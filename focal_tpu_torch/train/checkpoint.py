"""Checkpoints as torch files (the port's form of the JAX package's
``train/checkpoint.py``).

``save_params`` writes the backbone's state_dict alone: the `_latest` and
`_best` files of pretraining, which later stages load. ``save_state``
writes what `-resume` needs to go on as if never stopped: the parameters,
the optimizer's state, the update count, the epoch, the best validation
loss and the run's seed. The step's and the epoch's generators are derived
from (seed, update count) and (seed, epoch), so those restore them.
"""

import torch


def save_params(path, model):
    torch.save(model.state_dict(), path)


def save_state(path, state, epoch, best):
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.optimizer.state_dict(),
                "step": state.step, "seed": state.seed, "epoch": int(epoch),
                "best": float(best)}, path)


def restore_state(path, state):
    """Load a save_state file into ``state`` (model, optimizer, update
    count) -> (epoch, best). Raises if the file is from another seed."""
    saved = torch.load(path, map_location=state.device, weights_only=True)
    if saved["seed"] != state.seed:
        raise ValueError(f"{path} was saved by a run with -seed {saved['seed']}, this run has "
                         f"-seed {state.seed}; pass the same seed to resume")
    state.model.load_state_dict(saved["model"])
    state.optimizer.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return saved["epoch"], saved["best"]
