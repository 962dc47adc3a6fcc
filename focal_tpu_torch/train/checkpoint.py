"""Checkpoints as torch files (the port's form of the JAX package's
``train/checkpoint.py``).

``save_params`` writes the backbone's state_dict alone: the `_latest` and
`_best` files of every stage; ``load_params_into`` loads one into a model
(finetuning loads pretraining's `_latest` without its class layer, the
test CLI a stage's `_best`). ``save_state``
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


def load_params_into(model, path, load_class_layer=True):
    """Load a save_params file into ``model`` in place, BatchNorm buffers
    included; without ``load_class_layer`` every ``class_layer`` entry keeps
    the model's own values (finetuning loads a pretrained backbone so).
    Entries the file lacks keep theirs too; a shape that differs raises."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    own = model.state_dict()
    with torch.no_grad():
        for name, t in own.items():
            if (not load_class_layer and "class_layer" in name) or name not in saved:
                continue
            if tuple(saved[name].shape) != tuple(t.shape):
                raise ValueError(f"{path}: {name} has shape {tuple(saved[name].shape)}, the model "
                                 f"{tuple(t.shape)}")
            t.copy_(saved[name])
