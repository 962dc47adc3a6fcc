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

Over several processes (``plan``) the files keep the single-process format:
each tensor-parallel slice (of a parameter, and of its optimizer moments)
is gathered whole before the process of rank 0 alone writes, and sliced
again on load, so `-resume`, the test CLI and `-init_weight` work across
layouts. Every rank calls the save functions (the gathers are collectives).
"""

import torch

from focal_tpu_torch.parallel import distributed, tp


def _model_state(model, plan):
    return tp.full_state_dict(model, plan) if plan is not None else model.state_dict()


def save_params(path, model, plan=None):
    state = _model_state(model, plan)
    if distributed.is_main():
        torch.save(state, path)


def _map_moments(opt_state, params, fn):
    """opt_state with fn(param, moment) in place of each moment of a param
    of ``params`` (the optimizer's order: state keys index it); a moment
    has its parameter's shape, the step counts stay as they are."""
    out = {"param_groups": opt_state["param_groups"], "state": {}}
    for i, entry in opt_state["state"].items():
        p = params[int(i)]
        out["state"][i] = {k: fn(p, v) if torch.is_tensor(v) and v.dim() > 0 else v
                           for k, v in entry.items()}
    return out


def save_state(path, state, epoch, best):
    plan = state.plan
    opt = state.optimizer.optimizer.state_dict()
    if plan is not None and plan.mp > 1:
        opt = _map_moments(opt, state.optimizer.params, lambda p, v: tp.whole(
            v, p.tp_spec, plan.mp, plan.model) if tp.is_sharded(p) else v)
    model = _model_state(state.model, plan)
    if distributed.is_main():
        torch.save({"model": model, "optimizer": opt, "step": state.step, "seed": state.seed,
                    "epoch": int(epoch), "best": float(best)}, path)


def restore_state(path, state):
    """Load a save_state file into ``state`` (model, optimizer, update
    count) -> (epoch, best). Raises if the file is from another seed."""
    saved = torch.load(path, map_location=state.device, weights_only=True)
    if saved["seed"] != state.seed:
        raise ValueError(f"{path} was saved by a run with -seed {saved['seed']}, this run has "
                         f"-seed {state.seed}; pass the same seed to resume")
    plan = state.plan
    opt = saved["optimizer"]
    if plan is not None and plan.mp > 1:
        tp.load_local(state.model, saved["model"], plan)
        opt = _map_moments(opt, state.optimizer.params, lambda p, v: tp.local_slice(
            v, p.tp_spec, plan.mp, plan.m) if tp.is_sharded(p) else v)
    else:
        state.model.load_state_dict(saved["model"])
    state.optimizer.optimizer.load_state_dict(opt)
    state.step = int(saved["step"])
    return saved["epoch"], saved["best"]


def load_params_into(model, path, load_class_layer=True, plan=None):
    """Load a save_params file into ``model`` in place, BatchNorm buffers
    included; without ``load_class_layer`` every ``class_layer`` entry keeps
    the model's own values (finetuning loads a pretrained backbone so).
    Entries the file lacks keep theirs too; a shape that differs raises.
    Under tensor parallelism (``plan``) each cut parameter takes its
    slice."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    try:
        tp.load_local(model, saved, plan, skip=() if load_class_layer else ("class_layer",))
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None
