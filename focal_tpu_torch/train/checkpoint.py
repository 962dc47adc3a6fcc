"""Checkpoints as torch files (the port's form of the JAX package's
``train/checkpoint.py``).

``save_params`` writes the backbone's state_dict alone: the `_latest` and
`_best` files of every stage; ``load_params_into`` loads one into a model
(finetuning loads pretraining's `_latest` without its class layer, the
test CLI a stage's `_best`). ``save_state``
writes what `-resume` needs to go on as if never stopped: the parameters,
the optimizer's state, the update count, the epoch, the best validation
loss, the run's seed and -grad_accum, and the gradient accumulator of a
cycle that straddles the epoch's end (``optim.StepOptimizer.acc``), so that
a resume in the middle of a cycle goes on exactly. The step's and the
epoch's generators are derived from (seed, update count) and (seed, epoch),
so those restore them. Resuming with another -grad_accum raises, as the JAX
package's ``check_meta`` does.

Over several processes (``plan``) the files keep the single-process format:
each tensor-parallel slice (of a parameter, of its optimizer moments and
of its accumulated gradient) is gathered whole before the process of rank 0 alone writes, and sliced
again on load, so `-resume`, the test CLI and `-init_weight` work across
layouts. Under data parallelism each rank's accumulator holds only its
rows' share of the cycle's mean (the optimizer sums over the data ranks at
the update), so the file keeps one accumulator a data rank, in rank order
(one in a single process); a run with as many data ranks takes each its
own, and one with another count gives data rank 0 the shares' sum and the
others zeros (the same sum at the update, to rounding). Every rank calls
the save functions (the gathers are collectives).
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


def _map_acc(acc, params, fn):
    """The accumulator (None, or an entry per parameter, None where no
    gradient came yet) with fn(param, entry) in place of each tensor."""
    if acc is None:
        return None
    return [None if a is None else fn(p, a) for p, a in zip(params, acc)]


def _data_shares(acc, plan):
    """[data rank 0's accumulator, rank 1's, ...], by one flat gather over
    the data ranks; [acc] for one data rank."""
    if acc is None or plan is None or plan.dp == 1:
        return None if acc is None else [acc]
    held = [a for a in acc if a is not None]
    rows = plan.gather_data_(torch.cat([a.reshape(-1) for a in held])[None])
    shares = []
    for row in rows:
        share, offset = [], 0
        for a in acc:
            share.append(None if a is None else row[offset:offset + a.numel()].view_as(a))
            offset += 0 if a is None else a.numel()
        shares.append(share)
    return shares


def _own_share(shares, plan):
    """This rank's accumulator from a file's ``_data_shares``."""
    if shares is None:
        return None
    dp, d = (1, 0) if plan is None else (plan.dp, plan.d)
    if len(shares) == dp:
        return shares[d]
    total = [None if a is None else sum(s[i] for s in shares) for i, a in enumerate(shares[0])]
    return total if d == 0 else [None if a is None else torch.zeros_like(a) for a in total]


def save_state(path, state, epoch, best, grad_accum=1):
    plan = state.plan
    opt = state.optimizer.optimizer.state_dict()
    acc = state.optimizer.acc
    if plan is not None and plan.mp > 1:
        def whole(p, v):
            return tp.whole(v, p.tp_spec, plan.mp, plan.model) if tp.is_sharded(p) else v

        opt = _map_moments(opt, state.optimizer.params, whole)
        acc = _map_acc(acc, state.optimizer.params, whole)
    acc = _data_shares(acc, plan)
    model = _model_state(state.model, plan)
    if distributed.is_main():
        torch.save({"model": model, "optimizer": opt, "step": state.step, "seed": state.seed,
                    "epoch": int(epoch), "best": float(best), "grad_accum": int(grad_accum),
                    "acc": acc}, path)


def restore_state(path, state, grad_accum=1):
    """Load a save_state file into ``state`` (model, optimizer, accumulator,
    update count) -> (epoch, best). Raises if the file is from another
    seed or another -grad_accum."""
    saved = torch.load(path, map_location=state.device, weights_only=True)
    if saved["seed"] != state.seed:
        raise ValueError(f"{path} was saved by a run with -seed {saved['seed']}, this run has "
                         f"-seed {state.seed}; pass the same seed to resume")
    saved_accum = saved.get("grad_accum", 1)
    if saved_accum != grad_accum:
        raise ValueError(f"Checkpoint {path} was saved with grad_accum={saved_accum} "
                         f"but this run uses grad_accum={grad_accum}; the optimizer-state "
                         f"structure differs. Pass -grad_accum {saved_accum} to resume, "
                         "or start a fresh run.")
    plan = state.plan
    opt, acc = saved["optimizer"], _own_share(saved.get("acc"), plan)
    if plan is not None and plan.mp > 1:
        tp.load_local(state.model, saved["model"], plan)
        def local(p, v):
            return tp.local_slice(v, p.tp_spec, plan.mp, plan.m) if tp.is_sharded(p) else v

        opt = _map_moments(opt, state.optimizer.params, local)
        acc = _map_acc(acc, state.optimizer.params, local)
    else:
        state.model.load_state_dict(saved["model"])
    state.optimizer.optimizer.load_state_dict(opt)
    state.optimizer.acc = acc
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
