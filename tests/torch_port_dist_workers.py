"""Rank bodies of the port's multi-process CPU tests: each runs in a gloo
process that ``focal_tpu_torch.parallel.distributed.run_local`` spawned and
returns numpy arrays to the test. Nothing here imports JAX.

``step_result`` takes one MOD_TINY training step (every drop rate 0, SGD, a
seeded init; the views drawn as the run draws them) on a process layout or,
with ``plan`` None, in one process; ``rank_steps`` runs a list of them on a
rank. ``rank_tp_blocks`` runs ``sharded_window_block_tp`` (the plain
versions of #4-TP/#5-TP on the CPU) on the rank's windows and heads of whole
inputs; ``dropout_masks`` records the masks of one SW_Transformer step at
its recipe's dropout rates; ``rank_tp`` runs all three.
"""

import copy

import numpy as np
import torch

from focal_tpu_torch.data import synthetic_arrays, to_device
from focal_tpu_torch.models import apply_plan, build_backbone, init_params
from focal_tpu_torch.ops.augment import build_augmenter
from focal_tpu_torch.ops.pallas_kernels import sharded_window_block_tp
from focal_tpu_torch.parallel import tp
from focal_tpu_torch.parallel.mesh import make_mesh_plan
from focal_tpu_torch.params import parse_train_params
from focal_tpu_torch.train.losses import make_focal_loss
from focal_tpu_torch.train.optim import StepOptimizer, trainable_mask
from focal_tpu_torch.train.state import TrainState
from focal_tpu_torch.train.steps import make_pretrain_step, make_supervised_train_step

BATCH = 16
LR = 0.05


def _args(model, supervised, rate=0.0):
    argv = ["-dataset", "MOD_TINY", "-model", model, "-device", "cpu",
            "-batch_size", str(BATCH)] + (["-learn_framework", "no"] if supervised else [])
    args = parse_train_params(argv)
    cfg = copy.deepcopy(args.dataset_config)
    for section in ("SW_Transformer", "DeepSense"):
        for key in ("dropout_ratio", "drop_path_rate", "attn_drop_rate"):
            if key in cfg[section]:
                cfg[section][key] = rate
    args.dataset_config = cfg
    return args


def step_result(model_name, supervised=False, fused=True, pallas_block=True, plan=None, rate=0.0):
    """{"loss", "state" (the updated state_dict, whole)} of one step, every
    drop rate ``rate``."""
    args = _args(model_name, supervised, rate)
    model = build_backbone(args.dataset_config, model_name, args.task, args.learn_framework,
                           pallas_block=pallas_block)
    model = apply_plan(init_params(model, seed=0), plan)
    mask = trainable_mask(model, args)
    params = [p for name, p in model.named_parameters() if mask[name]]
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    opt = StepOptimizer(torch.optim.SGD(params, lr=LR), params, lambda epoch: LR, 10, plan=plan)
    state = TrainState(model, opt, seed=3, plan=plan)
    data, labels, _ = synthetic_arrays(args.dataset_config, args.task, 2 * BATCH, seed=1)
    data = to_device(data, "cpu")
    idx = torch.arange(BATCH)
    augmenter = build_augmenter(args)
    if supervised:
        step = make_supervised_train_step(model, augmenter, fixed_aug=True, plan=plan)
        _, metrics = step(state, data, torch.from_numpy(labels).long(), idx)
    else:
        step = make_pretrain_step(model, augmenter, make_focal_loss(args), fused_views=fused,
                                  plan=plan)
        _, metrics = step(state, data, idx)
    whole = tp.full_state_dict(model, plan) if plan is not None else model.state_dict()
    return {"loss": float(metrics["loss"]),
            "state": {k: v.detach().numpy().copy() for k, v in whole.items()}}


def rank_steps(rank, world, mp, configs):
    """step_result of each config (a dict of its keyword arguments) on this
    rank of a dp x mp layout."""
    plan = make_mesh_plan(0, mp)
    return [step_result(plan=plan, **cfg) for cfg in configs]


def _qkv_cols(C, H, heads):
    """Columns of a [C, 3C] part|head|dim weight that hold ``heads``."""
    hd = C // H
    return np.concatenate([np.arange(p * C + h * hd, p * C + (h + 1) * hd)
                           for p in range(3) for h in heads])


def tp_block_shard(case, plan):
    """The rank's inputs of a whole-block case: its windows (whole samples
    of nW windows) and its heads' columns of wqkv, rows of wproj, and
    heads of the bias table."""
    C, H = case["x"].shape[-1], case["rel_bias"].shape[0]
    per = H // plan.mp
    heads = list(range(plan.m * per, (plan.m + 1) * per))
    cols = _qkv_cols(C, H, heads)
    hd = C // H
    rows = np.arange(heads[0] * hd, (heads[-1] + 1) * hd)
    lo, hi = plan.rows(case["x"].shape[0])
    return {"x": case["x"][lo:hi], "wqkv": case["wqkv"][:, cols], "bqkv": case["bqkv"][cols],
            "wproj": case["wproj"][rows], "bproj": case["bproj"],
            "rel_bias": case["rel_bias"][heads], "mask": case["mask"], "dy": case["dy"][lo:hi],
            "cols": cols, "rows": rows, "lo": lo, "hi": hi, "heads": heads}


def rank_tp_blocks(rank, world, mp, cases):
    """sharded_window_block_tp forward and backward on this rank's shard of
    each case: y and dx of its windows, its heads' weight gradients, and
    where they go in the whole tensors."""
    plan = make_mesh_plan(0, mp)
    out = []
    for case in cases:
        sh = tp_block_shard(case, plan)
        t = {k: torch.from_numpy(np.ascontiguousarray(sh[k])).requires_grad_(k != "mask")
             for k in ("x", "wqkv", "bqkv", "wproj", "bproj", "rel_bias")}
        mask = None if sh["mask"] is None else torch.from_numpy(sh["mask"])
        y = sharded_window_block_tp(plan, t["x"], t["wqkv"], t["bqkv"], t["wproj"], t["bproj"],
                                    t["rel_bias"], mask)
        y.backward(torch.from_numpy(sh["dy"]))
        res = {"y": y.detach().numpy(), **{f"d{k}": t[k].grad.numpy() for k in t}}
        out.append({**res, **{k: sh[k] for k in ("cols", "rows", "lo", "hi", "heads")}})
    return out


DROP_RATE = 0.2  # MOD's dropout_ratio and attn_drop_rate


def dropout_masks(plan=None):
    """Every ``remat_dropout`` call of the Swin blocks in one SW_Transformer
    pretrain step at every drop rate DROP_RATE (the plain attention route,
    so that the attention's dropout is one of them): (the input's shape, the
    generator's seed, where the input is nonzero, where the output is),
    in call order."""
    from focal_tpu_torch.models import swin

    calls, plain = [], swin.remat_dropout

    def record(x, rate, generator):
        out = plain(x, rate, generator)
        calls.append((tuple(x.shape), generator.initial_seed(), (x != 0).numpy(),
                      (out != 0).numpy()))
        return out

    swin.remat_dropout = record
    try:
        step_result("SW_Transformer", pallas_block=False, plan=plan, rate=DROP_RATE)
    finally:
        swin.remat_dropout = plain
    return calls


def rank_tp(rank, world, mp, cases, steps):
    """rank_tp_blocks, rank_steps and dropout_masks in one spawn."""
    return (rank_tp_blocks(rank, world, mp, cases), rank_steps(rank, world, mp, steps),
            dropout_masks(make_mesh_plan(0, mp)))
