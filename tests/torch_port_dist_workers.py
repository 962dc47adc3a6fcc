"""Rank bodies of the port's multi-process CPU tests: each runs in a gloo
process that ``focal_tpu_torch.parallel.distributed.run_local`` spawned and
returns numpy arrays to the test. Nothing here imports JAX.

``step_result`` takes one MOD_TINY training step (every drop rate 0, SGD, a
seeded init; the views drawn as the run draws them) on a process layout or,
with ``plan`` None, in one process; ``rank_steps`` runs a list of them on a
rank. ``rank_tp_blocks`` runs ``sharded_window_block_tp`` (the plain
versions of #4-TP/#5-TP on the CPU) on the rank's windows and heads of whole
inputs; ``dropout_masks`` records the masks of one SW_Transformer step at
its recipe's dropout rates; ``rank_tp`` runs all three. ``sharded_step``
takes one step of the sharded layout on a data rank, or the replicated
step over the whole global batch in one process; ``rank_sharded`` runs a
list of them on a rank.
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
from focal_tpu_torch.train.steps import (make_gathered_pretrain_step, make_pretrain_step,
                                         make_supervised_train_step)
from torch_port_replay import recorded_passes, replayed_bitwise

BATCH = 16
LR = 0.05


def _args(model, supervised, rate=0.0, flags=()):
    argv = ["-dataset", "MOD_TINY", "-model", model, "-device", "cpu",
            "-batch_size", str(BATCH)] + (["-learn_framework", "no"] if supervised else [])
    argv += list(flags)
    args = parse_train_params(argv)
    cfg = copy.deepcopy(args.dataset_config)
    for section in ("SW_Transformer", "DeepSense"):
        for key in ("dropout_ratio", "drop_path_rate", "attn_drop_rate"):
            if key in cfg[section]:
                cfg[section][key] = rate
    args.dataset_config = cfg
    return args


def step_result(model_name, supervised=False, fused=True, pallas_block=True, plan=None, rate=0.0,
                flags=(), evaluate=False):
    """{"loss", "state" (the updated state_dict, whole)} of one step, every
    drop rate ``rate``; ``flags``: more of the CLI's (-compute_dtype,
    -pallas_conv, -pallas_mlp); with ``evaluate`` also "eval", the updated
    model's eval logits of the step's batch (every rank all of it)."""
    args = _args(model_name, supervised, rate, flags)
    model = build_backbone(args.dataset_config, model_name, args.task, args.learn_framework,
                           pallas_block=pallas_block, pallas_conv=args.pallas_conv,
                           pallas_mlp=args.pallas_mlp, compute_dtype=args.compute_dtype)
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
    out = {"loss": float(metrics["loss"]),
           "state": {k: v.detach().numpy().copy() for k, v in whole.items()}}
    if evaluate:
        model.eval()
        with torch.no_grad():
            batch = {loc: {m: a.index_select(0, idx) for m, a in mods.items()}
                     for loc, mods in augmenter.no(data).items()}
            out["eval"] = model(batch, head="class").float().numpy()
    return out


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


def rank_tp_blocks(rank, world, mp, cases, bf16=False):
    """sharded_window_block_tp forward and backward on this rank's shard of
    each case: y and dx of its windows, its heads' weight gradients, and
    where they go in the whole tensors. With ``bf16`` x and dy in bf16 (the
    weights f32, rounded inside: #4-TP-bf16/#5-TP-bf16's plain versions),
    y and dx returned as f32 values."""
    plan = make_mesh_plan(0, mp)
    dt = torch.bfloat16 if bf16 else torch.float32
    out = []
    for case in cases:
        sh = tp_block_shard(case, plan)
        t = {k: torch.from_numpy(np.ascontiguousarray(sh[k])) for k in
             ("x", "wqkv", "bqkv", "wproj", "bproj", "rel_bias")}
        t["x"] = t["x"].to(dt)
        t = {k: v.requires_grad_(True) for k, v in t.items()}
        mask = None if sh["mask"] is None else torch.from_numpy(sh["mask"])
        y = sharded_window_block_tp(plan, t["x"], t["wqkv"], t["bqkv"], t["wproj"], t["bproj"],
                                    t["rel_bias"], mask)
        y.backward(torch.from_numpy(sh["dy"]).to(dt))
        res = {"y": y.detach().float().numpy(),
               **{f"d{k}": t[k].grad.float().numpy() for k in t}}
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


def rank_tp_bf16(rank, world, mp, cases, steps):
    """rank_tp_blocks in bf16 and rank_steps in one spawn."""
    return rank_tp_blocks(rank, world, mp, cases, bf16=True), rank_steps(rank, world, mp, steps)


def flag_off_routes(plan=None):
    """The fused kernels' calls in one SW_Transformer -pallas_mlp supervised
    step and one DeepSense -pallas_conv pretrain step (MOD_TINY, rate 0),
    counted by spies on the names the modules call: {"fused_mlp": n,
    "fused_conv_tower": n}."""
    from focal_tpu_torch.models import layers, swin

    calls = {"fused_mlp": 0, "fused_conv_tower": 0}
    saved = {(swin, "fused_mlp"): swin.fused_mlp, (layers, "fused_conv_tower"):
             layers.fused_conv_tower}

    def spy(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    for (mod, name), fn in saved.items():
        setattr(mod, name, spy(name, fn))
    try:
        step_result("SW_Transformer", supervised=True, plan=plan, flags=["-pallas_mlp"])
        step_result("DeepSense", plan=plan, flags=["-pallas_conv"])
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return calls


def rank_tp_deepsense(rank, world, mp, steps, ckpt_path):
    """rank_steps of DeepSense configs; at mp 2 without data ranks also the
    flag-off routes (flag_off_routes) and a checkpoint of the rank's model
    (train.checkpoint.save_params: rank 0 writes the single-process tree to
    ``ckpt_path``)."""
    from focal_tpu_torch.train import checkpoint

    plan = make_mesh_plan(0, mp)
    out = {"steps": [step_result(plan=plan, **cfg) for cfg in steps]}
    if plan.dp == 1:
        out["routes"] = flag_off_routes(plan)
        model = apply_plan(marked_deepsense(), plan)
        checkpoint.save_params(ckpt_path, model, plan)
        out["local_shapes"] = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return out


def marked_deepsense():
    """The MOD_TINY DeepSense, its seeded init with every entry of its
    state_dict (parameters and BatchNorm statistics) moved by 1e-3 times
    its flat index, so that a tree put together from slices shows each
    entry's place."""
    args = _args("DeepSense", False)
    model = init_params(build_backbone(args.dataset_config, "DeepSense", args.task,
                                       args.learn_framework), seed=0)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.add_(torch.arange(t.numel(), dtype=t.dtype).view_as(t) * 1e-3)
    return model


def tower_case(seed, samples, S, C, cin, layers, external, dtype):
    """A conv tower's inputs as numpy arrays: x0 [samples * 2, S, cin (C for
    an external first conv)], the layers' weights, biases, BatchNorm affines
    and per-sample Dropout2d masks, the output gradient."""
    rng = np.random.default_rng(seed)
    kw = 3
    cfgs = tuple((kw, (C if external else cin) if k == 0 else C, C, k > 0) for k in range(layers))
    f = lambda *shape, s=1.0: (s * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    case = {"cfgs": cfgs, "external": external, "dtype": dtype,
            "x0": f(2 * samples, S, cfgs[0][1]), "dy": f(2 * samples, S, C)}
    case["ws"] = [np.zeros((1, 1), np.float32) if external and k == 0 else
                  f(kw * cin_k, C, s=(kw * cin_k) ** -0.5) for k, (_, cin_k, _, _) in enumerate(cfgs)]
    case["bs"] = [f(C, s=0.1) for _ in cfgs]
    case["scales"] = [1.0 + f(C, s=0.1) for _ in cfgs]
    case["biases"] = [f(C, s=0.1) for _ in cfgs]
    case["masks"] = [((rng.random((samples, C)) > 0.2) / 0.8).astype(np.float32) for _ in cfgs]
    return case


def tower_result(case, plan=None):
    """fused_conv_tower (its plain versions on the CPU) on a case, over
    ``plan``'s data ranks (each its samples' rows) or whole: the output,
    the statistics and every gradient, as f32 numpy arrays."""
    from focal_tpu_torch.ops.conv_tower import fused_conv_tower

    dt = torch.bfloat16 if case["dtype"] == "bfloat16" else torch.float32
    samples = case["masks"][0].shape[0]
    lo, hi = (0, samples) if plan is None else plan.rows(samples)
    rows = slice(2 * lo, 2 * hi)  # two rows (intervals) a sample
    x0 = torch.from_numpy(case["x0"][rows]).to(dt).requires_grad_(True)
    params = [[torch.from_numpy(a).requires_grad_(True) for a in case[k]]
              for k in ("ws", "bs", "scales", "biases")]
    masks = [torch.from_numpy(m[lo:hi]) for m in case["masks"]]
    a, mus, vars_ = fused_conv_tower(x0, case["cfgs"], *params, masks, case["external"], plan=plan)
    leaves = [x0] + [p for group in params for p in group]
    grads = torch.autograd.grad(a, leaves, torch.from_numpy(case["dy"][rows]).to(dt),
                                allow_unused=True)
    return {"a": a.detach().float().numpy(), "mus": [m.numpy() for m in mus],
            "vars": [v.numpy() for v in vars_], "lo": 2 * lo, "hi": 2 * hi,
            "grads": [None if g is None else g.float().numpy() for g in grads]}


def rank_conv_dp(rank, world, cases, steps):
    """tower_result of each case on this data rank, and rank_steps of the
    DeepSense -pallas_conv configs at dp ``world``."""
    plan = make_mesh_plan(0, 1)
    return ([tower_result(c, plan) for c in cases],
            [step_result(plan=plan, **cfg) for cfg in steps])


SHARDED_POOLS = {  # draws the size of the batch (jitter) and across its rows (mixup)
    "random": {"time_augmenters": ["jitter"], "freq_augmenters": ["phase_shift"]},
}


def sharded_step(model_name, supervised=False, accum=1, plan=None):
    """{"loss", "state", "grads"} of one SGD update over a global batch of BATCH
    rows (``accum`` micro-batches of it with GradCache), every drop rate 0,
    the recipe's augmenters drawn with jitter forced in pretraining and
    mixup's soft targets in supervised training. With ``plan`` (the data
    ranks) each rank holds only its rows of every micro-batch and takes the
    sharded step; without, one process takes the replicated step over the
    whole batch."""
    flags = ["-mixup_labels"] if supervised else []
    args = _args(model_name, supervised, 0.0, flags)
    args.dataset_config["FOCAL"]["random_augmenters"] = SHARDED_POOLS["random"]
    args.dataset_config["jitter"]["prob"] = 1.0
    model = build_backbone(args.dataset_config, model_name, args.task, args.learn_framework)
    model = apply_plan(init_params(model, seed=0), plan)
    mask = trainable_mask(model, args)
    params = [p for name, p in model.named_parameters() if mask[name]]
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    opt = StepOptimizer(torch.optim.SGD(params, lr=LR), params, lambda epoch: LR, 10, plan=plan)
    state = TrainState(model, opt, seed=3, plan=plan)
    data, labels, _ = synthetic_arrays(args.dataset_config, args.task, accum * BATCH, seed=1)
    micro = BATCH // accum
    ways, d = (plan.dp, plan.d) if plan is not None else (1, 0)
    local = micro // ways
    rows = np.concatenate([i * micro + d * local + np.arange(local) for i in range(accum)])
    data = to_device({loc: {m: a[rows] for m, a in mods.items()} for loc, mods in data.items()},
                     "cpu")
    labels = torch.from_numpy(labels[rows]).long()
    sharded = plan is not None
    augmenter = build_augmenter(args)
    if supervised:
        step = make_supervised_train_step(model, augmenter, plan=plan, sharded=sharded)
        _, metrics = step(state, data, labels, torch.arange(local))
    elif accum > 1:
        step = make_gathered_pretrain_step(model, augmenter, make_focal_loss(args), accum,
                                           plan=plan, sharded=sharded)
        with recorded_passes(model) as seen:
            _, metrics = step(state, [(data, torch.arange(i * local, (i + 1) * local))
                                      for i in range(accum)])
        assert replayed_bitwise(seen)
    else:
        step = make_pretrain_step(model, augmenter, make_focal_loss(args), plan=plan,
                                  sharded=sharded)
        _, metrics = step(state, data, torch.arange(local), (0, 0))
    return {"loss": float(metrics["loss"]),
            "state": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
            "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                      if p.grad is not None}}


def rank_sharded(rank, world, configs):
    """sharded_step of each config on this data rank."""
    plan = make_mesh_plan(0, 1)
    return [sharded_step(plan=plan, **cfg) for cfg in configs]
