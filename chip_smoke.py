"""Chip smoke test of the PyTorch/CUDA port (focal_tpu_torch) on one card.

    python3 chip_smoke.py [--out DIR]

Phases (each raises on failure; the script exits non-zero and prints no
result line if any fails):
  1. print the card's name and power limit (nvidia-smi); build every kernel
     from the sources in this checkout (nvcc, one run per source);
  2. kernel #1 vs plain: fused_window_block against its plain PyTorch
     version on the card at every MOD SW_Transformer block geometry (batch
     128), shifted and unshifted, max abs error <= 1e-4 (both full f32: the
     difference is summation order);
  3. the serving path: the MOD SW_Transformer at full width (seeded random
     init) served by focal_tpu_torch.serve.Predictor over ~1,000 synthetic
     samples at batch 128 (ragged tail included): probabilities finite and
     summing to 1, #1 launched 16 times per batch (and no other kernel),
     and the first batch equal (atol 1e-5) to the same model run with the
     plain block on the card;
  4. timing of #1 with CUDA events after warm-up at each geometry: kernel,
     plain version, a library yardstick (matmul + scaled_dot_product_attention
     + matmul, never called by the port) and the bound from the geometry's
     FLOP and byte counts; plus the Predictor's windows/s and p50 batch
     latency;
  5. a torch.profiler trace of one served batch: device busy time, idle
     share, device operations and the device kernels by time;
  6. kernels #2 and #3 vs plain at every block geometry of the training
     batch (256 samples, two views fused to 512): #2's output against the
     plain forward fed #2's own keep mask (1e-4 absolute), #2's keep rate
     within 5 sigma of 1 - attn_drop_rate per launch, #3's six gradients
     (with #2's mask, and without a mask) against autograd of the plain
     version as max|kernel - plain| / max|plain| <= 1e-4 (long f32 sums),
     #3 given the weights' [out, in] copies as the Swin block gives them;
  7. the training path: FOCAL pretrain steps of the MOD SW_Transformer at
     full width (flax-style init, seed 0, batch 256, synthetic data resident
     on the card, a fixed idx as bench.py uses): warm-up, then timed steps
     with #2 and #3 launched 16 times per step each (no other kernel),
     losses and parts finite; ms per step (p50), samples/s and attention
     windows/s, peak device memory; one step with every drop rate at 0 from
     the trained state, through the kernels and through the plain versions:
     loss within 1e-5 relative and every parameter's gradient within
     max|delta| / max|plain| <= 1e-4;
  8. timing of #2 and #3 at each training geometry: kernel, plain, library
     (scaled_dot_product_attention with dropout; the autograd backward of
     the library block) and bound;
  9. a torch.profiler trace of one training step;
 10. kernels #4 and #5 vs plain at every per-head block geometry of
     MOD_WIDE (C 512 and 1024, 4 heads) at the wide training batch (64
     samples, views fused to 128): #4 at rate 0 (1e-4 absolute), #4 with
     dropout against the plain forward fed its own mask (1e-4 absolute,
     keep rate within 5 sigma), #4's mask equal to #2's bit for bit at
     C = 512, #5's six gradients with #4's mask and without (1e-4
     relative) and the same bits on a second call;
 11. the training entry point: python -m focal_tpu_torch.train at MOD_WIDE
     (512 synthetic samples, batch 64, 2 epochs, validation every epoch)
     run in-process, then -resume to epoch 3: finite losses, two validation
     points and one after the resume, the _latest/_best/_resume files; per
     step #2 and #3 launched 4 times (stage 0) and #4 and #5 12 times, per
     eval forward #1 4 times and #4 12 times, nothing else;
 12. MOD_WIDE pretrain steps timed as phase 7 times MOD's (batch 64, 3
     warm-up + 10 timed; #2/#3 4 per step, #4/#5 12 per step), the rate-0
     kernels-vs-plain step held to phase 7's tolerances from the initial
     state (and from the trained state beside the plain step on the CPU,
     reported but not held: AdamW at lr 1e-3 grows the 184M-parameter
     model's attention logits, so any f32 summation order moves its loss),
     and a torch.profiler trace of one step;
 13. timing of #4 and #5 at each per-head geometry (kernel, plain, library,
     bound), and beside them #1 and #3 at the C = 512 geometries, where
     they launch too.

Prints a {"kernels": [...]} line, the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}. Needs one CUDA card; imports no JAX and
nothing of the JAX package. --out DIR writes the per-geometry details and
the profiles as JSON there.
"""

import argparse
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SERVE_BATCH = 128
SERVE_SAMPLES = 1000
TRAIN_BATCH = 256         # samples per step; the two views run fused as 512
TRAIN_WARMUP = 3
TRAIN_STEPS = 20
WIDE_BATCH = 64           # MOD_WIDE samples per step; views fused to 128
WIDE_STEPS = 10
WIDE_SAMPLES = 512        # MOD_WIDE synthetic train split of the entry-point run
KERNEL_TOL = 1e-4
GRAD_TOL = 1e-4           # relative: max|kernel - plain| / max|plain|
SLICE_TOL = 1e-5
LOSS_TOL = 1e-5           # relative
PK = "focal_tpu/ops/pallas_kernels.py"


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def block_geometries(cfg, batch):
    """Every distinct (modality, stage, shifted) launch of the forward,
    with how many times one forward makes it."""
    from focal_tpu_torch.models.sw_transformer import mod_geometry
    from focal_tpu_torch.models.swin import block_geometry, shifted_window_mask

    sw = cfg["SW_Transformer"]
    loc = cfg["location_names"][0]
    geos = []
    for mod in cfg["modality_names"]:
        geo = mod_geometry(cfg, loc, mod)
        for stage, ((H, W), C) in enumerate(geo["stages"]):
            depth = geo["block_num"][stage]
            kinds = {}  # (wh, ww, shifted) -> [sh, sw, blocks]; no mask -> shifts unused
            for i in range(depth):
                shift = [0, 0] if i % 2 == 0 else [w // 2 for w in geo["window"]]
                wh, ww, sh, sws, shifted = block_geometry((H, W), geo["window"], shift)
                kinds.setdefault((wh, ww, shifted), [sh, sws, 0])[2] += 1
            for (wh, ww, shifted), (sh, sws, count) in kinds.items():
                nW = (H // wh) * (W // ww)
                geos.append({
                    "name": f"{mod}/stage{stage}/{'shifted' if shifted else 'plain'}",
                    "H": H, "W": W, "C": C, "heads": sw["time_freq_head_num"],
                    "N": wh * ww, "nW": nW, "windows": batch * nW,
                    "mask": shifted_window_mask(H, W, wh, ww, sh, sws) if shifted else None,
                    "per_forward": count,
                })
    return geos


def bound(flops, nbytes):
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def work(g):
    """#1 (and #4 at rate 0): FLOPs and bytes of one launch (projections +
    attention; each input read once and the output written once) and its
    bound."""
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]
    flops = B * (8 * N * C * C + 4 * N * N * C)
    elems = 2 * B * N * C + 4 * C * C + 4 * C + H * N * N
    if g["mask"] is not None:
        elems += g["nW"] * N * N
    nbytes = 4 * elems
    return (flops, nbytes) + bound(flops, nbytes)


def work_dropout(g):
    """#2 (and #4 with dropout): #1's work plus writing the uint8 keep mask."""
    flops, nbytes, _, _ = work(g)
    nbytes += g["windows"] * g["heads"] * g["N"] ** 2
    return (flops, nbytes) + bound(flops, nbytes)


def work_backward(g, with_keep):
    """#3 (and #5): FLOPs = B_ (22 N C^2 + 12 N^2 C): qkv recompute 6NC^2,
    dx 6NC^2, dWqkv 6NC^2, d(attn out) 2NC^2, dWproj 2NC^2; attention
    12 N^2 C (scores, attention output, d(attention), dv, dq, dk: 2 N^2 C
    each). Bytes: x, dy, dx, the keep mask, the weights, bias table and
    shift mask once, and the gradients once."""
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]
    flops = B * (22 * N * C * C + 12 * N * N * C)
    elems = 3 * B * N * C + 2 * (4 * C * C + 4 * C + H * N * N)
    if g["mask"] is not None:
        elems += g["nW"] * N * N
    nbytes = 4 * elems + (B * H * N * N if with_keep else 0)
    return (flops, nbytes) + bound(flops, nbytes)


def make_inputs(torch, g, gen, dev):
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    x = rnd(B, N, C)
    wqkv = rnd(C, 3 * C, scale=C**-0.5)
    bqkv = rnd(3 * C, scale=0.1)
    wproj = rnd(C, C, scale=C**-0.5)
    bproj = rnd(C, scale=0.1)
    rel_bias = rnd(H, N, N, scale=0.02)
    mask = None if g["mask"] is None else torch.from_numpy(g["mask"]).to(dev)
    return x, wqkv, bqkv, wproj, bproj, rel_bias, mask


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_block(torch, x, wqkv, bqkv, wproj, bproj, attn_mask, H, dropout_p=0.0):
    """Yardstick only: the same function through cuBLAS and PyTorch's
    scaled_dot_product_attention (q is pre-scaled, so scale=1)."""
    B, N, C = x.shape
    qkv = torch.matmul(x, wqkv).add_(bqkv).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
    o = torch.nn.functional.scaled_dot_product_attention(
        qkv[0], qkv[1], qkv[2], attn_mask=attn_mask, dropout_p=dropout_p, scale=1.0)
    return torch.matmul(o.transpose(1, 2).reshape(B, N, C), wproj).add_(bproj)


def library_mask(torch, g, rel_bias, mask):
    B = g["windows"]
    attn_mask = rel_bias[None].expand(B, -1, -1, -1)
    if mask is not None:
        attn_mask = attn_mask + mask[torch.arange(B, device=mask.device) % g["nW"]][:, None]
    return attn_mask.contiguous()


def library_backward_ms(torch, g, args, dy, rate):
    """The autograd backward of the library block (the bias-table gradient
    flows through its attention mask), timed."""
    x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
    leaves = [t.clone().requires_grad_(True) for t in (x, wqkv, bqkv, wproj, bproj)]
    am = library_mask(torch, g, rel_bias, mask).requires_grad_(True)
    out = library_block(torch, *leaves, am, g["heads"], rate)
    ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves + [am], dy, retain_graph=True))
    del out
    return ms


def transposed(args):
    """wqkv and wproj in nn.Linear's [out, in] layout, which #3 and #5 read
    and the Swin block passes them."""
    return args[1].t().contiguous(), args[3].t().contiguous()


def rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def profile_device(torch, fn):
    """Run fn once under torch.profiler: wall ms, device busy ms, device
    operations and the device rows by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # device rows only: a CPU op's self device time repeats its kernels'
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_ops": sum(e.count for e in rows), "rows": [
                {"name": e.key, "device_ms": e.self_device_time_total / 1e3, "count": e.count}
                for e in rows]}


def log_profile(tag, what, breakdown, top=12):
    b = breakdown
    log(f"[{tag}] {what}: wall {b['wall_ms']:.3f} ms, device busy {b['device_busy_ms']:.3f} ms, "
        f"idle share {1 - b['device_busy_ms'] / b['wall_ms']:.3f}, {b['device_ops']} device operations")
    for r in b["rows"][:top]:
        log(f"[{tag}] {r['device_ms']:.4f} ms x{r['count']}: {r['name'][:90]}")


def zero_counts(kernels):
    for k in kernels:
        k.launches = 0


def counts(kernels):
    return {k.__name__: k.launches for k in kernels}


def check_counts(what, got, want):
    """Every kernel's launches in a path equal the expected count (0 for
    the kernels the path must not launch)."""
    if got != want:
        raise AssertionError(f"{what}: launches {got} != expected {want}")


def run_train_steps(torch, np, targs, batch, warmup, steps, kernels, per_step, dev, tag,
                    rate0_at_init=False):
    """Pretrain steps of the SW_Transformer at full width (flax-style init,
    seed 0, synthetic data resident on the card, a fixed idx as bench.py
    uses): warm-up, then timed steps with each kernel's launches per step
    checked; then one step with every drop rate at 0 through the kernels
    and through the plain versions, held to LOSS_TOL and GRAD_TOL: from the
    trained state, or with ``rate0_at_init`` from the initial one, and then
    from the trained state as well, reported beside the same plain step on
    the host's CPU (another f32 summation order) but not held. Returns
    (summary, (state, step, data, idx))."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.models.sw_transformer import init_params
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    host_data, labels, _ = synthetic_arrays(targs.dataset_config, targs.task, 2 * batch, seed=0)
    tdata = to_device(host_data, dev)
    idx = torch.arange(batch, device=dev) % len(labels)  # fixed, as bench.py
    model = build_backbone(targs.dataset_config, targs.model, targs.task, targs.learn_framework)
    init_params(model, seed=0)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.to(dev)
    state = create_train_state(targs, model, steps_per_epoch=100, seed=0)
    step = make_pretrain_step(model, build_augmenter(targs), make_focal_loss(targs))
    t0 = time.time()
    for _ in range(warmup):
        state, metrics = step(state, tdata, idx)
    torch.cuda.synchronize()
    log(f"[{tag}] {targs.dataset} SW_Transformer pretrain, batch {batch} (views fused to "
        f"{2 * batch}), {sum(p.numel() for p in model.parameters())} parameters; "
        f"{warmup} warm-up steps in {time.time() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    step_s, history = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.time()
        state, metrics = step(state, tdata, idx)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        history.append(torch.stack([metrics[k] for k in sorted(metrics)]))
    launches = counts(kernels)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    history = torch.stack(history).cpu()
    names_sorted = sorted(metrics)
    if not bool(torch.isfinite(history).all()):
        raise AssertionError(f"non-finite loss or part: {history}")
    check_counts(f"{tag}: {steps} steps", launches,
                 {k.__name__: per_step.get(k.__name__, 0) * steps for k in kernels})
    p50_ms = float(np.percentile(step_s, 50)) * 1e3
    geos = block_geometries(targs.dataset_config, 2 * batch)
    step_windows = sum(g["per_forward"] * g["windows"] for g in geos)  # through the attention
    train = {
        "steps": steps, "launches": launches, "p50_ms": p50_ms,
        "mean_ms": float(np.mean(step_s)) * 1e3, "min_ms": float(np.min(step_s)) * 1e3,
        "max_ms": float(np.max(step_s)) * 1e3,
        "samples_per_s": batch / (p50_ms / 1e3),
        "attention_windows_per_s": step_windows / (p50_ms / 1e3), "peak_mb": peak_mb,
        "first": dict(zip(names_sorted, history[0].tolist())),
        "last": dict(zip(names_sorted, history[-1].tolist())),
    }
    log(f"[{tag}] {steps} steps: launches {launches} (per step {per_step})")
    log(f"[{tag}] loss {train['first']['loss']:.4f} -> {train['last']['loss']:.4f}; last parts "
        + ", ".join(f"{k} {v:.4f}" for k, v in train["last"].items() if k != "loss"))
    log(f"[{tag}] p50 step {p50_ms:.3f} ms (mean {train['mean_ms']:.3f}, min {train['min_ms']:.3f}, "
        f"max {train['max_ms']:.3f}), {train['samples_per_s']:.1f} samples/s, "
        f"{train['attention_windows_per_s']:.1f} attention windows/s ({step_windows} a step), "
        f"peak memory {peak_mb:.1f} MiB")

    # one step with every drop rate at 0, kernels vs plain
    cfg0 = copy.deepcopy(targs.dataset_config)
    sw0 = cfg0["SW_Transformer"]
    sw0["dropout_ratio"] = sw0["drop_path_rate"] = sw0["attn_drop_rate"] = 0.0
    args0 = copy.copy(targs)
    args0.dataset_config = cfg0
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def rate0_step(weights, window_block, forward, device):
        """(loss, {name: gradient on the CPU}) of one rate-0 step."""
        m = build_backbone(cfg0, targs.model, targs.task, targs.learn_framework)
        m.load_state_dict(weights)
        m.to(device)
        st = create_train_state(args0, m, steps_per_epoch=100, seed=0)
        st.step = state.step
        data = {loc: {k: a.to(device) for k, a in mods.items()} for loc, mods in tdata.items()}
        swin_mod.window_block, swin_mod.window_block_forward = window_block, forward
        try:
            _, mt = make_pretrain_step(m, build_augmenter(args0), make_focal_loss(args0))(
                st, data, idx.to(device))
        finally:
            swin_mod.window_block, swin_mod.window_block_forward = pk.window_block, pk.window_block_forward
        return float(mt["loss"]), {n: None if p.grad is None else p.grad.cpu()
                                   for n, p in m.named_parameters() if p.requires_grad}

    def differ(a, b):
        """(relative loss difference, worst relative gradient difference, its name)."""
        (loss_a, grads_a), (loss_b, grads_b) = a, b
        worst_err, worst = 0.0, ""
        for name, gb in grads_b.items():
            ga = grads_a[name]
            if ga is None or gb is None:
                if (ga is None) != (gb is None):
                    raise AssertionError(f"{name}: gradient on one path only")
                continue
            e = rel_err(ga, gb)
            if e > worst_err:
                worst_err, worst = e, name
        return abs(loss_a - loss_b) / abs(loss_b), worst_err, worst

    gated = initial if rate0_at_init else trained
    kern = rate0_step(gated, pk.window_block, pk.window_block_forward, dev)
    plain = rate0_step(gated, pk.window_block_reference, pk.fused_window_block_reference, dev)
    loss_rel, step_grad_err, worst = differ(kern, plain)
    where = "initial" if rate0_at_init else "trained"
    train.update(rate0_state=where, rate0_loss_kernel=kern[0], rate0_loss_plain=plain[0],
                 rate0_loss_rel=loss_rel, rate0_max_grad_rel=step_grad_err, rate0_worst=worst)
    log(f"[{tag}] rate-0 step from the {where} state, kernels vs plain: loss {kern[0]:.6f} vs "
        f"{plain[0]:.6f} (rel {loss_rel:.2e}), max grad rel err {step_grad_err:.2e} ({worst})")
    if not loss_rel <= LOSS_TOL:
        raise AssertionError(f"rate-0 loss differs: {kern[0]} vs {plain[0]}")
    if not step_grad_err <= GRAD_TOL:
        raise AssertionError(f"rate-0 gradients differ: {step_grad_err} at {worst}")
    del kern, plain
    if rate0_at_init:
        # the trained state, not held: the same comparison, and the plain
        # step on the card against the plain step on the CPU
        kern = rate0_step(trained, pk.window_block, pk.window_block_forward, dev)
        plain = rate0_step(trained, pk.window_block_reference, pk.fused_window_block_reference, dev)
        host = rate0_step(trained, pk.window_block_reference, pk.fused_window_block_reference,
                          torch.device("cpu"))
        kp, pc = differ(kern, plain), differ(plain, host)
        train.update(trained_rate0_kernel_vs_plain=kp, trained_rate0_plain_card_vs_cpu=pc,
                     trained_rate0_losses=[kern[0], plain[0], host[0]])
        log(f"[{tag}] rate-0 step from the trained state (not held): loss kernels {kern[0]:.6f}, "
            f"plain {plain[0]:.6f}, plain on the CPU {host[0]:.6f}; kernels vs plain: loss rel "
            f"{kp[0]:.2e}, max grad rel {kp[1]:.2e} ({kp[2]}); plain on the card vs on the CPU: "
            f"loss rel {pc[0]:.2e}, max grad rel {pc[1]:.2e} ({pc[2]})")
        del kern, plain, host
    return train, (state, step, tdata, idx)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the per-geometry JSON")
    cli = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "focal_tpu_torch")):
        sys.exit("chip_smoke.py must run from a checkout of the repository (no focal_tpu_torch/ beside it)")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls (the default, stated)
    torch.backends.cudnn.allow_tf32 = False

    import importlib

    from focal_tpu_torch.data import DeviceDataLoader, load_split, synthetic_arrays
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.ops import _build
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml, parse_train_params
    from focal_tpu_torch.serve import Predictor

    fwd, fwd_drop, bwd = pk.fused_window_block, pk.fused_window_block_dropout, pk.fused_window_block_backward
    ph_fwd, ph_bwd = pk.fused_window_block_perhead, pk.fused_window_block_perhead_backward
    all_kernels = (fwd, fwd_drop, bwd, ph_fwd, ph_bwd)
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.time()

    # ---- 1. build: one nvcc per source
    t0 = time.time()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel libraries in {time.time() - t0:.1f}s")
    for src in _build.SOURCES:
        with open(_build.log_path(src)) as f:
            for line in f.read().splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    log(f"[build] {src}: {line.strip()}")

    # ---- 2. #1 vs plain at every block geometry of the MOD forward
    cfg = load_yaml(os.path.join(HERE, "focal_tpu_torch", "configs", "MOD.yaml"))  # full width
    task = "vehicle_classification"
    geos = block_geometries(cfg, SERVE_BATCH)
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for g in geos:
        args = make_inputs(torch, g, gen, dev)
        y = fwd(*args)
        torch.cuda.synchronize()
        err = float((y - pk.fused_window_block_reference(*args)).abs().max())
        g["max_abs_err"] = err
        max_err = max(max_err, err)
        log(f"[check] {g['name']}: windows {g['windows']} C {g['C']} nW {g['nW']} "
            f"max|kernel-plain| {err:.3e}")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{g['name']}: kernel differs from plain by {err} > {KERNEL_TOL}")
    torch.cuda.synchronize()

    # ---- 3. the serving path: full-width MOD SW_Transformer served by the Predictor
    data, labels, names = synthetic_arrays(cfg, task, SERVE_SAMPLES, seed=3)
    n = len(names)
    predictor = Predictor(cfg, "SW_Transformer", task, None, batch_size=SERVE_BATCH,
                          device="cuda", seed=0)
    n_params = sum(p.numel() for p in predictor.model.parameters())
    log(f"[slice] MOD SW_Transformer, {n_params} parameters, warm-up {predictor.compile_seconds:.2f}s")
    zero_counts(all_kernels)
    result = predictor.predict(data)
    serve_launches = counts(all_kernels)
    per_fwd = sum(g["per_forward"] for g in geos)  # 16 Swin blocks in the MOD forward
    batches = result["latency"]["batches"]
    check_counts("serving", serve_launches, {**{k.__name__: 0 for k in all_kernels},
                                             fwd.__name__: per_fwd * batches})
    launches = serve_launches[fwd.__name__]
    probs = result["probs"]
    if probs.shape != (n, cfg[task]["num_classes"]) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities: shape {probs.shape}")
    sum_err = float(np.abs(probs.sum(-1) - 1.0).max())
    if sum_err > 1e-5:
        raise AssertionError(f"probabilities do not sum to 1 (max error {sum_err})")
    log(f"[slice] {n} samples in {batches} batches of {SERVE_BATCH}: "
        f"kernel launches {launches} ({per_fwd} per batch)")

    first = {loc: {m: a[:SERVE_BATCH] for m, a in mods.items()} for loc, mods in data.items()}
    swin_mod.window_block_forward = pk.fused_window_block_reference  # the plain block, same model
    try:
        plain_probs = predictor._forward(first)
    finally:
        swin_mod.window_block_forward = pk.window_block_forward
    slice_err = float(np.abs(plain_probs - probs[:SERVE_BATCH]).max())
    log(f"[slice] first batch, kernel vs plain block: max|dprobs| {slice_err:.3e}")
    if not slice_err <= SLICE_TOL:
        raise AssertionError(f"served probs differ from the plain model by {slice_err}")
    lat = result["latency"]
    log(f"[slice] p50 batch {lat['p50_s'] * 1e3:.3f} ms, mean {lat['mean_s'] * 1e3:.3f} ms, "
        f"{lat['windows_per_s']:.1f} windows/s")

    # ---- 4. #1 timing per geometry
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "flops": 0, "bytes": 0}
    for g in geos:
        x, wqkv, bqkv, wproj, bproj, rel_bias, mask = make_inputs(torch, g, gen, dev)
        attn_mask = library_mask(torch, g, rel_bias, mask)
        args = (x, wqkv, bqkv, wproj, bproj, rel_bias, mask)
        g["ms"] = time_ms(torch, lambda: fwd(*args))
        g["plain_ms"] = time_ms(torch, lambda: pk.fused_window_block_reference(*args))
        g["library_ms"] = time_ms(
            torch, lambda: library_block(torch, x, wqkv, bqkv, wproj, bproj, attn_mask, g["heads"]))
        g["flops"], g["bytes"], g["bound_ms"], g["bound_by"] = work(g)
        log(f"[time] {g['name']}: kernel {g['ms']:.4f} ms, plain {g['plain_ms']:.4f} ms, "
            f"library {g['library_ms']:.4f} ms, bound {g['bound_ms']:.4f} ms ({g['bound_by']}), "
            f"{g['flops'] / g['ms'] / 1e9:.2f} TFLOP/s")
        for k in tot:
            tot[k] += g["per_forward"] * g[k]
    log(f"[time] one forward at batch {SERVE_BATCH} (16 launches): kernel {tot['ms']:.4f} ms, "
        f"plain {tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, "
        f"bound {tot['bound_ms']:.4f} ms; kernel share of p50 batch "
        f"{tot['ms'] / (lat['p50_s'] * 1e3):.3f}")

    # ---- 5. where one served batch's time goes on the device
    predictor._forward(first)
    serve_profile = profile_device(torch, lambda: predictor._forward(first))
    log_profile("profile", "one served batch", serve_profile)
    del predictor

    # ---- 6. #2 and #3 vs plain at every block geometry of the training batch
    rate = float(cfg["SW_Transformer"]["attn_drop_rate"])
    tgeos = block_geometries(cfg, 2 * TRAIN_BATCH)
    drop_err = grad_err = grad_abs = 0.0
    for gi, g in enumerate(tgeos):
        args = make_inputs(torch, g, gen, dev)
        y, keep = fwd_drop(*args, 1000 + gi, rate)
        torch.cuda.synchronize()
        err = float((y - pk.fused_window_block_dropout_reference(*args, keep, rate)).abs().max())
        kept = float(keep.double().mean())
        sigma = math.sqrt(rate * (1 - rate) / keep.numel())
        dy = torch.randn(y.shape, generator=gen).to(dev)
        tr = transposed(args)
        errs = {}
        for tag, kp in (("keep", keep), ("nomask", None)):
            got = bwd(*args, dy, kp, rate, *tr)
            torch.cuda.synchronize()
            want = pk.fused_window_block_backward_reference(*args, dy, kp, rate)
            errs[tag] = max(rel_err(a, b) for a, b in zip(got, want))
            grad_abs = max(grad_abs, *(float((a - b).abs().max()) for a, b in zip(got, want)))
        g.update(max_abs_err_fwd=err, keep_rate=kept, keep_sigma=sigma, max_rel_err_bwd=errs["keep"],
                 max_rel_err_bwd_nomask=errs["nomask"])
        drop_err, grad_err = max(drop_err, err), max(grad_err, *errs.values())
        log(f"[check-train] {g['name']}: windows {g['windows']} C {g['C']} nW {g['nW']}: "
            f"#2 max|kernel-plain| {err:.3e}, keep rate {kept:.5f} ({(kept - 1 + rate) / sigma:+.2f} "
            f"sigma); #3 max rel err {errs['keep']:.3e} (mask), {errs['nomask']:.3e} (no mask)")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{g['name']}: #2 differs from plain by {err}")
        if not abs(kept - (1 - rate)) <= 5 * sigma:
            raise AssertionError(f"{g['name']}: keep rate {kept} is not 1 - {rate} within 5 sigma")
        if not max(errs.values()) <= GRAD_TOL:
            raise AssertionError(f"{g['name']}: #3 gradients differ from plain by {errs}")

    # ---- 7. the training path: FOCAL pretrain steps at full width
    targs = parse_train_params(["-dataset", "MOD", "-model", "SW_Transformer",
                                "-learn_framework", "FOCAL", "-stage", "pretrain",
                                "-batch_size", str(TRAIN_BATCH)])
    train, (state, step, tdata, idx) = run_train_steps(
        torch, np, targs, TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, all_kernels,
        {fwd_drop.__name__: per_fwd, bwd.__name__: per_fwd}, dev, "train")
    train_launches = train["launches"]
    p50_ms = train["p50_ms"]

    # ---- 8. #2 and #3 timing per training geometry
    ttot = {k: 0.0 for k in ("fwd_ms", "fwd_plain_ms", "fwd_library_ms", "fwd_bound_ms",
                             "bwd_ms", "bwd_plain_ms", "bwd_library_ms", "bwd_bound_ms")}
    tflops = {"fwd": [0, 0], "bwd": [0, 0]}
    for gi, g in enumerate(tgeos):
        args = make_inputs(torch, g, gen, dev)
        x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
        attn_mask = library_mask(torch, g, rel_bias, mask)
        _, keep = fwd_drop(*args, 7, rate)
        dy = torch.randn(x.shape, generator=gen).to(dev)
        g["fwd_ms"] = time_ms(torch, lambda: fwd_drop(*args, 7, rate))
        g["fwd_plain_ms"] = time_ms(
            torch, lambda: pk.fused_window_block_dropout_reference(*args, keep, rate))
        g["fwd_library_ms"] = time_ms(torch, lambda: library_block(
            torch, x, wqkv, bqkv, wproj, bproj, attn_mask, g["heads"], rate))
        tr = transposed(args)
        g["bwd_ms"] = time_ms(torch, lambda: bwd(*args, dy, keep, rate, *tr))
        g["bwd_plain_ms"] = time_ms(
            torch, lambda: pk.fused_window_block_backward_reference(*args, dy, keep, rate))
        g["bwd_library_ms"] = library_backward_ms(torch, g, args, dy, rate)
        f, b, g["fwd_bound_ms"], g["fwd_bound_by"] = work_dropout(g)
        tflops["fwd"][0] += f * g["per_forward"]
        tflops["fwd"][1] += b * g["per_forward"]
        f2, b2, g["bwd_bound_ms"], g["bwd_bound_by"] = work_backward(g, True)
        tflops["bwd"][0] += f2 * g["per_forward"]
        tflops["bwd"][1] += b2 * g["per_forward"]
        g["fwd_gflop"], g["bwd_gflop"] = f / 1e9, f2 / 1e9
        log(f"[time-train] {g['name']}: #2 {g['fwd_ms']:.4f} ms (plain {g['fwd_plain_ms']:.4f}, "
            f"library {g['fwd_library_ms']:.4f}, bound {g['fwd_bound_ms']:.4f}, "
            f"{f / g['fwd_ms'] / 1e9:.2f} TFLOP/s); #3 {g['bwd_ms']:.4f} ms (plain "
            f"{g['bwd_plain_ms']:.4f}, library {g['bwd_library_ms']:.4f}, bound "
            f"{g['bwd_bound_ms']:.4f}, {f2 / g['bwd_ms'] / 1e9:.2f} TFLOP/s)")
        for k in ttot:
            ttot[k] += g["per_forward"] * g[k]
    log(f"[time-train] one step (16 launches each): #2 {ttot['fwd_ms']:.3f} ms (plain "
        f"{ttot['fwd_plain_ms']:.3f}, library {ttot['fwd_library_ms']:.3f}, bound "
        f"{ttot['fwd_bound_ms']:.3f}); #3 {ttot['bwd_ms']:.3f} ms (plain {ttot['bwd_plain_ms']:.3f}, "
        f"library {ttot['bwd_library_ms']:.3f}, bound {ttot['bwd_bound_ms']:.3f}); "
        f"share of the p50 step {(ttot['fwd_ms'] + ttot['bwd_ms']) / p50_ms:.3f}")

    # ---- 9. where one training step's time goes on the device
    train_profile = profile_device(torch, lambda: step(state, tdata, idx))
    log_profile("profile-train", "one training step", train_profile, top=15)
    train["idle_share"] = 1 - train_profile["device_busy_ms"] / train_profile["wall_ms"]
    del state, step, tdata, idx
    torch.cuda.empty_cache()

    # ---- 10. #4 and #5 vs plain at every per-head geometry of MOD_WIDE
    wcfg = load_yaml(os.path.join(HERE, "focal_tpu_torch", "configs", "MOD_WIDE.yaml"))
    wrate = float(wcfg["SW_Transformer"]["attn_drop_rate"])
    wgeos = block_geometries(wcfg, 2 * WIDE_BATCH)
    mono = [g for g in wgeos if pk.wblock_fits(g["N"], g["C"], g["heads"])]
    pgeos = [g for g in wgeos if not pk.wblock_fits(g["N"], g["C"], g["heads"])]
    wide_per_step = {
        fwd_drop.__name__: sum(g["per_forward"] for g in mono),
        bwd.__name__: sum(g["per_forward"] for g in mono),
        ph_fwd.__name__: sum(g["per_forward"] for g in pgeos),
        ph_bwd.__name__: sum(g["per_forward"] for g in pgeos),
    }
    wide_per_eval = {fwd.__name__: sum(g["per_forward"] for g in mono),
                     ph_fwd.__name__: sum(g["per_forward"] for g in pgeos)}
    log(f"[check-wide] MOD_WIDE: {len(mono)} monolithic geometries (C "
        f"{sorted({g['C'] for g in mono})}), {len(pgeos)} per-head (C "
        f"{sorted({g['C'] for g in pgeos})}); per step {wide_per_step}")
    ph_err = ph_drop_err = ph_grad_err = ph_grad_abs = 0.0
    for gi, g in enumerate(pgeos):
        args = make_inputs(torch, g, gen, dev)
        y0, none = ph_fwd(*args)
        y, keep = ph_fwd(*args, 2000 + gi, wrate)
        torch.cuda.synchronize()
        if none is not None:
            raise AssertionError("#4 at rate 0 returned a keep mask")
        err0 = float((y0 - pk.fused_window_block_reference(*args)).abs().max())
        err = float((y - pk.fused_window_block_reference(*args, keep, wrate)).abs().max())
        kept = float(keep.double().mean())
        sigma = math.sqrt(wrate * (1 - wrate) / keep.numel())
        same_mask = None
        if g["C"] == 512:
            same_mask = bool(torch.equal(fwd_drop(*args, 2000 + gi, wrate)[1], keep))
        dy = torch.randn(y.shape, generator=gen).to(dev)
        tr = transposed(args)
        errs = {}
        for tag, kp in (("keep", keep), ("nomask", None)):
            got = ph_bwd(*args, dy, kp, wrate, *tr)
            again = ph_bwd(*args, dy, kp, wrate, *tr)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{g['name']}: #5 gives other bits on a second call ({tag})")
            want = pk.fused_window_block_backward_reference(*args, dy, kp, wrate)
            errs[tag] = max(rel_err(a, b) for a, b in zip(got, want))
            ph_grad_abs = max(ph_grad_abs, *(float((a - b).abs().max()) for a, b in zip(got, want)))
        g.update(max_abs_err_rate0=err0, max_abs_err_fwd=err, keep_rate=kept, keep_sigma=sigma,
                 mask_equals_2=same_mask, max_rel_err_bwd=errs["keep"],
                 max_rel_err_bwd_nomask=errs["nomask"])
        ph_err, ph_drop_err = max(ph_err, err0), max(ph_drop_err, err)
        ph_grad_err = max(ph_grad_err, *errs.values())
        log(f"[check-wide] {g['name']}: windows {g['windows']} C {g['C']} nW {g['nW']}: #4 "
            f"max|kernel-plain| {err0:.3e} (rate 0), {err:.3e} (dropout), keep rate {kept:.5f} "
            f"({(kept - 1 + wrate) / sigma:+.2f} sigma), mask == #2's: {same_mask}; #5 max rel err "
            f"{errs['keep']:.3e} (mask), {errs['nomask']:.3e} (no mask), repeatable")
        if not max(err0, err) <= KERNEL_TOL:
            raise AssertionError(f"{g['name']}: #4 differs from plain by {err0}, {err}")
        if not abs(kept - (1 - wrate)) <= 5 * sigma:
            raise AssertionError(f"{g['name']}: keep rate {kept} is not 1 - {wrate} within 5 sigma")
        if same_mask is False:
            raise AssertionError(f"{g['name']}: #4's keep mask differs from #2's")
        if not max(errs.values()) <= GRAD_TOL:
            raise AssertionError(f"{g['name']}: #5 gradients differ from plain by {errs}")
        del args, y0, y, keep, dy, tr
    torch.cuda.empty_cache()

    # ---- 11. the training entry point at MOD_WIDE, then -resume
    train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
    run_dir = os.path.join(HERE, "build", "chip_smoke_train")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["-dataset", "MOD_WIDE", "-model", "SW_Transformer", "-learn_framework", "FOCAL",
            "-stage", "pretrain", "-synthetic", "-synthetic_samples", str(WIDE_SAMPLES),
            "-batch_size", str(WIDE_BATCH), "-val_epochs", "1", "-output_dir", run_dir]
    wargs = parse_train_params(argv)
    plan_batches = {o: len(DeviceDataLoader(load_split(o, wargs), WIDE_BATCH, sequence=True))
                    for o in ("train", "val", "test")}
    # a validation point: train features for the probe; per split, two views
    # for the loss and the features
    evals_per_point = plan_batches["train"] + 3 * (plan_batches["val"] + plan_batches["test"])
    cli_runs = []
    for extra, points_want in ((["-epochs", "2"], [0, 1]), (["-epochs", "3", "-resume"], [2])):
        zero_counts(all_kernels)
        t0 = time.time()
        st, best, points = train_cli.main(argv + extra)
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = counts(all_kernels)
        n_steps = st.step - (cli_runs[-1]["step"] if cli_runs else 0)
        n_evals = len(points) * evals_per_point
        want = {k.__name__: wide_per_step.get(k.__name__, 0) * n_steps
                + wide_per_eval.get(k.__name__, 0) * n_evals for k in all_kernels}
        if [p["epoch"] for p in points] != points_want:
            raise AssertionError(f"validation points {[p['epoch'] for p in points]} != {points_want}")
        for p in points:
            if not all(math.isfinite(p[k]) for k in ("train_loss", "val_loss", "test_loss")):
                raise AssertionError(f"non-finite loss at a validation point: {p}")
        check_counts(f"train CLI {' '.join(extra)}", got, want)
        folder = os.path.join(run_dir, "weights", "MOD_WIDE_SW_Transformer")
        (exp,) = [d for d in os.listdir(folder) if d.startswith("exp")]
        for kind in ("latest", "best", "resume"):
            path = os.path.join(folder, exp, f"MOD_WIDE_SW_Transformer_pretrain_{kind}.pt")
            if not os.path.isfile(path):
                raise AssertionError(f"missing checkpoint {path}")
        cli_runs.append({"argv": extra, "seconds": secs, "step": st.step, "steps": n_steps,
                         "eval_forwards": n_evals, "launches": got, "points": points,
                         "best": best})
        log(f"[train-cli] MOD_WIDE {' '.join(extra)}: {n_steps} steps, {n_evals} eval forwards "
            f"in {secs:.1f}s; launches {got}; points " + "; ".join(
                f"epoch {p['epoch']} train {p['train_loss']:.4f} val {p['val_loss']:.4f} "
                f"test {p['test_loss']:.4f} val acc {p['val_acc']:.3f}" for p in points))
        del st
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 12. MOD_WIDE pretrain steps timed, the rate-0 step, one profiled step
    wtargs = parse_train_params(["-dataset", "MOD_WIDE", "-model", "SW_Transformer",
                                 "-learn_framework", "FOCAL", "-stage", "pretrain",
                                 "-batch_size", str(WIDE_BATCH)])
    wide, (state, step, tdata, idx) = run_train_steps(
        torch, np, wtargs, WIDE_BATCH, TRAIN_WARMUP, WIDE_STEPS, all_kernels, wide_per_step, dev,
        "train-wide", rate0_at_init=True)
    wide_profile = profile_device(torch, lambda: step(state, tdata, idx))
    log_profile("profile-wide", "one MOD_WIDE training step", wide_profile, top=15)
    wide["idle_share"] = 1 - wide_profile["device_busy_ms"] / wide_profile["wall_ms"]
    del state, step, tdata, idx
    torch.cuda.empty_cache()

    # ---- 13. #4 and #5 timing per geometry; #1 and #3 beside them at C = 512
    wtot = {k: 0.0 for k in ("fwd_ms", "fwd_plain_ms", "fwd_library_ms", "fwd_bound_ms",
                             "bwd_ms", "bwd_plain_ms", "bwd_library_ms", "bwd_bound_ms",
                             "eval_ms", "eval_plain_ms", "eval_library_ms", "eval_bound_ms")}
    wflops = {"fwd": [0, 0], "bwd": [0, 0]}
    for g in pgeos:
        args = make_inputs(torch, g, gen, dev)
        x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
        attn_mask = library_mask(torch, g, rel_bias, mask)
        _, keep = ph_fwd(*args, 7, wrate)
        dy = torch.randn(x.shape, generator=gen).to(dev)
        tr = transposed(args)
        g["eval_ms"] = time_ms(torch, lambda: ph_fwd(*args))
        g["eval_plain_ms"] = time_ms(torch, lambda: pk.fused_window_block_reference(*args))
        g["eval_library_ms"] = time_ms(torch, lambda: library_block(
            torch, x, wqkv, bqkv, wproj, bproj, attn_mask, g["heads"]))
        g["fwd_ms"] = time_ms(torch, lambda: ph_fwd(*args, 7, wrate))
        g["fwd_plain_ms"] = time_ms(
            torch, lambda: pk.fused_window_block_reference(*args, keep, wrate))
        g["fwd_library_ms"] = time_ms(torch, lambda: library_block(
            torch, x, wqkv, bqkv, wproj, bproj, attn_mask, g["heads"], wrate))
        g["bwd_ms"] = time_ms(torch, lambda: ph_bwd(*args, dy, keep, wrate, *tr))
        g["bwd_plain_ms"] = time_ms(
            torch, lambda: pk.fused_window_block_backward_reference(*args, dy, keep, wrate))
        g["bwd_library_ms"] = library_backward_ms(torch, g, args, dy, wrate)
        _, _, g["eval_bound_ms"], _ = work(g)
        f, b, g["fwd_bound_ms"], g["fwd_bound_by"] = work_dropout(g)
        f2, b2, g["bwd_bound_ms"], g["bwd_bound_by"] = work_backward(g, True)
        wflops["fwd"] = [wflops["fwd"][0] + f * g["per_forward"], wflops["fwd"][1] + b * g["per_forward"]]
        wflops["bwd"] = [wflops["bwd"][0] + f2 * g["per_forward"], wflops["bwd"][1] + b2 * g["per_forward"]]
        mono_note = ""
        if g["C"] == 512:  # the monolithic kernels launch at this width too
            g["mono_eval_ms"] = time_ms(torch, lambda: fwd(*args))
            g["mono_bwd_ms"] = time_ms(torch, lambda: bwd(*args, dy, keep, wrate, *tr))
            mono_note = (f"; beside them #1 {g['mono_eval_ms']:.4f} ms, "
                         f"#3 {g['mono_bwd_ms']:.4f} ms")
        log(f"[time-wide] {g['name']}: #4 {g['eval_ms']:.4f} ms at rate 0 (plain "
            f"{g['eval_plain_ms']:.4f}, library {g['eval_library_ms']:.4f}, bound "
            f"{g['eval_bound_ms']:.4f}), {g['fwd_ms']:.4f} ms with dropout (plain "
            f"{g['fwd_plain_ms']:.4f}, library {g['fwd_library_ms']:.4f}, bound "
            f"{g['fwd_bound_ms']:.4f}, {f / g['fwd_ms'] / 1e9:.2f} TFLOP/s); #5 {g['bwd_ms']:.4f} ms "
            f"(plain {g['bwd_plain_ms']:.4f}, library {g['bwd_library_ms']:.4f}, bound "
            f"{g['bwd_bound_ms']:.4f}, {f2 / g['bwd_ms'] / 1e9:.2f} TFLOP/s){mono_note}")
        for k in wtot:
            wtot[k] += g["per_forward"] * g[k]
        del args, x, wqkv, keep, dy, tr, attn_mask
    n_ph = wide_per_step[ph_fwd.__name__]
    log(f"[time-wide] one MOD_WIDE step ({n_ph} launches each): #4 {wtot['fwd_ms']:.3f} ms (plain "
        f"{wtot['fwd_plain_ms']:.3f}, library {wtot['fwd_library_ms']:.3f}, bound "
        f"{wtot['fwd_bound_ms']:.3f}); #5 {wtot['bwd_ms']:.3f} ms (plain {wtot['bwd_plain_ms']:.3f}, "
        f"library {wtot['bwd_library_ms']:.3f}, bound {wtot['bwd_bound_ms']:.3f}); share of the "
        f"p50 step {(wtot['fwd_ms'] + wtot['bwd_ms']) / wide['p50_ms']:.3f}; one eval forward's "
        f"#4 {wtot['eval_ms']:.3f} ms")
    log(f"[smoke] {time.time() - t_start:.1f}s after the build started")

    if cli.out:
        os.makedirs(cli.out, exist_ok=True)
        with open(os.path.join(cli.out, "chip_smoke.json"), "w") as f:
            json.dump({
                "card": card,
                "geometries": [{k: v for k, v in g.items() if k != "mask"} for g in geos],
                "train_geometries": [{k: v for k, v in g.items() if k != "mask"} for g in tgeos],
                "wide_geometries": [{k: v for k, v in g.items() if k != "mask"} for g in pgeos],
                "per_forward": tot, "per_step": ttot, "wide_per_step": wtot, "latency": lat,
                "launches": launches, "slice_err": slice_err, "profile": serve_profile,
                "train": train, "train_profile": train_profile, "wide": wide,
                "wide_profile": wide_profile, "train_cli": cli_runs,
            }, f, indent=1)

    def entry(name, replaces, launches_, err, ms, plain, bnd, flops_bytes, lib, per, **extra):
        ops_t, byte_t = flops_bytes[0] / F32_FLOPS, flops_bytes[1] / HBM_BYTES_PER_S
        return {"name": name, "route": "cuda", "source": "focal_tpu_torch/csrc/window_block.cu",
                "replaces": replaces, "launches": launches_, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bnd,
                "bound_by": "operations" if ops_t >= byte_t else "bytes", "library_ms": lib,
                "per": per, **extra}

    by_path = {k.__name__: {"serve_MOD": serve_launches[k.__name__],
                            "pretrain_steps_MOD": train_launches[k.__name__],
                            "train_cli_MOD_WIDE": sum(r["launches"][k.__name__] for r in cli_runs),
                            "pretrain_steps_MOD_WIDE": wide["launches"][k.__name__]}
               for k in all_kernels}
    cli_launches = by_path[ph_fwd.__name__]["train_cli_MOD_WIDE"]
    train_per = (f"times: one pretrain step at batch {TRAIN_BATCH} (views fused to "
                 f"{2 * TRAIN_BATCH}), 16 launches; launches: {TRAIN_STEPS} timed steps")
    wide_per = (f"times: one MOD_WIDE pretrain step at batch {WIDE_BATCH} (views fused to "
                f"{2 * WIDE_BATCH}), {n_ph} launches; launches: the MOD_WIDE train CLI run "
                f"({sum(r['steps'] for r in cli_runs)} steps, "
                f"{sum(r['eval_forwards'] for r in cli_runs)} eval forwards)")
    kernels = [
        entry("fused_window_block", f"{PK}:949", launches, max_err, tot["ms"], tot["plain_ms"],
              tot["bound_ms"], (tot["flops"], tot["bytes"]), tot["library_ms"],
              f"times: one forward at batch {SERVE_BATCH}, 16 launches over {len(geos)} "
              f"geometries; launches: all {batches} forwards of the served run",
              launches_per_forward=per_fwd, forwards=batches, launches_by_path=by_path[fwd.__name__]),
        entry("fused_window_block_dropout", f"{PK}:1432", train_launches[fwd_drop.__name__],
              drop_err, ttot["fwd_ms"], ttot["fwd_plain_ms"], ttot["fwd_bound_ms"], tflops["fwd"],
              ttot["fwd_library_ms"], train_per, launches_per_step=per_fwd, steps=TRAIN_STEPS,
              launches_by_path=by_path[fwd_drop.__name__]),
        entry("fused_window_block_backward", f"{PK}:971",
              train_launches[bwd.__name__], grad_abs, ttot["bwd_ms"],
              ttot["bwd_plain_ms"], ttot["bwd_bound_ms"], tflops["bwd"], ttot["bwd_library_ms"],
              train_per, launches_per_step=per_fwd, steps=TRAIN_STEPS, max_rel_err=grad_err,
              launches_by_path=by_path[bwd.__name__]),
        entry("fused_window_block_perhead", f"{PK}:1123", cli_launches,
              max(ph_err, ph_drop_err), wtot["fwd_ms"], wtot["fwd_plain_ms"], wtot["fwd_bound_ms"],
              wflops["fwd"], wtot["fwd_library_ms"], wide_per, launches_per_step=n_ph,
              launches_per_eval_forward=wide_per_eval[ph_fwd.__name__],
              eval_forward_ms=wtot["eval_ms"], launches_by_path=by_path[ph_fwd.__name__]),
        entry("fused_window_block_perhead_backward", f"{PK}:1166",
              by_path[ph_bwd.__name__]["train_cli_MOD_WIDE"], ph_grad_abs, wtot["bwd_ms"],
              wtot["bwd_plain_ms"], wtot["bwd_bound_ms"], wflops["bwd"], wtot["bwd_library_ms"],
              wide_per, launches_per_step=n_ph, max_rel_err=ph_grad_err,
              launches_by_path=by_path[ph_bwd.__name__]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
