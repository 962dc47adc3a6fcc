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
     version as max|kernel - plain| / max|plain| <= 1e-4 (long f32 sums)
     and the same bits on a second call, #3 given the weights' [out, in]
     copies as the Swin block gives them;
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
     the library block), the bounds on the f32 CUDA cores, on the TF32
     tensor cores (3 passes) and by the bytes the design moves
     (design_bytes), TFLOP/s; then five profiled calls of each of #2 and
     #3 at every training geometry, which fail the run if any device
     kernel they launch is not one of csrc/window_block.cu's, their time
     split by kernel name into GEMM, attention, weight gradient and
     reduction;
  9. a torch.profiler trace of one training step (#2/#3's device time in
     it by phase), the step beside the one with the per-window #2/#3
     (PARENT_STEPS);
 10. kernels #4 and #5 vs plain at every per-head block geometry of
     MOD_WIDE (C 512 and 1024, 4 heads) at the wide training batch (64
     samples, views fused to 128): #4 at rate 0 (1e-4 absolute), #4 with
     dropout against the plain forward fed its own mask (1e-4 absolute,
     keep rate within 5 sigma), #4's mask equal to #2's bit for bit at
     every per-head geometry (#2 launches at C = 1024 too), #5's six
     gradients with #4's mask and without (1e-4 relative) and the same bits
     on a second call;
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
     and a torch.profiler trace of one step (#2-#5's device time in it by
     phase); p50, samples/s, idle share and peak memory printed beside the
     step with the per-window #2/#3 (PARENT_STEPS);
 13. timing of #4 and #5 at each per-head geometry (kernel, plain, library,
     bounds and TFLOP/s as phase 8 times #2 and #3; #4 at rate 0, and #1
     beside it at C = 512), #2 and #3 at MOD_WIDE stage 0 as phase 8; then
     the profiled calls of phase 8 for #2/#3 at stage 0 and for #4/#5 at
     every per-head geometry;
 14. kernels #13 (fused_conv_tower) and #14 (fused_conv_tower_backward) vs
     plain at every conv-tower geometry of the DeepSense pretrain step: MOD
     (batch 256, views fused to 512: R 5,120 rows of S 20, C 64) and
     MOD_WIDE (batch 128 fused to 256, C 256), seismic (first conv inside,
     KW 3, Cin 2) and audio (first conv outside, KW 5): output, batch means
     and variances <= 1e-5 relative, the five gradients <= 1e-4 relative
     (absolutely to 1e-2 where both are below 1e-2: conv biases before a
     BatchNorm), the same bits on a second call;
 15. DeepSense pretrain steps (flax-style init, synthetic data resident on
     the card), MOD_WIDE at batch 128 (views fused to 256; 3 warm-up + 10
     timed) and MOD at batch 256 (3 + 20), on the default path (cuDNN
     convs, no kernel launched) and with -pallas_conv (#13 11 and #14 20
     launches a step at either): p50, samples/s, peak memory and a
     profiled step's idle share, device busy time and #13/#14's share of
     it; a dropout-0 MOD step, kernels vs plain, from the initial state
     (loss 1e-5, gradients 1e-4 relative, running statistics 1e-5) and
     from the trained one (reported);
 16. the entry point: python -m focal_tpu_torch.train -dataset MOD -model
     DeepSense -pallas_conv -synthetic in-process, 2 epochs with validation,
     then -resume to 3: finite losses, the three checkpoint files with the
     running statistics, #13/#14 launches only in the steps (eval forwards
     launch nothing); then Predictor serves the _best file over ~1,000
     synthetic samples at batch 128 (no kernel launched);
 17. timing of #13 and #14 per tower geometry (kernel, plain version, the
     unfused cuDNN chain and its autograd backward as the library
     yardstick, the bounds on the f32 CUDA cores and on the TF32 tensor
     cores (3 passes)), summed over a MOD and a MOD_WIDE step; then five
     profiled calls of each at every geometry, which fail the run if a
     device kernel other than csrc/conv_tower.cu's and PyTorch's own
     [C]-sized steps between the wrappers' calls runs, their device time
     split by kernel ([profile-tower]: products, weight gradients,
     elementwise passes, reductions, the first conv on the CUDA cores);
 18. kernels #10 (fused_mlp_forward), #11 (fused_mlp_dropout_forward) and
     #12 (fused_mlp_backward) vs plain at every MLP geometry on the fused
     route: MOD at batch 128 (C 64/128/256, 16 blocks) and MOD_WIDE stage 0
     (C 256, batch 64 fused to 128): #10, and #11 fed its own masks
     (mlp_keep_masks), <= 1e-4 absolute; #12's five gradients with the
     masks and without <= 1e-4 relative; each mask's keep rate within 5
     sigma of 0.8; the same bits on a second call;
 19. MOD supervised steps at batch 128 (fixed pool: mixup, phase_shift):
     3 warm-up + 20 timed on the default path (#2/#3 16 a step, no MLP
     kernel) and with -pallas_mlp (#2, #3, #11, #12 16 each), p50,
     samples/s, peak memory, a profiled step's idle share, top device
     kernels and #10-#12's device time by phase; the -pallas_mlp step
     beside the one with the CUDA-core #10-#12 (PARENT_STEPS); a rate-0
     step from the initial state, kernels (#1, #3, #10, #12 16 each) vs
     plain: loss 1e-5 relative, gradients 1e-4;
 20. the entry points in-process at MOD with -pallas_mlp and -synthetic (512
     samples): supervised 2 epochs, -resume to 3, focal_tpu_torch.test on
     its _best; FOCAL pretrain 1 epoch, finetune 2 epochs, -resume to 3,
     test: the launches per step (finetune: #2 and #11 only, the backbone
     frozen) and per eval forward (#1 and #10 16 each) held exactly, every
     backbone entry of the finetuned files bitwise the pretrained one,
     class_layer and mod_fusion_layer moved; Predictor -pallas_mlp over
     ~1,000 samples (#1 and #10 16 a batch), its probabilities within 1e-5
     of phase 3's (the cuBLAS MLP, same weights);
 21. timing of #10, #11 and #12 per geometry (kernel, plain version, the
     cuBLAS chain addmm -> GELU -> addmm with F.dropout for #11 and its
     autograd backward for #12 as the library yardstick, the bounds on the
     f32 CUDA cores and on the TF32 tensor cores (3 passes), TFLOP/s), then
     profiled calls of each at every geometry (at least 5 and 20 ms of
     them), which fail the run if
     any device kernel they launch is not one of csrc/fused_mlp.cu's, their
     time split by kernel name (hidden and output products, masked
     gradient, weight gradient, reduction);
 22. the attention-only kernels (-no_pallas_block) vs plain at every
     attention geometry: MOD at the served batch (128) and the training
     batch (256, views fused to 512), MOD_WIDE's 16 blocks at 64 fused to
     128 (hd 64 to 256), shifted and unshifted: #6, and #7 fed its own mask
     (window_attention_keep_mask), <= 1e-4 absolute; #8, and #9 with the
     mask, every gradient <= 1e-4 relative (absolutely to 1e-6 where both
     sides are below it) and the same bits on a second call; #7's keep rate
     within 5 sigma of 0.8 and its mask equal to #2's (#4's where #2 does
     not launch) bit for bit at the same seed and geometry;
 23. MOD pretrain steps with -no_pallas_block at batch 256: 3 warm-up + 20
     timed (#7 and #9 16 a step, nothing of #1-#5), p50, samples/s, peak
     memory, a profiled step's idle share and top device kernels; a rate-0
     step from the initial state, kernels (#6 and #8 16 each) vs plain:
     loss <= 1e-5 relative, gradients <= 1e-4;
 24. the entry points in-process at MOD with -no_pallas_block -synthetic
     (512 samples): supervised 1 epoch, -resume to 2, test on its _best;
     FOCAL pretrain 1 epoch, finetune 1 epoch (#7 only: the backbone is
     frozen), test on its _best: launches per step and per eval forward (#6
     16) held exactly; then Predictor(pallas_block=False) over ~1,000
     samples (#6 16 a batch), its probabilities within 1e-5 of phase 3's
     (#1's route, same weights), and a torch.profiler trace of one served
     batch (#6's device time);
 25. timing of #6-#9 per geometry (kernel, plain version, the library
     yardstick F.scaled_dot_product_attention with the bias materialised as
     attn_mask, dropout_p for #7, its autograd backward for #8/#9, and the
     bound), summed over one served MOD forward (#6) and one MOD training
     step (#7, #9; #8 at rate 0).

Prints a {"kernels": [...]} line, the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}. Needs one CUDA card; imports no JAX and
nothing of the JAX package. --out DIR writes the per-geometry details and
the profiles as JSON there.
"""

import argparse
import copy
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3;
# TF32 on the tensor cores (#4 and #5 run 3 TF32 products per f32 one)
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
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
# the pretrain steps with the per-window #2 and #3, before they ran on the
# tensor cores (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W)
PARENT_STEPS = {"MOD": {"p50_ms": 135.740, "idle_share": 0.256, "peak_mb": 6938.5},
                "MOD_WIDE": {"p50_ms": 210.455, "idle_share": 0.021, "peak_mb": 9716.9},
                # the -pallas_mlp MOD supervised step (batch 128) with #10-#12
                # on the CUDA cores
                "MOD_supervised_pallas_mlp": {"p50_ms": 102.901, "idle_share": 0.542,
                                              "peak_mb": 1043.5}}


def log(msg):
    print(msg, flush=True)


def kernel_of(ptxas_line):
    """The kernel a ptxas "Compiling entry function" line names, read from
    its mangled name (a length-prefixed identifier ending in _kernel, with
    its bool or int template arguments and its source tag: <true>,
    <128, true, false>, <64, FusedMlpSrc>). The last such identifier is
    the kernel's: an anonymous namespace's hash may also end in one."""
    found = [(int(m.group(1)), m.group(2))
             for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", ptxas_line)]
    for n, ident in reversed(found):
        if len(ident) >= n and ident[:n].endswith("_kernel"):
            rest = ident[n:]
            if not rest.startswith("I"):
                return ident[:n]
            args = [{"1": "true", "0": "false"}[v] if k == "b" else v
                    for k, v in re.findall(r"L([bi])(\d+)E", rest)]
            args += [t[:int(k)] for k, t in re.findall(r"(?=(\d+)([A-Za-z_]\w*))", rest)
                     if t[:int(k)].endswith("Src")]
            return f"{ident[:n]}<{', '.join(args)}>"
    return ptxas_line.strip()


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


def tc_bound(flops, nbytes):
    """The bound of #2-#5 on the units they run on: 3 TF32 products an f32
    one (3xTF32) at the tensor cores' TF32 peak, or the bytes."""
    return 1e3 * max(3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


def design_bytes(g, backward, sms):
    """Bytes that #2-#5 as designed move, each workspace written once and
    read once a phase: forward x -> qkv, qkv -> ao, ao -> y (10 C floats a
    row); backward x, dy -> qkv, g; qkv, g -> dqkv, ao; dqkv -> dx; x,
    dqkv, ao, dy -> the weight gradients (24 C); the keep mask, the weights
    and, in the backward, the split partials written and read (the split
    count as csrc/window_block.cu's bwd_plan sets it on ``sms`` SMs). What
    the algorithm needs is work()/work_backward()'s count."""
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]
    R = B * N
    keep = B * H * N * N
    if not backward:
        return 4 * (10 * R * C + 4 * C * C + 4 * C + H * N * N) + keep
    bn = 128 if C % 128 == 0 else 64  # the tile width (tile_bn)
    wtiles = -(-C // 128) * (-(-3 * C // bn) + -(-C // bn))
    splits = max(1, min(-(-4 * sms // wtiles), -(-R // 256)))
    rps = -(-R // splits)
    rps = -(-rps // 32) * 32
    E = 4 * C * C + 4 * C
    return 4 * (24 * R * C + 7 * C * C + 3 * C + 2 * H * N * N + 2 * -(-R // rps) * E + E) + keep


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


def time_training(torch, pk, fwd, bwd, names, g, gen, dev, rate, sms, tag):
    """The training forward ``fwd`` (#2 or #4, with dropout) and backward
    ``bwd`` (#3 or #5) at geometry g, stored in g: kernel, plain version and
    library yardstick times; the f32 bound (work_dropout, work_backward),
    the 3xTF32 one (tc_bound), the bound of the bytes the design moves
    (design_bytes); TFLOP/s."""
    args = make_inputs(torch, g, gen, dev)
    x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
    attn_mask = library_mask(torch, g, rel_bias, mask)
    _, keep = fwd(*args, 7, rate)
    dy = torch.randn(x.shape, generator=gen).to(dev)
    tr = transposed(args)
    g["fwd_ms"] = time_ms(torch, lambda: fwd(*args, 7, rate))
    g["fwd_plain_ms"] = time_ms(
        torch, lambda: pk.fused_window_block_dropout_reference(*args, keep, rate))
    g["fwd_library_ms"] = time_ms(torch, lambda: library_block(
        torch, x, wqkv, bqkv, wproj, bproj, attn_mask, g["heads"], rate))
    g["bwd_ms"] = time_ms(torch, lambda: bwd(*args, dy, keep, rate, *tr))
    g["bwd_plain_ms"] = time_ms(
        torch, lambda: pk.fused_window_block_backward_reference(*args, dy, keep, rate))
    g["bwd_library_ms"] = library_backward_ms(torch, g, args, dy, rate)
    for d, (f, b, bound_ms, by) in (("fwd", work_dropout(g)), ("bwd", work_backward(g, True))):
        g.update({f"{d}_flops": f, f"{d}_bytes": b, f"{d}_bound_ms": bound_ms,
                  f"{d}_bound_by": by, f"{d}_bound_tc_ms": tc_bound(f, b),
                  f"{d}_design_bytes": design_bytes(g, d == "bwd", sms),
                  f"{d}_tflops": f / g[f"{d}_ms"] / 1e9})
        g[f"{d}_bound_design_ms"] = 1e3 * g[f"{d}_design_bytes"] / HBM_BYTES_PER_S
    log(f"[{tag}] {g['name']} (windows {g['windows']}, C {g['C']}): " + "; ".join(
        f"{name} {g[f'{d}_ms']:.4f} ms (plain {g[f'{d}_plain_ms']:.4f}, library "
        f"{g[f'{d}_library_ms']:.4f}, bound f32 {g[f'{d}_bound_ms']:.4f}, TF32x3 "
        f"{g[f'{d}_bound_tc_ms']:.4f}, design bytes {g[f'{d}_bound_design_ms']:.4f}, "
        f"{g[f'{d}_tflops']:.2f} TFLOP/s)" for d, name in zip(("fwd", "bwd"), names)))


TRAIN_KEYS = tuple(f"{d}_{k}" for d in ("fwd", "bwd") for k in (
    "ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms", "bound_design_ms", "flops",
    "bytes", "design_bytes"))


def step_totals(geos, tag, names, launches):
    """time_training's numbers summed over one step (each geometry times
    its launches a forward), logged."""
    tot = {k: sum(g["per_forward"] * g[k] for g in geos) for k in TRAIN_KEYS}
    log(f"[{tag}] one step ({launches} launches each): " + "; ".join(
        f"{name} {tot[f'{d}_ms']:.3f} ms (plain {tot[f'{d}_plain_ms']:.3f}, library "
        f"{tot[f'{d}_library_ms']:.3f}, bound f32 {tot[f'{d}_bound_ms']:.3f}, TF32x3 "
        f"{tot[f'{d}_bound_tc_ms']:.3f}, design bytes {tot[f'{d}_bound_design_ms']:.3f} "
        f"({tot[f'{d}_design_bytes'] / 1e9:.3f} GB), {tot[f'{d}_flops'] / 1e9:.1f} GFLOP, "
        f"{tot[f'{d}_flops'] / tot[f'{d}_ms'] / 1e9:.2f} TFLOP/s)"
        for d, name in zip(("fwd", "bwd"), names)))
    return tot


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


@functools.lru_cache(maxsize=None)
def source_kernels(*files):
    """The names of the __global__ kernels of csrc/ files, read from the
    sources."""
    names = set()
    for name in files:
        with open(os.path.join(HERE, "focal_tpu_torch", "csrc", name)) as f:
            names |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", f.read()))
    return names


def kernel_name(row):
    """The bare kernel name of a profiler row (None for a copy or memset)."""
    m = re.search(r"::(\w+)(?:<[^()]*>)?\(", row)
    return m.group(1) if m else None


# a library's kernels: its source's, and gemm_splitk.cuh's (shared by
# window_block.cu and fused_mlp.cu) as it instantiates them, with its tag
# type in their names; the phase each kernel serves
SPLITK = "gemm_splitk.cuh"
WB_LIB = {"source": "window_block.cu", "tag": "WindowBlockSrc",
          "phases": {"proj_gemm_kernel": "GEMM", "attn_fwd_kernel": "attention",
                     "attn_bwd_kernel": "attention", "wgrad_gemm_kernel": "weight gradient",
                     "reduce_partials_kernel": "reduction"}}
MLP_LIB = {"source": "fused_mlp.cu", "tag": "FusedMlpSrc",
                   "phases": {"mlp_hidden_kernel": "hidden GEMM", "mlp_out_kernel": "output GEMM",
                              "mlp_g2_kernel": "masked gradient",
                              "wgrad_gemm_kernel": "weight gradient",
                              "reduce_partials_kernel": "reduction"}}
# how many times one call of #2 or #4 (fwd) or of #3 or #5 (bwd) launches each
WB_LAUNCHES = {"fwd": {"proj_gemm_kernel": 2, "attn_fwd_kernel": 1},
               "bwd": {"proj_gemm_kernel": 2, "attn_bwd_kernel": 1, "wgrad_gemm_kernel": 1,
                       "reduce_partials_kernel": 2}}
PROFILE_REPS = 5
PROFILE_TRACE_MS = 20.0


def owned_by(lib, row):
    """Whether a profiler row is a kernel of ``lib`` (WB_LIB or
    MLP_LIB)."""
    name = kernel_name(row)
    if name not in source_kernels(lib["source"], SPLITK):
        return False
    return name not in source_kernels(SPLITK) or lib["tag"] in row


def mlp_launches(chunks, d):
    """How many times one call of #10 or #11 (fwd) or of #12 with masks
    (bwd) launches each fused_mlp.cu kernel, in ``chunks`` row chunks."""
    if d == "fwd":
        return {"mlp_hidden_kernel": chunks, "mlp_out_kernel": chunks}
    return {"mlp_g2_kernel": chunks, "mlp_hidden_kernel": chunks, "mlp_out_kernel": chunks,
            "wgrad_gemm_kernel": chunks, "reduce_partials_kernel": 1}


def kernel_phase_split(torch, fn, launches, lib=WB_LIB, reps=PROFILE_REPS):
    """``reps`` calls of fn under torch.profiler; each kernel's device
    time per call (its mean per launch times ``launches[name]``: a short
    trace may lose a few records) and those times by ``lib``'s phases.
    Raises if a device kernel (or copy) ran that is not one of ``lib``'s
    (no cuBLAS or library kernel may run under the kernels' wrappers), or
    not one of ``launches``, or if one of ``launches`` left no record."""
    def calls():
        # pauses around the calls: in a process that had traced before, a
        # trace of one call (a few milliseconds) lost some or all records
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)

    prof = profile_device(torch, calls)
    kernels = {}
    for r in prof["rows"]:
        name = kernel_name(r["name"])
        if not owned_by(lib, r["name"]):
            raise AssertionError(f"a device kernel outside csrc/{lib['source']} ran: {r['name']}")
        if name not in launches:
            raise AssertionError(f"{name} ran; expected only {sorted(launches)}")
        k = kernels.setdefault(name, {"device_ms": 0.0, "count": 0})
        k["device_ms"] += r["device_ms"]
        k["count"] += r["count"]
    missing = set(launches) - set(kernels)
    if missing:
        raise AssertionError(f"the profile holds no record of {sorted(missing)}")
    phases = {}
    for name, k in kernels.items():
        k["ms_per_call"] = k["device_ms"] / k["count"] * launches[name]
        phase = lib["phases"][name]
        phases[phase] = phases.get(phase, 0.0) + k["ms_per_call"]
    return {"device_ms": sum(phases.values()), "phases": phases, "kernels": kernels, "reps": reps,
            "complete": all(k["count"] == reps * launches[n] for n, k in kernels.items())}


def trace_reps(torch, fn):
    """Calls of fn (warmed here) that a profiled trace takes: at least
    PROFILE_REPS and PROFILE_TRACE_MS of them by CUDA events."""
    return max(PROFILE_REPS, math.ceil(PROFILE_TRACE_MS / time_ms(torch, fn, iters=3, warmup=1)))


def block_profiles(torch, fwd, bwd, names, g, gen, dev, rate, tag):
    """The training forward ``fwd`` (#2 or #4, with dropout) and its
    backward ``bwd`` (#3 or #5) at geometry g profiled after a warm-up
    call, split by kernel name (kernel_phase_split); ``names`` label them."""
    args = make_inputs(torch, g, gen, dev)
    tr = transposed(args)
    dy = torch.randn(args[0].shape, generator=gen).to(dev)
    _, keep = fwd(*args, 7, rate)
    calls = {"fwd": lambda: fwd(*args, 7, rate), "bwd": lambda: bwd(*args, dy, keep, rate, *tr)}
    # at least PROFILE_TRACE_MS of calls: a trace of a few milliseconds can
    # lose every record of a kernel
    out = {d: kernel_phase_split(torch, fn, WB_LAUNCHES[d], reps=trace_reps(torch, fn))
           for d, fn in calls.items()}
    for d, name in zip(("fwd", "bwd"), names):
        s = out[d]
        log(f"[{tag}] {g['name']} (windows {g['windows']}, C {g['C']}) {name}: device "
            f"{s['device_ms']:.4f} ms a call; " + ", ".join(
                f"{p} {ms:.4f}" for p, ms in sorted(s["phases"].items(), key=lambda kv: -kv[1]))
            + "; records " + ", ".join(f"{k} x{v['count']}" for k, v in s["kernels"].items())
            + f" of {s['reps']} calls")
    return out


def profile_split(torch, fwd, bwd, names, geos, gen, dev, rate, tag):
    """block_profiles at every geometry of ``geos``; the device time by
    phase summed over one step (each geometry times its launches a
    forward)."""
    split = {"fwd": {}, "bwd": {}}
    for g in geos:
        g["profile"] = block_profiles(torch, fwd, bwd, names, g, gen, dev, rate, tag)
        for d in ("fwd", "bwd"):
            for phase, ms in g["profile"][d]["phases"].items():
                split[d][phase] = split[d].get(phase, 0.0) + g["per_forward"] * ms
    log(f"[{tag}] one step, device ms by phase: {names[0]} {split['fwd']}; "
        f"{names[1]} {split['bwd']}")
    return split


def block_device_ms(prof, lib=WB_LIB):
    """The device time of ``lib``'s kernels (#2-#5's by default) in a
    profiled step, by phase."""
    out = {}
    for r in prof["rows"]:
        if owned_by(lib, r["name"]):
            phase = lib["phases"][kernel_name(r["name"])]
            out[phase] = out.get(phase, 0.0) + r["device_ms"]
    return out


def beside_parent(tag, dataset, run):
    """The step beside the parent's (PARENT_STEPS)."""
    p = PARENT_STEPS[dataset]
    log(f"[{tag}] beside the per-window #2/#3 ({dataset}: p50 {p['p50_ms']:.3f} ms, idle share "
        f"{p['idle_share']:.3f}, peak {p['peak_mb']:.1f} MiB): p50 {run['p50_ms']:.3f} ms "
        f"({run['p50_ms'] / p['p50_ms']:.3f}x), {run['samples_per_s']:.1f} samples/s, idle share "
        f"{run['idle_share']:.3f}, peak memory {run['peak_mb']:.1f} MiB; #2-#5 device time in the "
        f"profiled step by phase (ms): {run['block_device_ms']}")


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
                    rate0_from="trained", rate0_launches=None):
    """Pretrain steps of the SW_Transformer at full width (flax-style init,
    seed 0, synthetic data resident on the card, a fixed idx as bench.py
    uses; the attention-only route with -no_pallas_block): warm-up, then
    timed steps with each kernel's launches per step checked; then one step
    with every drop rate at 0 through the kernels and through the plain
    versions, held to LOSS_TOL and GRAD_TOL (and, given
    ``rate0_launches``, the kernels' launches in it held to those): from
    the state ``rate0_from`` names, "trained" or "initial"; with
    "initial+trained" from the trained state as well, reported beside the
    same plain step on the host's CPU (another f32 summation order) but not
    held. Returns (summary, (state, step, data, idx))."""
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
    pallas_block = not targs.no_pallas_block
    model = build_backbone(targs.dataset_config, targs.model, targs.task, targs.learn_framework,
                           pallas_block=pallas_block)
    init_params(model, seed=0)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.to(dev)
    state = create_train_state(targs, model, steps_per_epoch=100, seed=0)
    step = make_pretrain_step(model, build_augmenter(targs), make_focal_loss(targs))
    t0 = time.time()
    for _ in range(warmup):
        state, metrics = step(state, tdata, idx)
    torch.cuda.synchronize()
    log(f"[{tag}] {targs.dataset} SW_Transformer pretrain{'' if pallas_block else ' -no_pallas_block'}"
        f", batch {batch} (views fused to {2 * batch}), "
        f"{sum(p.numel() for p in model.parameters())} parameters; "
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

    # the Swin module's kernel entry points and their plain versions
    entry_points = {"window_block": pk.window_block_reference,
                    "window_block_forward": pk.fused_window_block_reference,
                    "window_attention": pk.window_attention_reference,
                    "fused_window_attention": pk.fused_window_attention_reference}

    def rate0_step(weights, plain, device):
        """(loss, {name: gradient on the CPU}, launches) of one rate-0 step,
        through the kernels or, with ``plain``, their plain versions."""
        m = build_backbone(cfg0, targs.model, targs.task, targs.learn_framework,
                           pallas_block=pallas_block)
        m.load_state_dict(weights)
        m.to(device)
        st = create_train_state(args0, m, steps_per_epoch=100, seed=0)
        st.step = state.step
        data = {loc: {k: a.to(device) for k, a in mods.items()} for loc, mods in tdata.items()}
        if plain:
            for name, fn in entry_points.items():
                setattr(swin_mod, name, fn)
        zero_counts(kernels)
        try:
            _, mt = make_pretrain_step(m, build_augmenter(args0), make_focal_loss(args0))(
                st, data, idx.to(device))
            loss = float(mt["loss"])
        finally:
            for name in entry_points:
                setattr(swin_mod, name, getattr(pk, name))
        return loss, {n: None if p.grad is None else p.grad.cpu()
                      for n, p in m.named_parameters() if p.requires_grad}, counts(kernels)

    def differ(a, b):
        """(relative loss difference, worst relative gradient difference, its name)."""
        (loss_a, grads_a, _), (loss_b, grads_b, _) = a, b
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

    where = rate0_from.split("+")[0]
    kern = rate0_step(initial if where == "initial" else trained, False, dev)
    plain = rate0_step(initial if where == "initial" else trained, True, dev)
    loss_rel, step_grad_err, worst = differ(kern, plain)
    train.update(rate0_state=where, rate0_loss_kernel=kern[0], rate0_loss_plain=plain[0],
                 rate0_loss_rel=loss_rel, rate0_max_grad_rel=step_grad_err, rate0_worst=worst,
                 rate0_launches=kern[2])
    log(f"[{tag}] rate-0 step from the {where} state, kernels vs plain: loss {kern[0]:.6f} vs "
        f"{plain[0]:.6f} (rel {loss_rel:.2e}), max grad rel err {step_grad_err:.2e} ({worst}); "
        f"launches {kern[2]}")
    if not loss_rel <= LOSS_TOL:
        raise AssertionError(f"rate-0 loss differs: {kern[0]} vs {plain[0]}")
    if not step_grad_err <= GRAD_TOL:
        raise AssertionError(f"rate-0 gradients differ: {step_grad_err} at {worst}")
    if rate0_launches is not None:
        check_counts(f"{tag}: rate-0 step (kernels)", kern[2],
                     {k.__name__: rate0_launches.get(k.__name__, 0) for k in kernels})
        check_counts(f"{tag}: rate-0 step (plain)", plain[2], {k.__name__: 0 for k in kernels})
    del kern, plain
    if rate0_from == "initial+trained":
        # the trained state, not held: the same comparison, and the plain
        # step on the card against the plain step on the CPU
        kern = rate0_step(trained, False, dev)
        plain = rate0_step(trained, True, dev)
        host = rate0_step(trained, True, torch.device("cpu"))
        kp, pc = differ(kern, plain), differ(plain, host)
        train.update(trained_rate0_kernel_vs_plain=kp, trained_rate0_plain_card_vs_cpu=pc,
                     trained_rate0_losses=[kern[0], plain[0], host[0]])
        log(f"[{tag}] rate-0 step from the trained state (not held): loss kernels {kern[0]:.6f}, "
            f"plain {plain[0]:.6f}, plain on the CPU {host[0]:.6f}; kernels vs plain: loss rel "
            f"{kp[0]:.2e}, max grad rel {kp[1]:.2e} ({kp[2]}); plain on the card vs on the CPU: "
            f"loss rel {pc[0]:.2e}, max grad rel {pc[1]:.2e} ({pc[2]})")
        del kern, plain, host
    return train, (state, step, tdata, idx)


# ---------------------------------------------------------------------------
# DeepSense and its conv-tower kernels (#13, #14)

DS_BATCH = 256            # DeepSense MOD samples per step; views fused to 512
DS_WIDE_BATCH = 128       # DeepSense MOD_WIDE samples per step; views fused to 256
DS_SAMPLES = 512          # MOD synthetic train split of the DeepSense entry-point run
TOWER_TOL = 1e-5          # relative: output, batch means and variances
# a gradient below NEAR_ZERO on both sides is compared absolutely, to
# NEAR_ZERO, as the JAX package's own test holds its kernels: a conv bias
# before a BatchNorm has a true gradient of 0, and both sides sum ~1e5 rows
# of cancellation noise (~1e-3)
NEAR_ZERO = 1e-2
# operations an element of a layer's output, besides its conv: forward the
# two stat sums (3), the BN affine (2), the GELU with its erf (~20), the mask
# and the residual (2); backward the GELU derivative (~25), x-hat and gy (4),
# the two sums (4), dc (5), the residual (1) and db (1)
FWD_ELEM_OPS = 27
BWD_ELEM_OPS = 40
CT = "focal_tpu/ops/conv_tower.py"
# csrc/conv_tower.cu's kernels (and gemm_splitk.cuh's reduction as it
# instantiates it, tagged ConvTowerSrc) and the part of #13/#14 each serves
TOWER_LIB = {"source": "conv_tower.cu", "tag": "ConvTowerSrc",
             "phases": {"conv_gemm_kernel": "products", "conv_wgrad_kernel": "weight gradients",
                        "bn_elementwise_kernel": "elementwise passes",
                        "tap_transpose_kernel": "elementwise passes",
                        "bn_grad_sums_kernel": "reductions", "reduce_partials_kernel": "reductions",
                        "bn_stats_kernel": "reductions", "bn_grad_stats_kernel": "reductions",
                        "narrow_conv_kernel": "first conv (CUDA cores)",
                        "narrow_convT_kernel": "first conv (CUDA cores)",
                        "narrow_wgrad_kernel": "first conv (CUDA cores)"}}
TOWER_KERNEL_NAMES = tuple(TOWER_LIB["phases"])
# an external first conv's BN statistics and coefficients are PyTorch's
# own kernels, between #13's calls
TORCH_PHASE = "[C]-sized steps (PyTorch)"


def tower_geometries(cfg, samples, dataset):
    """The conv towers of one DeepSense train forward at ``samples`` (the
    views fused): per modality R = samples * intervals rows of S positions,
    its layer configs and whether the first conv runs outside."""
    ds = cfg["DeepSense"]
    loc = cfg["location_names"][0]
    half = ds["loc_mod_out_channels"] // 2
    geos = []
    for mod in cfg["modality_names"]:
        lens = ds["loc_mod_conv_lens"][mod]
        stride = ds["loc_mod_in_conv_stride"][mod]
        s = cfg["loc_mod_spectrum_len"][loc][mod]
        external = max(stride) > 1
        S = (s - lens[0][1]) // stride[1] + 1 if external else s
        cin0 = cfg["loc_mod_in_freq_channels"][loc][mod]
        L = 1 + ds["loc_mod_conv_inter_layers"]
        cfgs = tuple((lens[0][1] if k == 0 else lens[1][1], cin0 if k == 0 else half, half, k > 0)
                     for k in range(L))
        geos.append({"name": f"{dataset} {mod}", "samples": samples,
                     "intervals": cfg["num_segments"], "R": samples * cfg["num_segments"], "S": S,
                     "C": half, "cfgs": cfgs, "external": external})
    return geos


def tower_work(g):
    """(forward FLOPs, forward bytes, backward FLOPs, backward bytes) of the
    chain at geometry g: the convs 2*R*S*KW*Cin*Cout (twice in the
    backward: the transposed conv and dW) plus FWD_ELEM_OPS / BWD_ELEM_OPS
    an output element; bytes: each input of the function read once and
    each output written once (forward: x0, the parameters and masks in,
    the last activation and the statistics out; backward: dy and the saved
    activations in, dx0 and the parameter gradients out)."""
    R, S, C = g["R"], g["S"], g["C"]
    RS = R * S
    f_fl = b_fl = 0
    params = 0
    saved = 0
    for k, (kw, cin, cout, _) in enumerate(g["cfgs"]):
        conv = 0 if (k == 0 and g["external"]) else 2 * RS * kw * cin * cout
        f_fl += conv + FWD_ELEM_OPS * RS * cout
        b_fl += 2 * conv + BWD_ELEM_OPS * RS * cout
        params += (0 if (k == 0 and g["external"]) else kw * cin * cout) + 3 * cout
        saved += 2 * RS * cout  # c_k and a_k
    cin0 = g["cfgs"][0][2] if g["external"] else g["cfgs"][0][1]
    masks = len(g["cfgs"]) * g["samples"] * C
    f_by = 4 * (RS * cin0 + params + masks + RS * C + 2 * len(g["cfgs"]) * C)
    b_by = 4 * (RS * C + saved + RS * cin0 + params + masks + RS * cin0 + params)
    return f_fl, f_by, b_fl, b_by


def tower_tc_bounds(g):
    """(forward, backward) bound in ms of the tower on the units it runs
    on: its convs as three TF32 products an f32 one at the tensor cores'
    peak, the elementwise operations at the f32 peak, or the bytes."""
    f_fl, f_by, b_fl, b_by = tower_work(g)
    conv = sum(0 if (k == 0 and g["external"]) else 2 * g["R"] * g["S"] * kw * cin * cout
               for k, (kw, cin, cout, _) in enumerate(g["cfgs"]))
    return tuple(1e3 * max(3 * c / TF32_FLOPS + (fl - c) / F32_FLOPS, by / HBM_BYTES_PER_S)
                 for c, fl, by in ((conv, f_fl, f_by), (2 * conv, b_fl, b_by)))


def tower_phase_split(torch, fn, strict=True):
    """trace_reps calls of fn (#13's tower_forward or #14's backward) under
    torch.profiler after a pause, each kernel's device time per call and
    those times by TOWER_LIB's phases; PyTorch's own kernels and memsets
    (the [C]-sized steps between the wrappers' calls) under TORCH_PHASE. With ``strict``
    it raises on any other kernel (cuDNN, cuBLAS: none may run); without,
    other kernels are kept by name (a parent checkout's)."""
    reps = trace_reps(torch, fn)

    def calls():
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)

    prof = profile_device(torch, calls)
    kernels, phases = {}, {}
    for r in prof["rows"]:
        name = kernel_name(r["name"]) or r["name"]
        if owned_by(TOWER_LIB, r["name"]):
            phase = TOWER_LIB["phases"][name]
        elif r["name"].startswith(("void at::native::", "at::native::", "Memset")) and not any(
                w in r["name"].lower() for w in ("gemm", "conv", "cudnn", "cutlass", "cublas")):
            phase = TORCH_PHASE
        elif strict:
            raise AssertionError(f"a device kernel outside csrc/conv_tower.cu ran: {r['name']}")
        else:
            phase = name
        k = kernels.setdefault(name, {"device_ms": 0.0, "count": 0})
        k["device_ms"] += r["device_ms"] / reps
        k["count"] += r["count"]
        phases[phase] = phases.get(phase, 0.0) + r["device_ms"] / reps
    return {"device_ms": sum(phases.values()), "phases": phases, "kernels": kernels}


def tower_inputs(torch, np, g, seed, dev):
    """Inputs at a trained model's scale: unit activations, lecun-scaled
    weights, BN affine near (1, 0), Dropout2d masks of rate 0.2 per sample."""
    rng = np.random.default_rng(seed)
    cin0 = g["cfgs"][0][2] if g["external"] else g["cfgs"][0][1]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x0 = t(rng.normal(size=(g["R"], g["S"], cin0)))
    ws, bs, scales, biases, masks = [], [], [], [], []
    for k, (kw, cin, cout, _) in enumerate(g["cfgs"]):
        ws.append(t(np.zeros((1, 1))) if (k == 0 and g["external"]) else
                  t(rng.normal(size=(kw * cin, cout)) * (kw * cin) ** -0.5))
        bs.append(t(rng.normal(size=cout) * 0.1))
        scales.append(t(1.0 + 0.1 * rng.normal(size=cout)))
        biases.append(t(0.1 * rng.normal(size=cout)))
        masks.append(t((rng.random((g["samples"], cout)) > 0.2) / 0.8))
    dy = t(rng.normal(size=(g["R"], g["S"], g["C"])))
    return x0, [ws, bs, scales, biases], masks, dy


def tower_leaves(torch, x0, params, external):
    """Differentiable copies: x0 and every parameter but an external first
    conv's placeholders."""
    x0 = x0.clone().requires_grad_(True)
    params = [[p.clone().requires_grad_(not (external and k == 0 and gi < 2))
               for k, p in enumerate(group)] for gi, group in enumerate(params)]
    leaves = [x0] + [p for group in params for p in group if p.requires_grad]
    return x0, params, leaves


def grad_errors(got, want):
    """(worst relative error over the gradients compared relatively, worst
    absolute error over the near-zero ones, worst absolute error overall)."""
    rel = near = absolute = 0.0
    for g, w in zip(got, want):
        d = float((g - w).abs().max())
        absolute = max(absolute, d)
        if max(float(g.abs().max()), float(w.abs().max())) < NEAR_ZERO:
            near = max(near, d)
        else:
            rel = max(rel, d / float(w.abs().max()))
    return rel, near, absolute


def library_tower(torch, F, x0, g, params, masks):
    """Yardstick only: the unfused chain through cuDNN (conv2d in NCHW,
    batch_norm in training mode, GELU, the mask, the residual)."""
    ws, bs, scales, biases = params
    R, S = g["R"], g["S"]
    x = x0.permute(0, 2, 1).unsqueeze(2)  # [R, Cin, 1, S]
    a = None
    for k, (kw, cin, cout, residual) in enumerate(g["cfgs"]):
        if k == 0 and g["external"]:
            c = x
        else:
            w4 = ws[k].view(kw, cin, cout).permute(2, 1, 0).unsqueeze(2)  # [Cout, Cin, 1, KW]
            c = F.conv2d(a if k > 0 else x, w4, bs[k], padding=(0, (kw - 1) // 2))
        y = F.batch_norm(c, None, None, scales[k], biases[k], training=True, eps=1e-5)
        m = masks[k].repeat_interleave(R // masks[k].shape[0], dim=0)[:, :, None, None]
        z = F.gelu(y, approximate="none") * m
        a = z + a if residual else z
    return a


def run_deepsense_steps(torch, np, targs, batch, warmup, steps, kernels, per_step, dev, tag):
    """DeepSense pretrain steps (flax-style init, seed 0, synthetic data
    resident on the card, a fixed idx): warm-up, then timed steps with each
    kernel's launches per step checked, and one profiled step. Returns
    (summary, model)."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    host_data, labels, _ = synthetic_arrays(targs.dataset_config, targs.task, 2 * batch, seed=0)
    tdata = to_device(host_data, dev)
    idx = torch.arange(batch, device=dev) % len(labels)
    model = build_backbone(targs.dataset_config, "DeepSense", targs.task, targs.learn_framework,
                           pallas_conv=targs.pallas_conv)
    init_params(model, seed=0).to(dev)
    state = create_train_state(targs, model, steps_per_epoch=100, seed=0)
    step = make_pretrain_step(model, build_augmenter(targs), make_focal_loss(targs))
    t0 = time.time()
    for _ in range(warmup):
        state, metrics = step(state, tdata, idx)
    torch.cuda.synchronize()
    log(f"[{tag}] {targs.dataset} DeepSense pretrain{' -pallas_conv' if targs.pallas_conv else ''}, batch "
        f"{batch} (views fused to {2 * batch}), {sum(p.numel() for p in model.parameters())} "
        f"parameters; {warmup} warm-up steps in {time.time() - t0:.2f}s")
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
    if not bool(torch.isfinite(history).all()):
        raise AssertionError(f"{tag}: non-finite loss or part: {history}")
    check_counts(f"{tag}: {steps} steps", launches,
                 {k.__name__: per_step.get(k.__name__, 0) * steps for k in kernels})
    p50_ms = float(np.percentile(step_s, 50)) * 1e3
    profile = profile_device(torch, lambda: step(state, tdata, idx))
    own_ms = sum(r["device_ms"] for r in profile["rows"] if owned_by(TOWER_LIB, r["name"]))
    summary = {
        "steps": steps, "launches": launches, "p50_ms": p50_ms, "tower_kernels_device_ms": own_ms,
        "mean_ms": float(np.mean(step_s)) * 1e3, "min_ms": float(np.min(step_s)) * 1e3,
        "max_ms": float(np.max(step_s)) * 1e3, "samples_per_s": batch / (p50_ms / 1e3),
        "peak_mb": peak_mb, "loss_first": float(history[0][sorted(metrics).index("loss")]),
        "loss_last": float(history[-1][sorted(metrics).index("loss")]), "profile": profile,
        "idle_share": 1 - profile["device_busy_ms"] / profile["wall_ms"],
        "device_busy_ms": profile["device_busy_ms"],
    }
    log(f"[{tag}] {steps} steps: launches {launches}; loss {summary['loss_first']:.4f} -> "
        f"{summary['loss_last']:.4f}; p50 step {p50_ms:.3f} ms (mean {summary['mean_ms']:.3f}, "
        f"min {summary['min_ms']:.3f}, max {summary['max_ms']:.3f}), "
        f"{summary['samples_per_s']:.1f} samples/s, peak memory {peak_mb:.1f} MiB")
    log_profile(tag, "one profiled step", profile, top=15)
    log(f"[{tag}] device time of the conv-tower kernels (#13, #14) in the profiled step: "
        f"{own_ms:.4f} ms")
    del state, step, tdata, idx
    return summary, model


def deepsense_rate0_step(torch, targs, weights, dev, plain):
    """One pretrain step of DeepSense at dropout 0 with -pallas_conv from
    ``weights`` (a state_dict): through the tower's kernels, or with
    ``plain`` through its plain version. Returns (loss, {name: gradient},
    {name: running statistic}) on the CPU."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone
    from focal_tpu_torch.models import layers as layers_mod
    from focal_tpu_torch.ops import conv_tower as ct
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    cfg0 = copy.deepcopy(targs.dataset_config)
    cfg0["DeepSense"]["dropout_ratio"] = 0.0
    args0 = copy.copy(targs)
    args0.dataset_config = cfg0
    host_data, labels, _ = synthetic_arrays(cfg0, targs.task, 2 * targs.batch_size, seed=0)
    data = to_device(host_data, dev)
    idx = torch.arange(targs.batch_size, device=dev) % len(labels)
    m = build_backbone(cfg0, "DeepSense", targs.task, targs.learn_framework, pallas_conv=True)
    m.load_state_dict(weights)
    m.to(dev)
    st = create_train_state(args0, m, steps_per_epoch=100, seed=0)
    if plain:
        layers_mod.fused_conv_tower = ct.fused_conv_tower_reference
    try:
        _, mt = make_pretrain_step(m, build_augmenter(args0), make_focal_loss(args0))(st, data, idx)
    finally:
        layers_mod.fused_conv_tower = ct.fused_conv_tower
    return (float(mt["loss"]), {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None},
            {n: b.detach().cpu() for n, b in m.named_buffers()})


# ---------------------------------------------------------------------------
# the fused MLP (#10, #11, #12) and the classifier stages

SUP_BATCH = 128           # supervised and finetune samples per step (no views to fuse)
SUP_SAMPLES = 512         # MOD synthetic train split of the classifier entry-point runs
# operations a hidden element besides the two products: forward the bias,
# the exact GELU (~20) and the mask; backward the GELU again and its
# derivative (~35), the masks, dz and the bias sums
MLP_ELEM_FWD = 24
MLP_ELEM_BWD = 40
TINY_GRAD = 1e-6          # a gradient tensor below this on both sides is compared absolutely


def mlp_geometries(cfg, batch, dataset):
    """Every (modality, stage) whose Swin MLPs take the fused route
    (``mlp_fits``) in one forward at ``batch`` samples: T rows, width C,
    hidden H and the blocks (launches) a forward makes there."""
    from focal_tpu_torch.models.sw_transformer import mod_geometry
    from focal_tpu_torch.ops.fused_mlp import mlp_fits

    sw = cfg["SW_Transformer"]
    loc = cfg["location_names"][0]
    geos = []
    for mod in cfg["modality_names"]:
        geo = mod_geometry(cfg, loc, mod)
        for stage, ((H, W), C) in enumerate(geo["stages"]):
            hidden = int(C * float(sw.get("mlp_ratio", 4.0)))
            if mlp_fits(C, hidden):
                geos.append({"name": f"{dataset} {mod}/stage{stage}", "T": batch * H * W, "C": C,
                             "H": hidden, "per_forward": geo["block_num"][stage]})
    return geos


def mlp_work(g, backward):
    """(FLOPs, bytes) of one launch: forward 4TCH for the two products plus
    MLP_ELEM_FWD a hidden element, x, the weights and y once; backward the
    10TCH it needs (z again, dh, dx, dW1, dW2) plus MLP_ELEM_BWD a hidden
    element, x, g and the weights read once, dx and the gradients written
    once."""
    T, C, H = g["T"], g["C"], g["H"]
    if backward:
        return 10 * T * C * H + MLP_ELEM_BWD * T * H, 4 * (3 * T * C + 4 * C * H + 2 * H + C)
    return 4 * T * C * H + MLP_ELEM_FWD * T * H, 4 * (2 * T * C + 2 * C * H + H + C)


def mlp_inputs(torch, np, g, seed, dev):
    """x, w1 [C, H], b1, w2 [H, C], b2 and a gradient g at a trained model's
    scale (unit activations, lecun-scaled weights, small biases)."""
    rng = np.random.default_rng(seed)
    T, C, H = g["T"], g["C"], g["H"]
    shapes = [(T, C), (C, H), (H,), (H, C), (C,), (T, C)]
    scales = [1.0, C**-0.5, 0.1, H**-0.5, 0.1, 1.0]
    return [torch.from_numpy((rng.normal(size=s) * k).astype(np.float32)).to(dev)
            for s, k in zip(shapes, scales)]


def library_mlp(torch, F, x, w1, b1, w2, b2, rate=0.0):
    """Yardstick only: the cuBLAS chain addmm -> GELU -> addmm, with
    F.dropout after each at ``rate``."""
    h = F.gelu(torch.addmm(b1, x, w1), approximate="none")
    if rate:
        h = F.dropout(h, rate)
    y = torch.addmm(b2, h, w2)
    return F.dropout(y, rate) if rate else y


def plain_mlp(x, w1, b1, w2, b2, w1_t=None, w2_t=None):
    """fused_mlp's plain version with its signature (for the rate-0 step)."""
    from focal_tpu_torch.ops.fused_mlp import fused_mlp_reference

    return fused_mlp_reference(x, w1, b1, w2, b2)


def run_supervised_steps(torch, np, sargs, batch, warmup, steps, kernels, per_step, dev, tag):
    """Supervised steps of the MOD SW_Transformer at full width (flax-style
    init, seed 0, synthetic data and labels resident on the card, a fixed
    idx, the recipe's fixed pool: mixup and phase_shift): warm-up, timed
    steps with each kernel's launches per step checked, one profiled step.
    Returns the summary."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_supervised_train_step

    host_data, labels, _ = synthetic_arrays(sargs.dataset_config, sargs.task, 2 * batch, seed=0)
    tdata = to_device(host_data, dev)
    tlabels = torch.from_numpy(labels).long().to(dev)
    idx = torch.arange(batch, device=dev) % len(labels)
    model = build_backbone(sargs.dataset_config, "SW_Transformer", sargs.task, "no",
                           pallas_mlp=sargs.pallas_mlp)
    init_params(model, seed=0).to(dev)
    state = create_train_state(sargs, model, steps_per_epoch=100, seed=0)
    step = make_supervised_train_step(model, build_augmenter(sargs), fixed_aug=True)
    t0 = time.time()
    for _ in range(warmup):
        state, metrics = step(state, tdata, tlabels, idx)
    torch.cuda.synchronize()
    log(f"[{tag}] MOD SW_Transformer supervised{' -pallas_mlp' if sargs.pallas_mlp else ''}, "
        f"batch {batch}; {warmup} warm-up steps in {time.time() - t0:.2f}s")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    step_s, history = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.time()
        state, metrics = step(state, tdata, tlabels, idx)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        history.append(torch.stack([metrics["loss"], metrics["acc"]]))
    launches = counts(kernels)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    history = torch.stack(history).cpu()
    if not bool(torch.isfinite(history).all()):
        raise AssertionError(f"{tag}: non-finite loss: {history}")
    check_counts(f"{tag}: {steps} steps", launches,
                 {k.__name__: per_step.get(k.__name__, 0) * steps for k in kernels})
    p50_ms = float(np.percentile(step_s, 50)) * 1e3
    profile = profile_device(torch, lambda: step(state, tdata, tlabels, idx))
    mlp_split = block_device_ms(profile, MLP_LIB)
    mlp_ms = sum(mlp_split.values())
    summary = {
        "steps": steps, "launches": launches, "p50_ms": p50_ms,
        "mean_ms": float(np.mean(step_s)) * 1e3, "min_ms": float(np.min(step_s)) * 1e3,
        "max_ms": float(np.max(step_s)) * 1e3, "samples_per_s": batch / (p50_ms / 1e3),
        "peak_mb": peak_mb, "loss_first": float(history[0][0]), "loss_last": float(history[-1][0]),
        "profile": profile, "idle_share": 1 - profile["device_busy_ms"] / profile["wall_ms"],
        "mlp_kernels_device_ms": mlp_ms, "mlp_device_ms_by_phase": mlp_split,
    }
    log(f"[{tag}] {steps} steps: launches {launches}; loss {summary['loss_first']:.4f} -> "
        f"{summary['loss_last']:.4f}; p50 step {p50_ms:.3f} ms (mean {summary['mean_ms']:.3f}, "
        f"min {summary['min_ms']:.3f}, max {summary['max_ms']:.3f}), "
        f"{summary['samples_per_s']:.1f} samples/s, peak memory {peak_mb:.1f} MiB")
    log_profile(tag, "one profiled step", profile, top=15)
    log(f"[{tag}] device time of the fused MLP kernels (#10-#12) in the profiled step: "
        f"{mlp_ms:.4f} ms ({mlp_split})")
    del state, step, tdata, idx, model
    return summary


def supervised_rate0_step(torch, sargs, weights, dev, plain):
    """One supervised step of the MOD SW_Transformer at every drop rate 0
    with -pallas_mlp from ``weights``: through the kernels (#1/#3, #10/#12),
    or with ``plain`` through their plain versions. The fixed pool is
    replaced by ["no"] so both take the same inputs. Returns (loss,
    {name: gradient}) on the CPU and the launches."""
    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_supervised_train_step

    cfg0 = copy.deepcopy(sargs.dataset_config)
    sw0 = cfg0["SW_Transformer"]
    sw0["dropout_ratio"] = sw0["drop_path_rate"] = sw0["attn_drop_rate"] = 0.0
    sw0["fixed_augmenters"] = {"time_augmenters": ["no"], "freq_augmenters": ["no"]}
    args0 = copy.copy(sargs)
    args0.dataset_config = cfg0
    host_data, labels, _ = synthetic_arrays(cfg0, sargs.task, 2 * sargs.batch_size, seed=0)
    data = to_device(host_data, dev)
    tlabels = torch.from_numpy(labels).long().to(dev)
    idx = torch.arange(sargs.batch_size, device=dev) % len(labels)
    m = build_backbone(cfg0, "SW_Transformer", sargs.task, "no", pallas_mlp=True)
    m.load_state_dict(weights)
    m.to(dev)
    st = create_train_state(args0, m, steps_per_epoch=100, seed=0)
    if plain:
        swin_mod.window_block, swin_mod.window_block_forward = (pk.window_block_reference,
                                                                pk.fused_window_block_reference)
        swin_mod.fused_mlp = plain_mlp
    kernels = (pk.fused_window_block, pk.fused_window_block_backward, fm.fused_mlp_forward,
               fm.fused_mlp_backward, pk.fused_window_block_dropout, fm.fused_mlp_dropout_forward)
    zero_counts(kernels)
    try:
        _, mt = make_supervised_train_step(m, build_augmenter(args0), fixed_aug=True)(
            st, data, tlabels, idx)
        torch.cuda.synchronize()
    finally:
        swin_mod.window_block, swin_mod.window_block_forward = pk.window_block, pk.window_block_forward
        swin_mod.fused_mlp = fm.fused_mlp
    return (float(mt["loss"]), {n: p.grad.cpu() for n, p in m.named_parameters()
                                if p.grad is not None}, counts(kernels))


# ---------------------------------------------------------------------------
# the attention-only kernels (#6-#9) of -no_pallas_block

# operations a score besides the products: forward the bias and mask adds,
# the max, exp, sum and scale (6); backward the softmax again (6), the
# row dot a . da and ds (4)
ATTN_ELEM_FWD = 6
ATTN_ELEM_BWD = 10
ATTN_SRC = "focal_tpu_torch/csrc/window_attention.cu"


def attention_geometries(cfg, batch, dataset):
    """block_geometries with the head width hd: the attention's q, k, v
    are [windows, heads, N, hd]."""
    geos = block_geometries(cfg, batch)
    for g in geos:
        g["name"] = f"{dataset} {g['name']}"
        g["hd"] = g["C"] // g["heads"]
    return geos


def attention_work(g, backward):
    """(FLOPs, bytes) of one launch. FLOPs: the products, 4 N^2 hd a
    (window, head) pair forward (q k^T, a v) and 10 N^2 hd backward (q k^T
    again, g v^T, dq, dk, dv), plus ATTN_ELEM_* a score (the Philox words of
    #7/#9 are integer work, not counted). Bytes: q, k, v (and g) read once,
    out (dq, dk, dv) written once, rel_bias (and drel_bias) and the shift
    mask once; no keep mask is stored."""
    pairs, N, hd, H = g["windows"] * g["heads"], g["N"], g["hd"], g["heads"]
    mask = g["nW"] * N * N if g["mask"] is not None else 0
    if backward:
        flops = pairs * (10 * N * N * hd + ATTN_ELEM_BWD * N * N)
        elems = 7 * pairs * N * hd + 2 * H * N * N + mask
    else:
        flops = pairs * (4 * N * N * hd + ATTN_ELEM_FWD * N * N)
        elems = 4 * pairs * N * hd + H * N * N + mask
    return flops, 4 * elems


def attention_inputs(torch, np, g, seed, dev):
    """q (pre-scaled by hd**-0.5), k, v, the output gradient gy, rel_bias
    at a trained model's scale and the geometry's shift mask (or None)."""
    rng = np.random.default_rng(seed)
    shape = (g["windows"], g["heads"], g["N"], g["hd"])
    q, k, v, gy = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    q *= np.float32(g["hd"] ** -0.5)
    rel_bias = (0.02 * rng.normal(size=(g["heads"], g["N"], g["N"]))).astype(np.float32)
    out = [torch.from_numpy(a).to(dev) for a in (q, k, v, rel_bias)]
    mask = None if g["mask"] is None else torch.from_numpy(g["mask"]).to(dev)
    return out + [mask, torch.from_numpy(gy).to(dev)]


def library_attention(torch, q, k, v, attn_mask, rate=0.0):
    """Yardstick only: PyTorch's scaled_dot_product_attention with the bias
    and shift mask materialised as attn_mask (q is pre-scaled: scale 1)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=rate, scale=1.0)


def grads_differ(got, want):
    """Worst max|got - want| / max|want| over the gradients, each compared
    absolutely (to TINY_GRAD) where both sides are below TINY_GRAD."""
    worst = 0.0
    for a, b in zip(got, want):
        if max(float(a.abs().max()), float(b.abs().max())) < TINY_GRAD:
            if float((a - b).abs().max()) > TINY_GRAD:
                return math.inf
            continue
        worst = max(worst, rel_err(a, b))
    return worst


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
    from focal_tpu_torch.ops import conv_tower as ct
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml, parse_train_params
    from focal_tpu_torch.serve import Predictor

    fwd, fwd_drop, bwd = pk.fused_window_block, pk.fused_window_block_dropout, pk.fused_window_block_backward
    ph_fwd, ph_bwd = pk.fused_window_block_perhead, pk.fused_window_block_perhead_backward
    ct_fwd, ct_bwd = ct.fused_conv_tower, ct.fused_conv_tower_backward
    mlp_fwd, mlp_drop, mlp_bwd = fm.fused_mlp_forward, fm.fused_mlp_dropout_forward, fm.fused_mlp_backward
    at_fwd, at_drop = pk.fused_window_attention, pk.fused_window_attention_dropout
    at_bwd, at_drop_bwd = pk.fused_window_attention_backward, pk.fused_window_attention_dropout_backward
    all_kernels = (fwd, fwd_drop, bwd, ph_fwd, ph_bwd, ct_fwd, ct_bwd, mlp_fwd, mlp_drop, mlp_bwd,
                   at_fwd, at_drop, at_bwd, at_drop_bwd)
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
                if "Compiling entry function" in line:
                    log(f"[build] {src}: {kernel_of(line)}")
                elif "registers" in line or "smem" in line or "spill" in line:
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
            again = bwd(*args, dy, kp, rate, *tr)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{g['name']}: #3 gives other bits on a second call ({tag})")
            want = pk.fused_window_block_backward_reference(*args, dy, kp, rate)
            errs[tag] = max(rel_err(a, b) for a, b in zip(got, want))
            grad_abs = max(grad_abs, *(float((a - b).abs().max()) for a, b in zip(got, want)))
        g.update(max_abs_err_fwd=err, keep_rate=kept, keep_sigma=sigma, max_rel_err_bwd=errs["keep"],
                 max_rel_err_bwd_nomask=errs["nomask"])
        drop_err, grad_err = max(drop_err, err), max(grad_err, *errs.values())
        log(f"[check-train] {g['name']}: windows {g['windows']} C {g['C']} nW {g['nW']}: "
            f"#2 max|kernel-plain| {err:.3e}, keep rate {kept:.5f} ({(kept - 1 + rate) / sigma:+.2f} "
            f"sigma); #3 max rel err {errs['keep']:.3e} (mask), {errs['nomask']:.3e} (no mask), "
            "repeatable")
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

    # ---- 8. #2 and #3 timing per training geometry, and profiled by phase
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for g in tgeos:
        time_training(torch, pk, fwd_drop, bwd, ("#2", "#3"), g, gen, dev, rate, sms, "time-train")
    ttot = step_totals(tgeos, "time-train", ("#2", "#3"), per_fwd)
    log(f"[time-train] share of the p50 step {(ttot['fwd_ms'] + ttot['bwd_ms']) / p50_ms:.3f}")
    train_split = profile_split(torch, fwd_drop, bwd, ("#2", "#3"), tgeos, gen, dev, rate,
                                "profile-train-kernels")
    torch.cuda.empty_cache()

    # ---- 9. where one training step's time goes on the device
    train_profile = profile_device(torch, lambda: step(state, tdata, idx))
    log_profile("profile-train", "one training step", train_profile, top=15)
    train["idle_share"] = 1 - train_profile["device_busy_ms"] / train_profile["wall_ms"]
    train["block_device_ms"] = block_device_ms(train_profile)
    beside_parent("train", "MOD", train)
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
        if not same_mask:
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
        "train-wide", rate0_from="initial+trained")
    wide_profile = profile_device(torch, lambda: step(state, tdata, idx))
    log_profile("profile-wide", "one MOD_WIDE training step", wide_profile, top=15)
    wide["idle_share"] = 1 - wide_profile["device_busy_ms"] / wide_profile["wall_ms"]
    wide["block_device_ms"] = block_device_ms(wide_profile)
    beside_parent("train-wide", "MOD_WIDE", wide)
    del state, step, tdata, idx
    torch.cuda.empty_cache()

    # ---- 13. #4 and #5 timing per geometry (#4 at rate 0 too, #1 beside it
    # at C = 512), #2 and #3 at MOD_WIDE stage 0, each profiled by phase
    for g in pgeos:
        time_training(torch, pk, ph_fwd, ph_bwd, ("#4", "#5"), g, gen, dev, wrate, sms, "time-wide")
        args = make_inputs(torch, g, gen, dev)
        x, wqkv, bqkv, wproj, bproj, rel_bias, mask = args
        attn_mask = library_mask(torch, g, rel_bias, mask)
        g["eval_ms"] = time_ms(torch, lambda: ph_fwd(*args))
        g["eval_plain_ms"] = time_ms(torch, lambda: pk.fused_window_block_reference(*args))
        g["eval_library_ms"] = time_ms(torch, lambda: library_block(
            torch, x, wqkv, bqkv, wproj, bproj, attn_mask, g["heads"]))
        f0, b0, g["eval_bound_ms"], _ = work(g)
        g["eval_bound_tc_ms"] = tc_bound(f0, b0)
        note = ""
        if g["C"] == 512:  # #1, per window, takes this width too (ROADMAP A14)
            g["mono_eval_ms"] = time_ms(torch, lambda: fwd(*args))
            note = f"; beside it #1 {g['mono_eval_ms']:.4f} ms"
        log(f"[time-wide] {g['name']}: #4 at rate 0 (eval) {g['eval_ms']:.4f} ms (plain "
            f"{g['eval_plain_ms']:.4f}, library {g['eval_library_ms']:.4f}, bound f32 "
            f"{g['eval_bound_ms']:.4f}, TF32x3 {g['eval_bound_tc_ms']:.4f}, "
            f"{f0 / g['eval_ms'] / 1e9:.2f} TFLOP/s){note}")
        del args, x, wqkv, attn_mask
    n_ph = wide_per_step[ph_fwd.__name__]
    wtot = step_totals(pgeos, "time-wide", ("#4", "#5"), n_ph)
    wtot.update({k: sum(g["per_forward"] * g[k] for g in pgeos) for k in (
        "eval_ms", "eval_plain_ms", "eval_library_ms", "eval_bound_ms", "eval_bound_tc_ms")})
    log(f"[time-wide] #4/#5 share of the p50 step {(wtot['fwd_ms'] + wtot['bwd_ms']) / wide['p50_ms']:.3f}; "
        f"one eval forward's #4 {wtot['eval_ms']:.3f} ms (plain {wtot['eval_plain_ms']:.3f}, library "
        f"{wtot['eval_library_ms']:.3f}, bound f32 {wtot['eval_bound_ms']:.3f}, TF32x3 "
        f"{wtot['eval_bound_tc_ms']:.3f})")
    for g in mono:
        time_training(torch, pk, fwd_drop, bwd, ("#2", "#3"), g, gen, dev, wrate, sms, "time-wide")
    stot = step_totals(mono, "time-wide", ("#2", "#3"), wide_per_step[fwd_drop.__name__])
    # profiled at each geometry (kernel_phase_split): only window_block.cu's
    # kernels may run; their time by phase, summed per step
    wide_split = profile_split(torch, fwd_drop, bwd, ("#2", "#3"), mono, gen, dev, wrate,
                               "profile-wide-kernels")
    ph_split = profile_split(torch, ph_fwd, ph_bwd, ("#4", "#5"), pgeos, gen, dev, wrate,
                             "profile-perhead")
    torch.cuda.empty_cache()

    # ---- 14. #13 and #14 vs plain at every tower geometry of the DeepSense
    # pretrain step: MOD (batch 256, views fused to 512, C 64) and MOD_WIDE
    # (batch 128 fused to 256, C 256), seismic (first conv inside) and audio
    # (first conv outside)
    import torch.nn.functional as F

    cgeos = (tower_geometries(cfg, 2 * DS_BATCH, "MOD")
             + tower_geometries(wcfg, 2 * DS_WIDE_BATCH, "MOD_WIDE"))
    ct_fwd_err = ct_grad_rel = ct_grad_near = ct_grad_abs = 0.0
    for gi, g in enumerate(cgeos):
        x0, params, masks, dy = tower_inputs(torch, np, g, 100 + gi, dev)
        runs = []
        for fn in (ct_fwd, ct_fwd, ct.fused_conv_tower_reference):
            xl, pl_, leaves = tower_leaves(torch, x0, params, g["external"])
            y, mus, vars_ = fn(xl, g["cfgs"], *pl_, masks, g["external"])
            runs.append((y.detach(), mus, vars_, torch.autograd.grad(y, leaves, dy)))
            del y
        torch.cuda.synchronize()
        (y, mus, vars_, grads), again, (ry, rmus, rvars, rgrads) = runs
        fwd_rel = max([rel_err(y, ry)] + [rel_err(a, b) for a, b in zip(mus + vars_, rmus + rvars)])
        fwd_abs = max([float((y - ry).abs().max())]
                      + [float((a - b).abs().max()) for a, b in zip(mus + vars_, rmus + rvars)])
        g_rel, g_near, g_abs = grad_errors(grads, rgrads)
        same = (torch.equal(y, again[0]) and all(torch.equal(a, b) for a, b in zip(mus, again[1]))
                and all(torch.equal(a, b) for a, b in zip(grads, again[3])))
        g.update(max_rel_err_fwd=fwd_rel, max_abs_err_fwd=fwd_abs, max_rel_err_bwd=g_rel,
                 max_abs_err_bwd_near_zero=g_near, max_abs_err_bwd=g_abs, repeatable=same)
        ct_fwd_err = max(ct_fwd_err, fwd_abs)
        ct_grad_rel, ct_grad_near, ct_grad_abs = (max(ct_grad_rel, g_rel), max(ct_grad_near, g_near),
                                                  max(ct_grad_abs, g_abs))
        log(f"[check-tower] {g['name']}: R {g['R']} S {g['S']} C {g['C']} layers {len(g['cfgs'])}"
            f"{' (first conv outside)' if g['external'] else ''}: #13 max rel err {fwd_rel:.3e} "
            f"(output, means, variances); #14 max rel err {g_rel:.3e}, near-zero max abs err "
            f"{g_near:.3e}; same bits on a second call: {same}")
        if not fwd_rel <= TOWER_TOL:
            raise AssertionError(f"{g['name']}: #13 differs from plain by {fwd_rel}")
        if not (g_rel <= GRAD_TOL and g_near <= NEAR_ZERO):
            raise AssertionError(f"{g['name']}: #14 gradients differ from plain: {g_rel}, {g_near}")
        if not same:
            raise AssertionError(f"{g['name']}: #13/#14 give other bits on a second call")
        del runs, grads, again, rgrads, x0, params, masks, dy
    torch.cuda.empty_cache()

    # ---- 15. DeepSense pretrain steps: the default path (cuDNN convs, no
    # kernel) and -pallas_conv (#13/#14), in one call: MOD at batch 256 (3 +
    # 20 steps), then MOD_WIDE at batch 128 (3 + 10), where the towers weigh
    def tower_launches(geos):
        """#13's and #14's wrapper calls in one step over the towers geos."""
        return {ct_fwd.__name__: sum(len(g["cfgs"]) + (0 if g["external"] else 1) for g in geos),
                ct_bwd.__name__: sum(2 * len(g["cfgs"]) for g in geos)}

    mod_geos = [g for g in cgeos if g["name"].startswith("MOD ")]
    ds_per_step = tower_launches(mod_geos)
    ds_wide_per_step = tower_launches([g for g in cgeos if g["name"].startswith("MOD_WIDE ")])
    ds_runs = {}
    for dataset, batch, steps in (("MOD_WIDE", DS_WIDE_BATCH, WIDE_STEPS),
                                  ("MOD", DS_BATCH, TRAIN_STEPS)):
        for pallas in (False, True):
            dargs = parse_train_params(["-dataset", dataset, "-model", "DeepSense",
                                        "-learn_framework", "FOCAL", "-stage", "pretrain",
                                        "-batch_size", str(batch)]
                                       + (["-pallas_conv"] if pallas else []))
            tag = ("deepsense-pallas" if pallas else "deepsense-default") + (
                "-wide" if dataset == "MOD_WIDE" else "")
            per_step = ds_per_step if dataset == "MOD" else ds_wide_per_step
            ds_runs[tag], trained = run_deepsense_steps(
                torch, np, dargs, batch, TRAIN_WARMUP, steps, all_kernels,
                per_step if pallas else {}, dev, tag)
            if pallas and dataset == "MOD":
                trained_sd = {k: v.detach().cpu().clone() for k, v in trained.state_dict().items()}
            del trained
            torch.cuda.empty_cache()
    w_def, w_pal = ds_runs["deepsense-default-wide"], ds_runs["deepsense-pallas-wide"]
    log(f"[deepsense-wide] MOD_WIDE step, -pallas_conv vs default: p50 {w_pal['p50_ms']:.3f} vs "
        f"{w_def['p50_ms']:.3f} ms, {w_pal['samples_per_s']:.1f} vs {w_def['samples_per_s']:.1f} "
        f"samples/s, idle share {w_pal['idle_share']:.3f} vs {w_def['idle_share']:.3f}, device "
        f"busy {w_pal['device_busy_ms']:.3f} vs {w_def['device_busy_ms']:.3f} ms (#13/#14 "
        f"{w_pal['tower_kernels_device_ms']:.3f}), peak {w_pal['peak_mb']:.1f} vs "
        f"{w_def['peak_mb']:.1f} MiB")
    # the rate-0 step, kernels vs plain: from the initial state (held) and
    # from the -pallas_conv run's trained state (reported)
    from focal_tpu_torch.models import build_backbone, init_params

    initial_sd = init_params(build_backbone(cfg, "DeepSense", task, "FOCAL"), seed=0).state_dict()
    rate0 = {}
    for where, weights in (("initial", initial_sd), ("trained", trained_sd)):
        kern = deepsense_rate0_step(torch, dargs, weights, dev, plain=False)
        plain = deepsense_rate0_step(torch, dargs, weights, dev, plain=True)
        loss_rel = abs(kern[0] - plain[0]) / abs(plain[0])
        g_rel, g_near, _ = grad_errors([kern[1][n] for n in plain[1]], list(plain[1].values()))
        stats_rel = max(rel_err(kern[2][n], plain[2][n]) for n in plain[2])
        rate0[where] = {"loss_kernel": kern[0], "loss_plain": plain[0], "loss_rel": loss_rel,
                        "max_grad_rel": g_rel, "max_grad_abs_near_zero": g_near,
                        "max_stats_rel": stats_rel}
        log(f"[deepsense-rate0] from the {where} state, kernels vs plain: loss {kern[0]:.6f} vs "
            f"{plain[0]:.6f} (rel {loss_rel:.2e}), max grad rel err {g_rel:.2e} (near-zero max "
            f"abs {g_near:.2e}), running statistics max rel err {stats_rel:.2e}"
            f"{'' if where == 'initial' else ' (reported, not held)'}")
        if where == "initial" and not (loss_rel <= LOSS_TOL and g_rel <= GRAD_TOL
                                       and g_near <= NEAR_ZERO and stats_rel <= TOWER_TOL):
            raise AssertionError(f"DeepSense rate-0 step, kernels vs plain: {rate0[where]}")
        del kern, plain
    del trained_sd, initial_sd
    torch.cuda.empty_cache()

    # ---- 16. the entry point: python -m focal_tpu_torch.train -dataset MOD
    # -model DeepSense -pallas_conv -synthetic, 2 epochs, then -resume to 3;
    # then Predictor serves the _best file
    run_dir = os.path.join(HERE, "build", "chip_smoke_deepsense")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["-dataset", "MOD", "-model", "DeepSense", "-learn_framework", "FOCAL", "-stage",
            "pretrain", "-pallas_conv", "-synthetic", "-synthetic_samples", str(DS_SAMPLES),
            "-batch_size", str(DS_BATCH), "-val_epochs", "1", "-output_dir", run_dir]
    ds_cli = []
    folder = os.path.join(run_dir, "weights", "MOD_DeepSense")
    for extra, points_want in ((["-epochs", "2"], [0, 1]), (["-epochs", "3", "-resume"], [2])):
        zero_counts(all_kernels)
        t0 = time.time()
        st, best, points = train_cli.main(argv + extra)
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = counts(all_kernels)
        n_steps = st.step - (ds_cli[-1]["step"] if ds_cli else 0)
        # eval forwards launch nothing: the counts are the steps' alone
        want = {k.__name__: ds_per_step.get(k.__name__, 0) * n_steps for k in all_kernels}
        if [p["epoch"] for p in points] != points_want:
            raise AssertionError(f"validation points {[p['epoch'] for p in points]} != {points_want}")
        for p in points:
            if not all(math.isfinite(p[k]) for k in ("train_loss", "val_loss", "test_loss")):
                raise AssertionError(f"non-finite loss at a validation point: {p}")
        check_counts(f"DeepSense train CLI {' '.join(extra)}", got, want)
        (exp,) = [d for d in os.listdir(folder) if d.startswith("exp")]
        files = {kind: os.path.join(folder, exp, f"MOD_DeepSense_pretrain_{kind}.pt")
                 for kind in ("latest", "best", "resume")}
        for kind, path in files.items():
            saved = torch.load(path, map_location="cpu", weights_only=True)
            keys = saved["model"] if kind == "resume" else saved
            n_stats = sum(k.endswith(".mean") or k.endswith(".var") for k in keys)
            if n_stats != 2 * sum(len(g["cfgs"]) for g in mod_geos):  # each BatchNorm's two
                raise AssertionError(f"{path}: {n_stats} running statistics")
        ds_cli.append({"argv": extra, "seconds": secs, "step": st.step, "steps": n_steps,
                       "launches": got, "points": points, "best": best})
        log(f"[deepsense-cli] MOD {' '.join(extra)}: {n_steps} steps in {secs:.1f}s; launches "
            f"{got}; points " + "; ".join(
                f"epoch {p['epoch']} train {p['train_loss']:.4f} val {p['val_loss']:.4f} "
                f"test {p['test_loss']:.4f} val acc {p['val_acc']:.3f}" for p in points))
        del st
    predictor = Predictor(cfg, "DeepSense", task, files["best"], batch_size=SERVE_BATCH,
                          device="cuda", learn_framework="FOCAL")
    zero_counts(all_kernels)
    ds_result = predictor.predict(data)
    ds_serve_launches = counts(all_kernels)
    check_counts("DeepSense serving", ds_serve_launches, {k.__name__: 0 for k in all_kernels})
    dprobs = ds_result["probs"]
    if dprobs.shape != (n, cfg[task]["num_classes"]) or not np.isfinite(dprobs).all():
        raise AssertionError(f"DeepSense: bad probabilities: shape {dprobs.shape}")
    if float(np.abs(dprobs.sum(-1) - 1.0).max()) > 1e-5:
        raise AssertionError("DeepSense: probabilities do not sum to 1")
    ds_lat = ds_result["latency"]
    log(f"[deepsense-serve] {n} samples in {ds_lat['batches']} batches of {SERVE_BATCH} from the "
        f"_best file: p50 batch {ds_lat['p50_s'] * 1e3:.3f} ms, p99 {ds_lat['p99_s'] * 1e3:.3f} ms, "
        f"{ds_lat['windows_per_s']:.1f} samples/s; launches {ds_serve_launches}")
    del predictor
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 17. #13 and #14 timing per tower geometry: the kernels, the plain
    # versions, the library yardstick (the unfused cuDNN chain and its
    # autograd backward) and the bound
    ctot = {}
    for gi, g in enumerate(cgeos):
        x0, params, masks, dy = tower_inputs(torch, np, g, 200 + gi, dev)
        _, _, _, saved = ct.tower_forward(x0, g["cfgs"], *params, masks, g["external"])
        g["fwd_ms"] = time_ms(torch, lambda: ct.tower_forward(x0, g["cfgs"], *params, masks,
                                                              g["external"]))
        g["bwd_ms"] = time_ms(torch, lambda: ct_bwd(saved, dy))
        with torch.no_grad():
            g["fwd_plain_ms"] = time_ms(torch, lambda: ct.fused_conv_tower_reference(
                x0, g["cfgs"], *params, masks, g["external"]))
            g["fwd_library_ms"] = time_ms(torch, lambda: library_tower(torch, F, x0, g, params, masks))
        xl, pl_, leaves = tower_leaves(torch, x0, params, g["external"])
        ry = ct.fused_conv_tower_reference(xl, g["cfgs"], *pl_, masks, g["external"])[0]
        g["bwd_plain_ms"] = time_ms(torch, lambda: torch.autograd.grad(ry, leaves, dy,
                                                                       retain_graph=True))
        del ry
        xl, pl_, leaves = tower_leaves(torch, x0, params, g["external"])
        ly = library_tower(torch, F, xl, g, pl_, masks)
        dyl = dy.permute(0, 2, 1).unsqueeze(2)
        g["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(ly, leaves, dyl,
                                                                         retain_graph=True))
        del ly
        # device time by kernel: only conv_tower.cu's kernels and PyTorch's
        # [C]-sized steps may run under #13 and #14
        g["profile"] = {"fwd": tower_phase_split(torch, lambda: ct.tower_forward(
                            x0, g["cfgs"], *params, masks, g["external"])),
                        "bwd": tower_phase_split(torch, lambda: ct_bwd(saved, dy))}
        del saved
        f_fl, f_by, b_fl, b_by = tower_work(g)
        g["fwd_gflop"], g["bwd_gflop"] = f_fl / 1e9, b_fl / 1e9
        g["fwd_bound_ms"], g["fwd_bound_by"] = bound(f_fl, f_by)
        g["bwd_bound_ms"], g["bwd_bound_by"] = bound(b_fl, b_by)
        g["fwd_bound_tc_ms"], g["bwd_bound_tc_ms"] = tower_tc_bounds(g)
        g["fwd_flops_bytes"], g["bwd_flops_bytes"] = (f_fl, f_by), (b_fl, b_by)
        log(f"[time-tower] {g['name']}: #13 {g['fwd_ms']:.4f} ms (plain {g['fwd_plain_ms']:.4f}, "
            f"library {g['fwd_library_ms']:.4f}, bound f32 {g['fwd_bound_ms']:.4f}, TF32x3 "
            f"{g['fwd_bound_tc_ms']:.4f}, {f_fl / g['fwd_ms'] / 1e9:.2f} TFLOP/s); #14 "
            f"{g['bwd_ms']:.4f} ms (plain {g['bwd_plain_ms']:.4f}, library "
            f"{g['bwd_library_ms']:.4f}, bound f32 {g['bwd_bound_ms']:.4f}, TF32x3 "
            f"{g['bwd_bound_tc_ms']:.4f}, {b_fl / g['bwd_ms'] / 1e9:.2f} TFLOP/s)")
        for d, what in (("fwd", "#13"), ("bwd", "#14")):
            pr = g["profile"][d]
            log(f"[profile-tower] {g['name']} {what}: device {pr['device_ms']:.4f} ms a call: "
                + ", ".join(f"{ph} {ms:.4f}" for ph, ms in sorted(pr["phases"].items(),
                                                                   key=lambda kv: -kv[1])))
        ds = g["name"].split()[0]
        step_sum = ctot.setdefault(ds, {"fwd_flops": 0, "fwd_bytes": 0, "bwd_flops": 0,
                                        "bwd_bytes": 0, "fwd_bound_tc_ms": 0.0,
                                        "bwd_bound_tc_ms": 0.0,
                                        "device_ms_by_phase": {"fwd": {}, "bwd": {}}})
        for k in ("fwd_ms", "fwd_plain_ms", "fwd_library_ms", "bwd_ms", "bwd_plain_ms",
                  "bwd_library_ms", "fwd_bound_tc_ms", "bwd_bound_tc_ms"):
            step_sum[k] = step_sum.get(k, 0.0) + g[k]
        for d in ("fwd", "bwd"):
            split = step_sum["device_ms_by_phase"][d]
            for ph, ms in g["profile"][d]["phases"].items():
                split[ph] = split.get(ph, 0.0) + ms
        step_sum["fwd_flops"] += f_fl
        step_sum["fwd_bytes"] += f_by
        step_sum["bwd_flops"] += b_fl
        step_sum["bwd_bytes"] += b_by
        del x0, params, masks, dy, xl, pl_, leaves
    for ds, step_sum in ctot.items():
        step_sum["fwd_bound_ms"] = bound(step_sum["fwd_flops"], step_sum["fwd_bytes"])[0]
        step_sum["bwd_bound_ms"] = bound(step_sum["bwd_flops"], step_sum["bwd_bytes"])[0]
        log(f"[time-tower] one {ds} DeepSense step's towers: #13 {step_sum['fwd_ms']:.3f} ms "
            f"(plain {step_sum['fwd_plain_ms']:.3f}, library {step_sum['fwd_library_ms']:.3f}, "
            f"bound f32 {step_sum['fwd_bound_ms']:.3f}, TF32x3 {step_sum['fwd_bound_tc_ms']:.3f}, "
            f"{step_sum['fwd_flops'] / 1e9:.2f} GFLOP); #14 {step_sum['bwd_ms']:.3f} ms (plain "
            f"{step_sum['bwd_plain_ms']:.3f}, library {step_sum['bwd_library_ms']:.3f}, bound f32 "
            f"{step_sum['bwd_bound_ms']:.3f}, TF32x3 {step_sum['bwd_bound_tc_ms']:.3f}, "
            f"{step_sum['bwd_flops'] / 1e9:.2f} GFLOP)")
        log(f"[profile-tower] one {ds} DeepSense step's towers, device ms by phase: "
            f"#13 {step_sum['device_ms_by_phase']['fwd']}; #14 {step_sum['device_ms_by_phase']['bwd']}")
    mod_tot = ctot["MOD"]
    for ds, tag in (("MOD", "deepsense-pallas"), ("MOD_WIDE", "deepsense-pallas-wide")):
        log(f"[time-tower] share of the -pallas_conv p50 step ({ds}): "
            f"{(ctot[ds]['fwd_ms'] + ctot[ds]['bwd_ms']) / ds_runs[tag]['p50_ms']:.3f}")
    torch.cuda.empty_cache()
    # ---- 18. #10, #11 and #12 vs plain at every MLP geometry on the fused
    # route: MOD at the classifier batch of 128, MOD_WIDE stage 0 at batch
    # 64 with the views fused to 128
    mgeos = (mlp_geometries(cfg, SUP_BATCH, "MOD")
             + mlp_geometries(wcfg, 2 * WIDE_BATCH, "MOD_WIDE"))
    mlp_rate = float(cfg["SW_Transformer"]["dropout_ratio"])
    mlp_err = {"fwd": 0.0, "drop": 0.0, "bwd": 0.0, "bwd_abs": 0.0}
    for gi, g in enumerate(mgeos):
        T, C, H = g["T"], g["C"], g["H"]
        x, w1, b1, w2, b2, gy = mlp_inputs(torch, np, g, 300 + gi, dev)
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
        seed = 4000 + gi
        y, y_again = mlp_fwd(x, w1, b1, w2, b2), mlp_fwd(x, w1, b1, w2, b2)
        yd = mlp_drop(x, w1, b1, w2, b2, seed, mlp_rate)
        yd_again = mlp_drop(x, w1, b1, w2, b2, seed, mlp_rate)
        keep1, keep2 = fm.mlp_keep_masks(seed, T, C, H, mlp_rate, dev)
        torch.cuda.synchronize()
        err = float((y - fm.fused_mlp_reference(x, w1, b1, w2, b2)).abs().max())
        derr = float((yd - fm.fused_mlp_dropout_reference(x, w1, b1, w2, b2, keep1, keep2,
                                                          mlp_rate)).abs().max())
        rates = {}
        for name, k in (("keep1", keep1), ("keep2", keep2)):
            kept = float(k.double().mean())
            rates[name] = (kept, (kept - 1 + mlp_rate) / math.sqrt(mlp_rate * (1 - mlp_rate) / k.numel()))
        same = torch.equal(y, y_again) and torch.equal(yd, yd_again)
        errs = {}
        for tag, sd, keeps in (("mask", seed, (keep1, keep2)), ("nomask", None, (None, None))):
            got = mlp_bwd(x, w1, b1, w1t, w2t, gy, sd, mlp_rate)
            again = mlp_bwd(x, w1, b1, w1t, w2t, gy, sd, mlp_rate)
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, b) for a, b in zip(got, again))
            want = fm.fused_mlp_backward_reference(x, w1, b1, w2, b2, gy, *keeps, mlp_rate)
            errs[tag] = max(rel_err(a, b) for a, b in zip(got, want))
            mlp_err["bwd_abs"] = max(mlp_err["bwd_abs"], *(float((a - b).abs().max())
                                                            for a, b in zip(got, want)))
            del got, again, want
        g.update(max_abs_err_fwd=err, max_abs_err_dropout=derr, keep_rates=rates,
                 max_rel_err_bwd=errs["mask"], max_rel_err_bwd_nomask=errs["nomask"],
                 repeatable=same)
        mlp_err["fwd"], mlp_err["drop"] = max(mlp_err["fwd"], err), max(mlp_err["drop"], derr)
        mlp_err["bwd"] = max(mlp_err["bwd"], *errs.values())
        log(f"[check-mlp] {g['name']}: T {T} C {C} H {H} ({g['per_forward']} a forward): #10 "
            f"max|kernel-plain| {err:.3e}, #11 {derr:.3e} (its own masks), keep rates "
            + ", ".join(f"{k} {v[0]:.5f} ({v[1]:+.2f} sigma)" for k, v in rates.items())
            + f"; #12 max rel err {errs['mask']:.3e} (masks), {errs['nomask']:.3e} (none); "
            f"same bits on a second call: {same}")
        if not max(err, derr) <= KERNEL_TOL:
            raise AssertionError(f"{g['name']}: #10/#11 differ from plain by {err}, {derr}")
        if not all(abs(v[1]) <= 5 for v in rates.values()):
            raise AssertionError(f"{g['name']}: keep rates {rates} not 1 - {mlp_rate} within 5 sigma")
        if not max(errs.values()) <= GRAD_TOL:
            raise AssertionError(f"{g['name']}: #12 gradients differ from plain by {errs}")
        if not same:
            raise AssertionError(f"{g['name']}: #10/#11/#12 give other bits on a second call")
        del x, w1, b1, w2, b2, gy, w1t, w2t, y, y_again, yd, yd_again, keep1, keep2
    torch.cuda.empty_cache()

    # ---- 19. MOD supervised steps at batch 128, the default path and
    # -pallas_mlp; the rate-0 step, kernels vs plain, from the initial state
    per_fwd_mlp = sum(g["per_forward"] for g in mgeos if g["name"].startswith("MOD "))
    sup_step = {fwd_drop.__name__: per_fwd, bwd.__name__: per_fwd,
                mlp_drop.__name__: per_fwd_mlp, mlp_bwd.__name__: per_fwd_mlp}
    ft_step = {fwd_drop.__name__: per_fwd, mlp_drop.__name__: per_fwd_mlp}
    eval_fwd = {fwd.__name__: per_fwd, mlp_fwd.__name__: per_fwd_mlp}
    sup_runs = {}
    for pallas in (False, True):
        sargs = parse_train_params(["-dataset", "MOD", "-model", "SW_Transformer",
                                    "-learn_framework", "no", "-batch_size", str(SUP_BATCH)]
                                   + (["-pallas_mlp"] if pallas else []))
        tag = "supervised-pallas-mlp" if pallas else "supervised-default"
        per_step = sup_step if pallas else {fwd_drop.__name__: per_fwd, bwd.__name__: per_fwd}
        sup_runs[tag] = run_supervised_steps(torch, np, sargs, SUP_BATCH, TRAIN_WARMUP,
                                             TRAIN_STEPS, all_kernels, per_step, dev, tag)
        torch.cuda.empty_cache()
    run, p = sup_runs["supervised-pallas-mlp"], PARENT_STEPS["MOD_supervised_pallas_mlp"]
    log(f"[supervised-pallas-mlp] beside the CUDA-core #10-#12 (p50 {p['p50_ms']:.3f} ms, idle "
        f"share {p['idle_share']:.3f}, peak {p['peak_mb']:.1f} MiB): p50 {run['p50_ms']:.3f} ms "
        f"({run['p50_ms'] / p['p50_ms']:.3f}x), idle share {run['idle_share']:.3f}, device busy "
        f"{run['profile']['device_busy_ms']:.3f} ms, peak {run['peak_mb']:.1f} MiB "
        f"({run['peak_mb'] / p['peak_mb']:.3f}x; {run['peak_mb'] / sup_runs['supervised-default']['peak_mb']:.3f}x "
        f"the default route's), #10-#12 device {run['mlp_kernels_device_ms']:.4f} ms")
    from focal_tpu_torch.models import build_backbone, init_params

    sup_initial = init_params(build_backbone(cfg, "SW_Transformer", task, "no", pallas_mlp=True),
                              seed=0).state_dict()
    kern = supervised_rate0_step(torch, sargs, sup_initial, dev, plain=False)
    plain = supervised_rate0_step(torch, sargs, sup_initial, dev, plain=True)
    want0 = {fwd.__name__: per_fwd, bwd.__name__: per_fwd, mlp_fwd.__name__: per_fwd_mlp,
             mlp_bwd.__name__: per_fwd_mlp, fwd_drop.__name__: 0, mlp_drop.__name__: 0}
    check_counts("supervised rate-0 step (kernels)", kern[2], want0)
    check_counts("supervised rate-0 step (plain)", plain[2], {k: 0 for k in want0})
    sup_rate0_loss = abs(kern[0] - plain[0]) / abs(plain[0])
    # a true gradient of 0 (the fusion attention's key bias: its softmax is
    # blind to it) is rounding noise on both sides: compared absolutely
    zero_grads = [n for n in plain[1] if max(float(kern[1][n].abs().max()),
                                             float(plain[1][n].abs().max())) < TINY_GRAD]
    sup_rate0_grad, worst = max((rel_err(kern[1][n], plain[1][n]), n) for n in plain[1]
                                if n not in zero_grads)
    zero_abs = max([float((kern[1][n] - plain[1][n]).abs().max()) for n in zero_grads] + [0.0])
    sup_rate0 = {"loss_kernel": kern[0], "loss_plain": plain[0], "loss_rel": sup_rate0_loss,
                 "max_grad_rel": sup_rate0_grad, "worst": worst, "zero_gradients": zero_grads,
                 "zero_gradients_max_abs": zero_abs, "launches": kern[2]}
    log(f"[supervised-rate0] from the initial state, kernels vs plain: loss {kern[0]:.6f} vs "
        f"{plain[0]:.6f} (rel {sup_rate0_loss:.2e}), max grad rel err {sup_rate0_grad:.2e} "
        f"({worst}); true-zero gradients {zero_grads} within {zero_abs:.2e} absolute; "
        f"launches {kern[2]}")
    if set(kern[1]) != set(plain[1]) or not (sup_rate0_loss <= LOSS_TOL
                                             and sup_rate0_grad <= GRAD_TOL
                                             and zero_abs <= TINY_GRAD):
        raise AssertionError(f"supervised rate-0 step, kernels vs plain: {sup_rate0}")
    del kern, plain, sup_initial
    torch.cuda.empty_cache()

    # ---- 20. the classifier entry points at MOD with -pallas_mlp: supervised
    # 2 epochs, -resume to 3, test; FOCAL pretrain 1 epoch, finetune 2 epochs,
    # -resume to 3, test; then Predictor -pallas_mlp
    test_cli = importlib.import_module("focal_tpu_torch.test")
    run_dir = os.path.join(HERE, "build", "chip_smoke_classifier")
    shutil.rmtree(run_dir, ignore_errors=True)
    base = ["-dataset", "MOD", "-model", "SW_Transformer", "-pallas_mlp", "-synthetic",
            "-synthetic_samples", str(SUP_SAMPLES), "-val_epochs", "1", "-output_dir", run_dir]
    sup_argv = base + ["-learn_framework", "no", "-batch_size", str(SUP_BATCH)]
    pre_argv = base + ["-learn_framework", "FOCAL", "-stage", "pretrain"]
    ft_argv = base + ["-learn_framework", "FOCAL", "-stage", "finetune", "-batch_size",
                      str(SUP_BATCH)]

    def cli_plan(argv):
        """(train steps an epoch, eval forwards a validation point, eval
        forwards of the test CLI) of a run."""
        a = parse_train_params(argv)
        seq = a.train_mode == "contrastive" and a.stage == "pretrain"
        n = {o: len(DeviceDataLoader(load_split(o, a), a.batch_size, sequence=seq))
             for o in ("train", "val", "test")}
        steps = len(DeviceDataLoader(load_split("train", a), a.batch_size, drop_last=True,
                                     sequence=seq))
        evals = n["train"] + 3 * (n["val"] + n["test"]) if seq else n["val"] + n["test"]
        return steps, evals, n["test"]

    cls_runs = []

    def run_cli(what, fn, argv, per_step, epochs, points_want, evals=eval_fwd, runs=None):
        steps_per_epoch, evals_per_point, test_evals = cli_plan(argv)
        zero_counts(all_kernels)
        t0 = time.time()
        out = fn(argv)
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = counts(all_kernels)
        if points_want is None:  # the test CLI: one eval forward a test batch
            n_steps, n_evals = 0, test_evals
            if not all(math.isfinite(v) for v in out):
                raise AssertionError(f"{what}: non-finite test metrics {out}")
            summary = {"loss": out[0], "acc": out[1], "f1": out[2]}
        else:
            st, best, points = out
            n_steps, n_evals = steps_per_epoch * epochs, evals_per_point * len(points)
            if [p["epoch"] for p in points] != points_want:
                raise AssertionError(f"{what}: validation points {[p['epoch'] for p in points]}")
            for p in points:
                if not all(math.isfinite(p[k]) for k in ("train_loss", "val_loss", "test_loss")):
                    raise AssertionError(f"{what}: non-finite loss at a validation point: {p}")
            summary = {"best": best, "points": points, "step": st.step}
        want = {k.__name__: per_step.get(k.__name__, 0) * n_steps
                + evals.get(k.__name__, 0) * n_evals for k in all_kernels}
        check_counts(what, got, want)
        (cls_runs if runs is None else runs).append({"what": what, "seconds": secs, "steps": n_steps, "eval_forwards": n_evals,
                         "launches": got, **summary})
        log(f"[classifier-cli] {what}: {n_steps} steps, {n_evals} eval forwards in {secs:.1f}s; "
            f"launches {got}; " + ("; ".join(
                f"epoch {p['epoch']} train {p['train_loss']:.4f} val {p['val_loss']:.4f} val acc "
                f"{p['val_acc']:.3f} test acc {p['test_acc']:.3f}" for p in summary["points"])
                if "points" in summary else f"test loss {out[0]:.4f} acc {out[1]:.4f} f1 {out[2]:.4f}"))
        return out

    weights = os.path.join(run_dir, "weights", "MOD_SW_Transformer")
    run_cli("supervised -epochs 2", train_cli.main, sup_argv + ["-epochs", "2"], sup_step, 2, [0, 1])
    run_cli("supervised -epochs 3 -resume", train_cli.main, sup_argv + ["-epochs", "3", "-resume"],
            sup_step, 1, [2])
    run_cli("test (supervised _best)", test_cli.main, sup_argv, {}, 0, None)
    sup_dir = os.path.join(weights, "exp0_supervised_vehicle_classification_1.0")
    for kind in ("best", "latest", "resume"):
        path = os.path.join(sup_dir, f"MOD_SW_Transformer_vehicle_classification_{kind}.pt")
        if not os.path.isfile(path):
            raise AssertionError(f"missing checkpoint {path}")
    run_cli("pretrain -epochs 1", train_cli.main, pre_argv + ["-epochs", "1"], sup_step, 1, [0])
    pre_dir = os.path.join(weights, "exp0_contrastive_FOCAL")
    pretrained = torch.load(os.path.join(pre_dir, "MOD_SW_Transformer_pretrain_latest.pt"),
                            map_location="cpu", weights_only=True)
    ft_file = os.path.join(pre_dir, "MOD_SW_Transformer_vehicle_classification_1.0_finetune_latest.pt")
    for extra, epochs, points_want in ((["-epochs", "2"], 2, [0, 1]),
                                       (["-epochs", "3", "-resume"], 1, [2])):
        run_cli(f"finetune {' '.join(extra)}", train_cli.main, ft_argv + extra, ft_step, epochs,
                points_want)
        tuned = torch.load(ft_file, map_location="cpu", weights_only=True)
        moved = set()
        for name, t in tuned.items():
            head = name.startswith(("class_layer", "mod_fusion_layer"))
            if head and not torch.equal(t, pretrained[name]):
                moved.add(name.split(".")[0])
            if not head and not torch.equal(t, pretrained[name]):
                raise AssertionError(f"finetune moved the frozen backbone parameter {name}")
        if moved != {"class_layer", "mod_fusion_layer"}:
            raise AssertionError(f"finetune moved {moved}, not class_layer and mod_fusion_layer")
    run_cli("test (finetune _best)", test_cli.main, ft_argv, {}, 0, None)
    log(f"[classifier-cli] finetune left all {len(pretrained) - sum(n.startswith(('class_layer', 'mod_fusion_layer')) for n in pretrained)} "
        "backbone entries bitwise as pretrained; class_layer and mod_fusion_layer moved")
    shutil.rmtree(run_dir, ignore_errors=True)
    del pretrained, tuned
    torch.cuda.empty_cache()

    predictor = Predictor(cfg, "SW_Transformer", task, None, batch_size=SERVE_BATCH,
                          device="cuda", seed=0, pallas_mlp=True)
    zero_counts(all_kernels)
    mlp_result = predictor.predict(data)
    mlp_serve_launches = counts(all_kernels)
    mlp_batches = mlp_result["latency"]["batches"]
    check_counts("serving -pallas_mlp", mlp_serve_launches,
                 {k.__name__: eval_fwd.get(k.__name__, 0) * mlp_batches for k in all_kernels})
    mlp_serve_err = float(np.abs(mlp_result["probs"] - probs).max())
    mlp_lat = mlp_result["latency"]
    log(f"[serve-mlp] {n} samples in {mlp_batches} batches of {SERVE_BATCH} with -pallas_mlp: "
        f"launches {mlp_serve_launches}; p50 batch {mlp_lat['p50_s'] * 1e3:.3f} ms, "
        f"{mlp_lat['windows_per_s']:.1f} samples/s; max|dprobs| vs the cuBLAS MLP {mlp_serve_err:.3e}")
    if not mlp_serve_err <= SLICE_TOL:
        raise AssertionError(f"-pallas_mlp served probabilities differ by {mlp_serve_err}")
    del predictor
    torch.cuda.empty_cache()

    # ---- 21. #10, #11 and #12 timing per geometry: kernel, plain version,
    # the cuBLAS chain as the library yardstick (with F.dropout for #11 and
    # its autograd backward for #12), the bounds on the f32 CUDA cores and
    # on the TF32 tensor cores (3 passes), TFLOP/s; then profiled calls of
    # each at every geometry, which fail the run if a device kernel they
    # launch is not one of csrc/fused_mlp.cu's, split by kernel name
    mtot = {}
    for gi, g in enumerate(mgeos):
        T, C, H = g["T"], g["C"], g["H"]
        x, w1, b1, w2, b2, gy = mlp_inputs(torch, np, g, 500 + gi, dev)
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
        keep1, keep2 = fm.mlp_keep_masks(7, T, C, H, mlp_rate, dev)
        calls = {"fwd": lambda: mlp_fwd(x, w1, b1, w2, b2),
                 "drop": lambda: mlp_drop(x, w1, b1, w2, b2, 7, mlp_rate),
                 "bwd": lambda: mlp_bwd(x, w1, b1, w1t, w2t, gy, 7, mlp_rate)}
        with torch.no_grad():
            g["fwd_ms"] = time_ms(torch, calls["fwd"])
            g["fwd_plain_ms"] = time_ms(torch, lambda: fm.fused_mlp_reference(x, w1, b1, w2, b2))
            g["fwd_library_ms"] = time_ms(torch, lambda: library_mlp(torch, F, x, w1, b1, w2, b2))
            g["drop_ms"] = time_ms(torch, calls["drop"])
            g["drop_plain_ms"] = time_ms(torch, lambda: fm.fused_mlp_dropout_reference(
                x, w1, b1, w2, b2, keep1, keep2, mlp_rate))
            g["drop_library_ms"] = time_ms(
                torch, lambda: library_mlp(torch, F, x, w1, b1, w2, b2, mlp_rate))
        g["bwd_ms"] = time_ms(torch, calls["bwd"])
        g["bwd_nomask_ms"] = time_ms(torch, lambda: mlp_bwd(x, w1, b1, w1t, w2t, gy))
        g["bwd_plain_ms"] = time_ms(torch, lambda: fm.fused_mlp_backward_reference(
            x, w1, b1, w2, b2, gy, keep1, keep2, mlp_rate))
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        ly = library_mlp(torch, F, *leaves, mlp_rate)
        g["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(ly, leaves, gy,
                                                                         retain_graph=True))
        del ly, leaves
        f_fl, f_by = mlp_work(g, False)
        b_fl, b_by = mlp_work(g, True)
        g["fwd_bound_ms"], g["fwd_bound_by"] = bound(f_fl, f_by)
        g["bwd_bound_ms"], g["bwd_bound_by"] = bound(b_fl, b_by)
        g["fwd_bound_tc_ms"], g["bwd_bound_tc_ms"] = tc_bound(f_fl, f_by), tc_bound(b_fl, b_by)
        g["fwd_gflop"], g["bwd_gflop"] = f_fl / 1e9, b_fl / 1e9
        g["chunks"] = fm.mlp_launch_plan(T, C, H, True, dev)[1]
        log(f"[time-mlp] {g['name']} ({g['chunks']} row chunks): #10 {g['fwd_ms']:.4f} ms (plain "
            f"{g['fwd_plain_ms']:.4f}, library {g['fwd_library_ms']:.4f}, bound f32 "
            f"{g['fwd_bound_ms']:.4f}, TF32x3 {g['fwd_bound_tc_ms']:.4f}, "
            f"{f_fl / g['fwd_ms'] / 1e9:.2f} TFLOP/s); #11 {g['drop_ms']:.4f} ms (plain "
            f"{g['drop_plain_ms']:.4f}, library {g['drop_library_ms']:.4f}, "
            f"{f_fl / g['drop_ms'] / 1e9:.2f} TFLOP/s); #12 {g['bwd_ms']:.4f} ms, "
            f"{g['bwd_nomask_ms']:.4f} without masks (plain {g['bwd_plain_ms']:.4f}, library "
            f"{g['bwd_library_ms']:.4f}, bound f32 {g['bwd_bound_ms']:.4f}, TF32x3 "
            f"{g['bwd_bound_tc_ms']:.4f}, {b_fl / g['bwd_ms'] / 1e9:.2f} TFLOP/s)")
        for fn in calls.values():  # warm before the traces
            fn()
        torch.cuda.synchronize()
        # a trace of well under a millisecond of kernels lost every record:
        # at least PROFILE_TRACE_MS of calls
        g["profile"] = {d: kernel_phase_split(
            torch, fn, mlp_launches(g["chunks"], "bwd" if d == "bwd" else "fwd"), MLP_LIB,
            reps=max(PROFILE_REPS, math.ceil(PROFILE_TRACE_MS / g[f"{d}_ms"])))
            for d, fn in calls.items()}
        log(f"[profile-mlp] {g['name']}: " + "; ".join(
            f"{name} device {g['profile'][d]['device_ms']:.4f} ms a call (" + ", ".join(
                f"{p} {ms:.4f}" for p, ms in sorted(g["profile"][d]["phases"].items(),
                                                    key=lambda kv: -kv[1])) + ")"
            for d, name in (("fwd", "#10"), ("drop", "#11"), ("bwd", "#12"))))
        ds = g["name"].split()[0]
        step_sum = mtot.setdefault(ds, {"fwd_flops": 0, "fwd_bytes": 0, "bwd_flops": 0,
                                        "bwd_bytes": 0, "launches": 0,
                                        "device_ms_by_phase": {"fwd": {}, "drop": {}, "bwd": {}}})
        k = g["per_forward"]
        for key in ("fwd_ms", "fwd_plain_ms", "fwd_library_ms", "drop_ms", "drop_plain_ms",
                    "drop_library_ms", "bwd_ms", "bwd_nomask_ms", "bwd_plain_ms",
                    "bwd_library_ms"):
            step_sum[key] = step_sum.get(key, 0.0) + k * g[key]
        for d, split in step_sum["device_ms_by_phase"].items():
            for phase, ms in g["profile"][d]["phases"].items():
                split[phase] = split.get(phase, 0.0) + k * ms
        step_sum["fwd_flops"] += k * f_fl
        step_sum["fwd_bytes"] += k * f_by
        step_sum["bwd_flops"] += k * b_fl
        step_sum["bwd_bytes"] += k * b_by
        step_sum["launches"] += k
        del x, w1, b1, w2, b2, gy, w1t, w2t, keep1, keep2, calls
    for ds, step_sum in mtot.items():
        for d in ("fwd", "bwd"):
            fl, by = step_sum[f"{d}_flops"], step_sum[f"{d}_bytes"]
            step_sum[f"{d}_bound_ms"], step_sum[f"{d}_bound_tc_ms"] = bound(fl, by)[0], tc_bound(fl, by)
        log(f"[time-mlp] one {ds} forward's MLPs ({step_sum['launches']} launches): #10 "
            f"{step_sum['fwd_ms']:.3f} ms (plain {step_sum['fwd_plain_ms']:.3f}, library "
            f"{step_sum['fwd_library_ms']:.3f}, bound f32 {step_sum['fwd_bound_ms']:.3f}, TF32x3 "
            f"{step_sum['fwd_bound_tc_ms']:.3f}, {step_sum['fwd_flops'] / 1e9:.2f} GFLOP, "
            f"{step_sum['fwd_flops'] / step_sum['fwd_ms'] / 1e9:.2f} TFLOP/s); #11 "
            f"{step_sum['drop_ms']:.3f} (plain {step_sum['drop_plain_ms']:.3f}, library "
            f"{step_sum['drop_library_ms']:.3f}); #12 {step_sum['bwd_ms']:.3f} ms, "
            f"{step_sum['bwd_nomask_ms']:.3f} without masks (plain {step_sum['bwd_plain_ms']:.3f}, "
            f"library {step_sum['bwd_library_ms']:.3f}, bound f32 {step_sum['bwd_bound_ms']:.3f}, "
            f"TF32x3 {step_sum['bwd_bound_tc_ms']:.3f}, {step_sum['bwd_flops'] / 1e9:.2f} GFLOP, "
            f"{step_sum['bwd_flops'] / step_sum['bwd_ms'] / 1e9:.2f} TFLOP/s); device ms by "
            f"phase: {step_sum['device_ms_by_phase']}")
    mod_mlp = mtot["MOD"]
    log(f"[time-mlp] share of the -pallas_mlp supervised p50 step (MOD): "
        f"{(mod_mlp['drop_ms'] + mod_mlp['bwd_ms']) / sup_runs['supervised-pallas-mlp']['p50_ms']:.3f}")
    torch.cuda.empty_cache()

    # ---- 22. #6-#9 vs plain at every attention geometry: MOD served (128)
    # and training (256, views fused to 512), MOD_WIDE's 16 blocks (64 fused
    # to 128); #7's mask against #2's (#4's where #2 does not launch)
    agen = {"serve": attention_geometries(cfg, SERVE_BATCH, "MOD"),
            "train": attention_geometries(cfg, 2 * TRAIN_BATCH, "MOD"),
            "wide": attention_geometries(wcfg, 2 * WIDE_BATCH, "MOD_WIDE")}
    at_err = {"fwd": 0.0, "drop": 0.0, "bwd": 0.0, "bwd_abs": 0.0}
    t22 = time.time()
    for kind, ags in agen.items():
        a_rate = wrate if kind == "wide" else rate
        for gi, g in enumerate(ags):
            B, H, N, C = g["windows"], g["heads"], g["N"], g["C"]
            seed = 6000 + 100 * len(kind) + gi
            q, k, v, rel_bias, mask, gy = attention_inputs(torch, np, g, seed, dev)
            y = at_fwd(q, k, v, rel_bias, mask)
            yd = at_drop(q, k, v, rel_bias, mask, seed, a_rate)
            keep = pk.window_attention_keep_mask(seed, B, H, N, a_rate, dev)
            blk = fwd_drop if pk.wblock_fits(N, C, H) else ph_fwd
            blk_keep = blk(*make_inputs(torch, g, gen, dev), seed, a_rate)[1]
            torch.cuda.synchronize()
            same_mask = bool(torch.equal(blk_keep, keep))
            del blk_keep
            err = float((y - pk.fused_window_attention_reference(q, k, v, rel_bias, mask)).abs().max())
            derr = float((yd - pk.fused_window_attention_dropout_reference(
                q, k, v, rel_bias, mask, keep, a_rate)).abs().max())
            kept = float(keep.double().mean())
            sigma = math.sqrt(a_rate * (1 - a_rate) / keep.numel())
            errs, same = {}, True
            for tag, sd, kp in (("mask", seed, keep), ("nomask", None, None)):
                r = a_rate if sd is not None else 0.0
                got = pk.fused_window_attention_backward(q, k, v, rel_bias, mask, gy, sd, r)
                again = pk.fused_window_attention_backward(q, k, v, rel_bias, mask, gy, sd, r)
                torch.cuda.synchronize()
                same = same and all(torch.equal(a, b) for a, b in zip(got, again))
                want = pk.fused_window_attention_backward_reference(q, k, v, rel_bias, mask, gy, kp, r)
                errs[tag] = grads_differ(got, want)
                at_err["bwd_abs"] = max(at_err["bwd_abs"], *(float((a - b).abs().max())
                                                              for a, b in zip(got, want)))
                del got, again, want
            g.update(max_abs_err_fwd=err, max_abs_err_dropout=derr, keep_rate=kept,
                     keep_sigma=sigma, mask_equals_whole_block=same_mask,
                     max_rel_err_bwd=errs["mask"], max_rel_err_bwd_nomask=errs["nomask"],
                     repeatable=same)
            at_err["fwd"], at_err["drop"] = max(at_err["fwd"], err), max(at_err["drop"], derr)
            at_err["bwd"] = max(at_err["bwd"], *errs.values())
            log(f"[check-attn] {g['name']}: windows {B} heads {H} N {N} hd {g['hd']} nW {g['nW']}: "
                f"#6 max|kernel-plain| {err:.3e}, #7 {derr:.3e} (its own mask), keep rate {kept:.5f} "
                f"({(kept - 1 + a_rate) / sigma:+.2f} sigma), mask == {blk.__name__}'s: {same_mask}; "
                f"#9 max rel err {errs['mask']:.3e}, #8 {errs['nomask']:.3e}; same bits on a second "
                f"call: {same}")
            if not max(err, derr) <= KERNEL_TOL:
                raise AssertionError(f"{g['name']}: #6/#7 differ from plain by {err}, {derr}")
            if not abs(kept - (1 - a_rate)) <= 5 * sigma:
                raise AssertionError(f"{g['name']}: keep rate {kept} is not 1 - {a_rate} within 5 sigma")
            if not same_mask:
                raise AssertionError(f"{g['name']}: #7's keep mask differs from {blk.__name__}'s")
            if not max(errs.values()) <= GRAD_TOL:
                raise AssertionError(f"{g['name']}: #8/#9 gradients differ from plain by {errs}")
            if not same:
                raise AssertionError(f"{g['name']}: #8/#9 give other bits on a second call")
            del q, k, v, rel_bias, mask, gy, y, yd, keep
    torch.cuda.empty_cache()
    log(f"[check-attn] {sum(len(a) for a in agen.values())} geometries in {time.time() - t22:.1f}s")

    # ---- 23. MOD pretrain steps with -no_pallas_block at batch 256; the
    # rate-0 step from the initial state (#6 and #8), kernels vs plain
    attn_step = {at_drop.__name__: per_fwd, at_drop_bwd.__name__: per_fwd}
    nargs = parse_train_params(["-dataset", "MOD", "-model", "SW_Transformer",
                                "-learn_framework", "FOCAL", "-stage", "pretrain",
                                "-no_pallas_block", "-batch_size", str(TRAIN_BATCH)])
    attn_train, (state, step, tdata, idx) = run_train_steps(
        torch, np, nargs, TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, all_kernels, attn_step, dev,
        "train-no-pallas-block", rate0_from="initial",
        rate0_launches={at_fwd.__name__: per_fwd, at_bwd.__name__: per_fwd})
    attn_profile = profile_device(torch, lambda: step(state, tdata, idx))
    log_profile("profile-no-pallas-block", "one -no_pallas_block training step", attn_profile, top=15)
    attn_train["idle_share"] = 1 - attn_profile["device_busy_ms"] / attn_profile["wall_ms"]
    attn_train["attention_kernels_device_ms"] = {
        kern: sum(r["device_ms"] for r in attn_profile["rows"] if f"{kern}<true>" in r["name"])
        for kern in ("wattn_fwd_kernel", "wattn_bwd_kernel")}
    log(f"[train-no-pallas-block] device time in the profiled step: #7 "
        f"{attn_train['attention_kernels_device_ms']['wattn_fwd_kernel']:.4f} ms, #9 "
        f"{attn_train['attention_kernels_device_ms']['wattn_bwd_kernel']:.4f} ms (16 launches each; "
        f"#9's ordered d rel_bias pass apart); beside the default route's step of "
        f"phases 7 and 9: p50 {attn_train['p50_ms']:.3f} vs {p50_ms:.3f} ms, idle share "
        f"{attn_train['idle_share']:.3f} vs {train['idle_share']:.3f}, peak memory "
        f"{attn_train['peak_mb']:.1f} vs {train['peak_mb']:.1f} MiB")
    del state, step, tdata, idx
    torch.cuda.empty_cache()

    # ---- 24. the entry points at MOD with -no_pallas_block: supervised 1
    # epoch, -resume to 2, test; FOCAL pretrain 1 epoch, finetune 1 epoch,
    # test; then Predictor(pallas_block=False)
    run_dir = os.path.join(HERE, "build", "chip_smoke_no_pallas_block")
    shutil.rmtree(run_dir, ignore_errors=True)
    nbase = ["-dataset", "MOD", "-model", "SW_Transformer", "-no_pallas_block", "-synthetic",
             "-synthetic_samples", str(SUP_SAMPLES), "-val_epochs", "1", "-output_dir", run_dir]
    nsup = nbase + ["-learn_framework", "no", "-batch_size", str(SUP_BATCH)]
    nft = nbase + ["-learn_framework", "FOCAL", "-stage", "finetune", "-batch_size", str(SUP_BATCH)]
    attn_eval = {at_fwd.__name__: per_fwd}
    attn_runs = []
    for what, fn, argv, per_step, epochs, points_want in (
            ("supervised -epochs 1", train_cli.main, nsup + ["-epochs", "1"], attn_step, 1, [0]),
            ("supervised -epochs 2 -resume", train_cli.main, nsup + ["-epochs", "2", "-resume"],
             attn_step, 1, [1]),
            ("test (supervised _best)", test_cli.main, nsup, {}, 0, None),
            ("pretrain -epochs 1", train_cli.main,
             nbase + ["-learn_framework", "FOCAL", "-stage", "pretrain", "-epochs", "1"],
             attn_step, 1, [0]),
            ("finetune -epochs 1", train_cli.main, nft + ["-epochs", "1"],
             {at_drop.__name__: per_fwd}, 1, [0]),  # the frozen backbone takes no backward
            ("test (finetune _best)", test_cli.main, nft, {}, 0, None)):
        run_cli(f"-no_pallas_block {what}", fn, argv, per_step, epochs, points_want,
                evals=attn_eval, runs=attn_runs)
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    predictor = Predictor(cfg, "SW_Transformer", task, None, batch_size=SERVE_BATCH,
                          device="cuda", seed=0, pallas_block=False)
    zero_counts(all_kernels)
    attn_result = predictor.predict(data)
    attn_serve_launches = counts(all_kernels)
    attn_batches = attn_result["latency"]["batches"]
    check_counts("serving -no_pallas_block", attn_serve_launches,
                 {k.__name__: attn_eval.get(k.__name__, 0) * attn_batches for k in all_kernels})
    attn_serve_err = float(np.abs(attn_result["probs"] - probs).max())
    attn_lat = attn_result["latency"]
    log(f"[serve-no-pallas-block] {n} samples in {attn_batches} batches of {SERVE_BATCH}: launches "
        f"{attn_serve_launches}; p50 batch {attn_lat['p50_s'] * 1e3:.3f} ms (#1's route "
        f"{lat['p50_s'] * 1e3:.3f}), {attn_lat['windows_per_s']:.1f} samples/s; max|dprobs| vs "
        f"#1's route {attn_serve_err:.3e}")
    if not attn_serve_err <= SLICE_TOL:
        raise AssertionError(f"-no_pallas_block served probabilities differ by {attn_serve_err}")
    predictor._forward(first)
    attn_serve_profile = profile_device(torch, lambda: predictor._forward(first))
    log_profile("profile-serve-no-pallas-block", "one -no_pallas_block served batch",
                attn_serve_profile)
    attn_serve_device_ms = sum(r["device_ms"] for r in attn_serve_profile["rows"]
                               if "wattn_fwd_kernel<false>" in r["name"])
    log(f"[serve-no-pallas-block] device time of #6 in the profiled batch: "
        f"{attn_serve_device_ms:.4f} ms ({per_fwd} launches)")
    del predictor
    torch.cuda.empty_cache()

    # ---- 25. #6-#9 timing per geometry: kernel, plain version, the library
    # yardstick (scaled_dot_product_attention with the bias as attn_mask,
    # its autograd backward) and the bound; #6 over one served forward, #7,
    # #8 (rate 0) and #9 over one training step
    atot = {}
    for kind, keys in (("serve", ("fwd",)), ("train", ("drop", "bwd", "drop_bwd"))):
        tot_k = atot.setdefault(kind, {})
        for gi, g in enumerate(agen[kind]):
            q, k, v, rel_bias, mask, gy = attention_inputs(torch, np, g, 7000 + gi, dev)
            attn_mask = library_mask(torch, g, rel_bias, mask)
            fb = {"fwd": attention_work(g, False), "bwd": attention_work(g, True)}
            fb["drop"], fb["drop_bwd"] = fb["fwd"], fb["bwd"]
            with torch.no_grad():
                if kind == "serve":
                    g["fwd_ms"] = time_ms(torch, lambda: at_fwd(q, k, v, rel_bias, mask))
                    g["fwd_plain_ms"] = time_ms(
                        torch, lambda: pk.fused_window_attention_reference(q, k, v, rel_bias, mask))
                    g["fwd_library_ms"] = time_ms(
                        torch, lambda: library_attention(torch, q, k, v, attn_mask))
                else:
                    keep = pk.window_attention_keep_mask(7, g["windows"], g["heads"], g["N"], rate,
                                                         dev)
                    g["drop_ms"] = time_ms(torch, lambda: at_drop(q, k, v, rel_bias, mask, 7, rate))
                    g["drop_plain_ms"] = time_ms(torch, lambda: pk.fused_window_attention_reference(
                        q, k, v, rel_bias, mask, keep, rate))
                    g["drop_library_ms"] = time_ms(
                        torch, lambda: library_attention(torch, q, k, v, attn_mask, rate))
            if kind == "train":
                g["bwd_ms"] = time_ms(torch, lambda: at_bwd(q, k, v, rel_bias, mask, gy))
                g["drop_bwd_ms"] = time_ms(
                    torch, lambda: at_drop_bwd(q, k, v, rel_bias, mask, gy, 7, rate))
                g["bwd_plain_ms"] = time_ms(torch, lambda: pk.fused_window_attention_backward_reference(
                    q, k, v, rel_bias, mask, gy))
                g["drop_bwd_plain_ms"] = time_ms(
                    torch, lambda: pk.fused_window_attention_backward_reference(
                        q, k, v, rel_bias, mask, gy, keep, rate))
                for r, key in ((0.0, "bwd_library_ms"), (rate, "drop_bwd_library_ms")):
                    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
                    am = attn_mask.clone().requires_grad_(True)
                    ly = library_attention(torch, *leaves, am, r)
                    g[key] = time_ms(torch, lambda: torch.autograd.grad(ly, leaves + [am], gy,
                                                                        retain_graph=True))
                    del ly, leaves, am
                del keep
            for d in keys:
                g[f"{d}_flops_bytes"] = fb[d]
                g[f"{d}_bound_ms"], g[f"{d}_bound_by"] = bound(*fb[d])
                for s in ("", "_plain", "_library", "_bound"):
                    tot_k[f"{d}{s}_ms"] = tot_k.get(f"{d}{s}_ms", 0.0) + g["per_forward"] * g[f"{d}{s}_ms"]
                tot_k[f"{d}_flops"] = tot_k.get(f"{d}_flops", 0) + g["per_forward"] * fb[d][0]
                tot_k[f"{d}_bytes"] = tot_k.get(f"{d}_bytes", 0) + g["per_forward"] * fb[d][1]
            log(f"[time-attn] {g['name']} (windows {g['windows']}, hd {g['hd']}): " + "; ".join(
                f"{d} {g[f'{d}_ms']:.4f} ms (plain {g[f'{d}_plain_ms']:.4f}, library "
                f"{g[f'{d}_library_ms']:.4f}, bound {g[f'{d}_bound_ms']:.4f} by {g[f'{d}_bound_by']}, "
                f"{fb[d][1] / g[f'{d}_ms'] / 1e6:.1f} GB/s)" for d in keys))
            del q, k, v, rel_bias, mask, gy, attn_mask
    names = {"fwd": "#6", "drop": "#7", "bwd": "#8 (rate 0)", "drop_bwd": "#9"}
    for kind, tot_k in atot.items():
        what = (f"one served MOD forward at batch {SERVE_BATCH}" if kind == "serve" else
                f"one MOD training step at batch {TRAIN_BATCH} (views fused to {2 * TRAIN_BATCH})")
        log(f"[time-attn] {what}, {per_fwd} launches each: " + "; ".join(
            f"{names[d]} {tot_k[f'{d}_ms']:.3f} ms (plain {tot_k[f'{d}_plain_ms']:.3f}, library "
            f"{tot_k[f'{d}_library_ms']:.3f}, bound {tot_k[f'{d}_bound_ms']:.3f}, "
            f"{tot_k[f'{d}_bytes'] / 1e9:.3f} GB, {tot_k[f'{d}_flops'] / 1e9:.3f} GFLOP)"
            for d in ("fwd", "drop", "bwd", "drop_bwd") if f"{d}_ms" in tot_k))
    a_train = atot["train"]
    log(f"[time-attn] share of the -no_pallas_block p50 step (MOD): "
        f"{(a_train['drop_ms'] + a_train['drop_bwd_ms']) / attn_train['p50_ms']:.3f}")
    torch.cuda.empty_cache()
    log(f"[smoke] phases 22-25 in {time.time() - t22:.1f}s; {time.time() - t_start:.1f}s after the "
        "build started")

    if cli.out:
        os.makedirs(cli.out, exist_ok=True)
        with open(os.path.join(cli.out, "chip_smoke.json"), "w") as f:
            json.dump({
                "card": card,
                "geometries": [{k: v for k, v in g.items() if k != "mask"} for g in geos],
                "train_geometries": [{k: v for k, v in g.items() if k != "mask"} for g in tgeos],
                "wide_geometries": [{k: v for k, v in g.items() if k != "mask"} for g in pgeos],
                "wide_stage0_geometries": [{k: v for k, v in g.items() if k != "mask"}
                                           for g in mono],
                "per_forward": tot, "per_step": ttot, "wide_per_step": wtot,
                "wide_stage0_per_step": stot, "train_device_ms_by_phase": train_split,
                "wide_stage0_device_ms_by_phase": wide_split,
                "wide_perhead_device_ms_by_phase": ph_split, "latency": lat,
                "launches": launches, "slice_err": slice_err, "profile": serve_profile,
                "train": train, "train_profile": train_profile, "wide": wide,
                "wide_profile": wide_profile, "train_cli": cli_runs,
                "tower_geometries": [{k: v for k, v in g.items() if k != "cfgs"} for g in cgeos],
                "tower_per_step": ctot, "deepsense_steps": ds_runs, "deepsense_rate0": rate0,
                "deepsense_cli": ds_cli, "deepsense_serve_latency": ds_lat,
                "mlp_geometries": mgeos, "mlp_per_forward": mtot, "supervised_steps": sup_runs,
                "supervised_rate0": sup_rate0, "classifier_cli": cls_runs,
                "serve_pallas_mlp_latency": mlp_lat, "serve_pallas_mlp_err": mlp_serve_err,
                "attention_geometries": {kind: [{k: v for k, v in g.items() if k != "mask"}
                                                for g in ags] for kind, ags in agen.items()},
                "attention_totals": atot, "no_pallas_block_steps": attn_train,
                "no_pallas_block_profile": attn_profile, "no_pallas_block_cli": attn_runs,
                "serve_no_pallas_block_latency": attn_lat,
                "serve_no_pallas_block_err": attn_serve_err,
                "serve_no_pallas_block_profile": attn_serve_profile,
            }, f, indent=1)

    def entry(name, replaces, launches_, err, ms, plain, bnd, flops_bytes, lib, per,
              source="focal_tpu_torch/csrc/window_block.cu", **extra):
        ops_t, byte_t = flops_bytes[0] / F32_FLOPS, flops_bytes[1] / HBM_BYTES_PER_S
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bnd,
                "bound_by": "operations" if ops_t >= byte_t else "bytes", "library_ms": lib,
                "per": per, **extra}

    by_path = {k.__name__: {"serve_MOD": serve_launches[k.__name__],
                            "pretrain_steps_MOD": train_launches[k.__name__],
                            "train_cli_MOD_WIDE": sum(r["launches"][k.__name__] for r in cli_runs),
                            "pretrain_steps_MOD_WIDE": wide["launches"][k.__name__],
                            "pretrain_steps_MOD_DeepSense_default":
                                ds_runs["deepsense-default"]["launches"][k.__name__],
                            "pretrain_steps_MOD_DeepSense_pallas_conv":
                                ds_runs["deepsense-pallas"]["launches"][k.__name__],
                            "pretrain_steps_MOD_WIDE_DeepSense_default":
                                ds_runs["deepsense-default-wide"]["launches"][k.__name__],
                            "pretrain_steps_MOD_WIDE_DeepSense_pallas_conv":
                                ds_runs["deepsense-pallas-wide"]["launches"][k.__name__],
                            "train_cli_MOD_DeepSense": sum(r["launches"][k.__name__] for r in ds_cli),
                            "serve_MOD_DeepSense": ds_serve_launches[k.__name__],
                            "supervised_steps_MOD_default":
                                sup_runs["supervised-default"]["launches"][k.__name__],
                            "supervised_steps_MOD_pallas_mlp":
                                sup_runs["supervised-pallas-mlp"]["launches"][k.__name__],
                            "supervised_rate0_step_MOD": sup_rate0["launches"].get(k.__name__, 0),
                            "classifier_cli_MOD_pallas_mlp":
                                sum(r["launches"][k.__name__] for r in cls_runs),
                            "serve_MOD_pallas_mlp": mlp_serve_launches[k.__name__],
                            "pretrain_steps_MOD_no_pallas_block": attn_train["launches"][k.__name__],
                            "pretrain_rate0_step_MOD_no_pallas_block":
                                attn_train["rate0_launches"][k.__name__],
                            "classifier_cli_MOD_no_pallas_block":
                                sum(r["launches"][k.__name__] for r in attn_runs),
                            "serve_MOD_no_pallas_block": attn_serve_launches[k.__name__]}
               for k in all_kernels}
    cli_launches = by_path[ph_fwd.__name__]["train_cli_MOD_WIDE"]
    train_per = (f"times: one pretrain step at batch {TRAIN_BATCH} (views fused to "
                 f"{2 * TRAIN_BATCH}), 16 launches; launches: {TRAIN_STEPS} timed steps")
    wide_per = (f"times: one MOD_WIDE pretrain step at batch {WIDE_BATCH} (views fused to "
                f"{2 * WIDE_BATCH}), {n_ph} launches; launches: the MOD_WIDE train CLI run "
                f"({sum(r['steps'] for r in cli_runs)} steps, "
                f"{sum(r['eval_forwards'] for r in cli_runs)} eval forwards)")
    tower_per = (f"times: the two conv towers of one MOD DeepSense pretrain step at batch "
                 f"{DS_BATCH} (views fused to {2 * DS_BATCH}; mod_wide_step: MOD_WIDE at "
                 f"{DS_WIDE_BATCH}); launches: {TRAIN_STEPS} timed MOD -pallas_conv steps; "
                 f"max_abs_err: worst over the MOD and MOD_WIDE towers (#14: every gradient, the "
                 f"near-zero conv-bias ones included)")

    MLP_SRC = "focal_tpu_torch/csrc/fused_mlp.cu"
    sup_mlp_launches = sup_runs["supervised-pallas-mlp"]["launches"]
    mlp_per = (f"times: the {per_fwd_mlp} MLPs of one MOD forward at batch {SUP_BATCH}; launches: "
               f"the -pallas_mlp served run ({mlp_batches} forwards)")
    mlp_step_per = (f"times: the {per_fwd_mlp} MLPs of one MOD supervised step at batch "
                    f"{SUP_BATCH} (dropout {mlp_rate}); launches: {TRAIN_STEPS} timed -pallas_mlp "
                    "supervised steps; max_abs_err: worst over the MOD and MOD_WIDE stage-0 "
                    "geometries")

    def train_extra(d):
        """#2's or #3's bounds on the tensor cores and by the design's bytes,
        device time by phase, and the MOD_WIDE stage-0 step's figures."""
        return {"bound_ms_tensor_cores": ttot[f"{d}_bound_tc_ms"],
                "bound_ms_design_bytes": ttot[f"{d}_bound_design_ms"],
                "device_ms_by_phase": train_split[d],
                "mod_wide_stage0": {
                    k: stot[f"{d}_{k}"] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_tc_ms", "bound_design_ms")}
                | {"device_ms_by_phase": wide_split[d],
                   "launches_per_step": wide_per_step[fwd_drop.__name__]}}

    def mlp_extra(d):
        """#10's, #11's or #12's bound on the tensor cores, device time by
        phase, and the MOD_WIDE stage-0 figures."""
        key = "fwd" if d == "drop" else d
        w = mtot["MOD_WIDE"]
        return {"bound_ms_tensor_cores": mod_mlp[f"{key}_bound_tc_ms"],
                "device_ms_by_phase": mod_mlp["device_ms_by_phase"][d],
                "mod_wide_stage0": {
                    "ms": w[f"{d}_ms"], "plain_ms": w[f"{d}_plain_ms"],
                    "library_ms": w[f"{d}_library_ms"], "bound_ms": w[f"{key}_bound_ms"],
                    "bound_ms_tensor_cores": w[f"{key}_bound_tc_ms"],
                    "device_ms_by_phase": w["device_ms_by_phase"][d],
                    "rows_of_samples": 2 * WIDE_BATCH, "launches": w["launches"]}}

    def per_wide(d):
        w = ctot["MOD_WIDE"]
        return {"ms": w[f"{d}_ms"], "plain_ms": w[f"{d}_plain_ms"],
                "library_ms": w[f"{d}_library_ms"], "bound_ms": w[f"{d}_bound_ms"],
                "bound_ms_tensor_cores": w[f"{d}_bound_tc_ms"],
                "device_ms_by_phase": w["device_ms_by_phase"][d], "batch": DS_WIDE_BATCH,
                "launches_per_step": ds_wide_per_step[(ct_fwd if d == "fwd" else ct_bwd).__name__]}

    kernels = [
        entry("fused_window_block", f"{PK}:949", launches, max_err, tot["ms"], tot["plain_ms"],
              tot["bound_ms"], (tot["flops"], tot["bytes"]), tot["library_ms"],
              f"times: one forward at batch {SERVE_BATCH}, 16 launches over {len(geos)} "
              f"geometries; launches: all {batches} forwards of the served run",
              launches_per_forward=per_fwd, forwards=batches, launches_by_path=by_path[fwd.__name__]),
        entry("fused_window_block_dropout", f"{PK}:1432", train_launches[fwd_drop.__name__],
              drop_err, ttot["fwd_ms"], ttot["fwd_plain_ms"], ttot["fwd_bound_ms"],
              (ttot["fwd_flops"], ttot["fwd_bytes"]), ttot["fwd_library_ms"], train_per,
              launches_per_step=per_fwd, steps=TRAIN_STEPS, **train_extra("fwd"),
              launches_by_path=by_path[fwd_drop.__name__]),
        entry("fused_window_block_backward", f"{PK}:971",
              train_launches[bwd.__name__], grad_abs, ttot["bwd_ms"],
              ttot["bwd_plain_ms"], ttot["bwd_bound_ms"], (ttot["bwd_flops"], ttot["bwd_bytes"]),
              ttot["bwd_library_ms"], train_per, launches_per_step=per_fwd, steps=TRAIN_STEPS,
              max_rel_err=grad_err, **train_extra("bwd"), launches_by_path=by_path[bwd.__name__]),
        entry("fused_window_block_perhead", f"{PK}:1123", cli_launches,
              max(ph_err, ph_drop_err), wtot["fwd_ms"], wtot["fwd_plain_ms"], wtot["fwd_bound_ms"],
              (wtot["fwd_flops"], wtot["fwd_bytes"]), wtot["fwd_library_ms"], wide_per, launches_per_step=n_ph,
              launches_per_eval_forward=wide_per_eval[ph_fwd.__name__],
              eval_forward_ms=wtot["eval_ms"], bound_ms_tensor_cores=wtot["fwd_bound_tc_ms"],
              device_ms_by_phase=ph_split["fwd"], launches_by_path=by_path[ph_fwd.__name__]),
        entry("fused_window_block_perhead_backward", f"{PK}:1166",
              by_path[ph_bwd.__name__]["train_cli_MOD_WIDE"], ph_grad_abs, wtot["bwd_ms"],
              wtot["bwd_plain_ms"], wtot["bwd_bound_ms"], (wtot["bwd_flops"], wtot["bwd_bytes"]),
              wtot["bwd_library_ms"],
              wide_per, launches_per_step=n_ph, max_rel_err=ph_grad_err,
              bound_ms_tensor_cores=wtot["bwd_bound_tc_ms"], device_ms_by_phase=ph_split["bwd"],
              launches_by_path=by_path[ph_bwd.__name__]),
        entry("fused_conv_tower", f"{CT}:174", by_path[ct_fwd.__name__][
                  "pretrain_steps_MOD_DeepSense_pallas_conv"], ct_fwd_err, mod_tot["fwd_ms"],
              mod_tot["fwd_plain_ms"], mod_tot["fwd_bound_ms"],
              (mod_tot["fwd_flops"], mod_tot["fwd_bytes"]), mod_tot["fwd_library_ms"], tower_per,
              source="focal_tpu_torch/csrc/conv_tower.cu", replaces_also=[f"{CT}:163"],
              launches_per_step=ds_per_step[ct_fwd.__name__], steps=TRAIN_STEPS,
              max_rel_err=max(g["max_rel_err_fwd"] for g in cgeos),
              bound_ms_tensor_cores=mod_tot["fwd_bound_tc_ms"],
              device_ms_by_phase=mod_tot["device_ms_by_phase"]["fwd"],
              mod_wide_step=per_wide("fwd"), launches_by_path=by_path[ct_fwd.__name__]),
        entry("fused_conv_tower_backward", f"{CT}:230", by_path[ct_bwd.__name__][
                  "pretrain_steps_MOD_DeepSense_pallas_conv"], ct_grad_abs, mod_tot["bwd_ms"],
              mod_tot["bwd_plain_ms"], mod_tot["bwd_bound_ms"],
              (mod_tot["bwd_flops"], mod_tot["bwd_bytes"]), mod_tot["bwd_library_ms"], tower_per,
              source="focal_tpu_torch/csrc/conv_tower.cu",
              replaces_also=[f"{CT}:206", f"{CT}:257"],
              launches_per_step=ds_per_step[ct_bwd.__name__], steps=TRAIN_STEPS,
              max_rel_err=ct_grad_rel, max_abs_err_near_zero=ct_grad_near,
              bound_ms_tensor_cores=mod_tot["bwd_bound_tc_ms"],
              device_ms_by_phase=mod_tot["device_ms_by_phase"]["bwd"],
              mod_wide_step=per_wide("bwd"), launches_by_path=by_path[ct_bwd.__name__]),
        entry("fused_mlp_forward", f"{PK}:527", by_path[mlp_fwd.__name__]["serve_MOD_pallas_mlp"],
              mlp_err["fwd"], mod_mlp["fwd_ms"], mod_mlp["fwd_plain_ms"], mod_mlp["fwd_bound_ms"],
              (mod_mlp["fwd_flops"], mod_mlp["fwd_bytes"]), mod_mlp["fwd_library_ms"], mlp_per,
              source=MLP_SRC, launches_per_forward=per_fwd_mlp, forwards=mlp_batches,
              **mlp_extra("fwd"), launches_by_path=by_path[mlp_fwd.__name__]),
        entry("fused_mlp_dropout_forward", f"{PK}:537", sup_mlp_launches[mlp_drop.__name__],
              mlp_err["drop"], mod_mlp["drop_ms"], mod_mlp["drop_plain_ms"], mod_mlp["fwd_bound_ms"],
              (mod_mlp["fwd_flops"], mod_mlp["fwd_bytes"]), mod_mlp["drop_library_ms"], mlp_step_per,
              source=MLP_SRC, launches_per_step=per_fwd_mlp, steps=TRAIN_STEPS,
              **mlp_extra("drop"), launches_by_path=by_path[mlp_drop.__name__]),
        entry("fused_mlp_backward", f"{PK}:590", sup_mlp_launches[mlp_bwd.__name__],
              mlp_err["bwd_abs"], mod_mlp["bwd_ms"], mod_mlp["bwd_plain_ms"], mod_mlp["bwd_bound_ms"],
              (mod_mlp["bwd_flops"], mod_mlp["bwd_bytes"]), mod_mlp["bwd_library_ms"], mlp_step_per,
              source=MLP_SRC, replaces_also=[f"{PK}:601"], launches_per_step=per_fwd_mlp,
              steps=TRAIN_STEPS, max_rel_err=mlp_err["bwd"], ms_without_masks=mod_mlp["bwd_nomask_ms"],
              **mlp_extra("bwd"), launches_by_path=by_path[mlp_bwd.__name__]),
    ]
    a_serve = atot["serve"]
    attn_step_per = (f"times: the {per_fwd} launches of one MOD training step at batch "
                     f"{TRAIN_BATCH} (views fused to {2 * TRAIN_BATCH}; dropout {rate})")

    def attn_entry(name, line, kernel, d, tot_k, per, err, **extra):
        return entry(name, f"{PK}:{line}", extra.pop("launches"), err, tot_k[f"{d}_ms"],
                     tot_k[f"{d}_plain_ms"], tot_k[f"{d}_bound_ms"],
                     (tot_k[f"{d}_flops"], tot_k[f"{d}_bytes"]), tot_k[f"{d}_library_ms"], per,
                     source=ATTN_SRC, launches_by_path=by_path[kernel.__name__], **extra)

    kernels += [
        attn_entry("fused_window_attention", 119, at_fwd, "fwd", a_serve,
                   f"times: the {per_fwd} launches of one MOD forward at batch {SERVE_BATCH}; "
                   f"launches: the -no_pallas_block served run ({attn_batches} forwards); "
                   "max_abs_err: worst over the MOD and MOD_WIDE geometries", at_err["fwd"],
                   launches=attn_serve_launches[at_fwd.__name__], launches_per_forward=per_fwd,
                   forwards=attn_batches, device_ms_in_profiled_batch=attn_serve_device_ms),
        attn_entry("fused_window_attention_dropout", 129, at_drop, "drop", a_train,
                   attn_step_per + f"; launches: {TRAIN_STEPS} timed -no_pallas_block pretrain steps",
                   at_err["drop"], launches=attn_train["launches"][at_drop.__name__],
                   launches_per_step=per_fwd, steps=TRAIN_STEPS, device_ms_in_profiled_step=
                   attn_train["attention_kernels_device_ms"]["wattn_fwd_kernel"]),
        attn_entry("fused_window_attention_backward", 189, at_bwd, "bwd", a_train,
                   attn_step_per.replace(f"dropout {rate}", "every drop rate 0")
                   + "; launches: the -no_pallas_block rate-0 step", at_err["bwd_abs"],
                   launches=attn_train["rate0_launches"][at_bwd.__name__],
                   launches_per_step=per_fwd, max_rel_err=at_err["bwd"]),
        attn_entry("fused_window_attention_dropout_backward", 200, at_drop_bwd, "drop_bwd", a_train,
                   attn_step_per + f"; launches: {TRAIN_STEPS} timed -no_pallas_block pretrain steps",
                   at_err["bwd_abs"], launches=attn_train["launches"][at_drop_bwd.__name__],
                   launches_per_step=per_fwd, steps=TRAIN_STEPS, max_rel_err=at_err["bwd"],
                   device_ms_in_profiled_step=
                   attn_train["attention_kernels_device_ms"]["wattn_bwd_kernel"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
