"""Chip smoke test of the PyTorch/CUDA port (focal_tpu_torch) on one card.

    python3 chip_smoke.py [--out DIR]

Phases (each raises on failure; the script exits non-zero and prints no
result line if any fails):
  1. print the card's name and power limit (nvidia-smi); build every kernel
     of the serving path from the sources in this checkout (nvcc, one run
     per source);
  2. kernel vs plain: fused_window_block against its plain PyTorch version
     on the card at every MOD SW_Transformer block geometry (batch 128),
     shifted and unshifted, max abs error <= 1e-4 (both full f32: the
     difference is summation order);
  3. the slice: the MOD SW_Transformer at full width (seeded random init)
     served by focal_tpu_torch.serve.Predictor over ~1,000 synthetic samples
     at batch 128 (ragged tail included): probabilities finite and summing
     to 1, the kernel launched 16 times per batch, and the first batch equal
     (atol 1e-5) to the same model run with the plain block on the card;
  4. timing with CUDA events after warm-up at each geometry: kernel, plain
     version, a library yardstick (matmul + scaled_dot_product_attention +
     matmul, never called by the port) and the bound from the geometry's
     FLOP and byte counts; plus the Predictor's windows/s and p50 batch
     latency;
  5. a torch.profiler trace of one served batch: device busy time, idle
     share, device operations and the device kernels by time.

Prints a {"kernels": [...]} line, the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}. Needs one CUDA card; imports no JAX and
nothing of the JAX package. --out DIR writes the per-geometry details and
the profile as JSON there.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SERVE_BATCH = 128
SERVE_SAMPLES = 1000
KERNEL_TOL = 1e-4
SLICE_TOL = 1e-5


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def block_geometries(cfg, batch):
    """Every distinct (modality, stage, shifted) launch of the MOD forward,
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


def work(g):
    """FLOPs and bytes of one launch: projections + attention; each input
    read once and the output written once."""
    B, N, C, H = g["windows"], g["N"], g["C"], g["heads"]
    flops = B * (8 * N * C * C + 4 * N * N * C)
    elems = 2 * B * N * C + 4 * C * C + 4 * C + H * N * N
    if g["mask"] is not None:
        elems += g["nW"] * N * N
    nbytes = 4 * elems
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return flops, nbytes, 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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


def library_block(torch, x, wqkv, bqkv, wproj, bproj, attn_mask, H):
    """Yardstick only: the same function through cuBLAS and PyTorch's
    scaled_dot_product_attention (q is pre-scaled, so scale=1)."""
    B, N, C = x.shape
    qkv = torch.matmul(x, wqkv).add_(bqkv).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
    o = torch.nn.functional.scaled_dot_product_attention(
        qkv[0], qkv[1], qkv[2], attn_mask=attn_mask, scale=1.0)
    return torch.matmul(o.transpose(1, 2).reshape(B, N, C), wproj).add_(bproj)


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

    from focal_tpu_torch.data import synthetic_arrays
    from focal_tpu_torch.models import swin as swin_mod
    from focal_tpu_torch.ops import _build
    from focal_tpu_torch.ops.pallas_kernels import fused_window_block, fused_window_block_reference
    from focal_tpu_torch.params import load_yaml
    from focal_tpu_torch.serve import Predictor

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build
    t0 = time.time()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel libraries in {time.time() - t0:.1f}s")
    for src in libs:
        with open(_build.log_path(src)) as f:
            for line in f.read().splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    log(f"[build] {src}: {line.strip()}")

    # ---- 2. kernel vs plain at every block geometry of the MOD forward
    cfg = load_yaml(os.path.join(HERE, "focal_tpu_torch", "configs", "MOD.yaml"))  # full width
    task = "vehicle_classification"
    geos = block_geometries(cfg, SERVE_BATCH)
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for g in geos:
        args = make_inputs(torch, g, gen, dev)
        y = fused_window_block(*args)
        torch.cuda.synchronize()
        ref = fused_window_block_reference(*args)
        err = float((y - ref).abs().max())
        g["max_abs_err"] = err
        max_err = max(max_err, err)
        log(f"[check] {g['name']}: windows {g['windows']} C {g['C']} nW {g['nW']} "
            f"max|kernel-plain| {err:.3e}")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{g['name']}: kernel differs from plain by {err} > {KERNEL_TOL}")
    torch.cuda.synchronize()

    # ---- 3. the slice: full-width MOD SW_Transformer served by the Predictor
    data, labels, names = synthetic_arrays(cfg, task, SERVE_SAMPLES, seed=3)
    n = len(names)
    predictor = Predictor(cfg, "SW_Transformer", task, None, batch_size=SERVE_BATCH,
                          device="cuda", seed=0)
    n_params = sum(p.numel() for p in predictor.model.parameters())
    log(f"[slice] MOD SW_Transformer, {n_params} parameters, warm-up {predictor.compile_seconds:.2f}s")
    fused_window_block.launches = 0
    result = predictor.predict(data)
    launches = fused_window_block.launches
    batches = result["latency"]["batches"]
    probs = result["probs"]
    if probs.shape != (n, cfg[task]["num_classes"]) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities: shape {probs.shape}")
    sum_err = float(np.abs(probs.sum(-1) - 1.0).max())
    if sum_err > 1e-5:
        raise AssertionError(f"probabilities do not sum to 1 (max error {sum_err})")
    if launches != 16 * batches:
        raise AssertionError(f"kernel launches {launches} != 16 x {batches} batches")
    log(f"[slice] {n} samples in {batches} batches of {SERVE_BATCH}: "
        f"kernel launches {launches} (16 per batch)")

    first = {loc: {m: a[:SERVE_BATCH] for m, a in mods.items()} for loc, mods in data.items()}
    swin_mod.fused_window_block = fused_window_block_reference  # the plain block, same model
    try:
        plain_probs = predictor._forward(first)
    finally:
        swin_mod.fused_window_block = fused_window_block
    slice_err = float(np.abs(plain_probs - probs[:SERVE_BATCH]).max())
    log(f"[slice] first batch, kernel vs plain block: max|dprobs| {slice_err:.3e}")
    if not slice_err <= SLICE_TOL:
        raise AssertionError(f"served probs differ from the plain model by {slice_err}")
    lat = result["latency"]
    log(f"[slice] p50 batch {lat['p50_s'] * 1e3:.3f} ms, mean {lat['mean_s'] * 1e3:.3f} ms, "
        f"{lat['windows_per_s']:.1f} windows/s")

    # ---- 4. timing per geometry
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "flops": 0, "bytes": 0}
    for g in geos:
        x, wqkv, bqkv, wproj, bproj, rel_bias, mask = make_inputs(torch, g, gen, dev)
        H, B = g["heads"], g["windows"]
        attn_mask = rel_bias[None].expand(B, -1, -1, -1)
        if mask is not None:
            attn_mask = attn_mask + mask[torch.arange(B, device=dev) % g["nW"]][:, None]
        attn_mask = attn_mask.contiguous()
        args = (x, wqkv, bqkv, wproj, bproj, rel_bias, mask)
        saved = fused_window_block.launches
        g["ms"] = time_ms(torch, lambda: fused_window_block(*args))
        fused_window_block.launches = saved  # timing launches are not the main path's
        g["plain_ms"] = time_ms(torch, lambda: fused_window_block_reference(*args))
        g["library_ms"] = time_ms(
            torch, lambda: library_block(torch, x, wqkv, bqkv, wproj, bproj, attn_mask, H))
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predictor._forward(first)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        predictor._forward(first)
        wall_ms = (time.time() - t0) * 1e3
    # device rows only: a CPU op's self device time repeats its kernels'
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    device_ops = sum(e.count for e in rows)
    breakdown = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_ops": device_ops, "rows": [
        {"name": e.key, "device_ms": e.self_device_time_total / 1e3, "count": e.count}
        for e in rows]}
    log(f"[profile] one batch: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}, {device_ops} device operations")
    for r in breakdown["rows"][:12]:
        log(f"[profile] {r['device_ms']:.4f} ms x{r['count']}: {r['name'][:90]}")

    if cli.out:
        os.makedirs(cli.out, exist_ok=True)
        with open(os.path.join(cli.out, "chip_smoke.json"), "w") as f:
            json.dump({
                "card": card,
                "geometries": [{k: v for k, v in g.items() if k != "mask"} for g in geos],
                "per_forward": tot, "latency": lat, "launches": launches,
                "slice_err": slice_err, "profile": breakdown,
            }, f, indent=1)

    kernels = [{
        "name": "fused_window_block",
        "route": "cuda",
        "source": "focal_tpu_torch/csrc/window_block.cu",
        "replaces": "focal_tpu/ops/pallas_kernels.py:949",
        "launches": launches,  # the whole served run
        "launches_per_forward": launches // batches,
        "forwards": batches,
        "max_abs_err": max_err,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if tot["flops"] / F32_FLOPS >= tot["bytes"] / HBM_BYTES_PER_S else "bytes",
        "library_ms": tot["library_ms"],
        "per": f"times: one forward at batch {SERVE_BATCH}, 16 launches over {len(geos)} "
               f"geometries; launches: all {batches} forwards of the served run",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
