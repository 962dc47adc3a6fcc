"""Time the window-block training kernels (#2-#5), the attention-only
kernels (#6-#9), the fused MLP kernels (#10-#12) and the conv-tower kernels
(#13, #14) of one or more checkouts of the repository on one card, so that
two commits can be compared within one call.

    python3 compare_kernels.py [--profile] DIR [DIR ...]

Each DIR holds a focal_tpu_torch/ package (for example the parent commit
unpacked with git archive); each is built and timed in a process of its
own, in the order given, so run them as parent, change, change, parent.
Per DIR it prints, from chip_smoke.py's helpers (CUDA events after
warm-up): #2 and #3 summed over one MOD pretrain step (batch 256, views
fused to 512) and over MOD_WIDE stage 0's launches (batch 64 fused to
128), #4 and #5 over MOD_WIDE's per-head launches of that step, #6-#9 over
one MOD step's 16 launches, and #10, #11 and #12 at every MLP geometry and
summed over one MOD forward's 16 MLPs (batch 128) and MOD_WIDE stage 0's 4
(batch 128), and the -pallas_mlp MOD supervised step (chip_smoke's phase
19: 3 + 20 steps at batch 128; p50, idle share, device busy time, peak
memory), and #13 and #14 at every tower geometry and summed over one MOD
and one MOD_WIDE DeepSense step (CUDA events, device time by kernel from
five profiled calls, the host's enqueue time a call, the cuDNN chain's
forward) with the -pallas_conv MOD_WIDE DeepSense step (3 + 10 steps at
batch 128; p50, idle share, device busy, peak memory). With --profile, #2
and #3 are also split by kernel name (chip_smoke.profile_split; the DIR's
window_block.cu must have the kernels chip_smoke.py knows). Needs a CUDA
card; imports no JAX.
"""

import importlib.util
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def measure(root, profile):
    """Build and time the package under ``root`` (run in a child process)."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from focal_tpu_torch.ops import _build
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml, parse_train_params

    if not os.path.abspath(pk.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {pk.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 yardsticks, as chip_smoke.py sets them
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rate = 0.2
    pairs = {("#2", "#3"): (pk.fused_window_block_dropout, pk.fused_window_block_backward),
             ("#4", "#5"): (pk.fused_window_block_perhead, pk.fused_window_block_perhead_backward)}
    for dataset, batch in (("MOD", 512), ("MOD_WIDE", 128)):
        cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", f"{dataset}.yaml"))
        every = cs.block_geometries(cfg, batch)
        for names, (fwd, bwd) in pairs.items():
            mono = names == ("#2", "#3")
            geos = [g for g in every if pk.wblock_fits(g["N"], g["C"], g["heads"]) == mono]
            if not geos:
                continue
            tot = dict.fromkeys(names, 0.0)
            for g in geos:
                args = cs.make_inputs(torch, g, gen, dev)
                tr = cs.transposed(args)
                dy = torch.randn(args[0].shape, generator=gen).to(dev)
                _, keep = fwd(*args, 7, rate)
                tot[names[0]] += g["per_forward"] * cs.time_ms(torch, lambda: fwd(*args, 7, rate))
                tot[names[1]] += g["per_forward"] * cs.time_ms(
                    torch, lambda: bwd(*args, dy, keep, rate, *tr))
                del args, tr, dy, keep
            print(f"[{root}] {dataset} ({'/'.join(names)} geometries, batch {batch}): one step: "
                  + ", ".join(f"{k} {ms:.3f} ms" for k, ms in tot.items()), flush=True)
        geos = [g for g in every if pk.wblock_fits(g["N"], g["C"], g["heads"])]
        if profile:
            cs.profile_split(torch, pk.fused_window_block_dropout, pk.fused_window_block_backward,
                             ("#2", "#3"), geos, gen, dev, rate, f"profile-{dataset}")
        torch.cuda.empty_cache()
    cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", "MOD.yaml"))
    tot = {"#6": 0.0, "#7": 0.0, "#8": 0.0, "#9": 0.0}
    for i, g in enumerate(cs.attention_geometries(cfg, 512, "MOD")):
        q, k, v, rb, mask, gy = cs.attention_inputs(torch, np, g, i, dev)
        runs = {"#6": lambda: pk.fused_window_attention(q, k, v, rb, mask),
                "#7": lambda: pk.fused_window_attention_dropout(q, k, v, rb, mask, 3, rate),
                "#8": lambda: pk.fused_window_attention_backward(q, k, v, rb, mask, gy),
                "#9": lambda: pk.fused_window_attention_dropout_backward(q, k, v, rb, mask, gy,
                                                                         3, rate)}
        for key, fn in runs.items():
            tot[key] += g["per_forward"] * cs.time_ms(torch, fn)
    print(f"[{root}] MOD one step (16 launches each): "
          + ", ".join(f"{key} {ms:.3f} ms" for key, ms in tot.items()), flush=True)
    torch.cuda.empty_cache()
    for dataset in ("MOD", "MOD_WIDE"):
        cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", f"{dataset}.yaml"))
        tot = {"#10": 0.0, "#11": 0.0, "#12": 0.0}
        for i, g in enumerate(cs.mlp_geometries(cfg, 128, dataset)):
            x, w1, b1, w2, b2, gy = cs.mlp_inputs(torch, np, g, 500 + i, dev)
            w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
            runs = {"#10": lambda: fm.fused_mlp_forward(x, w1, b1, w2, b2),
                    "#11": lambda: fm.fused_mlp_dropout_forward(x, w1, b1, w2, b2, 7, rate),
                    "#12": lambda: fm.fused_mlp_backward(x, w1, b1, w1t, w2t, gy, 7, rate)}
            ms = {key: cs.time_ms(torch, fn) for key, fn in runs.items()}
            for key in tot:
                tot[key] += g["per_forward"] * ms[key]
            print(f"[{root}] {g['name']} (T {g['T']}, C {g['C']}, {g['per_forward']} a forward): "
                  + ", ".join(f"{key} {v:.4f} ms" for key, v in ms.items()), flush=True)
            del x, w1, b1, w2, b2, gy, w1t, w2t, runs
        print(f"[{root}] {dataset} MLPs of one forward at batch 128: "
              + ", ".join(f"{key} {v:.3f} ms" for key, v in tot.items()), flush=True)
        torch.cuda.empty_cache()
    measure_towers(cs, torch, np, root, dev, load_yaml)
    step = (pk.fused_window_block_dropout, pk.fused_window_block_backward,
            fm.fused_mlp_dropout_forward, fm.fused_mlp_backward)
    sargs = parse_train_params(["-dataset", "MOD", "-model", "SW_Transformer", "-learn_framework",
                                "no", "-batch_size", "128", "-pallas_mlp"])
    run = cs.run_supervised_steps(torch, np, sargs, 128, cs.TRAIN_WARMUP, cs.TRAIN_STEPS, step,
                                  {k.__name__: 16 for k in step}, dev, "supervised-pallas-mlp")
    print(f"[{root}] MOD supervised step with -pallas_mlp (batch 128): p50 {run['p50_ms']:.3f} ms, "
          f"idle share {run['idle_share']:.3f}, device busy {run['profile']['device_busy_ms']:.3f} "
          f"ms, peak {run['peak_mb']:.1f} MiB", flush=True)


def measure_towers(cs, torch, np, root, dev, load_yaml):
    """#13 and #14 per tower geometry and summed over one MOD and one
    MOD_WIDE DeepSense step (chip_smoke's phase-17 inputs): CUDA-event ms,
    device ms a call by kernel (five profiled calls), the host's ms to
    enqueue a call, and the f32 cuDNN chain's forward (the yardstick); then the
    -pallas_conv MOD_WIDE DeepSense step (3 + 10 steps at batch 128)."""
    import torch.nn.functional as F

    from focal_tpu_torch.ops import conv_tower as ct
    from focal_tpu_torch.params import parse_train_params

    for dataset, samples in (("MOD", 2 * cs.DS_BATCH), ("MOD_WIDE", 2 * cs.DS_WIDE_BATCH)):
        cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", f"{dataset}.yaml"))
        tot = {}
        for i, g in enumerate(cs.tower_geometries(cfg, samples, dataset)):
            x0, params, masks, dy = cs.tower_inputs(torch, np, g, 200 + i, dev)
            _, _, _, saved = ct.tower_forward(x0, g["cfgs"], *params, masks, g["external"])
            runs = {"#13": lambda: ct.tower_forward(x0, g["cfgs"], *params, masks, g["external"]),
                    "#14": lambda: ct.fused_conv_tower_backward(saved, dy)}
            ms = {}
            for key, fn in runs.items():
                ms[key] = cs.time_ms(torch, fn)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    fn()
                ms[f"{key} host"] = (time.perf_counter() - t0) * 1e3 / 20
                torch.cuda.synchronize()
                split = cs.tower_phase_split(torch, fn, strict=False)
                ms[f"{key} device"] = split["device_ms"]
                print(f"[{root}] {g['name']} {key} device ms by phase: "
                      + ", ".join(f"{ph} {v:.4f}" for ph, v in sorted(split["phases"].items(),
                                                                      key=lambda kv: -kv[1])),
                      flush=True)
            with torch.no_grad():
                ms["cuDNN fwd"] = cs.time_ms(torch, lambda: cs.library_tower(torch, F, x0, g,
                                                                              params, masks))
            for key, v in ms.items():
                tot[key] = tot.get(key, 0.0) + v
            print(f"[{root}] {g['name']} (R {g['R']}, S {g['S']}, C {g['C']}): "
                  + ", ".join(f"{key} {v:.4f} ms" for key, v in ms.items()), flush=True)
            del x0, params, masks, dy, saved, runs
        print(f"[{root}] {dataset} one DeepSense step's towers: "
              + ", ".join(f"{key} {v:.3f} ms" for key, v in tot.items()), flush=True)
        torch.cuda.empty_cache()
    targs = parse_train_params(["-dataset", "MOD_WIDE", "-model", "DeepSense", "-learn_framework",
                                "FOCAL", "-stage", "pretrain", "-batch_size",
                                str(cs.DS_WIDE_BATCH), "-pallas_conv"])
    kernels = (ct.fused_conv_tower, ct.fused_conv_tower_backward)
    run, model = cs.run_deepsense_steps(torch, np, targs, cs.DS_WIDE_BATCH, cs.TRAIN_WARMUP,
                                        cs.WIDE_STEPS, kernels, {k.__name__: n for k, n in
                                                                 zip(kernels, (11, 20))},
                                        dev, "deepsense-pallas-wide")
    print(f"[{root}] MOD_WIDE DeepSense step with -pallas_conv (batch {cs.DS_WIDE_BATCH}): p50 "
          f"{run['p50_ms']:.3f} ms, idle share {run['idle_share']:.3f}, device busy "
          f"{run['device_busy_ms']:.3f} ms, peak {run['peak_mb']:.1f} MiB", flush=True)
    del model
    torch.cuda.empty_cache()


def main():
    argv = sys.argv[1:]
    if argv[:1] == ["--child"]:
        measure(os.path.abspath(argv[1]), "--profile" in argv[2:])
        return
    profile = "--profile" in argv
    dirs = [a for a in argv if a != "--profile"]
    if not dirs:
        sys.exit(__doc__)
    for d in dirs:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", d] + (["--profile"] if profile else [])
        subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
