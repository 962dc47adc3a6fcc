"""Time the window-block training kernels (#2, #3) and the attention-only
kernels (#6-#9) of one or more checkouts of the repository on one card, so
that two commits can be compared within one call.

    python3 compare_kernels.py [--profile] DIR [DIR ...]

Each DIR holds a focal_tpu_torch/ package (for example the parent commit
unpacked with git archive); each is built and timed in a process of its
own, in the order given, so run them as parent, change, change, parent.
Per DIR it prints, from chip_smoke.py's helpers (CUDA events after
warm-up): #2 and #3 summed over one MOD pretrain step (batch 256, views
fused to 512) and over MOD_WIDE stage 0's launches (batch 64 fused to
128), and #6-#9 over one MOD step's 16 launches. With --profile, #2 and #3
are also split by kernel name (chip_smoke.profile_split; the DIR's
window_block.cu must have the kernels chip_smoke.py knows). Needs a CUDA
card; imports no JAX.
"""

import importlib.util
import os
import subprocess
import sys

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
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml

    if not os.path.abspath(pk.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {pk.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rate = 0.2
    for dataset, batch in (("MOD", 512), ("MOD_WIDE", 128)):
        cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", f"{dataset}.yaml"))
        geos = [g for g in cs.block_geometries(cfg, batch)
                if pk.wblock_fits(g["N"], g["C"], g["heads"])]
        tot = {"#2": 0.0, "#3": 0.0}
        for g in geos:
            args = cs.make_inputs(torch, g, gen, dev)
            tr = cs.transposed(args)
            dy = torch.randn(args[0].shape, generator=gen).to(dev)
            _, keep = pk.fused_window_block_dropout(*args, 7, rate)
            tot["#2"] += g["per_forward"] * cs.time_ms(
                torch, lambda: pk.fused_window_block_dropout(*args, 7, rate))
            tot["#3"] += g["per_forward"] * cs.time_ms(
                torch, lambda: pk.fused_window_block_backward(*args, dy, keep, rate, *tr))
            del args, tr, dy, keep
        print(f"[{root}] {dataset} (#2/#3 geometries, batch {batch}): one step: #2 "
              f"{tot['#2']:.3f} ms, #3 {tot['#3']:.3f} ms", flush=True)
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
