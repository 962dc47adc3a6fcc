"""What the bf16 wgmma kernels compile to and how they run, for one or more
checkouts of the repository on one card: the fused MLP's (#10-bf16 to
#12-bf16, csrc/fused_mlp.cu), the whole-block kernels' (the forward
#1-, #2- and #4-bf16, the backward #3-bf16 and #5-bf16,
csrc/window_block.cu) and the conv tower's (#13-bf16, #14-bf16,
csrc/conv_tower.cu: its build report alone; compare_kernels.py --parts
towers_bf16 checks and times them), all on csrc/gemm_wgmma.cuh, and the
attention-only kernels' (#6-bf16 to #9-bf16, csrc/window_attention.cu, on
mma.sync: its build report alone; compare_kernels.py --parts
attention_bf16 times them).

    python3 diagnose_mlp.py [--bench] DIR [DIR ...]

Each DIR holds a focal_tpu_torch/ package (this checkout is ".", a variant
a copy under build/ with its sources edited, the parent commit one
unpacked with git archive); each is built and run in a process of its own.
Per DIR and source it prints:
  * the build's ptxas lines that say a wgmma pipeline was serialized
    (C7510-C7518, C7520; the C7519 notes are harmless) and the bf16
    kernels that spill, with their registers;
  * each bf16 kernel's count of HGMMA (wgmma) and HMMA (mma.sync)
    instructions in the compiled SASS (cuobjdump);
  * #10-bf16, #11-bf16 (masks of mlp_keep_masks) and #12-bf16 (with the
    masks and without) against their bf16 plain versions at WIDTHS: the
    worst error relative to max|plain| of y and of each gradient, and
    whether a second call gives the same bits;
  * #2-bf16 and #3-bf16 (#4-bf16 and #5-bf16 at the widths wblock_fits
    sends to them) with a keep mask and without against
    fused_window_block_bf16_reference and
    fused_window_block_backward_bf16_reference at
    BLOCKS (MOD's and MOD_WIDE's widths, ragged rows, the shifted-window
    mask, other N, a head width not a multiple of 4, and the widest head
    the bf16 gate admits): y's and each gradient's error relative to
    max|plain|, whether a second call gives the same bits, and the
    digests of y and the keep mask and of the gradients (two checkouts with
    equal digests give the same bits);
  * with --bench, each MLP kernel's device time a call (a profile over at
    least chip_smoke.PROFILE_TRACE_MS of calls) at every MLP geometry of a
    MOD and a MOD_WIDE forward at batch 128 beside the bf16 library chain's
    (addmm -> GELU -> addmm and its autograd backward), and their sums over
    each forward, and the bf16 whole-block kernels' device time by kernel
    over a served MOD forward (#1-bf16), a MOD step (#2-bf16, #3-bf16) and
    a MOD_WIDE step (#4-bf16, #5-bf16) (compare_kernels.py --parts
    window_bf16 times them by events and by phase).
Needs a CUDA card; imports no JAX.
"""

import importlib.util
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# (T, C, H): MOD's widths, MOD_WIDE's stage 0, C > 256 (the forward's
# two-launch form), H = 2C, C 8 and T not a multiple of the 128-row tiles
WIDTHS = [(2311, 64, 256), (1170, 128, 512), (301, 256, 1024), (517, 320, 1280),
          (777, 96, 192), (200, 8, 32), (3000, 256, 512), (73728, 256, 1024), (999, 192, 768)]
# (windows, N, C, H, nW or 0 for no mask): MOD's widths (C 64, 128, 256 at
# hd 16, 32, 64) with and without the shifted-window mask, rows not a
# multiple of 128, MOD_WIDE's per-head widths (#5-bf16: C 512 and 1024), N
# other than 9, a head of 5 columns, and one head of 1,600 columns (the
# widest the bf16 gate admits at N = 9: one slot of the ring)
BLOCKS = [(256, 9, 64, 4, 32), (131, 9, 128, 4, 0), (67, 9, 256, 4, 2), (40, 9, 512, 4, 8),
          (13, 9, 1024, 4, 0), (50, 16, 64, 2, 5), (77, 4, 96, 8, 0), (21, 9, 40, 8, 3),
          (3, 9, 1600, 1, 0)]
# the bf16 kernels' names in each source's build
BF16_KERNELS = {"fused_mlp.cu": ("wg_", "wcast"),
                "window_block.cu": ("wb_wg_", "wg_wgrad", "wg_reduce", "attn_bwd_bf16",
                                    "attn_fwd_bf16"),
                "conv_tower.cu": ("ct_wg_", "wg_reduce", "_sliced_", "bn_dc_sums"),
                "window_attention.cu": ("wattn_bf16_", "wattn_fwd_bf16", "wattn_bwd_bf16")}
RATE = 0.2


def build_report(build, source="fused_mlp.cu"):
    """The build's serialization lines and spills, and SASS instruction
    counts, of ``source``'s bf16 kernels."""
    print(f"  {source}:", flush=True)
    ours = lambda name: any(k in name for k in BF16_KERNELS[source])
    log = open(build.log_path(source)).read()
    short = lambda name: re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}\d*", "", name)[:60]
    for line in log.splitlines():
        m = re.search(r"\((C75\d\d)\).*function '(\S+)'", line)
        if m and m.group(1) != "C7519":
            print(f"  serialized ({m.group(1)}): {short(m.group(2))}", flush=True)
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        elif cur and ours(cur):
            if "spill stores" in line and not line.strip().startswith("0 bytes stack"):
                print(f"  spills: {short(cur)}: {line.strip()}", flush=True)
    tool = os.path.join(os.path.dirname(os.path.dirname(build.find_nvcc())), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.library_path(source)],
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0]
        elif fn:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += bool(re.search(r"\bHMMA\b", line))
    for name, (hg, hm) in sorted(counts.items()):
        if ours(name):
            print(f"  sass {short(name)}: HGMMA {hg}, HMMA {hm}", flush=True)


def check(torch, np, fm, dev):
    """The bf16 kernels against their plain versions at WIDTHS."""
    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    for T, C, H in WIDTHS:
        rng = np.random.default_rng(T + C)
        mk = lambda s, k: torch.from_numpy((rng.normal(size=s) * k).astype(np.float32)).to(dev)
        x, w1, b1 = mk((T, C), 1.0).to(torch.bfloat16), mk((C, H), C**-0.5), mk((H,), 0.1)
        w2, b2, g = mk((H, C), H**-0.5), mk((C,), 0.1), mk((T, C), 1.0).to(torch.bfloat16)
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
        keep1, keep2 = fm.mlp_keep_masks(9, T, C, H, RATE, dev)
        y = [fm.fused_mlp_forward_bf16(x, w1, b1, w2, b2) for _ in range(2)]
        yd = [fm.fused_mlp_dropout_forward_bf16(x, w1, b1, w2, b2, 9, RATE) for _ in range(2)]
        same = torch.equal(*y) and torch.equal(*yd)
        out = [f"fwd {rel(y[0], fm.fused_mlp_bf16_reference(x, w1, b1, w2, b2)):.2e}",
               f"drop {rel(yd[0], fm.fused_mlp_bf16_reference(x, w1, b1, w2, b2, keep1, keep2, RATE)):.2e}"]
        for seed, masks in ((None, ()), (9, (keep1, keep2, RATE))):
            got = [fm.fused_mlp_backward_bf16(x, w1, b1, w1t, w2t, g, seed, RATE) for _ in range(2)]
            same = same and all(torch.equal(a, b) for a, b in zip(*got))
            want = fm.fused_mlp_backward_bf16_reference(x, w1, b1, w2, b2, g, *masks)
            out.append(("bwd-masks " if masks else "bwd ") + " ".join(
                f"{n} {rel(a, b):.2e}" for n, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"),
                                                          got[0], want)))
        torch.cuda.synchronize()
        print(f"  T {T} C {C} H {H}: " + "; ".join(out) + f"; same bits again: {same}", flush=True)


def check_blocks(cs, torch, np, pk, dev):
    """#2-bf16 and #3-bf16 (#4-bf16 and #5-bf16) against the bf16 plain
    versions at BLOCKS, the backward fed the forward's own keep mask."""
    names = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias")
    for B, N, C, H, nW in BLOCKS:
        rng = np.random.default_rng(B + N + C)
        mk = lambda s, k: torch.from_numpy((rng.normal(size=s) * k).astype(np.float32)).to(dev)
        bf = torch.bfloat16
        x, wqkv, bqkv = mk((B, N, C), 1.0).to(bf), mk((C, 3 * C), C**-0.5).to(bf), mk((3 * C,), 0.1)
        wproj, bproj = mk((C, C), C**-0.5).to(bf), mk((C,), 0.1)
        rel_bias, dy = mk((H, N, N), 0.02), mk((B, N, C), 1.0).to(bf)
        mask = (torch.from_numpy(np.where(rng.random((nW, N, N)) < 0.3, -100.0, 0.0)
                                 .astype(np.float32)).to(dev) if nW else None)
        args = (x, wqkv, bqkv, wproj, bproj, rel_bias, mask)
        mono = pk.wblock_fits(N, C, H)
        fwd = pk.fused_window_block_dropout_bf16 if mono else pk.fused_window_block_perhead_bf16
        bwd = (pk.fused_window_block_backward_bf16 if mono
               else pk.fused_window_block_perhead_backward_bf16)
        ys = [fwd(*args, 7, RATE) for _ in range(2)]
        keep = ys[0][1]
        same = torch.equal(ys[0][0], ys[1][0]) and torch.equal(keep, ys[1][1])
        bits = [digest(ys[0])]
        ref = pk.fused_window_block_bf16_reference(*args, keep, RATE)
        out = [f"y {float((ys[0][0].float() - ref.float()).abs().max() / ref.float().abs().max()):.2e}"
               f" (gate {cs.BF16_FWD_TOL:.0e})"]
        for tag, kp in (("keep", keep), ("no keep", None)):
            got = [bwd(*args, dy, kp, RATE) for _ in range(2)]
            same = same and all(torch.equal(a, b) for a, b in zip(*got))
            bits.append(digest(got[0]))
            want = pk.fused_window_block_backward_bf16_reference(*args, dy, kp, RATE)
            errs = {n: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp_min(1e-30))
                    for n, a, b in zip(names, got[0], want)}
            out.append(f"{tag}: " + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
                       + f" (gate {cs.BF16_GRAD_TOL:.0e} by chip_smoke.bf16_grad_err: "
                       f"{cs.bf16_grad_err(got[0], want):.2e})")
        torch.cuda.synchronize()
        print(f"  windows {B} N {N} C {C} H {H} nW {nW} ({fwd.__name__}, {bwd.__name__}): "
              + "; ".join(out)
              + f"; same bits again: {same}; digests {' '.join(bits)}", flush=True)


def digest(tensors):
    """sha-256 (first 16 hex digits) of tensors' bytes: equal digests from
    two checkouts are the same bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def bench_blocks(cs, torch, pk, root, dev):
    """Device ms by kernel of the bf16 whole-block kernels (a profile over at
    least chip_smoke.PROFILE_TRACE_MS of calls a geometry): #1-bf16 over a
    served MOD forward (batch 128), #2-bf16 and #3-bf16 over a MOD step's
    whole-block geometries (batch 512), #4-bf16 and #5-bf16 over a MOD_WIDE
    step's per-head ones (batch 128), on chip_smoke.bf16_inputs."""
    from focal_tpu_torch.params import load_yaml

    gen = torch.Generator().manual_seed(0)

    def by_kernel(fn, per, into):
        reps = cs.trace_reps(torch, fn)

        def calls():
            time.sleep(0.05)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)

        for r in cs.profile_device(torch, calls)["rows"]:
            name = cs.kernel_name(r["name"]) or r["name"][:30]
            into[name] = into.get(name, 0.0) + per * r["device_ms"] / reps

    for label, dataset, batch, pick in (("served MOD #1-bf16", "MOD", cs.SERVE_BATCH, "serve"),
                                        ("MOD step #2-bf16/#3-bf16", "MOD", 512, "mono"),
                                        ("MOD_WIDE step #4-bf16/#5-bf16", "MOD_WIDE", 128,
                                         "perhead")):
        cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", f"{dataset}.yaml"))
        fwd, bwd = {}, {}
        for g in cs.block_geometries(cfg, batch):
            mono = pk.wblock_fits(g["N"], g["C"], g["heads"])
            if (pick == "mono" and not mono) or (pick == "perhead" and mono):
                continue
            args = cs.bf16_inputs(torch, g, gen, dev)
            if pick == "serve":
                by_kernel(lambda: pk.fused_window_block_bf16(*args), g["per_forward"], fwd)
            else:
                f = pk.fused_window_block_dropout_bf16 if mono else pk.fused_window_block_perhead_bf16
                b = (pk.fused_window_block_backward_bf16 if mono
                     else pk.fused_window_block_perhead_backward_bf16)
                dy = torch.randn(args[0].shape, generator=gen).to(dev).to(torch.bfloat16)
                _, keep = f(*args, 7, RATE)
                by_kernel(lambda: f(*args, 7, RATE), g["per_forward"], fwd)
                by_kernel(lambda: b(*args, dy, keep, RATE), g["per_forward"], bwd)
            del args
        for d, ks in (("forward", fwd), ("backward", bwd)):
            if ks:
                print(f"  {label}, {d} (device ms by kernel): {sum(ks.values()):.3f}: "
                      + ", ".join(f"{k} {v:.3f}" for k, v in sorted(ks.items(),
                                                                    key=lambda kv: -kv[1])),
                      flush=True)
        torch.cuda.empty_cache()


def bench(cs, torch, np, fm, root, dev):
    """Device time a call per MLP geometry beside the bf16 library chain."""
    import torch.nn.functional as F

    from focal_tpu_torch.params import load_yaml

    for dataset in ("MOD", "MOD_WIDE"):
        cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", f"{dataset}.yaml"))
        tot = {}
        for i, g in enumerate(cs.mlp_geometries(cfg, 128, dataset)):
            x, w1, b1, w2, b2, gy = cs.mlp_bf16_inputs(torch, np, g, 500 + i, dev)
            w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
            lw = [t.to(torch.bfloat16) for t in (w1, b1, w2, b2)]
            leaves = [t.clone().requires_grad_(True) for t in [x] + lw]
            ly = cs.library_mlp(torch, F, *leaves, RATE)
            runs = {"#10-bf16": lambda: fm.fused_mlp_forward_bf16(x, w1, b1, w2, b2),
                    "#11-bf16": lambda: fm.fused_mlp_dropout_forward_bf16(x, w1, b1, w2, b2, 7,
                                                                          RATE),
                    "#12-bf16": lambda: fm.fused_mlp_backward_bf16(x, w1, b1, w1t, w2t, gy, 7,
                                                                   RATE),
                    "library fwd": lambda: cs.library_mlp(torch, F, x, *lw),
                    "library bwd": lambda: torch.autograd.grad(ly, leaves, gy, retain_graph=True)}
            ms = {}
            for key, fn in runs.items():
                with torch.no_grad() if key != "library bwd" else torch.enable_grad():
                    ms[key] = cs.device_ms_per_call(torch, fn)
                tot[key] = tot.get(key, 0.0) + g["per_forward"] * ms[key]
            print(f"  {g['name']} (T {g['T']}, C {g['C']}, {g['per_forward']} a forward): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
            del x, w1, b1, w2, b2, gy, w1t, w2t, lw, leaves, ly, runs
        print(f"  {dataset}, the MLPs of one forward at batch 128 (device ms): "
              + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()), flush=True)
        torch.cuda.empty_cache()


def child(root, with_bench):
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from focal_tpu_torch.ops import _build
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk

    if not os.path.abspath(fm.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {fm.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("diagnose_mlp.py needs a CUDA card")
    print(f"[{root}]", flush=True)
    _build.build_all(tuple(BF16_KERNELS))
    for source in BF16_KERNELS:
        build_report(_build, source)
    dev = torch.device("cuda")
    check(torch, np, fm, dev)
    check_blocks(cs, torch, np, pk, dev)
    if with_bench:
        bench(cs, torch, np, fm, root, dev)
        bench_blocks(cs, torch, pk, root, dev)


def main():
    argv = sys.argv[1:]
    if argv[:1] == ["--child"]:
        child(os.path.abspath(argv[1]), argv[2] == "1")
        return
    with_bench = "--bench" in argv
    dirs = [a for a in argv if a != "--bench"]
    if not dirs:
        sys.exit(__doc__)
    for d in dirs:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", d,
                        "1" if with_bench else "0"], check=True)


if __name__ == "__main__":
    main()
