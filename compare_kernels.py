"""Time the window-block training kernels (#2-#5), the attention-only
kernels (#6-#9), the fused MLP kernels (#10-#12) and the conv-tower kernels
(#13, #14) of one or more checkouts of the repository on one card, so that
two commits can be compared within one call.

    python3 compare_kernels.py [--profile] [--parts P,...] DIR [DIR ...]

Each DIR holds a focal_tpu_torch/ package (for example the parent commit
unpacked with git archive); each is built and timed in a process of its
own, in the order given, so run them as parent, change, change, parent.
Per DIR it prints, from chip_smoke.py's helpers (CUDA events after
warm-up): #2 and #3 summed over one MOD pretrain step (batch 256, views
fused to 512) and over MOD_WIDE stage 0's launches (batch 64 fused to
128), #4 and #5 over MOD_WIDE's per-head launches of that step, #6-#9 over
one MOD step's 16 launches (#6 also over a served MOD forward's), and #10,
#11 and #12 at every MLP geometry and summed over one MOD forward's 16 MLPs (batch 128) and MOD_WIDE stage 0's 4
(batch 128), and the -pallas_mlp MOD supervised step (chip_smoke's phase
19: 3 + 20 steps at batch 128; p50, idle share, device busy time, peak
memory), and #13 and #14 at every tower geometry and summed over one MOD
and one MOD_WIDE DeepSense step (CUDA events, device time by kernel from
five profiled calls, the host's enqueue time a call, the cuDNN chain's
forward) with the -pallas_conv MOD_WIDE DeepSense step (3 + 10 steps at
batch 128; p50, idle share, device busy, peak memory). #1 is summed over
one served MOD forward (batch 128), and #1 and #6-#9 are timed over at
least 20 ms of calls each, #6-#9 also by their device time in a profile
and by the host's time to enqueue a call; the -no_pallas_block MOD
pretrain step (3 + 20 steps at batch 256) gives its p50, peak memory, a
profiled step's device busy time, #7's and #9's device time and that of
the copy and concatenation kernels and of PyTorch's elementwise kernels.
With --profile, #2 and #3 are also split by kernel name
(chip_smoke.profile_split; the DIR's window_block.cu must have the kernels
chip_smoke.py knows). --parts takes a comma list of window (#1-#5),
window_bf16 (#1-bf16 to #5-bf16 by events, device time and device time by
phase, #3-bf16's and #5-bf16's host enqueue, and the bf16 MOD pretrain
step), attention (#6-#9 and the -no_pallas_block step), attention_bf16
(#6-bf16 to #9-bf16 at every MOD geometry and summed over a served MOD
forward, #6-bf16, and a MOD step, #7-bf16 to #9-bf16, by device time and
events beside the bound, the f32 #6-#9 by device time at the same
geometries; the build's spills and HMMA counts of the bf16 kernels; and
digests of the outputs of the f32 #6-#9, #1-#5 and #1-#5-bf16, the same
bits giving the same digests on two checkouts; it builds only
window_attention.cu and window_block.cu), mlp (#10-#12 and the
-pallas_mlp step), mlp_bf16 (#10-bf16 to #12-bf16 per MLP geometry of a
MOD and a MOD_WIDE forward by events and device time beside the bf16
library chain, and the bf16 -pallas_mlp MOD supervised step), towers
(#13, #14 and their step) and towers_bf16 (#13-bf16 and #14-bf16 at every
tower geometry of one MOD and one MOD_WIDE DeepSense step, chip_smoke's
phase-30 inputs, and summed over each step by the towers that run them:
device ms a call with its split by phase and by kernel, CUDA-event ms, the
host's median ms to enqueue a call, the cuDNN bf16 chain forward and
backward, and the bound; then the other recipes' towers and the
two-location mod_extractor's, by device time); all by default.
Needs a CUDA card; imports no JAX.
"""

import importlib.util
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PARTS = ("window", "window_bf16", "attention", "attention_bf16", "mlp", "mlp_bf16", "towers",
         "towers_bf16")
# the sources a part builds (all by default)
PART_SOURCES = {"attention_bf16": ("window_attention.cu", "window_block.cu")}


def measure(root, profile, parts):
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
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 yardsticks, as chip_smoke.py sets them
    torch.backends.cudnn.allow_tf32 = False
    sources = set()
    for part in parts:
        sources |= set(PART_SOURCES.get(part, _build.SOURCES))
    _build.build_all(tuple(sorted(sources)))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rate = 0.2
    if "window" in parts:
        measure_window(cs, torch, root, dev, gen, rate, profile)
    if "window_bf16" in parts:
        measure_window_bf16(cs, torch, root, dev, gen, rate)
    if "attention" in parts:
        measure_attention(cs, torch, np, root, dev, rate)
    if "attention_bf16" in parts:
        measure_attention_bf16(cs, torch, np, root, dev, rate)
    if "mlp" in parts:
        measure_mlp(cs, torch, np, root, dev, rate)
    if "mlp_bf16" in parts:
        measure_mlp_bf16(cs, torch, np, root, dev, rate)
    if "towers" in parts:
        measure_towers(cs, torch, np, root, dev, load_yaml)
    if "towers_bf16" in parts:
        measure_towers_bf16(cs, torch, np, root, dev, load_yaml)


def measure_window(cs, torch, root, dev, gen, rate, profile):
    """#1 over one served MOD forward; #2/#3 and #4/#5 over a MOD and a
    MOD_WIDE step."""
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml

    cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", "MOD.yaml"))
    total = device = 0.0
    for g in cs.block_geometries(cfg, cs.SERVE_BATCH):
        args = cs.make_inputs(torch, g, gen, dev)
        total += g["per_forward"] * cs.time_ms_long(torch, lambda: pk.fused_window_block(*args))
        device += g["per_forward"] * cs.device_ms_per_call(torch, lambda: pk.fused_window_block(*args))
        del args
    print(f"[{root}] MOD one served forward at batch {cs.SERVE_BATCH} (16 launches): #1 "
          f"{total:.3f} ms (device {device:.3f})", flush=True)
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


# the phase of each kernel the bf16 whole-block kernels (#1- to #5-bf16)
# run, under the names of this tree's csrc/window_block.cu and of its
# parent's (the forward's products on mma.sync, its attention without the
# ring)
BF16_PHASES = {"wb_wg_qkvg_kernel": "products", "wb_wg_y_kernel": "products",
               "wb_wg_dx_kernel": "products", "attn_fwd_bf16_kernel": "attention",
               "attn_bwd_bf16_kernel": "attention", "wg_wgrad_kernel": "weight gradients",
               "wg_reduce_kernel": "reductions", "bf16_proj_kernel": "products",
               "attn_fwd_kernel": "attention"}


def phases_of(cs, torch, fn):
    """Device ms a call of fn by BF16_PHASES' phase, over a profile of at
    least chip_smoke.PROFILE_TRACE_MS of calls; a kernel the map does not
    name is reported under its own name."""
    reps = cs.trace_reps(torch, fn)

    def calls():
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)

    out = {}
    for r in cs.profile_device(torch, calls)["rows"]:
        name = cs.kernel_name(r["name"]) or r["name"][:40]
        phase = BF16_PHASES.get(name, name)
        out[phase] = out.get(phase, 0.0) + r["device_ms"] / reps
    return out


def measure_window_bf16(cs, torch, root, dev, gen, rate):
    """#1-bf16 over one served MOD forward, #2-bf16/#3-bf16 over a MOD step
    (batch 512) and #4-bf16/#5-bf16 over a MOD_WIDE step (batch 128), on
    chip_smoke.bf16_inputs, by CUDA events, by device time in a profile
    and by phase, the backward's also by the host's median enqueue of a
    call; then the bf16 MOD pretrain step. A parent whose bf16 backward
    reads transposed weights gets them, as its route passed them."""
    import inspect

    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml

    def both(fn):
        return cs.time_ms_long(torch, fn), cs.device_ms_per_call(torch, fn)

    def add_phases(into, fn, per):
        for ph, ms in phases_of(cs, torch, fn).items():
            into[ph] = into.get(ph, 0.0) + per * ms

    def by_phase(phases):
        return ", ".join(f"{k} {v:.3f}" for k, v in sorted(phases.items(), key=lambda kv: -kv[1]))

    cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", "MOD.yaml"))
    tot, serve_phases = [0.0, 0.0], {}
    for g in cs.block_geometries(cfg, cs.SERVE_BATCH):
        args = cs.bf16_inputs(torch, g, gen, dev)
        ev, dv = both(lambda: pk.fused_window_block_bf16(*args))
        tot = [tot[0] + g["per_forward"] * ev, tot[1] + g["per_forward"] * dv]
        add_phases(serve_phases, lambda: pk.fused_window_block_bf16(*args), g["per_forward"])
        del args
    print(f"[{root}] MOD one served bf16 forward at batch {cs.SERVE_BATCH}: #1-bf16 "
          f"{tot[0]:.3f} ms (device {tot[1]:.3f}); device ms by phase: {by_phase(serve_phases)}",
          flush=True)
    pairs = {("#2-bf16", "#3-bf16"): (pk.fused_window_block_dropout_bf16,
                                      pk.fused_window_block_backward_bf16),
             ("#4-bf16", "#5-bf16"): (pk.fused_window_block_perhead_bf16,
                                      pk.fused_window_block_perhead_backward_bf16)}
    for dataset, batch in (("MOD", 512), ("MOD_WIDE", 128)):
        cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", f"{dataset}.yaml"))
        every = cs.block_geometries(cfg, batch)
        for names, (fwd, bwd) in pairs.items():
            mono = names[0] == "#2-bf16"
            geos = [g for g in every if pk.wblock_fits(g["N"], g["C"], g["heads"]) == mono]
            if not geos:
                continue
            transposes = "wqkv_t" in inspect.signature(bwd).parameters
            tot = {n: [0.0, 0.0] for n in names}
            host, phases, fwd_phases = 0.0, {}, {}
            for g in geos:
                args = cs.bf16_inputs(torch, g, gen, dev)
                tr = cs.transposed(args) if transposes else ()
                dy = torch.randn(args[0].shape, generator=gen).to(dev).to(torch.bfloat16)
                _, keep = fwd(*args, 7, rate)
                run_bwd = lambda: bwd(*args, dy, keep, rate, *tr)
                for n, fn in ((names[0], lambda: fwd(*args, 7, rate)), (names[1], run_bwd)):
                    ev, dv = both(fn)
                    tot[n] = [tot[n][0] + g["per_forward"] * ev, tot[n][1] + g["per_forward"] * dv]
                host += g["per_forward"] * cs.host_enqueue_ms(torch, run_bwd)
                add_phases(phases, run_bwd, g["per_forward"])
                add_phases(fwd_phases, lambda: fwd(*args, 7, rate), g["per_forward"])
                del args, tr, dy, keep, run_bwd
            print(f"[{root}] {dataset} bf16 ({'/'.join(names)} geometries, batch {batch}): one "
                  "step: " + ", ".join(f"{k} {a:.3f} ms (device {b:.3f})"
                                       for k, (a, b) in tot.items())
                  + f"; {names[0]} device ms by phase: {by_phase(fwd_phases)}"
                  + f"; {names[1]} device ms by phase: {by_phase(phases)}"
                  + f"; host's median enqueue ({names[1]}) {host:.3f} ms", flush=True)
        torch.cuda.empty_cache()
    window_bf16_step(cs, torch, root, dev)


def window_bf16_step(cs, torch, root, dev):
    """The bf16 MOD pretrain step on the default routes (root bench.py's
    configuration: batch 256, views fused to 512; 3 warm-up and 20 timed
    steps, synthetic data on the card, a fixed idx): p50, peak memory, and
    a profiled step's device busy time and idle share."""
    import numpy as np

    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone, init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.params import parse_train_params
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    batch = cs.TRAIN_BATCH
    targs = parse_train_params(["-dataset", "MOD", "-learn_framework", "FOCAL", "-compute_dtype",
                                "bfloat16", "-batch_size", str(batch)])
    cfg = targs.dataset_config
    data = to_device(synthetic_arrays(cfg, targs.task, 2 * batch, seed=0)[0], dev)
    idx = torch.arange(batch, device=dev)
    model = init_params(build_backbone(cfg, "SW_Transformer", targs.task, "FOCAL",
                                       compute_dtype="bfloat16"), seed=0).to(dev)
    state = create_train_state(targs, model, steps_per_epoch=100, seed=0)
    step = make_pretrain_step(model, build_augmenter(targs), make_focal_loss(targs))
    for _ in range(cs.TRAIN_WARMUP):
        step(state, data, idx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(cs.TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        step(state, data, idx)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    prof = cs.profile_device(torch, lambda: step(state, data, idx))
    print(f"[{root}] MOD bf16 pretrain step (batch {batch}): p50 "
          f"{float(np.percentile(step_s, 50)) * 1e3:.3f} ms, peak {peak_mb:.1f} MiB, device busy "
          f"{prof['device_busy_ms']:.3f} ms, idle share "
          f"{1 - prof['device_busy_ms'] / prof['wall_ms']:.3f}", flush=True)
    del model, state, step, data
    torch.cuda.empty_cache()


def measure_attention(cs, torch, np, root, dev, rate):
    """#6 over one served MOD forward's 16 launches (batch 128) and #6-#9
    over one MOD step's (batch 256, views fused to 512), each over at least
    20 ms of calls; then the -no_pallas_block MOD pretrain step."""
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml

    cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", "MOD.yaml"))
    for what, batch, keys in (("one served forward", cs.SERVE_BATCH, ("#6",)),
                              ("one step", 2 * cs.TRAIN_BATCH, ("#6", "#7", "#8", "#9"))):
        tot = {}
        for i, g in enumerate(cs.attention_geometries(cfg, batch, "MOD")):
            q, k, v, rb, mask, gy = cs.attention_inputs(torch, np, g, i, dev)
            runs = {"#6": lambda: pk.fused_window_attention(q, k, v, rb, mask),
                    "#7": lambda: pk.fused_window_attention_dropout(q, k, v, rb, mask, 3, rate),
                    "#8": lambda: pk.fused_window_attention_backward(q, k, v, rb, mask, gy),
                    "#9": lambda: pk.fused_window_attention_dropout_backward(q, k, v, rb, mask,
                                                                             gy, 3, rate)}
            runs = {key: runs[key] for key in keys}
            ms = {key: cs.time_ms_long(torch, fn) for key, fn in runs.items()}
            for key, fn in runs.items():  # device time a call, and the host's to enqueue one
                ms[f"{key} device"] = cs.device_ms_per_call(torch, fn)
                ms[f"{key} host"] = cs.host_enqueue_ms(torch, fn)
            for key in ms:
                tot[key] = tot.get(key, 0.0) + g["per_forward"] * ms[key]
            fwd_bytes, bwd_bytes = cs.attention_work(g, False)[1], cs.attention_work(g, True)[1]
            print(f"[{root}] {g['name']} (windows {g['windows']}, hd {g['hd']}, {g['per_forward']} "
                  f"a forward): " + ", ".join(f"{key} {v:.4f} ms" for key, v in ms.items())
                  + f"; #6/#7 {fwd_bytes / 1e9:.4f} GB, #6's device time at "
                  f"{fwd_bytes / ms['#6 device'] / 1e6:.1f} GB/s"
                  + (f"; #8/#9 {bwd_bytes / 1e9:.4f} GB, #9's device time at "
                     f"{bwd_bytes / ms['#9 device'] / 1e6:.1f} GB/s" if "#9" in ms else ""),
                  flush=True)
            del q, k, v, rb, mask, gy, runs
        print(f"[{root}] MOD {what} at batch {batch} (16 launches each; device: kernels only, by "
              "profile; host: the median enqueue of a launch, summed): "
              + ", ".join(f"{key} {ms:.3f} ms" for key, ms in tot.items()), flush=True)
        torch.cuda.empty_cache()
    attention_step(cs, torch, root, dev)


def attention_step(cs, torch, root, dev):
    """The -no_pallas_block MOD pretrain step at batch 256 (views fused to
    512; 3 warm-up and 20 timed steps, synthetic data on the card, a fixed
    idx): p50 and peak memory, and from one profiled step the device busy
    time, #7's and #9's device time and that of the copy and concatenation
    kernels and of PyTorch's elementwise kernels."""
    import numpy as np

    from focal_tpu_torch.data import synthetic_arrays, to_device
    from focal_tpu_torch.models import build_backbone
    from focal_tpu_torch.models.sw_transformer import init_params
    from focal_tpu_torch.ops.augment import build_augmenter
    from focal_tpu_torch.params import parse_train_params
    from focal_tpu_torch.train.losses import make_focal_loss
    from focal_tpu_torch.train.state import create_train_state
    from focal_tpu_torch.train.steps import make_pretrain_step

    batch = cs.TRAIN_BATCH
    targs = parse_train_params(["-dataset", "MOD", "-model", "SW_Transformer", "-learn_framework",
                                "FOCAL", "-stage", "pretrain", "-no_pallas_block", "-batch_size",
                                str(batch)])
    host_data, labels, _ = synthetic_arrays(targs.dataset_config, targs.task, 2 * batch, seed=0)
    tdata = to_device(host_data, dev)
    idx = torch.arange(batch, device=dev) % len(labels)
    model = build_backbone(targs.dataset_config, targs.model, targs.task, targs.learn_framework,
                           pallas_block=False)
    init_params(model, seed=0)
    model.to(dev)
    state = create_train_state(targs, model, steps_per_epoch=100, seed=0)
    step = make_pretrain_step(model, build_augmenter(targs), make_focal_loss(targs))
    for _ in range(cs.TRAIN_WARMUP):
        state, _ = step(state, tdata, idx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(cs.TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.time()
        state, _ = step(state, tdata, idx)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    prof = cs.profile_device(torch, lambda: step(state, tdata, idx))
    rows = prof["rows"]
    copies = sum(r["device_ms"] for r in rows
                 if "copy" in r["name"].lower() or "cat" in r["name"].lower())
    elementwise = sum(r["device_ms"] for r in rows if "elementwise" in r["name"].lower())
    print(f"[{root}] MOD -no_pallas_block pretrain step (batch {batch}): p50 "
          f"{float(np.percentile(step_s, 50)) * 1e3:.3f} ms, peak {peak_mb:.1f} MiB, device busy "
          f"{prof['device_busy_ms']:.3f} ms, idle share "
          f"{1 - prof['device_busy_ms'] / prof['wall_ms']:.3f}; device ms: #7 "
          f"{cs.attention_kernel_ms(rows, 'wattn_fwd_kernel', True):.3f}, #9 "
          f"{cs.attention_kernel_ms(rows, 'wattn_bwd_kernel', True):.3f}, copy and concatenation "
          f"kernels {copies:.3f}, elementwise kernels {elementwise:.3f}", flush=True)
    del model, state, step, tdata
    torch.cuda.empty_cache()


def measure_attention_bf16(cs, torch, np, root, dev, rate):
    """#6-bf16 at a served MOD forward's geometries (batch 128) and #7-bf16,
    #8-bf16 and #9-bf16 at a MOD step's (256 fused to 512), on the route's
    inputs (head views of a bf16 qkv, q unscaled with its scale passed):
    device ms a call (a profile) and CUDA-event ms, the bound
    (chip_smoke.attention_bf16_work); the f32 #6-#9 by device time at the
    same geometries; the sums over the forward and the step with the share
    of the bound; the bf16 kernels' spills and HMMA counts; the digests."""
    from focal_tpu_torch.ops import _build
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml

    spec = importlib.util.spec_from_file_location("diagnose_mlp",
                                                  os.path.join(HERE, "diagnose_mlp.py"))
    dm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dm)
    print(f"[{root}] the bf16 attention kernels' build:", flush=True)
    dm.build_report(_build, "window_attention.cu")
    cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", "MOD.yaml"))
    serve = cs.attention_geometries(cfg, cs.SERVE_BATCH, "MOD")
    train = cs.attention_geometries(cfg, 2 * cs.TRAIN_BATCH, "MOD")
    for what, geos, names in (("one served MOD forward", serve, ("#6",)),
                              ("one MOD step", train, ("#7", "#8", "#9"))):
        tot = {}
        for i, g in enumerate(geos):
            s = g["hd"] ** -0.5
            qkv, rb, mask, gy = cs.attention_bf16_inputs(torch, np, g, 600 + i, dev)
            q, k, v = pk._head_views(qkv, g["heads"])
            gh = pk._heads(gy, g["heads"])
            fq, fk, fv, frb, fmask, fgy = cs.attention_inputs(torch, np, g, 600 + i, dev)
            runs = {
                "#6-bf16": lambda: pk.fused_window_attention_bf16(q, k, v, rb, mask, q_scale=s),
                "#7-bf16": lambda: pk.fused_window_attention_dropout_bf16(q, k, v, rb, mask, 7,
                                                                          rate, q_scale=s),
                "#8-bf16": lambda: pk.fused_window_attention_backward_bf16(q, k, v, rb, mask, gh,
                                                                           q_scale=s),
                "#9-bf16": lambda: pk.fused_window_attention_dropout_backward_bf16(
                    q, k, v, rb, mask, gh, 7, rate, q_scale=s),
                "#6": lambda: pk.fused_window_attention(fq, fk, fv, frb, fmask),
                "#7": lambda: pk.fused_window_attention_dropout(fq, fk, fv, frb, fmask, 7, rate),
                "#8": lambda: pk.fused_window_attention_backward(fq, fk, fv, frb, fmask, fgy),
                "#9": lambda: pk.fused_window_attention_dropout_backward(fq, fk, fv, frb, fmask,
                                                                         fgy, 7, rate)}
            ms = {}
            for n in names:
                ms[f"{n}-bf16 device"] = cs.device_ms_per_call(torch, runs[f"{n}-bf16"])
                ms[f"{n}-bf16 events"] = cs.time_ms_long(torch, runs[f"{n}-bf16"])
                ms[f"{n}-bf16 bound"] = cs.attention_bf16_work(g, n in ("#8", "#9"))[2]
                ms[f"{n} device"] = cs.device_ms_per_call(torch, runs[n])
            for key, v_ in ms.items():
                tot[key] = tot.get(key, 0.0) + g["per_forward"] * v_
            print(f"[{root}] {g['name']} (windows {g['windows']}, hd {g['hd']}, "
                  f"{g['per_forward']} a forward): "
                  + ", ".join(f"{key} {v_:.4f}" for key, v_ in ms.items()), flush=True)
            del qkv, rb, mask, gy, q, k, v, gh, fq, fk, fv, frb, fmask, fgy, runs
        print(f"[{root}] bf16 attention, {what} (ms): " + ", ".join(
            f"{key} {v_:.4f}" for key, v_ in tot.items()) + "; share of the bound by device time: "
            + ", ".join(f"{n}-bf16 {tot[f'{n}-bf16 bound'] / tot[f'{n}-bf16 device']:.3f}"
                        for n in names), flush=True)
        torch.cuda.empty_cache()
    for name, digest in bits_digests(torch, np, pk, dev).items():
        print(f"[{root}] digest {name}: {digest}", flush=True)


def _digest(torch, tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def bits_digests(torch, np, pk, dev):
    """sha-256 (16 hex digits) of the outputs of kernels that a change to
    the bf16 attention must leave as they were: the f32 #6-#9 (at two
    geometries, rate 0 and 0.2), #1-#3 (C 64) and #4/#5 (C 512) and their
    bf16 forms, on inputs made from fixed seeds."""
    out = {}
    for B, H, N, hd, nW in ((131, 4, 9, 16, 4), (37, 4, 9, 64, 0)):
        rng = np.random.default_rng(B + hd)
        q, k, v, g = (torch.from_numpy(rng.normal(size=(B, H, N, hd)).astype(np.float32)).to(dev)
                      for _ in range(4))
        rb = torch.from_numpy((0.02 * rng.normal(size=(H, N, N))).astype(np.float32)).to(dev)
        mask = (torch.from_numpy(np.where(rng.random((nW, N, N)) < 0.3, -100.0, 0.0).astype(
            np.float32)).to(dev) if nW else None)
        outs = [pk.fused_window_attention(q, k, v, rb, mask, q_scale=hd**-0.5),
                pk.fused_window_attention_dropout(q, k, v, rb, mask, 5, 0.2),
                *pk.fused_window_attention_backward(q, k, v, rb, mask, g, q_scale=hd**-0.5),
                *pk.fused_window_attention_dropout_backward(q, k, v, rb, mask, g, 5, 0.2)]
        out[f"f32 #6-#9 B {B} hd {hd}"] = _digest(torch, outs)
    for B, C, nW in ((131, 64, 4), (37, 512, 0)):
        rng = np.random.default_rng(B + C)
        H, N = 4, 9
        shapes = [(B, N, C), (C, 3 * C), (3 * C,), (C, C), (C,), (H, N, N)]
        scales = [1.0, C**-0.5, 0.1, C**-0.5, 0.1, 0.02]
        args = [torch.from_numpy((rng.normal(size=sh) * sc).astype(np.float32)).to(dev)
                for sh, sc in zip(shapes, scales)]
        args.append(torch.from_numpy(np.where(rng.random((nW, N, N)) < 0.3, -100.0, 0.0).astype(
            np.float32)).to(dev) if nW else None)
        dy = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev)
        bf = torch.bfloat16
        bargs = [args[0].to(bf), args[1].to(bf), args[2], args[3].to(bf), *args[4:]]
        if pk.wblock_fits(N, C, H):
            y, keep = pk.fused_window_block_dropout(*args, 5, 0.2)
            f32 = [pk.fused_window_block(*args), y, keep,
                   *pk.fused_window_block_backward(*args, dy, keep, 0.2)]
            yb, keepb = pk.fused_window_block_dropout_bf16(*bargs, 5, 0.2)
            b16 = [pk.fused_window_block_bf16(*bargs), yb, keepb,
                   *pk.fused_window_block_backward_bf16(*bargs, dy.to(bf), keepb, 0.2)]
            names = ("#1-#3", "#1-#3-bf16")
        else:
            y, keep = pk.fused_window_block_perhead(*args, 5, 0.2)
            f32 = [pk.fused_window_block_perhead(*args)[0], y, keep,
                   *pk.fused_window_block_perhead_backward(*args, dy, keep, 0.2)]
            yb, keepb = pk.fused_window_block_perhead_bf16(*bargs, 5, 0.2)
            b16 = [pk.fused_window_block_perhead_bf16(*bargs)[0], yb, keepb,
                   *pk.fused_window_block_perhead_backward_bf16(*bargs, dy.to(bf), keepb, 0.2)]
            names = ("#4/#5", "#4/#5-bf16")
        out[f"f32 {names[0]} B {B} C {C}"] = _digest(torch, f32)
        out[f"{names[1]} B {B} C {C}"] = _digest(torch, b16)
    torch.cuda.synchronize()
    return out


def measure_mlp(cs, torch, np, root, dev, rate):
    """#10-#12 per MLP geometry and over a MOD and a MOD_WIDE forward; the
    -pallas_mlp MOD supervised step."""
    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml, parse_train_params

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
    step = (pk.fused_window_block_dropout, pk.fused_window_block_backward,
            fm.fused_mlp_dropout_forward, fm.fused_mlp_backward)
    sargs = parse_train_params(["-dataset", "MOD", "-model", "SW_Transformer", "-learn_framework",
                                "no", "-batch_size", "128", "-pallas_mlp"])
    run = cs.run_supervised_steps(torch, np, sargs, 128, cs.TRAIN_WARMUP, cs.TRAIN_STEPS, step,
                                  {k.__name__: 16 for k in step}, dev, "supervised-pallas-mlp")
    print(f"[{root}] MOD supervised step with -pallas_mlp (batch 128): p50 {run['p50_ms']:.3f} ms, "
          f"idle share {run['idle_share']:.3f}, device busy {run['profile']['device_busy_ms']:.3f} "
          f"ms, peak {run['peak_mb']:.1f} MiB", flush=True)


def measure_mlp_bf16(cs, torch, np, root, dev, rate):
    """#10-bf16 to #12-bf16 per MLP geometry of a MOD and a MOD_WIDE forward
    (batch 128; chip_smoke.mlp_bf16_inputs) by CUDA events and by device time
    in a profile, beside the bf16 library chain's (addmm -> GELU -> addmm,
    its autograd backward: the same code in every DIR's process, so its
    spread between them is the call's noise), summed over each forward;
    then the bf16 -pallas_mlp MOD supervised step (3 + 20 steps at batch
    128)."""
    import torch.nn.functional as F

    from focal_tpu_torch.ops import fused_mlp as fm
    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml, parse_train_params

    for dataset in ("MOD", "MOD_WIDE"):
        cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", f"{dataset}.yaml"))
        tot = {}
        for i, g in enumerate(cs.mlp_geometries(cfg, 128, dataset)):
            x, w1, b1, w2, b2, gy = cs.mlp_bf16_inputs(torch, np, g, 500 + i, dev)
            w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
            lw = [t.to(torch.bfloat16) for t in (w1, b1, w2, b2)]
            leaves = [t.clone().requires_grad_(True) for t in [x] + lw]
            ly = cs.library_mlp(torch, F, *leaves, rate)
            runs = {"#10-bf16": lambda: fm.fused_mlp_forward_bf16(x, w1, b1, w2, b2),
                    "#11-bf16": lambda: fm.fused_mlp_dropout_forward_bf16(x, w1, b1, w2, b2, 7,
                                                                          rate),
                    "#12-bf16": lambda: fm.fused_mlp_backward_bf16(x, w1, b1, w1t, w2t, gy, 7,
                                                                   rate),
                    "library fwd": lambda: cs.library_mlp(torch, F, x, *lw),
                    "library bwd": lambda: torch.autograd.grad(ly, leaves, gy, retain_graph=True)}
            ms = {}
            for key, fn in runs.items():
                with torch.no_grad() if key != "library bwd" else torch.enable_grad():
                    ms[key] = (cs.time_ms_long(torch, fn), cs.device_ms_per_call(torch, fn))
            for key, v in ms.items():
                t = tot.setdefault(key, [0.0, 0.0])
                t[0] += g["per_forward"] * v[0]
                t[1] += g["per_forward"] * v[1]
            print(f"[{root}] bf16 {g['name']} (T {g['T']}, C {g['C']}, {g['per_forward']} a "
                  "forward): " + ", ".join(f"{key} {a:.4f} ms (device {b:.4f})"
                                          for key, (a, b) in ms.items()), flush=True)
            del x, w1, b1, w2, b2, gy, w1t, w2t, lw, leaves, ly, runs
        print(f"[{root}] bf16 {dataset} MLPs of one forward at batch 128: "
              + ", ".join(f"{key} {a:.3f} ms (device {b:.3f})" for key, (a, b) in tot.items()),
              flush=True)
        torch.cuda.empty_cache()
    step = (pk.fused_window_block_dropout_bf16, pk.fused_window_block_backward_bf16,
            fm.fused_mlp_dropout_forward_bf16, fm.fused_mlp_backward_bf16)
    sargs = parse_train_params(["-dataset", "MOD", "-model", "SW_Transformer", "-learn_framework",
                                "no", "-batch_size", "128", "-pallas_mlp", "-compute_dtype",
                                "bfloat16"])
    run = cs.run_supervised_steps(torch, np, sargs, 128, cs.TRAIN_WARMUP, cs.TRAIN_STEPS, step,
                                  {k.__name__: 16 for k in step}, dev,
                                  "supervised-pallas-mlp-bf16")
    print(f"[{root}] MOD bf16 supervised step with -pallas_mlp (batch 128): p50 "
          f"{run['p50_ms']:.3f} ms, idle share {run['idle_share']:.3f}, device busy "
          f"{run['profile']['device_busy_ms']:.3f} ms, peak {run['peak_mb']:.1f} MiB", flush=True)


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


def measure_towers_bf16(cs, torch, np, root, dev, load_yaml):
    """#13-bf16 and #14-bf16 per tower geometry and summed over one MOD and
    one MOD_WIDE DeepSense step (chip_smoke's phase-30 inputs; a geometry
    counts as often as towers run it): device ms a call by phase (a
    profile, chip_smoke.tower_phase_split), CUDA-event ms, the host's median
    ms to enqueue a call (21 calls, each after a synchronise), the cuDNN
    bf16 chain (chip_smoke.library_tower on bf16 rows, its autograd
    backward) and the bound (chip_smoke.tower_bf16_work)."""
    import statistics

    import torch.nn.functional as F

    from focal_tpu_torch.ops import conv_tower as ct

    bf = torch.bfloat16
    for dataset, samples in (("MOD", 2 * cs.DS_BATCH), ("MOD_WIDE", 2 * cs.DS_WIDE_BATCH)):
        cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", f"{dataset}.yaml"))
        tot, phases, kernels = {}, {}, {}
        for i, g in enumerate(cs.tower_geometries(cfg, samples, dataset)):
            x0, params, masks, dy = cs.tower_bf16_inputs(torch, np, g, 300 + i, dev)
            kp = [[w.to(bf) for w in params[0]]] + params[1:]
            cfgs, ext = g["cfgs"], g["external"]
            _, _, _, saved = ct.tower_forward(x0, cfgs, *kp, masks, ext)
            runs = {"#13-bf16": lambda: ct.tower_forward(x0, cfgs, *kp, masks, ext),
                    "#14-bf16": lambda: ct.fused_conv_tower_backward_bf16(saved, dy)}
            ms = {}
            for key, fn in runs.items():
                split = cs.tower_phase_split(torch, fn, strict=False)
                ms[f"{key} device"] = split["device_ms"]
                for ph, v in split["phases"].items():
                    phases[(key, ph)] = phases.get((key, ph), 0.0) + g["towers"] * v
                for name, k in split["kernels"].items():
                    kernels[(key, name)] = kernels.get((key, name), 0.0) + g["towers"] * k["device_ms"]
                ms[key] = cs.time_ms(torch, fn)
                host = []
                for _ in range(21):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                ms[f"{key} host"] = statistics.median(host)
                print(f"[{root}] {g['name']} {key} device ms by phase: "
                      + ", ".join(f"{ph} {v:.4f}" for ph, v in sorted(split["phases"].items(),
                                                                      key=lambda kv: -kv[1])),
                      flush=True)
            lp = [kp[0], [b.to(bf) for b in params[1]]] + params[2:]
            lm = [m.to(bf) for m in masks]
            with torch.no_grad():
                ms["library fwd"] = cs.time_ms(torch, lambda: cs.library_tower(torch, F, x0, g, lp,
                                                                                lm))
            xl, pl_, leaves = cs.tower_leaves(torch, x0, lp, ext)
            ly = cs.library_tower(torch, F, xl, g, pl_, lm)
            dyl = dy.permute(0, 2, 1).unsqueeze(2)
            ms["library bwd"] = cs.time_ms(torch, lambda: torch.autograd.grad(
                ly, leaves, dyl, retain_graph=True))
            work = cs.tower_bf16_work(g)
            ms["bound fwd"], ms["bound bwd"] = work[2], work[6]
            for key, v in ms.items():
                tot[key] = tot.get(key, 0.0) + g["towers"] * v
            print(f"[{root}] {g['name']} (R {g['R']}, S {g['S']}, C {g['C']}, towers "
                  f"{g['towers']}): " + ", ".join(f"{key} {v:.4f} ms" for key, v in ms.items()),
                  flush=True)
            del x0, params, masks, dy, saved, runs, ly, xl, pl_, leaves
        print(f"[{root}] {dataset} bf16 one DeepSense step's towers: "
              + ", ".join(f"{key} {v:.4f} ms" for key, v in tot.items()), flush=True)
        for key in ("#13-bf16", "#14-bf16"):
            print(f"[{root}] {dataset} bf16 step {key} device ms by phase: "
                  + ", ".join(f"{ph} {v:.4f}" for (k, ph), v in sorted(
                      phases.items(), key=lambda kv: -kv[1]) if k == key), flush=True)
            print(f"[{root}] {dataset} bf16 step {key} device ms by kernel: "
                  + ", ".join(f"{name} {v:.4f}" for (k, name), v in sorted(
                      kernels.items(), key=lambda kv: -kv[1]) if k == key), flush=True)
        torch.cuda.empty_cache()
    mod = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", "MOD.yaml"))
    others = [g for r in cs.RECIPES
              for g in cs.tower_geometries(load_yaml(os.path.join(
                  root, "focal_tpu_torch", "configs", f"{r}.yaml")), 2 * cs.DS_BATCH, r)]
    others += [g for g in cs.tower_geometries(cs.two_locations(mod), 2 * cs.DS_BATCH,
                                              "MOD two-location")
               if g["name"].endswith("mod_extractor")]
    for i, g in enumerate(others):
        x0, params, masks, dy = cs.tower_bf16_inputs(torch, np, g, 400 + i, dev)
        kp = [[w.to(bf) for w in params[0]]] + params[1:]
        cfgs, ext = g["cfgs"], g["external"]
        _, _, _, saved = ct.tower_forward(x0, cfgs, *kp, masks, ext)
        fwd = cs.tower_phase_split(torch, lambda: ct.tower_forward(x0, cfgs, *kp, masks, ext),
                                   strict=False)["device_ms"]
        bwd = cs.tower_phase_split(torch, lambda: ct.fused_conv_tower_backward_bf16(saved, dy),
                                   strict=False)["device_ms"]
        print(f"[{root}] {g['name']} (R {g['R']}, S {g['S']}, C {g['C']}, cin "
              f"{g['cfgs'][0][1]}, layers {len(cfgs)}): #13-bf16 device {fwd:.4f} ms, #14-bf16 "
              f"device {bwd:.4f} ms", flush=True)
        del x0, params, masks, dy, saved
    torch.cuda.empty_cache()


def main():
    argv = sys.argv[1:]
    parts = PARTS
    if "--parts" in argv:
        i = argv.index("--parts")
        parts = tuple(argv[i + 1].split(","))
        if not set(parts) <= set(PARTS):
            sys.exit(f"--parts takes {', '.join(PARTS)}")
        del argv[i:i + 2]
    if argv[:1] == ["--child"]:
        measure(os.path.abspath(argv[1]), "--profile" in argv[2:], parts)
        return
    profile = "--profile" in argv
    dirs = [a for a in argv if a != "--profile"]
    if not dirs:
        sys.exit(__doc__)
    for d in dirs:
        cmd = ([sys.executable, os.path.abspath(__file__), "--child", d, "--parts", ",".join(parts)]
               + (["--profile"] if profile else []))
        subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
