"""Where the attention-only backward (#8/#9) or, with --forward, forward
(#6/#7) of csrc/window_attention.cu spends its time on the card, by two
diagnostic builds of a copy of the port; with --bf16 their bf16 forms
(#9-bf16, #7-bf16).

    python3 diagnose_attention.py [--forward] [--bf16] [DIR]

DIR is the checkout to diagnose (this one by default; for example the
parent commit unpacked with git archive). Each build is a copy of DIR's
focal_tpu_torch/ under build/diagnose/ with its window_attention.cu
patched (the patches anchor on the source's text and fail where it
changed):
  * phases: clock64() counters around each phase of the kernel, summed
    over every warp (one atomicAdd a warp at the end) and read back by an
    added focal_debug_cycles();
  * staging: the same grid, chunks and cp.async ring, with the math
    replaced by copying each row through (dq = q + g, dk = k, dv = v; out
    = q + k + v): what the staging alone takes, the ring's ceiling.
The f32 kernels are the bodies wattn_fwd / wattn_bwd. With --bf16 the
kernels patched are the tensor-core bf16 kernels (wattn_bf16_fwd_kernel,
wattn_bf16_bwd_kernel) where DIR has them, and in a checkout from before
them the same f32 bodies, which its bf16 forms instantiate on bf16 rows;
the copy-through then moves bf16 rows.
For each MOD training geometry (batch 256, views fused to 512) it prints
the kernel's device time a call (chip_smoke.device_ms_per_call) on DIR, on
the staging build and on the phases build, and the phases build's cycles a
warp spends on each phase of a chunk (for the bf16 kernels, whose warps
each take whole pairs, the pairs' phases summed over the warp's pairs of
the chunk). The bf16 inputs are the route's: q, k,
v as head views of one [B_, N, 3C] bf16 tensor, q unscaled with its scale
passed. Each build runs in a process of its own. Needs a CUDA card;
imports no JAX.
"""

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "diagnose")
PHASES = ("wait", "issue", "keep bits + bias", "products", "softmax..ds", "dq", "barrier",
          "stage 2")
FWD_PHASES = ("wait", "land (scale q; widen bf16)", "barrier", "issue", "keep bits + bias",
              "products", "softmax + dropout", "a v + write")
# the tensor-core bf16 kernels' phases: a chunk's (wait, land, barrier,
# issue), then a group of a warp's pairs' (products, row phase, products)
BF16_PHASES = ("wait", "land (scale q)", "barrier", "issue + d rel_bias sums", "q k^T, g v^T",
               "rows: softmax..ds, tiles", "dq = ds k", "dk, dv")
BF16_FWD_PHASES = ("wait", "land (scale q)", "barrier", "issue", "q k^T",
                   "rows: softmax, dropout, tiles", "a v + write", "-")
SRC = os.path.join("focal_tpu_torch", "csrc", "window_attention.cu")
NEW_BF16 = "wattn_bf16_bwd_kernel"  # the tensor-core bf16 kernels are in the source


def _replace(src, old, new):
    if old not in src:
        raise SystemExit(f"diagnose_attention.py: {SRC} no longer has the text it patches:\n{old}")
    return src.replace(old, new, 1)


def _after_line(src, anchor, text):
    """``text`` inserted after the line holding ``anchor``."""
    if anchor not in src:
        raise SystemExit(f"diagnose_attention.py: {SRC} no longer has the text it patches:\n"
                         f"{anchor}")
    end = src.index("\n", src.index(anchor)) + 1
    return src[:end] + text + src[end:]


def _before_line(src, anchor, text):
    """``text`` inserted before the line holding ``anchor``."""
    if anchor not in src:
        raise SystemExit(f"diagnose_attention.py: {SRC} no longer has the text it patches:\n"
                         f"{anchor}")
    start = src.rindex("\n", 0, src.index(anchor)) + 1
    return src[:start] + text + src[start:]


def _tick(name):
    return f"    {{ const unsigned long long n = clock64(); {name} += n - tc; tc = n; }}\n"


def _segment(src, start, end):
    """(the text before ``start``, from it to ``end``, from ``end`` on): the
    patches of one kernel anchor within its own text."""
    i = src.index(start)
    j = src.index(end, i)
    return src[:i], src[i:j], src[j:]


COUNTERS = "__device__ unsigned long long g_phase_cycles[9];\n\n"
FLUSH = ("  if (threadIdx.x % 32 == 0) {\n"
         "    for (int q = 0; q < 8; ++q) atomicAdd(&g_phase_cycles[q], c[q]);\n"
         "    atomicAdd(&g_phase_cycles[8], (unsigned long long)it);\n  }\n")
READBACK = '''
// The counters summed over every warp (8 phases, then the warps' chunks),
// or with reset their zeroing.
extern "C" int focal_debug_cycles(unsigned long long* host, int reset) {
  unsigned long long zero[9] = {};
  if (reset) return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(zero));
}
'''


# ---------------------------------------------------------------------------
# the f32 bodies (wattn_fwd, wattn_bwd)


def _backward_body(src):
    return _segment(src, "// backward (#8; #9 with kDropout)", "// The keep mask of #7 / #9")


def _forward_body(src):
    return _segment(src, "// forward (#6; #7 with kDropout)", "// backward (#8; #9 with kDropout)")


def patch_phases(src):
    """wattn_bwd with a clock64() counter around each phase."""
    head, body, tail = _backward_body(src)
    body = _replace(body, "  int it = 0;\n", "  int it = 0;\n  unsigned long long tc, c[8] = {};\n")
    body = _replace(body, "    focal::cp_async_wait<0>();",
                    "    tc = clock64();\n    focal::cp_async_wait<0>();")
    body = _replace(body, "the other slot and ds / a_v are free\n",
                    "the other slot and ds / a_v are free\n" + _tick("c[0]"))
    body = _replace(body, "    focal::cp_async_commit();\n    const float* ks",
                    "    focal::cp_async_commit();\n" + _tick("c[1]") + "    const float* ks")
    body = _replace(body, "    const float* kb = ks + t.pl * N * g.stride;\n",
                    _tick("c[2]") + "    const float* kb = ks + t.pl * N * g.stride;\n")
    body = _replace(body, "g, t.lane, ds);  // d_attn\n",
                    "g, t.lane, ds);  // d_attn\n" + _tick("c[3]"))
    body = _before_line(body, "dqo = dq + t.w", _tick("c[4]"))
    body = _replace(body, "    });\n    __syncthreads();\n\n    // stage 2",
                    "    });\n" + _tick("c[5]") + "    __syncthreads();\n" + _tick("c[6]")
                    + "\n    // stage 2")
    body = _replace(body, "      dacc[e] = acc;\n    }\n  }\n",
                    "      dacc[e] = acc;\n    }\n" + _tick("c[7]") + "  }\n" + FLUSH)
    return head + COUNTERS + body + tail + READBACK


def patch_fwd_phases(src):
    """wattn_fwd with a clock64() counter around each phase."""
    head, body, tail = _forward_body(src)
    body = _replace(body, "  int it = 0;\n", "  int it = 0;\n  unsigned long long tc, c[8] = {};\n")
    wait = "    focal::cp_async_wait<0>();  // this thread's copies of the chunk have landed\n"
    body = _replace(body, wait, "    tc = clock64();\n" + wait + _tick("c[0]"))
    body = _after_line(body, "(chunk, g, qs, q_scale);", _tick("c[1]"))  # q scaled (widened)
    body = _after_line(body, "// and every thread's, scaled", _tick("c[2]"))
    body = _replace(body, "    focal::cp_async_commit();\n    const float* ks",
                    "    focal::cp_async_commit();\n" + _tick("c[3]") + "    const float* ks")
    body = _replace(body, "    float p[kN];\n", _tick("c[4]") + "    float p[kN];\n")
    body = _replace(body, "    focal::softmax_scores(p, N);\n",
                    _tick("c[5]") + "    focal::softmax_scores(p, N);\n")
    body = _replace(body, "    const float* vb = vs", _tick("c[6]") + "    const float* vb = vs")
    body = _replace(body, "      if (t.active) store4(o + 4 * c, acc);\n    });\n  }\n}\n",
                    "      if (t.active) store4(o + 4 * c, acc);\n    });\n" + _tick("c[7]")
                    + "  }\n" + FLUSH + "}\n")
    return head + COUNTERS + body + tail + READBACK


def patch_fwd_staging(src):
    """wattn_fwd with the math replaced by copying rows through."""
    head, body, tail = _forward_body(src)
    start = body.index("    const Row t = thread_row(g, p0, np);\n")
    end = body.index("template <int kN, int kCols, bool kDropout>\n__global__")
    return head + body[:start] + '''    const Row t = thread_row(g, p0, np);
    auto* o = out + t.w * so.b + t.h * so.h + t.i * so.n;
    focal::for_lane_cols<kCols>(t.lane, g, [&](int c) {
      const float4 x = *reinterpret_cast<const float4*>(qs + t.r * g.stride + 4 * c);
      const float4 y = *reinterpret_cast<const float4*>(ks + t.r * g.stride + 4 * c);
      const float4 z = *reinterpret_cast<const float4*>(vs + t.r * g.stride + 4 * c);
      if (t.active) store4(o + 4 * c, make_float4(x.x + y.x + z.x, x.y + y.y + z.y,
                                                  x.z + y.z + z.z, x.w + y.w + z.w));
    });
  }
}

''' + body[end:] + tail


def patch_staging(src):
    """wattn_bwd with the math replaced by copying rows through."""
    head, body, tail = _backward_body(src)
    start = body.index("    // stage 1: query row i of pair pl\n")
    end = body.index("  for (int e = threadIdx.x; e < g.H * nn; e += kThreads)\n"
                     "    dbias_part[")
    return head + body[:start] + '''    const Row t = thread_row(g, p0, np);
    auto* dqo = dq + t.w * so.dq.b + t.h * so.dq.h + t.i * so.dq.n;
    auto* dko = dk + t.w * so.dk.b + t.h * so.dk.h + t.i * so.dk.n;
    auto* dvo = dv + t.w * so.dv.b + t.h * so.dv.h + t.i * so.dv.n;
    focal::for_lane_cols<kCols>(t.lane, g, [&](int c) {
      const float4 x = *reinterpret_cast<const float4*>(qs + t.r * g.stride + 4 * c);
      const float4 y = *reinterpret_cast<const float4*>(ks + t.r * g.stride + 4 * c);
      const float4 z = *reinterpret_cast<const float4*>(vs + t.r * g.stride + 4 * c);
      const float4 u = *reinterpret_cast<const float4*>(gs + t.r * g.stride + 4 * c);
      if (t.active) {
        store4(dqo + 4 * c, make_float4(x.x + u.x, x.y + u.y, x.z + u.z, x.w + u.w));
        store4(dko + 4 * c, y);
        store4(dvo + 4 * c, z);
      }
    });
  }
  __syncthreads();
''' + body[end:] + tail


# ---------------------------------------------------------------------------
# the tensor-core bf16 kernels (wattn_bf16_fwd_kernel, wattn_bf16_bwd_kernel)


def _bf16_body(src, forward):
    if forward:
        return _segment(src, "// bf16 forward (#6-bf16; #7-bf16 with kDropout)",
                        "// bf16 backward (#8-bf16; #9-bf16 with kDropout)")
    return _segment(src, "// bf16 backward (#8-bf16; #9-bf16 with kDropout)",
                    "// bf16 kernel instances")


def _tick_marks(body, marks):
    """The body with each `// [phase k]` mark replaced by tick k, the chunk
    loop's counters declared and flushed at the kernel's end."""
    body = _replace(body, "  int it = 0;\n", "  int it = 0;\n  unsigned long long tc = clock64(), "
                    "c[8] = {};\n")
    for k in marks:
        body = _replace(body, f"// [phase {k}]\n", f"// [phase {k}]\n" + _tick(f"c[{k}]"))
    return _replace(body, "  // [end]\n", FLUSH)


def patch_bf16_phases(src, forward):
    """The bf16 kernel with a clock64() counter after each `// [phase k]`
    mark."""
    head, body, tail = _bf16_body(src, forward)
    body = _tick_marks(body, range(7 if forward else 8))
    return head + COUNTERS + body + tail + READBACK


def patch_bf16_staging(src, forward):
    """The bf16 kernel with the pairs' math replaced by copying rows
    through (in f32, stored as bf16)."""
    head, body, tail = _bf16_body(src, forward)
    start = body.index("      // [math]\n")
    end = body.index("      // [end math]\n")
    if forward:
        copy = '''      for (int u = 0; u < cnt; ++u) {
        const int pl = pl0 + kWarps16 * u, pair = p0 + pl, w = pair / g.H, h = pair - w * g.H;
        const bf16* qs = qs0 + pl * N * g.rs;
        for (int e = lane; e < N * g.c8; e += 32) {
          const int i = e / g.c8, c = 8 * (e - i * g.c8);
          float f[8];
          for (int v = 0; v < 8; ++v)
            f[v] = __bfloat162float(qs[i * g.rs + c + v]) +
                   __bfloat162float(qs[slab + i * g.rs + c + v]) +
                   __bfloat162float(qs[2 * slab + i * g.rs + c + v]);
          bf16* o = out + w * so.b + h * so.h + i * so.n + c;
          store4(o, make_float4(f[0], f[1], f[2], f[3]));
          store4(o + 4, make_float4(f[4], f[5], f[6], f[7]));
        }
      }
'''
    else:
        copy = '''      for (int u = 0; u < cnt; ++u) {
        const int pl = pl0 + kWarps16 * u, pair = p0 + pl, w = pair / g.H, h = pair - w * g.H;
        const bf16* qs = qs0 + pl * N * g.rs;
        for (int e = lane; e < N * g.c8; e += 32) {
          const int i = e / g.c8, c = 8 * (e - i * g.c8);
          float f[8];
          for (int v = 0; v < 8; ++v)
            f[v] = __bfloat162float(qs[i * g.rs + c + v]) +
                   __bfloat162float(qs[3 * slab + i * g.rs + c + v]);
          bf16* o = dq + w * so.dq.b + h * so.dq.h + i * so.dq.n + c;
          store4(o, make_float4(f[0], f[1], f[2], f[3]));
          store4(o + 4, make_float4(f[4], f[5], f[6], f[7]));
          *reinterpret_cast<uint4*>(dk + w * so.dk.b + h * so.dk.h + i * so.dk.n + c) =
              *reinterpret_cast<const uint4*>(qs + slab + i * g.rs + c);
          *reinterpret_cast<uint4*>(dv + w * so.dv.b + h * so.dv.h + i * so.dv.n + c) =
              *reinterpret_cast<const uint4*>(qs + 2 * slab + i * g.rs + c);
        }
      }
'''
    return head + body[:start] + copy + body[end:] + tail


# ---------------------------------------------------------------------------


def patches(src, forward, bf16):
    """(staging patch, phases patch, phase names) for the kernel diagnosed."""
    if bf16 and NEW_BF16 in src:
        return (lambda s: patch_bf16_staging(s, forward), lambda s: patch_bf16_phases(s, forward),
                BF16_FWD_PHASES if forward else BF16_PHASES)
    if forward:
        return patch_fwd_staging, patch_fwd_phases, FWD_PHASES
    return patch_staging, patch_phases, PHASES


def build_copy(dir_, name, patch):
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(dir_, "focal_tpu_torch"), os.path.join(root, "focal_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, SRC)
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(patch(src))
    return root


def measure(name, root, forward, bf16, phases):
    """The kernel's device time per MOD training geometry for the package
    under ``root``: #9 (``forward``: #7; ``bf16``: #9-bf16, #7-bf16); with
    a phases build, its cycles a warp and chunk."""
    import ctypes
    import importlib.util

    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from focal_tpu_torch.ops import pallas_kernels as pk
    from focal_tpu_torch.params import load_yaml

    if not os.path.abspath(pk.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {pk.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("diagnose_attention.py needs a CUDA card")
    dev = torch.device("cuda")
    lib = pk._window_attention_lib()
    if name == "phases":
        lib.focal_debug_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    kernel = ("#7" if forward else "#9") + ("-bf16" if bf16 else "")
    cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", "MOD.yaml"))
    total = 0.0
    for i, g in enumerate(cs.attention_geometries(cfg, 2 * cs.TRAIN_BATCH, "MOD")):
        if bf16:
            qkv, rb, mask, gy = cs.attention_bf16_inputs(torch, np, g, i, dev)
            q, k, v = pk._head_views(qkv, g["heads"])
            gh, s = pk._heads(gy, g["heads"]), g["hd"] ** -0.5

            def fn():
                if forward:
                    return pk.fused_window_attention_dropout_bf16(q, k, v, rb, mask, 3, 0.2,
                                                                  q_scale=s)
                return pk.fused_window_attention_dropout_backward_bf16(q, k, v, rb, mask, gh, 3,
                                                                       0.2, q_scale=s)
        else:
            q, k, v, rb, mask, gy = cs.attention_inputs(torch, np, g, i, dev)

            def fn():
                if forward:
                    return pk.fused_window_attention_dropout(q, k, v, rb, mask, 3, 0.2)
                return pk.fused_window_attention_dropout_backward(q, k, v, rb, mask, gy, 3, 0.2)

        ms = cs.device_ms_per_call(torch, fn)
        total += g["per_forward"] * ms
        line = f"[{name}] {g['name']} (windows {g['windows']}, hd {g['hd']}): {kernel} {ms:.4f} ms"
        if name == "phases":
            torch.cuda.synchronize()
            lib.focal_debug_cycles(None, 1)
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            c = (ctypes.c_ulonglong * 9)()
            lib.focal_debug_cycles(ctypes.cast(c, ctypes.c_void_p), 0)
            line += "; cycles a warp and chunk: " + ", ".join(
                f"{p} {c[j] // max(c[8], 1)}" for j, p in enumerate(phases) if p != "-")
        print(line, flush=True)
    print(f"[{name}] one MOD step (16 launches): {kernel} {total:.3f} ms of device time",
          flush=True)


def main():
    argv = sys.argv[1:]
    if argv[:1] == ["--child"]:
        name, root, forward, bf16 = argv[1], argv[2], "--forward" in argv, "--bf16" in argv
        with open(os.path.join(root, SRC)) as f:
            phases = patches(f.read(), forward, bf16)[2]
        measure(name, root, forward, bf16, phases)
        return
    forward, bf16 = "--forward" in argv, "--bf16" in argv
    dirs = [a for a in argv if not a.startswith("--")]
    dir_ = os.path.abspath(dirs[0]) if dirs else HERE
    with open(os.path.join(dir_, SRC)) as f:
        staging, phases, _ = patches(f.read(), forward, bf16)
    roots = {"tree": dir_, "staging": build_copy(dir_, "staging", staging),
             "phases": build_copy(dir_, "phases", phases)}
    flags = (["--forward"] if forward else []) + (["--bf16"] if bf16 else [])
    print(f"diagnose_attention.py on {dir_}", flush=True)
    for name, root in roots.items():
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", name, root] + flags,
                       check=True)


if __name__ == "__main__":
    main()
