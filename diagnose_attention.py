"""Where the attention-only backward (#8/#9) or, with --forward, forward
(#6/#7) of csrc/window_attention.cu spends its time on the card, by two
diagnostic builds of a copy of the port.

    python3 diagnose_attention.py [--forward]

Each build is a copy of focal_tpu_torch/ under build/diagnose/ with its
window_attention.cu patched (the patches anchor on the source's text and
fail where it changed):
  * phases: clock64() counters around each phase of wattn_bwd_kernel (or
    wattn_fwd_kernel), summed over every warp (one atomicAdd a warp at the
    end) and read back by an added focal_debug_cycles();
  * staging: the same grid, chunks and cp.async ring, with the math
    replaced by copying each row through (dq = q + g, dk = k, dv = v; out
    = q + k + v): what the staging alone takes, the ring's ceiling.
For each MOD training geometry (batch 256, views fused to 512) it prints
#9's (#7's) device time a call (chip_smoke.device_ms_per_call) on this
checkout, on the staging build and on the phases build, and the phases
build's cycles a warp spends on each phase of a chunk. Each build runs in
a process of its own. Needs a CUDA card; imports no JAX.
"""

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "diagnose")
PHASES = ("wait", "issue", "keep bits + bias", "products", "softmax..ds", "dq", "barrier",
          "stage 2")
FWD_PHASES = ("wait", "scale q", "barrier", "issue", "keep bits + bias", "products",
              "softmax + dropout", "a v + write")
SRC = os.path.join("focal_tpu_torch", "csrc", "window_attention.cu")


def _replace(src, old, new):
    if old not in src:
        raise SystemExit(f"diagnose_attention.py: {SRC} no longer has the text it patches:\n{old}")
    return src.replace(old, new, 1)


def _tick(name):
    return f"    {{ const unsigned long long n = clock64(); {name} += n - tc; tc = n; }}\n"


def _segment(src, start, end):
    """(the text before ``start``, from it to ``end``, from ``end`` on): the
    patches of one kernel anchor within its own text."""
    i, j = src.index(start), src.index(end)
    return src[:i], src[i:j], src[j:]


COUNTERS = "__device__ unsigned long long g_phase_cycles[9];\n\n"


def patch_phases(src):
    """wattn_bwd_kernel with a clock64() counter around each phase."""
    head, body, tail = _segment(src, "// backward (#8; #9 with kDropout)",
                                "// out[e] = sum over s (in order)")
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
    body = _replace(body, "    float4* dqo = ", _tick("c[4]") + "    float4* dqo = ")
    body = _replace(body, "    });\n    __syncthreads();\n\n    // stage 2",
                    "    });\n" + _tick("c[5]") + "    __syncthreads();\n" + _tick("c[6]")
                    + "\n    // stage 2")
    body = _replace(body, "      dacc[e] = acc;\n    }\n  }\n",
                    "      dacc[e] = acc;\n    }\n" + _tick("c[7]") + "  }\n"
                    "  if (threadIdx.x % 32 == 0) {\n"
                    "    for (int q = 0; q < 8; ++q) atomicAdd(&g_phase_cycles[q], c[q]);\n"
                    "    atomicAdd(&g_phase_cycles[8], (unsigned long long)it);\n  }\n")
    return head + COUNTERS + body + tail + READBACK


READBACK = '''
// The counters summed over every warp (8 phases, then the warps' chunks),
// or with reset their zeroing.
extern "C" int focal_debug_cycles(unsigned long long* host, int reset) {
  unsigned long long zero[9] = {};
  if (reset) return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return (int)cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(zero));
}
'''


def _forward_kernel(src):
    return _segment(src, "// forward (#6; #7 with kDropout)", "// backward (#8; #9 with kDropout)")


def patch_fwd_phases(src):
    """wattn_fwd_kernel with a clock64() counter around each phase."""
    head, body, tail = _forward_kernel(src)
    body = _replace(body, "  int it = 0;\n", "  int it = 0;\n  unsigned long long tc, c[8] = {};\n")
    wait = "    focal::cp_async_wait<0>();  // this thread's copies of the chunk have landed\n"
    body = _replace(body, wait, "    tc = clock64();\n" + wait + _tick("c[0]"))
    scale = "    if (q_scale != 1.f) scale_staged_q(chunk, g, qs, q_scale);\n"
    body = _replace(body, scale, scale + _tick("c[1]"))
    bar = "    __syncthreads();  // and every thread's, scaled; the other slot is free\n"
    body = _replace(body, bar, bar + _tick("c[2]"))
    body = _replace(body, "    focal::cp_async_commit();\n    const float* ks",
                    "    focal::cp_async_commit();\n" + _tick("c[3]") + "    const float* ks")
    body = _replace(body, "    float p[kN];\n", _tick("c[4]") + "    float p[kN];\n")
    body = _replace(body, "    focal::softmax_scores(p, N);\n",
                    _tick("c[5]") + "    focal::softmax_scores(p, N);\n")
    body = _replace(body, "    const float* vb = vs", _tick("c[6]") + "    const float* vb = vs")
    body = _replace(body, "      if (t.active) o[c] = acc;\n    });\n  }\n}\n",
                    "      if (t.active) o[c] = acc;\n    });\n" + _tick("c[7]") + "  }\n"
                    "  if (threadIdx.x % 32 == 0) {\n"
                    "    for (int q = 0; q < 8; ++q) atomicAdd(&g_phase_cycles[q], c[q]);\n"
                    "    atomicAdd(&g_phase_cycles[8], (unsigned long long)it);\n  }\n}\n")
    return head + COUNTERS + body + tail + READBACK


def patch_fwd_staging(src):
    """wattn_fwd_kernel with the math replaced by copying rows through."""
    head, body, tail = _forward_kernel(src)
    start = body.index("    const Row t = thread_row(g, p0, np);\n")
    return head + body[:start] + '''    const Row t = thread_row(g, p0, np);
    float4* o = reinterpret_cast<float4*>(out + t.w * so.b + t.h * so.h + t.i * so.n);
    focal::for_lane_cols<kCols>(t.lane, g, [&](int c) {
      const float4 x = *reinterpret_cast<const float4*>(qs + t.r * g.stride + 4 * c);
      const float4 y = *reinterpret_cast<const float4*>(ks + t.r * g.stride + 4 * c);
      const float4 z = *reinterpret_cast<const float4*>(vs + t.r * g.stride + 4 * c);
      if (t.active) o[c] = make_float4(x.x + y.x + z.x, x.y + y.y + z.y, x.z + y.z + z.z,
                                       x.w + y.w + z.w);
    });
  }
}

''' + tail


def patch_staging(src):
    """wattn_bwd_kernel with the math replaced by copying rows through."""
    start = src.index("    // stage 1: query row i of pair pl\n")
    end = src.index("  for (int e = threadIdx.x; e < g.H * nn; e += kThreads)\n"
                    "    dbias_part[")
    return src[:start] + '''    const Row t = thread_row(g, p0, np);
    float4* dqo = reinterpret_cast<float4*>(dq + t.w * so.dq.b + t.h * so.dq.h + t.i * so.dq.n);
    float4* dko = reinterpret_cast<float4*>(dk + t.w * so.dk.b + t.h * so.dk.h + t.i * so.dk.n);
    float4* dvo = reinterpret_cast<float4*>(dv + t.w * so.dv.b + t.h * so.dv.h + t.i * so.dv.n);
    focal::for_lane_cols<kCols>(t.lane, g, [&](int c) {
      const float4 x = *reinterpret_cast<const float4*>(qs + t.r * g.stride + 4 * c);
      const float4 y = *reinterpret_cast<const float4*>(ks + t.r * g.stride + 4 * c);
      const float4 z = *reinterpret_cast<const float4*>(vs + t.r * g.stride + 4 * c);
      const float4 u = *reinterpret_cast<const float4*>(gs + t.r * g.stride + 4 * c);
      if (t.active) {
        dqo[c] = make_float4(x.x + u.x, x.y + u.y, x.z + u.z, x.w + u.w);
        dko[c] = y;
        dvo[c] = z;
      }
    });
  }
  __syncthreads();
''' + src[end:]


def build_copy(name, patch):
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "focal_tpu_torch"), os.path.join(root, "focal_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, SRC)
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(patch(src))
    return root


def measure(name, root, forward):
    """#9's (with ``forward`` #7's) device time per MOD training geometry
    for the package under ``root``; with a phases build, its cycles a warp
    and chunk."""
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
    kernel, phases = ("#7", FWD_PHASES) if forward else ("#9", PHASES)
    cfg = load_yaml(os.path.join(root, "focal_tpu_torch", "configs", "MOD.yaml"))
    total = 0.0
    for i, g in enumerate(cs.attention_geometries(cfg, 2 * cs.TRAIN_BATCH, "MOD")):
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
                f"{p} {c[j] // max(c[8], 1)}" for j, p in enumerate(phases))
        print(line, flush=True)
    print(f"[{name}] one MOD step (16 launches): {kernel} {total:.3f} ms of device time",
          flush=True)


def main():
    if sys.argv[1:2] == ["--child"]:
        measure(sys.argv[2], sys.argv[3], sys.argv[4:5] == ["--forward"])
        return
    forward = sys.argv[1:2] == ["--forward"]
    patches = ((patch_fwd_staging, patch_fwd_phases) if forward
               else (patch_staging, patch_phases))
    roots = {"tree": HERE, "staging": build_copy("staging", patches[0]),
             "phases": build_copy("phases", patches[1])}
    for name, root in roots.items():
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", name, root]
                       + (["--forward"] if forward else []), check=True)


if __name__ == "__main__":
    main()
