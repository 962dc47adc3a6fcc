"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``focal_tpu_torch/csrc/`` becomes one shared library with
a plain C interface, compiled for ``sm_90a`` on first use into
``build/focal_tpu_torch/`` beside the package, named by a content hash of
the sources and flags (a changed source builds anew, an unchanged one is
reused). The hash covers the shared headers (``*.cuh``, such as
``philox.cuh``) as well. A failed build raises with nvcc's output. Nothing
here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "focal_tpu_torch")
SOURCES = ("window_block.cu", "window_attention.cu", "conv_tower.cu", "fused_mlp.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded = {}  # source name -> ctypes.CDLL, one load per process


def find_nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin on PATH")


def _digest(source):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path(source):
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{_digest(source)}.so")


def log_path(source):
    """nvcc's output for the last build of `source` (ptxas register and
    shared-memory report included)."""
    return library_path(source)[: -len(".so")] + ".log"


def build_all(sources=SOURCES):
    """Compile every source not yet built, one nvcc run each, all started
    together. Returns {source: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    runs = {}
    for s in sources:
        if os.path.isfile(library_path(s)):
            continue
        tmp = f"{library_path(s)}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, s)]
        runs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True))
    failed = []
    for s, (tmp, proc) in runs.items():
        out = proc.communicate()[0]
        with open(log_path(s), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            failed.append(f"nvcc failed on {s} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, library_path(s))  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return {s: library_path(s) for s in sources}


def load(source):
    """ctypes handle of the library built from `source`, building it first
    when needed."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(build_all((source,))[source])
        _loaded[source] = lib
    return lib
