"""The port's kernel build (``ops/_build.py``) without a CUDA toolkit: a
stand-in nvcc shows that every source not yet built gets its own compiler
run, all started before any is waited for, that a built library is reused,
and that a failed compile raises with the compiler's output."""

import os
import stat
import time

import pytest

from focal_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
# stand-in nvcc: sleep, then write the -o file unless the source says FAIL
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac
  shift
done
echo "ptxas info    : Used 32 registers ($src)"
sleep 1
if grep -q FAIL "$src"; then echo "error in $src"; exit 2; fi
echo built > "$out"
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return csrc


def test_sources_build_in_parallel_and_are_reused(fake_toolkit):
    for name in ("a.cu", "b.cu", "c.cu"):
        (fake_toolkit / name).write_text(f"// {name}\n")
    t0 = time.time()
    libs = _build.build_all(("a.cu", "b.cu", "c.cu"))
    assert time.time() - t0 < 2.5  # three 1 s compiles, run together
    assert all(os.path.isfile(p) for p in libs.values())
    assert "Used 32 registers" in open(_build.log_path("b.cu")).read()
    t0 = time.time()
    assert _build.build_all(("a.cu", "b.cu", "c.cu")) == libs  # built: reused
    assert time.time() - t0 < 0.5
    (fake_toolkit / "b.cu").write_text("// changed\n")
    assert _build.library_path("b.cu") != libs["b.cu"]  # a changed source builds anew


def test_a_failed_compile_raises_with_the_output(fake_toolkit):
    (fake_toolkit / "ok.cu").write_text("// fine\n")
    (fake_toolkit / "bad.cu").write_text("// FAIL\n")
    with pytest.raises(RuntimeError, match="nvcc failed on bad.cu") as err:
        _build.build_all(("ok.cu", "bad.cu"))
    assert "error in" in str(err.value)
    assert os.path.isfile(_build.library_path("ok.cu"))
    assert not os.path.exists(_build.library_path("bad.cu"))
