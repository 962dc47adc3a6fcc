"""The training kernels' phase order at the whole-block widths (#2, #3), in
plain PyTorch, held on the CPU against the plain block and the JAX
package's whole-block Pallas kernels, and the 3xTF32 arithmetic at their
product depths.

#2 and #3 run the phase order of #4 and #5 (csrc/window_block.cu): the
projections over all R = B_ N rows of a call, the attention per (window,
head) pair between them, the weight gradients as fixed row-split partials
summed in split order. ``stages_forward`` and ``stages_backward``
(tests/test_torch_port_perhead_stages.py) write that order out; here they
run at MOD's widths, C = 64, 128, 256 with 4 heads (hd 16, 32, 64), nW 1
and 4, rates 0 and 0.2, with every product through torch.matmul or the
plain emulation of the kernels' tensor-core product
(``gemm_3xtf32_reference``).

Tolerances: y within 1e-5 absolute and each gradient within 1e-5 relative
(max|got - want| / max|want|) of ``fused_window_block_reference`` and its
autograd backward. Against ``_wblock_fwd_impl`` (rate 0: its dropout needs
the TPU PRNG) and ``_wblock_bwd_impl`` (fed the same keep mask) in
interpret mode: 1e-5 at C = 64, where both are f32; 1e-2 at C >= 128,
where the JAX kernel computes in bf16 (``_wblock_compute_dtype``), on
bf16-representable inputs. The emulation is held to the card's f32 gates
at K = 64, 192 and 768 (C, 3C at C = 64; 3C at C = 256: the deepest
product of #2/#3), and one TF32 product is shown to miss them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.ops.pallas_kernels import _wblock_bwd_impl, _wblock_fwd_impl, expand_bias_lanes
from focal_tpu_torch.ops import pallas_kernels as pk
from test_torch_port_perhead_stages import GEMMS, _abs, _case, _torch, stages_backward
from test_torch_port_perhead_stages import stages_forward
from test_torch_port_train_kernel import _jax_keep
from test_torch_port_wide_kernel import NAMES, _rel

WIDTHS = [64, 128, 256]


@pytest.mark.parametrize("gemm", sorted(GEMMS))
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("nW", [1, 4])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_stages_forward_match_the_plain_block(gemm, C, nW, rate):
    arrs, mask, keep = _case(C, nW, rate, 7 * C + nW)
    args, tmask, _, tkeep = _torch(arrs, mask, keep)
    assert pk.wblock_fits(9, C, 4)  # the geometries #2 and #3 serve
    y, ws = stages_forward(*args, tmask, tkeep, rate, gemm=GEMMS[gemm])
    assert _abs(y, pk.fused_window_block_reference(*args, tmask, tkeep, rate)) <= 1e-5
    x, wqkv, bqkv = args[:3]
    assert _abs(ws["qkv"], x.reshape(-1, C) @ wqkv + bqkv) <= 1e-5


@pytest.mark.parametrize("gemm", sorted(GEMMS))
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("nW", [1, 4])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_stages_backward_match_autograd_of_the_plain_block(gemm, C, nW, rate):
    arrs, mask, keep = _case(C, nW, rate, 8 * C + nW)
    args, tmask, dy, tkeep = _torch(arrs, mask, keep)
    got, _ = stages_backward(*args, tmask, dy, tkeep, rate, gemm=GEMMS[gemm])
    want = pk.fused_window_block_backward_reference(*args, tmask, dy, tkeep, rate)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w.numpy()) <= 1e-5, (name, _rel(g.numpy(), w.numpy()))


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("nW", [1, 4])
def test_stages_forward_match_the_jax_kernel(C, nW):
    arrs, mask, _ = _case(C, nW, 0.0, 9 * C + nW)
    args, tmask, _, _ = _torch(arrs, mask, None)
    y, _ = stages_forward(*args, tmask, gemm=pk.gemm_3xtf32_reference)
    x, wqkv, bqkv, wproj, bproj, rel_bias, _ = arrs
    want = np.asarray(_wblock_fwd_impl(*(jnp.asarray(a) for a in (x, wqkv, bqkv, wproj, bproj)),
                                       expand_bias_lanes(jnp.asarray(rel_bias), mask)),
                      np.float32)
    if C < 128:
        assert float(np.abs(y.numpy() - want).max()) <= 1e-5
    else:
        assert _rel(y.numpy(), want) <= 1e-2


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("nW", [1, 4])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_stages_backward_match_the_jax_kernel(C, nW, rate):
    arrs, mask, keep = _case(C, nW, rate, 10 * C + nW)
    args, tmask, dy, tkeep = _torch(arrs, mask, keep)
    got, _ = stages_backward(*args, tmask, dy, tkeep, rate, gemm=pk.gemm_3xtf32_reference)
    B, N = 8, 9
    x, wqkv, bqkv, wproj, bproj, rel_bias, dyn = arrs
    want = _wblock_bwd_impl(
        *(jnp.asarray(a) for a in (x, wqkv, bqkv, wproj, bproj)),
        expand_bias_lanes(jnp.asarray(rel_bias), mask), jnp.asarray(dyn),
        mask=None if keep is None else _jax_keep(keep, N, C, B), rate=rate)
    want = [np.asarray(w, np.float32) for w in want]
    want[5] = want[5].sum(-1)  # d bias_l [H, N, N, 128] -> d rel_bias
    tol = 1e-5 if C < 128 else 1e-2
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= tol, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("K", [64, 192, 768])
def test_3xtf32_emulation_holds_the_gates_at_whole_block_depths(K):
    """MOD-scaled products (unit activations, weights of std K**-0.5):
    3xTF32 meets the card's gates (1e-4 absolute on O(1) outputs, 1e-5
    relative), one TF32 product misses the relative one."""
    rng = np.random.default_rng(K + 1)
    a = rng.normal(size=(512, K)).astype(np.float32)
    b = (rng.normal(size=(K, 512)) * K**-0.5).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    three = pk.gemm_3xtf32_reference(torch.from_numpy(a), torch.from_numpy(b)).double().numpy()
    one = pk.gemm_3xtf32_reference(torch.from_numpy(a), torch.from_numpy(b), passes=1)
    one = one.double().numpy()
    assert np.abs(three - exact).max() <= 1e-4 and _rel(three, exact) <= 1e-5
    assert _rel(one, exact) > 2e-4
