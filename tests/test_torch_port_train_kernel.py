"""Plain versions of the training kernels (#2 forward with attention
dropout, #3 backward) against the JAX package on the CPU, and the CPU side
of their wrappers.

#3's plain version (autograd through fused_window_block_reference with a
keep mask) is held against ``focal_tpu.ops.pallas_kernels._wblock_bwd_impl``
run in interpret mode, fed the same explicit keep mask: the port's uint8
[B_, H, N, N] becomes the JAX [H, N, N, Bp] bf16 lane layout, padded to
``_block_tile(N, C, B_)``. The JAX forward's dropout needs the TPU PRNG, but
this backward needs none, so dx and every weight gradient are checked with
dropout on. Inputs are drawn as bf16-representable f32 values, so the JAX
kernel's cast of its inputs to bf16 at C >= 128 (``_wblock_compute_dtype``)
loses nothing and the comparison is of the algorithm. Tolerance, as
max|port - jax| / max|jax| per gradient: 2e-5 at C = 64 (both f32,
summation order only); 6e-3 at C = 256, where the JAX kernel still rounds
its intermediates (dq, dk, dv, the attention output) to bf16.

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_port_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.swin import shifted_window_mask
from focal_tpu.ops.pallas_kernels import _block_tile, _wblock_bwd_impl, expand_bias_lanes
from focal_tpu_torch.ops import pallas_kernels as pk
from focal_tpu_torch.ops.dropout import StepRngs


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _inputs(rng, B, N, C, H, nW):
    """Inputs at a trained model's scale (weights std C**-0.5), each value
    representable in bf16."""
    shapes = [(B, N, C), (C, 3 * C), (3 * C,), (C, C), (C,), (H, N, N), (B, N, C)]
    scales = [1.0, C**-0.5, 0.1, C**-0.5, 0.1, 0.02, 1.0]
    arrs = [_bf16_exact(rng.normal(size=s) * k) for s, k in zip(shapes, scales)]
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if nW == 4 else None
    assert mask is None or mask.shape[0] == nW
    return arrs, mask


def _jax_keep(keep, N, C, B):
    """uint8 [B, H, N, N] -> bf16 [H, N, N, Bp], zero-padded lanes."""
    tile = _block_tile(N, C, B)
    Bp = -(-B // tile) * tile
    lanes = np.zeros(keep.shape[1:] + (Bp,), np.float32)
    lanes[..., :B] = keep.transpose(1, 2, 3, 0)
    return jnp.asarray(lanes, jnp.bfloat16)


@pytest.mark.parametrize("C,nW,rate", [
    (64, 1, 0.0), (64, 4, 0.2), (64, 1, 0.2), (256, 4, 0.0), (256, 4, 0.2),
])
def test_plain_backward_matches_jax_kernel(C, nW, rate):
    B, N, H = 128, 9, 4
    rng = np.random.default_rng(C + nW + int(rate * 10))
    (x, wqkv, bqkv, wproj, bproj, rel_bias, dy), mask = _inputs(rng, B, N, C, H, nW)
    keep = None
    if rate:
        keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8)
    t = [torch.from_numpy(a) for a in (x, wqkv, bqkv, wproj, bproj, rel_bias)]
    got = pk.fused_window_block_backward(
        *t, None if mask is None else torch.from_numpy(mask), torch.from_numpy(dy),
        None if keep is None else torch.from_numpy(keep), rate)

    bias_l = expand_bias_lanes(jnp.asarray(rel_bias), mask)
    want = _wblock_bwd_impl(
        *(jnp.asarray(a) for a in (x, wqkv, bqkv, wproj, bproj)), bias_l, jnp.asarray(dy),
        mask=None if keep is None else _jax_keep(keep, N, C, B), rate=rate)
    want = [np.asarray(w, np.float32) for w in want]
    want[5] = want[5].sum(-1)  # d bias_l [H, N, N, 128] -> d rel_bias
    tol = 2e-5 if C < 128 else 6e-3
    for name, g, w in zip(["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"], got, want):
        g = g.numpy()
        assert g.shape == w.shape, name
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= tol, (name, rel)


def test_plain_dropout_forward_applies_the_mask():
    """keep all ones is the plain block scaled through the attention; keep
    all zeros leaves only the output bias."""
    rng = np.random.default_rng(1)
    B, N, C, H = 6, 9, 16, 2
    (x, wqkv, bqkv, wproj, bproj, rel_bias, _), _ = _inputs(rng, B, N, C, H, 1)
    t = [torch.from_numpy(a) for a in (x, wqkv, bqkv, wproj, bproj, rel_bias)]
    ones = torch.ones(B, H, N, N, dtype=torch.uint8)
    base = pk.fused_window_block_reference(*t)
    rate = 0.25
    scaled = pk.fused_window_block_dropout_reference(*t, None, ones, rate)
    # all kept: attention weights scaled by 1/(1-rate), so the attention
    # output part of y is scaled too
    ao_part = base - t[4]
    torch.testing.assert_close(scaled - t[4], ao_part / (1 - rate), rtol=1e-5, atol=1e-5)
    zeros = pk.fused_window_block_dropout_reference(*t, None, torch.zeros_like(ones), rate)
    torch.testing.assert_close(zeros, t[4].expand_as(zeros), rtol=0, atol=0)


def test_cpu_dropout_wrapper_keep_rate_and_seed():
    """On the CPU the dropout wrapper draws its mask with torch's generator:
    keep rate within 5 sigma of 1 - rate; same seed, same mask; no launch
    counted."""
    rng = np.random.default_rng(2)
    B, N, C, H = 400, 9, 16, 4
    (x, wqkv, bqkv, wproj, bproj, rel_bias, _), _ = _inputs(rng, B, N, C, H, 1)
    t = [torch.from_numpy(a) for a in (x, wqkv, bqkv, wproj, bproj, rel_bias)]
    before = pk.fused_window_block_dropout.launches
    y1, k1 = pk.fused_window_block_dropout(*t, None, 5, 0.2)
    y2, k2 = pk.fused_window_block_dropout(*t, None, 5, 0.2)
    _, k3 = pk.fused_window_block_dropout(*t, None, 6, 0.2)
    assert pk.fused_window_block_dropout.launches == before
    assert k1.dtype == torch.uint8 and k1.shape == (B, H, N, N)
    assert torch.equal(k1, k2) and torch.equal(y1, y2) and not torch.equal(k1, k3)
    n = k1.numel()
    assert abs(float(k1.double().mean()) - 0.8) <= 5 * (0.16 / n) ** 0.5


def test_window_block_function_matches_autograd_of_plain():
    """window_block (the autograd pair) on CPU tensors: forward and all six
    gradients equal autograd through the plain block with the same mask."""
    rng = np.random.default_rng(3)
    B, N, C, H = 20, 9, 16, 2
    (x, wqkv, bqkv, wproj, bproj, rel_bias, dy), _ = _inputs(rng, B, N, C, H, 1)
    mask = torch.from_numpy(shifted_window_mask(6, 6, 3, 3, 1, 1))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, wqkv, bqkv, wproj, bproj, rel_bias)]
    y = pk.window_block(*leaves, mask, seed=9, rate=0.2)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    keep = pk.draw_keep_mask(9, (B, H, N, N), 0.2, "cpu")
    ref_leaves = [l.detach().clone().requires_grad_(True) for l in leaves]
    ref = pk.fused_window_block_reference(*ref_leaves, mask, keep, 0.2)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    want = torch.autograd.grad(ref, ref_leaves, torch.from_numpy(dy))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    # rate 0: the #1 forward, no mask
    y0 = pk.window_block(*leaves, mask, rate=0.0)
    torch.testing.assert_close(y0, pk.fused_window_block_reference(*leaves, mask), rtol=0, atol=0)


def test_window_block_reference_stands_in_for_window_block(monkeypatch):
    """A Swin block in training with its window_block swapped for the plain
    version (as chip_smoke.py's kernel-vs-plain step does): the same output
    and parameter gradients on the CPU, where both draw the same mask."""
    from focal_tpu_torch.models import swin

    torch.manual_seed(0)
    blk = swin.SwinBlock(16, (6, 6), 2, (3, 3), (1, 1), attn_drop=0.2).train()
    x = torch.randn(2, 36, 16)
    runs = []
    for fn in (pk.window_block, pk.window_block_reference):
        monkeypatch.setattr(swin, "window_block", fn)
        blk.zero_grad()
        rng = StepRngs(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
        y = blk(x, rng)
        y.square().sum().backward()
        runs.append((y.detach(), {n: p.grad.clone() for n, p in blk.named_parameters()}))
    (y1, g1), (y2, g2) = runs
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    for n in g1:
        torch.testing.assert_close(g1[n], g2[n], rtol=1e-6, atol=1e-6, msg=n)


def test_keep_threshold_is_the_tpu_kernels():
    assert pk._keep_threshold(0.2) == int(np.uint32(0.2 * 4294967296.0))
    assert pk._keep_threshold(0.999999999999) == 2**32 - 1
