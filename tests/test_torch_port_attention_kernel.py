"""Plain versions of the attention-only kernels (#6 forward, #7 forward with
attention dropout, #8 and #9 their backwards) against the JAX package on
the CPU, and the CPU side of their wrappers.

  * #6 and #8: ``fused_window_attention_reference`` and autograd through it
    against ``focal_tpu.ops.pallas_kernels.fused_window_attention`` and its
    ``jax.vjp``, whose Pallas kernels run in interpret mode off the TPU.
    The JAX bias is the 128-lane pattern ``expand_bias_lanes`` builds from
    the same rel_bias and shift mask; its gradient summed over the lanes is
    drel_bias.
  * #7 and #9: their dropout forms need the TPU's PRNG, so the plain
    versions are held against the TPU kernels' own jnp math
    (``_scores_softmax``, ``_weighted_sum``, ``_bwd_math``) on the
    batch-in-lanes layout, fed the same numpy keep mask.

Tolerances (both sides f32; summation order only): the output 1e-5
absolute; dq, dk, dv and drel_bias 1e-5 relative, max|port - jax| /
max|jax| per gradient.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_port_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.swin import shifted_window_mask
from focal_tpu.ops.pallas_kernels import (_bwd_math, _scores_softmax, _weighted_sum,
                                          expand_bias_lanes, fused_window_attention)
from focal_tpu_torch.ops import pallas_kernels as pk

# (windows B_, heads, window tokens N, head width hd, nW): unshifted and
# shifted (nW 4) at the MOD head widths 16 and 64, and one 2x2 window (N 4)
GEOMETRIES = [(128, 2, 9, 16, 1), (64, 2, 9, 16, 4), (32, 4, 9, 64, 4), (36, 2, 4, 16, 4)]


def _inputs(seed, B, H, N, hd, nW):
    """q (pre-scaled by hd**-0.5), k, v, the output gradient g, rel_bias at
    a trained model's scale, and the shift mask of a 6x6 (3x3 windows) or
    4x4 (2x2 windows) grid, or None."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, N, hd)).astype(np.float32) for _ in range(4))
    q *= np.float32(hd**-0.5)
    rel_bias = (0.02 * rng.normal(size=(H, N, N))).astype(np.float32)
    mask = None
    if nW > 1:
        side, w = (6, 3) if N == 9 else (4, 2)
        mask = shifted_window_mask(side, side, w, w, 1, 1)
        assert mask.shape == (nW, N, N)
    return (q, k, v, g, rel_bias, mask), rng


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B,H,N,hd,nW", GEOMETRIES)
def test_plain_forward_and_backward_match_jax_kernel(B, H, N, hd, nW):
    (q, k, v, g, rel_bias, mask), _ = _inputs(B + hd + nW, B, H, N, hd, nW)
    out = pk.fused_window_attention(_t(q), _t(k), _t(v), _t(rel_bias), _t(mask)).numpy()
    grads = pk.fused_window_attention_backward(_t(q), _t(k), _t(v), _t(rel_bias), _t(mask), _t(g))

    bias_l = expand_bias_lanes(jnp.asarray(rel_bias), mask)
    want, vjp = jax.vjp(jax.jit(fused_window_attention), *(jnp.asarray(a) for a in (q, k, v)),
                        bias_l)
    np.testing.assert_allclose(out, np.asarray(want), rtol=0, atol=1e-5)
    dq, dk, dv, dbias_l = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    for name, got, w in zip(["dq", "dk", "dv", "drel_bias"], grads, [dq, dk, dv, dbias_l.sum(-1)]):
        assert got.shape == w.shape, name
        assert _rel(got.numpy(), w) <= 1e-5, (name, _rel(got.numpy(), w))


def _jax_dropout(q, k, v, g, rel_bias, mask, keep, rate):
    """#7's output and #9's (dq, dk, dv, drel_bias) in the TPU kernels' jnp,
    head by head on the [N, hd, B_] lane layout, with ``keep`` as their
    mask (``_attn_fwd_dropout_kernel``, ``_attn_bwd_dropout_kernel``)."""
    B, H, N, _ = q.shape
    bias_w = np.zeros((N, N, B), np.float32)
    if mask is not None:
        bias_w = mask[np.arange(B) % mask.shape[0]].transpose(1, 2, 0)
    out, dq, dk, dv, drel = [], [], [], [], []
    for h in range(H):
        ql, kl, vl, gl = (jnp.asarray(a[:, h].transpose(1, 2, 0)) for a in (q, k, v, g))
        bias = jnp.asarray(rel_bias[h][:, :, None] + bias_w)
        kp = jnp.asarray(keep[:, h].transpose(1, 2, 0).astype(bool))
        attn = jnp.where(kp, _scores_softmax(ql, kl, bias) / (1.0 - rate), 0.0)
        out.append(_weighted_sum(attn, vl))
        d = _bwd_math(ql, kl, vl, gl, bias, kp, 1.0 / (1.0 - rate))
        for acc, a in zip((dq, dk, dv), d[:3]):
            acc.append(a)
        drel.append(np.asarray(d[3]).sum(-1))

    def back(parts):  # H x [N, hd, B_] -> [B_, H, N, hd]
        return np.stack([np.asarray(a).transpose(2, 0, 1) for a in parts], axis=1)

    return back(out), (back(dq), back(dk), back(dv), np.stack(drel))


@pytest.mark.parametrize("B,H,N,hd,nW", GEOMETRIES[1:])
def test_plain_dropout_pair_matches_the_tpu_kernels_math(B, H, N, hd, nW):
    (q, k, v, g, rel_bias, mask), rng = _inputs(B + hd, B, H, N, hd, nW)
    rate = 0.2
    keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8)
    args = [_t(a) for a in (q, k, v, rel_bias, mask)]
    out = pk.fused_window_attention_dropout_reference(*args, _t(keep), rate).numpy()
    grads = pk.fused_window_attention_backward_reference(*args, _t(g), _t(keep), rate)
    want_out, want_grads = _jax_dropout(q, k, v, g, rel_bias, mask, keep, rate)
    np.testing.assert_allclose(out, want_out, rtol=0, atol=1e-5)
    for name, got, w in zip(["dq", "dk", "dv", "drel_bias"], grads, want_grads):
        assert got.shape == w.shape, name
        assert _rel(got.numpy(), w) <= 1e-5, (name, _rel(got.numpy(), w))


def test_cpu_wrappers_take_the_plain_versions_and_launch_nothing():
    """On CPU tensors #6-#9 are their plain versions (#7 and #9 with
    draw_keep_mask's mask for the seed, the mask window_attention_keep_mask
    returns there), and no launch is counted."""
    (q, k, v, g, rel_bias, mask), _ = _inputs(1, 8, 2, 9, 16, 4)
    args = [_t(a) for a in (q, k, v, rel_bias, mask)]
    kernels = (pk.fused_window_attention, pk.fused_window_attention_dropout,
               pk.fused_window_attention_backward, pk.fused_window_attention_dropout_backward)
    before = [f.launches for f in kernels]
    keep = pk.window_attention_keep_mask(5, 8, 2, 9, 0.2, "cpu")
    assert keep.dtype == torch.uint8 and keep.shape == (8, 2, 9, 9)
    assert torch.equal(keep, pk.draw_keep_mask(5, (8, 2, 9, 9), 0.2, "cpu"))
    torch.testing.assert_close(pk.fused_window_attention(*args),
                               pk.fused_window_attention_reference(*args), rtol=0, atol=0)
    torch.testing.assert_close(pk.fused_window_attention_dropout(*args, 5, 0.2),
                               pk.fused_window_attention_reference(*args, keep, 0.2), rtol=0, atol=0)
    for got, want in zip(pk.fused_window_attention_backward(*args, _t(g), seed=5, rate=0.2),
                         pk.fused_window_attention_backward_reference(*args, _t(g), keep, 0.2)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [f.launches for f in kernels] == before
    with pytest.raises(ValueError, match="rate"):
        pk.fused_window_attention_dropout(*args, 5, 0.0)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_window_attention_function_matches_autograd_of_plain(rate):
    """The autograd pair on the qkv projection's output (as the Swin block
    hands it over): its output and its gradients in qkv and rel_bias equal
    autograd through the plain version with the same mask."""
    rng = np.random.default_rng(3)
    B, H, N, hd = 20, 2, 9, 8
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * hd)).astype(np.float32))
    rel_bias = torch.from_numpy((0.02 * rng.normal(size=(H, N, N))).astype(np.float32))
    mask = torch.from_numpy(shifted_window_mask(6, 6, 3, 3, 1, 1))
    g = torch.from_numpy(rng.normal(size=(B, H, N, hd)).astype(np.float32))
    runs = []
    for fn in (pk.window_attention_qkv, pk.window_attention_qkv_reference):
        leaves = [qkv.clone().requires_grad_(True), rel_bias.clone().requires_grad_(True)]
        y = fn(leaves[0], H, leaves[1], mask, seed=9, rate=rate)
        runs.append((y.detach(), torch.autograd.grad(y, leaves, g)))
    (y1, g1), (y2, g2) = runs
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
