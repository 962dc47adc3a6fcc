"""The attention-only forward's phase order (#6, #7) and the route around
it, on the CPU.

#6 and #7 (csrc/window_attention.cu) walk chunks of P (window, head) pairs
with a persistent grid (block b takes chunks b, b + grid, ...), each
chunk's q, k and v staged in a ring slot, q scaled there by the caller's
``q_scale``; per query row the scores, softmax and dropout, then the output
row written at the caller's strides: the head view of one [B_, N, C]
tensor, the proj Linear's input. ``stages_attention_forward`` writes that
order out in plain PyTorch; here it runs at N 9, hd 16/32/64, 4 heads,
window batches that end in a ragged chunk, shifted and unshifted, against
the JAX ``fused_window_attention`` (its Pallas kernel in interpret mode) at
rate 0 and the TPU kernels' dropout math (``_jax_dropout``) fed the same
numpy keep mask at rate 0.2.

The route (``window_attention_qkv`` in training, ``fused_window_attention``
in eval) passes q unscaled with its scale and an ``out`` view: its output
is a view of a [B_, N, C] tensor, no scaled q is saved for the backward,
and the output and gradients equal the plain route's (q * scale, then the
attention, then the output laid out for the proj Linear).

Tolerances (f32 on both sides, summation order only): outputs 1e-5
absolute, gradients 1e-5 relative (max|got - want| / max|want|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.ops.pallas_kernels import expand_bias_lanes
from focal_tpu.ops.pallas_kernels import fused_window_attention as jax_fused_window_attention
from focal_tpu_torch.models import swin as tswin
from focal_tpu_torch.ops import pallas_kernels as pk
from test_torch_port_attention_kernel import _inputs, _jax_dropout
from test_torch_port_attention_stages import ATTN_STAGE_GEOMETRIES, attention_plan


def stages_attention_forward(q, k, v, rel_bias, mask, keep, rate, q_scale, grid):
    """#6/#7's order for q (unscaled: each chunk's staged rows are scaled in
    place by ``q_scale``), k, v [B_, H, N, hd], ``keep`` (uint8 [B_, H, N,
    N]) or None. Returns the [B_, N, C] tensor whose head view the chunks
    write, row by row."""
    B, H, N, hd = q.shape
    _, P = attention_plan(B, H, N, hd, forward=True)
    total = B * H
    nchunks = -(-total // P)
    y = torch.full((B, N, H * hd), float("nan"))
    out = y.view(B, N, H, hd).transpose(1, 2)  # the caller's strides
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    for b in range(grid):
        for chunk in range(b, nchunks, grid):
            pairs = torch.arange(chunk * P, min(total, (chunk + 1) * P))
            w, h = pairs // H, pairs % H
            qc, kc, vc = (t[w, h] for t in (q, k, v))  # the ring slot's rows
            qc.mul_(q_scale)
            s = qc @ kc.transpose(-1, -2) + rel_bias[h]
            if mask is not None:
                s = s + mask[w % mask.shape[0]]
            p = torch.softmax(s, dim=-1)
            if keep is not None:
                p = torch.where(keep[w, h].bool(), p * inv_keep, 0.0)
            out[w, h] = p @ vc
    assert not torch.isnan(y).any()
    return y


def _laid_out(a):
    """[B_, H, N, hd] as the proj Linear's [B_, N, C]."""
    B, H, N, hd = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B, N, H * hd)


def _unscaled(rng, B, H, N, hd):
    """q before the scale, and q * scale as numpy's f32 multiply rounds it
    (torch's q * scale rounds the same)."""
    q = rng.normal(size=(B, H, N, hd)).astype(np.float32)
    return q, q * np.float32(hd**-0.5)


def test_forward_plan_at_the_mod_widths():
    """The forward's ring (q, k, v) fits at make_geo's pairs at every MOD and
    MOD_WIDE width, the backward's plan alike; a head of 63 float4 columns
    (one lane a row, 28 pairs) shrinks to what fits."""
    for hd in (16, 32, 64, 128, 256):
        assert attention_plan(512, 4, 9, hd, forward=True) == attention_plan(512, 4, 9, hd)
    assert attention_plan(512, 4, 16, 256, forward=True) == (8, 2)
    assert attention_plan(5, 4, 9, 252, forward=True) == (1, 4)
    assert attention_plan(5, 4, 9, 252) == (1, 3)


@pytest.mark.parametrize("B,H,N,hd,nW", ATTN_STAGE_GEOMETRIES)
@pytest.mark.parametrize("grid", [1, 3])
def test_forward_stages_match_the_jax_kernel_at_rate_0(B, H, N, hd, nW, grid):
    (_, k, v, _, rel_bias, mask), rng = _inputs(B + hd + nW, B, H, N, hd, nW)
    q, qs = _unscaled(rng, B, H, N, hd)
    got = stages_attention_forward(*(torch.from_numpy(a) for a in (q, k, v, rel_bias)),
                                   _t(mask), None, 0.0, hd**-0.5, grid)
    bias_l = expand_bias_lanes(jnp.asarray(rel_bias), mask)
    want = jax.jit(jax_fused_window_attention)(*(jnp.asarray(a) for a in (qs, k, v)), bias_l)
    np.testing.assert_allclose(got.numpy(), _laid_out(np.asarray(want)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,H,N,hd,nW", ATTN_STAGE_GEOMETRIES)
def test_forward_stages_match_the_tpu_kernels_math_with_dropout(B, H, N, hd, nW):
    (_, k, v, g, rel_bias, mask), rng = _inputs(B + hd + 2 * nW, B, H, N, hd, nW)
    q, qs = _unscaled(rng, B, H, N, hd)
    rate = 0.2
    keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8)
    got = stages_attention_forward(*(torch.from_numpy(a) for a in (q, k, v, rel_bias)),
                                   _t(mask), torch.from_numpy(keep), rate, hd**-0.5, 3)
    want, _ = _jax_dropout(qs, k, v, g, rel_bias, mask, keep, rate)
    np.testing.assert_allclose(got.numpy(), _laid_out(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_cpu_forwards_take_q_scale_and_out(rate):
    """#6/#7's wrappers on the CPU with ``q_scale`` and ``out``: the plain
    version on q * scale, written into ``out`` and returned as it; the same
    bits as the call on the scaled q; no launch counted."""
    B, H, N, hd, nW = 37, 4, 9, 16, 4
    (_, k, v, _, rel_bias, mask), rng = _inputs(11, B, H, N, hd, nW)
    q, qs = _unscaled(rng, B, H, N, hd)
    args = [_t(a) for a in (k, v, rel_bias, mask)]
    before = [pk.fused_window_attention.launches, pk.fused_window_attention_dropout.launches]
    y = torch.empty((B, N, H * hd))
    view = y.view(B, N, H, hd).transpose(1, 2)
    if rate:
        want = pk.fused_window_attention_dropout(torch.from_numpy(qs), *args, 5, rate)
        got = pk.fused_window_attention_dropout(torch.from_numpy(q), *args, 5, rate,
                                                q_scale=hd**-0.5, out=view)
    else:
        want = pk.fused_window_attention(torch.from_numpy(qs), *args)
        got = pk.fused_window_attention(torch.from_numpy(q), *args, q_scale=hd**-0.5, out=view)
    assert got is view and torch.equal(got, want)
    assert [pk.fused_window_attention.launches,
            pk.fused_window_attention_dropout.launches] == before


def _function_node(y):
    """The _WindowAttentionQKV node under the views window_attention_qkv
    returns."""
    node = y.grad_fn
    while node is not None and type(node).__name__ != "_WindowAttentionQKVBackward":
        node = node.next_functions[0][0]
    assert node is not None
    return node


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_route_function_saves_no_scaled_q_and_writes_the_proj_layout(hd, rate):
    """window_attention_qkv on the CPU: its output is the head view of a
    contiguous [B_, N, C] tensor (laid out for the proj Linear without a
    copy); it saves qkv, rel_bias and the mask only; output, d(qkv) and d
    rel_bias equal the plain route's (q * scale before the attention)."""
    B, H, N, nW = 37, 4, 9, 4
    rng = np.random.default_rng(hd + 1)
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * hd)).astype(np.float32))
    rel_bias = torch.from_numpy((0.02 * rng.normal(size=(H, N, N))).astype(np.float32))
    mask = _t(_inputs(0, 1, H, N, hd, nW)[0][5])
    gy = torch.from_numpy(rng.normal(size=(B, N, H * hd)).astype(np.float32))
    leaves = [qkv.clone().requires_grad_(True), rel_bias.clone().requires_grad_(True)]
    out = pk.window_attention_qkv(leaves[0], H, leaves[1], mask, seed=5, rate=rate)
    laid = out.transpose(1, 2).reshape(B, N, H * hd)
    assert out.shape == (B, H, N, hd) and laid._base is not None
    assert laid.is_contiguous() and laid.data_ptr() == out.data_ptr()
    saved = _function_node(out).saved_tensors
    assert [tuple(t.shape) for t in saved] == [(B, N, 3 * H * hd), (H, N, N), (nW, N, N)]
    got = torch.autograd.grad(laid, leaves, gy)
    ref_leaves = [qkv.clone().requires_grad_(True), rel_bias.clone().requires_grad_(True)]
    ref = pk.window_attention_qkv_reference(ref_leaves[0], H, ref_leaves[1], mask, 5, rate)
    ref_laid = ref.transpose(1, 2).reshape(B, N, H * hd)
    want = torch.autograd.grad(ref_laid, ref_leaves, gy)
    assert float((laid - ref_laid).detach().abs().max()) <= 1e-5
    for a, w in zip(got, want):
        assert float((a - w).abs().max() / w.abs().max()) <= 1e-5


def test_eval_route_passes_the_scale_and_the_proj_layout(monkeypatch):
    """The eval route calls fused_window_attention once with q unscaled,
    ``q_scale`` hd**-0.5 and ``out`` the head view of a [B_, N, C] tensor;
    the block's output equals the plain route's (q * scale, the attention,
    the output laid out, the proj Linear) within 1e-5."""
    B, N, C, H = 20, 9, 64, 4
    torch.manual_seed(3)
    attn = tswin.WindowAttention(C, (3, 3), H, pallas_block=False).eval()
    with torch.no_grad():
        attn.relative_position_bias_table.normal_(0.0, 0.02)
    x = torch.randn(B, N, C)
    mask = _t(_inputs(0, 1, H, N, C // H, 4)[0][5])
    seen = []
    real = tswin.fused_window_attention

    def spy(q, k, v, rel_bias, mask=None, **kw):
        got = real(q, k, v, rel_bias, mask, **kw)
        seen.append((kw, got))
        return got

    monkeypatch.setattr(tswin, "fused_window_attention", spy)
    with torch.no_grad():
        y = attn(x, mask)
        qkv = attn.qkv(x).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        o = pk.fused_window_attention_reference(qkv[0] * (C // H) ** -0.5, qkv[1], qkv[2],
                                                attn._rel_bias(), mask)
        want = attn.proj(o.transpose(1, 2).reshape(B, N, C))
    assert len(seen) == 1
    kw, out = seen[0]
    assert kw["q_scale"] == (C // H) ** -0.5 and kw["out"] is out
    assert out._base is not None and out._base.shape == (B, N, C) and out._base.is_contiguous()
    assert float((y - want).abs().max()) <= 1e-5


def _t(a):
    return None if a is None else torch.from_numpy(a)
