"""The bf16 forms of the whole-block kernels (#1-bf16, #2-bf16, #3-bf16):
their plain versions against the JAX package's kernels fed bf16, on the
CPU, and the CPU side of their wrappers and routes.

``focal_tpu.ops.pallas_kernels.fused_window_block`` and ``_wblock_bwd_impl``
run in interpret mode here with bf16 x, wqkv and wproj (f32 biases and bias
table) and give a bf16 y and dx, as the JAX package's SW_Transformer at
``-compute_dtype bfloat16`` calls them. The port's plain versions
(``fused_window_block_bf16_reference``,
``fused_window_block_backward_bf16_reference``) round at the same points;
the same numpy-seeded inputs go to both, at MOD's three stage geometries
(N 9, C 64/128/256, 4 heads) with and without the shift mask. #2-bf16 has
no JAX counterpart off the TPU (its dropout draws the TPU's bits), so it is
held at rate -> 0 (every weight kept) against JAX's rate-0 forward, and its
backward (#3-bf16 with a stored mask) against ``_wblock_bwd_impl`` fed the
same keep mask.

Tolerances, as max|port - jax| / max|jax|: the forward 1e-2 (measured
<= 3.1e-3: a y element one bf16 step, 2^-8, off where the two f32 sums
round to either side); each gradient 2e-2 (measured <= 1.6e-3 for dx, in
bf16, and <= 6.2e-4 for the f32 weight gradients: dq, dk, dv rounded to
bf16 before the products flip the same way).

The CUDA kernels are held against these plain versions on the card
(``tests/test_torch_port_gpu.py``, ``chip_smoke.py`` phase 29).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.swin import shifted_window_mask
from focal_tpu.ops.pallas_kernels import (_block_tile, _wblock_bwd_impl, expand_bias_lanes,
                                          fused_window_block)
from focal_tpu_torch.ops import pallas_kernels as pk

FWD_TOL = 1e-2
GRAD_TOL = 2e-2
GEOMETRIES = [(64, 1, 0.0), (64, 4, 0.2), (128, 4, 0.2), (128, 1, 0.0), (256, 4, 0.0),
              (256, 1, 0.2)]
GRAD_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias")


def _inputs(C, nW, B=32, N=9, H=4):
    """Numpy-seeded inputs at a trained model's scale; the JAX package's
    (bf16 x, wqkv, wproj, dy; f32 biases and lane-expanded bias table) and
    the port's (the same values as torch tensors)."""
    rng = np.random.default_rng(C + nW)
    x = rng.normal(size=(B, N, C))
    wqkv = rng.normal(size=(C, 3 * C)) * C**-0.5
    bqkv = rng.normal(size=3 * C) * 0.1
    wproj = rng.normal(size=(C, C)) * C**-0.5
    bproj = rng.normal(size=C) * 0.1
    rel_bias = rng.normal(size=(H, N, N)) * 0.02
    dy = rng.normal(size=(B, N, C))
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if nW == 4 else None
    bf = jnp.bfloat16
    j_x, j_wq, j_wp, j_dy = (jnp.asarray(a, jnp.float32).astype(bf) for a in (x, wqkv, wproj, dy))
    j_f32 = [jnp.asarray(a, jnp.float32) for a in (bqkv, bproj)]
    jax_args = (j_x, j_wq, j_f32[0], j_wp, j_f32[1],
                expand_bias_lanes(jnp.asarray(rel_bias, jnp.float32), mask))

    def to_bf16(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    def to_f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    port_args = (to_bf16(j_x), to_bf16(j_wq), to_f32(bqkv), to_bf16(j_wp), to_f32(bproj),
                 to_f32(rel_bias), None if mask is None else torch.from_numpy(mask))
    return jax_args, j_dy, port_args, to_bf16(j_dy), rng


def _jax_keep(keep, N, C, B):
    """uint8 [B, H, N, N] -> bf16 [H, N, N, Bp], zero-padded lanes."""
    tile = _block_tile(N, C, B)
    Bp = -(-B // tile) * tile
    lanes = np.zeros(keep.shape[1:] + (Bp,), np.float32)
    lanes[..., :B] = keep.transpose(1, 2, 3, 0)
    return jnp.asarray(lanes, jnp.bfloat16)


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("C,nW,rate", GEOMETRIES)
def test_bf16_plain_forward_matches_jax_kernel(C, nW, rate):
    """#1-bf16's plain version, and #2-bf16's at rate -> 0 with every weight
    kept, against the JAX kernel's bf16 forward."""
    jax_args, _, port_args, _, _ = _inputs(C, nW)
    want = fused_window_block(*jax_args)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    y = pk.fused_window_block_bf16_reference(*port_args)
    assert y.dtype == torch.bfloat16 and y.shape == want.shape
    assert _rel(y, want) <= FWD_TOL
    B, N, _ = port_args[0].shape
    ones = torch.ones(B, port_args[5].shape[0], N, N, dtype=torch.uint8)
    y0 = pk.fused_window_block_bf16_reference(*port_args, ones, 1e-7)
    assert _rel(y0, want) <= FWD_TOL


@pytest.mark.parametrize("C,nW,rate", GEOMETRIES)
def test_bf16_plain_backward_matches_jax_kernel(C, nW, rate):
    """#3-bf16's plain version against ``_wblock_bwd_impl`` fed bf16, with a
    stored keep mask (#2-bf16's backward) where rate > 0: dx in bf16, the
    weight, bias and bias-table gradients in f32."""
    jax_args, j_dy, port_args, dy, rng = _inputs(C, nW)
    B, N, _ = port_args[0].shape
    H = port_args[5].shape[0]
    keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8) if rate else None
    want = _wblock_bwd_impl(*jax_args, j_dy, mask=None if keep is None else _jax_keep(keep, N, C, B),
                            rate=rate)
    assert want[0].dtype == jnp.bfloat16
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    want[5] = want[5].sum(-1)  # d bias_l [H, N, N, 128] -> d rel_bias
    got = pk.fused_window_block_backward_bf16_reference(
        *port_args, dy, None if keep is None else torch.from_numpy(keep), rate)
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert tuple(g.shape) == w.shape, name
        assert _rel(g, w) <= GRAD_TOL, name


def test_bf16_wrappers_on_the_cpu_take_the_plain_versions():
    """On CPU tensors #1-bf16, #2-bf16 and #3-bf16 are their plain versions
    (#2-bf16's mask from draw_keep_mask, #2's mask for the same seed) and
    count no launch; the f32 plain versions dispatch a bf16 x to them."""
    _, _, args, dy, _ = _inputs(64, 4, B=8)
    B, N, _ = args[0].shape
    H = args[5].shape[0]
    counts = [k.launches for k in (pk.fused_window_block_bf16, pk.fused_window_block_dropout_bf16,
                                   pk.fused_window_block_backward_bf16)]
    y = pk.fused_window_block_bf16(*args)
    assert torch.equal(y, pk.fused_window_block_bf16_reference(*args))
    assert torch.equal(y, pk.fused_window_block_reference(*args))
    y2, keep = pk.fused_window_block_dropout_bf16(*args, 7, 0.2)
    assert torch.equal(keep, pk.draw_keep_mask(7, (B, H, N, N), 0.2, "cpu"))
    assert torch.equal(y2, pk.fused_window_block_bf16_reference(*args, keep, 0.2))
    got = pk.fused_window_block_backward_bf16(*args, dy, keep, 0.2)
    want = pk.fused_window_block_backward_reference(*args, dy, keep, 0.2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert counts == [k.launches for k in (pk.fused_window_block_bf16,
                                           pk.fused_window_block_dropout_bf16,
                                           pk.fused_window_block_backward_bf16)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_bf16_window_block_gradients_reach_f32_weights_unrounded(rate):
    """window_block on a bf16 x with f32 (folded) weights: y and dx in bf16;
    the weights' gradients in f32, equal to #3-bf16's unrounded ones, as the
    JAX package's VJP hands them through the cast; the plain stand-in
    (window_block_reference) gives the same on the CPU."""
    _, _, args, dy, _ = _inputs(128, 4, B=8)
    x, wq, bq, wp, bp, rb, mask = args
    leaves = [x.clone().requires_grad_(True), wq.float().requires_grad_(True),
              bq.clone().requires_grad_(True), wp.float().requires_grad_(True),
              bp.clone().requires_grad_(True), rb.clone().requires_grad_(True)]
    runs = []
    for fn in (pk.window_block, pk.window_block_reference):
        y = fn(*leaves, mask, seed=3, rate=rate)
        runs.append((y, torch.autograd.grad(y, leaves, dy)))
    (y, grads), (y_ref, grads_ref) = runs
    assert y.dtype == torch.bfloat16 and torch.equal(y, y_ref)
    assert grads[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in grads[1:])
    keep = None
    if rate:
        B, N, _ = x.shape
        keep = pk.draw_keep_mask(3, (B, rb.shape[0], N, N), rate, "cpu")
    want = pk.fused_window_block_backward_bf16_reference(*args, dy, keep, rate)
    for name, g, g_ref, w in zip(GRAD_NAMES, grads, grads_ref, want):
        assert torch.equal(g, w), name
        assert torch.equal(g_ref, w), name


def test_bf16_routes_refuse_the_per_head_geometries():
    """A bf16 block that wblock_fits sends to #4/#5 (MOD_WIDE's C 512 and
    1024) no longer refuses: it takes #4-bf16 and #5-bf16 (ROADMAP A6.3),
    in eval and in training, and gives what their plain versions (the bf16
    plain versions of #1-#3) give, in bf16, its f32 weights' gradients f32;
    nothing runs f32."""
    N, H = 9, 4
    for C in (512, 1024):
        assert not pk.wblock_fits(N, C, H)
        rng = np.random.default_rng(C)
        x = torch.from_numpy(rng.normal(size=(2, N, C)).astype(np.float32)).to(torch.bfloat16)
        w = [torch.from_numpy((rng.normal(size=s) * k).astype(np.float32)) for s, k in
             (((C, 3 * C), C**-0.5), ((3 * C,), 0.1), ((C, C), C**-0.5), ((C,), 0.1),
              ((H, N, N), 0.02))]
        wb = (w[0].to(torch.bfloat16), w[1], w[2].to(torch.bfloat16), w[3], w[4])
        want = pk.fused_window_block_bf16_reference(x, *wb)
        assert torch.equal(pk.window_block_forward(x, *w), want)
        leaves = [x.clone().requires_grad_(True)] + [t.clone().requires_grad_(True) for t in w]
        y = pk.window_block(*leaves)
        assert y.dtype == torch.bfloat16 and torch.equal(y.detach(), want)
        dy = torch.ones_like(y)
        grads = torch.autograd.grad(y, leaves, dy)
        ref = pk.fused_window_block_backward_bf16_reference(x, *wb, None, dy)
        assert grads[0].dtype == torch.bfloat16
        for g, r in zip(grads, ref):
            assert g.dtype == r.dtype and torch.equal(g, r)


def test_bf16_fold_rounds_after_the_q_scale_and_refolds_on_change():
    """In bf16 the served block folds the q scale into the f32 qkv weights
    first and rounds the result to bf16 (as the JAX package's ``(wqkv *
    scale_vec).astype(dtype)``), wproj rounded alike, the biases and bias
    table left f32; the bf16 copies are cached and folded anew after
    load_state_dict or an in-place write."""
    from focal_tpu_torch.models import swin

    C, H = 16, 2
    attn = swin.WindowAttention(C, (3, 3), H, compute_dtype=torch.bfloat16).eval()
    with torch.no_grad():
        for p in attn.parameters():
            p.normal_()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 9, C))).to(torch.bfloat16)
    with torch.inference_mode():
        first = attn.folded_kernel_args()
        y0 = attn(x)
        assert attn.folded_kernel_args() is first
    wqkv, bqkv, wproj, bproj, rel_bias = first
    assert (wqkv.dtype, wproj.dtype) == (torch.bfloat16, torch.bfloat16)
    assert {t.dtype for t in (bqkv, bproj, rel_bias)} == {torch.float32}
    scale = torch.cat([torch.full((C,), (C // H) ** -0.5), torch.ones(2 * C)])
    folded = (attn.qkv.weight.detach() * scale[:, None]).t().to(torch.bfloat16)
    assert torch.equal(wqkv, folded)
    assert torch.equal(wproj, attn.proj.weight.detach().t().to(torch.bfloat16))
    fresh = swin.WindowAttention(C, (3, 3), H, compute_dtype=torch.bfloat16).eval()
    with torch.no_grad():
        for p in fresh.parameters():
            p.normal_()
    attn.load_state_dict(fresh.state_dict())
    with torch.inference_mode():
        assert attn.folded_kernel_args() is not first
        for got, want in zip(attn.folded_kernel_args(), fresh.kernel_args()):
            assert torch.equal(got, want)
        assert torch.equal(attn(x), fresh(x)) and not torch.equal(attn(x), y0)
    with torch.no_grad():
        attn.proj.weight.mul_(2.0)
    with torch.inference_mode():
        assert torch.equal(attn.folded_kernel_args()[2], fresh.kernel_args()[2] * 2)
