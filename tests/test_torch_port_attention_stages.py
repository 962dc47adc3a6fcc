"""The attention-only backward's phase order (#8, #9), #1 on the row-tiled
forward, and the routes at the widths no kernel takes, on the CPU.

#8 and #9 (csrc/window_attention.cu) walk chunks of P (window, head) pairs
with a persistent grid (block b takes chunks b, b + grid, ...); per chunk
they compute each query row's softmax, d_attn, ds and dq (times the q
scale), then each key row's dk and dv, and add the chunk's ds to the
block's d rel_bias per head in pair order; one ordered pass adds the
blocks' partials. The route's backward writes d(qkv) as one [B_, N, 3C]
tensor. ``stages_attention_backward`` writes that order out in plain
PyTorch; here it runs at N 9, hd 16/32/64, 4 heads, window batches that
end in a ragged chunk, shifted and unshifted, against the JAX
``fused_window_attention`` VJP (its Pallas kernels in interpret mode) at
rate 0 and the TPU kernels' ``_bwd_math`` fed the same numpy keep mask at
rate 0.2. #1 runs #2's row-tiled forward at rate 0: the plain block equals
that phase order (``stages_forward``) with f32 and 3xTF32 products.

Each fused route has a gate that copies the JAX package's (``mlp_fits``,
``tower_fits``, ``wblock_fits``) and a gate the port routes by
(``mlp_takes``, ``tower_takes``, ``wblock_takes``, ``attention_takes``):
the JAX gate where the CUDA kernels take the width. Where they do not (C
or H not a multiple of 4, N above 16, heads too wide), the block runs what
it would with the flag off: the MLP's Linears, the conv block's cuDNN
convs, and for window attention the JAX package's XLA route in plain
PyTorch (``WindowAttention._plain_attention``). The JAX package runs its
kernel there; no packaged recipe has such a width.

Tolerances (f32 on both sides, summation order only): d(qkv) and
d rel_bias 1e-5 relative (max|got - want| / max|want|); outputs 1e-5
absolute, also against the JAX kernel in interpret mode at the narrow
widths no kernel of the port takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.swin import WindowAttention as JaxWindowAttention
from focal_tpu.models.swin import shifted_window_mask
from focal_tpu.ops.conv_tower import tower_fits as jax_tower_fits
from focal_tpu.ops.pallas_kernels import expand_bias_lanes
from focal_tpu.ops.pallas_kernels import fused_window_attention as jax_fused_window_attention
from focal_tpu.ops.pallas_kernels import fused_window_block as jax_fused_window_block
from focal_tpu.ops.pallas_kernels import mlp_fits as jax_mlp_fits
from focal_tpu.ops.pallas_kernels import wblock_fits as jax_wblock_fits
from focal_tpu_torch.models import swin as tswin
from focal_tpu_torch.models.layers import ConvBlock
from focal_tpu_torch.ops import conv_tower as ct
from focal_tpu_torch.ops import fused_mlp as fm
from focal_tpu_torch.ops import pallas_kernels as pk
from focal_tpu_torch.weights import params_from_flax
from test_torch_port_attention_kernel import _inputs, _jax_dropout
from test_torch_port_perhead_stages import GEMMS, _abs, _case, _torch, stages_forward

# ---------------------------------------------------------------------------
# #8 and #9: the phase order of the persistent, ring-staged backward

THREADS, MAX_LANES, SMEM_OPTIN = 256, 8, 232448  # csrc/window_rows.cuh; the H100's opt-in


def attention_plan(B, H, N, hd, forward=False):
    """(lanes G, pairs P a chunk) as focal::make_geo and the launch plans
    set them: G a power of two up to 8 dividing the float4 columns with two
    columns a lane; P = 256 / (N G), fewer where the two-slot ring (q, k, v
    rows in the forward; q, k, v, g rows, ds, a_v and the block's d
    rel_bias in the backward) does not fit a block's shared memory."""
    c4 = -(-hd // 4)
    lanes = 1
    while 2 * lanes <= MAX_LANES and c4 % (2 * lanes) == 0 and 4 * lanes <= c4:
        lanes *= 2
    pairs = max(1, THREADS // (N * lanes))
    stride = 4 * c4 + 4

    def floats(p):
        if forward:
            return 6 * p * N * stride
        return 8 * p * N * stride + (2 * p + H) * N * N

    while pairs > 1 and 4 * floats(pairs) > SMEM_OPTIN:
        pairs -= 1
    return lanes, pairs


def stages_attention_backward(q, k, v, g, rel_bias, mask, keep, rate, dq_scale, grid,
                              q_scale=1.0):
    """#8/#9's phase order: (d(qkv) [B_, N, 3C] with dq times ``dq_scale``,
    drel_bias [H, N, N]) for q times ``q_scale`` (each chunk's staged rows
    scaled in place, as the kernel scales its ring slot), k, v, g [B_, H,
    N, hd]."""
    B, H, N, hd = q.shape
    _, P = attention_plan(B, H, N, hd)
    total = B * H
    nchunks = -(-total // P)
    grads = torch.zeros(3, B, H, N, hd)
    partials = []
    for b in range(grid):
        dacc = torch.zeros(H, N, N)
        for chunk in range(b, nchunks, grid):
            pairs = torch.arange(chunk * P, min(total, (chunk + 1) * P))
            w, h = pairs // H, pairs % H
            qc, kc, vc, gc = (t[w, h] for t in (q, k, v, g))
            if q_scale != 1.0:
                qc.mul_(q_scale)
            s = qc @ kc.transpose(-1, -2) + rel_bias[h]
            if mask is not None:
                s = s + mask[w % mask.shape[0]]
            p = torch.softmax(s, dim=-1)
            da = gc @ vc.transpose(-1, -2)
            a_v = p
            if keep is not None:
                kp = keep[w, h].bool()
                a_v = torch.where(kp, p / (1.0 - rate), 0.0)
                da = torch.where(kp, da / (1.0 - rate), 0.0)
            ds = p * (da - (da * p).sum(-1, keepdim=True))
            grads[0, w, h] = (ds @ kc) * dq_scale
            grads[1, w, h] = ds.transpose(-1, -2) @ qc
            grads[2, w, h] = a_v.transpose(-1, -2) @ gc
            for pl in range(len(pairs)):  # pair order, each head's running sum
                dacc[h[pl]] = dacc[h[pl]] + ds[pl]
        partials.append(dacc)
    drel_bias = torch.zeros(H, N, N)
    for part in partials:  # block order, as reduce_partials_kernel
        drel_bias = drel_bias + part
    return grads.permute(1, 3, 0, 2, 4).reshape(B, N, 3 * H * hd), drel_bias


def _laid(dq, dk, dv, scale):
    """[B_, H, N, hd] gradients as the route's d(qkv) [B_, N, 3C]."""
    B, H, N, hd = dq.shape
    return np.stack([dq * np.float32(scale), dk, dv]).transpose(1, 3, 0, 2, 4).reshape(
        B, N, 3 * H * hd)


ATTN_STAGE_GEOMETRIES = [(37, 4, 9, 16, 1), (37, 4, 9, 16, 4), (29, 4, 9, 32, 4),
                         (13, 4, 9, 64, 1), (13, 4, 9, 64, 4)]


def test_attention_plan_at_the_mod_widths():
    """hd 16, 32, 64 take 2, 4 and 8 lanes a query row and 14, 7 and 3 pairs
    a chunk; every test geometry ends in a ragged chunk."""
    assert [attention_plan(512, 4, 9, hd) for hd in (16, 32, 64)] == [(2, 14), (4, 7), (8, 3)]
    assert attention_plan(67, 4, 9, 256) == (8, 3)
    for B, H, N, hd, _ in ATTN_STAGE_GEOMETRIES:
        assert (B * H) % attention_plan(B, H, N, hd)[1] != 0


@pytest.mark.parametrize("B,H,N,hd,nW", ATTN_STAGE_GEOMETRIES)
@pytest.mark.parametrize("grid", [1, 3])
def test_attention_stages_match_the_jax_kernel_at_rate_0(B, H, N, hd, nW, grid):
    (q, k, v, g, rel_bias, mask), _ = _inputs(B + hd + nW, B, H, N, hd, nW)
    scale = hd**-0.5
    got, drb = stages_attention_backward(*(torch.from_numpy(a) for a in (q, k, v, g, rel_bias)),
                                         _t(mask), None, 0.0, scale, grid)
    bias_l = expand_bias_lanes(jnp.asarray(rel_bias), mask)
    _, vjp = jax.vjp(jax.jit(jax_fused_window_attention), *(jnp.asarray(a) for a in (q, k, v)),
                     bias_l)
    dq, dk, dv, dbias_l = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    assert _rel(got.numpy(), _laid(dq, dk, dv, scale)) <= 1e-5
    assert _rel(drb.numpy(), dbias_l.sum(-1)) <= 1e-5


@pytest.mark.parametrize("B,H,N,hd,nW", ATTN_STAGE_GEOMETRIES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_stages_scale_q_as_the_caller_did(B, H, N, hd, nW, rate):
    """q unscaled with ``q_scale``: the same bits as the call on q * scale
    (the route's q, scaled in the kernel and never saved)."""
    (_, k, v, g, rel_bias, mask), rng = _inputs(B + hd + 3 * nW, B, H, N, hd, nW)
    q = rng.normal(size=(B, H, N, hd)).astype(np.float32)
    keep = torch.from_numpy((rng.random((B, H, N, N)) >= rate).astype(np.uint8)) if rate else None
    scale = hd**-0.5
    rest = [torch.from_numpy(a) for a in (k, v, g, rel_bias)]
    want = stages_attention_backward(torch.from_numpy(q * np.float32(scale)), *rest, _t(mask), keep,
                                     rate, scale, 3)
    got = stages_attention_backward(torch.from_numpy(q), *rest, _t(mask), keep, rate, scale, 3,
                                    q_scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("B,H,N,hd,nW", ATTN_STAGE_GEOMETRIES)
def test_attention_stages_match_the_tpu_kernels_math_with_dropout(B, H, N, hd, nW):
    (q, k, v, g, rel_bias, mask), rng = _inputs(B + hd + 2 * nW, B, H, N, hd, nW)
    rate, scale = 0.2, hd**-0.5
    keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8)
    got, drb = stages_attention_backward(*(torch.from_numpy(a) for a in (q, k, v, g, rel_bias)),
                                         _t(mask), torch.from_numpy(keep), rate, scale, 3)
    _, (dq, dk, dv, drel) = _jax_dropout(q, k, v, g, rel_bias, mask, keep, rate)
    assert _rel(got.numpy(), _laid(dq, dk, dv, scale)) <= 1e-5
    assert _rel(drb.numpy(), drel) <= 1e-5


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_route_function_writes_the_qkv_layout(hd, rate):
    """window_attention_qkv on the CPU (the route's autograd pair, the
    plain versions inside): its d(qkv) and d rel_bias against the stage
    emulation fed draw_keep_mask's mask, the one the CPU wrappers draw."""
    B, H, N, nW = 37, 4, 9, 4
    rng = np.random.default_rng(hd)
    qkv = torch.from_numpy(rng.normal(size=(B, N, 3 * H * hd)).astype(np.float32))
    rel_bias = torch.from_numpy((0.02 * rng.normal(size=(H, N, N))).astype(np.float32))
    mask = torch.from_numpy(shifted_window_mask(6, 6, 3, 3, 1, 1))
    gy = torch.from_numpy(rng.normal(size=(B, H, N, hd)).astype(np.float32))
    leaves = [qkv.clone().requires_grad_(True), rel_bias.clone().requires_grad_(True)]
    y = pk.window_attention_qkv(leaves[0], H, leaves[1], mask, seed=5, rate=rate)
    got = torch.autograd.grad(y, leaves, gy)
    q, k, v = qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4).unbind(0)
    keep = pk.draw_keep_mask(5, (B, H, N, N), rate, "cpu") if rate else None
    want = stages_attention_backward(q * hd**-0.5, k, v, gy, rel_bias, mask, keep, rate,
                                     hd**-0.5, 3)
    assert got[0].shape == (B, N, 3 * H * hd)
    for a, w in zip(got, want):
        assert _rel(a.numpy(), w.numpy()) <= 1e-5


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# #1: the row-tiled forward at rate 0


@pytest.mark.parametrize("gemm", sorted(GEMMS))
@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("nW", [1, 4])
def test_window_block_at_rate_0_is_the_row_tiled_forward(gemm, C, nW):
    """fused_window_block (its plain version here) equals #2's phase order
    with no keep mask, which #1 launches on the card: 1e-5 absolute."""
    arrs, mask, _ = _case(C, nW, 0.0, 5 * C + nW)
    args, tmask, _, _ = _torch(arrs, mask, None)
    y, _ = stages_forward(*args, tmask, gemm=GEMMS[gemm])
    assert _abs(pk.fused_window_block(*args, tmask), y) <= 1e-5

# ---------------------------------------------------------------------------
# the gates


def test_mlp_gate_is_the_jax_gate_where_the_kernels_take_the_width():
    for C in range(1, 480):
        for H in (C + 1, 2 * C, 4 * C):
            takes = fm.mlp_takes(C, H)
            assert takes == (jax_mlp_fits(C, H) and C % 4 == 0 and H % 4 == 0), (C, H)
            assert not takes or fm.kernel_refuses(8192, C, H) is None
    assert fm.mlp_takes(384, 1536) and fm.mlp_takes(412, 1648)  # above the old C 256 cap
    assert jax_mlp_fits(6, 24) and not fm.mlp_takes(6, 24)
    assert not fm.mlp_takes(416, 1664) and not jax_mlp_fits(416, 1664)


def test_mlp_routes_by_its_gate():
    assert tswin.Mlp(384, 1536, 384, use_pallas=True).fused
    assert not tswin.Mlp(6, 24, 6, use_pallas=True).fused  # the Linears: no kernel takes C 6
    assert not tswin.Mlp(64, 254, 64, use_pallas=True).fused  # nor H 254


@pytest.mark.parametrize("S,kw", [(20, 3), (20, 5), (9, 5)])
def test_tower_gate_is_the_jax_gate_where_the_kernels_take_the_width(S, kw):
    for R in (40, 5120):
        for C in range(1, 300):
            for cin in (2, 6, C):
                takes = ct.tower_takes(R, S, C, cin, kw_max=kw)
                want = (jax_tower_fits(R, S, C, jnp.float32, kw_max=kw) and C % 4 == 0
                        and C <= ct.MAX_CHANNELS)
                assert takes == want, (R, S, C, cin)
                assert not takes or ct.kernel_refuses(R, S, C, cin) is None
    assert jax_tower_fits(40, 20, 6, jnp.float32, kw_max=3) and not ct.tower_takes(40, 20, 6, 2,
                                                                                   kw_max=3)


def test_conv_block_routes_by_its_gate():
    """A conv block of 6 channels (half of 12) trains through its cuDNN
    convs with ``use_pallas``; one of 64 through the fused tower."""
    for out, fused in ((12, False), (128, True)):
        block = ConvBlock(2, (10, 20), out, [(1, 3), (1, 3)], 2, use_pallas=True).train()
        assert block.fused_geometry(torch.zeros(4, 10, 20, 2)) == fused, out


def test_window_gates_refuse_where_the_kernels_do():
    for N in (4, 9, 16, 17):
        for H in (1, 2, 3, 4):
            for hd in range(1, 2100, 1 if N == 9 else 7):
                C = H * hd
                stride = 4 * (-(-hd // 4)) + 4
                fits = 4 * (4 * N * stride + (2 + H) * N * N) <= 232448
                assert pk.wblock_takes(N, C, H) == (N <= 16 and C % 4 == 0 and fits), (N, C, H)
                assert pk.attention_takes(N, hd) == (N <= 16 and hd % 4 == 0 and hd <= 256)
    assert jax_wblock_fits(9, 6) and not pk.wblock_takes(9, 6, 2)
    assert pk.wblock_takes(9, 1024, 4) and pk.wblock_takes(9, 12, 4)  # hd 3: whole-block only
    assert not pk.attention_takes(9, 3) and not pk.wblock_takes(9, 4096, 1)


# ---------------------------------------------------------------------------
# window attention at a width no kernel takes: the XLA route


def _spy_routes(monkeypatch):
    calls = []
    for name in ("window_attention_qkv", "fused_window_attention", "window_block",
                 "window_block_forward"):
        def spy(*args, _name=name, **kw):
            calls.append(_name)
            raise AssertionError(f"{_name} called at a width no kernel takes")
        monkeypatch.setattr(tswin, name, spy)
    return calls


def _jax_block(C, H, nW, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, 9, C)).astype(np.float32)
    mask = None if nW == 1 else shifted_window_mask(6, 6, 3, 3, 1, 1)
    jax_attn = JaxWindowAttention(dim=C, window_size=(3, 3), num_heads=H, use_pallas=False)
    params = jax.tree_util.tree_map(
        np.asarray, jax_attn.init({"params": jax.random.key(0)}, jnp.asarray(x), mask,
                                  train=False)["params"])
    for k in ("qkv", "proj"):
        params[k]["bias"] = (rng.normal(size=params[k]["bias"].shape) * 0.1).astype(np.float32)
    params["relative_position_bias_table"] = (
        rng.normal(size=params["relative_position_bias_table"].shape) * 0.02).astype(np.float32)
    return x, mask, jax_attn, params


@pytest.mark.parametrize("C,H", [(6, 2), (18, 3)])
@pytest.mark.parametrize("nW", [1, 4])
@pytest.mark.parametrize("pallas_block", [True, False])
def test_window_attention_at_a_width_no_kernel_takes_is_the_jax_kernel(C, H, nW, pallas_block,
                                                                       monkeypatch):
    """C 6 / H 2 and C 18 / H 3 (hd 3 and 6): neither gate admits them, so
    the block runs the XLA route, with either flag; it computes what the
    JAX package's whole-block kernel (interpret mode) computes there."""
    assert not pk.wblock_takes(9, C, H) and not pk.attention_takes(9, C // H)
    x, mask, _, params = _jax_block(C, H, nW, C + nW)
    port = tswin.WindowAttention(C, (3, 3), H, pallas_block=pallas_block).eval()
    port.load_state_dict(params_from_flax(params, {}, {"location_names": ["l"]}), strict=True)
    with torch.no_grad():
        wqkv, bqkv, wproj, bproj, rel_bias = (t.numpy() for t in port.kernel_args())
    calls = _spy_routes(monkeypatch)
    with torch.no_grad():
        out = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert calls == []
    want = jax_fused_window_block(*(jnp.asarray(a) for a in (x, wqkv, bqkv, wproj, bproj)),
                                  expand_bias_lanes(jnp.asarray(rel_bias), mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def test_window_attention_xla_route_trains_like_the_jax_one():
    """Training at C 6 (rate 0): the XLA route's output and gradients
    against the JAX package's XLA path under jax.grad, 1e-5; with dropout
    it draws ``remat_dropout``'s mask from the step's device generator."""
    C, H = 6, 2
    x, mask, jax_attn, params = _jax_block(C, H, 4, 5)
    g = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jax_attn.apply({"params": p}, xx, mask, train=True) * g)

    want_x = jax.grad(loss, argnums=1)(params, jnp.asarray(x))
    port = tswin.WindowAttention(C, (3, 3), H).train()
    port.load_state_dict(params_from_flax(params, {}, {"location_names": ["l"]}), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt, torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), atol=1e-5)
    dropped = tswin.WindowAttention(C, (3, 3), H, attn_drop=0.5).train()
    from focal_tpu_torch.ops.dropout import StepRngs
    rng = StepRngs(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    y = dropped(torch.from_numpy(x), torch.from_numpy(mask), rng)
    assert y.shape == x.shape and torch.isfinite(y).all()
