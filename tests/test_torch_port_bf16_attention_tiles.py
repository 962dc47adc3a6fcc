"""The arithmetic of the tensor-core bf16 attention kernels (#6-bf16 to
#9-bf16, ``csrc/window_attention.cu``'s ``wattn_bf16_fwd_kernel`` and
``wattn_bf16_bwd_kernel``), emulated in plain PyTorch on the CPU, where the
kernels cannot run:

  * each (window, head) pair's rows and keys pad to one 16 x 16 tile, rows
    and keys past N reading row N - 1 (ldmatrix's clamped row addresses),
    head columns padded with zeros to a multiple of 16;
  * the products as bf16 x bf16 -> f32 (exact products, f32 sums); the f32
    operands p (a_v) and ds split into bf16 hi + lo, two products each,
    the lo product first into the accumulator;
  * the row phase: the scores leave the accumulators as f32, and one lane
    takes a query row: bias, then mask, added to each score, the max, the
    sum and rowsum(da p) taken key by key in order, 1 / sum times each
    weight (``window_rows.cuh``'s ``softmax_row``); a_v and ds go back to
    the products as bf16 hi and lo tiles whose keys past N, and (a zero
    row) rows past N, are 0;
  * the chunk walk of the persistent grid (pairs a chunk by ``plan_pairs``,
    a copy of the kernels' ``make_geo16``; block b takes chunks b, b +
    grid, ...) and drel_bias's order: a block adds its chunks' ds head by
    head in pair order, then the blocks' partials add in block order.

It is held against the JAX package's ``fused_window_attention`` fed bf16 in
interpret mode and its ``jax.vjp`` (1e-2 of max|y| and 2e-2 relative, as
``tests/test_torch_port_bf16_attention.py``'s (a)), against the TPU
kernels' own math (``_scores_softmax``, ``_weighted_sum``, ``_bwd_math``)
under a numpy keep mask (as its (b)), and against the bf16 plain versions
(``fused_window_attention_bf16_reference``, the card's yardstick) at head
widths 8, 16, 24 and 64, N 4, 9 and 16, a ragged last chunk and a shifted
mask, to the card's gates (8e-3 of max|y|, 1e-2 relative). The hi + lo
split's own error against the f32 products, before the bf16 store, is at
most 2^-15 of max|f32|.
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
from torch_port_threads import one_torch_thread  # noqa: F401

BF = torch.bfloat16
F32 = torch.float32
TILE = 16
WARPS = 4  # csrc/window_attention.cu's kWarps16
PAIRS_MAX = 64
FWD_SLOT_BYTES = 26 * 1024  # kFwdSlotBytes
BWD_SLOT_BYTES = 36 * 1024  # kBwdSlotBytes
JAX_FWD_TOL, JAX_GRAD_TOL = 1e-2, 2e-2  # tests/test_torch_port_bf16_attention.py (a), (b)
CARD_FWD_TOL, CARD_GRAD_TOL = 8e-3, 1e-2  # chip_smoke.py phase 33's gates
SPLIT_TOL = 2.0**-15


def plan_pairs(N, hd, ops, slot_bytes):
    """make_geo16's pairs a chunk: the slot's bytes over a pair's rows at
    the ring's stride (hd rounded up to 16, plus 8), a multiple of the
    block's 4 warps times the pairs a warp takes at once (min(8, 32 // N))
    where that many fit, at most 64."""
    rs = (hd + 15) // 16 * 16 + 8
    unit = WARPS * min(8, 32 // N)
    p = slot_bytes // (ops * N * rs * 2)
    if p >= unit:
        p -= p % unit
    return max(1, min(p, PAIRS_MAX))


def _bf(x):
    """x rounded to bf16, as f32."""
    return x.to(BF).to(F32)


def split(x):
    """x = hi + lo, each rounded to bf16 (as f32): hi = bf16(x), lo =
    bf16(x - hi)."""
    hi = _bf(x)
    return hi, _bf(x - hi)


def tile_rows(x, N, hd16):
    """[pairs, N, hd] bf16 rows as the [pairs, 16, hd16] f32 tile the
    kernels read: rows past N repeat row N - 1, columns past hd zero."""
    idx = torch.clamp(torch.arange(TILE), max=N - 1)
    t = x.to(F32)[:, idx]
    return torch.nn.functional.pad(t, (0, hd16 - x.shape[-1]))


def split_product(a, b):
    """(a_hi + a_lo) b as the kernels issue it: the lo product into the
    zeroed accumulator, then the hi product; a f32, b bf16 values."""
    hi, lo = split(a)
    return torch.matmul(lo, b) + torch.matmul(hi, b)


def row_sum(v, N):
    """Each row's sum over its first N keys, key by key in order (one lane's
    loop)."""
    acc = torch.zeros(v.shape[:-1], dtype=F32)
    for j in range(N):
        acc = acc + v[..., j]
    return acc


def row_max(v, N):
    acc = torch.full(v.shape[:-1], -torch.inf)
    for j in range(N):
        acc = torch.maximum(acc, v[..., j])
    return acc


def emulate(q, k, v, rel_bias, mask, g=None, keep=None, rate=0.0, q_scale=1.0):
    """The kernels' arithmetic on bf16 q (unscaled), k, v [B, H, N, hd]
    (and g: the backward), f32 rel_bias [H, N, N] and mask [nW, N, N] or
    None, keep uint8 [B, H, N, N] or None. Returns out (bf16) and, with g,
    (dq, dk, dv bf16, drel_bias f32) with dq the gradient of the scaled q,
    and the f32 results before the bf16 store (out, dq, dk, dv) next to the
    same products unsplit in f32."""
    B, H, N, hd = q.shape
    hd16 = (hd + 15) // 16 * 16
    pairs = B * H
    qs = pk.scale_bf16(q, q_scale) if q_scale != 1.0 else q  # scale_q16: bf16(q bf16(s))
    qt, kt, vt = (tile_rows(x.reshape(pairs, N, hd), N, hd16) for x in (qs, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2))  # [pairs, 16, 16]
    valid_key = torch.arange(TILE) < N
    valid_row = (torch.arange(TILE) < N)[:, None]
    bias = torch.zeros((B, H, TILE, TILE))
    bias[:, :, :N, :N] = rel_bias[None]
    if mask is not None:  # added after the bias, as softmax_row adds them
        s = (s.reshape(B, H, TILE, TILE) + bias).reshape(pairs, TILE, TILE)
        bias = torch.zeros((B, H, TILE, TILE))
        bias[:, :, :N, :N] = mask[torch.arange(B) % mask.shape[0]][:, None]
    s = (s.reshape(B, H, TILE, TILE) + bias).reshape(pairs, TILE, TILE)
    s = torch.where(valid_key, s, -torch.inf)
    e = torch.where(valid_key, torch.exp(s - row_max(s, N)[..., None]), 0.0)
    p = e * (1.0 / row_sum(e, N))[..., None]
    kp = torch.ones((pairs, TILE, TILE))
    inv_keep = 1.0
    if keep is not None:
        inv_keep = 1.0 / (1.0 - rate)
        kp = torch.zeros((pairs, TILE, TILE))
        kp[:, :N, :N] = keep.reshape(pairs, N, N).to(F32)
    av = torch.where(kp > 0, p * inv_keep, 0.0) if keep is not None else p

    def store(x):  # rows < N, columns < hd, rounded to bf16
        return x[:, :N, :hd].reshape(B, H, N, hd)

    out32 = split_product(av, vt)
    res = {"out": store(out32).to(BF), "f32": {"out": (store(out32), store(av @ vt))}}
    if g is None:
        return res
    gt = tile_rows(g.reshape(pairs, N, hd), N, hd16)
    da = torch.matmul(gt, vt.transpose(-1, -2))
    if keep is not None:
        da = torch.where(kp > 0, da * inv_keep, 0.0)
    dot = row_sum(da * p, N)
    ds = torch.where(valid_row, p * (da - dot[..., None]), 0.0)
    av = torch.where(valid_row, av, 0.0)
    dq32 = split_product(ds, kt)
    dk32 = split_product(ds.transpose(-1, -2), qt)
    dv32 = split_product(av.transpose(-1, -2), gt)
    res["grads"] = (store(dq32).to(BF), store(dk32).to(BF), store(dv32).to(BF),
                    drel_bias_walk(ds[:, :N, :N].reshape(B, H, N, N), plan_pairs(
                        N, hd, 4, BWD_SLOT_BYTES)))
    res["f32"].update(dq=(store(dq32), store(ds @ kt)),
                      dk=(store(dk32), store(ds.transpose(-1, -2) @ qt)),
                      dv=(store(dv32), store(av.transpose(-1, -2) @ gt)))
    return res


def drel_bias_walk(ds, P, grid=3):
    """drel_bias as the backward sums it: pairs in chunks of P, block b
    taking chunks b, b + grid, ...; each block adds its chunks' pairs of
    head h in pair order (chunk by chunk) into its partial, and the
    partials add in block order."""
    B, H, N, _ = ds.shape
    flat = ds.reshape(B * H, N, N)
    nchunks = -(-B * H // P)
    grid = min(grid, nchunks)
    parts = torch.zeros((grid, H, N, N))
    for b in range(grid):
        for chunk in range(b, nchunks, grid):
            p0, np_ = chunk * P, min(P, B * H - chunk * P)
            for h in range(H):
                for pl in range((h - p0 % H) % H, np_, H):
                    parts[b, h] = parts[b, h] + flat[p0 + pl]
    out = torch.zeros((H, N, N))
    for b in range(grid):
        out = out + parts[b]
    return out


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(seed, B, H, N, hd, nW):
    """bf16 q (unscaled), k, v, g [B, H, N, hd], f32 rel_bias at a trained
    model's scale, a 0 / -100 mask [nW, N, N] (or None), and the rng."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, H, N, hd)).astype(np.float32)).to(BF)
                  for _ in range(4))
    rel_bias = torch.from_numpy((0.02 * rng.normal(size=(H, N, N))).astype(np.float32))
    mask = None
    if nW:
        mask = torch.from_numpy(np.where(rng.random((nW, N, N)) < 0.3, -100.0, 0.0).astype(
            np.float32))
    return q, k, v, g, rel_bias, mask, rng


def test_plan_pairs_at_mods_widths_and_the_ragged_edges():
    """The pairs a chunk the plans give (copied here from make_geo16) at
    MOD's head widths, and the edges: a multiple of the warps' groups where
    one fits, never 0."""
    assert [plan_pairs(9, hd, 3, FWD_SLOT_BYTES) for hd in (16, 32, 64)] == [12, 12, 6]
    assert [plan_pairs(9, hd, 4, BWD_SLOT_BYTES) for hd in (16, 32, 64)] == [12, 12, 7]
    assert plan_pairs(16, 256, 4, BWD_SLOT_BYTES) == 1 and plan_pairs(4, 8, 3, FWD_SLOT_BYTES) == 32
    for N in (1, 4, 9, 16):
        unit = WARPS * min(8, 32 // N)
        for hd in range(8, 257, 8):
            for ops, budget in ((3, FWD_SLOT_BYTES), (4, BWD_SLOT_BYTES)):
                p = plan_pairs(N, hd, ops, budget)
                assert 1 <= p <= PAIRS_MAX and (p < unit or p % unit == 0 or p == PAIRS_MAX)


@pytest.mark.parametrize("hd,shifted", [(16, True), (64, False)])
def test_tiles_match_the_jax_kernel_fed_bf16(hd, shifted):
    """The emulation against fused_window_attention fed bf16 in interpret
    mode (q scaled by the JAX caller's bf16 multiply) and its jax.vjp."""
    H, N, B = 4, 9, 8
    q, k, v, g, rel_bias, _, _ = _inputs(hd + shifted, B, H, N, hd, 0)
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if shifted else None
    scale = hd**-0.5
    jq, jk, jv, jg = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v, g))
    bias_l = expand_bias_lanes(jnp.asarray(rel_bias.numpy()), mask)
    want, vjp = jax.vjp(jax.jit(fused_window_attention), jq * scale, jk, jv, bias_l)
    dq, dk, dv, dbias_l = vjp(jg)
    got = emulate(q, k, v, rel_bias, None if mask is None else torch.from_numpy(mask), g,
                  q_scale=scale)
    assert _rel(got["out"], want) <= JAX_FWD_TOL
    for name, a, w in zip(("dq", "dk", "dv", "drel_bias"), got["grads"],
                          (dq, dk, dv, np.asarray(dbias_l).sum(-1))):
        assert _rel(a, w) <= JAX_GRAD_TOL, (name, _rel(a, w))


def _tpu_math(q, k, v, g, rel_bias, mask, keep, rate):
    """#7's output and #9's gradients in the TPU kernels' jnp, head by head
    on the [N, hd, B_] lane layout, with ``keep`` as their mask, on f32
    inputs; out, dq, dk, dv rounded to bf16 as the kernels fed bf16 store
    them."""
    B, H, N, _ = q.shape
    bias_w = np.zeros((N, N, B), np.float32)
    if mask is not None:
        bias_w = mask[np.arange(B) % mask.shape[0]].transpose(1, 2, 0)
    outs = [[] for _ in range(5)]
    for h in range(H):
        ql, kl, vl, gl = (jnp.asarray(a[:, h].transpose(1, 2, 0)) for a in (q, k, v, g))
        bias = jnp.asarray(rel_bias[h][:, :, None] + bias_w)
        kp = jnp.asarray(keep[:, h].transpose(1, 2, 0).astype(bool))
        attn = jnp.where(kp, _scores_softmax(ql, kl, bias) / (1.0 - rate), 0.0)
        d = _bwd_math(ql, kl, vl, gl, bias, kp, 1.0 / (1.0 - rate))
        for acc, a in zip(outs, (_weighted_sum(attn, vl), *d[:3])):
            acc.append(a)
        outs[4].append(np.asarray(d[3]).sum(-1))

    def back(parts):  # H x [N, hd, B_] -> [B_, H, N, hd], rounded to bf16
        return np.stack([_f32(jnp.asarray(a).astype(jnp.bfloat16)).transpose(2, 0, 1)
                         for a in parts], axis=1)

    return [back(o) for o in outs[:4]] + [np.stack(outs[4])]


@pytest.mark.parametrize("hd,nW", [(16, 4), (32, 0)])
def test_tiles_with_a_keep_mask_match_the_tpu_kernels_math(hd, nW):
    """#7-bf16's and #9-bf16's arithmetic under a numpy keep mask against
    the TPU kernels' math on the upcast inputs with that mask."""
    H, N, B, rate = 4, 9, 8, 0.2
    q, k, v, g, rel_bias, mask, rng = _inputs(7 * hd, B, H, N, hd, nW)
    keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8)
    scale = hd**-0.5
    got = emulate(q, k, v, rel_bias, mask, g, torch.from_numpy(keep), rate, q_scale=scale)
    want = _tpu_math(_f32(pk.scale_bf16(q, scale)), _f32(k), _f32(v), _f32(g), rel_bias.numpy(),
                     None if mask is None else mask.numpy(), keep, rate)
    assert _rel(got["out"], want[0]) <= JAX_FWD_TOL
    for name, a, w in zip(("dq", "dk", "dv", "drel_bias"), got["grads"], want[1:]):
        assert _rel(a, w) <= JAX_GRAD_TOL, (name, _rel(a, w))


# (windows, heads, N, head width, shift-mask windows or 0): MOD's widths
# (hd 16, 32, 64 at N 9), a head width not a multiple of 16 (8, 24), N 4
# and 16, a shifted mask, and pair counts that leave a ragged last chunk
TILE_CASES = [(13, 4, 9, 16, 4), (7, 4, 9, 32, 0), (5, 4, 9, 64, 2), (11, 2, 4, 8, 3),
              (6, 3, 16, 24, 2), (3, 2, 16, 8, 0)]


@pytest.mark.parametrize("B,H,N,hd,nW", TILE_CASES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_tiles_match_the_bf16_plain_versions(B, H, N, hd, nW, rate):
    """The emulation against the bf16 plain versions (what the card tests
    hold the kernels to) at the card's gates, with and without a keep mask;
    the hi + lo split's error against the f32 products before the store at
    most 2^-15 of max|f32|; the chunk walk's drel_bias against the plain
    sum over windows."""
    q, k, v, g, rel_bias, mask, rng = _inputs(B * hd + N, B, H, N, hd, nW)
    keep = torch.from_numpy((rng.random((B, H, N, N)) >= rate).astype(np.uint8)) if rate else None
    scale = hd**-0.5
    got = emulate(q, k, v, rel_bias, mask, g, keep, rate, q_scale=scale)
    want = pk.fused_window_attention_bf16_reference(q, k, v, rel_bias, mask, keep, rate, scale)
    assert _rel(got["out"], want) <= CARD_FWD_TOL
    wgrads = pk.fused_window_attention_backward_bf16_reference(q, k, v, rel_bias, mask, g, keep,
                                                               rate, scale)
    for name, a, w in zip(("dq", "dk", "dv", "drel_bias"), got["grads"], wgrads):
        assert a.dtype == w.dtype, name
        assert _rel(a, w) <= CARD_GRAD_TOL, (name, _rel(a, w))
    for name, (split_f32, plain_f32) in got["f32"].items():
        assert _rel(split_f32, plain_f32) <= SPLIT_TOL, (name, _rel(split_f32, plain_f32))


def test_drel_bias_walk_is_the_sum_over_windows_in_any_plan():
    """The chunk walk adds every pair once to its head: any pairs a chunk
    and any grid give the plain sum (to f32 rounding), a ragged last chunk
    included."""
    ds = torch.from_numpy(np.random.default_rng(3).normal(size=(37, 3, 9, 9)).astype(np.float32))
    want = ds.sum(0)
    for P, grid in ((1, 1), (8, 3), (24, 5), (64, 2), (7, 4)):
        assert torch.allclose(drel_bias_walk(ds, P, grid), want, rtol=0, atol=1e-5), (P, grid)
