"""The order of work of the bf16 whole-block backward on Hopper (#3-bf16 and
#5-bf16, ``csrc/window_block.cu``'s ``wblock_bwd_bf16``) in plain PyTorch,
held on the CPU against the port's bf16 plain version and the JAX package's
whole-block and per-head backward kernels fed bf16.

On the card a call runs five launches:
  (a) qkv = x Wqkv + bqkv and g = dy Wproj^T in f32 (wgmma, f32 sums);
  (b) the attention backward per (window, head) pair, a persistent grid of
      blocks each walking chunks of P pairs (P and the grid from the launch
      plan): the softmax and its gradient in f32, dq, dk, dv and the
      attention output rounded once to bf16 as they are stored; each block
      sums, in f32, d rel_bias per head and dbqkv per column over its
      chunks' pairs in pair order (a pair's rows in order), and dbproj over
      its share of dy's rows (rows [b rpb, (b + 1) rpb): a thread's 8
      columns over rows slot, slot + slots, ..., then the slots in order);
  (c) dx = dqkv Wqkv^T from the bf16 dqkv, stored as bf16;
  (d) dWqkv = x^T dqkv and dWproj = ao^T dy over fixed row splits
      (multiples of 64 rows, ``wgrad_splits``), one f32 partial a split;
  (e) the weights' partials summed in split order, the three per-block sums
      over the blocks in eight consecutive slices, the slices in order.

``order_backward`` runs that order (``plan``: a copy of
``make_bwd_plan16``'s attention geometry, slots and row splits, and of
``wgrad_splits``). Tolerances as ``tests/test_torch_port_bf16_kernel.py``:
each gradient within 2e-2 of max|JAX| (GRAD_TOL); against the port's plain
version the card's gate, 1e-2 (CARD_GRAD_TOL), and bitwise where the two
compute in the same order (the bf16 stores and dx).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.swin import shifted_window_mask
from focal_tpu.ops.pallas_kernels import (_block_tile, _block_tile_perhead, _wblock_bwd_impl,
                                          _wblock_ph_bwd_impl, expand_bias_lanes)
from focal_tpu_torch.ops import pallas_kernels as pk
from torch_port_threads import one_torch_thread  # noqa: F401

GRAD_TOL = 2e-2       # against the JAX kernels (tests/test_torch_port_bf16_kernel.py)
CARD_GRAD_TOL = 1e-2  # against the port's plain version (chip_smoke.BF16_GRAD_TOL)
NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias")
BM, BK = 128, 64      # rows of a product tile; K of a stage (the row splits' unit)
THREADS = 256         # threads of an attention block (kAttnThreads)
MAX_N, MAX_LANES = 16, 8
SMEM_OPTIN = 232448   # bytes a block may opt in to on the H100


def make_geo(B, H, N, hd):
    """focal::make_geo (csrc/window_rows.cuh): lanes a query row, pairs a
    chunk, a staged row's stride in floats."""
    c4 = -(-hd // 4)
    lanes = 1
    while 2 * lanes <= MAX_LANES and c4 % (2 * lanes) == 0 and 4 * lanes <= c4:
        lanes *= 2
    return {"B": B, "H": H, "N": N, "hd": hd, "c4": c4, "lanes": lanes,
            "pairs": max(1, THREADS // (N * lanes)), "stride": 4 * c4 + 4, "total": B * H}


def attn_floats(g, C, wide):
    """attn_bwd16_floats: the ring (two slots, or one), dq's rows (two
    slots), ds and a_v, d rel_bias, dbqkv (two slots); at least 2,048."""
    slab, nn = g["pairs"] * g["N"] * g["stride"], g["N"] ** 2
    f = (4 if wide else 9) * slab + 2 * g["pairs"] * nn + g["H"] * nn + (0 if wide else 3 * C)
    return max(f, 2048)


def wgrad_splits(rows, wtiles, sms):
    """wgrad_splits (csrc/gemm_wgmma.cuh): the fewest row splits of the
    least span."""
    best = None
    for s in range(1, max(1, min(-(-rows // 256), 8 * sms // wtiles + 1)) + 1):
        rps = -(-(-(-rows // s)) // BK) * BK
        splits = -(-rows // rps)
        span = -(-splits * wtiles // sms) * (rps // BK)
        if best is None or span < best[0]:
            best = (span, rps, splits)
    return best[1], best[2]


def plan(B, N, C, H, sms=132, per_sm=2, optin=SMEM_OPTIN):
    """make_bwd_plan16 (csrc/window_block.cu) on a card of ``sms`` SMs where
    ``per_sm`` attention blocks fit an SM (the occupancy query's answer):
    the attention's geometry, slots (two, or one for a head too wide) and
    grid, the weight gradients' row splits, the workspace in floats (None
    where no plan fits)."""
    full = make_geo(B, H, N, C // H)
    g, wide = dict(full), False
    while 4 * attn_floats(g, C, wide) > optin:
        if g["pairs"] > 1:
            g["pairs"] -= 1
        elif not wide:
            wide, g["pairs"] = True, full["pairs"]
        else:
            return None
    chunks = -(-g["total"] // g["pairs"])
    grid = min(chunks, per_sm * sms)
    R = B * N
    wbn = 128 if (3 * C) % 128 == 0 and C % 128 == 0 else 64
    wtiles = -(-C // BM) * -(-3 * C // wbn) + -(-C // BM) * -(-C // wbn)
    rps, splits = wgrad_splits(R, wtiles, sms)
    sizes = [R * 3 * C, R * C, -(-R * 3 * C // 8) * 4, -(-R * C // 8) * 4, grid * 3 * C,
             grid * C, -(-grid * H * N * N // 4) * 4, splits * 4 * C * C]
    return {"geo": g, "wide": wide, "grid": grid, "rows_per_split": rps, "splits": splits,
            "wbn": wbn, "sizes": sizes, "total": sum(sizes)}


def _sequential(parts):
    """parts[0] + parts[1] + ... in f32, left to right."""
    out = parts[0].clone()
    for p in parts[1:]:
        out = out + p
    return out


def _slices(part):
    """wg_reduce_kernel's order over part [tiles, n]: eight consecutive
    slices of the tiles, each summed in order, then the slices in order."""
    tiles = part.shape[0]
    per = -(-tiles // 8)
    sums = []
    for s in range(8):
        acc = torch.zeros(part.shape[1:], dtype=torch.float32)
        for t in range(s * per, min(tiles, (s + 1) * per)):
            acc = acc + part[t]
        sums.append(acc)
    return _sequential(sums)


def attention_f32(q, k, v, g, rel_bias, mask, keep, rate):
    """The attention backward's f32 math per (window, head) pair, as the
    kernel computes it: p = softmax(q k^T + bias + mask), da = g v^T (kept
    and scaled), a_v = p (kept and scaled), ds = p (da - rowsum(da p)); dq =
    ds k, dk = ds^T q, dv = a_v^T g, ao = a_v v. Returns dq, dk, dv, ao
    [B, H, N, hd] and ds [B, H, N, N]."""
    s = torch.matmul(q, k.transpose(-1, -2)) + rel_bias[None]
    if mask is not None:
        s = s + mask[torch.arange(q.shape[0]) % mask.shape[0]][:, None]
    p = torch.softmax(s, -1)
    da = torch.matmul(g, v.transpose(-1, -2))
    av = p
    if keep is not None:
        kb = keep.bool()
        da = torch.where(kb, da / (1.0 - rate), 0.0)
        av = torch.where(kb, p / (1.0 - rate), 0.0)
    ds = p * (da - (da * p).sum(-1, keepdim=True))
    return (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
            torch.matmul(av.transpose(-1, -2), g), torch.matmul(av, v), ds)


def block_partials(summands, P, grid):
    """Per-block sums of summands [pairs, k, ...] (pair p's k summands, added
    one after another): block b adds chunks b, b + grid, ... of P pairs in
    pair order. Returns [grid, ...]."""
    pairs = summands.shape[0]
    chunks = -(-pairs // P)
    out = torch.zeros((grid,) + summands.shape[2:], dtype=torch.float32)
    for b in range(grid):
        acc = torch.zeros(summands.shape[2:], dtype=torch.float32)
        for c in range(b, chunks, grid):
            for pair in range(c * P, min(pairs, (c + 1) * P)):
                for term in summands[pair]:
                    acc = acc + term
        out[b] = acc
    return out


def dbqkv_partials(dq, dk, dv, P, grid):
    """The attention blocks' dbqkv partials [grid, 3C]: column (part, h, d)
    over the block's pairs of head h in pair order, a pair's rows in order
    (pair (w, h) adds zeros to the other heads' columns)."""
    B, H, N, hd = dq.shape
    summands = torch.zeros(B * H, N, 3, H, hd, dtype=torch.float32)
    for part, t in enumerate((dq, dk, dv)):
        for h in range(H):
            summands[h::H, :, part, h] = t[:, h]
    return block_partials(summands.reshape(B * H, N, 3 * H * hd), P, grid)


def dbproj_partials(dy, grid):
    """The attention blocks' dbproj partials [grid, C]: block b's rows [b
    rpb, (b + 1) rpb) of dy, 8 columns a thread over rows slot, slot +
    slots, ... (slots = 256 / (C / 8) while C / 8 <= 256), the slots in
    order."""
    R, C = dy.shape
    rpb = -(-R // grid)
    out = torch.zeros(grid, C, dtype=torch.float32)
    for cg0 in range(0, C // 8, THREADS):
        gb = min(THREADS, C // 8 - cg0)
        slots = THREADS // gb
        cols = slice(8 * cg0, 8 * (cg0 + gb))
        for b in range(grid):
            r0, r1 = b * rpb, min(R, (b + 1) * rpb)
            sums = []
            for slot in range(slots):
                acc = torch.zeros(8 * gb, dtype=torch.float32)
                for r in range(r0 + slot, r1, slots):
                    acc = acc + dy[r, cols]
                sums.append(acc)
            out[b, cols] = _sequential(sums)
    return out


def order_backward(x, wqkv, bqkv, wproj, rel_bias, mask, dy, keep=None, rate=0.0, grid=None,
                   attention=None):
    """The bf16 backward in the card's order (module docstring) for the
    launch plan's pairs and splits; ``grid`` overrides the plan's attention
    grid, ``attention`` its f32 math (attention_f32's signature). Returns
    the six gradients (dx bf16, the rest f32) and the bf16 stores (dqkv [R,
    3C], ao [R, C])."""
    f32, bf16 = torch.float32, torch.bfloat16
    B, N, C = x.shape
    H = rel_bias.shape[0]
    hd, R = C // H, B * N
    P = plan(B, N, C, H)
    grid = P["grid"] if grid is None else grid
    xf, dyf = x.to(f32).reshape(R, C), dy.to(f32).reshape(R, C)
    wq, wp = wqkv.to(f32), wproj.to(f32)
    # (a)
    qkv = torch.matmul(xf, wq) + bqkv
    g = torch.matmul(dyf, wp.t())
    # (b)
    heads = lambda t: t.reshape(B, N, H, hd).transpose(1, 2)
    q, k, v = (heads(qkv[:, i * C:(i + 1) * C]) for i in range(3))
    dq, dk, dv, ao, ds = (attention or attention_f32)(q, k, v, heads(g), rel_bias, mask, keep,
                                                       rate)
    rows = lambda t: t.transpose(1, 2).reshape(R, C)
    dqkv_b = torch.cat([rows(dq), rows(dk), rows(dv)], 1).to(bf16)
    ao_b = rows(ao).to(bf16)
    pairs = P["geo"]["pairs"]
    one_hot = torch.eye(H).repeat(B, 1)[:, None, :, None, None]  # pair (w, h) -> head h
    dbias_part = block_partials(ds.reshape(B * H, 1, 1, N, N) * one_hot, pairs, grid)
    dbqkv_part = dbqkv_partials(dq, dk, dv, pairs, grid)
    dbproj_part = dbproj_partials(dyf, grid)
    # (c)
    dx = torch.matmul(dqkv_b.to(f32), wq.t()).to(bf16).reshape(B, N, C)
    # (d)
    rps = P["rows_per_split"]
    wparts = [(torch.matmul(xf[r:r + rps].t(), dqkv_b[r:r + rps].to(f32)),
               torch.matmul(ao_b[r:r + rps].to(f32).t(), dyf[r:r + rps]))
              for r in range(0, R, rps)]
    # (e)
    dwqkv = _sequential([w[0] for w in wparts])
    dwproj = _sequential([w[1] for w in wparts])
    return ((dx, dwqkv, _slices(dbqkv_part), dwproj, _slices(dbproj_part),
             _slices(dbias_part)), (dqkv_b, ao_b))


def _inputs(C, shifted, B, H=4, N=9, seed=0):
    """Numpy-seeded inputs at a trained model's scale: the JAX package's
    (bf16 x, wqkv, wproj, dy; f32 biases and the lane-expanded bias table)
    and the port's (the same values as torch tensors), and the rng."""
    rng = np.random.default_rng(seed + C + int(shifted))
    x = rng.normal(size=(B, N, C))
    wqkv = rng.normal(size=(C, 3 * C)) * C**-0.5
    bqkv = rng.normal(size=3 * C) * 0.1
    wproj = rng.normal(size=(C, C)) * C**-0.5
    bproj = rng.normal(size=C) * 0.1
    rel_bias = rng.normal(size=(H, N, N)) * 0.02
    dy = rng.normal(size=(B, N, C))
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if shifted else None
    bf = jnp.bfloat16
    j_x, j_wq, j_wp, j_dy = (jnp.asarray(a, jnp.float32).astype(bf) for a in (x, wqkv, wproj, dy))
    jax_args = (j_x, j_wq, jnp.asarray(bqkv, jnp.float32), j_wp, jnp.asarray(bproj, jnp.float32),
                expand_bias_lanes(jnp.asarray(rel_bias, jnp.float32), mask))

    def to_bf16(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    port = (to_bf16(j_x), to_bf16(j_wq), torch.from_numpy(bqkv.astype(np.float32)),
            to_bf16(j_wp), torch.from_numpy(bproj.astype(np.float32)),
            torch.from_numpy(rel_bias.astype(np.float32)),
            None if mask is None else torch.from_numpy(mask))
    return jax_args, j_dy, port, to_bf16(j_dy), rng


def _jax_keep(keep, tile):
    """uint8 [B, H, N, N] -> bf16 [H, N, N, Bp] in a JAX kernel's lanes."""
    B = keep.shape[0]
    lanes = np.zeros(keep.shape[1:] + (-(-B // tile) * tile,), np.float32)
    lanes[..., :B] = keep.transpose(1, 2, 3, 0)
    return jnp.asarray(lanes, jnp.bfloat16)


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.float().numpy() if isinstance(want, torch.Tensor) else want
    return float(np.abs(got - want).max() / np.abs(want).max())


def _order_args(port, dy, keep, rate):
    x, wqkv, bqkv, wproj, _, rel_bias, mask = port
    return (x, wqkv, bqkv, wproj, rel_bias, mask, dy, keep, rate)


def _autograd_attention(q, k, v, g, rel_bias, mask, keep, rate):
    """attention_f32's outputs by autograd through the plain attention (the
    plain version's own order): dq, dk, dv, ao and ds."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        rb = rel_bias.detach().clone().requires_grad_(True)
        s = torch.matmul(q, k.transpose(-1, -2)) + rb[None]
        if mask is not None:
            s = s + mask[torch.arange(q.shape[0]) % mask.shape[0]][:, None]
        s.retain_grad()
        a = torch.softmax(s, -1)
        if keep is not None:
            a = torch.where(keep.bool(), a * (1.0 / (1.0 - rate)), 0.0)
        ao = torch.matmul(a, v)
        dq, dk, dv = torch.autograd.grad(ao, (q, k, v), g, retain_graph=True)
        ao.backward(g)
    return dq, dk, dv, ao.detach(), s.grad


# (C, rate, shifted): MOD's three widths, each of rate 0 and a stored keep
# mask with and without the shifted-window mask (a JAX kernel in interpret
# mode takes ~6 s a call here: four calls cover the pairs)
WHOLE_BLOCK_CASES = [(64, 0.2, True), (128, 0.0, False), (256, 0.0, True), (256, 0.2, False)]


@pytest.mark.parametrize("C,rate,shifted", WHOLE_BLOCK_CASES)
def test_order_matches_plain_and_jax(C, rate, shifted):
    """MOD's whole-block widths (#3-bf16): the card's order against
    ``_wblock_bwd_impl`` fed bf16 in interpret mode and against the port's
    plain version, at rate 0 and with a stored keep mask, with and without
    the shifted-window mask."""
    B = 16
    jax_args, j_dy, port, dy, rng = _inputs(C, shifted, B)
    H, N = port[5].shape[0], port[0].shape[1]
    keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8) if rate else None
    tkeep = None if keep is None else torch.from_numpy(keep)
    want = _wblock_bwd_impl(*jax_args, j_dy,
                            mask=None if keep is None else _jax_keep(keep, _block_tile(N, C, B)),
                            rate=rate)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    want[5] = want[5].sum(-1)  # d bias_l [H, N, N, lanes] -> d rel_bias
    got, _ = order_backward(*_order_args(port, dy, tkeep, rate))
    plain = pk.fused_window_block_backward_bf16_reference(*port, dy, tkeep, rate)
    assert got[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in got[1:])
    for name, a, p, w in zip(NAMES, got, plain, want):
        assert tuple(a.shape) == w.shape, name
        assert _rel(a, w) <= GRAD_TOL, (name, _rel(a, w))
        assert _rel(a, p) <= CARD_GRAD_TOL, (name, _rel(a, p))


@pytest.mark.parametrize("rate,shifted", [(0.0, False), (0.2, True)])
def test_order_matches_jax_perhead_kernel(rate, shifted):
    """MOD_WIDE's per-head width (#5-bf16, C 512): the card's order against
    ``_wblock_ph_bwd_impl`` fed bf16 in interpret mode."""
    B, C = 8, 512
    jax_args, j_dy, port, dy, rng = _inputs(C, shifted, B, seed=1)
    H, N = port[5].shape[0], port[0].shape[1]
    keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8) if rate else None
    tile = _block_tile_perhead(N, C, C // H, B, 2)
    want = _wblock_ph_bwd_impl(*jax_args, j_dy,
                               mask=None if keep is None else _jax_keep(keep, tile), rate=rate)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    want[5] = want[5].sum(-1)
    got, _ = order_backward(*_order_args(port, dy, None if keep is None else
                                         torch.from_numpy(keep), rate))
    for name, a, w in zip(NAMES, got, want):
        assert _rel(a, w) <= GRAD_TOL, (name, _rel(a, w))


@pytest.mark.parametrize("C,rate", [(64, 0.2), (256, 0.0)])
def test_order_stores_and_dx_bitwise_the_plain_version(C, rate):
    """Where the card's order is the plain version's: fed the plain
    version's own f32 attention (autograd), the bf16 stores of dq, dk, dv
    and the attention output and dx are its bits; the kernel's f32
    attention math stays within one bf16 step of them."""
    B = 12
    _, _, port, dy, rng = _inputs(C, True, B, seed=2)
    H, N = port[5].shape[0], port[0].shape[1]
    keep = torch.from_numpy((rng.random((B, H, N, N)) >= rate).astype(np.uint8)) if rate else None
    args = _order_args(port, dy, keep, rate)
    got, (dqkv_b, ao_b) = order_backward(*args, attention=_autograd_attention)
    plain = pk.fused_window_block_backward_bf16_reference(*port, dy, keep, rate)
    assert torch.equal(got[0], plain[0])  # dx
    # the plain version's stores: its f32 dqkv and ao, each rounded once
    x, wqkv, bqkv, wproj, _, rel_bias, mask = port
    R = B * N
    qkv = (torch.matmul(x.float().reshape(R, C), wqkv.float()) + bqkv).reshape(B, N, 3 * C)
    heads = lambda t: t.reshape(B, N, H, C // H).transpose(1, 2)
    g = torch.matmul(dy.float(), wproj.float().t())
    dq, dk, dv, ao, _ = _autograd_attention(heads(qkv[..., :C]), heads(qkv[..., C:2 * C]),
                                            heads(qkv[..., 2 * C:]), heads(g), rel_bias, mask,
                                            keep, rate)
    rows = lambda t: t.transpose(1, 2).reshape(R, C)
    assert torch.equal(dqkv_b, torch.cat([rows(dq), rows(dk), rows(dv)], 1).to(torch.bfloat16))
    assert torch.equal(ao_b, rows(ao).to(torch.bfloat16))
    _, (kdqkv, kao) = order_backward(*args)
    for a, b in ((kdqkv, dqkv_b), (kao, ao_b)):
        a, b = a.float(), b.float()
        step = torch.maximum(a.abs(), b.abs()) * 2.0**-7  # one bf16 step of either value
        assert bool(((a - b).abs() <= step + 1e-5 * b.abs().max()).all())


@pytest.mark.parametrize("grid", [1, 3, 264])
def test_sums_in_block_order_hold_for_any_grid(grid):
    """dbqkv, dbproj and d rel_bias as per-block partials in pair order,
    summed in block slices: for any grid the f32 sums agree with one f32
    sum to f32 rounding, and the partials add up per block (each pair and
    each row of dy counted once)."""
    B, C = 10, 64
    _, _, port, dy, rng = _inputs(C, False, B, seed=3)
    args = _order_args(port, dy, None, 0.0)
    one, _ = order_backward(*args, grid=1)
    got, _ = order_backward(*args, grid=grid)
    for name, a, b in zip(NAMES, got, one):
        assert _rel(a, b) <= 1e-5, name
    dyf = dy.float().reshape(-1, C)
    part = dbproj_partials(dyf, grid)
    assert part.shape == (grid, C)
    assert _rel(part.sum(0), dyf.double().sum(0).float()) <= 1e-5


def _recipe_blocks():
    """(recipe, N, C, H) of every whole-block geometry of the packaged
    SW_Transformer recipes (chip_smoke.block_geometries' distinct ones)."""
    from focal_tpu_torch.models.sw_transformer import mod_geometry
    from focal_tpu_torch.params import load_dataset_config

    out = set()
    for recipe in ("MOD_TINY", "MOD", "MOD_WIDE", "ACIDS", "PAMAP2", "RealWorld_HAR"):
        cfg = load_dataset_config(recipe)
        H = cfg["SW_Transformer"]["time_freq_head_num"]
        for loc in cfg["location_names"]:
            for mod in cfg["modality_names"]:
                geo = mod_geometry(cfg, loc, mod)
                N = geo["window"][0] * geo["window"][1]
                for _, C in geo["stages"]:
                    out.add((recipe, N, C, H))
    return sorted(out)


RECIPE_BLOCKS = _recipe_blocks()
# one head's rows of the f32 backward's attention (4 N stride + (2 + H) N^2
# floats, stride hd + 4) fit 232,448 bytes up to hd 1,600 at N 9 and 892 at
# N 16, and no further; the bf16 gate adds C % 8 == 0
EDGES = [(9, 1600, 1, True, True), (9, 1596, 1, True, False), (9, 1604, 1, False, False),
         (9, 1608, 1, False, False), (16, 888, 1, True, True), (16, 892, 1, True, False),
         (16, 896, 1, False, False), (9, 1500, 3, True, False), (9, 40, 8, True, True),
         (9, 20, 5, True, False), (17, 64, 4, False, False), (9, 6, 3, False, False),
         (9, 18, 3, False, False), (4, 96, 8, True, True)]


@pytest.mark.parametrize("recipe,N,C,H", RECIPE_BLOCKS)
def test_gates_and_plan_at_every_recipe_block(recipe, N, C, H):
    """``wblock_takes`` admits every packaged block in f32 and bf16 alike;
    the bf16 backward's plan fits them with two slots of the ring and at
    least two pairs a chunk, its workspace 16-byte aligned array by array
    (every size a multiple of 4 floats)."""
    assert pk.wblock_takes(N, C, H, torch.float32), recipe
    assert pk.wblock_takes(N, C, H, torch.bfloat16), recipe
    P = plan(64, N, C, H)
    assert not P["wide"] and P["geo"]["pairs"] >= 2, (recipe, C, P["geo"]["pairs"])
    assert all(size % 4 == 0 for size in P["sizes"])
    assert P["rows_per_split"] % BK == 0
    assert P["splits"] * P["rows_per_split"] >= 64 * N > (P["splits"] - 1) * P["rows_per_split"]


@pytest.mark.parametrize("N,C,H,takes32,takes16", EDGES)
def test_gates_at_the_edges_of_shared_memory(N, C, H, takes32, takes16):
    """``wblock_takes`` at the edges of a block's shared memory and of its
    row multiples, pinned for f32 and bf16; where the bf16 gate admits a
    width, the bf16 backward has a launch plan (one slot of the ring at the
    widest heads), so the kernel narrows no gate."""
    assert pk.wblock_takes(N, C, H, torch.float32) is takes32
    assert pk.wblock_takes(N, C, H, torch.bfloat16) is takes16
    if takes16:
        P = plan(3, N, C, H)
        assert P is not None
        assert 4 * attn_floats(P["geo"], C, P["wide"]) <= SMEM_OPTIN
