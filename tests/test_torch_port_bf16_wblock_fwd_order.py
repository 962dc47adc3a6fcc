"""The order of work of the bf16 whole-block forward on Hopper (#1-bf16,
#2-bf16 and #4-bf16, ``csrc/window_block.cu``'s ``wblock_fwd_bf16``) in
plain PyTorch, held on the CPU against the port's bf16 plain version and the
JAX package's whole-block and per-head forward kernels fed bf16.

On the card a call runs three launches:
  (a) qkv = x Wqkv + bqkv in f32 (wgmma, f32 sums), into the workspace;
  (b) the attention per (window, head) pair, a persistent grid of blocks
      each walking chunks of P pairs (P, the ring's slots and the grid from
      the launch plan): the scores, softmax and dropout in f32 (the keep
      mask written out), the attention output rounded once to bf16 into
      ao [R, C];
  (c) y = ao Wproj + bproj from the bf16 ao, the bias added to the f32
      sums, then each value rounded to bf16 once.

``order_forward`` runs that order (``plan``: a copy of
``make_fwd_plan16``'s ring, chunk pairs and workspace). Tolerances as
``tests/test_torch_port_bf16_kernel.py``: y within 1e-2 of max|JAX|
(FWD_TOL); against the port's plain version the same 1e-2 of max|y|, and
bitwise where the two compute in the same order (fed the plain version's
own attention).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.swin import shifted_window_mask
from focal_tpu.ops.pallas_kernels import _wblock_fwd_impl, _wblock_ph_fwd_impl, expand_bias_lanes
from focal_tpu_torch.ops import pallas_kernels as pk
from torch_port_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1e-2        # against the JAX kernels and the plain version (of max|y|)
THREADS = 256         # threads of an attention block (kAttnThreads)
MAX_LANES = 8
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


def attn_floats(g, wide):
    """attn_fwd16_floats: the ring's q, k, v rows, two slots or one."""
    return (3 if wide else 6) * g["pairs"] * g["N"] * g["stride"]


def plan(B, N, C, H, sms=132, per_sm=2, optin=SMEM_OPTIN):
    """make_fwd_plan16 (csrc/window_block.cu's plan_ring16) on a card of
    ``sms`` SMs where ``per_sm`` attention blocks fit an SM: make_geo's
    pairs a chunk, fewer where two slots do not fit ``optin`` bytes, then
    one slot (wide) with make_geo's pairs and fewer again; the grid; the
    workspace in floats, qkv [R, 3C] f32 then ao [R, C] bf16 (None where no
    plan fits)."""
    full = make_geo(B, H, N, C // H)
    g, wide = dict(full), False
    while 4 * attn_floats(g, wide) > optin:
        if g["pairs"] > 1:
            g["pairs"] -= 1
        elif not wide:
            wide, g["pairs"] = True, full["pairs"]
        else:
            return None
    R = B * N
    sizes = [R * 3 * C, -(-R * C // 8) * 4]
    return {"geo": g, "wide": wide, "smem": 4 * attn_floats(g, wide),
            "grid": min(-(-g["total"] // g["pairs"]), per_sm * sms), "sizes": sizes,
            "total": sum(sizes)}


def attention_rows(q, k, v, bias, mask, keep, rate):
    """The kernel's f32 math for a chunk's pairs (q, k, v [P, N, hd]; the
    pairs' bias and mask rows [P, N, N]): the scores plus the bias, plus the
    mask; exp(s - max) times the reciprocal of its sum; the kept weights
    times 1 / (1 - rate) in f32, the dropped 0; a_v v."""
    s = torch.matmul(q, k.transpose(-1, -2)) + bias
    if mask is not None:
        s = s + mask
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e * (1.0 / e.sum(-1, keepdim=True))
    if keep is not None:
        inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
        p = torch.where(keep.bool(), p * inv_keep, 0.0)
    return torch.matmul(p, v)


def plain_attention(q, k, v, bias, mask, keep, rate):
    """The plain version's own ops (``fused_window_attention_reference``) on
    a chunk's pairs."""
    scores = torch.matmul(q, k.transpose(-1, -2)) + bias
    if mask is not None:
        scores = scores + mask
    attn = torch.softmax(scores, dim=-1)
    if keep is not None:
        attn = torch.where(keep.bool(), attn * (1.0 / (1.0 - rate)), 0.0)
    return torch.matmul(attn, v)


def order_forward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep=None, rate=0.0, grid=None,
                  attention=attention_rows):
    """The bf16 forward in the card's order (module docstring) for the
    launch plan's chunks; ``grid`` overrides the plan's, ``attention`` the
    f32 math of a chunk. Returns y (bf16 [B, N, C]), the bf16 store ao [R,
    C] and how many times each (window, head) pair was computed."""
    f32, bf16 = torch.float32, torch.bfloat16
    B, N, C = x.shape
    H = rel_bias.shape[0]
    hd, R = C // H, B * N
    P = plan(B, N, C, H)
    grid = P["grid"] if grid is None else grid
    # (a)
    qkv = torch.matmul(x.to(f32), wqkv.to(f32)) + bqkv  # [B, N, 3C]
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, H, hd).transpose(1, 2) for i in range(3))
    # (b) block b walks chunks b, b + grid, ... of P pairs (window w = pair //
    # H, head h = pair % H); each pair's rows are computed and stored once
    pairs, total = P["geo"]["pairs"], B * H
    ao = torch.full((B, H, N, hd), float("nan"))
    visits = torch.zeros(total, dtype=torch.int64)
    for b in range(grid):
        for c in range(b, -(-total // pairs), grid):
            idx = torch.arange(c * pairs, min(total, (c + 1) * pairs))
            w, h = idx // H, idx % H
            ao[w, h] = attention(q[w, h], k[w, h], v[w, h], rel_bias[h],
                                 None if mask is None else mask[w % mask.shape[0]],
                                 None if keep is None else keep[w, h], rate)
            visits[idx] += 1
    ao_b = ao.transpose(1, 2).reshape(R, C).to(bf16)
    # (c)
    y = (torch.matmul(ao_b.to(f32), wproj.to(f32)) + bproj).to(bf16).reshape(B, N, C)
    return y, ao_b, visits


def _inputs(C, shifted, B, H=4, N=9, seed=0):
    """Numpy-seeded inputs at a trained model's scale: the JAX package's
    (bf16 x, wqkv, wproj; f32 biases and the lane-expanded bias table) and
    the port's (the same values as torch tensors), and the rng."""
    rng = np.random.default_rng(seed + C + int(shifted))
    x = rng.normal(size=(B, N, C))
    wqkv = rng.normal(size=(C, 3 * C)) * C**-0.5
    bqkv = rng.normal(size=3 * C) * 0.1
    wproj = rng.normal(size=(C, C)) * C**-0.5
    bproj = rng.normal(size=C) * 0.1
    rel_bias = rng.normal(size=(H, N, N)) * 0.02
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if shifted else None
    bf = jnp.bfloat16
    j_x, j_wq, j_wp = (jnp.asarray(a, jnp.float32).astype(bf) for a in (x, wqkv, wproj))
    jax_args = (j_x, j_wq, jnp.asarray(bqkv, jnp.float32), j_wp, jnp.asarray(bproj, jnp.float32),
                expand_bias_lanes(jnp.asarray(rel_bias, jnp.float32), mask))

    def to_bf16(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    port = (to_bf16(j_x), to_bf16(j_wq), torch.from_numpy(bqkv.astype(np.float32)),
            to_bf16(j_wp), torch.from_numpy(bproj.astype(np.float32)),
            torch.from_numpy(rel_bias.astype(np.float32)),
            None if mask is None else torch.from_numpy(mask))
    return jax_args, port, rng


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.float().numpy() if isinstance(want, torch.Tensor) else want
    return float(np.abs(got - want).max() / np.abs(want).max())


def _keep(rng, B, H, N, rate):
    return torch.from_numpy((rng.random((B, H, N, N)) >= rate).astype(np.uint8)) if rate else None


# (C, shifted): MOD's first width with and without the shifted-window mask
# (#1-bf16), and MOD_WIDE's per-head width (#4-bf16); a JAX kernel in
# interpret mode takes ~6 s a call here, one call a case
JAX_CASES = [(64, False), (64, True), (512, True)]


@pytest.mark.parametrize("C,shifted", JAX_CASES)
def test_order_matches_jax_kernels_and_plain(C, shifted):
    """The card's order against ``_wblock_fwd_impl`` (C 64) or
    ``_wblock_ph_fwd_impl`` (C 512) fed bf16 in interpret mode, at rate 0
    and through the dropout path with every weight kept (the JAX dropout
    draws the TPU's bits: rate -> 0); and against the port's plain version
    with a keep mask."""
    B = 16 if C <= 256 else 8
    jax_args, port, rng = _inputs(C, shifted, B)
    impl = _wblock_fwd_impl if C <= 256 else _wblock_ph_fwd_impl
    want = impl(*jax_args)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    y, _, visits = order_forward(*port)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == want.shape
    assert bool((visits == 1).all())
    assert _rel(y, want) <= FWD_TOL
    H, N = port[5].shape[0], port[0].shape[1]
    ones = torch.ones(B, H, N, N, dtype=torch.uint8)
    assert _rel(order_forward(*port, ones, 1e-7)[0], want) <= FWD_TOL
    keep = _keep(rng, B, H, N, 0.2)
    got = order_forward(*port, keep, 0.2)[0]
    assert _rel(got, pk.fused_window_block_bf16_reference(*port, keep, 0.2)) <= FWD_TOL


@pytest.mark.parametrize("C,rate,shifted", [(64, 0.2, True), (256, 0.0, False),
                                            (512, 0.2, False)])
def test_order_is_the_plain_versions_bits_in_the_plain_order(C, rate, shifted):
    """Fed the plain version's own attention, the card's order (qkv in f32,
    ao rounded once, y rounded once after the bias) gives the plain
    version's bits, y and ao alike; with the kernel's own f32 attention math
    it stays within one bf16 step of ao and 1e-2 of max|y|."""
    B = 12 if C <= 256 else 4
    _, port, rng = _inputs(C, shifted, B, seed=2)
    H, N = port[5].shape[0], port[0].shape[1]
    keep = _keep(rng, B, H, N, rate)
    y, ao_b, _ = order_forward(*port, keep, rate, attention=plain_attention)
    assert torch.equal(y, pk.fused_window_block_bf16_reference(*port, keep, rate))
    x, wqkv, bqkv, _, _, rel_bias, mask = port
    qkv = torch.matmul(x.float(), wqkv.float()) + bqkv
    q, k, v = pk._head_views(qkv, H)
    ao = pk.fused_window_attention_reference(q, k, v, rel_bias, mask, keep, rate)
    assert torch.equal(ao_b, ao.transpose(1, 2).reshape(B * N, C).to(torch.bfloat16))
    ky, kao, _ = order_forward(*port, keep, rate)
    assert _rel(ky, y) <= FWD_TOL
    a, b = kao.float(), ao_b.float()
    step = torch.maximum(a.abs(), b.abs()) * 2.0**-7  # one bf16 step of either value
    assert bool(((a - b).abs() <= step + 1e-5 * b.abs().max()).all())


@pytest.mark.parametrize("grid", [1, 3, 264])
def test_chunk_walk_computes_every_pair_once_for_any_grid(grid):
    """Each (window, head) pair is computed and stored once whatever the
    grid (the persistent walk's stride), and the stores do not depend on
    it: y has the same bits."""
    _, port, rng = _inputs(64, True, 37, seed=3)
    keep = _keep(rng, 37, 4, 9, 0.2)
    y, ao, visits = order_forward(*port, keep, 0.2, grid=grid)
    y1, ao1, _ = order_forward(*port, keep, 0.2, grid=1)
    assert visits.shape == (37 * 4,) and bool((visits == 1).all())
    assert torch.equal(y, y1) and torch.equal(ao, ao1)


def _recipe_blocks():
    """(recipe, N, C, H) of every whole-block geometry of the packaged
    SW_Transformer recipes (chip_smoke.block_geometries' distinct ones)."""
    from focal_tpu_torch.models.sw_transformer import mod_geometry
    from focal_tpu_torch.params import load_dataset_config

    out = set()
    for recipe in ("MOD", "MOD_WIDE", "ACIDS", "PAMAP2", "RealWorld_HAR"):
        cfg = load_dataset_config(recipe)
        H = cfg["SW_Transformer"]["time_freq_head_num"]
        for loc in cfg["location_names"]:
            for mod in cfg["modality_names"]:
                geo = mod_geometry(cfg, loc, mod)
                N = geo["window"][0] * geo["window"][1]
                for _, C in geo["stages"]:
                    out.add((recipe, N, C, H))
    return sorted(out)


@pytest.mark.parametrize("recipe,N,C,H", _recipe_blocks())
def test_plan_fits_at_every_recipe_block(recipe, N, C, H):
    """At every packaged block the bf16 gate admits, the forward's plan has
    two slots of the ring and at least two pairs a chunk within a block's
    shared memory, and its workspace arrays stay 16-byte aligned."""
    assert pk.wblock_takes(N, C, H, torch.bfloat16), recipe
    for B in (1, 64, 4096):
        P = plan(B, N, C, H)
        assert not P["wide"] and P["geo"]["pairs"] >= 2 and P["smem"] <= SMEM_OPTIN, (recipe, C)
        assert all(size % 4 == 0 for size in P["sizes"])


@pytest.mark.parametrize("N", [4, 9, 16])
def test_plan_fits_at_every_width_the_bf16_gate_admits(N):
    """Wherever ``wblock_takes`` admits a bf16 width (1 to 4 heads, heads of
    1 to 2,048 columns), the forward's plan fits a block's shared memory:
    the kernel narrows no gate. At N 9 the 1,600-column head, the widest,
    takes one slot of the ring and one pair."""
    admitted = 0
    for H in (1, 2, 4):
        for hd in list(range(1, 64)) + list(range(64, 2049, 4)):
            C = H * hd
            if pk.wblock_takes(N, C, H, torch.bfloat16):
                admitted += 1
                P = plan(3, N, C, H)
                assert P is not None and P["smem"] <= SMEM_OPTIN, (N, C, H)
    assert admitted > 100
    if N == 9:
        P = plan(3, 9, 1600, 1)
        assert pk.wblock_takes(9, 1600, 1, torch.bfloat16)
        assert P["wide"] and P["geo"]["pairs"] == 1 and P["smem"] == 3 * 9 * 1604 * 4
