"""The order of work of the fused MLP's bf16 kernels on Hopper (#10-bf16,
#11-bf16, #12-bf16 on ``wgmma``, ``csrc/fused_mlp.cu``) in plain PyTorch,
held on the CPU against the port's bf16 plain versions and the JAX
package's MLP kernels fed bf16.

On the card a call runs so:
  #10-bf16, #11-bf16 (C <= 256): one launch; a block's 128 rows walk H in
      chunks of 64 hidden columns: z_c = x W1[:, c] in f32, h_c =
      GELU(z_c + b1_c) keep1 / (1 - rate) rounded to bf16, y += h_c W2[c, :]
      in f32 across the chunks; then y + b2 (keep2) rounded to bf16. Wider
      C: row chunks of two launches, h [rows, H] rounded once as a whole.
  #12-bf16: row chunks (one [rows, H] bf16 array within 128 MiB); g2 = g
      keep2 / (1 - rate) rounded once to bf16 where stored, db2 from the
      f32 g2 as per-128-row-tile column partials; z = x W1 + b1 and dh = g2
      W2^T over one tile, dz = dh keep1 / (1 - rate) GELU'(z) in f32,
      rounded once to bf16 where stored beside the h the forward used, db1
      from the f32 dz as per-tile partials; dx = dz W1^T; dW1 = x^T dz and
      dW2 = h^T g2 over fixed row splits (multiples of 64 rows), a later
      chunk's added to the same split's partial; the weights' partials
      summed in split order, the bias partials in tile order.
The weights are rounded to bf16 once a call (the TPU kernel's astype).

``order_forward`` and ``order_backward`` run that order (``plan16`` is the
launch plan's copy: chunks, splits, tiles). Tolerances as
``tests/test_torch_port_bf16_mlp.py:18-19``: max|got - want| / max|want|
1e-2 for y and 2e-2 for each gradient against the JAX kernels; against the
port's plain versions the card's gates, 8e-3 for y (a bf16 step is 2^-8)
and 1e-2 for the gradients (only f32 summation orders differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.ops.pallas_kernels import _mlp_bwd_impl, _mlp_bwd_math, _mlp_fwd_core, _mlp_fwd_impl
from focal_tpu_torch.ops import fused_mlp as fm
from focal_tpu_torch.ops.conv_tower import gelu_exact, gelu_grad_exact
from torch_port_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1e-2       # against the JAX kernels (tests/test_torch_port_bf16_mlp.py)
GRAD_TOL = 2e-2
CARD_FWD_TOL = 8e-3  # against the port's plain versions (the card's gates)
CARD_GRAD_TOL = 1e-2
NAMES = ("dx", "dw1", "db1", "dw2", "db2")
BF = jnp.bfloat16
HIDDEN_CHUNK = 64    # kHiddenChunk
FUSED_MAX_C = fm.BF16_FUSED_MAX_C
BM, BK = 128, 64     # rows of a tile; K of a stage (the row splits' unit)
CHUNK_VALUES = 1 << 26  # one [rows, H] bf16 array: 128 MiB
# (C, H): MOD_TINY's widths (mlp_ratio 2) and MOD's (mlp_ratio 4)
WIDTHS = [(16, 32), (32, 64), (64, 256), (128, 512), (256, 1024)]


def plan16(T, C, H, backward, sms=132, chunk_values=CHUNK_VALUES):
    """make_plan16 (csrc/fused_mlp.cu): whether the forward is one fused
    launch, the row chunks' rows and count, the weight gradients' rows a
    split and splits, the call's 128-row tiles."""
    fused = not backward and C <= FUSED_MAX_C
    rows, chunks = T, 1
    if not fused:
        cap = max(BM, chunk_values // H // BM * BM)
        chunks = -(-T // cap)
        rows = -(-T // chunks)
        if chunks > 1:
            rows = -(-rows // BM) * BM
        chunks = -(-T // rows)
    wbn = 128 if H % 128 == 0 and C % 128 == 0 else 64
    wtiles = -(-C // BM) * -(-H // wbn) + -(-H // BM) * -(-C // wbn)
    best = None  # the fewest splits of the least span: waves of tiles x 64-row stages
    for s in range(1, max(1, min(-(-rows // 256), 8 * sms // wtiles + 1)) + 1):
        rps = -(-(-(-rows // s)) // BK) * BK
        splits = -(-rows // rps)
        span = -(-splits * wtiles // sms) * (rps // BK)
        if best is None or span < best[0]:
            best = (span, rps, splits)
    return {"fused": fused, "rows": rows, "chunks": chunks, "rows_per_split": best[1],
            "splits": best[2], "tiles": -(-T // BM)}


def _keep(t, keep, inv):
    return t if keep is None else torch.where(keep.bool(), t * inv, 0.0)


def _tile_sums(v):
    """Column sums of each 128-row tile of v [R, n], then the tiles in order."""
    parts = [v[r:r + BM].sum(0) for r in range(0, v.shape[0], BM)]
    out = torch.zeros_like(parts[0])
    for p in parts:
        out = out + p
    return out


def order_forward(x, w1, b1, w2, b2, keep1=None, keep2=None, rate=0.0):
    """#10-bf16 (#11-bf16 with the masks): the fused launch's order where C
    <= 256 (y summed over 64-column hidden chunks, each h chunk rounded to
    bf16), else h rounded whole and one product."""
    f32, bf16 = torch.float32, torch.bfloat16
    T, C = x.shape
    H = w1.shape[1]
    inv = 1.0 / (1.0 - rate) if keep1 is not None else 1.0
    xf, w1b, w2b = x.to(f32), w1.to(bf16).to(f32), w2.to(bf16).to(f32)
    chunk = HIDDEN_CHUNK if plan16(T, C, H, False)["fused"] else H
    y = torch.zeros(T, C, dtype=f32)
    for c0 in range(0, H, chunk):
        c1 = min(H, c0 + chunk)
        h = gelu_exact(torch.matmul(xf, w1b[:, c0:c1]) + b1[c0:c1])
        h = _keep(h, None if keep1 is None else keep1[:, c0:c1], inv)
        y = y + torch.matmul(h.to(bf16).to(f32), w2b[c0:c1])
    return _keep(y + b2, keep2, inv).to(bf16)


def order_backward(x, w1, b1, w2, g, keep1=None, keep2=None, rate=0.0, chunk_values=CHUNK_VALUES):
    """#12-bf16's order over plan16's row chunks: returns (dx, dw1, db1, dw2,
    db2) and the stored bf16 arrays (h, dz, g2) of the call."""
    f32, bf16 = torch.float32, torch.bfloat16
    T, C = x.shape
    H = w1.shape[1]
    P = plan16(T, C, H, True, chunk_values=chunk_values)
    inv = 1.0 / (1.0 - rate)
    w1b, w2b = w1.to(bf16).to(f32), w2.to(bf16).to(f32)
    parts = [[torch.zeros(C, H), torch.zeros(H, C)] for _ in range(P["splits"])]
    b1parts, b2parts, dx, stored = [], [], [], {"h": [], "dz": [], "g2": []}
    for c in range(P["chunks"]):
        r0 = c * P["rows"]
        r1 = min(T, r0 + P["rows"])
        k1 = None if keep1 is None else keep1[r0:r1]
        k2 = None if keep2 is None else keep2[r0:r1]
        xf = x[r0:r1].to(f32)
        g2 = _keep(g[r0:r1].to(f32), k2, inv)
        b2parts += [g2[r:r + BM].sum(0) for r in range(0, r1 - r0, BM)]
        g2b = g2.to(bf16)
        z = torch.matmul(xf, w1b) + b1
        h = _keep(gelu_exact(z), k1, inv).to(bf16)
        dz = _keep(torch.matmul(g2b.to(f32), w2b.t()), k1, inv) * gelu_grad_exact(z)
        b1parts += [dz[r:r + BM].sum(0) for r in range(0, r1 - r0, BM)]
        dzb = dz.to(bf16)
        dx.append(torch.matmul(dzb.to(f32), w1b.t()).to(bf16))
        for s, k0 in enumerate(range(0, r1 - r0, P["rows_per_split"])):
            k9 = k0 + P["rows_per_split"]
            parts[s][0] = parts[s][0] + torch.matmul(xf[k0:k9].t(), dzb[k0:k9].to(f32))
            parts[s][1] = parts[s][1] + torch.matmul(h[k0:k9].to(f32).t(), g2b[k0:k9].to(f32))
        for name, v in (("h", h), ("dz", dzb), ("g2", g2b)):
            stored[name].append(v)
    assert len(b1parts) == P["tiles"]
    grads = [torch.cat(dx)]
    for i, bparts in ((0, b1parts), (1, b2parts)):
        w = torch.zeros_like(parts[0][i])
        for p in parts:
            w = w + p[i]
        b = torch.zeros_like(bparts[0])
        for p in bparts:
            b = b + p
        grads += [w, b]
    return tuple(grads), {k: torch.cat(v) for k, v in stored.items()}


def _inputs(T, C, H, seed, rate=0.0):
    """Numpy-seeded bf16 x and g, f32 weights at a trained model's scale,
    masks at `rate` (None at 0), as torch tensors."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    x, g = bf(rng.normal(size=(T, C))), bf(rng.normal(size=(T, C)))
    w = [torch.from_numpy((rng.normal(size=s) * k).astype(np.float32))
         for s, k in zip([(C, H), (H,), (H, C), (C,)], [C**-0.5, 0.1, H**-0.5, 0.1])]
    keeps = (None, None)
    if rate:
        keeps = tuple(torch.from_numpy((rng.random(s) >= rate).astype(np.uint8))
                      for s in ((T, H), (T, C)))
    return x, w, g, keeps


def _rel(got, want):
    got, want = (np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)
                 for t in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jnp(t, dtype=jnp.float32):
    return jnp.asarray(t.float().numpy()).astype(dtype)


@pytest.mark.parametrize("C,H", WIDTHS)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_order_forward_matches_plain_and_jax(C, H, rate):
    """order_forward against fused_mlp_bf16_reference (the card's gate) and
    against the JAX kernel fed bf16: ``_mlp_fwd_impl`` in interpret mode at
    rate 0, its math ``_mlp_fwd_core`` on the kernel's operands with the
    same masks at rate 0.2."""
    T = 333
    x, (w1, b1, w2, b2), _, (k1, k2) = _inputs(T, C, H, C + H, rate)
    y = order_forward(x, w1, b1, w2, b2, k1, k2, rate)
    masks = () if k1 is None else (k1, k2, rate)
    assert y.dtype == torch.bfloat16
    assert _rel(y, fm.fused_mlp_bf16_reference(x, w1, b1, w2, b2, *masks)) <= CARD_FWD_TOL
    if rate == 0.0:
        want = _mlp_fwd_impl(_jnp(x, BF), *(_jnp(t) for t in (w1, b1, w2, b2)))
    else:
        want = _mlp_fwd_core(_jnp(x, BF), _jnp(w1, BF), _jnp(b1).reshape(1, -1), _jnp(w2, BF),
                             _jnp(b2).reshape(1, -1), jnp.asarray(k1.numpy() > 0),
                             jnp.asarray(k2.numpy() > 0), 1.0 / (1.0 - rate))[2].astype(BF)
    assert _rel(y, np.asarray(want.astype(jnp.float32))) <= FWD_TOL


@pytest.mark.parametrize("C,H", WIDTHS)
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("chunking", ["one", "several"])
def test_order_backward_matches_plain_and_jax(C, H, rate, chunking):
    """order_backward, in one row chunk and in three (128-row chunks of T =
    333), against fused_mlp_backward_bf16_reference (the card's gates) and
    the JAX kernel fed bf16: ``_mlp_bwd_impl`` in interpret mode at rate 0,
    ``_mlp_bwd_math`` with the same masks at rate 0.2. dx bf16, the rest
    f32."""
    T = 333
    x, (w1, b1, w2, b2), g, (k1, k2) = _inputs(T, C, H, 3 * C + H, rate)
    values = CHUNK_VALUES if chunking == "one" else BM * H
    assert plan16(T, C, H, True, chunk_values=values)["chunks"] == (1 if chunking == "one" else 3)
    got, _ = order_backward(x, w1, b1, w2, g, k1, k2, rate, chunk_values=values)
    masks = () if k1 is None else (k1, k2, rate)
    want = fm.fused_mlp_backward_bf16_reference(x, w1, b1, w2, b2, g, *masks)
    assert got[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in got[1:])
    for name, a, b in zip(NAMES, got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        assert _rel(a, b) <= CARD_GRAD_TOL, (name, _rel(a, b))
    if rate == 0.0:
        jwant = _mlp_bwd_impl(_jnp(x, BF), *(_jnp(t) for t in (w1, b1, w2, b2)), _jnp(g, BF))
    else:
        jwant = _mlp_bwd_math(_jnp(x, BF), _jnp(w1, BF), _jnp(b1).reshape(1, -1), _jnp(w2, BF),
                              _jnp(b2).reshape(1, -1), _jnp(g), jnp.asarray(k1.numpy() > 0),
                              jnp.asarray(k2.numpy() > 0), 1.0 / (1.0 - rate))
    for name, a, b in zip(NAMES, got, jwant):
        b = np.asarray(b.astype(jnp.float32)).reshape(tuple(a.shape))
        assert _rel(a, b) <= GRAD_TOL, (name, _rel(a, b))


@pytest.mark.parametrize("C,H", [(32, 64), (128, 512)])
def test_order_backward_stores_and_bias_partials(C, H):
    """What #12-bf16 stores is rounded once: h as the forward used it, dz and
    g2 are the bf16 roundings of their f32 values; db1 and db2 from the f32
    per-tile partials match the f32 sums to 1e-5 relative, where sums of the
    stored bf16 dz miss by more; the same bits on a second call."""
    T, rate = 333, 0.2
    x, (w1, b1, w2, _), g, (k1, k2) = _inputs(T, C, H, 5 * C, rate)
    got, stored = order_backward(x, w1, b1, w2, g, k1, k2, rate)
    again, _ = order_backward(x, w1, b1, w2, g, k1, k2, rate)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    f32, bf16, inv = torch.float32, torch.bfloat16, 1.0 / (1.0 - rate)
    z = torch.matmul(x.to(f32), w1.to(bf16).to(f32)) + b1
    g2 = torch.where(k2.bool(), g.to(f32) * inv, 0.0)
    dh = torch.where(k1.bool(), torch.matmul(g2.to(bf16).to(f32), w2.to(bf16).to(f32).t()) * inv,
                     0.0)
    dz = dh * gelu_grad_exact(z)
    assert torch.equal(stored["g2"], g2.to(bf16))
    assert torch.equal(stored["dz"], dz.to(bf16))
    assert torch.equal(stored["h"], torch.where(k1.bool(), gelu_exact(z) * inv, 0.0).to(bf16))
    assert _rel(got[2], dz.double().sum(0)) <= 1e-5
    assert _rel(got[4], g2.double().sum(0)) <= 1e-5
    assert _rel(stored["dz"].double().sum(0), dz.double().sum(0)) > _rel(got[2], dz.double().sum(0))
    assert torch.equal(got[2], _tile_sums(dz))


@pytest.mark.parametrize("C", list(range(8, 480, 8)))
def test_plan16_at_every_width_the_bf16_gate_admits(C):
    """Every width ``mlp_takes(C, H, bfloat16)`` admits (H = 2C and 4C) has a
    plan: the forward fused where C <= 256, else row chunks of at most 128
    MiB a [rows, H] bf16 array; the weight gradients' splits of whole
    64-row stages covering each chunk; at MOD_WIDE's stage 0 (T 73,728, C
    256, H 1,024) two chunks, the forward in one launch."""
    for H in (2 * C, 4 * C):
        if not fm.mlp_takes(C, H, torch.bfloat16):
            assert C > 256
            continue
        for T in (1, 333, 73728):
            fwd, bwd = plan16(T, C, H, False), plan16(T, C, H, True)
            assert fwd["fused"] == (C <= FUSED_MAX_C) and not bwd["fused"]
            for P in ([bwd] if fwd["fused"] else [fwd, bwd]):
                assert P["rows"] * H * 2 <= max(2 * CHUNK_VALUES, BM * H * 2)
                assert (P["chunks"] - 1) * P["rows"] < T <= P["chunks"] * P["rows"]
                assert P["chunks"] == 1 or P["rows"] % BM == 0
            assert bwd["rows_per_split"] % BK == 0
            assert (bwd["splits"] - 1) * bwd["rows_per_split"] < bwd["rows"]
            assert bwd["rows"] <= bwd["splits"] * bwd["rows_per_split"]
    if C == 256:
        assert plan16(73728, 256, 1024, True)["chunks"] == 2
        assert plan16(73728, 256, 1024, False)["fused"]
