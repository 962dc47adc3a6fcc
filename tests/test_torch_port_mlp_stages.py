"""The fused MLP kernels' phase order (#10-#12) in plain PyTorch, held on the
CPU against the plain MLP, the JAX package's MLP kernels and the 3xTF32
arithmetic of their tensor-core products.

On the card (csrc/fused_mlp.cu) a call runs over chunks of rows, each at
most CHUNK_FLOATS / H rows (a multiple of 128 where there are several, all
of one size but the last), every product over all the rows of a chunk:
  #10, #11: h = GELU(x W1 + b1) (keep1) into a workspace [rows, H];
      y = h W2 + b2 (keep2).
  #12: g2 = g keep2 / (1 - rate); z = x W1 + b1 and dh = g2 W2^T; dz =
      dh keep1 GELU'(z) and the h the forward used into workspaces;
      dx = dz W1^T; dW1 | db1 = x^T dz and the column sums of dz, dW2 | db2
      = h^T g2 and those of g2, as partials over fixed row splits of the
      chunk, a later chunk's added to the first chunk's in chunk order; the
      partials summed in split order.
``stages_forward`` and ``stages_backward`` run that order with every
product through ``gemm``: torch.matmul, or the plain emulation of the
kernels' 3xTF32 tensor-core product (``gemm_3xtf32_reference``).

Tolerance 1e-5 relative (max|got - want| / max|want|) for y and for each
gradient, at C = 64, 128, 256 (H = 4C) with T = 333 (not a multiple of any
tile), in one chunk and in three: against ``fused_mlp_reference`` and its
autograd backward (and the dropout form given numpy masks), against the
JAX ``_mlp_fwd_impl`` / ``_mlp_bwd_impl`` (Pallas in interpret mode; its
erf is a polynomial within 1.5e-7), and against the JAX kernels' own math
``_mlp_fwd_core`` / ``_mlp_bwd_math`` given the same masks. The emulation
is held to the card's f32 gates at the MLP's depths (K = 64, 256, 1024, and
split-K sums over thousands of rows), and one TF32 product is shown to
miss them.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from focal_tpu.ops import pallas_kernels as jpk
from focal_tpu_torch.ops import fused_mlp as fm
from focal_tpu_torch.ops import pallas_kernels as pk
from torch_port_threads import one_torch_thread  # noqa: F401

GEMMS = {"f32": torch.matmul, "3xtf32": pk.gemm_3xtf32_reference}
CHUNK_FLOATS = 1 << 25  # kChunkFloats in csrc/fused_mlp.cu
SMALL_CHUNKS = 1 << 15  # T = 333 in three chunks (128, 128, 77 rows) at every H here
BM = 128                # rows of a product tile (kGemmBM)
NAMES = ("dx", "dw1", "db1", "dw2", "db2")
TOL = 1e-5


def plan(T, C, H, chunk_floats=CHUNK_FLOATS, sms=132):
    """(rows a chunk, rows a weight-gradient split) as csrc/fused_mlp.cu's
    make_plan and gemm_splitk.cuh's split_rows set them on a card of
    ``sms`` SMs: 128 x 128 tiles (128 x 64 at C = 64), ~4 tiles an SM,
    >= 256 rows a split, a multiple of 32."""
    cap = max(BM, chunk_floats // H // BM * BM)
    chunks = -(-T // cap)
    rows = -(-T // chunks)
    if chunks > 1:
        rows = -(-rows // BM) * BM
    bn = 128 if H % 128 == 0 and C % 128 == 0 else 64
    tiles = -(-C // BM) * -(-H // bn) + -(-H // BM) * -(-C // bn)
    splits = max(1, min(-(-4 * sms // tiles), -(-rows // 256)))
    rps = -(-rows // splits)
    return rows, -(-rps // 32) * 32


def _masked(t, keep, rate):
    return t if keep is None else torch.where(keep.bool(), t / (1.0 - rate), 0.0)


def _gelu_grad(z):
    return 0.5 * (1.0 + torch.erf(z * 0.5**0.5)) + z * torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def stages_forward(x, w1, b1, w2, b2, keep1=None, keep2=None, rate=0.0, gemm=torch.matmul,
                   chunk_floats=CHUNK_FLOATS):
    """#10's (#11's with the masks) phase order: y and the chunks' h."""
    T, C = x.shape
    rows, _ = plan(T, C, w1.shape[1], chunk_floats)
    ys, hs = [], []
    for r0 in range(0, T, rows):
        sl = slice(r0, r0 + rows)
        h = _masked(F.gelu(gemm(x[sl], w1) + b1, approximate="none"),
                    None if keep1 is None else keep1[sl], rate)
        hs.append(h)
        ys.append(_masked(gemm(h, w2) + b2, None if keep2 is None else keep2[sl], rate))
    return torch.cat(ys), {"h": hs}


def stages_backward(x, w1, b1, w1_t, w2_t, g, keep1=None, keep2=None, rate=0.0,
                    gemm=torch.matmul, chunk_floats=CHUNK_FLOATS):
    """#12's phase order: (dx, dw1, db1, dw2, db2) and the workspaces of
    each chunk {h (as used), dz, g2} with the split partials."""
    T, C = x.shape
    H = w1.shape[1]
    rows, rps = plan(T, C, H, chunk_floats)
    dxs, chunks, partials = [], [], []
    for r0 in range(0, T, rows):
        sl = slice(r0, r0 + rows)
        xc = x[sl]
        g2 = _masked(g[sl], None if keep2 is None else keep2[sl], rate)
        z = gemm(xc, w1) + b1
        dh = gemm(g2, w2_t)
        k1 = None if keep1 is None else keep1[sl]
        dz = _masked(dh * _gelu_grad(z), k1, rate)
        h = _masked(F.gelu(z, approximate="none"), k1, rate)
        dxs.append(gemm(dz, w1_t))
        parts = [torch.cat([gemm(xc[s].t().contiguous(), dz[s]).flatten(), dz[s].sum(0),
                            gemm(h[s].t().contiguous(), g2[s]).flatten(), g2[s].sum(0)])
                 for s in (slice(s0, s0 + rps) for s0 in range(0, len(xc), rps))]
        # a later chunk adds to the first chunk's partials (it has no more splits)
        partials = parts if not partials else (
            [p + q for p, q in zip(partials, parts)] + partials[len(parts):])
        chunks.append({"h": h, "dz": dz, "g2": g2, "splits": len(parts)})
    total = torch.zeros_like(partials[0])
    for p in partials:  # in split order, as reduce_partials_kernel
        total = total + p
    ch = C * H
    grads = (torch.cat(dxs), total[:ch].view(C, H), total[ch:ch + H],
             total[ch + H:2 * ch + H].view(H, C), total[2 * ch + H:])
    return grads, {"chunks": chunks, "partials": partials}


def _case(C, seed, rate=0.0, T=333):
    """x, w1, b1, w2, b2, g at a trained model's scale, and numpy keep masks
    at ``rate`` (None at 0)."""
    rng = np.random.default_rng(seed)
    H = 4 * C
    shapes = [(T, C), (C, H), (H,), (H, C), (C,), (T, C)]
    scales = [1.0, C**-0.5, 0.1, H**-0.5, 0.1, 1.0]
    arrs = [(rng.normal(size=s) * k).astype(np.float32) for s, k in zip(shapes, scales)]
    keeps = (None, None)
    if rate:
        keeps = ((rng.random((T, H)) >= rate).astype(np.uint8),
                 (rng.random((T, C)) >= rate).astype(np.uint8))
    return arrs, keeps


def _torch(arrs, keeps):
    t = [torch.from_numpy(a) for a in arrs]
    return t, [None if k is None else torch.from_numpy(k) for k in keeps]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _backward_args(t):
    x, w1, b1, w2, _, g = t
    return x, w1, b1, w1.t().contiguous(), w2.t().contiguous(), g


CHUNKINGS = {"one": CHUNK_FLOATS, "three": SMALL_CHUNKS}


@pytest.mark.parametrize("gemm", sorted(GEMMS))
@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_stages_forward_match_the_plain_mlp(gemm, C, rate, chunking):
    arrs, keeps = _case(C, C + int(10 * rate), rate)
    t, (k1, k2) = _torch(arrs, keeps)
    y, ws = stages_forward(*t[:5], k1, k2, rate, GEMMS[gemm], CHUNKINGS[chunking])
    if rate:
        want = fm.fused_mlp_dropout_reference(*t[:5], k1, k2, rate)
    else:
        want = fm.fused_mlp_reference(*t[:5])
    assert _rel(y, want) <= TOL
    assert len(ws["h"]) == (3 if chunking == "three" else 1)
    assert [h.shape[1] for h in ws["h"]] == [4 * C] * len(ws["h"])


@pytest.mark.parametrize("gemm", sorted(GEMMS))
@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_stages_backward_match_autograd_of_the_plain_mlp(gemm, C, rate, chunking):
    arrs, keeps = _case(C, 2 * C + int(10 * rate), rate)
    t, (k1, k2) = _torch(arrs, keeps)
    got, ws = stages_backward(*_backward_args(t), k1, k2, rate, GEMMS[gemm], CHUNKINGS[chunking])
    want = fm.fused_mlp_backward_reference(*t, k1, k2, rate)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= TOL, (name, _rel(a, b))
    assert len(ws["chunks"]) == (3 if chunking == "three" else 1)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_stages_backward_workspaces(rate):
    """T 5,000 at C 64 in three chunks of 1,792 rows (the last 1,416), 7
    splits of 256 rows a chunk (the last 6): h is the forward's h as used
    and dz the gradient of z (autograd through the plain forward); the
    partials (each the sum of the chunks' partials of one split) sum to the
    whole products."""
    C, T, chunk_floats = 64, 5000, 1 << 19
    arrs, keeps = _case(C, 3 + int(10 * rate), rate, T=T)
    t, (k1, k2) = _torch(arrs, keeps)
    x, w1, b1, w2, b2, g = t
    _, ws = stages_backward(*_backward_args(t), k1, k2, rate, chunk_floats=chunk_floats)
    rows, rps = plan(T, C, 4 * C, chunk_floats)
    assert (rows, rps) == (1792, 256) and [c["splits"] for c in ws["chunks"]] == [7, 7, 6]
    _, fwd = stages_forward(x, w1, b1, w2, b2, k1, k2, rate, chunk_floats=chunk_floats)
    with torch.enable_grad():
        z = (x @ w1 + b1).requires_grad_(True)
        h = _masked(F.gelu(z, approximate="none"), k1, rate)
        y = _masked(h @ w2 + b2, k2, rate)
        (dz,) = torch.autograd.grad(y, z, g)
    for c, chunk in enumerate(ws["chunks"]):
        sl = slice(c * rows, (c + 1) * rows)
        assert _rel(chunk["h"], fwd["h"][c]) == 0.0
        assert _rel(chunk["dz"], dz[sl]) <= 1e-6
    whole = torch.cat([(x.t() @ dz).flatten(), dz.sum(0)])
    got = sum(ws["partials"])[:whole.numel()]
    assert _rel(got, whole) <= TOL


@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_stages_match_the_jax_kernels(C, chunking):
    """The 3xTF32 phase order against the JAX package's Pallas MLP kernels
    (interpret mode), rate 0: y and the five gradients."""
    arrs, _ = _case(C, 4 * C)
    t, _ = _torch(arrs, (None, None))
    chunk_floats = CHUNKINGS[chunking]
    y, _ = stages_forward(*t[:5], gemm=pk.gemm_3xtf32_reference, chunk_floats=chunk_floats)
    got, _ = stages_backward(*_backward_args(t), gemm=pk.gemm_3xtf32_reference,
                             chunk_floats=chunk_floats)
    j = [jnp.asarray(a) for a in arrs]
    assert _rel(y, jpk._mlp_fwd_impl(*j[:5])) <= TOL
    for name, a, b in zip(NAMES, got, jpk._mlp_bwd_impl(*j)):
        assert _rel(a, b) <= TOL, (name, _rel(a, b))


@pytest.mark.parametrize("C", [64, 128, 256])
def test_stages_dropout_match_the_jax_kernel_math(C):
    """The dropout forms (three chunks, 3xTF32) against the JAX kernels' own
    math given the same masks (the JAX dropout kernels need the TPU's
    generator)."""
    rate = 0.2
    arrs, keeps = _case(C, 5 * C, rate)
    t, (k1, k2) = _torch(arrs, keeps)
    y, _ = stages_forward(*t[:5], k1, k2, rate, pk.gemm_3xtf32_reference, SMALL_CHUNKS)
    got, _ = stages_backward(*_backward_args(t), k1, k2, rate, pk.gemm_3xtf32_reference,
                             SMALL_CHUNKS)
    j = [jnp.asarray(a) for a in arrs]
    jk1, jk2 = jnp.asarray(keeps[0].astype(bool)), jnp.asarray(keeps[1].astype(bool))
    inv = 1.0 / (1.0 - rate)
    _, _, want_y = jpk._mlp_fwd_core(*j[:5], jk1, jk2, inv)
    assert _rel(y, want_y) <= TOL
    want = jpk._mlp_bwd_math(*j, jk1, jk2, inv)
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b).reshape(a.shape)
        assert _rel(a, b) <= TOL, (name, _rel(a, b))


def test_plan_at_the_mlp_geometries():
    """MOD's MLPs (batch 128: T up to 73,728 at H 256) run in one chunk;
    MOD_WIDE's stage 0 (H 1,024, batch 128) in two (seismic, T 36,864) and
    three (audio, T 73,728) chunks of equal rows, each [rows, H] workspace
    within 128 MiB; the splits fill a 132-SM card about four times over."""
    for T, C in ((36864, 64), (73728, 64), (9216, 128), (18432, 128), (2304, 256), (4608, 256)):
        assert plan(T, C, 4 * C)[0] == T
    for T, chunks in ((36864, 2), (73728, 3)):
        rows, rps = plan(T, 256, 1024)
        assert rows * chunks == T and rows % BM == 0 and rows * 1024 * 4 <= 128 * 2**20
        assert -(-rows // rps) == 17 and rps % 32 == 0
    rows, rps = plan(36864, 64, 256)
    assert -(-rows // rps) == 83  # 6 tiles of 128 x 64 a split: 498 blocks


@pytest.mark.parametrize("K", [64, 256, 1024])
def test_3xtf32_emulation_holds_the_gates_at_the_mlp_depths(K):
    """The MLP's products at depth K = C or H (unit activations, weights of
    std K**-0.5): 3xTF32 meets the card's gates (1e-4 absolute on O(1)
    outputs, 1e-5 relative), one TF32 product misses the relative gate."""
    rng = np.random.default_rng(K)
    a = rng.normal(size=(512, K)).astype(np.float32)
    b = (rng.normal(size=(K, 512)) * K**-0.5).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    three = pk.gemm_3xtf32_reference(torch.from_numpy(a), torch.from_numpy(b))
    one = pk.gemm_3xtf32_reference(torch.from_numpy(a), torch.from_numpy(b), passes=1)
    assert np.abs(three.double().numpy() - exact).max() <= 1e-4 and _rel(three, exact) <= TOL
    assert _rel(one, exact) > 2e-4


def test_3xtf32_emulation_holds_the_gates_in_split_k_weight_gradients():
    """dW1 = x^T dz over 4,416 rows in 3 splits of 1,472 (a split of MOD_WIDE
    audio stage 0, C 256, H 1,024) as partials of 3xTF32 products summed in
    split order, against float64: 1e-5 relative; one TF32 product a split
    misses."""
    rng = np.random.default_rng(3)
    R, rps = 4416, 1472
    x = rng.normal(size=(R, 256)).astype(np.float32)
    dz = (rng.normal(size=(R, 1024)) * 0.05).astype(np.float32)
    exact = x.T.astype(np.float64) @ dz.astype(np.float64)
    sums = {}
    for passes in (3, 1):
        total = torch.zeros(256, 1024)
        for s0 in range(0, R, rps):
            total = total + pk.gemm_3xtf32_reference(torch.from_numpy(x[s0:s0 + rps].T.copy()),
                                                     torch.from_numpy(dz[s0:s0 + rps]), passes)
        sums[passes] = total
    assert _rel(sums[3], exact) <= TOL
    assert _rel(sums[1], exact) > 2e-4
