"""The conv-tower kernels' plan and phase order (#13, #14) in plain PyTorch,
held on the CPU against the plain tower, autograd, the JAX package's Pallas
tower and the 3xTF32 arithmetic of their tensor-core products.

On the card (csrc/conv_tower.cu) every conv over cin % 4 == 0 channels is
an implicit-im2col product over all R*S rows (tap j of the K-slice reads
rows g + j - lo, zero where the position leaves the sample), 3xTF32 in
128 x 128 or 128 x 64 tiles, with each row tile's Σc and Σc² as partials
summed in tile order; the apply is one pass writing a_k. The backward runs
the column sums Σgy and Σgy·x̂ per 256-row block (summed in block order),
dc in one pass, the transposed conv (the shifts negated, B the per-tap
W^T) and dW | db as partials over fixed row splits summed in split order.
The seismic first conv (cin 2) runs in f32 on the CUDA cores, its sums per
256-row block. ``stages_forward`` and ``stages_backward`` in
``ops/conv_tower.py`` run that order with every product through ``gemm``:
torch.matmul or the plain emulation of the 3xTF32 product
(``gemm_3xtf32_reference``).

Geometries: the real widths (C 64 of MOD, 256 of MOD_WIDE; KW 3 for the
seismic tower with its first conv inside, KW 5 for the audio one with its
first conv outside; S 20; five layers) at R = 24 rows (480 rows of
positions: three full 128-row tiles and a ragged one).

Tolerance 1e-5 relative (max|got - want| / max|want|) for the output, the
batch statistics and every gradient, against ``fused_conv_tower_reference``
and its autograd backward and against the JAX ``fused_conv_tower`` in
interpret mode; a conv bias before a BatchNorm has a true gradient of 0,
and both sides hold only cancellation noise, so its gradient is held
absolutely to 1e-5 of its layer's weight gradient. The emulation is held
to the card's f32 gates at the tower's depths (K = 192, 320, 768, 1280,
and weight gradients over R*S-deep row splits), and one TF32 product is
shown to miss them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.ops.conv_tower import fused_conv_tower as jax_fused_conv_tower
from focal_tpu_torch.ops import conv_tower as ct
from focal_tpu_torch.ops import pallas_kernels as pk
from torch_port_threads import one_torch_thread  # noqa: F401

GEMMS = {"f32": torch.matmul, "3xtf32": pk.gemm_3xtf32_reference}
TOL = 1e-5
SAMPLES, INTERVALS, S, LAYERS = 3, 8, 20, 5
R = SAMPLES * INTERVALS


def _case(C, external, seed):
    """numpy inputs at a trained model's scale: unit activations, lecun-scaled
    weights, BN affine near (1, 0), per-sample Dropout2d masks of rate 0.2,
    and an output gradient; the layer configs (kw, cin, cout, residual)."""
    rng = np.random.default_rng(seed)
    kw = 5 if external else 3
    cin0 = C if external else 2
    cfgs = tuple((kw, cin0 if k == 0 else C, C, k > 0) for k in range(LAYERS))
    x0 = rng.normal(size=(R, S, cin0)).astype(np.float32)
    ws, bs, scales, biases, masks = [], [], [], [], []
    for k, (kwk, cin, cout, _) in enumerate(cfgs):
        ws.append(np.zeros((1, 1), np.float32) if (external and k == 0) else
                  (rng.normal(size=(kwk * cin, cout)) * (kwk * cin) ** -0.5).astype(np.float32))
        bs.append((rng.normal(size=cout) * 0.1).astype(np.float32))
        scales.append((1.0 + 0.1 * rng.normal(size=cout)).astype(np.float32))
        biases.append((0.1 * rng.normal(size=cout)).astype(np.float32))
        masks.append(((rng.random((SAMPLES, cout)) > 0.2) / 0.8).astype(np.float32))
    dy = rng.normal(size=(R, S, C)).astype(np.float32)
    return cfgs, x0, [ws, bs, scales, biases], masks, dy


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _stages(cfgs, x0, params, masks, dy, external, gemm):
    """stages_forward then stages_backward on torch copies of the inputs."""
    p = [_t(g) for g in params]
    y, mus, vars_, saved = ct.stages_forward(torch.from_numpy(x0), cfgs, *p, _t(masks), external,
                                             gemm)
    grads, partials = ct.stages_backward(saved, cfgs, p[0], _t(masks), torch.from_numpy(dy),
                                         external, gemm)
    return (y, mus, vars_), grads, partials


def _check_grads(grads, want, external):
    """grads and want as (dx0, dws, dbs, dscales, dbiases): 1e-5 relative;
    each conv bias absolutely to 1e-5 of its layer's weight gradient (its
    true gradient is 0: both sides hold cancellation noise)."""
    dx0, dws, dbs, dscales, dbiases = grads
    assert _rel(dx0, want[0]) <= TOL, ("dx0", _rel(dx0, want[0]))
    for k in range(LAYERS):
        if external and k == 0:
            continue  # the first conv runs outside the tower: placeholders
        assert _rel(dws[k], want[1][k]) <= TOL, ("dw", k, _rel(dws[k], want[1][k]))
        scale = float(np.abs(np.asarray(want[1][k])).max())
        assert np.abs(np.asarray(dbs[k]) - np.asarray(want[2][k])).max() <= TOL * scale, ("db", k)
    for name, got, ref in (("dscale", dscales, want[3]), ("dbias", dbiases, want[4])):
        for k in range(LAYERS):
            assert _rel(got[k], ref[k]) <= TOL, (name, k, _rel(got[k], ref[k]))


@pytest.mark.parametrize("gemm", sorted(GEMMS))
@pytest.mark.parametrize("C", [64, 256])
@pytest.mark.parametrize("external", [False, True])
def test_stages_match_the_plain_tower_and_its_autograd(gemm, C, external):
    cfgs, x0, params, masks, dy = _case(C, external, C + external)
    (y, mus, vars_), grads, _ = _stages(cfgs, x0, params, masks, dy, external, GEMMS[gemm])
    leaves = [torch.from_numpy(x0).requires_grad_(True)] + [
        [torch.from_numpy(a).requires_grad_(True) for a in g] for g in params]
    ry, rmus, rvars = ct.fused_conv_tower_reference(leaves[0], cfgs, *leaves[1:], _t(masks),
                                                    external)
    assert tuple(y.shape) == (R, S, C)
    assert _rel(y, ry.detach()) <= TOL
    for a, b in zip(mus + vars_, rmus + rvars):
        assert _rel(a, b) <= TOL
    flat = [leaves[0]] + [p for g in leaves[1:] for p in g]
    got = torch.autograd.grad(ry, flat, torch.from_numpy(dy), allow_unused=True)
    z = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, got)]
    want = (z[0], *[z[1 + i * LAYERS:1 + (i + 1) * LAYERS] for i in range(4)])
    _check_grads(grads, want, external)


@pytest.mark.parametrize("C", [64, 256])
@pytest.mark.parametrize("external", [False, True])
def test_stages_match_the_jax_tower(C, external):
    """The 3xTF32 phase order against the JAX package's Pallas tower
    (interpret mode): output, statistics and the VJP of sum(y * dy)."""
    cfgs, x0, params, masks, dy = _case(C, external, 2 * C + external)
    (y, mus, vars_), grads, _ = _stages(cfgs, x0, params, masks, dy, external,
                                        pk.gemm_3xtf32_reference)
    rows = [jnp.asarray(np.repeat(m, INTERVALS, axis=0)) for m in masks]

    def loss(x0, ws, bs, scales, biases):
        jy, jmus, jvars = jax_fused_conv_tower(x0, cfgs, ws, bs, scales, biases, rows,
                                               external_c0=external)
        return jnp.sum(jy * dy), (jy, jmus, jvars)

    (_, (jy, jmus, jvars)), want = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        jnp.asarray(x0), *[tuple(jnp.asarray(a) for a in g) for g in params])
    assert _rel(y, jy) <= TOL
    for a, b in zip(mus + vars_, tuple(jmus) + tuple(jvars)):
        assert _rel(a, b) <= TOL
    _check_grads(grads, want, external)


@pytest.mark.parametrize("kw", [3, 5])
@pytest.mark.parametrize("C", [64, 256])
def test_row_shift_products_are_the_same_conv_and_its_transpose(kw, C):
    """The implicit im2col (rows shifted within their sample, zero rows at
    the sample edges) gives the plain SAME conv, and with the shifts
    negated and B the per-tap W^T its transpose (autograd of the conv)."""
    rng = np.random.default_rng(kw + C)
    x = torch.from_numpy(rng.normal(size=(R, S, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(kw * C, C)) * (kw * C) ** -0.5).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(R * S, C)).astype(np.float32))
    cols = ct.im2col_rows(x.reshape(R * S, C), kw, S)
    lo = (kw - 1) // 2
    assert float(cols[0::S, :lo * C].abs().max()) == 0.0  # position 0: no left taps
    assert float(cols[S - 1::S, (lo + 1) * C:].abs().max()) == 0.0  # position S - 1: no right
    assert _rel(cols @ w, ct._conv_same(x, w, kw).reshape(R * S, C)) <= TOL
    xl = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(ct._conv_same(xl, w, kw).reshape(R * S, C), xl, g)
    got = ct.im2col_rows(g, kw, S, sign=-1) @ ct.tap_transpose(w, kw, C, C)
    assert _rel(got, want.reshape(R * S, C)) <= TOL


def test_the_seismic_first_conv_runs_on_the_cuda_cores():
    """cin 2 is no multiple of 4: the narrow route, its sums per 256-row
    block; its f32 conv, transposed conv and weight gradient are the plain
    ones. Every other layer of either tower takes the products."""
    cfgs, x0, params, masks, dy = _case(64, False, 5)
    assert [ct.on_tensor_cores(cin) for _, cin, _, _ in cfgs] == [False] + [True] * (LAYERS - 1)
    x2 = torch.from_numpy(x0).reshape(R * S, 2)
    w, b = torch.from_numpy(params[0][0]), torch.from_numpy(params[1][0])
    c, sums, partials = ct.stages_conv(x2, w, b, 3, S, gemm=pk.gemm_3xtf32_reference)
    assert len(partials) == -(-R * S // ct.STAT_ROWS) == 2
    assert _rel(c, (ct._conv_same(torch.from_numpy(x0), w, 3) + b).reshape(R * S, 64)) <= 1e-6
    assert _rel(sums, torch.stack([c.sum(0), (c * c).sum(0)])) <= 1e-6
    _, grads, parts = _stages(cfgs, x0, params, masks, dy, False, pk.gemm_3xtf32_reference)
    plan = ct.layer_plan(R, S, 3, 2, 64)
    assert not plan["tensor_cores"] and len(parts[0]) == plan["splits"]
    assert [len(p) for p in parts[1:]] == [ct.layer_plan(R, S, 3, 64, 64)["splits"]] * (LAYERS - 1)


def test_tile_sums_and_splits_are_summed_in_order():
    """The forward's Σc, Σc² partials (one per 128-row tile, the last
    ragged) and the weight gradient's split partials, each summed in
    order, give the whole sums."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(R * S, 64)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(192, 64)) * 192**-0.5).astype(np.float32))
    c, sums, partials = ct.stages_conv(x, w, torch.zeros(64), 3, S)
    assert len(partials) == 4 and partials[-1].shape == (2, 64)
    assert _rel(sums, torch.stack([c.sum(0), (c * c).sum(0)])) <= 1e-6
    cfgs, x0, params, masks, dy = _case(64, True, 8)
    _, (_, dws, dbs, _, _), parts = _stages(cfgs, x0, params, masks, dy, True, torch.matmul)
    plan = ct.layer_plan(R, S, 5, 64, 64)
    assert plan["rows_per_split"] == 256 and plan["splits"] == 2 == len(parts[1])
    total = ct.ordered_sum(parts[1])
    assert torch.equal(total, parts[1][0] + parts[1][1])
    assert torch.equal(total[:-64].view(320, 64), dws[1]) and torch.equal(total[-64:], dbs[1])


# the towers of one DeepSense pretrain step (views fused): (dataset, R,
# layers as (kw, cin)), C and S 20 throughout
GEOMETRIES = {
    "MOD seismic": (5120, 64, [(3, 2)] + [(3, 64)] * 4),
    "MOD audio": (5120, 64, [(5, 64)] * 4),
    "MOD_WIDE seismic": (2560, 256, [(3, 2)] + [(3, 256)] * 4),
    "MOD_WIDE audio": (2560, 256, [(5, 256)] * 4),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plan_at_the_tower_geometries(name):
    """On a 132-SM card: the forward's partials per 128-row tile (per
    256-row block for the seismic first conv), the weight gradients' tiles
    and splits (~4 blocks an SM, >= 256 rows and a multiple of 32 a split),
    and each workspace (dc, W^T and the split partials for the backward
    apply)."""
    R_, C, layers = GEOMETRIES[name]
    RS = R_ * S
    for kw, cin in layers:
        p = ct.layer_plan(R_, S, kw, cin, C)
        assert p["tensor_cores"] == (cin != 2)
        assert p["fwd_partials"] == (-(-RS // 128) if cin != 2 else -(-RS // 256))
        assert p["stat_blocks"] == -(-RS // 256)
        assert p["rows_per_split"] % 32 == 0 and p["rows_per_split"] >= 256
        assert (p["splits"] - 1) * p["rows_per_split"] < RS <= p["splits"] * p["rows_per_split"]
        ws = p["workspace"]
        assert ws["forward"] == p["fwd_partials"] * 2 * C
        assert ws["bwd_apply"] == RS * C + (kw * C * cin if cin != 2 else 0) + p["splits"] * p["E"]
    want = {  # (bn, tiles, splits, rows a split) of the first and the last layer
        "MOD seismic": ((None, 1, 400, 256), (64, 2, 247, 416)),
        "MOD audio": ((64, 3, 169, 608), (64, 3, 169, 608)),
        "MOD_WIDE seismic": ((None, 1, 200, 256), (128, 12, 44, 1184)),
        "MOD_WIDE audio": ((128, 20, 27, 1920), (128, 20, 27, 1920)),
    }[name]
    for (kw, cin), w in zip((layers[0], layers[-1]), want):
        p = ct.layer_plan(R_, S, kw, cin, C)
        assert (p["bn"], p["wgrad_tiles"], p["splits"], p["rows_per_split"]) == w, (kw, cin, p)


@pytest.mark.parametrize("K", [192, 320, 768, 1280])
def test_3xtf32_emulation_holds_the_gates_at_the_tower_depths(K):
    """The convs' products at depth K = KW * C (unit activations, weights of
    std K**-0.5): 3xTF32 meets the card's gates (1e-4 absolute on O(1)
    outputs, 1e-5 relative), one TF32 product misses the relative gate."""
    rng = np.random.default_rng(K)
    a = rng.normal(size=(512, K)).astype(np.float32)
    b = (rng.normal(size=(K, 256)) * K**-0.5).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    three = pk.gemm_3xtf32_reference(torch.from_numpy(a), torch.from_numpy(b))
    one = pk.gemm_3xtf32_reference(torch.from_numpy(a), torch.from_numpy(b), passes=1)
    assert np.abs(three.double().numpy() - exact).max() <= 1e-4 and _rel(three, exact) <= TOL
    assert _rel(one, exact) > 2e-4


@pytest.mark.parametrize("name", ["MOD audio", "MOD_WIDE audio"])
def test_3xtf32_emulation_holds_the_gates_in_split_k_weight_gradients(name):
    """dW = im2col(a)^T dc over four of the plan's row splits (608 rows of
    320 columns at MOD, 1,920 of 1,280 at MOD_WIDE) as partials of 3xTF32
    products summed in split order, against float64: 1e-5 relative; one
    TF32 product a split misses."""
    R_, C, layers = GEOMETRIES[name]
    kw, cin = layers[-1]
    rps = ct.layer_plan(R_, S, kw, cin, C)["rows_per_split"]
    rng = np.random.default_rng(rps)
    rows = 4 * rps
    a = rng.normal(size=(rows, kw * cin)).astype(np.float32)
    dc = (rng.normal(size=(rows, C)) * 0.05).astype(np.float32)
    exact = a.T.astype(np.float64) @ dc.astype(np.float64)
    sums = {}
    for passes in (3, 1):
        sums[passes] = ct.ordered_sum([
            pk.gemm_3xtf32_reference(torch.from_numpy(a[r0:r0 + rps].T.copy()),
                                     torch.from_numpy(dc[r0:r0 + rps]), passes)
            for r0 in range(0, rows, rps)])
    assert _rel(sums[3], exact) <= TOL
    assert _rel(sums[1], exact) > 2e-4
