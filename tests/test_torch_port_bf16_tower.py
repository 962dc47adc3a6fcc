"""The conv tower's bf16 forms (#13-bf16, #14-bf16) on the CPU: the port's
plain bf16 tower (``fused_conv_tower`` on a bf16 x0, whose CPU path is
``_ConvTowerBf16`` with ``plain``) and the kernels' phase order in bf16
(``stages_forward``/``stages_backward`` with ``dtype=torch.bfloat16``)
against the JAX package's ``fused_conv_tower`` fed bf16 x0 and weights
(its Pallas kernels in interpret mode), forward and VJP.

Three geometries, R = 32 rows of S = 16 positions, C = 32, as the JAX
package's ConvBlock hands them at ``dtype=bfloat16``: an internal first
conv over cin 8 (KW 3, three layers: the bf16 products' loader takes cin
8), an external first conv (x0 its bf16 output, KW 5, two layers) and the
two-location ``mod_extractor``'s cin-1 KW-4 first conv (three layers, on
the CUDA cores). Masks at rate 0.2 per sample. The same numpy inputs go to
both sides; a bf16 cotangent for the VJP.

Tolerances. Both sides round at the same points; the f32 sums run in
another order, so a bf16 rounding of c, a, dc or dprev can land one bf16
step (2^-8 relative) apart, and that spreads through the later layers:
  * a (bf16): 2^-8 of max|a| (measured <= 3e-7);
  * the batch means and variances (f32, from the stored bf16 c): 1e-5
    relative (measured <= 4e-7);
  * dx0 (bf16): 1e-2 relative (measured <= 1.3e-3, a bf16 step at a few
    elements); dws, dscales and dbiases (f32): 1e-3 relative (measured <=
    7e-5); dbs, the conv biases' gradients, whose true value is 0 (a
    BatchNorm follows), absolutely: within 1e-4 of JAX's (both are the f32
    dc's cancellation noise, <= 3e-5; measured <= 3e-5 apart).
``stages_forward``/``stages_backward`` in bf16 are held to the same gates,
and to the plain bf16 tower (the same rounding points, another order of
sums) at half of them. ``tower_takes(..., torch.bfloat16)`` equals the JAX
package's ``tower_fits(..., jnp.bfloat16)`` at every packaged recipe's
geometry where the kernels take the widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.ops.conv_tower import fused_conv_tower as jax_fused_conv_tower
from focal_tpu.ops.conv_tower import tower_fits as jax_tower_fits
from focal_tpu_torch.ops import conv_tower as ct
from focal_tpu_torch.params import load_dataset_config
from torch_port_threads import one_torch_thread  # noqa: F401

R, S, SAMPLES, C = 32, 16, 8, 32
GEOMETRIES = {
    "internal_cin8_kw3": (((3, 8, C, False), (3, C, C, True), (3, C, C, True)), False),
    "external_kw5": (((5, C, C, False), (5, C, C, True)), True),
    "mod_extractor_cin1_kw4": (((4, 1, C, False), (4, C, C, True), (4, C, C, True)), False),
}
A_TOL = 2.0**-8
STATS_TOL = 1e-5
DX_TOL = 1e-2
GRAD_TOL = 1e-3
BIAS_GRAD_ABS = 1e-4
BF16 = jnp.bfloat16


def _inputs(seed, cfgs, external):
    """x0 (bf16 values), the f32 weights, biases, BN affines, per-sample
    masks at rate 0.2 and a bf16 cotangent, as numpy f32."""
    rng = np.random.default_rng(seed)
    cin0 = cfgs[0][2] if external else cfgs[0][1]

    def bf(a):
        return np.array(jnp.asarray(a, jnp.float32).astype(BF16).astype(jnp.float32))

    x0 = bf(rng.normal(size=(R, S, cin0)))
    ws, bs, scales, biases, masks = [], [], [], [], []
    for kw, cin, cout, _ in cfgs:
        ws.append((rng.normal(size=(kw * cin, cout)) * (kw * cin) ** -0.5).astype(np.float32))
        bs.append((rng.normal(size=(cout,)) * 0.1).astype(np.float32))
        scales.append((1.0 + 0.1 * rng.normal(size=(cout,))).astype(np.float32))
        biases.append((0.1 * rng.normal(size=(cout,))).astype(np.float32))
        masks.append(((rng.random((SAMPLES, cout)) > 0.2) / 0.8).astype(np.float32))
    dy = bf(rng.normal(size=(R, S, cfgs[-1][2])))
    return x0, ws, bs, scales, biases, masks, dy


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def case(request):
    """One geometry: the inputs and the JAX tower's bf16 forward and VJP
    (a, mus, vars, (dx0, dws, dbs, dscales, dbiases)), once for the file."""
    cfgs, external = GEOMETRIES[request.param]
    x0, ws, bs, scales, biases, masks, dy = _inputs(sorted(GEOMETRIES).index(request.param),
                                                    cfgs, external)
    rows = [jnp.asarray(np.repeat(m, R // SAMPLES, axis=0)) for m in masks]

    def tower(x0, ws, bs, scales, biases):
        return jax_fused_conv_tower(x0, cfgs, [w.astype(BF16) for w in ws], bs, scales, biases,
                                    rows, external_c0=external)

    (a, mus, vars_), vjp = jax.vjp(
        tower, jnp.asarray(x0).astype(BF16), *[[jnp.asarray(v) for v in t]
                                                for t in (ws, bs, scales, biases)])
    zeros = tuple(jnp.zeros_like(m) for m in mus)
    grads = vjp((jnp.asarray(dy).astype(BF16), zeros, zeros))
    jax_out = {"a": np.asarray(a.astype(jnp.float32)), "mus": [np.asarray(m) for m in mus],
               "vars": [np.asarray(v) for v in vars_], "dx0": np.asarray(grads[0].astype(jnp.float32)),
               "dws": [np.asarray(g) for g in grads[1]], "dbs": [np.asarray(g) for g in grads[2]],
               "dscales": [np.asarray(g) for g in grads[3]],
               "dbiases": [np.asarray(g) for g in grads[4]]}
    assert a.dtype == BF16 and grads[0].dtype == BF16
    assert all(g.dtype == jnp.float32 for t in grads[1:] for g in t)
    return request.param, cfgs, external, (x0, ws, bs, scales, biases, masks, dy), jax_out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _plain(cfgs, external, inputs):
    """The port's CPU path on a bf16 x0: (a, mus, vars, grads by name)."""
    x0, ws, bs, scales, biases, masks, dy = inputs
    leaves = [torch.from_numpy(x0).to(torch.bfloat16).requires_grad_(True)] + [
        [torch.from_numpy(a).requires_grad_(True) for a in t] for t in (ws, bs, scales, biases)]
    a, mus, vars_ = ct.fused_conv_tower(leaves[0], cfgs, *leaves[1:], _t(masks), external)
    a.backward(torch.from_numpy(dy).to(torch.bfloat16))
    grads = {"dx0": leaves[0].grad}
    for name, group in zip(("dws", "dbs", "dscales", "dbiases"), leaves[1:]):
        grads[name] = [torch.zeros_like(p) if p.grad is None else p.grad for p in group]
    return a.detach(), mus, vars_, grads


def _stages(cfgs, external, inputs, sms=132):
    """stages_forward then stages_backward in bf16 on a card of ``sms``
    SMs: (a, mus, vars, grads)."""
    x0, ws, bs, scales, biases, masks, dy = inputs
    p = [_t(t) for t in (ws, bs, scales, biases)]
    a, mus, vars_, saved = ct.stages_forward(torch.from_numpy(x0), cfgs, *p, _t(masks), external,
                                             dtype=torch.bfloat16, sms=sms)
    (dx0, dws, dbs, dscales, dbiases), _ = ct.stages_backward(
        saved, cfgs, p[0], _t(masks), torch.from_numpy(dy), external, sms=sms,
        dtype=torch.bfloat16)
    return a, mus, vars_, {"dx0": dx0, "dws": dws, "dbs": dbs, "dscales": dscales,
                           "dbiases": dbiases}


def _check(cfgs, external, got, want, scale=1.0):
    """got (a, mus, vars, grads) against want (the JAX dict's layout) at
    the file's tolerances times ``scale``."""
    a, mus, vars_, grads = got
    assert _rel(a.float().numpy(), want["a"]) <= A_TOL * scale
    for k in range(len(cfgs)):
        assert _rel(mus[k].numpy(), want["mus"][k]) <= STATS_TOL * scale, ("mu", k)
        assert _rel(vars_[k].numpy(), want["vars"][k]) <= STATS_TOL * scale, ("var", k)
    assert _rel(grads["dx0"].float().numpy(), want["dx0"]) <= DX_TOL * scale
    for name in ("dws", "dbs", "dscales", "dbiases"):
        for k in range(len(cfgs)):
            got_k, want_k = grads[name][k].float().numpy(), want[name][k]
            if name in ("dws", "dbs") and external and k == 0:  # placeholders: zeros both sides
                assert not got_k.any() and not want_k.any()
            elif name == "dbs":
                assert np.abs(got_k - want_k).max() <= BIAS_GRAD_ABS * scale, (name, k)
            else:
                assert _rel(got_k, want_k) <= GRAD_TOL * scale, (name, k)


def test_plain_bf16_tower_matches_jax(case):
    """a, mus, vars and the VJP (dx0, dws, dbs, dscales, dbiases) of the
    plain bf16 tower against the JAX tower fed bf16; the types as JAX's."""
    _, cfgs, external, inputs, want = case
    got = _plain(cfgs, external, inputs)
    assert got[0].dtype == torch.bfloat16 and got[3]["dx0"].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for n in ("dws", "dbs", "dscales", "dbiases")
               for g in got[3][n])
    _check(cfgs, external, got, want)


@pytest.mark.parametrize("sms", [132, 3])
def test_stages_bf16_match_jax_and_the_plain_tower(case, sms):
    """The kernels' phase order in bf16 (the products' tiles of whole
    samples summed by persistent blocks, the partials summed in slices, the
    folded Σgy and Σgy·x̂ from the stored da, split-K dW over runs of
    whole-sample K stages in split order, db per 256-row block of the f32
    dc) against the JAX tower, and against the plain bf16 tower at half the
    gates; on 132 SMs (a block a tile here) and on 3 (a block walks
    several: sums in yet another order, so a bf16 rounding of dc or dprev
    lands one step apart at other elements than on 132, and the plain
    tower is held at the file's full gates, as JAX is)."""
    _, cfgs, external, inputs, want = case
    got = _stages(cfgs, external, inputs, sms)
    _check(cfgs, external, got, want)
    a, mus, vars_, grads = _plain(cfgs, external, inputs)
    plain = {"a": a.detach().float().numpy(), "mus": [m.numpy() for m in mus],
             "vars": [v.numpy() for v in vars_], "dx0": grads["dx0"].float().numpy()}
    plain.update({n: [g.numpy() for g in grads[n]] for n in ("dws", "dbs", "dscales", "dbiases")})
    _check(cfgs, external, got, plain, scale=0.5 if sms == 132 else 1.0)


def test_bf16_plan_routes_and_workspaces():
    """In bf16 a conv runs on the tensor cores where cin is a multiple of 8;
    there (MOD's layer: R 5120, S 20, C 64 on 132 SMs) the products take
    row tiles of 6 whole samples (120 rows), one column-sum partial a
    persistent block (132), the weight gradient K stages of 3 samples (60
    rows) over wgrad_splits' runs; its partials hold dW alone, and the
    backward apply's workspace holds dc in bf16, the dc pass's block sums
    [blocks, C] and the split partials (no W^T); the fold's partials are a
    transposed conv's blocks' [per_n, 2, cin]."""
    assert [ct.on_tensor_cores(c, torch.bfloat16) for c in (1, 2, 4, 6, 8, 64)] == [
        False, False, False, False, True, True]
    assert [ct.on_tensor_cores(c) for c in (2, 4, 8)] == [False, True, True]
    RS, kw, cin, Cc = 5120 * 20, 3, 64, 64
    f32 = ct.layer_plan(5120, 20, kw, cin, Cc)
    bf = ct.layer_plan(5120, 20, kw, cin, Cc, dtype=torch.bfloat16)
    assert bf["E"] == kw * cin * Cc and f32["E"] == kw * cin * Cc + Cc
    assert bf["conv"]["tile"] == {"rb": 6, "sb": 20, "s_tiles": 1, "r_tiles": 854, "tiles": 854,
                                  "rows": 120}
    assert (bf["conv"]["bn"], bf["conv"]["tiles_n"], bf["conv"]["per_n"]) == (64, 1, 132)
    assert bf["fwd_partials"] == 132 and bf["fold"] == bf["conv"]
    w = bf["wgrad"]
    assert w["tile"] == {"rb": 3, "sb": 20, "s_tiles": 1, "r_tiles": 1707, "tiles": 1707,
                         "rows": 60}
    assert (w["m_pad"], w["bn"], w["wtiles"]) == (192, 64, 2)
    sp, rps = ct.wgrad_splits(1707 * 64, 2, 132)
    assert (w["splits"], w["per_split"]) == (sp, rps // 64)
    assert w["splits"] == -(-1707 // w["per_split"]) and bf["splits"] == w["splits"]
    assert bf["workspace"] == {"forward": 132 * 2 * Cc, "bwd_stats": bf["stat_blocks"] * 2 * Cc,
                               "bwd_apply": RS * Cc // 2 + bf["stat_blocks"] * Cc
                               + bf["splits"] * bf["E"], "fold": 132 * 2 * cin}
    assert bf["stat_blocks"] == RS // ct.STAT_ROWS
    narrow = ct.layer_plan(5120, 20, 3, 2, 64, dtype=torch.bfloat16)
    assert not narrow["tensor_cores"] and narrow["fwd_partials"] == -(-RS // ct.STAT_ROWS)
    assert "fold" not in narrow["workspace"] and narrow["splits"] == ct.split_rows(RS, 1, 132)[0]


# geometries whose tiles of whole samples leave rows out, and whose samples
# outrun a tile: R 33 of S 12 (10 samples a 120-row product tile: the
# fourth tile holds 3; 5 a 60-row K stage: the seventh holds 3), S 150 (two
# 75-position boxes a sample in the products, three of 50 in the weight
# gradient), S 70 (one sample a product tile, two 35-position K stages);
# cin 8 on the tensor cores, cin 2 on the CUDA cores, an external first conv
TILE_GEOMETRIES = {
    "tail_R33_S12": (33, 12, ((3, 8, 16, False), (3, 16, 16, True), (5, 16, 16, True)), False),
    "long_S150": (5, 150, ((3, 8, 16, False), (3, 16, 16, True)), False),
    "long_S70_external": (6, 70, ((5, 16, 16, False), (5, 16, 16, True)), True),
    "narrow_cin2_S20": (12, 20, ((3, 2, 16, False), (3, 16, 16, True)), False),
}


def _tile_inputs(R, S_, cfgs, external, seed):
    """_inputs' draws at another R and S: numpy f32, x0 and the cotangent
    of bf16 values (no JAX: these geometries meet the plain tower only)."""
    rng = np.random.default_rng(seed)
    cin0 = cfgs[0][2] if external else cfgs[0][1]
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()
    x0 = bf(rng.normal(size=(R, S_, cin0)))
    groups = [[], [], [], [], []]
    for kw, cin, cout, _ in cfgs:
        groups[0].append((rng.normal(size=(kw * cin, cout)) * (kw * cin) ** -0.5).astype(np.float32))
        groups[1].append((rng.normal(size=(cout,)) * 0.1).astype(np.float32))
        groups[2].append((1.0 + 0.1 * rng.normal(size=(cout,))).astype(np.float32))
        groups[3].append((0.1 * rng.normal(size=(cout,))).astype(np.float32))
        groups[4].append(((rng.random((R, cout)) > 0.2) / 0.8).astype(np.float32))
    return (x0, *groups, bf(rng.normal(size=(R, S_, cfgs[-1][2]))))


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("name", sorted(TILE_GEOMETRIES))
def test_bf16_stages_over_tiles_of_whole_samples(name, sms):
    """The stages model at geometries whose tiles leave rows out or cut a
    sample into boxes, on 132 SMs and on 2 (the persistent blocks walk
    several tiles, the weight gradient several K stages a split), against
    the plain bf16 tower at twice the file's gates: a few hundred to a
    thousand rows, where one bf16 step of dc at a few rows moves dW by ~1e-3
    of max|dW| (at tail_R33_S12 the plain tower's own dW sits 1.1e-3 from
    the one with its f32 steps in float64, the model's 6.8e-4); every row
    enters one tile's sums once (a row left out or taken twice moves a
    statistic by ~1/RS, 1e-3 to 1e-2 here, far past 2 STATS_TOL)."""
    R_, S_, cfgs, external = TILE_GEOMETRIES[name]
    inputs = _tile_inputs(R_, S_, cfgs, external, sorted(TILE_GEOMETRIES).index(name))
    got = _stages(cfgs, external, inputs, sms)
    a, mus, vars_, grads = _plain(cfgs, external, inputs)
    plain = {"a": a.float().numpy(), "mus": [m.numpy() for m in mus],
             "vars": [v.numpy() for v in vars_], "dx0": grads["dx0"].float().numpy()}
    plain.update({n: [g.numpy() for g in grads[n]] for n in ("dws", "dbs", "dscales", "dbiases")})
    _check(cfgs, external, got, plain, scale=2.0)


def _covers(st, R_, S_):
    """Whether the tiles' row ranges (tile_row_range) cover [0, R*S) once,
    in order, each within the tile's rows."""
    spans = [ct.tile_row_range(st, t, R_, S_) for t in range(st["tiles"])]
    return (spans[0][0] == 0 and spans[-1][1] == R_ * S_
            and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            and all(0 < e - b <= st["rows"] for b, e in spans))


def _plan_holds(R_, S_, kw, cin, C, sms=132):
    """The bf16 plan of one layer keeps the kernels' rules: boxes of at most
    256 along each axis and 128 (products) or 64 (weight-gradient K stages)
    rows of whole samples, or of one sample's positions, covering every
    row once; one partial a persistent block and no more blocks than SMs;
    every K stage in one split; the workspaces as focal_ct_workspace sizes
    them."""
    p = ct.layer_plan(R_, S_, kw, cin, C, sms, torch.bfloat16)
    if not p["tensor_cores"]:
        return p["fwd_partials"] == -(-R_ * S_ // ct.STAT_ROWS)
    for plan, rows in ((p["conv"], 128), (p["fold"], 128), (p["wgrad"], 64)):
        st = plan["tile"]
        assert st["rows"] <= rows and max(st["rb"], st["sb"]) <= 256, (R_, S_, st)
        assert (st["s_tiles"] == 1) == (S_ <= rows) and _covers(st, R_, S_), (R_, S_, st)
    conv, fold, w = p["conv"], p["fold"], p["wgrad"]
    assert conv["per_n"] == min(conv["tile"]["tiles"], sms // conv["tiles_n"])
    assert conv["per_n"] * conv["tiles_n"] <= sms and p["fwd_partials"] == conv["per_n"]
    assert w["m_pad"] == kw * -(-cin // 64) * 64 and w["m_pad"] >= kw * cin
    stages = w["tile"]["tiles"]
    assert (w["splits"] - 1) * w["per_split"] < stages <= w["splits"] * w["per_split"]
    assert p["workspace"] == {
        "forward": conv["per_n"] * 2 * C, "bwd_stats": p["stat_blocks"] * 2 * C,
        "bwd_apply": ct.bf16_floats(R_ * S_ * C) + p["stat_blocks"] * C + w["splits"] * kw * cin * C,
        "fold": fold["per_n"] * 2 * cin}
    return True


@pytest.mark.parametrize("dataset", ["MOD", "MOD_WIDE", "ACIDS", "PAMAP2", "RealWorld_HAR"])
def test_bf16_plan_at_every_recipe_tower_layer(dataset):
    """The bf16 plan at every tower layer of the recipe's DeepSense (the
    two-location mod_extractor's too: cin 1, S its loc_mod_out_channels,
    e.g. MOD's 128, one sample a 128-row tile, or boxes of a sample) at the fused batches the card runs (512 and 256 samples) and at a
    few samples, on 132 SMs and on 114 (an H100 PCIe)."""
    for batch in (2, 7, 256, 512):
        for R_, S_, C_, cin, kw in _recipe_geometries(dataset, batch):
            for sms in (132, 114):
                assert _plan_holds(R_, S_, kw, cin, C_, sms)
                assert _plan_holds(R_, S_, kw, C_, C_, sms)
    R_, S_ = _recipe_geometries(dataset, 512)[-1][:2]  # the mod_extractor
    st = ct.sample_tiles(R_, S_, 128)
    assert st["rb"] == 1 and st["s_tiles"] == -(-S_ // 128)


def test_bf16_plan_past_128_positions():
    """S 300 (past a 128-row tile): three boxes of 100 positions a sample in
    the products, five of 60 in the weight gradient, at C 64 and 256."""
    for C_ in (64, 256):
        assert _plan_holds(30, 300, 5, C_, C_)
    p = ct.layer_plan(30, 300, 5, 64, 64, dtype=torch.bfloat16)
    assert (p["conv"]["tile"]["s_tiles"], p["conv"]["tile"]["sb"]) == (3, 100)
    assert (p["wgrad"]["tile"]["s_tiles"], p["wgrad"]["tile"]["sb"]) == (5, 60)


def test_sliced_sum_is_slices_in_order():
    """sliced_sum: eight runs of consecutive partials, each summed in order,
    then the runs in order (sliced_sums, wg_reduce_kernel's column part)."""
    parts = [torch.tensor([float(2**k), 1.0]) for k in range(19)]
    per = 3  # ceil(19 / 8)
    runs = [sum(parts[i:i + per], torch.zeros(2)) for i in range(0, 19, per)]
    want = torch.zeros(2)
    for r in runs:
        want = want + r
    assert torch.equal(ct.sliced_sum(parts), want)
    assert torch.equal(ct.sliced_sum(parts[:1]), parts[0])


def test_bf16_kernels_refuse_widths_not_a_multiple_of_8():
    assert ct.kernel_refuses(64, 20, 64, 2, torch.bfloat16) is None
    assert "multiple of 8" in ct.kernel_refuses(64, 20, 12, 2, torch.bfloat16)
    assert ct.kernel_refuses(64, 20, 12, 2) is None  # f32 takes C 12
    assert not ct.tower_takes(64, 20, 12, 2, torch.bfloat16, kw_max=3)


def _recipe_geometries(dataset, batch):
    """(R, S, C, cin, kw_max) of each conv block's tower at ``batch``
    samples, as ConvBlock gates it (a second location's mod_extractor
    included: cin 1, S = loc_mod_out_channels)."""
    cfg = load_dataset_config(dataset)
    ds = cfg["DeepSense"]
    loc = cfg["location_names"][0]
    half = ds["loc_mod_out_channels"] // 2
    out = []
    for mod in cfg["modality_names"]:
        lens = ds["loc_mod_conv_lens"][mod]
        stride = ds["loc_mod_in_conv_stride"][mod]
        s = cfg["loc_mod_spectrum_len"][loc][mod]
        strided = max(stride) > 1
        s_out = (s - lens[0][1]) // stride[1] + 1 if strided else s
        kw_max = lens[1][1] if strided else max(lens[0][1], lens[1][1])
        cin = half if strided else cfg["loc_mod_in_freq_channels"][loc][mod]
        out.append((batch * cfg["num_segments"], s_out, half, cin, kw_max))
    lens = ds["loc_conv_lens"]
    out.append((batch * cfg["num_segments"], ds["loc_mod_out_channels"],
                ds["loc_out_channels"] // 2, 1, max(lens[0][1], lens[1][1])))
    return out


@pytest.mark.parametrize("dataset", ["MOD_TINY", "MOD", "MOD_WIDE", "ACIDS", "PAMAP2",
                                     "RealWorld_HAR"])
def test_bf16_gate_matches_jax(dataset):
    seen = set()
    for batch in (1, 2, 3, 4, 5, 8, 12, 13, 16, 24, 64, 100, 128, 200, 256, 512, 1000, 1024):
        for R_, S_, C_, cin, kw in _recipe_geometries(dataset, batch):
            assert ct.kernel_refuses(R_, S_, C_, cin, torch.bfloat16) is None
            got = ct.tower_takes(R_, S_, C_, cin, torch.bfloat16, kw_max=kw)
            assert got == jax_tower_fits(R_, S_, C_, BF16, kw_max=kw), (R_, S_, C_, kw)
            seen.add(got)
    assert True in seen
