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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work (several test
    processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _stages(cfgs, external, inputs):
    """stages_forward then stages_backward in bf16: (a, mus, vars, grads)."""
    x0, ws, bs, scales, biases, masks, dy = inputs
    p = [_t(t) for t in (ws, bs, scales, biases)]
    a, mus, vars_, saved = ct.stages_forward(torch.from_numpy(x0), cfgs, *p, _t(masks), external,
                                             dtype=torch.bfloat16)
    (dx0, dws, dbs, dscales, dbiases), _ = ct.stages_backward(
        saved, cfgs, p[0], _t(masks), torch.from_numpy(dy), external, dtype=torch.bfloat16)
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


def test_stages_bf16_match_jax_and_the_plain_tower(case):
    """The kernels' phase order in bf16 (tile sums, split-K dW in split
    order, db per 256-row block of the f32 dc) against the JAX tower, and
    against the plain bf16 tower at half the gates."""
    _, cfgs, external, inputs, want = case
    got = _stages(cfgs, external, inputs)
    _check(cfgs, external, got, want)
    a, mus, vars_, grads = _plain(cfgs, external, inputs)
    plain = {"a": a.detach().float().numpy(), "mus": [m.numpy() for m in mus],
             "vars": [v.numpy() for v in vars_], "dx0": grads["dx0"].float().numpy()}
    plain.update({n: [g.numpy() for g in grads[n]] for n in ("dws", "dbs", "dscales", "dbiases")})
    _check(cfgs, external, got, plain, scale=0.5)


def test_bf16_plan_routes_and_workspaces():
    """In bf16 a conv runs on the tensor cores where cin is a multiple of 8;
    the weight gradient's partials hold dW alone and the backward apply's
    workspace holds dc and W^T in bf16 and the dc pass's block sums."""
    assert [ct.on_tensor_cores(c, torch.bfloat16) for c in (1, 2, 4, 6, 8, 64)] == [
        False, False, False, False, True, True]
    assert [ct.on_tensor_cores(c) for c in (2, 4, 8)] == [False, True, True]
    RS, kw, cin, Cc = 5120 * 20, 3, 64, 64
    f32 = ct.layer_plan(5120, 20, kw, cin, Cc)
    bf = ct.layer_plan(5120, 20, kw, cin, Cc, dtype=torch.bfloat16)
    assert bf["E"] == kw * cin * Cc and f32["E"] == kw * cin * Cc + Cc
    assert bf["workspace"]["bwd_apply"] == (RS * Cc // 2 + kw * Cc * cin // 2
                                            + bf["stat_blocks"] * 2 * Cc + bf["splits"] * bf["E"])
    assert bf["workspace"]["forward"] == f32["workspace"]["forward"]
    narrow = ct.layer_plan(5120, 20, 3, 2, 64, dtype=torch.bfloat16)
    assert not narrow["tensor_cores"] and narrow["fwd_partials"] == -(-RS // ct.STAT_ROWS)


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
