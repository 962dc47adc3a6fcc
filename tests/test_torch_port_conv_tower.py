"""The port's conv tower (``ops/conv_tower.py``) against the JAX package's
``fused_conv_tower`` (its Pallas kernels in interpret mode) on the CPU.

The same numpy inputs, made from a seed, go through both: the port's CPU
path is the tower's plain version (``fused_conv_tower_reference``, autograd
through torch ops). Geometries are the JAX package's own test's,
``CFG_SEISMIC`` (internal first conv, KW 3) and ``CFG_AUDIO`` (external
first conv, KW 5), at R = 64 rows of S = 20.

Tolerances (both f32: summation order only):
  * the output, the batch means and the biased batch variances: 1e-5
    relative (max|port - jax| / max|jax|);
  * dx0, dws, dbs, dscales, dbiases: 2e-5 relative, compared absolutely
    (1e-2) where both are below 1e-2: a conv bias feeds a BatchNorm, its
    true gradient is exactly 0 and both sides compute only cancellation
    noise (the JAX package's own test holds its kernels so);
  * ``tower_fits`` equals the JAX package's exactly at every geometry of
    the MOD_TINY, MOD and MOD_WIDE conv blocks, batches that do not tile
    included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.ops.conv_tower import fused_conv_tower as jax_fused_conv_tower
from focal_tpu.ops.conv_tower import tower_fits as jax_tower_fits
from focal_tpu_torch.ops.conv_tower import fused_conv_tower, tower_fits
from focal_tpu_torch.params import load_dataset_config
from torch_port_threads import one_torch_thread  # noqa: F401

CFG_SEISMIC = ((3, 2, 32, False), (3, 32, 32, True), (3, 32, 32, True))
CFG_AUDIO = ((5, 2, 32, False), (5, 32, 32, True))  # external first conv
R, S, SAMPLES = 64, 20, 8  # 8 samples of 8 intervals


def _setup(seed, cfgs, external_c0):
    """Inputs as the JAX package's test draws them; masks per sample [8, C]
    (rows repeat them 8 times, as its ConvBlock does)."""
    rng = np.random.default_rng(seed)
    cin0 = cfgs[0][2] if external_c0 else cfgs[0][1]
    x0 = rng.normal(size=(R, S, cin0)).astype(np.float32)
    ws, bs, scales, biases, masks = [], [], [], [], []
    for kw, cin, cout, _ in cfgs:
        ws.append((rng.normal(size=(kw * cin, cout)) * 0.2).astype(np.float32))
        bs.append((rng.normal(size=(cout,)) * 0.1).astype(np.float32))
        scales.append((1.0 + 0.1 * rng.normal(size=(cout,))).astype(np.float32))
        biases.append((0.1 * rng.normal(size=(cout,))).astype(np.float32))
        masks.append(((rng.random((SAMPLES, cout)) > 0.2) / 0.8).astype(np.float32))
    return x0, ws, bs, scales, biases, masks


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))


def _jax(x0, cfgs, ws, bs, scales, biases, masks, external):
    rows = [jnp.asarray(np.repeat(m, R // SAMPLES, axis=0)) for m in masks]
    return jax_fused_conv_tower(jnp.asarray(x0), cfgs, [jnp.asarray(w) for w in ws],
                                [jnp.asarray(b) for b in bs], [jnp.asarray(s) for s in scales],
                                [jnp.asarray(b) for b in biases], rows, external_c0=external)


@pytest.mark.parametrize("external", [False, True])
@pytest.mark.parametrize("per_sample_masks", [False, True])
def test_forward_matches_jax(external, per_sample_masks):
    cfgs = CFG_AUDIO if external else CFG_SEISMIC
    args = _setup(0, cfgs, external)
    y, mus, vars_ = _jax(*args[:1], cfgs, *args[1:], external)
    x0, ws, bs, scales, biases, masks = (
        [torch.from_numpy(a) for a in arg] if isinstance(arg, list) else torch.from_numpy(arg)
        for arg in args)
    if not per_sample_masks:  # the JAX package's [R, C] rows
        masks = [m.repeat_interleave(R // SAMPLES, dim=0) for m in masks]
    py, pmus, pvars = fused_conv_tower(x0, cfgs, ws, bs, scales, biases, masks, external)
    assert py.shape == (R, S, cfgs[-1][2])
    assert _rel(py.numpy(), y) <= 1e-5
    for k in range(len(cfgs)):
        assert _rel(pmus[k].numpy(), mus[k]) <= 1e-5, k
        assert _rel(pvars[k].numpy(), vars_[k]) <= 1e-5, k


@pytest.mark.parametrize("external", [False, True])
def test_gradients_match_jax(external):
    cfgs = CFG_AUDIO if external else CFG_SEISMIC
    x0, ws, bs, scales, biases, masks = _setup(1, cfgs, external)

    def jax_loss(x0, ws, bs, scales, biases):
        rows = [jnp.asarray(np.repeat(m, R // SAMPLES, axis=0)) for m in masks]
        y, _, _ = jax_fused_conv_tower(x0, cfgs, ws, bs, scales, biases, rows, external_c0=external)
        return jnp.sum(jnp.sin(y))

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x0), *[tuple(jnp.asarray(a) for a in t) for t in (ws, bs, scales, biases)])
    leaves = [torch.from_numpy(x0).requires_grad_(True)] + [
        [torch.from_numpy(a).requires_grad_(True) for a in t] for t in (ws, bs, scales, biases)]
    y, _, _ = fused_conv_tower(leaves[0], cfgs, *leaves[1:], [torch.from_numpy(m) for m in masks],
                               external)
    torch.sin(y).sum().backward()
    assert _rel(leaves[0].grad.numpy(), want[0]) <= 2e-5, "dx0"
    for name, got, ref in zip(["dws", "dbs", "dscales", "dbiases"], leaves[1:], want[1:]):
        for k in range(len(cfgs)):
            if external and k == 0 and name in ("dws", "dbs"):
                # placeholders on both sides: the first conv runs outside the tower
                assert got[k].grad is None or float(got[k].grad.abs().max()) == 0.0
                assert float(jnp.abs(ref[k]).max()) == 0.0
                continue
            a, b = got[k].grad.numpy(), np.asarray(ref[k])
            if max(np.abs(a).max(), np.abs(b).max()) < 1e-2:
                assert np.abs(a - b).max() < 1e-2, f"{name}[{k}] (near zero)"
            else:
                assert _rel(a, b) <= 2e-5, f"{name}[{k}]"


def _block_geometries(dataset, batch):
    """(R, S, C, kw_max) of each conv block's tower, as ConvBlock gates it."""
    cfg = load_dataset_config(dataset)
    ds = cfg["DeepSense"]
    loc = cfg["location_names"][0]
    out = []
    for mod in cfg["modality_names"]:
        lens = ds["loc_mod_conv_lens"][mod]
        stride = ds["loc_mod_in_conv_stride"][mod]
        s = cfg["loc_mod_spectrum_len"][loc][mod]
        strided = max(stride) > 1
        s_out = (s - lens[0][1]) // stride[1] + 1 if strided else s
        kw_max = lens[1][1] if strided else max(lens[0][1], lens[1][1])
        out.append((batch * cfg["num_segments"], s_out, ds["loc_mod_out_channels"] // 2, kw_max))
    return out


@pytest.mark.parametrize("dataset", ["MOD_TINY", "MOD", "MOD_WIDE"])
def test_tower_fits_matches_jax(dataset):
    for batch in (1, 2, 3, 5, 8, 13, 16, 24, 64, 100, 128, 200, 256, 512, 1000, 1024):
        for R_, S_, C, kw in _block_geometries(dataset, batch):
            got = tower_fits(R_, S_, C, torch.float32, kw_max=kw)
            assert got == jax_tower_fits(R_, S_, C, jnp.float32, kw_max=kw), (R_, S_, C, kw)
    seen = set()
    for R_ in range(1, 300, 7):
        for S_, C, kw in ((20, 64, 3), (12, 16, 5), (20, 256, 5), (21, 64, 5)):
            got = tower_fits(R_, S_, C, kw_max=kw)
            assert got == jax_tower_fits(R_, S_, C, jnp.float32, kw_max=kw), (R_, S_, C, kw)
            seen.add(got)
    assert seen == {True, False}  # both routes occur
