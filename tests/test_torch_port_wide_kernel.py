"""The per-head kernels' plain versions (#4 forward, #5 backward) against
the JAX package's per-head Pallas kernels on the CPU, and the routing
between the monolithic (#1-#3) and per-head kernels.

#4 and #5 compute the function of #1-#3, so their plain versions are
``fused_window_block_reference`` and ``fused_window_block_backward_reference``.
Here they are held against ``_wblock_ph_fwd_impl`` (rate 0: the JAX dropout
forward needs the TPU PRNG) and ``_wblock_ph_bwd_impl`` run directly in
interpret mode, the backward with and without an explicit keep mask (the
port's uint8 [B_, H, N, N] as the JAX [H, N, N, Bp] bf16 lane layout,
padded to ``_block_tile_perhead``). Tolerances, max|port - jax| / max|jax|
per output or gradient:
  * C = 64, H = 4: 2e-5 (both f32; summation order only);
  * C = 512, H = 4, nW 1 and 4: 1e-2, on bf16-representable inputs, as the
    JAX kernel computes in bf16 at C >= 128 and rounds its intermediates.
Routing: the port's ``wblock_fits`` equals the JAX ``wblock_fits`` at every
block geometry of MOD and MOD_WIDE, and a WindowAttention at C = 512 goes
through the per-head wrappers in eval and in training.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_port_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.swin import shifted_window_mask
from focal_tpu.ops.pallas_kernels import _block_tile_perhead, _wblock_ph_bwd_impl
from focal_tpu.ops.pallas_kernels import _wblock_ph_fwd_impl, expand_bias_lanes
from focal_tpu.ops.pallas_kernels import wblock_fits as jax_wblock_fits
from focal_tpu_torch.models import swin
from focal_tpu_torch.models.sw_transformer import mod_geometry
from focal_tpu_torch.ops import pallas_kernels as pk
from focal_tpu_torch.params import load_dataset_config

NAMES = ["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "drel_bias"]


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _inputs(rng, B, N, C, H, nW):
    """x, wqkv, bqkv, wproj, bproj, rel_bias, dy at a trained model's scale,
    each value representable in bf16, and the 6x6 shift mask (nW = 4)."""
    shapes = [(B, N, C), (C, 3 * C), (3 * C,), (C, C), (C,), (H, N, N), (B, N, C)]
    scales = [1.0, C**-0.5, 0.1, C**-0.5, 0.1, 0.02, 1.0]
    arrs = [_bf16_exact(rng.normal(size=s) * k) for s, k in zip(shapes, scales)]
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if nW == 4 else None
    return arrs, mask


def _jax_keep(keep, N, C, H, B):
    """uint8 [B, H, N, N] -> bf16 [H, N, N, Bp], zero-padded lanes."""
    tile = _block_tile_perhead(N, C, C // H, B, 2 if C >= 128 else 4)
    lanes = np.zeros(keep.shape[1:] + (-(-B // tile) * tile,), np.float32)
    lanes[..., :B] = keep.transpose(1, 2, 3, 0)
    return jnp.asarray(lanes, jnp.bfloat16)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


CASES = [(64, 1), (64, 4), (512, 1), (512, 4)]


@pytest.mark.parametrize("C,nW", CASES)
def test_perhead_plain_forward_matches_jax_kernel(C, nW):
    B, N, H = 8, 9, 4
    (x, wqkv, bqkv, wproj, bproj, rel_bias, _), mask = _inputs(np.random.default_rng(C + nW), B, N,
                                                               C, H, nW)
    t = [torch.from_numpy(a) for a in (x, wqkv, bqkv, wproj, bproj, rel_bias)]
    got, keep = pk.fused_window_block_perhead(*t, None if mask is None else torch.from_numpy(mask))
    assert keep is None
    want = _wblock_ph_fwd_impl(*(jnp.asarray(a) for a in (x, wqkv, bqkv, wproj, bproj)),
                               expand_bias_lanes(jnp.asarray(rel_bias), mask))
    assert _rel(got.numpy(), np.asarray(want, np.float32)) <= (2e-5 if C < 128 else 1e-2)


@pytest.mark.parametrize("C,nW", CASES)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_perhead_plain_backward_matches_jax_kernel(C, nW, rate):
    B, N, H = 8, 9, 4
    rng = np.random.default_rng(C + nW + int(rate * 10))
    (x, wqkv, bqkv, wproj, bproj, rel_bias, dy), mask = _inputs(rng, B, N, C, H, nW)
    keep = (rng.random((B, H, N, N)) >= rate).astype(np.uint8) if rate else None
    t = [torch.from_numpy(a) for a in (x, wqkv, bqkv, wproj, bproj, rel_bias)]
    got = pk.fused_window_block_perhead_backward(
        *t, None if mask is None else torch.from_numpy(mask), torch.from_numpy(dy),
        None if keep is None else torch.from_numpy(keep), rate)
    want = _wblock_ph_bwd_impl(
        *(jnp.asarray(a) for a in (x, wqkv, bqkv, wproj, bproj)),
        expand_bias_lanes(jnp.asarray(rel_bias), mask), jnp.asarray(dy),
        mask=None if keep is None else _jax_keep(keep, N, C, H, B), rate=rate)
    want = [np.asarray(w, np.float32) for w in want]
    want[5] = want[5].sum(-1)  # d bias_l [H, N, N, 128] -> d rel_bias
    tol = 2e-5 if C < 128 else 1e-2
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= tol, (name, _rel(g.numpy(), w))


def _block_geometries(dataset):
    """{(N, C, H)} of every Swin block of a recipe's SW_Transformer."""
    cfg = load_dataset_config(dataset)
    geos = set()
    for mod in cfg["modality_names"]:
        geo = mod_geometry(cfg, cfg["location_names"][0], mod)
        for stage, (res, C) in enumerate(geo["stages"]):
            for i in range(geo["block_num"][stage]):
                shift = [0, 0] if i % 2 == 0 else [w // 2 for w in geo["window"]]
                wh, ww, _, _, shifted = swin.block_geometry(res, geo["window"], shift)
                geos.add((mod, stage, shifted, wh * ww, C,
                          cfg["SW_Transformer"]["time_freq_head_num"]))
    return sorted(geos)


def test_mod_wide_recipe_is_the_jax_packages():
    import os

    import focal_tpu
    import focal_tpu_torch

    paths = [os.path.join(os.path.dirname(pkg.__file__), "configs", "MOD_WIDE.yaml")
             for pkg in (focal_tpu, focal_tpu_torch)]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    sw = load_dataset_config("MOD_WIDE")["SW_Transformer"]
    assert sw["time_freq_out_channels"] == 256 and sw["time_freq_head_num"] == 4


@pytest.mark.parametrize("dataset", ["MOD", "MOD_WIDE"])
def test_routing_matches_jax_wblock_fits(dataset):
    """Monolithic at C <= 256, per head at C = 512 and 1024: the port's
    rule gives the JAX package's answer at each of the 10 block geometries
    (modality x stage x shifted) of the recipe."""
    geos = _block_geometries(dataset)
    assert len(geos) == 10
    for mod, stage, shifted, N, C, H in geos:
        assert pk.wblock_fits(N, C, H) == jax_wblock_fits(N, C), (mod, stage, shifted, N, C)
    per_head = {C for *_, C, H in geos if not pk.wblock_fits(9, C, H)}
    assert per_head == (set() if dataset == "MOD" else {512, 1024})


def test_wide_window_attention_reaches_the_perhead_wrappers(monkeypatch):
    """A WindowAttention at C = 512 calls #4 in eval and #4 then #5 in
    training (CPU tensors: the wrappers run the plain versions), and never
    the monolithic wrappers."""
    calls = []

    def spy(name):
        real = getattr(pk, name)

        def wrapper(*a, **k):
            calls.append(name)
            return real(*a, **k)
        return wrapper

    for name in ("fused_window_block_perhead", "fused_window_block_perhead_backward"):
        monkeypatch.setattr(pk, name, spy(name))
    for name in ("fused_window_block", "fused_window_block_dropout", "fused_window_block_backward"):
        monkeypatch.setattr(pk, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} called"))

    torch.manual_seed(0)
    attn = swin.WindowAttention(512, (3, 3), 4, attn_drop=0.2)
    x = torch.randn(3, 9, 512)
    with torch.no_grad():
        y = attn.eval()(x)
    assert calls == ["fused_window_block_perhead"] and y.shape == x.shape
    calls.clear()
    from focal_tpu_torch.ops.dropout import StepRngs
    rng = StepRngs(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    attn.train()(x, None, rng).square().sum().backward()
    assert calls == ["fused_window_block_perhead", "fused_window_block_perhead_backward"]
    assert all(p.grad is not None for p in attn.parameters())
