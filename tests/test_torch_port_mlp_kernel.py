"""The fused Swin MLP of the port (``ops.fused_mlp``: the plain versions the
CPU runs in place of kernels #10-#12) against the JAX package's on the CPU.

  * ``fused_mlp`` and ``fused_mlp_backward`` vs the JAX ``fused_mlp``
    (its Pallas kernels in interpret mode) and its VJP, at (T 700, C 64,
    H 256) and (T 1100, C 32, H 128): T not a multiple of the JAX tile.
    Tolerance 1e-5 relative (max|port - jax| / max|jax|) for the output
    and each of the five gradients: both are f32; the JAX kernel's erf is
    the Abramowitz-Stegun one (error 1.5e-7), the port's torch's exact one.
  * The dropout form given the same numpy masks vs the JAX kernels' own
    math, ``_mlp_fwd_core`` and ``_mlp_bwd_math`` (the JAX dropout kernels
    need the TPU's generator): the same 1e-5.
  * ``mlp_fits`` equal to the JAX gate at the MOD_TINY, MOD and MOD_WIDE
    widths and beyond; the CPU draws' keep rate within 5 sigma of 1 - rate.
  * The port's ``Mlp`` on the fused route vs the JAX ``Mlp(use_pallas=True)``
    at rate 0 (eval), from the same flax parameters: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.swin import Mlp as JaxMlp
from focal_tpu.ops import pallas_kernels as jpk
from focal_tpu_torch.models.swin import Mlp
from focal_tpu_torch.ops import fused_mlp as fm
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _inputs(T, C, H, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(T, C), (C, H), (H,), (H, C), (C,), (T, C)]
    scales = [1.0, C**-0.5, 0.1, H**-0.5, 0.1, 1.0]
    return [(rng.normal(size=s) * k).astype(np.float32) for s, k in zip(shapes, scales)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("T,C,H", [(700, 64, 256), (1100, 32, 128)])
def test_fused_mlp_and_its_gradients_match_jax(T, C, H):
    x, w1, b1, w2, b2, g = _inputs(T, C, H)
    want_y, vjp = jax.vjp(jpk.fused_mlp, *map(jnp.asarray, (x, w1, b1, w2, b2)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    y = fm.fused_mlp(*leaves)
    assert _rel(y.detach(), want_y) <= TOL
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    for name, got, want in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, want_grads):
        assert _rel(got, want) <= TOL, name
    t = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2, g)]
    direct = fm.fused_mlp_backward(t[0], t[1], t[2], t[1].t().contiguous(),
                                   t[3].t().contiguous(), t[5])
    for name, got, want in zip(("dx", "dw1", "db1", "dw2", "db2"), direct, want_grads):
        assert _rel(got, want) <= TOL, name
    assert fm.fused_mlp_forward(*t[:5]).shape == (T, C)


@pytest.mark.parametrize("T,C,H", [(700, 64, 256), (333, 32, 128)])
def test_dropout_form_matches_the_jax_kernel_math_given_its_masks(T, C, H):
    x, w1, b1, w2, b2, g = _inputs(T, C, H, seed=1)
    rng = np.random.default_rng(2)
    rate = 0.2
    keep1, keep2 = rng.random((T, H)) >= rate, rng.random((T, C)) >= rate
    inv = 1.0 / (1.0 - rate)
    j = list(map(jnp.asarray, (x, w1, b1, w2, b2, g)))
    _, _, want_y = jpk._mlp_fwd_core(j[0], j[1], j[2], j[3], j[4], jnp.asarray(keep1),
                                     jnp.asarray(keep2), inv)
    want_grads = jpk._mlp_bwd_math(j[0], j[1], j[2], j[3], j[4], j[5], jnp.asarray(keep1),
                                   jnp.asarray(keep2), inv)
    t = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2, g)]
    k1, k2 = torch.from_numpy(keep1.astype(np.uint8)), torch.from_numpy(keep2.astype(np.uint8))
    assert _rel(fm.fused_mlp_dropout_reference(*t[:5], k1, k2, rate), want_y) <= TOL
    grads = fm.fused_mlp_backward_reference(*t, k1, k2, rate)
    for name, got, want in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, want_grads):
        assert _rel(got, np.asarray(want).reshape(got.shape)) <= TOL, name


def test_mlp_fits_equals_the_jax_gate():
    widths = [16, 32, 64, 128, 256, 384, 400, 416, 512, 1024]
    for C in widths:
        for H in (4 * C, 2 * C):
            assert fm.mlp_fits(C, H) == jpk.mlp_fits(C, H), (C, H)
    # the packaged recipes: MOD_TINY and MOD fused everywhere, MOD_WIDE in stage 0
    assert [fm.mlp_fits(C, 4 * C) for C in (16, 32, 64, 128, 256, 512, 1024)] == [True] * 5 + [
        False, False]


def test_cpu_masks_keep_one_minus_rate_and_the_seed_decides():
    T, C, H, rate = 2000, 32, 128, 0.2
    k1, k2 = fm.draw_mlp_masks(5, T, C, H, rate, "cpu")
    for k in (k1, k2):
        p = float(k.double().mean())
        assert abs(p - (1 - rate)) <= 5 * (rate * (1 - rate) / k.numel()) ** 0.5
    again = fm.draw_mlp_masks(5, T, C, H, rate, "cpu")
    assert torch.equal(k1, again[0]) and torch.equal(k2, again[1])
    assert not torch.equal(k1, fm.draw_mlp_masks(6, T, C, H, rate, "cpu")[0])
    x = torch.from_numpy(_inputs(T, C, H)[0])
    w = [torch.from_numpy(a) for a in _inputs(T, C, H)[1:5]]
    torch.testing.assert_close(fm.fused_mlp_dropout(x, *w, 5, rate),
                               fm.fused_mlp_dropout_reference(x, *w, k1, k2, rate), rtol=0, atol=0)


def test_port_mlp_fused_route_matches_jax_mlp_with_pallas():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 36, 64)).astype(np.float32)
    jmlp = JaxMlp(hidden=256, out=64, drop=0.2, use_pallas=True)
    variables = jmlp.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                          jnp.asarray(x), train=False)
    want = jmlp.apply(variables, jnp.asarray(x), train=False)
    mlp = Mlp(64, 256, 64, drop=0.2, use_pallas=True).eval()
    assert mlp.fused
    p = variables["params"]
    with torch.no_grad():
        for name in ("Dense_0", "Dense_1"):
            getattr(mlp, name).weight.copy_(torch.from_numpy(np.array(p[name]["kernel"]).T))
            getattr(mlp, name).bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))
        got = mlp(torch.from_numpy(x))
    assert got.shape == (4, 36, 64)
    assert _rel(got, want) <= TOL
    assert not Mlp(512, 2048, 512, use_pallas=True).fused  # mlp_fits says no: the plain path
