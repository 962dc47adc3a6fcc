"""The fused MLP's bf16 forms (#10-bf16, #11-bf16, #12-bf16): their plain
versions against the JAX package's MLP kernels fed bf16, on the CPU, the
bf16 ``Mlp(use_pallas=True)`` against the JAX module, and the bf16 gate.

``_mlp_fwd_impl`` and ``_mlp_bwd_impl`` (``focal_tpu/ops/
pallas_kernels.py``) run in interpret mode here on a bf16 x (and g) with the
f32 weights and biases uncast, as the JAX package's ``Mlp`` calls them at
``dtype=bfloat16`` (``focal_tpu/models/swin.py:431-446``): the kernel casts
the weights to bf16 inside, computes z and the GELU (its A-S erf) in f32,
rounds h, g2 and dz to bf16 before their products, sums db1 from the f32
dz, and gives a bf16 y and dx and f32 weight and bias gradients. The port's
plain versions (``fused_mlp_bf16_reference``,
``fused_mlp_backward_bf16_reference``) round at the same points with the
same erf (ROADMAP C6). The dropout kernels draw the TPU's bits and cannot
run off it, so the dropout forms are held, given their masks, against the
kernels' math (``_mlp_fwd_core``, ``_mlp_bwd_math``) on bf16 operands.

Tolerances, max|port - jax| / max|jax|: y 1e-2 (one bf16 step is 2^-8 of
an element), each gradient 2e-2, as the window-block bf16 files hold theirs.

The CUDA kernels are held against these plain versions on the card
(``tests/test_torch_port_gpu.py``, ``chip_smoke.py`` phase 32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.swin import Mlp as JaxMlp
from focal_tpu.ops.pallas_kernels import (_mlp_bwd_impl, _mlp_bwd_math, _mlp_fwd_core,
                                          _mlp_fwd_impl)
from focal_tpu.ops.pallas_kernels import mlp_fits as jax_mlp_fits
from focal_tpu_torch.models import swin
from focal_tpu_torch.models.sw_transformer import mod_geometry
from focal_tpu_torch.ops import fused_mlp as fm
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.weights import params_from_flax

FWD_TOL = 1e-2
GRAD_TOL = 2e-2
NAMES = ("dx", "dw1", "db1", "dw2", "db2")
BF = jnp.bfloat16


def _inputs(T, C, seed):
    """Numpy-seeded x and g (bf16-representable), f32 weights at a trained
    model's scale; as numpy arrays, and the rng."""
    rng = np.random.default_rng(seed)
    H = 4 * C
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.float32).astype(BF).astype(jnp.float32))
    x, g = bf(rng.normal(size=(T, C))), bf(rng.normal(size=(T, C)))
    w = [(rng.normal(size=s) * k).astype(np.float32)
         for s, k in zip([(C, H), (H,), (H, C), (C,)], [C**-0.5, 0.1, H**-0.5, 0.1])]
    return x, w, g, rng


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("T,C", [(300, 64), (77, 128)])
def test_bf16_plain_versions_match_jax_kernels(T, C):
    """#10-bf16's and #12-bf16's plain versions (and the CPU wrappers)
    against ``_mlp_fwd_impl`` and ``_mlp_bwd_impl`` fed a bf16 x and g with
    f32 weights: y and dx bf16, the weight and bias gradients f32."""
    x, (w1, b1, w2, b2), g, _ = _inputs(T, C, T + C)
    jx, jg = jnp.asarray(x).astype(BF), jnp.asarray(g).astype(BF)
    jw = [jnp.asarray(a) for a in (w1, b1, w2, b2)]
    want_y = _mlp_fwd_impl(jx, *jw)
    assert want_y.dtype == BF
    want = _mlp_bwd_impl(jx, *jw, jg)
    assert want[0].dtype == BF and all(w.dtype == jnp.float32 for w in want[1:])
    tx, tg = _t(x, torch.bfloat16), _t(g, torch.bfloat16)
    tw1, tb1, tw2, tb2 = (_t(a) for a in (w1, b1, w2, b2))
    y = fm.fused_mlp_forward_bf16(tx, tw1, tb1, tw2, tb2)
    assert y.dtype == torch.bfloat16 and torch.equal(y, fm.fused_mlp_bf16_reference(
        tx, tw1, tb1, tw2, tb2))
    assert _rel(y, np.asarray(want_y.astype(jnp.float32))) <= FWD_TOL
    got = fm.fused_mlp_backward_bf16(tx, tw1, tb1, tw1.t().contiguous(), tw2.t().contiguous(), tg)
    assert got[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in got[1:])
    for name, a, w in zip(NAMES, got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert tuple(a.shape) == w.shape, name
        assert _rel(a, w) <= GRAD_TOL, (name, _rel(a, w))


@pytest.mark.parametrize("C", [64, 256])
def test_bf16_dropout_forms_match_the_kernel_math_given_masks(C):
    """#11-bf16's and #12-bf16's plain versions with masks (rate 0.2) against
    ``_mlp_fwd_core`` and ``_mlp_bwd_math`` on the kernel's operands (bf16
    x, weights cast to bf16, f32 biases and g) with the same masks; db1 is
    the sum of the f32 dz, which a sum of the rounded dz would miss."""
    T, rate = 200, 0.2
    x, (w1, b1, w2, b2), g, rng = _inputs(T, C, C)
    keep1, keep2 = rng.random((T, 4 * C)) >= rate, rng.random((T, C)) >= rate
    inv = 1.0 / (1.0 - rate)
    jx = jnp.asarray(x).astype(BF)
    jw1, jw2 = jnp.asarray(w1).astype(BF), jnp.asarray(w2).astype(BF)
    jb1, jb2 = jnp.asarray(b1).reshape(1, -1), jnp.asarray(b2).reshape(1, -1)
    _, _, want_y = _mlp_fwd_core(jx, jw1, jb1, jw2, jb2, jnp.asarray(keep1), jnp.asarray(keep2), inv)
    want = _mlp_bwd_math(jx, jw1, jb1, jw2, jb2, jnp.asarray(g), jnp.asarray(keep1),
                         jnp.asarray(keep2), inv)
    tx, tg = _t(x, torch.bfloat16), _t(g, torch.bfloat16)
    tw = [_t(a) for a in (w1, b1, w2, b2)]
    k1, k2 = (torch.from_numpy(k.astype(np.uint8)) for k in (keep1, keep2))
    y = fm.fused_mlp_bf16_reference(tx, *tw, k1, k2, rate)
    assert _rel(y, np.asarray(want_y.astype(BF).astype(jnp.float32))) <= FWD_TOL
    got = fm.fused_mlp_backward_bf16_reference(tx, *tw, tg, k1, k2, rate)
    want = [np.asarray(w.astype(BF).astype(jnp.float32)) if i == 0 else np.asarray(w).reshape(
        np.shape(w)[-1] if np.ndim(w) == 2 and np.shape(w)[0] == 1 else np.shape(w))
        for i, w in enumerate(want)]
    for name, a, w in zip(NAMES, got, want):
        assert tuple(a.shape) == w.shape, name
        assert _rel(a, w) <= GRAD_TOL, (name, _rel(a, w))
    # db1 from the f32 dz: the sum of dz rounded to bf16 is another number
    dz_b = np.asarray(_mlp_dz(jx, jw1, jb1, jw2, jnp.asarray(g), keep1, keep2, inv).astype(BF)
                      .astype(jnp.float32)).sum(0)
    assert _rel(got[2], want[2]) < _rel(torch.from_numpy(dz_b), want[2])
    # the CPU wrappers: draw_mlp_masks' masks, the plain versions
    w1_t, w2_t = tw[0].t().contiguous(), tw[2].t().contiguous()
    d1, d2 = fm.draw_mlp_masks(5, T, C, 4 * C, rate, "cpu")
    assert torch.equal(fm.fused_mlp_dropout_forward_bf16(tx, *tw, 5, rate),
                       fm.fused_mlp_bf16_reference(tx, *tw, d1, d2, rate))
    for a, b in zip(fm.fused_mlp_backward_bf16(tx, tw[0], tw[1], w1_t, w2_t, tg, 5, rate),
                    fm.fused_mlp_backward_bf16_reference(tx, *tw, tg, d1, d2, rate)):
        assert torch.equal(a, b)


def _mlp_dz(x, w1, b1, w2, g, keep1, keep2, inv):
    """The kernel math's f32 dz (``_mlp_bwd_math``'s steps up to the cast)."""
    from focal_tpu.ops.pallas_kernels import _gelu_grad

    z = jnp.dot(x, w1, preferred_element_type=jnp.float32) + b1
    g2 = jnp.where(keep2, g * inv, 0.0).astype(x.dtype)
    dh = jnp.where(keep1, jnp.dot(g2, w2.T, preferred_element_type=jnp.float32) * inv, 0.0)
    return dh * _gelu_grad(z)


@pytest.mark.parametrize("C", [64, 128])
def test_bf16_mlp_module_matches_jax_module(C):
    """The port's bf16 ``Mlp(use_pallas=True)`` (fused: ``_FusedMlpBf16``'s
    plain pair on the CPU) against the JAX ``Mlp(use_pallas=True,
    dtype=bfloat16)`` (the MLP kernels in interpret mode) at rate 0: y and
    dx in bf16, every parameter's gradient in f32 reaching the f32
    parameters, in eval and in training."""
    T = 96
    x, _, g, rng = _inputs(T, C, 7 * C)
    jmlp = JaxMlp(hidden=4 * C, out=C, dtype=BF, use_pallas=True)
    jx, jg = jnp.asarray(x).astype(BF).reshape(2, T // 2, C), jnp.asarray(g).astype(BF)
    params = jax.jit(lambda xx: jmlp.init({"params": jax.random.key(1)}, xx, train=False))(jx)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.05) * rng.normal(size=np.shape(a)).astype(np.float32),
        params["params"])
    y, vjp = jax.vjp(lambda p, xx: jmlp.apply({"params": p}, xx, train=False), params, jx)
    jgrads, jdx = vjp(jg.reshape(y.shape))
    assert y.dtype == BF and jdx.dtype == BF

    mlp = swin.Mlp(C, 4 * C, C, use_pallas=True, compute_dtype=torch.bfloat16)
    assert mlp.fused
    mlp.load_state_dict(params_from_flax(params, {}, {"location_names": ["l"]}), strict=True)
    tx = _t(np.asarray(jx.astype(jnp.float32)), torch.bfloat16)
    tg = _t(np.asarray(jg.astype(jnp.float32)), torch.bfloat16).reshape(tx.shape)
    with torch.no_grad():
        y_eval = mlp.eval()(tx)
    y = np.asarray(y.astype(jnp.float32))
    assert y_eval.dtype == torch.bfloat16 and _rel(y_eval, y) <= FWD_TOL
    tx = tx.clone().requires_grad_(True)
    y_train = mlp.train()(tx)
    assert torch.equal(y_train.detach(), y_eval)
    y_train.backward(tg)
    assert tx.grad.dtype == torch.bfloat16
    assert _rel(tx.grad, np.asarray(jdx.astype(jnp.float32))) <= GRAD_TOL
    want = params_from_flax(jax.device_get(jgrads), {}, {"location_names": ["l"]})
    got = dict(mlp.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        assert got[name].dtype == got[name].grad.dtype == torch.float32, name
        assert _rel(got[name].grad, w.numpy()) <= GRAD_TOL, name


def _recipe_widths(dataset):
    """{C} of every Swin block of a recipe's SW_Transformer."""
    cfg = load_dataset_config(dataset)
    return {C for mod in cfg["modality_names"]
            for _, C in mod_geometry(cfg, cfg["location_names"][0], mod)["stages"]}


@pytest.mark.parametrize("dataset", ["MOD_TINY", "MOD", "MOD_WIDE", "ACIDS", "PAMAP2",
                                     "RealWorld_HAR"])
def test_bf16_gate_at_every_recipe_width(dataset):
    """The bf16 gate ``mlp_takes(C, H, bf16)`` is the JAX package's
    ``mlp_fits`` at every recipe's block widths (all multiples of 16), as the
    f32 gate is: MOD's C 64/128/256 and MOD_WIDE's stage 0 fused, MOD_WIDE's
    C 512/1024 not; and a bf16 Mlp at a width that is not a multiple of 8
    (which the f32 gate takes) runs the unfused bf16 Linears."""
    for C in _recipe_widths(dataset):
        H = 4 * C
        assert C % 16 == 0
        assert fm.mlp_takes(C, H, torch.bfloat16) == jax_mlp_fits(C, H) == fm.mlp_takes(C, H), C
    assert fm.mlp_takes(20, 80) and not fm.mlp_takes(20, 80, torch.bfloat16)
    mlp = swin.Mlp(20, 80, 20, use_pallas=True, compute_dtype=torch.bfloat16)
    assert not mlp.fused
    y = mlp(torch.ones(3, 20, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
