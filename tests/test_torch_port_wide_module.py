"""A wide WindowAttention (C = 512, 4 heads, 3x3 windows: MOD_WIDE stage 1)
of the port against the JAX package's on the CPU.

The JAX module runs with ``use_pallas_block``, so at C = 512 its whole-block
kernel dispatches to the per-head Pallas kernels (interpret mode), forward
and backward; the port's module routes to #4 and #5, whose wrappers take
their plain versions on CPU tensors. The parameters are the flax init,
perturbed, and carried across by ``params_from_flax``; inputs and
parameters are bf16-representable. Rate 0 (the JAX dropout kernels need the
TPU PRNG). Tolerance: max|port - jax| / max|jax| <= 1e-2 for the output, dx
and every parameter gradient, as the JAX kernel computes in bf16 at
C >= 128 and rounds its intermediates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import focal_tpu.ops.pallas_kernels as jpk
from focal_tpu.models.swin import WindowAttention as JaxWindowAttention
from focal_tpu.models.swin import shifted_window_mask
from focal_tpu_torch.models import swin
from focal_tpu_torch.weights import params_from_flax

C, H, B = 512, 4, 8
TOL = 1e-2


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shifted", [False, True])
def test_wide_window_attention_matches_jax_perhead_kernel(shifted, monkeypatch):
    ran = []
    for name in ("_wblock_ph_fwd_impl", "_wblock_ph_bwd_impl"):
        real = getattr(jpk, name)
        monkeypatch.setattr(jpk, name, lambda *a, _r=real, _n=name, **k: ran.append(_n) or _r(*a, **k))
    rng = np.random.default_rng(5 + shifted)
    x = _bf16_exact(rng.normal(size=(B, 9, C)))
    dy = _bf16_exact(rng.normal(size=(B, 9, C)))
    mask = shifted_window_mask(6, 6, 3, 3, 1, 1) if shifted else None
    jm = None if mask is None else jnp.asarray(mask)
    jattn = JaxWindowAttention(dim=C, window_size=(3, 3), num_heads=H, use_pallas=True,
                               use_pallas_block=True)
    params = jax.jit(lambda xx: jattn.init({"params": jax.random.key(0)}, xx, jm, train=False))(x)
    params = jax.tree_util.tree_map(
        lambda a: _bf16_exact(np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))),
        params["params"])
    y, vjp = jax.vjp(lambda p, xx: jattn.apply({"params": p}, xx, jm, train=False),
                     params, jnp.asarray(x))
    jgrads, jdx = vjp(jnp.asarray(dy))
    assert "_wblock_ph_fwd_impl" in ran and "_wblock_ph_bwd_impl" in ran  # the per-head kernels

    attn = swin.WindowAttention(C, (3, 3), H)
    attn.load_state_dict(params_from_flax(params, {}, {"location_names": ["l"]}), strict=True)
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        y_eval = attn.eval()(torch.from_numpy(x), tmask)
    assert _rel(y_eval.numpy(), np.asarray(y)) <= TOL
    tx = torch.from_numpy(x).requires_grad_(True)
    y_train = attn.train()(tx, tmask)  # attn_drop 0: no dropout, no rng needed
    y_train.backward(torch.from_numpy(dy))
    assert _rel(y_train.detach().numpy(), np.asarray(y)) <= TOL
    assert _rel(tx.grad.numpy(), np.asarray(jdx)) <= TOL
    want = params_from_flax(jax.device_get(jgrads), {}, {"location_names": ["l"]})
    got = dict(attn.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        assert _rel(got[name].grad.numpy(), w.numpy()) <= TOL, name
