"""SW_Transformer at ``-compute_dtype bfloat16`` against the JAX package's
``dtype=jnp.bfloat16`` on the CPU: the eval forward (the rate-0 steps are
in ``test_torch_port_bf16_step.py``).

MOD_TINY, the JAX model with its whole-block kernels (``use_pallas``,
``use_pallas_block``: interpret mode here), parameters carried into the
port by ``params_from_flax``; both sides take the same numpy inputs.

The forward is held against the JAX model applied op by op (no ``jit``):
there every bf16 op rounds on its own, and the port, which rounds at the
same points (``models.layers.Dense``, ``LayerNorm``, ``gelu``, the fusion
attention; the kernels' plain versions), gave the same bits in the class
logits, the features and the projections (measured: 0). The tolerance is
one bf16 step (2^-8) of max|y|, room for a summation order of the CPU's
matmuls. (A jitted JAX forward lets XLA fuse bf16 elementwise chains and
skip their roundings: it lies 1.4e-2 of max|logits| from both, as far as
JAX's f32 model lies from its bf16 one, 1e-2.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.sw_transformer import SWTransformer as JaxSWTransformer
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.weights import params_from_flax

TASK = "vehicle_classification"
FWD_TOL = 2.0**-8


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))).astype(np.float32), params)


@pytest.fixture(scope="module")
def tiny_bf16_pair():
    cfg = load_dataset_config("MOD_TINY")
    loc = cfg["location_names"][0]
    rng = np.random.default_rng(2)
    x = {loc: {}}
    for mod in cfg["modality_names"]:
        c = 2 * cfg["loc_mod_in_time_channels"][loc][mod]
        shape = (3, c, cfg["num_segments"], cfg["loc_mod_spectrum_len"][loc][mod])
        x[loc][mod] = rng.normal(size=shape).astype(np.float32)
    jmodel = JaxSWTransformer(dataset_config=cfg, task=TASK, dtype=jnp.bfloat16, use_pallas=True,
                              use_pallas_block=True)
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    v = jax.jit(lambda xx: jmodel.init({"params": jax.random.key(3)}, xx, train=False,
                                       head="both"))(jx)
    params = _perturb(v["params"], 3)
    port = build_backbone(cfg, "SW_Transformer", TASK, compute_dtype="bfloat16").eval()
    port.load_state_dict(params_from_flax(params, {}, cfg), strict=True)
    tx = {loc: {m: torch.from_numpy(a) for m, a in mods.items()} for loc, mods in x.items()}
    return jmodel, params, jx, port, tx


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bf16_forward_rounds_where_jax_does(tiny_bf16_pair):
    """Logits (f32), projections and features (bf16) against the JAX bf16
    model applied op by op."""
    jmodel, params, jx, port, tx = tiny_bf16_pair
    logits, proj = jmodel.apply({"params": params}, jx, train=False, head="both")
    feats = jmodel.apply({"params": params}, jx, train=False, head="feat")
    with torch.no_grad():
        p_logits, p_proj = port(tx, head="both")
        p_feats = port(tx, head="feat")
    assert logits.dtype == jnp.float32 and p_logits.dtype == torch.float32
    assert _rel(p_logits.numpy(), logits) <= FWD_TOL
    for want, got in ((proj, p_proj), (feats, p_feats)):
        assert set(got) == set(want)
        for mod in want:
            assert want[mod].dtype == jnp.bfloat16 and got[mod].dtype == torch.bfloat16
            assert _rel(got[mod].float().numpy(), want[mod].astype(jnp.float32)) <= FWD_TOL
    assert all(p.dtype == torch.float32 for p in port.parameters())
