"""Port's Swin block and SW_Transformer (eval) against the JAX package on the
CPU, with the same parameters carried across by params_from_flax.

Every parameter is perturbed from its flax init (biases, LayerNorm scales
and bias tables included) so no term is trivially zero. Tolerance 1e-4 on
outputs: both sides are f32 and differ by summation order through several
matmuls, LayerNorms and softmaxes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.sw_transformer import SWTransformer as JaxSWTransformer
from focal_tpu.models.swin import SwinBlock as JaxSwinBlock
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.models import swin as tswin
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.weights import params_from_flax

TASK = "vehicle_classification"


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))).astype(np.float32), params
    )


def test_full_width_shifted_block_matches_jax():
    """One SwinBlock at MOD audio stage-0 geometry: 12x48 patches, C=64,
    4 heads, 3x3 windows, shifted (64 masked windows per sample), batch 2."""
    C, res = 64, (12, 48)
    x = np.random.default_rng(0).normal(size=(2, res[0] * res[1], C)).astype(np.float32)
    blk = JaxSwinBlock(dim=C, input_resolution=res, num_heads=4, window_size=[3, 3],
                       shift_size=[1, 1])
    v = jax.jit(lambda xx: blk.init({"params": jax.random.key(1)}, xx, train=False))(x)
    params = _perturb(v["params"], 1)
    ref = np.asarray(jax.jit(lambda p, xx: blk.apply({"params": p}, xx, train=False))(params, x))

    port = tswin.SwinBlock(C, res, 4, (3, 3), (1, 1)).eval()
    assert port.shifted and port.attn_mask.shape == (64, 9, 9)
    port.load_state_dict(params_from_flax(params, {}, {"location_names": ["l"]}), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def _jax_apply(model, head):
    return jax.jit(lambda p, xx: model.apply({"params": p}, xx, train=False, head=head))


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = load_dataset_config("MOD_TINY")
    loc = cfg["location_names"][0]
    rng = np.random.default_rng(2)
    x = {loc: {}}
    for mod in cfg["modality_names"]:
        c = 2 * cfg["loc_mod_in_time_channels"][loc][mod]
        shape = (3, c, cfg["num_segments"], cfg["loc_mod_spectrum_len"][loc][mod])
        x[loc][mod] = rng.normal(size=shape).astype(np.float32)
    jmodel = JaxSWTransformer(dataset_config=cfg, task=TASK)
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    # jit: eager flax dispatches every op separately (slow on the CPU)
    v = jax.jit(lambda xx: jmodel.init({"params": jax.random.key(3)}, xx, train=False,
                                       head="both"))(jx)
    params = _perturb(v["params"], 3)
    port = build_backbone(cfg, "SW_Transformer", TASK).eval()
    port.load_state_dict(params_from_flax(params, v.get("batch_stats", {}), cfg), strict=True)
    tx = {loc: {m: torch.from_numpy(a) for m, a in mods.items()} for loc, mods in x.items()}
    return jmodel, params, jx, port, tx


def test_tiny_model_logits_match_jax(tiny_pair):
    jmodel, params, jx, port, tx = tiny_pair
    ref = np.asarray(_jax_apply(jmodel, "class")(params, jx))
    with torch.no_grad():
        out = port(tx, head="class").numpy()
    assert out.shape == ref.shape == (3, 7)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("head", ["feat", "proj"])
def test_tiny_model_feature_heads_match_jax(tiny_pair, head):
    jmodel, params, jx, port, tx = tiny_pair
    ref = _jax_apply(jmodel, head)(params, jx)
    with torch.no_grad():
        out = port(tx, head=head)
    assert set(out) == set(ref)
    for mod in ref:
        np.testing.assert_allclose(out[mod].numpy(), np.asarray(ref[mod]), atol=1e-4)


def test_state_dict_names_follow_flax_tree(tiny_pair):
    port = tiny_pair[3]
    names = set(port.state_dict())
    assert "stage0_shake_audio.block1.attn.qkv.weight" in names
    assert "patch_embed_shake_seismic.proj.weight" in names
    assert "mod_fusion_layer.MultiHeadDotProductAttention_0.out.weight" in names
