"""DeepSense under tensor parallelism (``-model_parallel``) on the CPU, and
the flag-off routes that ``-pallas_mlp`` and ``-pallas_conv`` take there.

  * the rules: ``parallel.tp.sharded_leaf_count`` equals the JAX
    ``tp.sharded_leaf_count`` over the same DeepSense's params (drawn by
    ``jax.eval_shape``) at MOD_TINY and MOD, mp 2 and 4;
  * the MOD_TINY DeepSense pretrain step at mp 2 and at dp 2 x mp 2, and
    the supervised step at mp 2 with the updated model's eval logits,
    against the single-process step (every drop rate 0, SGD), with the
    tolerances of the JAX package's tests/test_tensor_parallel.py: the loss
    within rtol 1e-4, the parameters and BatchNorm statistics within rtol
    3e-3 and atol 1e-5, every rank's whole state identical;
  * the routes: at mp 2 a SW_Transformer ``-pallas_mlp`` step and a
    DeepSense ``-pallas_conv`` step call neither the fused MLP nor the
    fused conv tower (spies on the names the modules call), as the JAX
    registry builds them at mp > 1; one process calls both;
  * checkpoints: a DeepSense mp 2 model saves the single-process tree
    (``train.checkpoint.save_params``): the names and shapes of one
    process's state_dict, each entry the ranks' slices put back in place.
One spawn a layout runs every check of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist_workers as workers
from focal_tpu.models.deepsense import DeepSense as JaxDeepSense
from focal_tpu.parallel import tp as jax_tp
from focal_tpu.parallel.mesh import make_mesh_plan as jax_mesh_plan
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.parallel import distributed, tp
from focal_tpu_torch.params import load_dataset_config
from torch_port_threads import one_torch_thread  # noqa: F401

STEPS = {"pretrain": dict(model_name="DeepSense"),
         "supervised": dict(model_name="DeepSense", supervised=True, evaluate=True)}
LAYOUTS = {"mp2": (2, 2), "dp2xmp2": (4, 2)}  # (world, mp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{layout: per rank rank_tp_deepsense's results}, and the mp 2
    checkpoint's path."""
    path = str(tmp_path_factory.mktemp("tp_ckpt") / "deepsense_mp2.pt")
    out = {}
    for name, (world, mp) in LAYOUTS.items():
        steps = list(STEPS.values()) if name == "mp2" else [STEPS["pretrain"]]
        out[name] = distributed.run_local(workers.rank_tp_deepsense, world, mp, steps, path)
    return out, path


@pytest.mark.parametrize("layout,step", [("mp2", "pretrain"), ("mp2", "supervised"),
                                         ("dp2xmp2", "pretrain")])
def test_tp_deepsense_step_matches_single_process(ranks, layout, step):
    single = workers.step_result(**STEPS[step])
    results = [r["steps"][list(STEPS).index(step) if layout == "mp2" else 0]
               for r in ranks[0][layout]]
    for r in results:
        assert np.isclose(r["loss"], single["loss"], rtol=1e-4), (r["loss"], single["loss"])
        if "eval" in single:
            np.testing.assert_allclose(r["eval"], single["eval"], rtol=1e-4, atol=1e-5)
    assert set(results[0]["state"]) == set(single["state"])
    for name, want in single["state"].items():
        np.testing.assert_allclose(results[0]["state"][name], want, rtol=3e-3, atol=1e-5,
                                   err_msg=name)
        for r in results[1:]:
            np.testing.assert_array_equal(r["state"][name], results[0]["state"][name],
                                          err_msg=name)


def test_pallas_flags_take_the_flag_off_routes_under_tp(ranks):
    single = workers.flag_off_routes()
    assert single["fused_mlp"] > 0 and single["fused_conv_tower"] > 0, single
    for r in ranks[0]["mp2"]:
        assert r["routes"] == {"fused_mlp": 0, "fused_conv_tower": 0}, r["routes"]


def test_tp_deepsense_checkpoint_is_the_single_process_tree(ranks):
    results, path = ranks
    saved = torch.load(path, weights_only=True)
    model = workers.marked_deepsense()
    whole = model.state_dict()
    specs = {**tp.model_specs(model, 2), **tp.model_specs(model, 2, buffers=True)}
    assert any(n.endswith(".BatchNorm_0.mean") for n in specs) and any(
        n.endswith(".out_proj.weight") for n in specs)
    assert set(saved) == set(whole)
    for name, t in whole.items():
        assert torch.equal(saved[name], t), name
        local = results["mp2"][0]["local_shapes"][name]
        if name in specs:  # the ranks held halves of it
            assert local[specs[name].axis] * 2 == t.shape[specs[name].axis], name
        else:
            assert local == tuple(t.shape), name


@pytest.mark.parametrize("dataset,mp", [("MOD_TINY", 2), ("MOD", 2), ("MOD", 4)])
def test_deepsense_sharded_leaf_count_matches_jax(dataset, mp):
    cfg = load_dataset_config(dataset)
    with torch.device("meta"):
        model = build_backbone(cfg, "DeepSense", "vehicle_classification", "FOCAL")
    x = {loc: {mod: jnp.zeros((2, cfg["loc_mod_in_freq_channels"][loc][mod],
                               cfg["num_segments"], cfg["loc_mod_spectrum_len"][loc][mod]))
               for mod in cfg["loc_modalities"][loc]} for loc in cfg["location_names"]}
    jmodel = JaxDeepSense(dataset_config=cfg, task="vehicle_classification")
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.key(0)}, x, train=False, head="both"))
    want = jax_tp.sharded_leaf_count({"params": shapes["params"]}, jax_mesh_plan(1, mp))
    got = tp.sharded_leaf_count(model, mp)
    assert got == want > 0, (got, want)
