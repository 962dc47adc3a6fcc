"""A rate-0 supervised step of each multi-location backbone of the port
against the JAX package's on the CPU, on the two-location MOD_TINY of
``test_torch_port_multi_location.py`` (the JAX package's own
``tests/test_multi_location.py`` recipe): every drop rate 0 and the fixed
pool ["no"], batch 8, from parameters and running statistics drawn at
random in the JAX tree and carried in by ``params_from_flax``. Loss 1e-5 relative; each gradient 1e-4
relative (absolutely where both are below 1e-2: conv biases before a
BatchNorm); running statistics 1e-5 relative.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from focal_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from focal_tpu.models import build_backbone as jax_build_backbone
from focal_tpu.ops import build_augmenter as jax_build_augmenter
from focal_tpu.params.auto import set_auto_params
from focal_tpu.params.cli import build_parser
from focal_tpu.train import optim as jo
from focal_tpu.train.state import TrainState
from focal_tpu.train.steps import make_supervised_train_step as jax_make_supervised_step
from focal_tpu_torch.data import synthetic_arrays, to_device
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.ops.augment import build_augmenter
from focal_tpu_torch.params import load_dataset_config, parse_train_params
from focal_tpu_torch.train.state import create_train_state
from focal_tpu_torch.train.steps import make_supervised_train_step
from focal_tpu_torch.weights import params_from_flax
from test_torch_port_multi_location import MODELS, TASK, _random_variables, two_locations
from torch_port_threads import one_torch_thread  # noqa: F401

BATCH = 8
STEPS_PER_EPOCH = 10


def _deterministic(cfg):
    cfg = copy.deepcopy(cfg)
    sw = cfg["SW_Transformer"]
    sw["dropout_ratio"] = sw["drop_path_rate"] = sw["attn_drop_rate"] = 0.0
    cfg["DeepSense"]["dropout_ratio"] = 0.0
    for model in MODELS:
        cfg[model]["fixed_augmenters"] = {"time_augmenters": ["no"], "freq_augmenters": ["no"]}
    return cfg


def _capturing(tx):
    """tx that also keeps the gradient it was given in its state."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _argv(model):
    return ["-dataset", "MOD_TINY", "-model", model, "-learn_framework", "no",
            "-batch_size", str(BATCH)]


def _jax_step(tmp, model, cfg):
    args = build_parser().parse_args(_argv(model) + ["-output_dir", str(tmp)])
    args.option = "train"
    args = set_auto_params(args)
    args.dataset_config = cfg
    args.data_parallel = 1
    net = jax_build_backbone(args)
    augmenter = jax_build_augmenter(args)
    ds = jax_synthetic(cfg, args.task, 2 * BATCH, seed=0)
    data = {loc: {m: jnp.asarray(a) for m, a in mods.items()} for loc, mods in ds.data.items()}
    sample = augmenter.no({loc: {m: a[:2] for m, a in mods.items()} for loc, mods in data.items()})
    variables = _random_variables(net, sample, 0)  # the tree's shapes, drawn in numpy
    state = TrainState.create(apply_fn=net.apply, params=variables["params"],
                              batch_stats=variables.get("batch_stats", {}), tx=optax.identity())
    tx = _capturing(jo.build_optimizer(args, state.params, steps_per_epoch=STEPS_PER_EPOCH)[0])
    state = state.replace(tx=tx, opt_state=tx.init(state.params))
    init = jax.device_get((state.params, state.batch_stats))
    new_state, metrics = jax_make_supervised_step(net, augmenter)(
        state, data, jnp.asarray(ds.labels), jnp.arange(BATCH, dtype=jnp.int32),
        jax.random.key(1))
    return {"init": init, "loss": float(metrics["loss"]),
            "grads": params_from_flax(jax.device_get(new_state.opt_state[1]), {}, cfg),
            "stats": params_from_flax({}, jax.device_get(new_state.batch_stats), cfg)}


def _grad_err(got, want):
    g, w = got.numpy(), want.numpy()
    if max(np.abs(g).max(), np.abs(w).max()) < 1e-2:
        return float(np.abs(g - w).max())
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.mark.parametrize("model", MODELS)
def test_rate_zero_supervised_step_matches_jax(model, tmp_path):
    cfg = _deterministic(two_locations(load_dataset_config("MOD_TINY")))
    ref = _jax_step(tmp_path, model, cfg)
    args = parse_train_params(_argv(model) + ["-device", "cpu"])
    args.dataset_config = cfg
    net = build_backbone(cfg, model, TASK, args.learn_framework)
    net.load_state_dict(params_from_flax(*ref["init"], cfg), strict=True)
    state = create_train_state(args, net, steps_per_epoch=STEPS_PER_EPOCH)
    host, labels, _ = synthetic_arrays(cfg, TASK, 2 * BATCH, seed=0)
    _, metrics = make_supervised_train_step(net, build_augmenter(args))(
        state, to_device(host, "cpu"), torch.from_numpy(labels).long(), torch.arange(BATCH))
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], rtol=1e-5)
    grads = {n: p.grad for n, p in net.named_parameters()}
    assert set(grads) == set(ref["grads"])
    for name, want in ref["grads"].items():
        if grads[name] is None:  # off the class path (the projectors): 0 on the JAX side
            assert "mod_projector" in name and float(want.abs().max()) == 0.0, name
            continue
        assert _grad_err(grads[name], want) <= 1e-4, name
    buffers = dict(net.named_buffers())
    for name, want in ref["stats"].items():
        assert float((buffers[name] - want).abs().max() / want.abs().max()) <= 1e-5, name
