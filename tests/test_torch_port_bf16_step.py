"""A rate-0 FOCAL pretrain step and a supervised step of SW_Transformer at
``-compute_dtype bfloat16`` against the JAX package's bf16 steps on the CPU,
and the pretrain step on the attention-only route (``-no_pallas_block``).

MOD_TINY, batch 8, every drop rate 0 and the augmenter pools ["no"], the
JAX steps with ``force_pallas`` (the whole-block kernels, or with
``-no_pallas_block`` the attention-only ones, in interpret mode), the port
from the JAX initial parameters (``params_from_flax``).

The steps are held against the JAX package's jitted steps (an op-by-op
step took ~140 s here; XLA's fusions there round fewer intermediates, so
both sides carry bf16 noise of their own in the backward): loss within
1e-2 relative (measured 3.9e-3 pretrain, 8.7e-4 supervised, 2.3e-4
pretrain -no_pallas_block); each parameter's gradient at a cosine of at
least 0.9 to JAX's (measured >= 0.957, >= 0.998 and >= 0.960: a bias
whose gradient sums bf16 noise over the rows agrees least), and the median
over the parameters of ||g - g_jax|| / ||g_jax|| within 5e-2 (measured
2.5e-2, 1.5e-2 and 2.7e-2). The fusion
attentions' key biases are left out: their true gradient is 0 (the
softmax ignores a shift of every score of a row, C7), which the port
gives exactly and JAX as noise. The port's parameters and gradients stay
f32.
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
from focal_tpu.train.losses import make_focal_loss as jax_make_focal_loss
from focal_tpu.train.state import init_state
from focal_tpu.train.steps import make_pretrain_step as jax_make_pretrain_step
from focal_tpu.train.steps import make_supervised_train_step as jax_make_supervised_step
from focal_tpu_torch.data import synthetic_arrays, to_device
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.ops.augment import build_augmenter
from focal_tpu_torch.params import parse_train_params
from focal_tpu_torch.train.losses import make_focal_loss
from focal_tpu_torch.train.state import create_train_state
from focal_tpu_torch.train.steps import make_pretrain_step, make_supervised_train_step
from focal_tpu_torch.weights import params_from_flax
from torch_port_threads import one_torch_thread  # noqa: F401

TASK = "vehicle_classification"
BATCH = 8
STEPS_PER_EPOCH = 10
LOSS_TOL = 1e-2
GRAD_MIN_COS = 0.9
GRAD_MEDIAN_TOL = 5e-2


def _deterministic(cfg):
    cfg = copy.deepcopy(cfg)
    sw = cfg["SW_Transformer"]
    sw["dropout_ratio"] = sw["drop_path_rate"] = sw["attn_drop_rate"] = 0.0
    cfg["FOCAL"]["random_augmenters"] = {"time_augmenters": ["no"], "freq_augmenters": ["no"]}
    cfg["SW_Transformer"]["fixed_augmenters"] = {"time_augmenters": ["no"],
                                                 "freq_augmenters": ["no"]}
    return cfg


def _capturing(tx):
    """tx that also keeps the gradient it was given in its state."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _argv(stage):
    framework = "FOCAL" if stage.startswith("pretrain") else "no"
    return ["-dataset", "MOD_TINY", "-model", "SW_Transformer", "-learn_framework", framework,
            "-batch_size", str(BATCH), "-compute_dtype", "bfloat16"] + (
                ["-no_pallas_block"] if stage.endswith("-no_pallas_block") else [])


def _jax_step(tmp, stage):
    """The JAX package's bf16 step (its whole-block kernels in interpret
    mode) from its init: (cfg, init params, loss, gradients by port name)."""
    args = build_parser().parse_args(_argv(stage) + ["-stage", "pretrain", "-output_dir",
                                                     str(tmp)])
    args.option = "train"
    args = set_auto_params(args)
    assert args.compute_dtype == "bfloat16"
    args.dataset_config = _deterministic(args.dataset_config)
    args.force_pallas, args.data_parallel = True, 1
    net = jax_build_backbone(args)
    augmenter = jax_build_augmenter(args)
    ds = jax_synthetic(args.dataset_config, args.task, 2 * BATCH, seed=0, seq_len=4)
    data = {loc: {m: jnp.asarray(a) for m, a in mods.items()} for loc, mods in ds.data.items()}
    sample = augmenter.no({loc: {m: a[:2] for m, a in mods.items()} for loc, mods in data.items()})
    state = init_state(args, net, sample, optax.identity(), jax.random.key(0))
    tx = _capturing(jo.build_optimizer(args, state.params, steps_per_epoch=STEPS_PER_EPOCH)[0])
    state = state.replace(tx=tx, opt_state=tx.init(state.params))
    init = jax.device_get(state.params)
    idx = jnp.arange(BATCH, dtype=jnp.int32)
    if stage.startswith("pretrain"):
        step = jax_make_pretrain_step(net, augmenter, jax_make_focal_loss(args))
        new_state, metrics = step(state, data, idx, jax.random.key(1))
    else:
        step = jax_make_supervised_step(net, augmenter)
        new_state, metrics = step(state, data, jnp.asarray(ds.labels), idx, jax.random.key(1))
    cfg = args.dataset_config
    return cfg, init, float(metrics["loss"]), params_from_flax(
        jax.device_get(new_state.opt_state[1]), {}, cfg)


def _port_step(cfg, init, stage):
    args = parse_train_params(_argv(stage) + ["-device", "cpu"])
    args.dataset_config = cfg
    net = build_backbone(cfg, "SW_Transformer", TASK, args.learn_framework,
                         pallas_block=not args.no_pallas_block, compute_dtype=args.compute_dtype)
    net.load_state_dict(params_from_flax(init, {}, cfg), strict=True)
    state = create_train_state(args, net, steps_per_epoch=STEPS_PER_EPOCH)
    host, labels, _ = synthetic_arrays(cfg, TASK, 2 * BATCH, seed=0)
    data = to_device(host, "cpu")
    if stage.startswith("pretrain"):
        step = make_pretrain_step(net, build_augmenter(args), make_focal_loss(args))
        _, metrics = step(state, data, torch.arange(BATCH))
    else:
        step = make_supervised_train_step(net, build_augmenter(args))
        _, metrics = step(state, data, torch.from_numpy(labels).long(), torch.arange(BATCH))
    return float(metrics["loss"]), {n: p.grad for n, p in net.named_parameters()
                                    if p.grad is not None}, net


@pytest.mark.parametrize("stage", ["pretrain", "supervised", "pretrain-no_pallas_block"])
def test_bf16_rate0_step_matches_jax(stage, tmp_path):
    cfg, init, loss_jax, g_jax = _jax_step(tmp_path, stage)
    loss, grads, net = _port_step(cfg, init, stage)
    assert abs(loss - loss_jax) / abs(loss_jax) <= LOSS_TOL
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert grads and all(g.dtype == torch.float32 for g in grads.values())
    errs = []
    for name, got in grads.items():
        if name.endswith("key.bias"):
            continue
        want = g_jax[name]
        cos = float((got * want).sum() / (got.norm() * want.norm()))
        assert cos >= GRAD_MIN_COS, (name, cos)
        errs.append(float((got - want).norm() / want.norm()))
    assert len(errs) > 100 and float(np.median(errs)) <= GRAD_MEDIAN_TOL
