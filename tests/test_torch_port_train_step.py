"""One FOCAL pretrain step of the port (``train.steps.make_pretrain_step``)
against the JAX package's on the CPU.

MOD_TINY SW_Transformer, batch 8 (two subsequences of 4), every drop rate
0 and the augmenter pool ["no"] (so both views are the FFT and the step is
deterministic), starting from the JAX initial parameters carried into the
port by ``params_from_flax``. The JAX step runs with ``args.force_pallas``,
so its whole-block kernels (#1 forward, #3 backward) run in interpret mode;
the port's run their plain versions. The port's step under
``-no_pallas_block`` (the attention-only route: qkv and proj Linears around
#6/#8's plain versions) is held to the same JAX step, whose function it
computes.

Tolerances (both f32; summation order only):
  * loss and each part: 1e-5 relative;
  * gradients: max|port - jax| / max|jax| <= 1e-4 per parameter;
  * post-update parameters wherever |g_jax| > 1e-3 max|g_jax| of that
    tensor: 1e-6 absolute (AdamW's first step moves each element by about
    +-lr = 1e-3, so an element whose gradient is below the gradient error
    can flip sign and move by 2 lr; those are left out). Frozen patch_embed
    parameters must not move on either side.
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
from focal_tpu.train.losses import make_focal_loss as jax_make_focal_loss
from focal_tpu.train.optim import build_optimizer as jax_build_optimizer
from focal_tpu.train.state import init_state
from focal_tpu.train.steps import make_pretrain_step as jax_make_pretrain_step
from focal_tpu_torch.data import synthetic_arrays, to_device
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.ops.augment import build_augmenter
from focal_tpu_torch.params import parse_train_params
from focal_tpu_torch.train.losses import make_focal_loss
from focal_tpu_torch.train.state import create_train_state
from focal_tpu_torch.train.steps import make_pretrain_step
from focal_tpu_torch.weights import params_from_flax
from torch_port_threads import one_torch_thread  # noqa: F401

BATCH = 8
STEPS_PER_EPOCH = 10


def _deterministic(cfg):
    cfg = copy.deepcopy(cfg)
    sw = cfg["SW_Transformer"]
    sw["dropout_ratio"] = sw["drop_path_rate"] = sw["attn_drop_rate"] = 0.0
    cfg["FOCAL"]["random_augmenters"] = {"time_augmenters": ["no"], "freq_augmenters": ["no"]}
    return cfg


def _capturing(tx):
    """tx that also keeps the gradient it was given in its state, so one
    run of the JAX step yields its loss, gradients and update."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    args = build_parser().parse_args(["-dataset", "MOD_TINY", "-model", "SW_Transformer",
                                      "-learn_framework", "FOCAL", "-stage", "pretrain",
                                      "-batch_size", str(BATCH)])
    args.option = "train"
    args.output_dir = str(tmp_path_factory.mktemp("jax_step"))
    args = set_auto_params(args)
    args.dataset_config = _deterministic(args.dataset_config)
    args.force_pallas = True   # the whole-block kernels, in interpret mode
    args.data_parallel = 1     # one device: the kernels without shard_map
    model = jax_build_backbone(args)
    augmenter = jax_build_augmenter(args)
    ds = jax_synthetic(args.dataset_config, args.task, 2 * BATCH, seed=0, seq_len=4)
    data = {loc: {m: jnp.asarray(a) for m, a in mods.items()} for loc, mods in ds.data.items()}
    sample = augmenter.no({loc: {m: a[:2] for m, a in mods.items()} for loc, mods in data.items()})
    state = init_state(args, model, sample, optax.identity(), jax.random.key(0))
    tx, _ = jax_build_optimizer(args, state.params, steps_per_epoch=STEPS_PER_EPOCH)
    tx = _capturing(tx)
    state = state.replace(tx=tx, opt_state=tx.init(state.params))
    init = jax.device_get(state.params)
    step = jax_make_pretrain_step(model, augmenter, jax_make_focal_loss(args))
    new_state, metrics = step(state, data, jnp.arange(BATCH, dtype=jnp.int32), jax.random.key(1))
    return {
        "cfg": args.dataset_config, "init": init,
        "grads": jax.device_get(new_state.opt_state[1]),
        "params": jax.device_get(new_state.params),
        "metrics": {k: float(v) for k, v in metrics.items()},
    }


def _port_step(cfg, init, fused_views=True, pallas_block=True):
    args = parse_train_params(["-dataset", "MOD_TINY", "-batch_size", str(BATCH)]
                              + ([] if pallas_block else ["-no_pallas_block"]))
    args.dataset_config = _deterministic(args.dataset_config)
    model = build_backbone(args.dataset_config, args.model, args.task, args.learn_framework,
                           pallas_block=not args.no_pallas_block)
    model.load_state_dict(params_from_flax(init, {}, args.dataset_config), strict=True)
    state = create_train_state(args, model, steps_per_epoch=STEPS_PER_EPOCH)
    data = to_device(synthetic_arrays(args.dataset_config, args.task, 2 * BATCH, seed=0)[0], "cpu")
    step = make_pretrain_step(model, build_augmenter(args), make_focal_loss(args), fused_views)
    state, metrics = step(state, data, torch.arange(BATCH))
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    return state, {k: float(v) for k, v in metrics.items()}, grads


def test_loss_and_parts_match_jax(jax_step):
    _, metrics, _ = _port_step(jax_step["cfg"], jax_step["init"])
    assert set(metrics) == set(jax_step["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(v, jax_step["metrics"][k], rtol=1e-5, err_msg=k)


def test_gradients_and_update_match_jax(jax_step):
    state, _, grads = _port_step(jax_step["cfg"], jax_step["init"])
    _check_gradients_and_update(jax_step, state, grads)


def test_attention_only_route_takes_the_jax_step(jax_step):
    """-no_pallas_block: the same loss and parts (1e-5), gradients (1e-4)
    and update as the JAX step."""
    state, metrics, grads = _port_step(jax_step["cfg"], jax_step["init"], pallas_block=False)
    for k, v in metrics.items():
        np.testing.assert_allclose(v, jax_step["metrics"][k], rtol=1e-5, err_msg=k)
    _check_gradients_and_update(jax_step, state, grads)


def _check_gradients_and_update(jax_step, state, grads):
    cfg = jax_step["cfg"]
    g_ref = params_from_flax(jax_step["grads"], {}, cfg)
    p0 = params_from_flax(jax_step["init"], {}, cfg)
    p_ref = params_from_flax(jax_step["params"], {}, cfg)
    post = state.model.state_dict()
    assert state.step == 1
    trained = set(grads)
    assert trained == {n for n in post if "patch_embed" not in n}
    for name, want in g_ref.items():
        if name not in trained:  # frozen: no update on either side
            torch.testing.assert_close(post[name], p0[name], rtol=0, atol=0)
            torch.testing.assert_close(p_ref[name], p0[name], rtol=0, atol=0)
            continue
        got = grads[name]
        if got is None:  # not on the pretrain path (mod_fusion_layer, class_layer)
            assert float(want.abs().max()) == 0.0, name
            continue
        scale = float(want.abs().max())
        if scale == 0.0:
            assert float(got.abs().max()) == 0.0, name
            continue
        rel = float((got - want).abs().max()) / scale
        assert rel <= 1e-4, (name, rel)
        big = want.abs() > 1e-3 * scale
        torch.testing.assert_close(post[name][big], p_ref[name][big], rtol=0, atol=1e-6,
                                   msg=name)


def test_unfused_views_take_the_same_step(jax_step):
    """Without BatchNorm the [2B] fused batch and two forwards give the same
    loss and gradients (1e-5 relative)."""
    _, m_fused, g_fused = _port_step(jax_step["cfg"], jax_step["init"], fused_views=True)
    _, m_two, g_two = _port_step(jax_step["cfg"], jax_step["init"], fused_views=False)
    np.testing.assert_allclose(m_two["loss"], m_fused["loss"], rtol=1e-5)
    for name, g in g_fused.items():
        if g is not None:
            scale = max(float(g.abs().max()), 1e-30)
            assert float((g_two[name] - g).abs().max()) / scale <= 1e-5, name
