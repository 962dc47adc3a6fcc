"""The fusion attention's dropout: the port's ``AttentionFusion`` (and its
``MultiHeadDotProductAttention``) against the JAX package's, whose flax
MHA drops the softmaxed weights with ``broadcast_dropout``: one keep mask
of shape [1, 1, Lq, Lk] a call, shared by every sample and head, the kept
weights scaled by 1 / (1 - rate).

The TPU's PRNG stream cannot be reproduced, so the masks are read from the
outputs. The fusion has one query and n = 2 or 3 keys, so a call has at
most 2^n = 8 possible masks; the port's output under each (its
``keep_mask`` replaced by the given mask) is a candidate.
  * Every JAX train-mode output, under 32 dropout keys, equals one
    candidate for every sample and head at once (the broadcast): 1e-5.
  * The port's own draws: each train-mode output equals exactly one
    candidate, and the kept share over 300 calls is within 5 sigma of 0.8.
  * Rate 0 in training, and any rate in eval, give the rate-0 eval output
    bitwise.
  * A supervised SW_Transformer step runs ``mod_fusion_layer`` at the
    recipe's dropout_ratio and draws one [1, 1, 1, n_mod] mask from the
    step's device generator.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.layers import AttentionFusion as JaxAttentionFusion
from focal_tpu_torch.models import build_backbone, layers
from focal_tpu_torch.ops.dropout import StepRngs
from focal_tpu_torch.params import parse_train_params
from focal_tpu_torch.train.state import create_train_state
from focal_tpu_torch.train.steps import make_supervised_train_step
from focal_tpu_torch.data import synthetic_arrays, to_device
from focal_tpu_torch.ops.augment import build_augmenter
from focal_tpu_torch.weights import params_from_flax

RATE = 0.2
DIM, HEADS = 32, 4


def _pair(n, seed):
    """(jax module, its perturbed params, port module, input [4, 2, n, C])."""
    x = np.random.default_rng(seed).normal(size=(4, 2, n, DIM)).astype(np.float32)
    jmod = JaxAttentionFusion(num_heads=HEADS, dropout_ratio=RATE)
    params = jmod.init({"params": jax.random.key(seed)}, x, False)["params"]
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=np.shape(a))).astype(np.float32), params)
    port = layers.AttentionFusion(DIM, HEADS, RATE)
    port.load_state_dict(params_from_flax(params, {}, {"location_names": ["l"]}), strict=True)
    return jmod, params, port, x


def _candidates(port, x, monkeypatch):
    """{mask tuple: the port's train output under that keep mask}."""
    n = x.shape[2]
    out = {}
    port.train()
    rngs = StepRngs(torch.Generator(), torch.Generator())
    for keep in itertools.product((0, 1), repeat=n):
        drawn = []

        def forced(shape, rate, gen, keep=keep):
            drawn.append(tuple(shape))
            return torch.tensor(keep, dtype=torch.float32).reshape(shape) / (1.0 - rate)

        monkeypatch.setattr(layers, "keep_mask", forced)
        with torch.no_grad():
            out[keep] = port(torch.from_numpy(x), rngs).numpy()
        assert drawn == [(1, 1, 1, n)]
    monkeypatch.undo()
    return out


def _match(y, candidates, atol):
    """The masks whose candidate equals y everywhere (every sample, interval
    and head at once)."""
    return [k for k, c in candidates.items() if np.max(np.abs(y - c)) <= atol]


@pytest.mark.parametrize("n", [2, 3])
def test_jax_train_outputs_are_port_outputs_under_one_broadcast_mask(n, monkeypatch):
    jmod, params, port, x = _pair(n, seed=n)
    cands = _candidates(port, x, monkeypatch)
    keys = jax.random.split(jax.random.key(7), 32)
    outs = np.asarray(jax.jit(jax.vmap(
        lambda k: jmod.apply({"params": params}, x, True, rngs={"dropout": k})))(keys))
    seen = set()
    for y in outs:
        hits = _match(y, cands, 1e-5)
        assert len(hits) == 1, hits
        seen.add(hits[0])
    assert len(seen) > 1  # the keys drew different masks


@pytest.mark.parametrize("n", [2, 3])
def test_port_keep_rate_and_broadcast_from_its_own_draws(n, monkeypatch):
    _, _, port, x = _pair(n, seed=10 + n)
    cands = _candidates(port, x, monkeypatch)
    port.train()
    rngs = StepRngs(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    kept, calls = 0, 300
    with torch.no_grad():
        for _ in range(calls):
            hits = _match(port(torch.from_numpy(x), rngs).numpy(), cands, 1e-6)
            assert len(hits) == 1, hits
            kept += sum(hits[0])
    total = calls * n
    sigma = np.sqrt(RATE * (1 - RATE) / total)
    assert abs(kept / total - (1 - RATE)) <= 5 * sigma, kept / total


def test_rate_zero_train_and_eval_are_bitwise_the_plain_output():
    _, params, port, x = _pair(3, seed=20)
    plain = layers.AttentionFusion(DIM, HEADS)
    plain.load_state_dict(port.state_dict())
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ref = plain.eval()(xt).numpy()
        assert np.array_equal(plain.train()(xt).numpy(), ref)  # rate 0 in training, no rng
        assert np.array_equal(port.eval()(xt).numpy(), ref)  # rate 0.2 in eval
    with pytest.raises(ValueError, match="attention dropout"):
        port.train()(xt)  # a dropping forward needs the step's rng


def test_supervised_step_applies_the_fusion_dropout(monkeypatch):
    args = parse_train_params(["-dataset", "MOD_TINY", "-learn_framework", "no",
                               "-batch_size", "4", "-device", "cpu"])
    cfg = args.dataset_config
    model = build_backbone(cfg, args.model, args.task, args.learn_framework)
    mha = model.mod_fusion_layer.MultiHeadDotProductAttention_0
    assert mha.dropout_rate == cfg["SW_Transformer"]["dropout_ratio"] == RATE
    drawn = []
    real = layers.keep_mask

    def spy(shape, rate, gen):
        drawn.append((tuple(shape), rate, gen.device.type))
        return real(shape, rate, gen)

    monkeypatch.setattr(layers, "keep_mask", spy)
    state = create_train_state(args, model, steps_per_epoch=1)
    data = to_device(synthetic_arrays(cfg, args.task, 8, seed=0)[0], "cpu")
    labels = torch.zeros(8, dtype=torch.int64)
    step = make_supervised_train_step(model, build_augmenter(args))
    _, metrics = step(state, data, labels, torch.arange(4))
    assert np.isfinite(float(metrics["loss"]))
    assert drawn == [((1, 1, 1, len(cfg["modality_names"])), RATE, "cpu")]
