"""The port's DeepSense (``models/deepsense.py``, ``models/layers.py``)
against the JAX package's flax module on the CPU, at MOD_TINY.

The same inputs and parameters (numpy, from a seed; flax's init perturbed
so that no bias, BatchNorm affine or running statistic sits at its init
value) go through flax's DeepSense and, carried by ``params_from_flax``
(``batch_stats`` included), through the port's. The JAX fused path
(``use_pallas=True``) runs its conv-tower Pallas kernels in interpret mode;
the port's fused path runs the tower's plain version (CPU tensors).

Tolerances (both f32; summation order and, on the fused paths, the TPU
kernels' erf approximation, 1.5e-7 absolute):
  * eval forward, all four heads: 1e-4 absolute (as the SW_Transformer's);
  * train forward at dropout 0, unfused and fused: outputs and the updated
    running statistics 1e-5 relative (max|port - jax| / max|jax|);
    gradients of sum(sin(out)) 1e-4 relative per parameter, compared
    absolutely (1e-4) where both are below 1e-2: a conv bias feeding a
    BatchNorm has a true gradient of exactly 0, and both sides compute only
    cancellation noise there;
  * init: the lecun-normal std within 2 % of fan_in**-0.5 (flax's fan_in:
    kh*kw*cin for a conv, 2C for the GRU's stacked wi [2, C, 3H], as flax's
    own draw shows), the GRU's wh [2H, 3H] rows orthonormal to 1e-5;
  * Dropout2d: whole (sample, channel) planes zero or scaled by 1/(1-rate),
    the keep rate within 5 sigma of 1 - rate.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.deepsense import DeepSense as FlaxDeepSense
from focal_tpu.params.yaml_utils import load_dataset_config as jax_load_config
from focal_tpu_torch.models import build_backbone, init_params
from focal_tpu_torch.models import layers as port_layers
from focal_tpu_torch.ops.dropout import StepRngs, keep_mask
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.weights import params_from_flax
from torch_port_threads import one_torch_thread  # noqa: F401

TASK = "vehicle_classification"
BATCH = 8


def _cfg(dropout=None, name="MOD_TINY"):
    cfg = copy.deepcopy(load_dataset_config(name))
    if dropout is not None:
        cfg["DeepSense"]["dropout_ratio"] = dropout
    return cfg


def _freq_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    loc = cfg["location_names"][0]
    return {loc: {m: rng.normal(size=(b, cfg["loc_mod_in_freq_channels"][loc][m],
                                      cfg["num_segments"], cfg["loc_mod_spectrum_len"][loc][m])
                                ).astype(np.float32)
                  for m in cfg["modality_names"]}}


def _jnp(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _torch(x):
    return {loc: {m: torch.from_numpy(a) for m, a in mods.items()} for loc, mods in x.items()}


def _perturbed_variables(model, x, seed):
    """flax init, every leaf moved by a small seeded amount (running
    variances kept positive)."""
    v = model.init({"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
                   _jnp(x), train=False, head="both")
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        a = np.asarray(leaf)
        noise = rng.normal(size=a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return jnp.asarray(a * np.exp(0.3 * noise))
        return jnp.asarray(a + 0.1 * noise)

    return jax.tree_util.tree_map_with_path(move, jax.device_get(v))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _port(cfg, variables, use_pallas=False):
    net = build_backbone(cfg, "DeepSense", TASK, pallas_conv=use_pallas)
    net.load_state_dict(params_from_flax(variables["params"], variables["batch_stats"], cfg),
                        strict=True)
    return net


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    x = _freq_batch(cfg, BATCH, 0)
    flax_model = FlaxDeepSense(dataset_config=jax_load_config("MOD_TINY"), task=TASK)
    return cfg, x, flax_model, _perturbed_variables(flax_model, x, 0)


def test_params_from_flax_carries_batch_stats(tiny):
    cfg, _, _, v = tiny
    sd = params_from_flax(v["params"], v["batch_stats"], cfg)
    net = _port(cfg, v)
    assert set(sd) == set(net.state_dict())
    name = "loc_mod_extractor_shake_seismic.ConvLayer2D_1.BatchNorm_0"
    bn = v["batch_stats"]["loc_mod_extractor_shake_seismic"]["ConvLayer2D_1"]["BatchNorm_0"]
    np.testing.assert_array_equal(net.state_dict()[f"{name}.mean"].numpy(), np.asarray(bn["mean"]))
    np.testing.assert_array_equal(net.state_dict()[f"{name}.var"].numpy(), np.asarray(bn["var"]))
    kernel = np.asarray(v["params"]["loc_mod_extractor_shake_audio"]["ConvLayer2D_0"]["Conv_0"]["kernel"])
    weight = net.state_dict()["loc_mod_extractor_shake_audio.ConvLayer2D_0.Conv_0.weight"].numpy()
    np.testing.assert_array_equal(weight, kernel.transpose(3, 2, 0, 1))  # HWIO -> [out, in, kh, kw]
    assert f"{name}.mean" in dict(net.named_buffers())


@pytest.mark.parametrize("head", ["class", "proj", "feat", "both"])
def test_eval_forward_matches_flax(tiny, head):
    cfg, x, flax_model, v = tiny
    want = flax_model.apply(v, _jnp(x), train=False, head=head)
    net = _port(cfg, v).eval()
    with torch.no_grad():
        got = net(_torch(x), head=head)
    flat_w, flat_g = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), got))
    assert len(flat_w) == len(flat_g)
    for w, g in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_forward_and_gradients_match_flax(tiny, use_pallas, monkeypatch):
    cfg0 = _cfg(dropout=0.0)
    _, x, _, v = tiny
    jcfg = copy.deepcopy(jax_load_config("MOD_TINY"))
    jcfg["DeepSense"]["dropout_ratio"] = 0.0
    flax_model = FlaxDeepSense(dataset_config=jcfg, task=TASK, use_pallas=use_pallas)

    def jax_loss(params):
        (logits, proj), st = flax_model.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, _jnp(x), train=True,
            head="both", mutable=["batch_stats"])
        loss = jnp.sum(jnp.sin(logits)) + sum(jnp.sum(jnp.sin(p)) for p in proj.values())
        return loss, (logits, proj, st["batch_stats"])

    (_, (logits, proj, stats)), grads = jax.value_and_grad(jax_loss, has_aux=True)(v["params"])

    calls = []
    real = port_layers.fused_conv_tower
    monkeypatch.setattr(port_layers, "fused_conv_tower",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    net = _port(cfg0, v, use_pallas=use_pallas).train()
    plogits, pproj = net(_torch(x), head="both")
    loss = torch.sin(plogits).sum() + sum(torch.sin(p).sum() for p in pproj.values())
    loss.backward()
    assert len(calls) == (2 if use_pallas else 0)  # one tower per modality

    assert _rel(plogits.detach().numpy(), logits) <= 1e-5
    for m in pproj:
        assert _rel(pproj[m].detach().numpy(), proj[m]) <= 1e-5, m
    want_stats = params_from_flax({}, jax.device_get(stats), cfg0)
    bufs = dict(net.named_buffers())
    assert set(want_stats) == set(bufs)
    for name, want in want_stats.items():
        assert _rel(bufs[name].numpy(), want.numpy()) <= 1e-5, name
    want_grads = params_from_flax(jax.device_get(grads), {}, cfg0)
    for name, p in net.named_parameters():
        want = want_grads[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        if max(np.abs(got).max(), np.abs(want).max()) < 1e-2:
            assert np.abs(got - want).max() < 1e-4, name
        else:
            assert _rel(got, want) <= 1e-4, (name, _rel(got, want))


def test_init_statistics_match_flax():
    cfg = _cfg(name="MOD")
    net = init_params(build_backbone(cfg, "DeepSense", TASK), seed=3)
    sd = net.state_dict()
    flax_model = FlaxDeepSense(dataset_config=jax_load_config("MOD"), task=TASK)
    x = _freq_batch(cfg, 2, 1)
    fv = jax.jit(lambda: flax_model.init({"params": jax.random.key(3), "dropout": jax.random.key(4)},
                                         _jnp(x), train=False, head="both"))()
    fp = fv["params"]
    checks = {  # port name -> (flax leaf, fan_in)
        "loc_mod_extractor_shake_audio.ConvLayer2D_2.Conv_0.weight":
            (fp["loc_mod_extractor_shake_audio"]["ConvLayer2D_2"]["Conv_0"]["kernel"], 5 * 64),
        "loc_mod_extractor_shake_audio.ConvLayer2D_0.Conv_0.weight":
            (fp["loc_mod_extractor_shake_audio"]["ConvLayer2D_0"]["Conv_0"]["kernel"], 80 * 2),
        "loc_mod_extractor_shake_seismic.out_proj.weight":
            (fp["loc_mod_extractor_shake_seismic"]["out_proj"]["kernel"], 1280),
        "recurrent_audio.gru0.wi": (fp["recurrent_audio"]["gru0"]["wi"], 2 * 128),
        "recurrent_audio.gru1.wi": (fp["recurrent_audio"]["gru1"]["wi"], 2 * 512),
    }
    for name, (leaf, fan_in) in checks.items():
        want = fan_in**-0.5
        assert abs(float(sd[name].std()) / want - 1) <= 0.02, (name, float(sd[name].std()), want)
        assert abs(float(np.std(np.asarray(leaf))) / want - 1) <= 0.02, ("flax", name)
    for mod in cfg["modality_names"]:
        for k in range(cfg["DeepSense"]["recurrent_layers"]):
            wh = sd[f"recurrent_{mod}.gru{k}.wh"]
            two, H, H3 = wh.shape
            w = wh.reshape(two * H, H3).double()
            assert float((w @ w.T - torch.eye(two * H, dtype=torch.float64)).abs().max()) <= 1e-5
            assert float(sd[f"recurrent_{mod}.gru{k}.bh"].abs().max()) == 0.0
    bn = "loc_mod_extractor_shake_seismic.ConvLayer2D_3.BatchNorm_0"
    assert float(sd[f"{bn}.mean"].abs().max()) == 0.0 and bool((sd[f"{bn}.var"] == 1).all())
    assert bool((sd[f"{bn}.weight"] == 1).all()) and float(sd[f"{bn}.bias"].abs().max()) == 0.0
    assert set(sd) == set(params_from_flax(jax.device_get(fp), jax.device_get(fv["batch_stats"]),
                                           cfg))


def test_dropout2d_zeroes_whole_planes_at_its_rate():
    rate = 0.2
    # the layer's init from a fixed seed, not from whatever the global
    # generator holds after the tests before it: about one init in a
    # thousand puts a conv output exactly on its channel's mean, whose
    # BatchNorm output and GELU are then 0 inside a kept plane
    with torch.random.fork_rng():
        torch.manual_seed(0)
        layer = port_layers.ConvLayer2D(4, 64, (1, 3), dropout_ratio=rate).train()
    rng = StepRngs(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    x = torch.randn(32, 4, 5, 20, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        y = layer(x, rng)
    zero = (y == 0).all(dim=(2, 3))
    assert bool(((y != 0).all(dim=(2, 3)) | zero).all())  # a plane is zero as a whole
    assert 0 < int(zero.sum()) < zero.numel()
    m = keep_mask((4096, 64), rate, torch.Generator().manual_seed(5))
    assert set(torch.unique(m).tolist()) == {0.0, 1.0 / (1.0 - rate)}
    kept = float((m > 0).double().mean())
    assert abs(kept - (1 - rate)) <= 5 * (rate * (1 - rate) / m.numel()) ** 0.5
