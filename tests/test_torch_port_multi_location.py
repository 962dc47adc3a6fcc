"""Multi-location backbones of the port against the JAX package on the
CPU, on the two-location MOD_TINY that the JAX package's own
``tests/test_multi_location.py`` builds (the recipe copied in process with
a second location, ``tower``, shaped as ``shake``).

  * ``TransformerEncoderLayer`` (SW_Transformer's location context) and
    ``MeanFusion`` alone against flax's, in eval: 1e-5; the encoder
    layer's dropouts in training: one broadcast [1, 1, n, n] attention mask
    and three elementwise masks, at the recipe's rate.
  * Each backbone's forward (class, feat and proj heads) against
    ``focal_tpu`` through ``params_from_flax``, every parameter and running
    statistic drawn at random: 1e-4.
  * (``test_torch_port_multi_location_step.py`` holds a rate-0 train step
    of each backbone.)
  * The DeepSense ``mod_extractor``'s conv tower (cin 1, kw 4 in every
    layer, C 64 at MOD's width, S 128) in its plain version against the
    JAX ``fused_conv_tower`` in interpret mode: outputs and statistics
    1e-5 relative, gradients 2e-5; and the model's ``-pallas_conv`` training
    forward runs that tower for ``mod_extractor_{mod}``.
  * Zeroing one location changes the logits of either backbone.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.deepsense import DeepSense as JaxDeepSense
from focal_tpu.models.layers import MeanFusion as JaxMeanFusion
from focal_tpu.models.sw_transformer import SWTransformer as JaxSWTransformer
from focal_tpu.models.sw_transformer import TransformerEncoderLayer as JaxEncoderLayer
from focal_tpu.ops.conv_tower import fused_conv_tower as jax_fused_conv_tower
from focal_tpu_torch.models import build_backbone, init_params, layers
from focal_tpu_torch.ops import conv_tower
from focal_tpu_torch.ops.dropout import StepRngs
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.weights import params_from_flax
from torch_port_threads import one_torch_thread  # noqa: F401

TASK = "vehicle_classification"
MODELS = ["SW_Transformer", "DeepSense"]


def two_locations(cfg):
    """A recipe copied with a second location ``tower`` shaped as the first."""
    cfg = copy.deepcopy(cfg)
    first = cfg["location_names"][0]
    cfg["location_names"] = [first, "tower"]
    cfg["num_location"] = 2
    for key in ("loc_modalities", "loc_mod_in_freq_channels", "loc_mod_in_time_channels",
                "loc_mod_spectrum_len"):
        cfg[key]["tower"] = copy.deepcopy(cfg[key][first])
    return cfg


@pytest.fixture(scope="module")
def cfg():
    return two_locations(load_dataset_config("MOD_TINY"))


def _perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=np.shape(a))).astype(np.float32), params)


def _random_variables(jmodel, xx, seed):
    """Parameters and running statistics of the JAX model's tree drawn in
    numpy (the tree's shapes from ``jax.eval_shape``, no init compiled):
    kernels N(0, 1/fan_in) with fan_in all axes but the last, biases
    0.02 N(0, 1), LayerNorm and BatchNorm scales 1 + 0.02 N(0, 1), running
    means 0.1 N(0, 1) and variances 0.5 + U(0, 1)."""
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.key(0)}, xx, train=False, head="both"))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path[-1:]), leaf.shape
        if "scale" in name:
            a = 1.0 + 0.02 * rng.normal(size=shape)
        elif "var" in name:
            a = 0.5 + rng.random(size=shape)
        elif "mean" in name or len(shape) < 2:
            a = (0.1 if "mean" in name else 0.02) * rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _freq_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {loc: {mod: rng.normal(size=(b, cfg["loc_mod_in_freq_channels"][loc][mod],
                                        cfg["num_segments"],
                                        cfg["loc_mod_spectrum_len"][loc][mod])).astype(np.float32)
                  for mod in cfg["loc_modalities"][loc]}
            for loc in cfg["location_names"]}


def _torch(x):
    return {loc: {m: torch.from_numpy(a) for m, a in mods.items()} for loc, mods in x.items()}


# ---------------------------------------------------------------------------
# the layers alone


def test_encoder_layer_and_mean_fusion_match_flax():
    x = np.random.default_rng(0).normal(size=(5, 2, 32)).astype(np.float32)
    jl = JaxEncoderLayer(dim=32, num_heads=2, ffn_dim=32, dropout=0.2)
    params = _perturb(jl.init({"params": jax.random.key(0)}, x, False)["params"], 0, 0.1)
    assert sorted(params) == ["Dense_0", "Dense_1", "LayerNorm_0", "LayerNorm_1",
                              "MultiHeadDotProductAttention_0"]
    ref = np.asarray(jl.apply({"params": params}, x, False))
    port = layers.TransformerEncoderLayer(32, 2, 32, 0.2).eval()
    port.load_state_dict(params_from_flax(params, {}, {"location_names": ["l"]}), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), ref, atol=1e-5)

    f = np.random.default_rng(1).normal(size=(3, 4, 2, 8)).astype(np.float32)
    want = np.asarray(JaxMeanFusion().apply({}, f))
    got = layers.MeanFusion()(torch.from_numpy(f)).numpy()
    assert got.shape == (3, 4, 8)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_encoder_layer_dropouts_in_training(monkeypatch):
    drawn = []
    real = layers.keep_mask

    def spy(shape, rate, gen):
        drawn.append((tuple(shape), rate))
        return real(shape, rate, gen)

    monkeypatch.setattr(layers, "keep_mask", spy)
    port = layers.TransformerEncoderLayer(32, 2, 16, 0.2).train()
    rngs = StepRngs(torch.Generator(), torch.Generator().manual_seed(0))
    y = port(torch.randn(5, 2, 32), rngs)
    assert y.shape == (5, 2, 32) and torch.isfinite(y).all()
    assert sorted(drawn) == sorted([((1, 1, 2, 2), 0.2), ((5, 2, 32), 0.2), ((5, 2, 16), 0.2),
                                    ((5, 2, 32), 0.2)])


# ---------------------------------------------------------------------------
# the backbones' forwards


JAX_MODELS = {"SW_Transformer": JaxSWTransformer, "DeepSense": JaxDeepSense}


@pytest.fixture(scope="module", params=MODELS)
def pair(request, cfg):
    model = request.param
    x = _freq_batch(cfg, 3, 2)
    jmodel = JAX_MODELS[model](dataset_config=cfg, task=TASK)
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    variables = _random_variables(jmodel, jx, 3)
    params, stats = variables["params"], variables.get("batch_stats", {})
    port = build_backbone(cfg, model, TASK).eval()
    port.load_state_dict(params_from_flax(params, stats, cfg), strict=True)
    return model, jmodel, variables, jx, port, x


def test_two_location_names_follow_the_flax_tree(pair):
    model, _, variables, _, port, _ = pair
    names = set(port.state_dict())
    assert names == set(params_from_flax(variables["params"], variables.get("batch_stats"),
                                         two_locations(load_dataset_config("MOD_TINY"))))
    if model == "SW_Transformer":
        assert "loc_context_audio_1.MultiHeadDotProductAttention_0.out.weight" in names
        assert "loc_fusion_seismic.LayerNorm_0.weight" in names
    else:
        assert "mod_extractor_audio.ConvLayer2D_0.Conv_0.weight" in names
        assert "mod_extractor_audio.ConvLayer2D_1.BatchNorm_0.mean" in names


@pytest.fixture(scope="module")
def jax_heads(pair):
    """The JAX model's class, feat and proj outputs, from one compile."""
    _, jmodel, variables, jx, _, _ = pair

    def heads(v, xx):
        logits, proj = jmodel.apply(v, xx, train=False, head="both")
        return {"class": logits, "proj": proj,
                "feat": jmodel.apply(v, xx, train=False, head="feat")}

    return jax.jit(heads)(variables, jx)


@pytest.mark.parametrize("head", ["class", "feat", "proj"])
def test_two_location_forward_matches_jax(pair, jax_heads, head):
    port, x = pair[4], pair[5]
    ref = jax_heads[head]
    with torch.no_grad():
        out = port(_torch(x), head=head)
    if head == "class":
        assert out.shape == (3, 7)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    else:
        assert set(out) == set(ref)
        for mod in ref:
            np.testing.assert_allclose(out[mod].numpy(), np.asarray(ref[mod]), atol=1e-4)


def test_zeroing_one_location_changes_the_logits(pair):
    _, _, _, _, port, x = pair
    zeroed = {**x, "tower": {m: np.zeros_like(a) for m, a in x["tower"].items()}}
    with torch.no_grad():
        a, b = port(_torch(x)), port(_torch(zeroed))
    assert torch.isfinite(b).all() and float((a - b).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# the mod_extractor's conv tower


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))


def test_mod_extractor_tower_matches_the_jax_tower():
    """cin 1, kw 4 in all four layers, C 64, S 128: MOD's mod_extractor."""
    cfgs = ((4, 1, 64, False), (4, 64, 64, True), (4, 64, 64, True), (4, 64, 64, True))
    R, S, samples = 16, 128, 2
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(R, S, 1)).astype(np.float32)
    ws = [(rng.normal(size=(kw * cin, c)) * 0.2).astype(np.float32) for kw, cin, c, _ in cfgs]
    bs = [(rng.normal(size=(64,)) * 0.1).astype(np.float32) for _ in cfgs]
    scales = [(1.0 + 0.1 * rng.normal(size=(64,))).astype(np.float32) for _ in cfgs]
    biases = [(0.1 * rng.normal(size=(64,))).astype(np.float32) for _ in cfgs]
    masks = [((rng.random((samples, 64)) > 0.2) / 0.8).astype(np.float32) for _ in cfgs]
    rows = [jnp.asarray(np.repeat(m, R // samples, axis=0)) for m in masks]

    def jax_loss(x0, ws, bs, scales, biases):
        y, mus, vars_ = jax_fused_conv_tower(x0, cfgs, ws, bs, scales, biases, rows)
        return jnp.sum(jnp.sin(y)), (y, mus, vars_)

    (_, (y, mus, vars_)), want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4),
                                                    has_aux=True)(
        jnp.asarray(x0), *[tuple(jnp.asarray(a) for a in t) for t in (ws, bs, scales, biases)])
    leaves = [torch.from_numpy(x0).requires_grad_(True)] + [
        [torch.from_numpy(a).requires_grad_(True) for a in t] for t in (ws, bs, scales, biases)]
    py, pmus, pvars = conv_tower.fused_conv_tower(leaves[0], cfgs, *leaves[1:],
                                                  [torch.from_numpy(m) for m in masks])
    assert _rel(py.detach().numpy(), y) <= 1e-5
    for k in range(len(cfgs)):
        assert _rel(pmus[k].numpy(), mus[k]) <= 1e-5 and _rel(pvars[k].numpy(), vars_[k]) <= 1e-5
    torch.sin(py).sum().backward()
    assert _rel(leaves[0].grad.numpy(), want[0]) <= 2e-5, "dx0"
    for name, got, ref in zip(["dws", "dbs", "dscales", "dbiases"], leaves[1:], want[1:]):
        for k in range(len(cfgs)):
            g, r = got[k].grad.numpy(), np.asarray(ref[k])
            if name == "dbs" and max(np.abs(g).max(), np.abs(r).max()) < 1e-2:
                assert np.abs(g - r).max() <= 1e-2, (name, k)  # a bias before a BatchNorm
            else:
                assert _rel(g, r) <= 2e-5, (name, k)


def test_pallas_conv_trains_the_mod_extractor_through_the_tower(cfg, monkeypatch):
    model = init_params(build_backbone(cfg, "DeepSense", TASK, pallas_conv=True), seed=0)
    ext = model.mod_extractor_audio
    x = _torch(_freq_batch(cfg, 4, 7))
    assert ext.fused_geometry(torch.zeros(4, cfg["num_segments"],
                                          cfg["DeepSense"]["loc_mod_out_channels"], 1))
    towers = []
    real = layers.fused_conv_tower

    def spy(x0, cfgs, *args, **kw):
        towers.append((tuple(x0.shape), tuple(c[:2] for c in cfgs)))
        return real(x0, cfgs, *args, **kw)

    monkeypatch.setattr(layers, "fused_conv_tower", spy)
    rngs = StepRngs(torch.Generator(), torch.Generator().manual_seed(0))
    model.train()(x, head="proj", rng=rngs)
    s = cfg["DeepSense"]["loc_mod_out_channels"]
    kw = cfg["DeepSense"]["loc_conv_lens"][0][1]
    ext_towers = [t for t in towers if t[0] == (4 * cfg["num_segments"], s, 1)]
    assert len(ext_towers) == len(cfg["modality_names"])
    assert ext_towers[0][1] == ((kw, 1),) + ((kw, s // 2),) * cfg["DeepSense"][
        "loc_conv_inter_layers"]


def test_init_draws_the_location_layers_as_flax(cfg):
    """lecun-normal kernels (std fan_in**-0.5; q/k/v and out fan_in C, as
    flax's DenseGeneral kernels [C, H, hd] and [H, hd, C]), zero biases,
    unit LayerNorm scales; the mod_extractor's BatchNorms at 1 / 0."""
    sw = init_params(build_backbone(cfg, "SW_Transformer", TASK), seed=0)
    C = cfg["SW_Transformer"]["loc_out_channels"]
    for mod in cfg["modality_names"]:
        layer = getattr(sw, f"loc_context_{mod}_0")
        mha = layer.MultiHeadDotProductAttention_0
        for lin in (mha.query, mha.key, mha.value, mha.out, layer.Dense_0, layer.Dense_1):
            std = float(lin.weight.detach().std())
            assert abs(std * lin.weight.shape[1] ** 0.5 - 1.0) < 0.2, std
            assert float(lin.bias.detach().abs().max()) == 0.0
        fusion = getattr(sw, f"loc_fusion_{mod}")
        assert torch.equal(fusion.LayerNorm_0.weight, torch.ones(C))
        assert torch.equal(layer.LayerNorm_1.bias, torch.zeros(C))
    ds = init_params(build_backbone(cfg, "DeepSense", TASK), seed=0)
    bn = ds.mod_extractor_audio.ConvLayer2D_1.BatchNorm_0
    assert torch.equal(bn.var, torch.ones_like(bn.var)) and float(bn.mean.abs().max()) == 0.0
    conv = ds.mod_extractor_audio.ConvLayer2D_0.Conv_0.weight  # [C / 2, 1, 1, kw]: fan_in kw
    assert abs(float(conv.detach().std()) * conv.shape[-1] ** 0.5 - 1.0) < 0.3
