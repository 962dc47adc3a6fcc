"""The JAX package's other packaged recipes (ACIDS, PAMAP2, RealWorld_HAR)
in the port, against the JAX package on the CPU.

  * ``focal_tpu_torch/configs/{recipe}.yaml`` is byte for byte the JAX
    package's.
  * The routes' gates at every Swin block and conv tower of each recipe,
    for a batch of 2, 256 and 512 (a fused [2B] pretrain batch), against
    the JAX gates: ``wblock_takes`` is the JAX ``wblock_fits_any`` and
    ``wblock_fits`` its ``wblock_fits`` (N = 9 everywhere); the
    attention-only route takes every head width; ``mlp_takes`` is the JAX
    ``mlp_fits``; ``ConvBlock.fused_geometry`` (``tower_takes``) is the JAX
    ConvBlock's ``tower_fits`` decision, the two-location ``mod_extractor``
    (cin 1, kw 4, S = loc_mod_out_channels) included. Every one admits.
  * ROADMAP C8 at RealWorld_HAR: its shifted blocks have nW 48 (stage 0, C
    64) and 12 (stage 1, C 128), which the JAX package's fused gate refuses
    (``128 % nW``: the TPU's lane layout) and sends to its XLA attention.
    The port keeps its kernels there. Their plain versions, on both of the
    port's routes (whole block, and attention-only), equal the JAX XLA
    route: a block's eval output, its rate-0 training output and the input
    gradient of sum(sin(y)), 1e-5.
  * A forward of each backbone at each recipe's widths, every parameter and
    running statistic drawn at random, against ``focal_tpu`` through
    ``params_from_flax`` at batch 2 (Swin depth cut to 2 blocks a stage,
    one shifted and one unshifted where the stage shifts): class logits and
    the proj features, 1e-4.
  * The FOCAL loss over PAMAP2's three modalities (three modality pairs):
    value, parts and feature gradients, 1e-5 relative, for both backbones'
    temperatures.
"""

import copy
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.deepsense import DeepSense as JaxDeepSense
from focal_tpu.models.sw_transformer import SWTransformer as JaxSWTransformer
from focal_tpu.models.swin import SwinBlock as JaxSwinBlock
from focal_tpu.ops.conv_tower import tower_fits as jax_tower_fits
from focal_tpu.ops.pallas_kernels import mlp_fits as jax_mlp_fits
from focal_tpu.ops.pallas_kernels import wblock_fits as jax_wblock_fits
from focal_tpu.ops.pallas_kernels import wblock_fits_any as jax_wblock_fits_any
from focal_tpu.train import losses as jl
from focal_tpu_torch import params as port_params
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.models import swin as tswin
from focal_tpu_torch.ops import fused_mlp as fm
from focal_tpu_torch.ops import pallas_kernels as pk
from focal_tpu_torch.ops.dropout import StepRngs
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.train import losses as tl
from focal_tpu_torch.weights import params_from_flax
from test_torch_port_multi_location import _random_variables, two_locations
from torch_port_threads import one_torch_thread  # noqa: F401

RECIPES = ["ACIDS", "PAMAP2", "RealWorld_HAR"]
JAX_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "focal_tpu", "configs")


def _task(recipe):
    return port_params.DATASET_DEFAULT_TASK[recipe]


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_is_the_jax_package_bytes(recipe):
    with open(os.path.join(JAX_CONFIGS, f"{recipe}.yaml"), "rb") as f:
        want = f.read()
    with open(os.path.join(port_params.CONFIG_DIR, f"{recipe}.yaml"), "rb") as f:
        assert f.read() == want


def _swin_blocks(model):
    for loc, mod in model.geometries:
        for stage in model.stages(loc, mod):
            yield from stage.blocks()


@pytest.mark.parametrize("recipe", RECIPES)
def test_gates_equal_the_jax_gates_at_every_block_and_tower(recipe):
    cfg = load_dataset_config(recipe)
    sw = build_backbone(cfg, "SW_Transformer", _task(recipe))
    blocks = list(_swin_blocks(sw))
    assert len(blocks) == 8 * len(cfg["modality_names"])
    for blk in blocks:
        N, C, H = blk.wh * blk.ww, blk.attn.dim, blk.attn.num_heads
        assert N == 9 and N <= pk._MAX_N
        assert pk.wblock_takes(N, C, H) and jax_wblock_fits_any(N, C, H), (N, C, H)
        assert pk.wblock_fits(N, C, H) == jax_wblock_fits(N, C), (N, C, H)
        assert pk.attention_takes(N, C // H)
        hidden = blk.mlp.Dense_0.out_features
        assert fm.mlp_takes(C, hidden) and jax_mlp_fits(C, hidden), (C, hidden)
    for loc_cfg in (cfg, two_locations(cfg)):
        ds = build_backbone(loc_cfg, "DeepSense", _task(recipe))
        towers = [(name, m) for name, m in ds.named_children()
                  if name.startswith(("loc_mod_extractor_", "mod_extractor_"))]
        assert len(towers) == len(cfg["modality_names"]) * (
            1 if loc_cfg is cfg else len(loc_cfg["location_names"]) + 1)
        for name, block in towers:
            cin = block.ConvLayer2D_0.Conv_0.in_channels
            assert cin == 1 if name.startswith("mod_") else cin in (2, 6)
            kw_max = (block.conv_lens[1][1] if block.strided
                      else max(block.conv_lens[0][1], block.conv_lens[1][1]))
            for b in (2, 256, 512):
                # the gate reads the batch, the intervals and the input channels of x
                x = torch.zeros(b, cfg["num_segments"], block.out_size[1], cin)
                want = jax_tower_fits(b * cfg["num_segments"], block.out_size[1], block.half,
                                      jnp.float32, kw_max)
                assert block.fused_geometry(x) == want, (name, b)
                assert want or b == 2, (name, b)  # every training batch admits


# ---------------------------------------------------------------------------
# C8: RealWorld_HAR's shifted blocks at nW 48 and 12


@pytest.mark.parametrize("stage,res,C", [(0, (12, 36), 64), (1, (6, 18), 128)])
def test_c8_port_kernel_routes_equal_the_jax_xla_route(stage, res, C):
    cfg = load_dataset_config("RealWorld_HAR")
    geo = tswin.block_geometry(res, (3, 3), (1, 1))
    assert geo[-1]  # shifted
    sw = build_backbone(cfg, "SW_Transformer", _task("RealWorld_HAR"))
    blk = getattr(sw, f"stage{stage}_waist_acc").block1
    nW = blk.attn_mask.shape[0]
    assert blk.shifted and nW == {0: 48, 1: 12}[stage] and 128 % nW != 0  # JAX: XLA route

    rng = np.random.default_rng(stage)
    x = rng.normal(size=(2, res[0] * res[1], C)).astype(np.float32)
    jblk = JaxSwinBlock(dim=C, input_resolution=res, num_heads=4, window_size=[3, 3],
                        shift_size=[1, 1], use_pallas=False)
    params = jblk.init({"params": jax.random.key(stage)}, x, train=False)["params"]
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))).astype(np.float32),
        params)
    apply = jax.jit(lambda xx, train: jblk.apply({"params": params}, xx, train=train),
                    static_argnums=1)
    want_eval = np.asarray(apply(x, False))
    want_train, vjp = jax.vjp(lambda xx: apply(xx, True), jnp.asarray(x))
    want_dx = np.asarray(vjp(jnp.cos(want_train))[0])
    rngs = StepRngs(torch.Generator(), torch.Generator())
    for pallas_block in (True, False):
        port = tswin.SwinBlock(C, res, 4, (3, 3), (1, 1), pallas_block=pallas_block)
        port.load_state_dict(params_from_flax(params, {}, cfg), strict=True)
        assert port.attn_mask.shape[0] == nW
        with torch.no_grad():
            np.testing.assert_allclose(port.eval()(torch.from_numpy(x)).numpy(), want_eval,
                                       atol=1e-5)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = port.train()(xt, rngs)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_train), atol=1e-5)
        torch.sin(y).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), want_dx, atol=1e-5)


# ---------------------------------------------------------------------------
# forwards at the recipes' widths


def _cut(cfg):
    """Two Swin blocks a stage (the first unshifted, the second shifted)."""
    cfg = copy.deepcopy(cfg)
    sw = cfg["SW_Transformer"]
    sw["time_freq_block_num"] = {m: [2] * len(d) for m, d in sw["time_freq_block_num"].items()}
    return cfg


def _freq_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    loc = cfg["location_names"][0]
    return {loc: {mod: rng.normal(size=(b, cfg["loc_mod_in_freq_channels"][loc][mod],
                                        cfg["num_segments"],
                                        cfg["loc_mod_spectrum_len"][loc][mod])).astype(np.float32)
                  for mod in cfg["modality_names"]}}


JAX_MODELS = {"SW_Transformer": JaxSWTransformer, "DeepSense": JaxDeepSense}


@pytest.mark.parametrize("model", ["SW_Transformer", "DeepSense"])
@pytest.mark.parametrize("recipe", RECIPES)
def test_forward_at_the_recipe_widths_matches_jax(recipe, model):
    cfg = _cut(load_dataset_config(recipe))
    task = _task(recipe)
    x = _freq_batch(cfg, 2, 4)
    jmodel = JAX_MODELS[model](dataset_config=cfg, task=task)
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    variables = _random_variables(jmodel, jx, 6)
    logits, proj = jax.jit(lambda vv, xx: jmodel.apply(vv, xx, train=False, head="both"))(
        variables, jx)
    params, stats = variables["params"], variables.get("batch_stats", {})
    port = build_backbone(cfg, model, task).eval()
    port.load_state_dict(params_from_flax(params, stats, cfg), strict=True)
    with torch.no_grad():
        got_logits, got_proj = port(
            {loc: {m: torch.from_numpy(a) for m, a in mods.items()} for loc, mods in x.items()},
            head="both")
    assert got_logits.shape == (2, cfg[task]["num_classes"])
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), atol=1e-4)
    assert set(got_proj) == set(cfg["modality_names"])
    for mod, want in proj.items():
        np.testing.assert_allclose(got_proj[mod].numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# the FOCAL loss over three modalities


@pytest.mark.parametrize("model", ["SW_Transformer", "DeepSense"])
def test_focal_loss_over_pamap2_modalities_matches_jax(model):
    cfg = load_dataset_config("PAMAP2")
    mods = cfg["modality_names"]
    assert len(mods) == 3
    args = SimpleNamespace(dataset_config=cfg, model=model, tag=None)
    rng = np.random.default_rng(9)
    f1, f2 = ({m: rng.normal(size=(8, cfg["FOCAL"]["emb_dim"])).astype(np.float32)
               for m in mods} for _ in range(2))
    (want, wparts), wgrads = jax.jit(jax.value_and_grad(
        lambda a, b: jl.make_focal_loss(args)(a, b), argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, f1), jax.tree_util.tree_map(jnp.asarray, f2))
    t1 = {m: torch.from_numpy(a).requires_grad_(True) for m, a in f1.items()}
    t2 = {m: torch.from_numpy(a).requires_grad_(True) for m, a in f2.items()}
    got, parts = tl.make_focal_loss(args)(t1, t2)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert set(parts) == set(wparts)
    for k in parts:
        np.testing.assert_allclose(float(parts[k].detach()), float(wparts[k]), rtol=1e-5, atol=1e-6)
    got.backward()
    for tf, wf in ((t1, wgrads[0]), (t2, wgrads[1])):
        for m in mods:
            np.testing.assert_allclose(tf[m].grad.numpy(), np.asarray(wf[m]), rtol=1e-5,
                                       atol=1e-6)
