"""Reference-format checkpoints in the port (``utils/torch_export.py``,
``utils/torch_import.py``, ``python -m focal_tpu_torch.export_torch``)
against the JAX package's mapping on the CPU, without the reference
models: the JAX tree's parameters are drawn in numpy from
``jax.eval_shape`` (no init compiled).

  * the port's export of ``params_from_flax(tree)`` equals
    ``focal_tpu.utils.torch_export.export_*_state_dict(tree)`` key for key,
    in shape, dtype and bits, for DeepSense and SW_Transformer at one and
    two locations. The one named difference: a single-location DeepSense's
    dead ``mod_extractors`` blocks (the reference builds them and never
    runs them) are the JAX package's flax init from its own key there, and
    the port's seeded init here; those keys are held to the same shapes,
    dtypes and BatchNorm values;
  * the port's import of that export equals the JAX package's import
    carried through ``params_from_flax``, and import∘export is the
    identity on the port's state_dict, bitwise;
  * ``flax_from_params`` inverts ``params_from_flax`` bitwise, tree for tree;
  * a shape mismatch raises; ``load_class_layer=False`` keeps the head;
  * the export CLI round-trips through ``-torch_out``, from a params file
    and from an experiment folder.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.deepsense import DeepSense as JaxDeepSense
from focal_tpu.models.sw_transformer import SWTransformer as JaxSWTransformer
from focal_tpu.utils import torch_export as jax_export
from focal_tpu.utils import torch_import as jax_import
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.train import checkpoint as ckpt
from focal_tpu_torch.utils import torch_export, torch_import
from focal_tpu_torch.weights import flax_from_params, params_from_flax

export_cli = importlib.import_module("focal_tpu_torch.export_torch")

TASK = "vehicle_classification"
JAX_MODELS = {"SW_Transformer": JaxSWTransformer, "DeepSense": JaxDeepSense}


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


def _random_tree(model, cfg, seed):
    """(params, batch_stats) of the JAX model's tree drawn in numpy from its
    eval_shape: kernels N(0, 1/fan_in), the rest N(0, 0.02^2) about 0 (1
    for scales), running variances 0.5 + U(0, 1)."""
    rng = np.random.default_rng(seed)
    x = {loc: {mod: jnp.zeros((2, cfg["loc_mod_in_freq_channels"][loc][mod],
                               cfg["num_segments"], cfg["loc_mod_spectrum_len"][loc][mod]))
               for mod in cfg["loc_modalities"][loc]} for loc in cfg["location_names"]}
    jmodel = JAX_MODELS[model](dataset_config=cfg, task=TASK)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.key(0)}, x, train=False, head="both"))

    def draw(path, leaf):
        name, shape = jax.tree_util.keystr(path[-1:]), leaf.shape
        if "var" in name:
            a = 0.5 + rng.random(size=shape)
        elif "scale" in name:
            a = 1.0 + 0.02 * rng.normal(size=shape)
        elif len(shape) < 2 or "mean" in name:
            a = 0.02 * rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        return a.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    return tree["params"], tree.get("batch_stats", {})


CASES = [(model, locs) for model in ("DeepSense", "SW_Transformer") for locs in (1, 2)]


@pytest.fixture(scope="module", params=CASES, ids=[f"{m}-{n}loc" for m, n in CASES])
def case(request):
    model, locs = request.param
    cfg = load_dataset_config("MOD_TINY")
    cfg = two_locations(cfg) if locs == 2 else cfg
    params, stats = _random_tree(model, cfg, seed=11 + locs)
    state = params_from_flax(params, stats, cfg)
    port = build_backbone(cfg, model, TASK)
    port.load_state_dict(state, strict=True)
    return model, locs, cfg, params, stats, port.state_dict()


def _bits(a):
    a = np.asarray(a)
    return a.shape, a.dtype, a.tobytes()


def _jax_export(model, params, stats, cfg):
    if model == "DeepSense":
        return jax_export.export_deepsense_state_dict(params, stats, cfg)
    return jax_export.export_sw_transformer_state_dict(params, cfg)


def _dead(model, locs, key):
    """A single-location DeepSense's dead mod_extractor entry."""
    return model == "DeepSense" and locs == 1 and key.startswith("mod_extractors.")


def test_export_equals_the_jax_export(case):
    model, locs, cfg, params, stats, state = case
    want = _jax_export(model, params, stats, cfg)
    got = torch_export.export_state_dict(model, state, cfg)
    assert list(got) == list(want)
    dead = [k for k in want if _dead(model, locs, k)]
    assert bool(dead) == (model == "DeepSense" and locs == 1)
    for k in want:
        if k in dead and k.endswith(("conv.weight", "conv_layer_out.weight")):
            assert _bits(got[k])[:2] == _bits(want[k])[:2], k  # the two inits differ
        else:
            assert _bits(got[k]) == _bits(want[k]), k


def test_import_inverts_the_export(case):
    """import(export(state)) is state bitwise, and equals the JAX package's
    import of the same file carried through params_from_flax."""
    model, locs, cfg, params, stats, state = case
    sd = torch_export.export_state_dict(model, state, cfg)
    got = torch_import.import_state_dict(model, sd, state, cfg)
    assert set(got) == set(state)
    for k in state:
        assert _bits(got[k].numpy()) == _bits(state[k].numpy()), k
    variables = {"params": params, "batch_stats": stats}
    if model == "DeepSense":
        jp, js = jax_import.import_deepsense_state_dict(sd, variables, cfg)
    else:
        jp, js = jax_import.import_sw_transformer_state_dict(sd, variables, cfg)
    want = params_from_flax(jp, js, cfg)
    for k in state:
        assert _bits(got[k].numpy()) == _bits(want[k].numpy()), k


def test_flax_from_params_inverts_params_from_flax(case):
    model, locs, cfg, params, stats, state = case
    got_params, got_stats = flax_from_params(state, cfg)

    def same(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        else:
            assert _bits(a) == _bits(b), path

    same(got_params, params)
    same(got_stats, stats)


def test_import_rejects_a_shape_mismatch(case):
    model, locs, cfg, params, stats, state = case
    sd = torch_export.export_state_dict(model, state, cfg)
    key = next(k for k in sd if k.endswith("mod_projectors.audio.0.weight"))
    sd[key] = np.zeros((sd[key].shape[0] + 1, sd[key].shape[1]), np.float32)
    with pytest.raises(ValueError, match="Shape mismatch"):
        torch_import.import_state_dict(model, sd, state, cfg)


def test_load_class_layer_false_keeps_the_head(case):
    model, locs, cfg, params, stats, state = case
    sd = torch_export.export_state_dict(model, state, cfg)
    sd = {k: (v + 1.0 if k.startswith("class_layer") or "mod_projectors" in k else v)
          for k, v in sd.items()}
    kept = torch_import.import_state_dict(model, sd, state, cfg, load_class_layer=False)
    loaded = torch_import.import_state_dict(model, sd, state, cfg)
    heads = [k for k in state if k.startswith("class_layer")]
    assert heads
    for k in heads:
        assert torch.equal(kept[k], state[k]) and not torch.equal(loaded[k], state[k]), k
    projector = next(k for k in state if k.startswith("mod_projector_audio.Dense_0"))
    assert not torch.equal(kept[projector], state[projector])


@pytest.mark.parametrize("model", ["DeepSense", "SW_Transformer"])
def test_export_cli_round_trips(tmp_path, capsys, model):
    """-model_weight as a params file and as an experiment folder (its
    stage's _best): the -torch_out file imports back bitwise."""
    cfg = load_dataset_config("MOD_TINY")
    params, stats = _random_tree(model, cfg, seed=5)
    net = build_backbone(cfg, model, TASK)
    net.load_state_dict(params_from_flax(params, stats, cfg), strict=True)
    folder = tmp_path / "exp0_contrastive_FOCAL"
    folder.mkdir()
    ckpt.save_params(str(folder / f"MOD_TINY_{model}_{TASK}_1.0_finetune_best.pt"), net)
    argv = ["-dataset", "MOD_TINY", "-model", model, "-learn_framework", "FOCAL", "-stage",
            "finetune", "-device", "cpu"]
    for source, out in ((folder / f"MOD_TINY_{model}_{TASK}_1.0_finetune_best.pt", "a.pt"),
                        (folder, "b.pt")):
        path = export_cli.main(argv + ["-model_weight", str(source), "-torch_out",
                                       str(tmp_path / out)])
        assert path == str(tmp_path / out)
        sd = torch_import.load_torch_state_dict(path)
        back = torch_import.import_state_dict(model, sd, net.state_dict(), cfg)
        for k, t in net.state_dict().items():
            assert _bits(back[k].numpy()) == _bits(t.numpy()), k
    assert f"Wrote {tmp_path / 'b.pt'}" in capsys.readouterr().out
