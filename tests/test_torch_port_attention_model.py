"""The attention-only route (``-no_pallas_block``) of the port's
SW_Transformer on the CPU: the model against the JAX package, the route it
takes, and the entry points.

  * A MOD_TINY SW_Transformer built with ``pallas_block=False``, its
    parameters (perturbed from the flax init so no term is trivially zero)
    carried across by ``params_from_flax`` with the names of the whole-block
    route, against the flax model built with ``use_pallas`` and without
    ``use_pallas_block`` (its attention-only Pallas kernel, #6, in interpret
    mode: a spy counts the 8 blocks that call it): class logits and the
    feature heads within 1e-4, as ROADMAP holds model outputs.
  * The route, with spies on the Swin module's kernel entry points: under
    ``-no_pallas_block`` every block calls ``fused_window_attention`` (#6)
    once in eval and ``window_attention_qkv`` (#7/#9 on the qkv Linear's
    output, d(qkv) in its layout) once in training, and
    never the whole-block ``window_block_forward`` / ``window_block``;
    without it, the reverse.
  * ``python -m focal_tpu_torch.train -no_pallas_block`` on ``-device cpu``
    (MOD_TINY, synthetic): pretrain 2 epochs and ``-resume`` to 3, finetune,
    then ``python -m focal_tpu_torch.test`` and ``python -m
    focal_tpu_torch.predict`` on the finetuned ``_best``: the files, finite
    metrics and probabilities of the expected shape, the training steps
    through ``window_attention_qkv`` only.
"""

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.models.sw_transformer import SWTransformer as JaxSWTransformer
from focal_tpu.ops import pallas_kernels as jax_pk
from focal_tpu_torch import predict as predict_cli
from focal_tpu_torch import test as test_cli
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.models import swin as tswin
from focal_tpu_torch.ops.dropout import StepRngs
from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.weights import params_from_flax
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")

TASK = "vehicle_classification"


@pytest.fixture(scope="module", autouse=True)
def _root_logger_restored():
    """The CLI points the root logger at its run folder; give the next test
    file the logger it had."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    for h in handlers:
        if h not in root.handlers:
            root.addHandler(h)
    root.setLevel(level)


def _tiny_input(cfg, batch, seed):
    loc = cfg["location_names"][0]
    rng = np.random.default_rng(seed)
    return {loc: {m: rng.normal(size=(batch, 2 * cfg["loc_mod_in_time_channels"][loc][m],
                                      cfg["num_segments"],
                                      cfg["loc_mod_spectrum_len"][loc][m])).astype(np.float32)
                  for m in cfg["modality_names"]}}


def _torch_input(x):
    return {loc: {m: torch.from_numpy(a) for m, a in mods.items()} for loc, mods in x.items()}


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = load_dataset_config("MOD_TINY")
    x = _tiny_input(cfg, 3, 2)
    jmodel = JaxSWTransformer(dataset_config=cfg, task=TASK, use_pallas=True,
                              use_pallas_block=False)
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    v = jax.jit(lambda xx: jmodel.init({"params": jax.random.key(3)}, xx, train=False,
                                       head="both"))(jx)
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))).astype(np.float32),
        v["params"])
    port = build_backbone(cfg, "SW_Transformer", TASK, pallas_block=False).eval()
    port.load_state_dict(params_from_flax(params, {}, cfg), strict=True)
    return jmodel, params, jx, port, _torch_input(x)


@pytest.mark.parametrize("head", ["class", "feat"])
def test_attention_only_model_matches_flax_kernel_route(tiny_pair, head, monkeypatch):
    jmodel, params, jx, port, tx = tiny_pair
    traced = []
    real = jax_pk.fused_window_attention

    def spy(*args):
        traced.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(jax_pk, "fused_window_attention", spy)
    ref = jax.jit(lambda p, xx: jmodel.apply({"params": p}, xx, train=False, head=head))(params, jx)
    assert len(traced) == 8  # every Swin block of MOD_TINY (2 modalities x [2, 2])
    with torch.no_grad():
        out = port(tx, head=head)
    if head == "class":
        assert out.shape == (3, 7)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    else:
        for mod in ref:
            np.testing.assert_allclose(out[mod].numpy(), np.asarray(ref[mod]), atol=1e-4)


def _spy_calls(monkeypatch):
    calls = {}
    for name in ("window_attention_qkv", "fused_window_attention", "window_block",
                 "window_block_forward"):
        real = getattr(tswin, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kw)

        monkeypatch.setattr(tswin, name, spy)
    return calls


@pytest.mark.parametrize("pallas_block", [False, True])
def test_route_calls_one_kernel_entry_per_block(pallas_block, monkeypatch):
    cfg = load_dataset_config("MOD_TINY")
    net = build_backbone(cfg, "SW_Transformer", TASK, pallas_block=pallas_block)
    blocks = sum(len(s.blocks()) for m in cfg["modality_names"]
                 for s in net.stages(cfg["location_names"][0], m))
    assert blocks == 8
    x = _torch_input(_tiny_input(cfg, 2, 4))
    calls = _spy_calls(monkeypatch)
    with torch.no_grad():
        net.eval()(x, head="class")
    eval_calls = dict(calls)
    calls.clear()
    rng = StepRngs(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    # the class head and the projectors: the fusion layer's broadcast
    # dropout may drop every key of a call (probability rate^n), which cuts
    # the class head off from the backbone; the projectors always reach it
    logits, proj = net.train()(x, head="both", rng=rng)
    (logits.sum() + sum(p.sum() for p in proj.values())).backward()
    if pallas_block:
        assert eval_calls == {"window_block_forward": blocks}
        assert calls == {"window_block": blocks}
    else:
        assert eval_calls == {"fused_window_attention": blocks}
        assert calls == {"window_attention_qkv": blocks}
    assert net.stage0_shake_audio.block0.attn.qkv.weight.grad.abs().max() > 0


TINY = ["-dataset", "MOD_TINY", "-model", "SW_Transformer", "-no_pallas_block", "-synthetic",
        "-synthetic_samples", "64", "-batch_size", "16", "-val_epochs", "1", "-device", "cpu"]


def test_entry_points_run_the_attention_only_route(tmp_path, monkeypatch):
    out = ["-output_dir", str(tmp_path)]
    pre = TINY + ["-learn_framework", "FOCAL"] + out
    calls = _spy_calls(monkeypatch)
    state, _, points = train_cli.main(pre + ["-epochs", "2"])
    assert [p["epoch"] for p in points] == [0, 1] and state.step == 8
    # 8 steps of one fused [2B] forward through the 8 blocks; eval forwards don't train
    assert calls["window_attention_qkv"] == 8 * 8 and "window_block" not in calls
    assert "window_block_forward" not in calls and calls["fused_window_attention"] > 0
    state, _, points = train_cli.main(pre + ["-epochs", "3", "-resume"])
    assert [p["epoch"] for p in points] == [2] and state.step == 12
    exp = tmp_path / "weights" / "MOD_TINY_SW_Transformer" / "exp0_contrastive_FOCAL"
    assert all((exp / f"MOD_TINY_SW_Transformer_pretrain_{k}.pt").is_file()
               for k in ("latest", "best", "resume"))
    ft = TINY + ["-learn_framework", "FOCAL", "-stage", "finetune"] + out
    _, best, points = train_cli.main(ft + ["-epochs", "1"])
    assert len(points) == 1 and np.isfinite(points[0]["test_loss"])
    loss, acc, f1 = test_cli.main(ft)
    assert all(np.isfinite([loss, acc, f1])) and 0.0 <= acc <= 1.0
    best_file = exp / "MOD_TINY_SW_Transformer_vehicle_classification_1.0_finetune_best.pt"
    preds = tmp_path / "preds.json"
    result = predict_cli.main(["-dataset", "MOD_TINY", "-learn_framework", "FOCAL", "-synthetic",
                               "-synthetic_samples", "20", "-batch_size", "8", "-no_pallas_block",
                               "-model_weight", str(best_file), "-predictions_out", str(preds),
                               "-device", "cpu"])
    assert result["probs"].shape == (20, 7) and np.isfinite(result["probs"]).all()
    np.testing.assert_allclose(result["probs"].sum(-1), 1.0, atol=1e-5)
    assert preds.is_file()
    assert "window_block" not in calls and "window_block_forward" not in calls
