"""``-compute_dtype`` in the port: the flag in every parser and in
``Predictor``, the f32 default, the entry points at bf16 on the CPU (both
backbones), and the bf16 routes ported since (DeepSense, ``-pallas_mlp``,
MOD_WIDE's per-head blocks, ``-no_pallas_block`` and the widths no bf16
kernel takes), which once raised NotImplementedError naming ROADMAP A6 and
now build and run.
"""

import logging

import numpy as np
import pytest
import torch

from focal_tpu_torch import predict, test as test_cli
from focal_tpu_torch.data import synthetic_arrays
from focal_tpu_torch.models import build_backbone, swin
from focal_tpu_torch.params import (load_dataset_config, parse_predict_params, parse_test_params,
                                    parse_train_params)
from focal_tpu_torch.serve import Predictor
from focal_tpu_torch.train.__main__ import main as train_main
from torch_port_threads import one_torch_thread  # noqa: F401

TASK = "vehicle_classification"


@pytest.fixture(autouse=True)
def _root_logger_restored():
    """The training CLI points the root logger at its run folder; give the
    next test the logger it had."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


@pytest.mark.parametrize("parse", [parse_train_params, parse_test_params, parse_predict_params],
                         ids=["train", "test", "predict"])
def test_every_parser_takes_the_flag_with_the_f32_default(parse):
    assert parse(["-dataset", "MOD_TINY"]).compute_dtype == "float32"
    assert parse(["-dataset", "MOD_TINY", "-compute_dtype", "bfloat16"]).compute_dtype == "bfloat16"
    with pytest.raises(SystemExit):
        parse(["-dataset", "MOD_TINY", "-compute_dtype", "float16"])


def test_the_default_builds_the_f32_model():
    """No compute_dtype: every layer computes in f32, as before the flag."""
    model = build_backbone(load_dataset_config("MOD_TINY"), "SW_Transformer", TASK)
    dtypes = {m.compute_dtype for m in model.modules() if hasattr(m, "compute_dtype")}
    assert dtypes == {torch.float32}
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("model,kwargs,what", [
    ("DeepSense", {}, "DeepSense"),
    ("SW_Transformer", {"pallas_mlp": True}, "-pallas_mlp"),
    ("SW_Transformer", {"pallas_block": False}, "-no_pallas_block"),
])
def test_unported_routes_refuse_bf16(model, kwargs, what, monkeypatch):
    """No route refuses bf16 any more: DeepSense (ROADMAP A6.1), -pallas_mlp
    and -no_pallas_block (A6.3), each ported in bf16 since, build: every
    layer in bf16 over f32 parameters; the -pallas_mlp backbone runs a
    forward and a backward with every Swin block's MLP, in every stage, on
    the fused bf16 route (its plain pair here), the -no_pallas_block one
    with every block's attention on the bf16 attention-only route
    (window_attention_qkv on a bf16 qkv: #7-bf16/#9-bf16's plain versions
    here), and nothing raises naming A6."""
    cfg = load_dataset_config("MOD_TINY")
    if not kwargs.get("pallas_block", True):
        net = build_backbone(cfg, model, TASK, compute_dtype="bfloat16", **kwargs)
        assert {m.compute_dtype for m in net.modules()
                if hasattr(m, "compute_dtype")} == {torch.bfloat16}
        assert all(p.dtype == torch.float32 for p in net.parameters())
        attns = [m for m in net.modules() if isinstance(m, swin.WindowAttention)]
        runs = []
        real = swin.window_attention_qkv
        monkeypatch.setattr(swin, "window_attention_qkv",
                            lambda qkv, *a: runs.append(qkv.dtype) or real(qkv, *a))
        for name in ("window_block", "window_block_forward"):
            monkeypatch.setattr(swin, name, None)  # a whole-block call would raise
        from focal_tpu_torch.ops.dropout import StepRngs

        rng = np.random.default_rng(0)
        batch = {loc: {mod: torch.from_numpy(rng.normal(size=(
            3, 2 * cfg["loc_mod_in_time_channels"][loc][mod], cfg["num_segments"],
            cfg["loc_mod_spectrum_len"][loc][mod])).astype(np.float32))
            for mod in cfg["modality_names"]} for loc in cfg["location_names"]}
        rngs = StepRngs(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
        logits, proj = net.train()(batch, head="both", rng=rngs)
        assert runs == [torch.bfloat16] * len(attns)
        (logits.float().sum() + sum(p.float().sum() for p in proj.values())).backward()
        assert all(m.qkv.weight.grad is not None and m.qkv.weight.grad.dtype == torch.float32
                   and m.relative_position_bias_table.grad.dtype == torch.float32 for m in attns)
        return
    if model == "DeepSense" or kwargs.get("pallas_mlp"):
        net = build_backbone(cfg, model, TASK, compute_dtype="bfloat16", **kwargs)
        assert {m.compute_dtype for m in net.modules()
                if hasattr(m, "compute_dtype")} == {torch.bfloat16}
        assert all(p.dtype == torch.float32 for p in net.parameters())
        if model == "DeepSense":
            return
        from focal_tpu_torch.ops import fused_mlp as fm

        mlps = [m for m in net.modules() if isinstance(m, swin.Mlp)]
        assert mlps and all(m.fused for m in mlps)
        runs = []
        real = fm._FusedMlpBf16.apply
        monkeypatch.setattr(fm._FusedMlpBf16, "apply",
                            lambda *a: runs.append(a[0].shape[-1]) or real(*a))
        rng = np.random.default_rng(0)
        batch = {loc: {mod: torch.from_numpy(rng.normal(size=(
            3, 2 * cfg["loc_mod_in_time_channels"][loc][mod], cfg["num_segments"],
            cfg["loc_mod_spectrum_len"][loc][mod])).astype(np.float32))
            for mod in cfg["modality_names"]} for loc in cfg["location_names"]}
        from focal_tpu_torch.ops.dropout import StepRngs

        rngs = StepRngs(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
        logits = net.train()(batch, rng=rngs)  # dropout: #11-bf16's plain version
        assert len(runs) == len(mlps)
        assert sorted(set(runs)) == sorted({m.Dense_0.in_features for m in mlps})
        logits.float().sum().backward()
        assert all(m.Dense_0.weight.grad is not None and m.Dense_0.weight.grad.dtype == torch.float32
                   for m in mlps)


def test_blocks_of_the_per_head_kernels_refuse_bf16():
    """MOD_WIDE's stages 1 and 2 (C 512, 1024) go to #4/#5, whose bf16
    forms (#4-bf16, #5-bf16) are ported since (ROADMAP A6.3): the bf16
    MOD_WIDE SW_Transformer builds (on the meta device, its 184M parameters
    unallocated), with and without -pallas_mlp, and no block refuses."""
    from focal_tpu_torch.ops import pallas_kernels as pk

    for kwargs in ({}, {"pallas_mlp": True}):
        with torch.device("meta"):
            net = build_backbone(load_dataset_config("MOD_WIDE"), "SW_Transformer", TASK,
                                 compute_dtype="bfloat16", **kwargs)
        attns = [m for m in net.modules() if isinstance(m, swin.WindowAttention)]
        perhead = {m.dim for m in attns
                   if not pk.wblock_fits(m.window_size[0] * m.window_size[1], m.dim, m.num_heads)}
        assert perhead == {512, 1024}
        assert all(m.compute_dtype == torch.bfloat16 for m in attns)


@pytest.mark.parametrize("dim,heads", [(12, 2), (20, 4)], ids=["C12", "C20"])
def test_widths_no_bf16_kernel_takes_refuse(dim, heads):
    """C not a multiple of 8, which no bf16 kernel takes (#1-bf16 to
    #9-bf16 stage rows 8 values at a time), no longer refuses (ROADMAP
    C12): the bf16 WindowAttention builds over f32 parameters and runs the
    XLA route in bf16, a forward in eval and a forward and backward in
    training, its gradients f32 and finite, as the f32 one runs at these
    widths."""
    swin.WindowAttention(dim, (3, 3), heads)
    attn = swin.WindowAttention(dim, (3, 3), heads, attn_drop=0.2, compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in attn.parameters())
    x = torch.randn(8, 9, dim).to(torch.bfloat16)
    with torch.no_grad():
        assert attn.eval()(x).dtype == torch.bfloat16
    from focal_tpu_torch.ops.dropout import StepRngs

    rngs = StepRngs(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    y = attn.train()(x.requires_grad_(True), None, rngs)
    assert y.dtype == torch.bfloat16
    y.float().square().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 and bool(torch.isfinite(p.grad).all())
               for p in attn.parameters())


def test_predictor_serves_bf16_in_f32_probabilities():
    cfg = load_dataset_config("MOD_TINY")
    data, labels, _ = synthetic_arrays(cfg, TASK, 6, seed=0)  # a ragged last batch of 4
    out = {}
    for dtype in ("float32", "bfloat16"):
        p = Predictor(cfg, "SW_Transformer", TASK, None, batch_size=4, device="cpu", seed=1,
                      compute_dtype=dtype)
        assert {m.compute_dtype for m in p.model.modules()
                if hasattr(m, "compute_dtype")} == {getattr(torch, dtype)}
        out[dtype] = p.predict(data)["probs"]
        assert out[dtype].dtype == np.float32 and out[dtype].shape == (len(labels), 7)
        np.testing.assert_allclose(out[dtype].sum(-1), 1.0, atol=1e-5)
    # the same weights, two dtypes: close, not equal
    assert 0.0 < np.abs(out["float32"] - out["bfloat16"]).max() < 5e-2


def test_entry_points_run_bf16_and_save_f32(tmp_path, capsys):
    """The training CLI at bf16 (supervised, 1 epoch), the test CLI on its
    _best and the predict CLI, on the CPU: finite numbers, checkpoints of
    f32 tensors; DeepSense at bf16 trains the same way."""
    argv = ["-dataset", "MOD_TINY", "-learn_framework", "no", "-synthetic", "-synthetic_samples",
            "32", "-batch_size", "8", "-epochs", "1", "-val_epochs", "1", "-device", "cpu",
            "-output_dir", str(tmp_path), "-compute_dtype", "bfloat16"]
    state, best, points = train_main(argv)
    assert points and all(np.isfinite(p["train_loss"]) for p in points)
    folder = next((tmp_path / "weights" / "MOD_TINY_SW_Transformer").iterdir())
    saved = torch.load(next(folder.glob("*_best.pt")), map_location="cpu", weights_only=True)
    assert saved and all(t.dtype == torch.float32 for t in saved.values())
    loss, acc, f1 = test_cli.main(argv)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    result = predict.main(["-dataset", "MOD_TINY", "-synthetic", "-synthetic_samples", "6",
                           "-batch_size", "4", "-device", "cpu", "-compute_dtype", "bfloat16"])
    assert np.isfinite(result["probs"]).all()
    state, _, points = train_main(argv + ["-model", "DeepSense"])
    assert points and all(np.isfinite(p["train_loss"]) for p in points)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    folder = next((tmp_path / "weights" / "MOD_TINY_DeepSense").iterdir())
    saved = torch.load(next(folder.glob("*_best.pt")), map_location="cpu", weights_only=True)
    assert saved and all(t.dtype == torch.float32 for t in saved.values())


def test_dropouts_scale_in_the_tensors_type():
    """remat_dropout and DropPath on bf16 tensors stay bf16 and scale the
    kept values by 1 / keep in bf16, as the JAX package's ``x *
    _inv_keep(rate)`` and ``x / keep`` do; their gradients are bf16."""
    from focal_tpu_torch.ops.dropout import StepRngs, keep_scale, remat_dropout

    x = torch.randn(64, 32).to(torch.bfloat16).requires_grad_(True)
    y = remat_dropout(x, 0.2, torch.Generator().manual_seed(0))
    kept = y != 0
    assert y.dtype == torch.bfloat16 and 0 < int(kept.sum()) < x.numel()
    assert torch.equal(y[kept], (x.detach() * keep_scale(0.2))[kept])
    (g,) = torch.autograd.grad(y.float().sum(), x)
    assert g.dtype == torch.bfloat16
    dp = swin.DropPath(0.25).train()
    xs = x.detach().reshape(64, 1, 32)
    z = dp(xs, StepRngs(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)))
    rows = z.reshape(64, -1).abs().sum(-1) > 0
    assert z.dtype == torch.bfloat16 and 0 < int(rows.sum()) < 64
    assert torch.equal(z[rows], (xs / 0.75)[rows])
