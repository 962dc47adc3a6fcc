"""DeepSense FOCAL pretraining in the port against the JAX package on the
CPU, and the training CLI and serving of DeepSense.

  * One pretrain step (``train.steps.make_pretrain_step``) at MOD_TINY,
    batch 8 (two subsequences of 4), every drop rate 0 and the augmenter
    pool ["no"] (both views are the FFT: the step is deterministic), from
    the JAX initial parameters and batch statistics carried into the port
    by ``params_from_flax``; views fused as one [2B] batch and as two
    forwards (``-no_fused_views``), each without and with ``-pallas_conv``
    (the JAX conv-tower kernels in interpret mode, the port's tower in its
    plain version). Tolerances (f32, summation order only): the loss 1e-5
    relative; each parameter's gradient 1e-4 relative (max|port - jax| /
    max|jax|), absolutely (1e-4) where both are below 1e-2 (conv biases
    before a BatchNorm: a true gradient of 0, cancellation noise on both
    sides); each updated running statistic 1e-5 relative.
  * ``python -m focal_tpu_torch.train -model DeepSense -pallas_conv -device
    cpu`` in-process on MOD_TINY: two epochs and then ``-resume`` to a
    third equal a straight three-epoch run, parameters and running
    statistics within 1e-6 (the same steps; only float order may differ),
    and the checkpoints carry the running statistics. The recipe's
    pretrain schedule is switched to its step form for this test: the
    cosine one's length is ``-epochs`` (as in the JAX package), so a
    two-epoch run takes other learning rates than a three-epoch one.
  * ``Predictor`` serves the run's ``_best`` file on the CPU: probabilities
    finite, summing to 1, and equal (1e-6) to the loaded model's eval
    forward.
"""

import copy
import importlib
import logging

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
from focal_tpu_torch.ops.augment import Augmenter, build_augmenter
from focal_tpu_torch.params import load_dataset_config, parse_train_params
from focal_tpu_torch.serve import Predictor
from focal_tpu_torch.train.losses import make_focal_loss
from focal_tpu_torch.train.state import create_train_state
from focal_tpu_torch.train.steps import make_pretrain_step
from focal_tpu_torch.weights import params_from_flax
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")

BATCH = 8
STEPS_PER_EPOCH = 10
ARGV = ["-dataset", "MOD_TINY", "-model", "DeepSense", "-learn_framework", "FOCAL",
        "-stage", "pretrain", "-batch_size", str(BATCH)]


def _deterministic(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["DeepSense"]["dropout_ratio"] = 0.0
    cfg["FOCAL"]["random_augmenters"] = {"time_augmenters": ["no"], "freq_augmenters": ["no"]}
    return cfg


def _capturing(tx):
    """tx that also keeps the gradient it was given in its state."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _jax_step(tmp, fused_views, pallas):
    args = build_parser().parse_args(ARGV)
    args.option = "train"
    args.output_dir = str(tmp)
    args = set_auto_params(args)
    args.dataset_config = _deterministic(args.dataset_config)
    args.pallas_conv = pallas
    model = jax_build_backbone(args)
    augmenter = jax_build_augmenter(args)
    ds = jax_synthetic(args.dataset_config, args.task, 2 * BATCH, seed=0, seq_len=4)
    data = {loc: {m: jnp.asarray(a) for m, a in mods.items()} for loc, mods in ds.data.items()}
    sample = augmenter.no({loc: {m: a[:2] for m, a in mods.items()} for loc, mods in data.items()})
    state = init_state(args, model, sample, optax.identity(), jax.random.key(0))
    tx, _ = jax_build_optimizer(args, state.params, steps_per_epoch=STEPS_PER_EPOCH)
    tx = _capturing(tx)
    state = state.replace(tx=tx, opt_state=tx.init(state.params))
    init = jax.device_get((state.params, state.batch_stats))
    step = jax_make_pretrain_step(model, augmenter, jax_make_focal_loss(args),
                                  fused_views=fused_views)
    new_state, metrics = step(state, data, jnp.arange(BATCH, dtype=jnp.int32), jax.random.key(1))
    return {"cfg": args.dataset_config, "init": init, "loss": float(metrics["loss"]),
            "grads": jax.device_get(new_state.opt_state[1]),
            "stats": jax.device_get(new_state.batch_stats)}


def _port_step(cfg, init, fused_views, pallas):
    args = parse_train_params(ARGV + ["-device", "cpu"] + (["-pallas_conv"] if pallas else []))
    args.dataset_config = cfg
    model = build_backbone(cfg, "DeepSense", args.task, args.learn_framework, pallas_conv=pallas)
    model.load_state_dict(params_from_flax(*init, cfg), strict=True)
    state = create_train_state(args, model, steps_per_epoch=STEPS_PER_EPOCH)
    data = to_device(synthetic_arrays(cfg, args.task, 2 * BATCH, seed=0)[0], "cpu")
    step = make_pretrain_step(model, build_augmenter(args), make_focal_loss(args), fused_views)
    _, metrics = step(state, data, torch.arange(BATCH))
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(metrics["loss"]), grads, dict(model.named_buffers())


@pytest.mark.parametrize("fused_views", [True, False])
@pytest.mark.parametrize("pallas", [False, True])
def test_pretrain_step_matches_jax(fused_views, pallas, tmp_path):
    ref = _jax_step(tmp_path, fused_views, pallas)
    cfg = ref["cfg"]
    loss, grads, buffers = _port_step(cfg, ref["init"], fused_views, pallas)
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    want_grads = params_from_flax(ref["grads"], {}, cfg)
    assert set(want_grads) == set(grads)
    for name, want in want_grads.items():
        got = grads[name]
        if got is None:  # off the pretrain path (class_layer)
            assert float(want.abs().max()) == 0.0, name
            continue
        g, w = got.numpy(), want.numpy()
        if max(np.abs(g).max(), np.abs(w).max()) < 1e-2:
            assert np.abs(g - w).max() <= 1e-4, name
        else:
            rel = float(np.abs(g - w).max() / np.abs(w).max())
            assert rel <= 1e-4, (name, rel)
    want_stats = params_from_flax({}, ref["stats"], cfg)
    assert set(want_stats) == set(buffers)
    init_stats = params_from_flax({}, ref["init"][1], cfg)
    for name, want in want_stats.items():
        assert not torch.equal(want, init_stats[name]), name  # the step moved it
        rel = float((buffers[name] - want).abs().max() / want.abs().max())
        assert rel <= 1e-5, (name, rel)


TINY_CLI = ARGV[:-1] + ["16", "-synthetic", "-synthetic_samples", "64", "-val_epochs", "1",
                        "-pallas_conv", "-device", "cpu"]


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


def _files(out):
    folder = out / "weights" / "MOD_TINY_DeepSense"
    (exp,) = [p for p in folder.iterdir() if p.name.startswith("exp")]
    return {kind: exp / f"MOD_TINY_DeepSense_pretrain_{kind}.pt"
            for kind in ("latest", "best", "resume")}


def test_cli_resume_equals_straight_run_and_best_serves(tmp_path, monkeypatch):
    from focal_tpu_torch import params

    real = params.load_dataset_config

    def step_schedule(name):
        cfg = copy.deepcopy(real(name))
        cfg["FOCAL"]["pretrain_lr_scheduler"]["name"] = "step"
        return cfg

    monkeypatch.setattr(params, "load_dataset_config", step_schedule)
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    _, _, points = train_cli.main(TINY_CLI + ["-epochs", "3", "-output_dir", str(straight)])
    assert [p["epoch"] for p in points] == [0, 1, 2]
    assert all(np.isfinite(p[k]) for p in points for k in ("train_loss", "val_loss", "test_loss"))
    train_cli.main(TINY_CLI + ["-epochs", "2", "-output_dir", str(resumed)])
    state, _, more = train_cli.main(TINY_CLI + ["-epochs", "3", "-resume", "-output_dir",
                                                str(resumed)])
    assert [p["epoch"] for p in more] == [2]
    want = torch.load(_files(straight)["latest"], weights_only=True)
    got = torch.load(_files(resumed)["latest"], weights_only=True)
    stats = [n for n in want if n.endswith(".mean") or n.endswith(".var")]
    assert stats and set(got) == set(want) == set(state.model.state_dict())
    init_var = torch.ones_like(want[stats[1]])
    assert not torch.equal(want[stats[1]], init_var)  # the running statistics moved
    for name in want:
        assert float((got[name] - want[name]).abs().max()) <= 1e-6, name
    resume = torch.load(_files(resumed)["resume"], weights_only=True)
    assert set(stats) <= set(resume["model"])

    cfg = load_dataset_config("MOD_TINY")
    best = _files(resumed)["best"]
    predictor = Predictor(cfg, "DeepSense", "vehicle_classification", str(best), batch_size=16,
                          device="cpu", learn_framework="FOCAL")
    data, _, _ = synthetic_arrays(cfg, "vehicle_classification", 40, seed=3)
    result = predictor.predict(data)
    probs = result["probs"]
    assert probs.shape == (40, 7) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    net = build_backbone(cfg, "DeepSense", "vehicle_classification", "FOCAL")
    net.load_state_dict(torch.load(best, weights_only=True))
    x = {loc: {m: torch.from_numpy(a[:16]) for m, a in mods.items()} for loc, mods in data.items()}
    with torch.no_grad():
        direct = torch.softmax(net.eval()(Augmenter(cfg).no(x), head="class"), dim=-1).numpy()
    np.testing.assert_allclose(probs[:16], direct, atol=1e-6)


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a card and without -device cpu, DeepSense training and
    serving raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_dataset_config("MOD_TINY")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, "DeepSense", "vehicle_classification")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["-dataset", "MOD_TINY", "-model", "DeepSense", "-pallas_conv",
                        "-synthetic", "-output_dir", str(tmp_path)])


@pytest.mark.parametrize("flag,item", [("-init_weight", "A8"), ("-no_pallas_block", None)])
def test_unported_kernel_flags_raise(flag, item):
    """-init_weight (ported with its ROADMAP item, A8) parses for DeepSense;
    -no_pallas_block parses, reaches the SW_Transformer's attention-only
    route and is ignored by DeepSense, as in the JAX package."""
    assert parse_train_params(["-model", "DeepSense", "-pallas_conv"]).pallas_conv
    argv = [flag, "w.pt"] if flag == "-init_weight" else [flag]
    if item is not None:
        args = parse_train_params(["-model", "DeepSense", "-pallas_conv"] + argv)
        assert args.init_weight == "w.pt" and args.pallas_conv
        return
    cfg = load_dataset_config("MOD_TINY")
    for model in ("SW_Transformer", "DeepSense"):
        args = parse_train_params(argv + ["-model", model])
        assert args.no_pallas_block
        net = build_backbone(cfg, model, args.task, args.learn_framework,
                             pallas_block=not args.no_pallas_block)
        attns = [m for m in net.modules() if type(m).__name__ == "WindowAttention"]
        assert (model == "DeepSense") == (not attns)
        assert all(not m.pallas_block for m in attns)
