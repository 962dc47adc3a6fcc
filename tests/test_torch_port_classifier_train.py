"""The supervised and finetune stages of the port against the JAX package
on the CPU, and the classifier CLIs (``python -m focal_tpu_torch.train
-learn_framework no``, ``-stage finetune``, ``python -m
focal_tpu_torch.test``) in-process.

  * One supervised step (``train.steps.make_supervised_train_step``) at
    MOD_TINY, batch 8, every drop rate 0 and the fixed pool ["no"] (the
    step is deterministic), from the JAX initial parameters and batch
    statistics carried in by ``params_from_flax``: SW_Transformer without
    and with -pallas_mlp (the JAX attention and fused MLP kernels in
    interpret mode; the port's plain versions), each also with
    -no_pallas_block on the port's side (its attention-only route: the qkv
    and proj Linears around #6/#8's plain versions), and DeepSense. Loss 1e-5
    relative; each gradient 1e-4 relative (max|port - jax| / max|jax|), absolutely (1e-4) where both
    are below 1e-2 (conv biases before a BatchNorm); running statistics
    1e-5 relative.
  * Finetuning trains what the JAX ``trainable_mask`` trains; one finetune
    step leaves every backbone parameter bitwise as it was, moves the head
    as the JAX step does (1e-6 absolute where the gradient is not tiny, as
    the pretrain step test holds it; attention's key bias, whose true
    gradient is 0, is left out: Adam's first step turns its noise into
    +-lr) and updates DeepSense's running
    statistics as the JAX step does (1e-5 relative).
  * The supervised (AdamW) and finetune (Adam with L2) optimizers equal
    optax's over 3 updates: 1e-6 relative.
  * -label_ratio keeps the rows the JAX loader keeps, exactly; pretraining
    ignores it.
  * ``eval_supervised``'s numbers equal the JAX one's on the same logits:
    the loss to 1e-6 relative, the metrics to 1e-12.
  * The CLI: supervised 2 epochs and -resume to 3 equal a straight 3-epoch
    run (1e-6, the same steps); pretrain then finetune (backbone bitwise
    the pretrained one; the log of pretraining kept); the test CLI on each
    stage's _best file reproduces the run's final test loss (1e-6).
"""

import copy
import importlib
import logging
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from focal_tpu.data.loader import create_dataloader as jax_create_dataloader
from focal_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from focal_tpu.models import build_backbone as jax_build_backbone
from focal_tpu.ops import build_augmenter as jax_build_augmenter
from focal_tpu.params.auto import set_auto_params
from focal_tpu.params.cli import build_parser
from focal_tpu.train import optim as jo
from focal_tpu.train.evaluate import eval_supervised as jax_eval_supervised
from focal_tpu.train.state import init_state
from focal_tpu.train.steps import make_supervised_train_step as jax_make_supervised_step
from focal_tpu_torch import params as port_params
from focal_tpu_torch import test as test_cli
from focal_tpu_torch.data import load_split, synthetic_arrays, to_device
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.ops.augment import build_augmenter
from focal_tpu_torch.params import load_dataset_config, parse_train_params
from focal_tpu_torch.train import optim as to
from focal_tpu_torch.train.evaluate import supervised_metrics
from focal_tpu_torch.train.state import create_train_state
from focal_tpu_torch.train.steps import make_supervised_train_step
from focal_tpu_torch.weights import params_from_flax
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")

BATCH = 8
STEPS_PER_EPOCH = 10
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


def _deterministic(cfg):
    cfg = copy.deepcopy(cfg)
    sw = cfg["SW_Transformer"]
    sw["dropout_ratio"] = sw["drop_path_rate"] = sw["attn_drop_rate"] = 0.0
    cfg["DeepSense"]["dropout_ratio"] = 0.0
    for model in ("SW_Transformer", "DeepSense"):
        cfg[model]["fixed_augmenters"] = {"time_augmenters": ["no"], "freq_augmenters": ["no"]}
    return cfg


def _capturing(tx):
    """tx that also keeps the gradient it was given in its state."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _argv(model, stage):
    framework = "no" if stage == "supervised" else "FOCAL"
    return ["-dataset", "MOD_TINY", "-model", model, "-learn_framework", framework,
            "-batch_size", str(BATCH)]


def _jax_step(tmp, model, stage, pallas_mlp=False):
    args = build_parser().parse_args(_argv(model, stage) + ["-output_dir", str(tmp)])
    args.option = "train"
    args = set_auto_params(args)  # as pretraining: finetune's folder lookup is not needed here
    args.stage = "finetune" if stage == "finetune" else "pretrain"
    args.dataset_config = _deterministic(args.dataset_config)
    # the Pallas kernels (interpret mode) only where the fused MLP is compared,
    # and there the attention-only kernel rather than the slower whole block
    args.force_pallas, args.data_parallel, args.pallas_mlp = pallas_mlp, 1, pallas_mlp
    args.no_pallas_block = True
    net = jax_build_backbone(args)
    augmenter = jax_build_augmenter(args)
    ds = jax_synthetic(args.dataset_config, args.task, 2 * BATCH, seed=0)
    data = {loc: {m: jnp.asarray(a) for m, a in mods.items()} for loc, mods in ds.data.items()}
    sample = augmenter.no({loc: {m: a[:2] for m, a in mods.items()} for loc, mods in data.items()})
    state = init_state(args, net, sample, optax.identity(), jax.random.key(0))
    tx = _capturing(jo.build_optimizer(args, state.params, steps_per_epoch=STEPS_PER_EPOCH)[0])
    state = state.replace(tx=tx, opt_state=tx.init(state.params))
    init = jax.device_get((state.params, state.batch_stats))
    step = jax_make_supervised_step(net, augmenter)
    new_state, metrics = step(state, data, jnp.asarray(ds.labels),
                              jnp.arange(BATCH, dtype=jnp.int32), jax.random.key(1))
    cfg = args.dataset_config
    return {"cfg": cfg, "init": init, "loss": float(metrics["loss"]),
            "grads": params_from_flax(jax.device_get(new_state.opt_state[1]), {}, cfg),
            "params": params_from_flax(jax.device_get(new_state.params), {}, cfg),
            "stats": params_from_flax({}, jax.device_get(new_state.batch_stats), cfg),
            "mask": jo.trainable_mask(state.params, args)}


def _port_step(ref, model, stage, pallas_mlp=False, pallas_block=True):
    argv = _argv(model, stage) + (["-stage", "finetune"] if stage == "finetune" else [])
    argv += (["-pallas_mlp"] if pallas_mlp else []) + ([] if pallas_block else ["-no_pallas_block"])
    args = parse_train_params(argv + ["-device", "cpu"])
    args.dataset_config = cfg = ref["cfg"]
    net = build_backbone(cfg, model, TASK, args.learn_framework, pallas_mlp=args.pallas_mlp,
                         pallas_block=not args.no_pallas_block)
    net.load_state_dict(params_from_flax(*ref["init"], cfg), strict=True)
    state = create_train_state(args, net, steps_per_epoch=STEPS_PER_EPOCH)
    host, labels, _ = synthetic_arrays(cfg, TASK, 2 * BATCH, seed=0)
    step = make_supervised_train_step(net, build_augmenter(args), fixed_aug=stage == "supervised")
    _, metrics = step(state, to_device(host, "cpu"), torch.from_numpy(labels).long(),
                      torch.arange(BATCH))
    return args, net, float(metrics["loss"]), {n: p.grad for n, p in net.named_parameters()}


def _grad_err(got, want):
    g, w = got.numpy(), want.numpy()
    if max(np.abs(g).max(), np.abs(w).max()) < 1e-2:
        return float(np.abs(g - w).max())
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.mark.parametrize("model,pallas_mlp,pallas_block", [
    pytest.param("SW_Transformer", False, True, id="SW_Transformer-False"),
    pytest.param("SW_Transformer", True, True, id="SW_Transformer-True"),
    pytest.param("DeepSense", False, True, id="DeepSense-False"),
    pytest.param("SW_Transformer", False, False, id="SW_Transformer-False-no_pallas_block"),
    pytest.param("SW_Transformer", True, False, id="SW_Transformer-True-no_pallas_block"),
])
def test_supervised_step_matches_jax(model, pallas_mlp, pallas_block, tmp_path):
    ref = _jax_step(tmp_path, model, "supervised", pallas_mlp)
    _, net, loss, grads = _port_step(ref, model, "supervised", pallas_mlp, pallas_block)
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    assert set(grads) == set(ref["grads"])
    for name, want in ref["grads"].items():
        if grads[name] is None:  # off the class path (the projectors): 0 on the JAX side
            assert "mod_projector" in name and float(want.abs().max()) == 0.0, name
            continue
        assert _grad_err(grads[name], want) <= 1e-4, name
    buffers = dict(net.named_buffers())
    for name, want in ref["stats"].items():
        assert float((buffers[name] - want).abs().max() / want.abs().max()) <= 1e-5, name


def _named_mask(mask_tree, cfg, params):
    """A JAX trainable-mask tree -> {port name: bool}."""
    ones = jax.tree_util.tree_map(lambda p, m: np.full(np.shape(p), float(m), np.float32),
                                  params, mask_tree)
    return {n: bool(t.min() > 0) for n, t in params_from_flax(ones, {}, cfg).items()}


@pytest.mark.parametrize("model", ["SW_Transformer", "DeepSense"])
def test_finetune_step_trains_the_jax_set_and_nothing_else(model, tmp_path):
    ref = _jax_step(tmp_path, model, "finetune")
    args, net, loss, grads = _port_step(ref, model, "finetune")
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    want_mask = _named_mask(ref["mask"], ref["cfg"], ref["init"][0])
    assert to.trainable_mask(net, args) == want_mask
    assert sorted({n.split(".")[0] for n, m in want_mask.items() if m}) == (
        ["class_layer", "mod_fusion_layer"] if model == "SW_Transformer" else ["class_layer"])
    before = params_from_flax(*ref["init"], ref["cfg"])
    post = dict(net.named_parameters())
    for name, p in post.items():
        if not want_mask[name]:
            assert grads[name] is None and torch.equal(p.detach(), before[name]), name
            continue
        want_g = ref["grads"][name]
        assert _grad_err(grads[name], want_g) <= 1e-4, name
        if float(want_g.abs().max()) < 1e-6:
            continue  # a true gradient of 0 (attention's key bias): Adam moves noise
        big = want_g.abs() > 1e-3 * want_g.abs().max()
        torch.testing.assert_close(p.detach()[big], ref["params"][name][big], rtol=0, atol=1e-6)
    buffers = dict(net.named_buffers())
    for name, want in ref["stats"].items():
        assert not torch.equal(want, before[name])  # the finetune step moved it
        assert float((buffers[name] - want).abs().max() / want.abs().max()) <= 1e-5, name


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.patch_embed_a = nn.Linear(4, 3)
        self.dense = nn.Linear(3, 5)
        self.mod_fusion_layer = nn.Linear(5, 5)
        self.class_layer = nn.Linear(5, 2)


@pytest.mark.parametrize("stage", ["supervised", "finetune"])
def test_classifier_optimizers_match_optax(stage):
    cfg = copy.deepcopy(load_dataset_config("MOD"))
    args = SimpleNamespace(dataset_config=cfg, model="SW_Transformer", learn_framework="FOCAL",
                           train_mode="supervised" if stage == "supervised" else "contrastive",
                           stage="pretrain" if stage == "supervised" else "finetune",
                           clip_grad=False, grad_accum=1)
    torch.manual_seed(0)
    net = _Net()
    params = {name: {"kernel": jnp.asarray(m.weight.detach().numpy().T),
                     "bias": jnp.asarray(m.bias.detach().numpy())}
              for name, m in net.named_children()}
    tx, _ = jo.build_optimizer(args, params, steps_per_epoch=2)
    opt_state = tx.init(params)
    sopt, _ = to.build_optimizer(args, net, steps_per_epoch=2)
    assert type(sopt.optimizer).__name__ == ("AdamW" if stage == "supervised" else "Adam")
    rng = np.random.default_rng(1)
    for k in range(3):
        grads = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
                 for n, p in net.named_parameters()}
        tree = {}
        for name, g in grads.items():
            mod, leaf = name.split(".")
            tree.setdefault(mod, {})["kernel" if leaf == "weight" else "bias"] = jnp.asarray(
                g.T if leaf == "weight" else g)
        upd, opt_state = tx.update(tree, opt_state, params)
        params = optax.apply_updates(params, upd)
        sopt.zero_grad()
        for n, p in net.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[n])
        sopt.step(k)
    trained = {n for n, p in net.named_parameters() if p.requires_grad}
    assert trained == ({n for n, _ in net.named_parameters()} if stage == "supervised" else
                       {"mod_fusion_layer.weight", "mod_fusion_layer.bias", "class_layer.weight",
                        "class_layer.bias"})
    for n, p in net.named_parameters():
        mod, leaf = n.split(".")
        want = np.asarray(params[mod]["kernel"]).T if leaf == "weight" else params[mod]["bias"]
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6, atol=1e-9, err_msg=n)


@pytest.mark.parametrize("framework,stage,ratio", [("no", "pretrain", 0.3), ("FOCAL", "finetune", 0.5),
                                                   ("FOCAL", "pretrain", 0.5)])
def test_label_ratio_keeps_the_jax_rows(framework, stage, ratio, tmp_path):
    argv = ["-dataset", "MOD_TINY", "-learn_framework", framework, "-synthetic",
            "-synthetic_samples", "100", "-label_ratio", str(ratio), "-seed", "3"]
    args = parse_train_params(argv + ["-stage", stage, "-device", "cpu"])
    jargs = build_parser().parse_args(argv + ["-output_dir", str(tmp_path)])
    jargs.option = "train"
    jargs = set_auto_params(jargs)
    jargs.stage = stage
    split = load_split("train", args)
    want = jax_create_dataloader("train", jargs).dataset
    expected = 100 if (framework, stage) == ("FOCAL", "pretrain") else round(100 * ratio)
    assert len(split) == len(want) == expected
    np.testing.assert_array_equal(split.labels, want.labels)
    for loc, mods in want.data.items():
        for mod, arr in mods.items():
            np.testing.assert_array_equal(split.data[loc][mod], arr)


@pytest.mark.parametrize("task", ["vehicle_classification", "speed_classification"])
def test_eval_supervised_matches_jax_on_the_same_logits(task):
    args = parse_train_params(["-dataset", "MOD", "-task", task, "-learn_framework", "no"])
    n_cls = args.dataset_config[task]["num_classes"]
    rng = np.random.default_rng(7)
    nb, B = 5, 16
    logits = rng.normal(size=(nb, B, n_cls)).astype(np.float32)
    plan = SimpleNamespace(labels=rng.integers(0, n_cls, size=(nb, B)),
                           weight=np.ones((nb, B), np.float32), device_idx=None)
    plan.weight[-1, 9:] = 0.0  # a padded tail
    want_loss, want = jax_eval_supervised(args, None, lambda *a: jnp.asarray(logits), plan, None)
    loss, got = supervised_metrics(args, logits, plan)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    assert abs(got[0] - want[0]) <= 1e-12 and abs(got[1] - want[1]) <= 1e-12
    np.testing.assert_array_equal(got[2], want[2])


TINY = ["-dataset", "MOD_TINY", "-synthetic", "-synthetic_samples", "64", "-batch_size", "16",
        "-val_epochs", "1", "-device", "cpu"]


@pytest.fixture
def step_schedules(monkeypatch):
    """The recipes' cosine schedules take -epochs as their length (as in
    the JAX package), so a 2-epoch run takes other learning rates than a
    3-epoch one: switch to the step form for the resume test."""
    real = port_params.load_dataset_config

    def load(name):
        cfg = copy.deepcopy(real(name))
        cfg["SW_Transformer"]["lr_scheduler"]["name"] = "step"
        return cfg

    monkeypatch.setattr(port_params, "load_dataset_config", load)


def _folder(out, suffix):
    root = out / "weights" / "MOD_TINY_SW_Transformer"
    (exp,) = [p for p in root.iterdir() if p.name.endswith(suffix)]
    return exp


def test_supervised_cli_resume_equals_a_straight_run_and_test_reads_best(tmp_path, step_schedules):
    sup = TINY + ["-learn_framework", "no", "-pallas_mlp"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    state, best, points = train_cli.main(sup + ["-epochs", "3", "-output_dir", str(straight)])
    assert [p["epoch"] for p in points] == [0, 1, 2] and state.step == 3 * 4
    assert best == max(p["val_acc"] for p in points)
    assert all(np.isfinite(p[k]) for p in points for k in ("train_loss", "val_loss", "test_loss"))
    train_cli.main(sup + ["-epochs", "2", "-output_dir", str(resumed)])
    state2, best2, more = train_cli.main(sup + ["-epochs", "3", "-resume", "-output_dir",
                                                str(resumed)])
    assert [p["epoch"] for p in more] == [2] and state2.step == state.step and best2 == best
    exp = _folder(resumed, "supervised_vehicle_classification_1.0")
    files = {k: exp / f"MOD_TINY_SW_Transformer_vehicle_classification_{k}.pt"
             for k in ("best", "latest", "resume")}
    assert all(f.is_file() for f in files.values()) and (exp / "train_log.txt").is_file()
    want = torch.load(_folder(straight, "1.0") / files["latest"].name, weights_only=True)
    got = torch.load(files["latest"], weights_only=True)
    for name in want:
        assert float((got[name] - want[name]).abs().max()) <= 1e-6, name
    # the test CLI on the _latest weights' twin: the run's last point is the best or not, so
    # compare against the _best file's own evaluation through the class head
    loss, acc, _ = test_cli.main(sup + ["-output_dir", str(resumed)])
    best_point = [p for p in points if p["val_acc"] == best][0]
    np.testing.assert_allclose(loss, best_point["test_loss"], rtol=1e-5)
    np.testing.assert_allclose(acc, best_point["test_acc"], rtol=1e-12)


def test_pretrain_then_finetune_keeps_the_backbone_and_test_reads_best(tmp_path):
    out = ["-output_dir", str(tmp_path)]
    train_cli.main(TINY + ["-learn_framework", "FOCAL", "-epochs", "1"] + out)
    exp = _folder(tmp_path, "contrastive_FOCAL")
    pretrain_log = (exp / "pretrain_log.txt").read_text()
    pre = torch.load(exp / "MOD_TINY_SW_Transformer_pretrain_latest.pt", weights_only=True)
    state, best, points = train_cli.main(TINY + ["-learn_framework", "FOCAL", "-stage", "finetune",
                                                 "-epochs", "2"] + out)
    assert [p["epoch"] for p in points] == [0, 1] and state.step == 2 * 4
    assert (exp / "pretrain_log.txt").read_text() == pretrain_log
    assert (exp / "vehicle_classification_1.0_finetune_log.txt").is_file()
    latest = torch.load(exp / "MOD_TINY_SW_Transformer_vehicle_classification_1.0_finetune_latest.pt",
                        weights_only=True)
    moved = set()
    for name, t in latest.items():
        if name.startswith(("class_layer", "mod_fusion_layer")):
            if not torch.equal(t, pre[name]):
                moved.add(name.split(".")[0])
        else:
            assert torch.equal(t, pre[name]), name
    assert moved == {"class_layer", "mod_fusion_layer"}
    loss, acc, _ = test_cli.main(TINY + ["-learn_framework", "FOCAL", "-stage", "finetune"] + out)
    best_point = [p for p in points if p["val_acc"] == best][0]
    np.testing.assert_allclose(loss, best_point["test_loss"], rtol=1e-5)


def test_classifier_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["-dataset", "MOD_TINY", "-synthetic", "-output_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(base + ["-learn_framework", "no", "-pallas_mlp"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cli.main(base + ["-learn_framework", "no"])
    assert not os.path.exists(tmp_path / "weights")
