"""Gradient accumulation of the port (-grad_accum) on the CPU, against the
JAX package.

  * GradCache: the port's gathered pretrain step over k = 2 micro-batches
    of 4 (``train.steps.make_gathered_pretrain_step``) against the JAX
    package's jitted ``gathered_accum_update``, from the same initial
    parameters (``params_from_flax``), MOD_TINY SW_Transformer at every
    drop rate 0 with the augmenter pool ["no"], as
    ``test_torch_port_train_step.py`` sets the pretrain step up: the loss
    within 1e-5 relative, the gradients within max|port - jax| / max|jax|
    <= 1e-4 per tensor, the update as that file holds it;
  * the same gathered step against the port's own full-batch step of 8
    rows (LayerNorm only, so equal to the summation order): the loss within
    1e-6 relative, the gradients within 1e-5 of each tensor's largest;
  * MultiSteps: the port's optimizer under -grad_accum k against
    ``optax.MultiSteps`` around the JAX package's chain, the same gradients
    fed to both for 4k micro-steps: every micro-step's parameters within
    1e-6 relative (atol 1e-9), those of a cycle's inner micro-steps
    unchanged bit for bit, with the schedule counting effective updates
    (cycles that straddle epochs among the cases), the clip on the mean,
    and the finetune stage's frozen mask;
  * replay at the recipe's dropout, on the plain versions: pass 2's
    features equal pass 1's bitwise (SW_Transformer on each attention and
    MLP route, DeepSense with and without -pallas_conv), and DeepSense's
    BatchNorm buffers after one effective step equal those of pass 1's
    forwards chained (pass 2 folds nothing);
  * the CLIs: a MultiSteps supervised run resumed in the middle of a cycle
    equals a straight run (1e-6), in one process and at -data_parallel 2
    over two gloo processes, a resume with another -grad_accum raises, and
    -no_accum_gather pretrains.
"""

import copy
import importlib
import logging
import shutil
from types import SimpleNamespace

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
from focal_tpu.train import optim as jo
from focal_tpu.train.losses import make_focal_loss as jax_make_focal_loss
from focal_tpu.train.state import init_state
from focal_tpu.train.steps import gather_batch as jax_gather_batch
from focal_tpu.train.steps import (gathered_accum_update, make_micro_features,
                                   make_view_fuser)
from focal_tpu_torch.data import synthetic_arrays, to_device
from focal_tpu_torch.models import build_backbone, init_params
from focal_tpu_torch.ops.augment import build_augmenter
from focal_tpu_torch.params import parse_train_params
from focal_tpu_torch.train import optim as to
from focal_tpu_torch.train.losses import make_focal_loss
from focal_tpu_torch.train.state import TrainState, create_train_state
from focal_tpu_torch.train.steps import (gather_batch, make_gathered_pretrain_step,
                                         make_pretrain_step, pretrain_features, pretrain_views)
from focal_tpu_torch.weights import params_from_flax
from test_torch_port_distributed import _run
from test_torch_port_train_optim import CFG, _Net, _to_tree, _tree, _tree_flat
from test_torch_port_train_step import _capturing, _check_gradients_and_update, _deterministic
from torch_port_replay import recorded_passes, replayed_bitwise
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")

MICRO, K = 4, 2
STEPS_PER_EPOCH = 10


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
    root.setLevel(level)


@pytest.fixture(scope="module")
def jax_gathered(tmp_path_factory):
    """The JAX package's GradCache update over rows 0:4 and 4:8, jitted:
    its initial parameters, loss, gradients and updated parameters."""
    args = build_parser().parse_args(["-dataset", "MOD_TINY", "-model", "SW_Transformer",
                                      "-learn_framework", "FOCAL", "-stage", "pretrain",
                                      "-batch_size", str(MICRO), "-grad_accum", str(K)])
    args.option = "train"
    args.output_dir = str(tmp_path_factory.mktemp("jax_gathered"))
    args = set_auto_params(args)
    args.dataset_config = _deterministic(args.dataset_config)
    args.data_parallel = 1  # one device; the window attention's plain (XLA) route
    model = jax_build_backbone(args)
    augmenter = jax_build_augmenter(args)
    ds = jax_synthetic(args.dataset_config, args.task, 4 * MICRO, seed=0, seq_len=4)
    data = {loc: {m: jnp.asarray(a) for m, a in mods.items()} for loc, mods in ds.data.items()}
    sample = augmenter.no({loc: {m: a[:2] for m, a in mods.items()} for loc, mods in data.items()})
    state = init_state(args, model, sample, optax.identity(), jax.random.key(0))
    tx, _ = jo.build_optimizer(args, state.params, steps_per_epoch=STEPS_PER_EPOCH,
                               accum_in_step=True)
    tx = _capturing(tx)
    state = state.replace(tx=tx, opt_state=tx.init(state.params))
    init = jax.device_get(state.params)
    fuse, split = make_view_fuser(None, MICRO)
    micro_features = make_micro_features(model, fuse, split, True)

    def views_of(i):
        batch = jax_gather_batch(data, i * MICRO + jnp.arange(MICRO))
        r1, r2, r_drop = jax.random.split(jax.random.fold_in(jax.random.key(1), i), 3)
        return augmenter.random(r1, batch), augmenter.random(r2, batch), r_drop

    update = jax.jit(lambda st: gathered_accum_update(jax_make_focal_loss(args), micro_features,
                                                      views_of, st, jnp.arange(K)))
    new_state, loss = update(state)
    return {"cfg": args.dataset_config, "init": init, "loss": float(loss),
            "grads": jax.device_get(new_state.opt_state[1]),
            "params": jax.device_get(new_state.params)}


def _sw_args(batch, flags=()):
    args = parse_train_params(["-dataset", "MOD_TINY", "-batch_size", str(batch), "-device", "cpu",
                               "-grad_accum", str(K), *flags])
    return args


def _port_gathered(cfg, init):
    args = _sw_args(MICRO)
    args.dataset_config = cfg
    model = build_backbone(cfg, args.model, args.task, args.learn_framework)
    model.load_state_dict(params_from_flax(init, {}, cfg), strict=True)
    state = create_train_state(args, model, STEPS_PER_EPOCH, accum_in_step=True)
    data = to_device(synthetic_arrays(cfg, args.task, 4 * MICRO, seed=0)[0], "cpu")
    step = make_gathered_pretrain_step(model, build_augmenter(args), make_focal_loss(args), K)
    micro = [(data, torch.arange(i * MICRO, (i + 1) * MICRO)) for i in range(K)]
    with recorded_passes(model) as seen:
        state, metrics = step(state, micro)
    assert replayed_bitwise(seen)
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    return state, float(metrics["loss"]), grads, data


def test_gathered_step_matches_jax(jax_gathered):
    state, loss, grads, _ = _port_gathered(jax_gathered["cfg"], jax_gathered["init"])
    np.testing.assert_allclose(loss, jax_gathered["loss"], rtol=1e-5)
    _check_gradients_and_update(jax_gathered, state, grads)


def test_gathered_step_equals_the_full_batch_step(jax_gathered):
    """LayerNorm only: the effective batch's loss and gradient, one forward
    of 8 rows against two replayed micro-batches of 4."""
    cfg, init = jax_gathered["cfg"], jax_gathered["init"]
    _, loss, grads, data = _port_gathered(cfg, init)
    args = _sw_args(K * MICRO)
    args.dataset_config = cfg
    model = build_backbone(cfg, args.model, args.task, args.learn_framework)
    model.load_state_dict(params_from_flax(init, {}, cfg), strict=True)
    args.grad_accum = 1
    state = create_train_state(args, model, STEPS_PER_EPOCH)
    step = make_pretrain_step(model, build_augmenter(args), make_focal_loss(args))
    _, metrics = step(state, data, torch.arange(K * MICRO))
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-6)
    for name, p in model.named_parameters():
        if p.grad is None:
            assert grads.get(name) is None, name
            continue
        scale = max(float(p.grad.abs().max()), 1e-30)
        assert float((grads[name] - p.grad).abs().max()) / scale <= 1e-5, name


def _stage_args(stage, optimizer, clip, accum):
    cfg = copy.deepcopy(CFG)
    cfg["FOCAL"][f"{stage}_optimizer"]["name"] = optimizer
    cfg["FOCAL"][f"{stage}_lr_scheduler"]["train_epochs"] = 4
    return SimpleNamespace(dataset_config=cfg, train_mode="contrastive", learn_framework="FOCAL",
                           stage=stage, model="SW_Transformer", clip_grad=clip, grad_accum=accum)


@pytest.mark.parametrize("stage,optimizer,clip,accum,steps", [
    ("pretrain", "AdamW", False, 2, 2), ("pretrain", "AdamW", True, 2, 3),
    ("pretrain", "Adam", False, 3, 4), ("finetune", "AdamW", False, 2, 2),
])
def test_multisteps_match_optax(stage, optimizer, clip, accum, steps):
    """4k micro-steps of random gradients into both; ``steps`` micro-steps
    an epoch (3 and 4 leave cycles straddling epochs, so the effective
    updates' lr(epoch) is the float division's)."""
    args = _stage_args(stage, optimizer, clip, accum)
    torch.manual_seed(0)
    net = _Net()
    params = _tree(net)
    tx, _ = jo.build_optimizer(args, params, steps_per_epoch=steps)
    opt_state = tx.init(params)
    sopt, _ = to.build_optimizer(args, net, steps_per_epoch=steps)
    assert sopt.accum == accum
    rng = np.random.default_rng(1)
    scale = 100.0 if clip else 1.0
    for k in range(4 * accum):
        before = {n: p.detach().clone() for n, p in net.named_parameters()}
        grads = {n: (rng.normal(size=tuple(p.shape)) * scale).astype(np.float32)
                 for n, p in net.named_parameters()}
        upd, opt_state = tx.update(_to_tree(grads), opt_state, params)
        params = optax.apply_updates(params, upd)
        sopt.zero_grad()
        for n, p in net.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[n])
        sopt.step(k)
        want = _tree_flat(params)
        for n, p in net.named_parameters():
            if k % accum < accum - 1 or not p.requires_grad:
                assert torch.equal(p.detach(), before[n]), (k, n)
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6, atol=1e-9,
                                       err_msg=f"{n} after micro-step {k}")
    assert int(opt_state.gradient_step) == 4 and sopt.acc is None
    trained = {n.split(".")[0] for n, p in net.named_parameters() if p.requires_grad}
    assert trained == ({"class_layer"} if stage == "finetune" else {"dense", "class_layer"})


REPLAY = {
    "sw": ("SW_Transformer", []),
    "sw_no_pallas_block": ("SW_Transformer", ["-no_pallas_block"]),
    "sw_pallas_mlp": ("SW_Transformer", ["-pallas_mlp"]),
    "ds": ("DeepSense", []),
    "ds_pallas_conv": ("DeepSense", ["-pallas_conv"]),
}


@pytest.mark.parametrize("case", list(REPLAY))
def test_replay_is_bitwise_at_recipe_dropout(case):
    """The recipe's drop rates and augmenters, the plain versions of each
    route: pass 2 replays pass 1's features bit for bit, under gradient
    where pass 1 ran without; BatchNorm's running statistics are pass 1's
    chain (folded once a micro-batch, not again in pass 2)."""
    name, flags = REPLAY[case]
    args = _sw_args(MICRO, ["-model", name, *flags])
    cfg = args.dataset_config
    model = build_backbone(cfg, name, args.task, args.learn_framework,
                           pallas_conv=args.pallas_conv, pallas_mlp=args.pallas_mlp,
                           pallas_block=not args.no_pallas_block)
    model = init_params(model, seed=0)
    chained = copy.deepcopy(model)
    initial = {n: b.clone() for n, b in model.named_buffers()}
    state = create_train_state(args, model, STEPS_PER_EPOCH, seed=5, accum_in_step=True)
    data = to_device(synthetic_arrays(cfg, args.task, K * MICRO, seed=0)[0], "cpu")
    augmenter = build_augmenter(args)
    micro = [(data, torch.arange(i * MICRO, (i + 1) * MICRO)) for i in range(K)]
    step = make_gathered_pretrain_step(model, augmenter, make_focal_loss(args), K)
    with recorded_passes(model) as seen:
        _, metrics = step(state, micro)
    assert replayed_bitwise(seen) and np.isfinite(float(metrics["loss"]))
    ref = TrainState(chained, None, seed=5)
    with torch.no_grad():
        for i, (d, idx) in enumerate(micro):
            rngs = ref.generators(i)
            v1, v2 = pretrain_views(augmenter, rngs, gather_batch(d, idx))
            pretrain_features(chained, rngs, v1, v2)
    buffers = dict(model.named_buffers())
    stats = [n for n in buffers if n.endswith((".mean", ".var"))]
    assert bool(stats) == (name == "DeepSense")
    for n, want in chained.named_buffers():
        assert torch.equal(buffers[n], want), n
    assert all(not torch.equal(buffers[n], initial[n]) for n in stats)


TINY_SUP = ["-dataset", "MOD_TINY", "-model", "DeepSense", "-learn_framework", "no", "-synthetic",
            "-synthetic_samples", "48", "-batch_size", "16", "-val_epochs", "1", "-device", "cpu",
            "-grad_accum", "2"]


def _latest(out):
    (path,) = (out / "weights").rglob("*_latest.pt")
    return torch.load(path, weights_only=True)


def test_multisteps_resume_mid_cycle_equals_a_straight_run(tmp_path):
    """3 steps an epoch, cycles of 2: epoch 0's checkpoint holds half a
    cycle's accumulator, which the resumed run completes."""
    state, _, _ = train_cli.main(TINY_SUP + ["-epochs", "2", "-output_dir", str(tmp_path / "a")])
    assert state.step == 6 and state.optimizer.acc is None
    _, _, first = train_cli.main(TINY_SUP + ["-epochs", "1", "-output_dir", str(tmp_path / "b")])
    (resume,) = (tmp_path / "b" / "weights").rglob("*_resume.pt")
    saved = torch.load(resume, weights_only=True)
    assert saved["step"] == 3 and saved["grad_accum"] == 2
    assert len(saved["acc"]) == 1 and sum(a is not None for a in saved["acc"][0]) > 0
    with pytest.raises(ValueError, match="grad_accum=2"):
        train_cli.main([*TINY_SUP[:-1], "3", "-epochs", "2", "-resume", "-output_dir",
                        str(tmp_path / "b")])
    resumed, _, second = train_cli.main(TINY_SUP + ["-epochs", "2", "-resume", "-output_dir",
                                                    str(tmp_path / "b")])
    assert resumed.step == 6 and [p["epoch"] for p in first + second] == [0, 1]
    want, got = _latest(tmp_path / "a"), _latest(tmp_path / "b")
    for name in want:
        assert float((got[name] - want[name]).abs().max()) <= 1e-6, name


def test_multisteps_resume_mid_cycle_at_dp2_equals_a_straight_run(tmp_path):
    """The same at -data_parallel 2 over two gloo processes, where each
    rank's accumulator holds only its rows' share of the cycle's mean: the
    file keeps both ranks' shares, and each resumed rank completes its own.
    One process resumes the same file too (the shares' sum)."""
    argv = TINY_SUP + ["-data_parallel", "2"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _run("focal_tpu_torch.train", argv + ["-epochs", "2", "-output_dir", a], world=2)
    _run("focal_tpu_torch.train", argv + ["-epochs", "1", "-output_dir", b], world=2)
    (resume,) = (tmp_path / "b" / "weights").rglob("*_resume.pt")
    saved = torch.load(resume, weights_only=True)
    assert saved["step"] == 3 and len(saved["acc"]) == 2
    held = [(x, y) for x, y in zip(*saved["acc"]) if x is not None]
    assert held and any(not torch.equal(x, y) for x, y in held)
    shutil.copytree(b, tmp_path / "c")
    _run("focal_tpu_torch.train", argv + ["-epochs", "2", "-resume", "-output_dir", b], world=2)
    want, got = _latest(tmp_path / "a"), _latest(tmp_path / "b")
    for name in want:
        assert float((got[name] - want[name]).abs().max()) <= 1e-6, name
    one, _, _ = train_cli.main(TINY_SUP + ["-epochs", "2", "-resume", "-output_dir",
                                           str(tmp_path / "c")])
    assert one.step == 6 and all(torch.isfinite(p).all() for p in one.model.parameters())


def test_no_accum_gather_pretrains(tmp_path):
    """-no_accum_gather: MultiSteps over the pretrain micro-steps (4 of
    them, 2 updates)."""
    state, _, points = train_cli.main(
        ["-dataset", "MOD_TINY", "-synthetic", "-synthetic_samples", "64", "-batch_size", "16",
         "-epochs", "1", "-device", "cpu", "-grad_accum", "2", "-no_accum_gather",
         "-output_dir", str(tmp_path)])
    assert state.step == 4 and state.optimizer.accum == 2
    assert np.isfinite(points[0]["train_loss"]) and np.isfinite(points[0]["val_loss"])
