"""DeepSense at ``-compute_dtype bfloat16`` against the JAX package's
``dtype=jnp.bfloat16`` on the CPU, and its entry points.

MOD_TINY, the same numpy inputs and parameters on both sides (flax's bf16
init, perturbed so that no bias, BatchNorm affine or running statistic sits
at its init value, carried into the port by ``params_from_flax`` with its
``batch_stats``: the parameters stay f32 in both packages).

  * The forwards are held against the JAX model applied op by op (no
    ``jit``), where every bf16 op rounds on its own as the port's do: the
    eval forward's class logits (f32), projections (bf16) and GRU features
    (f32), and the rate-0 training forward (the batch's BatchNorm
    statistics) unfused and with the fused conv tower (JAX:
    ``use_pallas=True``, its Pallas kernels in interpret mode; the port:
    the tower's bf16 plain version), outputs and the updated running
    statistics. The eval forward to one bf16 step (2^-8) of max|y|
    (measured: <= 2^-9); the training forward to four (2^-6; measured <=
    2.6 steps in a projection), as its BatchNorms take the batch's mean and
    variance as f32 sums in another order than flax's, so that a
    normalised value can round one bf16 step apart and the later layers
    carry it; the running statistics 1e-4 relative (measured <= 1.5e-5).
  * Rate-0 pretrain and supervised steps (batch 8, every augmenter "no") are
    held against the JAX package's jitted bf16 steps, with the gates of
    ``test_torch_port_bf16_step.py``: the loss within 1e-2 relative, each
    parameter's gradient at a cosine of at least 0.9 to JAX's and the
    median over the parameters of ||g - g_jax|| / ||g_jax|| within 5e-2.
    The conv biases before a BatchNorm are left out of those gates: their
    true gradient is 0, so both sides give only rounding noise, JAX's (its
    bf16 sums) up to 9.4e-2 of the same conv kernel's gradient; the port's
    is held to at most 1e-2 of it (measured <= 1.2e-3). Parameters,
    gradients and the AdamW state are f32.
  * The training CLI (FOCAL pretrain with and without ``-pallas_conv``,
    finetune, supervised), the test CLI, the predict CLI and the sweep run
    DeepSense at bf16 on the CPU: finite numbers, f32 checkpoints.
"""

import copy
import importlib
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from focal_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from focal_tpu.models import build_backbone as jax_build_backbone
from focal_tpu.models.deepsense import DeepSense as FlaxDeepSense
from focal_tpu.ops import build_augmenter as jax_build_augmenter
from focal_tpu.params.auto import set_auto_params
from focal_tpu.params.cli import build_parser
from focal_tpu.params.yaml_utils import load_dataset_config as jax_load_config
from focal_tpu.train import optim as jo
from focal_tpu.train.losses import make_focal_loss as jax_make_focal_loss
from focal_tpu.train.state import init_state
from focal_tpu.train.steps import make_pretrain_step as jax_make_pretrain_step
from focal_tpu.train.steps import make_supervised_train_step as jax_make_supervised_step
from focal_tpu_torch import predict, sweep
from focal_tpu_torch import test as test_cli
from focal_tpu_torch.data import synthetic_arrays, to_device
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.models import layers as port_layers
from focal_tpu_torch.ops.augment import build_augmenter
from focal_tpu_torch.params import load_dataset_config, parse_train_params
from focal_tpu_torch.train.losses import make_focal_loss
from focal_tpu_torch.train.state import create_train_state
from focal_tpu_torch.train.steps import make_pretrain_step, make_supervised_train_step
from focal_tpu_torch.weights import params_from_flax
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")

TASK = "vehicle_classification"
BATCH = 8
STEPS_PER_EPOCH = 10
FWD_TOL = 2.0**-8
TRAIN_FWD_TOL = 2.0**-6
STATS_TOL = 1e-4
LOSS_TOL = 1e-2
GRAD_MIN_COS = 0.9
GRAD_MEDIAN_TOL = 5e-2
ZERO_GRAD_REL = 1e-2


@pytest.fixture(autouse=True)
def _root_logger_restored():
    """The CLIs point the root logger at their run folder; give the next
    test the logger it had."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


def _rate0(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["DeepSense"]["dropout_ratio"] = 0.0
    return cfg


def _freq_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    loc = cfg["location_names"][0]
    return {loc: {m: rng.normal(size=(b, cfg["loc_mod_in_freq_channels"][loc][m],
                                      cfg["num_segments"], cfg["loc_mod_spectrum_len"][loc][m])
                                ).astype(np.float32)
                  for m in cfg["modality_names"]}}


def _torch(x):
    return {loc: {m: torch.from_numpy(a) for m, a in mods.items()} for loc, mods in x.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def tiny():
    """MOD_TINY at dropout 0: the inputs and flax's bf16 init, perturbed."""
    jcfg = _rate0(jax_load_config("MOD_TINY"))
    x = _freq_batch(jcfg, BATCH, 0)
    flax_model = FlaxDeepSense(dataset_config=jcfg, task=TASK, dtype=jnp.bfloat16)
    v = jax.jit(lambda xx: flax_model.init({"params": jax.random.key(0)}, xx, train=False,
                                           head="both"))(jax.tree_util.tree_map(jnp.asarray, x))
    rng = np.random.default_rng(0)

    def move(path, leaf):
        a = np.asarray(leaf)
        noise = rng.normal(size=a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return jnp.asarray(a * np.exp(0.3 * noise))
        return jnp.asarray(a + 0.1 * noise)

    v = jax.tree_util.tree_map_with_path(move, jax.device_get(v))
    assert all(leaf.dtype == jnp.float32 for leaf in jax.tree_util.tree_leaves(v))
    return jcfg, x, v


def _port(cfg, v, pallas=False):
    net = build_backbone(cfg, "DeepSense", TASK, pallas_conv=pallas, compute_dtype="bfloat16")
    net.load_state_dict(params_from_flax(v["params"], v["batch_stats"], cfg), strict=True)
    return net


def test_bf16_init_carries_across_and_eval_forward_matches_jax(tiny):
    """A flax bf16 init carries into the port (f32 tensors, every name);
    the eval forward's class logits (f32), projections (bf16) and features
    (f32) against the JAX bf16 model applied op by op."""
    jcfg, x, v = tiny
    cfg = _rate0(load_dataset_config("MOD_TINY"))
    net = _port(cfg, v).eval()
    assert all(t.dtype == torch.float32 for t in net.state_dict().values())
    flax_model = FlaxDeepSense(dataset_config=jcfg, task=TASK, dtype=jnp.bfloat16)
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    logits, proj = flax_model.apply(v, jx, train=False, head="both")
    feats = flax_model.apply(v, jx, train=False, head="feat")
    with torch.no_grad():
        p_logits, p_proj = net(_torch(x), head="both")
        p_feats = net(_torch(x), head="feat")
    assert logits.dtype == jnp.float32 and p_logits.dtype == torch.float32
    assert _rel(p_logits.numpy(), logits) <= FWD_TOL
    for want, got, dt in ((proj, p_proj, torch.bfloat16), (feats, p_feats, torch.float32)):
        assert set(got) == set(want)
        for mod in want:
            assert got[mod].dtype == dt and want[mod].dtype == jnp.dtype(str(dt).split(".")[1])
            assert _rel(got[mod].float().numpy(), want[mod].astype(jnp.float32)) <= FWD_TOL


@pytest.mark.parametrize("use_pallas", [False, True], ids=["cudnn", "pallas_conv"])
def test_bf16_train_forward_matches_jax(tiny, use_pallas, monkeypatch):
    """The rate-0 training forward (the batch's statistics) and the updated
    running statistics, unfused and through the fused tower (JAX's Pallas
    kernels in interpret mode, the port's bf16 plain tower)."""
    jcfg, x, v = tiny
    flax_model = FlaxDeepSense(dataset_config=jcfg, task=TASK, dtype=jnp.bfloat16,
                               use_pallas=use_pallas)
    (logits, proj), st = flax_model.apply(v, jax.tree_util.tree_map(jnp.asarray, x), train=True,
                                          head="both", mutable=["batch_stats"])
    calls = []
    real = port_layers.fused_conv_tower
    monkeypatch.setattr(port_layers, "fused_conv_tower",
                        lambda *a, **k: calls.append((a[0].dtype, {m.dtype for m in a[6]}))
                        or real(*a, **k))
    cfg = _rate0(load_dataset_config("MOD_TINY"))
    net = _port(cfg, v, pallas=use_pallas).train()
    with torch.no_grad():
        p_logits, p_proj = net(_torch(x), head="both")
    # one tower a modality, on bf16 rows with f32 masks (the kernels take f32 masks)
    assert calls == ([(torch.bfloat16, {torch.float32})] * 2 if use_pallas else [])
    assert _rel(p_logits.numpy(), logits) <= TRAIN_FWD_TOL
    for mod in proj:
        assert p_proj[mod].dtype == torch.bfloat16
        assert _rel(p_proj[mod].float().numpy(), proj[mod].astype(jnp.float32)) <= TRAIN_FWD_TOL
    want_stats = params_from_flax({}, jax.device_get(st["batch_stats"]), cfg)
    bufs = dict(net.named_buffers())
    assert set(want_stats) == set(bufs)
    for name, want in want_stats.items():
        assert bufs[name].dtype == torch.float32
        assert _rel(bufs[name].numpy(), want.numpy()) <= STATS_TOL, name


def _deterministic(cfg):
    cfg = _rate0(cfg)
    cfg["FOCAL"]["random_augmenters"] = {"time_augmenters": ["no"], "freq_augmenters": ["no"]}
    cfg["DeepSense"]["fixed_augmenters"] = {"time_augmenters": ["no"], "freq_augmenters": ["no"]}
    return cfg


def _capturing(tx):
    """tx that also keeps the gradient it was given in its state."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _argv(stage):
    framework = "FOCAL" if stage == "pretrain" else "no"
    return ["-dataset", "MOD_TINY", "-model", "DeepSense", "-learn_framework", framework,
            "-batch_size", str(BATCH), "-compute_dtype", "bfloat16"]


@pytest.fixture(scope="module", params=["pretrain", "supervised"])
def jax_step(request, tmp_path_factory):
    """The JAX package's jitted bf16 step from its init: (stage, cfg, init
    (params, batch_stats), loss, gradients)."""
    stage = request.param
    args = build_parser().parse_args(_argv(stage) + ["-stage", "pretrain", "-output_dir",
                                                     str(tmp_path_factory.mktemp(stage))])
    args.option = "train"
    args = set_auto_params(args)
    assert args.compute_dtype == "bfloat16"
    args.dataset_config = _deterministic(args.dataset_config)
    net = jax_build_backbone(args)
    augmenter = jax_build_augmenter(args)
    ds = jax_synthetic(args.dataset_config, args.task, 2 * BATCH, seed=0, seq_len=4)
    data = {loc: {m: jnp.asarray(a) for m, a in mods.items()} for loc, mods in ds.data.items()}
    sample = augmenter.no({loc: {m: a[:2] for m, a in mods.items()} for loc, mods in data.items()})
    state = init_state(args, net, sample, optax.identity(), jax.random.key(0))
    tx = _capturing(jo.build_optimizer(args, state.params, steps_per_epoch=STEPS_PER_EPOCH)[0])
    state = state.replace(tx=tx, opt_state=tx.init(state.params))
    init = jax.device_get((state.params, state.batch_stats))
    idx = jnp.arange(BATCH, dtype=jnp.int32)
    if stage == "pretrain":
        step = jax_make_pretrain_step(net, augmenter, jax_make_focal_loss(args))
        new_state, metrics = step(state, data, idx, jax.random.key(1))
    else:
        step = jax_make_supervised_step(net, augmenter)
        new_state, metrics = step(state, data, jnp.asarray(ds.labels), idx, jax.random.key(1))
    return stage, args.dataset_config, init, float(metrics["loss"]), jax.device_get(
        new_state.opt_state[1])


def test_bf16_rate0_step_matches_jax(jax_step):
    stage, cfg, init, loss_jax, g_jax = jax_step
    g_jax = params_from_flax(g_jax, {}, cfg)
    args = parse_train_params(_argv(stage) + ["-device", "cpu"])
    args.dataset_config = cfg
    net = build_backbone(cfg, "DeepSense", TASK, args.learn_framework,
                         compute_dtype=args.compute_dtype)
    net.load_state_dict(params_from_flax(*init, cfg), strict=True)
    state = create_train_state(args, net, steps_per_epoch=STEPS_PER_EPOCH)
    host, labels, _ = synthetic_arrays(cfg, TASK, 2 * BATCH, seed=0)
    data = to_device(host, "cpu")
    if stage == "pretrain":
        step = make_pretrain_step(net, build_augmenter(args), make_focal_loss(args))
        _, metrics = step(state, data, torch.arange(BATCH))
    else:
        step = make_supervised_train_step(net, build_augmenter(args))
        _, metrics = step(state, data, torch.from_numpy(labels).long(), torch.arange(BATCH))
    loss = float(metrics["loss"])
    assert abs(loss - loss_jax) / abs(loss_jax) <= LOSS_TOL
    assert all(p.dtype == torch.float32 for p in net.parameters())
    grads = {n: p.grad for n, p in net.named_parameters() if p.grad is not None}
    assert grads and all(g.dtype == torch.float32 for g in grads.values())
    moments = [t for s in state.optimizer.optimizer.state.values() for t in s.values()
               if torch.is_tensor(t) and t.dim() > 0]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    errs = []
    for name, got in grads.items():
        want = g_jax[name]
        if name.endswith("Conv_0.bias"):  # a BatchNorm follows: true gradient 0
            kernel = grads[name[:-len("bias")] + "weight"]
            assert float(got.abs().max()) <= ZERO_GRAD_REL * float(kernel.abs().max()), name
            continue
        cos = float((got * want).sum() / (got.norm() * want.norm()))
        assert cos >= GRAD_MIN_COS, (name, cos)
        errs.append(float((got - want).norm() / want.norm()))
    assert len(errs) > 30 and float(np.median(errs)) <= GRAD_MEDIAN_TOL


def test_bf16_entry_points_run_deepsense(tmp_path, capsys):
    """The CLIs at MOD_TINY in bf16 on the CPU: FOCAL pretrain (-pallas_conv
    and the default route), finetune, supervised, test on the _best, the
    predict CLI and the sweep; finite numbers and f32 checkpoints."""
    base = ["-dataset", "MOD_TINY", "-model", "DeepSense", "-synthetic", "-synthetic_samples",
            "32", "-batch_size", "8", "-epochs", "1", "-val_epochs", "1", "-device", "cpu",
            "-compute_dtype", "bfloat16"]
    for extra in (["-pallas_conv"], []):
        out = tmp_path / ("pallas" if extra else "cudnn")
        pre = base + ["-learn_framework", "FOCAL", "-output_dir", str(out)] + extra
        _, _, points = train_cli.main(pre)
        assert points and all(np.isfinite(p["train_loss"]) for p in points)
    fin = pre + ["-stage", "finetune"]
    _, _, points = train_cli.main(fin)
    assert all(np.isfinite(p["train_loss"]) for p in points)
    loss, acc, _ = test_cli.main(fin)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    sup = base + ["-learn_framework", "no", "-output_dir", str(tmp_path / "sup")]
    train_cli.main(sup)
    loss, acc, _ = test_cli.main(sup)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    for folder in (tmp_path / "sup" / "weights" / "MOD_TINY_DeepSense").iterdir():
        for f in folder.glob("*_best.pt"):
            saved = torch.load(f, map_location="cpu", weights_only=True)
            assert saved and all(t.dtype == torch.float32 for t in saved.values())
    result = predict.main(["-dataset", "MOD_TINY", "-model", "DeepSense", "-synthetic",
                           "-synthetic_samples", "6", "-batch_size", "4", "-device", "cpu",
                           "-compute_dtype", "bfloat16"])
    assert result["probs"].dtype == np.float32 and np.isfinite(result["probs"]).all()
    out = tmp_path / "sweep.json"
    sweep.main(sup + ["-ratios", "1.0", "-out", str(out)])
    rows = json.loads(out.read_text())
    assert rows and all(np.isfinite(r["best_val_acc"]) for r in rows)
