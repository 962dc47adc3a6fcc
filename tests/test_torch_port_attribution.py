"""The attribution flags of the port's training CLI, -init_weight and the
regression branch of the evaluation, against the JAX package on the CPU.

  * -py_aug_draws: the [epochs, columns, 2] table equals the JAX package's
    exactly for the same seed (its pretraining run to the table, with a
    stand-in init); a forced id selects that augmenter on both views of a
    step, and a forced id equal to the drawn one changes nothing;
  * -ref_lr_timing: lr per epoch equals the JAX package's
    ``lr_epoch(max(e - 1, 0))`` in each stage (1e-5 relative, as
    test_torch_port_train_optim.py holds the schedules: float32 in JAX,
    float64 here);
  * -ragged_tail on the JAX package's case (5 subsequences, per 3, then per
    2): 2 updates an epoch and 4 after two epochs, the tail's update moves
    the parameters, a tail of one subsequence stays dropped; the schedule
    counts the tail's update as the JAX package's does (its steps per epoch
    captured), and -resume counts it too;
  * -init_weight loads parameters and BatchNorm buffers in each stage, and
    finetuning's pretrained backbone wins over it but for the class layer;
  * the regression branch equals the JAX package's ``eval_supervised`` on
    its own case, and the test CLI prints its line;
  * the arms refuse accumulation and a sharded layout with the JAX
    package's words.
"""

import copy
import glob
import importlib
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focal_tpu.params.auto import set_auto_params
from focal_tpu.params.cli import build_parser
from focal_tpu.params.yaml_utils import load_dataset_config as jax_load_dataset_config
from focal_tpu.train import loops as jax_loops
from focal_tpu.train import optim as jax_optim
from focal_tpu.train.state import TrainState
from focal_tpu_torch.data import synthetic_arrays
from focal_tpu_torch.models import build_backbone, init_params
from focal_tpu_torch.ops.augment import build_augmenter
from focal_tpu_torch.params import load_dataset_config, parse_train_params
from focal_tpu_torch.train import checkpoint as ckpt
from focal_tpu_torch.train import evaluate as ev
from focal_tpu_torch.train import loops
from focal_tpu_torch.train.losses import make_focal_loss
from focal_tpu_torch.train.optim import build_optimizer
from focal_tpu_torch.train.state import create_train_state
from focal_tpu_torch.train.steps import make_pretrain_step
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
test_cli = importlib.import_module("focal_tpu_torch.test")


@pytest.fixture(autouse=True)
def _restore_logging():
    """The stage loops log to their run folder's file; each test's
    handlers are closed after it."""
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


def _tiny(tmp_path, *flags, samples=32, batch=12, model="DeepSense"):
    return ["-dataset", "MOD_TINY", "-model", model, "-synthetic", "-synthetic_samples",
            str(samples), "-batch_size", str(batch), "-device", "cpu", "-output_dir",
            str(tmp_path), *flags]


class _Stop(Exception):
    pass


def _jax_pretrain_until_epoch_fn(monkeypatch, tmp_path, argv):
    """Run the JAX package's pretrain(argv) up to its epoch function, with a
    stand-in init (the table and the schedule need no parameters); returns
    (make_pretrain_epoch_fn's keyword arguments, build_optimizer's
    steps_per_epoch)."""
    captured = {}
    real_build = jax_optim.build_optimizer

    def build_spy(args, params, steps_per_epoch, **kw):
        captured["steps_per_epoch"] = steps_per_epoch
        return real_build(args, params, steps_per_epoch, **kw)

    def epoch_fn_spy(*a, **kw):
        captured.update(kw)
        raise _Stop

    monkeypatch.setattr(jax_loops, "init_state", lambda args, model, sample, tx, rng:
                        TrainState.create(apply_fn=None, params={"w": jnp.zeros(1)},
                                          batch_stats={}, tx=tx))
    monkeypatch.setattr(jax_loops, "build_optimizer", build_spy)
    monkeypatch.setattr(jax_loops, "make_pretrain_epoch_fn", epoch_fn_spy)
    args = build_parser().parse_args(argv + ["-compute_dtype", "float32"])
    args.option = "train"
    args.output_dir = str(tmp_path / "jax")
    with pytest.raises(_Stop):
        jax_loops.pretrain(set_auto_params(args))
    return captured


# (synthetic samples, batch): 8 subsequences at per 3 leave a tail of 2; 5
# subsequences at per 2 leave a tail of 1, which -ragged_tail drops (its
# table still has the column, as the JAX package's has)
TAIL_CASES = [(32, 12), (20, 8)]


@pytest.mark.parametrize("ragged", [False, True], ids=["no_tail", "ragged_tail"])
@pytest.mark.parametrize("samples,batch", TAIL_CASES)
def test_py_aug_draws_table_matches_jax(monkeypatch, tmp_path, samples, batch, ragged):
    argv = ["-dataset", "MOD_TINY", "-model", "DeepSense", "-learn_framework", "FOCAL",
            "-stage", "pretrain", "-synthetic", "-synthetic_samples", str(samples),
            "-batch_size", str(batch), "-epochs", "3", "-seed", "5", "-py_aug_draws"]
    argv += ["-ragged_tail"] if ragged else []
    want = _jax_pretrain_until_epoch_fn(monkeypatch, tmp_path, argv)["aug_id_table"]
    args = parse_train_params(argv + ["-device", "cpu"])
    run = loops.Run(args)
    got = loops.aug_id_table(run.train_loader, run.augmenter, 3, args.seed, args.ragged_tail)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("samples,batch,tail", [(32, 12, 1), (20, 8, 0)])
def test_ragged_tail_schedule_counts_the_tail_as_jax(monkeypatch, tmp_path, samples, batch, tail):
    """The lr paces by true epochs: the schedule's steps per epoch count the
    tail's update where the JAX package's do (2 + 1 with a 2-subsequence
    tail; 2 where the 1-subsequence tail is dropped)."""
    argv = ["-dataset", "MOD_TINY", "-model", "DeepSense", "-learn_framework", "FOCAL",
            "-stage", "pretrain", "-synthetic", "-synthetic_samples", str(samples),
            "-batch_size", str(batch), "-epochs", "2", "-ragged_tail"]
    want = _jax_pretrain_until_epoch_fn(monkeypatch, tmp_path, argv)["steps_per_epoch"]
    seen = {}

    def spy(args, model, steps_per_epoch, seed=0, accum_in_step=False):
        seen["spe"] = steps_per_epoch
        state = create_train_state(args, model, steps_per_epoch, seed)
        seen["lr"] = [state.optimizer.lr(k) for k in range(2 * steps_per_epoch)]
        seen["lr_epoch"] = [build_optimizer(args, model, steps_per_epoch)[1](e) for e in (0, 1)]
        raise _Stop

    monkeypatch.setattr(loops, "create_train_state", spy)
    with pytest.raises(_Stop):
        train_cli.main(argv + ["-device", "cpu", "-output_dir", str(tmp_path / "port")])
    assert seen["spe"] == want == 2 + tail
    assert seen["lr"] == [seen["lr_epoch"][k // want] for k in range(2 * want)]


_HEAD = torch.nn.ModuleDict({"class_layer": torch.nn.Linear(2, 2)})  # trained in every stage


@pytest.mark.parametrize("stage", ["pretrain", "finetune", "supervised"])
def test_ref_lr_timing_matches_jax(stage):
    """Epoch e trains at lr(max(e - 1, 0)) in every stage, as the JAX
    package's -ref_lr_timing schedule; without the flag at lr(e)."""
    flags = (["-learn_framework", "no"] if stage == "supervised"
             else ["-learn_framework", "FOCAL", "-stage", stage])
    argv = ["-dataset", "MOD", "-model", "SW_Transformer", "-epochs", "8"] + flags
    lrs = {}
    for timing in ((), ("-ref_lr_timing",)):
        jargs = build_parser().parse_args(argv + list(timing))
        jargs.dataset_config = jax_load_dataset_config("MOD")
        jargs.train_mode = "supervised" if stage == "supervised" else "contrastive"
        _, lrs["jax", timing] = jax_optim.build_optimizer(
            jargs, {"w": jnp.zeros(1)}, steps_per_epoch=4, epochs_override=8)
        _, lrs["port", timing] = build_optimizer(parse_train_params(argv + list(timing)),
                                                 _HEAD, steps_per_epoch=4)
    shifted, plain = ("-ref_lr_timing",), ()
    assert float(lrs["jax", plain](1)) != float(lrs["jax", plain](0))  # the schedule moves
    for e in range(10):
        base = float(lrs["jax", plain](max(e - 1, 0)))
        np.testing.assert_allclose(float(lrs["jax", shifted](e)), base, rtol=1e-5)
        np.testing.assert_allclose(lrs["port", shifted](e), base, rtol=1e-5)
        np.testing.assert_allclose(lrs["port", plain](e), float(lrs["jax", plain](e)), rtol=1e-5)


def test_forced_ids_select_the_augmenter_on_both_views(monkeypatch):
    """A forced id equal to the drawn one is the unforced view bitwise; a
    step's aug_ids (a, b) apply augmenter a on view 1 and b on view 2."""
    args = parse_train_params(["-dataset", "MOD_TINY", "-model", "DeepSense", "-device", "cpu"])
    aug = build_augmenter(args)
    pool = aug.time_aug_names + aug.freq_aug_names
    data, _, _ = synthetic_arrays(args.dataset_config, args.task, 8, seed=1)
    batch = {loc: {m: torch.from_numpy(a) for m, a in mods.items()} for loc, mods in data.items()}
    for s in range(4):
        drawn = int(torch.randint(0, len(pool), (), generator=torch.Generator().manual_seed(s)))
        free = aug.random(torch.Generator().manual_seed(s), batch)
        forced = aug.random(torch.Generator().manual_seed(s), batch, force_aug_id=drawn)
        for m in free["shake"]:
            assert torch.equal(free["shake"][m], forced["shake"][m])
    outs = {aug.random(torch.Generator().manual_seed(3), batch, force_aug_id=i)["shake"][
        "audio"].numpy().tobytes() for i in range(len(pool))}
    assert len(outs) >= 3

    applied = []
    real = type(aug)._apply_one

    def spy(self, name, table, gen, x):
        applied.append(name)
        return real(self, name, table, gen, x)

    monkeypatch.setattr(type(aug), "_apply_one", spy)
    model = init_params(build_backbone(args.dataset_config, "DeepSense", args.task, "FOCAL"))
    state = create_train_state(args, model, steps_per_epoch=1)
    step = make_pretrain_step(model, aug, make_focal_loss(args))
    data_t = {loc: {m: torch.from_numpy(a) for m, a in mods.items()}
              for loc, mods in synthetic_arrays(args.dataset_config, args.task, 16)[0].items()}
    for a, b in ((0, len(pool) - 1), (len(pool) - 1, 1)):
        applied.clear()
        step(state, data_t, torch.arange(8), np.asarray([a, b], np.int32))
        assert applied == [pool[a], pool[b]]


def _state_of(run_dir, pattern):
    (path,) = glob.glob(str(run_dir / "weights" / "*" / "*" / pattern))
    return torch.load(path, map_location="cpu", weights_only=True)


def test_ragged_tail_adds_one_update_an_epoch(tmp_path):
    """The JAX package's case: 5 subsequences at per 3 (batch 12) give 1
    update an epoch, 2 with -ragged_tail (4 after two epochs), and the
    tail's update moves the parameters; at per 2 (batch 8) the tail of one
    subsequence stays dropped (2 updates an epoch either way). -resume
    counts the tail's update: one epoch and a resume equal two epochs."""
    pre = ["-learn_framework", "FOCAL", "-stage", "pretrain", "-val_epochs", "1"]
    runs = {}
    for name, batch, flags in (("drop", 12, []), ("tail", 12, ["-ragged_tail"]),
                               ("one", 8, ["-ragged_tail"])):
        d = tmp_path / name
        st, _, _ = train_cli.main(_tiny(d, *pre, "-epochs", "1", *flags, samples=20, batch=batch))
        runs[name] = (st.step, _state_of(d, "*_pretrain_latest.pt"))
        st2, _, _ = train_cli.main(_tiny(d, *pre, "-epochs", "2", "-resume", *flags, samples=20,
                                         batch=batch))
        runs[name] += (st2.step,)
    assert [runs[k][0] for k in ("drop", "tail", "one")] == [1, 2, 2]
    assert [runs[k][2] for k in ("drop", "tail", "one")] == [2, 4, 4]
    drop, tail = runs["drop"][1], runs["tail"][1]
    assert any(not torch.equal(drop[k], tail[k]) for k in drop)
    straight = tmp_path / "straight"
    st, _, _ = train_cli.main(_tiny(straight, *pre, "-epochs", "2", "-ragged_tail", samples=20))
    assert st.step == 4
    resumed, whole = _state_of(tmp_path / "tail", "*_latest.pt"), _state_of(straight,
                                                                            "*_latest.pt")
    for k in whole:
        torch.testing.assert_close(resumed[k], whole[k], rtol=0, atol=1e-6)


def _perturbed_params_file(path, args, seed):
    """A params file of the run's backbone whose every entry, BatchNorm
    buffers included, differs from the seeded init."""
    model = init_params(build_backbone(args.dataset_config, args.model, args.task,
                                       args.learn_framework), seed=0)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.add_(0.5 + torch.rand(t.shape, generator=gen))
    ckpt.save_params(str(path), model)
    return model.state_dict()


@pytest.mark.parametrize("stage", ["pretrain", "supervised", "finetune"])
def test_init_weight_loads_every_stage(monkeypatch, tmp_path, stage):
    """The model a stage starts training from holds the -init_weight file's
    parameters and BatchNorm statistics; finetuning then loads the
    pretrained backbone over it, all but the class layer."""
    flags = {"pretrain": ["-learn_framework", "FOCAL", "-stage", "pretrain"],
             "supervised": ["-learn_framework", "no"],
             "finetune": ["-learn_framework", "FOCAL", "-stage", "finetune"]}[stage]
    if stage == "finetune":
        train_cli.main(_tiny(tmp_path, "-learn_framework", "FOCAL", "-epochs", "1"))
    args = parse_train_params(_tiny(tmp_path, *flags))
    init = _perturbed_params_file(tmp_path / "init.pt", args, seed=7)
    started = {}

    def spy(args, model, steps_per_epoch, seed=0, accum_in_step=False):
        started.update({k: v.detach().clone() for k, v in model.state_dict().items()})
        raise _Stop

    monkeypatch.setattr(loops, "create_train_state", spy)
    with pytest.raises(_Stop):
        train_cli.main(_tiny(tmp_path, *flags, "-init_weight", str(tmp_path / "init.pt")))
    assert set(started) == set(init) and any(k.endswith(".var") for k in init)
    pretrained = _state_of(tmp_path, "*_pretrain_latest.pt") if stage == "finetune" else {}
    for k, t in started.items():
        want = init[k] if (not pretrained or "class_layer" in k) else pretrained[k]
        assert torch.equal(t, want), k


def test_regression_branch_matches_jax():
    """The JAX package's case (tests/test_coverage_extras.py): two batches
    of three, one padded slot."""
    from types import SimpleNamespace

    from focal_tpu.train.evaluate import eval_supervised as jax_eval_supervised

    preds = np.array([[0.5, 1.0, 2.0], [3.0, 1.0, 0.0]], np.float32)
    labels = np.array([[1.0, 1.0, 2.0], [2.0, 9.0, 0.0]], np.float32)
    weight = np.array([[1.0, 1.0, 1.0], [1.0, 0.0, 1.0]], np.float32)
    plan = SimpleNamespace(device_idx=None, labels=labels, weight=weight)
    args = SimpleNamespace(task="distance_regression")
    want = jax_eval_supervised(args, None, lambda s, d, i: preds, plan, None)
    for logits in (preds, preds[..., None]):  # [nb, B], and the head's [nb, B, 1]
        got = ev.supervised_metrics(args, logits, plan)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        assert len(got[1]) == 1
        np.testing.assert_allclose(got[1][0], want[1][0], rtol=1e-6)
        np.testing.assert_allclose(got[0], (0.25 / 3 + 0.5) / 2, rtol=1e-6)


def test_regression_task_through_the_test_cli(tmp_path, capsys):
    """The test CLI on a regression task (a MOD_TINY copy whose task has
    one output) prints the JAX package's regression line."""
    cfg = copy.deepcopy(load_dataset_config("MOD_TINY"))
    cfg["distance_regression"] = {"num_classes": 1}
    args = parse_train_params(_tiny(tmp_path, "-learn_framework", "no", "-task",
                                    "distance_regression", "-model_weight", str(tmp_path),
                                    samples=16, batch=8), option="test")
    args.dataset_config = cfg
    model = init_params(build_backbone(cfg, "DeepSense", args.task, "no"))
    ckpt.save_params(str(tmp_path / "MOD_TINY_DeepSense_distance_regression_best.pt"), model)
    loss, mse = test_cli.test(args)
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Test classifier")]
    assert line == [f"Test classifier loss: {loss: .5f}, test mse: {mse: .5f}"]
    assert np.isfinite(loss) and np.isfinite(mse) and mse > 0


@pytest.mark.parametrize("flags", [["-ragged_tail", "-grad_accum", "2"],
                                   ["-py_aug_draws", "-data_layout", "sharded"]])
def test_arms_refuse_accumulation_and_sharding(flags):
    with pytest.raises(ValueError, match="attribution arms for the replicated single-step"):
        parse_train_params(flags)
