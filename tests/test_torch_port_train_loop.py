"""The pretrain loop of the port (``python -m focal_tpu_torch.train``) on
the CPU, and its parts against the JAX package.

  * the CLI, in-process, on MOD_TINY (64 synthetic samples, batch 16, two
    epochs, validation every epoch): two validation points with finite
    losses and the _latest, _best and _resume files;
  * two epochs straight equal one epoch and a -resume for the second: the
    same parameters within 1e-6 (the same steps in the same order; only
    the float order of the two processes' runs may differ);
  * the KNN probe's predictions equal ``focal_tpu.ops.knn.JaxKNN``'s and
    scikit-learn's on the same features, exactly;
  * ``eval_task_metrics`` equals the JAX package's (scikit-learn) on the
    same labels and predictions, to 1e-12;
  * split sizes, subsequences, steps per epoch and eval batches equal
    ``focal_tpu.data.loader.create_dataloader``'s, exactly.
"""

import importlib
import logging
import math

import numpy as np
import pytest
import torch

from focal_tpu.data.loader import DeviceDataLoader as JaxDeviceDataLoader
from focal_tpu.data.loader import create_dataloader as jax_create_dataloader
from focal_tpu.ops.knn import JaxKNN
from focal_tpu.params.auto import set_auto_params
from focal_tpu.params.cli import build_parser
from focal_tpu.train.evaluate import eval_task_metrics as jax_eval_task_metrics
from focal_tpu_torch.data import DeviceDataLoader, create_dataloader, load_split
from focal_tpu_torch.ops.knn import KNN
from focal_tpu_torch.params import parse_train_params
from focal_tpu_torch.train.evaluate import eval_task_metrics
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")

TINY = ["-dataset", "MOD_TINY", "-model", "SW_Transformer", "-learn_framework", "FOCAL",
        "-stage", "pretrain", "-synthetic", "-synthetic_samples", "64", "-batch_size", "16",
        "-val_epochs", "1", "-device", "cpu"]


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


def _run(out, *extra):
    return train_cli.main(TINY + ["-output_dir", str(out), *extra])


def _files(out):
    folder = out / "weights" / "MOD_TINY_SW_Transformer"
    (exp,) = [p for p in folder.iterdir() if p.name.startswith("exp")]
    return {kind: exp / f"MOD_TINY_SW_Transformer_pretrain_{kind}.pt"
            for kind in ("latest", "best", "resume")}


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    out = tmp_path_factory.mktemp("straight")
    state, best, points = _run(out, "-epochs", "2")
    return out, state, best, points


def test_cli_pretrains_validates_and_saves(straight):
    out, state, best, points = straight
    assert [p["epoch"] for p in points] == [0, 1]
    for p in points:
        for key in ("train_loss", "val_loss", "test_loss", "val_acc", "val_f1"):
            assert math.isfinite(p[key]), (key, p)
    assert state.step == 2 * 4  # 16 subsequences of 4, 4 a step
    assert best == min(p["val_loss"] for p in points)
    files = _files(out)
    assert all(f.is_file() for f in files.values())
    latest = torch.load(files["latest"], weights_only=True)
    assert set(latest) == set(state.model.state_dict())
    resume = torch.load(files["resume"], weights_only=True)
    assert resume["epoch"] == 1 and resume["step"] == 8 and resume["best"] == best


def test_resume_continues_as_a_straight_run(straight, tmp_path):
    out, state, _, points = straight
    _, _, first = _run(tmp_path, "-epochs", "1")
    resumed_state, best, second = _run(tmp_path, "-epochs", "2", "-resume")
    assert [p["epoch"] for p in first + second] == [0, 1]
    assert resumed_state.step == state.step
    assert best == min(p["val_loss"] for p in points)
    want = torch.load(_files(out)["latest"], weights_only=True)
    got = torch.load(_files(tmp_path)["latest"], weights_only=True)
    for name in want:
        assert float((got[name] - want[name]).abs().max()) <= 1e-6, name


def test_unported_stages_and_flags_raise(tmp_path, caplog):
    """The three stages dispatch (finetune without a pretrained run finds
    no folder); the accumulation, streaming and layout flags (ROADMAP A7.2,
    ported) parse and -grad_accum 2 pretrains, an attribution arm with it
    still raising; a layout of several processes without a rendezvous raises
    naming -dist_num_processes, the layouts that once raised as not ported
    among them (DeepSense and bf16 under -model_parallel, -pallas_mlp and
    -pallas_conv there, which log their flag-off routes, -pallas_conv under
    -data_parallel), so they are planned now; -no_pallas_block and the
    attribution flags (ROADMAP A8), ported, parse."""
    sup = parse_train_params(["-learn_framework", "no", "-pallas_mlp", "-label_ratio", "0.5"])
    assert sup.train_mode == "supervised" and sup.pallas_mlp and sup.batch_size == 256
    assert parse_train_params(["-no_pallas_block"]).no_pallas_block
    assert parse_train_params(["-stage", "finetune"]).batch_size == 128
    with pytest.raises(FileNotFoundError, match="contrastive_FOCAL"):
        train_cli.main(["-stage", "finetune", "-dataset", "MOD_TINY", "-synthetic", "-device",
                        "cpu", "-output_dir", str(tmp_path)])
    accum = parse_train_params(["-grad_accum", "2", "-no_accum_gather", "-hbm_budget_gb", "0.5",
                                "-stream_block_steps", "8"])
    assert (accum.grad_accum, accum.no_accum_gather, accum.hbm_budget_gb,
            accum.stream_block_steps) == (2, True, 0.5, 8)
    assert parse_train_params(["-data_layout", "sharded"]).data_layout == "sharded"
    with pytest.raises(ValueError, match="attribution arms"):
        parse_train_params(["-ragged_tail", "-grad_accum", "2"])
    for flags in (["-model_parallel", "2"], ["-data_parallel", "4"],
                  ["-model_parallel", "2", "-model", "DeepSense"],
                  ["-model_parallel", "2", "-pallas_mlp"],
                  ["-model_parallel", "2", "-model", "DeepSense", "-pallas_conv"],
                  ["-model_parallel", "2", "-compute_dtype", "bfloat16"],
                  ["-data_parallel", "2", "-pallas_conv"]):
        caplog.clear()
        with caplog.at_level("INFO"), pytest.raises(ValueError, match="-dist_num_processes"):
            parse_train_params(flags)
        flag_off = [f for f in ("-pallas_mlp", "-pallas_conv") if f in flags]
        logged = "flag-off routes" in caplog.text
        assert logged == bool(flag_off and "-model_parallel" in flags), (flags, caplog.text)
    for flags, name, value in ((["-ragged_tail"], "ragged_tail", True),
                               (["-py_aug_draws"], "py_aug_draws", True),
                               (["-init_weight", "w.pt"], "init_weight", "w.pt"),
                               (["-ref_lr_timing"], "ref_lr_timing", True)):
        assert getattr(parse_train_params(flags), name) == value
    state, _, _ = train_cli.main(TINY + ["-epochs", "1", "-grad_accum", "2", "-output_dir",
                                         str(tmp_path / "accum")])
    assert state.step == 2  # 4 steps of 16, 2 GradCache updates


@pytest.mark.parametrize("n,d,classes", [(200, 16, 7), (37, 5, 3)])
def test_knn_matches_jax_and_sklearn(n, d, classes):
    from sklearn.neighbors import KNeighborsClassifier

    rng = np.random.default_rng(n)
    fit_x = rng.normal(size=(n, d)).astype(np.float32)
    fit_y = rng.integers(0, classes, size=n)
    query = rng.normal(size=(50, d)).astype(np.float32)
    got = KNN().fit(torch.from_numpy(fit_x), torch.from_numpy(fit_y)).predict(torch.from_numpy(query))
    jax_pred = JaxKNN().fit(fit_x, fit_y).predict(query)
    sk_pred = KNeighborsClassifier(n_neighbors=5).fit(fit_x, fit_y).predict(query)
    np.testing.assert_array_equal(got.numpy(), jax_pred)
    np.testing.assert_array_equal(got.numpy(), sk_pred)


@pytest.mark.parametrize("task", ["vehicle_classification", "distance_classification"])
def test_eval_task_metrics_match_jax(task):
    args = parse_train_params(["-dataset", "MOD", "-task", task])
    rng = np.random.default_rng(4)
    n_cls = args.dataset_config[task]["num_classes"]
    labels = rng.integers(0, n_cls, size=300)
    preds = np.where(rng.random(300) < 0.6, labels, rng.integers(0, n_cls - 1, size=300))
    for lab, pred in ((labels, preds), (labels[:20], preds[:20]), (labels, labels)):
        acc, f1, conf = eval_task_metrics(args, lab, pred)
        jacc, jf1, jconf = jax_eval_task_metrics(args, lab, pred)
        assert abs(acc - jacc) <= 1e-12 and abs(f1 - jf1) <= 1e-12
        np.testing.assert_array_equal(conf, jconf)


@pytest.mark.parametrize("dataset,samples,batch", [
    ("MOD_TINY", 64, 16), ("MOD_TINY", 100, 16), ("MOD_TINY", 36, 64), ("MOD_WIDE", 512, 64),
])
def test_splits_and_batches_match_jax(dataset, samples, batch, tmp_path):
    argv = ["-dataset", dataset, "-model", "SW_Transformer", "-learn_framework", "FOCAL",
            "-stage", "pretrain", "-synthetic", "-synthetic_samples", str(samples),
            "-batch_size", str(batch), "-seed", "3"]
    args = parse_train_params(argv + ["-device", "cpu"])
    jargs = build_parser().parse_args(argv + ["-output_dir", str(tmp_path)])
    jargs.option = "train"
    jargs = set_auto_params(jargs)
    for option in ("train", "val", "test"):
        split = load_split(option, args)
        loader = create_dataloader(option, split, args)
        jloader = jax_create_dataloader(option, jargs)
        jds = jloader.dataset
        assert len(split) == len(jds) and len(loader) == len(jloader), option
        assert loader.batch_size == jloader.batch_size
        np.testing.assert_array_equal(split.labels, jds.labels)
        np.testing.assert_array_equal(split.subseq_idx, jds.subseq_idx)
        plans = list(DeviceDataLoader(split, batch, sequence=True))
        jplans = list(JaxDeviceDataLoader(jds, batch, sequence=True))
        assert len(plans) == len(jplans)
        for p, q in zip(plans, jplans):
            np.testing.assert_array_equal(p.idx, q.idx)
            np.testing.assert_array_equal(p.weight, q.weight)


def test_index_file_split_matches_jax(tmp_path):
    """A split read from sample files through an index file (the recipe's
    pretrain index for pretraining) holds the JAX package's arrays, labels
    and subsequences."""
    from focal_tpu.data.dataset import ArrayDataset
    from focal_tpu.data.synthetic import write_synthetic_sample_files

    args = parse_train_params(["-dataset", "MOD_TINY", "-device", "cpu"])
    files = write_synthetic_sample_files(args.dataset_config, args.task, str(tmp_path), 40, seed=5)
    args.dataset_config = dict(args.dataset_config, pretrain_index_file=files["pretrain"])
    split = load_split("train", args)
    want = ArrayDataset.from_index_file(files["pretrain"], args.task, seq_len=4)
    np.testing.assert_array_equal(split.labels, want.labels)
    np.testing.assert_array_equal(split.subseq_idx, want.subseq_idx)
    for loc, mods in want.data.items():
        for mod, arr in mods.items():
            np.testing.assert_array_equal(split.data[loc][mod], arr)
