"""The port's CLIs over several processes on the CPU (gloo): one process per
rank, started as a user starts them (``python -m focal_tpu_torch.train``
with ``-dist_coordinator``, ``-dist_num_processes`` and
``-dist_process_id``).

  * a MOD_TINY pretrain epoch on two processes at ``-data_parallel 2``
    writes one experiment folder, from rank 0, in the single-process
    format (the single-process port loads its files), and ``-resume`` at
    ``-model_parallel 2`` continues it for a second epoch;
  * a supervised epoch at ``-model_parallel 2`` (its tensor-parallel slices
    gathered whole on save), then ``python -m focal_tpu_torch.test`` on its
    `_best` file in one process and at ``-data_parallel 2`` give the same
    metrics;
  * a process count above 1 without a process id fails fast.
"""

import os
import subprocess
import sys

import pytest
import torch

from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.parallel.distributed import free_port
from focal_tpu_torch.params import load_dataset_config, parse_train_params
from focal_tpu_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["-dataset", "MOD_TINY", "-synthetic", "-synthetic_samples", "64", "-batch_size", "16",
          "-val_epochs", "1", "-device", "cpu"]


def _run(module, argv, world=1, timeout=240):
    """Run ``python -m module argv`` as ``world`` ranks; rank 0's stdout."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("FOCAL_DIST", "LOCAL_"))}
    env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // (2 * world)))
    port = free_port()
    procs = []
    for rank in range(world):
        dist = ([] if world == 1 else ["-dist_coordinator", f"127.0.0.1:{port}",
                                       "-dist_num_processes", str(world),
                                       "-dist_process_id", str(rank)])
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv, *dist], cwd=REPO,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs[0]


def _folders(root, model):
    base = os.path.join(root, "weights", f"MOD_TINY_{model}")
    return sorted(os.listdir(base)), base


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp2"))
    _run("focal_tpu_torch.train", COMMON + ["-epochs", "1", "-output_dir", out,
                                            "-data_parallel", "2"], world=2)
    return out


def test_dp2_pretrain_writes_one_single_process_tree(pretrained):
    names, base = _folders(pretrained, "SW_Transformer")
    assert names == ["exp0_contrastive_FOCAL"], names
    folder = os.path.join(base, names[0])
    files = sorted(os.listdir(folder))
    for kind in ("best", "latest", "resume"):
        assert f"MOD_TINY_SW_Transformer_pretrain_{kind}.pt" in files, files
    assert "pretrain_log.txt" in files
    model = build_backbone(load_dataset_config("MOD_TINY"), "SW_Transformer",
                           "vehicle_classification", "FOCAL")
    latest = os.path.join(folder, "MOD_TINY_SW_Transformer_pretrain_latest.pt")
    ckpt.load_params_into(model, latest)  # the single-process shapes, every entry
    assert set(torch.load(latest, weights_only=True)) == set(model.state_dict())
    resume = torch.load(os.path.join(folder, "MOD_TINY_SW_Transformer_pretrain_resume.pt"),
                        weights_only=True)
    assert resume["epoch"] == 0 and resume["step"] > 0


def test_resume_at_model_parallel_continues_the_run(pretrained):
    names, base = _folders(pretrained, "SW_Transformer")
    path = os.path.join(base, names[0], "MOD_TINY_SW_Transformer_pretrain_resume.pt")
    steps = torch.load(path, weights_only=True)["step"]
    _run("focal_tpu_torch.train", COMMON + ["-epochs", "2", "-output_dir", pretrained,
                                            "-resume", "-model_parallel", "2"], world=2)
    assert _folders(pretrained, "SW_Transformer")[0] == names
    resume = torch.load(path, weights_only=True)
    assert resume["epoch"] == 1 and resume["step"] == 2 * steps
    moments = [s["exp_avg"] for s in resume["optimizer"]["state"].values()]
    model = build_backbone(load_dataset_config("MOD_TINY"), "SW_Transformer",
                           "vehicle_classification", "FOCAL")
    shapes = {tuple(p.shape) for p in model.parameters()}
    assert moments and all(tuple(m.shape) in shapes for m in moments)
    with open(os.path.join(base, names[0], "pretrain_log.txt")) as f:
        log = f.read()
    assert "epoch 0" in log and "epoch 1" in log and "Mesh: 1 (data) x 2 (model)" in log


def test_supervised_at_model_parallel_then_test_cli(tmp_path):
    out = str(tmp_path)
    sup = COMMON + ["-learn_framework", "no", "-output_dir", out]
    _run("focal_tpu_torch.train", sup + ["-epochs", "1", "-model_parallel", "2"], world=2)
    names, _ = _folders(out, "SW_Transformer")
    assert names == ["exp0_supervised_vehicle_classification_1.0"], names
    single = _run("focal_tpu_torch.test", sup)
    dp2 = _run("focal_tpu_torch.test", sup + ["-data_parallel", "2"], world=2)
    lines = [ln for ln in single.splitlines() if ln.startswith(("Test classifier loss",
                                                               "Test acc"))]
    assert len(lines) == 2 and lines == [ln for ln in dp2.splitlines()
                                         if ln.startswith(("Test classifier loss", "Test acc"))]


def test_missing_process_id_fails_fast():
    with pytest.raises(ValueError, match="-dist_process_id"):
        parse_train_params(["-dataset", "MOD_TINY", "-device", "cpu", "-dist_coordinator",
                            "127.0.0.1:1", "-dist_num_processes", "2"])
