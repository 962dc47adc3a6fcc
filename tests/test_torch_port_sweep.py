"""The port's label-ratio sweep (``python -m focal_tpu_torch.sweep``) in
process on the CPU: MOD_TINY, -synthetic -synthetic_samples 64
-batch_size 16 -epochs 1, two ratios, supervised and finetuned (after a
one-epoch pretrain). Its JSON rows and printed table equal what the JAX
package's root sweep.py writes and prints for the same accuracies (that
script run with its stages stubbed to return them)."""

import importlib.util
import json
import logging
import os
import sys

import pytest

from focal_tpu.train import loops as jax_loops
from focal_tpu.utils import cache as jax_cache
from focal_tpu_torch import sweep
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _jax_sweep(monkeypatch, tmp_path, argv, accuracies):
    """The JAX package's sweep.py main() on argv, its stages stubbed to
    return ``accuracies`` in order -> (JSON rows, stdout lines)."""
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location("jax_root_sweep", os.path.join(REPO, "sweep.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    left = list(accuracies)
    stub = lambda args: (None, left.pop(0))  # noqa: E731
    monkeypatch.setattr(jax_loops, "supervised_train", stub)
    monkeypatch.setattr(jax_loops, "finetune", stub)
    monkeypatch.setattr(sys, "argv", ["sweep.py", *argv])
    module.main()
    with open(argv[argv.index("-out") + 1]) as f:
        return json.load(f)


@pytest.mark.parametrize("framework", ["no", "FOCAL"])
def test_sweep_rows_and_table_match_jax(monkeypatch, tmp_path, capsys, framework):
    common = ["-model", "DeepSense", "-dataset", "MOD_TINY", "-learn_framework", framework,
              "-synthetic", "-synthetic_samples", "64", "-batch_size", "16", "-epochs", "1",
              "-ratios", "0.5,1.0", "-output_dir", str(tmp_path)]
    if framework == "FOCAL":
        train_cli.main(common[:-4] + ["-stage", "pretrain", "-device", "cpu", "-output_dir",
                                      str(tmp_path)])
        common += ["-stage", "finetune"]
    rows = sweep.main(common + ["-device", "cpu", "-out", str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == rows
    assert [r["label_ratio"] for r in rows] == [0.5, 1.0]
    assert all(set(r) == {"task", "label_ratio", "best_val_acc"} for r in rows)
    assert all(r["task"] == "vehicle_classification" and 0.0 <= r["best_val_acc"] <= 1.0
               for r in rows)

    jax_rows = _jax_sweep(monkeypatch, tmp_path, common + ["-out", str(tmp_path / "jax.json")],
                          [r["best_val_acc"] for r in rows])
    jax_out = capsys.readouterr().out
    assert jax_rows == rows
    table = lambda out: [ln for ln in out.splitlines()  # noqa: E731
                         if ln.startswith(("task", "vehicle_classification"))]
    assert table(port_out) == table(jax_out)
    assert "best val acc" in table(port_out)[0]
