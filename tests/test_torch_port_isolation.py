"""The port stands alone: importing it (its offline data tools included)
loads neither JAX nor the JAX package (nor scikit-learn, which the card's
machine lacks), importing its training CLI runs nothing, and its entry
points refuse to carry on on the CPU unless asked."""

import json
import os
import subprocess
import sys

import pytest
import torch

from focal_tpu_torch.params import load_dataset_config
from focal_tpu_torch.serve import Predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import focal_tpu_torch
names = [m.name for m in pkgutil.walk_packages(focal_tpu_torch.__path__, "focal_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
       or m == "flax" or m.startswith("flax.")
       or m == "focal_tpu" or m.startswith("focal_tpu.")
       or m == "sklearn" or m.startswith("sklearn.")]
print(json.dumps({"modules": names, "bad": sorted(bad)}))
"""


def test_port_imports_no_jax_and_no_focal_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    probe = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "focal_tpu_torch.serve" in probe["modules"], probe  # submodules were walked
    assert "focal_tpu_torch.train.__main__" in probe["modules"], probe  # imported, ran nothing
    for name in ("distributed", "mesh", "tp"):  # the multi-process modules are walked too
        assert f"focal_tpu_torch.parallel.{name}" in probe["modules"], probe
    for name in ("preprocess.mod", "preprocess.mod_tables", "preprocess.partition",
                 "preprocess.signal", "native"):  # and the offline data tools
        assert f"focal_tpu_torch.{name}" in probe["modules"], probe
    assert probe["bad"] == [], f"port pulled in: {probe['bad']}"


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_dataset_config("MOD_TINY")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, "SW_Transformer", "vehicle_classification")


def test_training_cli_defaults_to_the_card(monkeypatch, tmp_path):
    """python -m focal_tpu_torch.train without -device raises with no card."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli = importlib.import_module("focal_tpu_torch.train.__main__")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-dataset", "MOD_TINY", "-synthetic", "-output_dir", str(tmp_path)])


def test_kernel_input_validator():
    """The validator the CUDA path runs before any launch: a float64,
    mis-shaped or non-contiguous tensor raises rather than reaching the
    kernel (tests/test_torch_port_gpu.py checks the wrapper itself on the
    card)."""
    from focal_tpu_torch.ops.pallas_kernels import _check

    x = torch.zeros(2, 9, 8)
    with pytest.raises(TypeError):
        _check("x", x.double(), (2, 9, 8), x.device)
    with pytest.raises(ValueError):
        _check("x", x, (2, 9, 16), x.device)
    with pytest.raises(ValueError):
        _check("x", x.transpose(0, 1), (9, 2, 8), x.device)


def test_recipe_comes_from_the_package_only(tmp_path, monkeypatch):
    """A data/MOD.yaml in the working directory does not replace the
    packaged full-width recipe; an unknown name raises."""
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "MOD.yaml").write_text("time_freq_out_channels: 8\n")
    monkeypatch.chdir(tmp_path)
    cfg = load_dataset_config("MOD")
    assert cfg["SW_Transformer"]["time_freq_out_channels"] == 64
    with pytest.raises(FileNotFoundError, match="MOD_TINY"):
        load_dataset_config("NO_SUCH_DATASET")
