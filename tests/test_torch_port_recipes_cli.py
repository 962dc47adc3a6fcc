"""The port's entry points on the JAX package's ACIDS, PAMAP2 and
RealWorld_HAR recipes, in-process on the CPU (``-synthetic -device cpu``,
32 samples, batch 8, one epoch), at the recipes' full widths:

  * DeepSense with ``-pallas_conv``: FOCAL pretraining, finetuning, then the
    test CLI on the finetuned ``_best`` file; the pretrain steps train every
    conv block through the conv tower (its plain version on the CPU) at
    the recipe's geometry (cin 2 and S 41 after ACIDS's external first
    conv, cin 6 and S 20 or 25 at PAMAP2 and RealWorld_HAR);
  * SW_Transformer: supervised training with ``-pallas_mlp`` (ACIDS),
    ``-no_pallas_block`` (PAMAP2) or both (RealWorld_HAR), the test CLI and
    serving (``python -m focal_tpu_torch.predict``) on its ``_best`` file
    with the same flags.

Each run reports finite losses and metrics, writes its checkpoints, and
serves probabilities over the recipe's classes that sum to 1 (1e-5).
"""

import importlib
import logging

import numpy as np
import pytest

from focal_tpu_torch import params as port_params
from focal_tpu_torch import predict as predict_cli
from focal_tpu_torch import test as test_cli
from focal_tpu_torch.models import layers
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")

SW_FLAGS = {"ACIDS": ["-pallas_mlp"], "PAMAP2": ["-no_pallas_block"],
            "RealWorld_HAR": ["-pallas_mlp", "-no_pallas_block"]}


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


def _common(recipe, model, tmp_path):
    return ["-dataset", recipe, "-model", model, "-synthetic", "-synthetic_samples", "32",
            "-batch_size", "8", "-epochs", "1", "-val_epochs", "1", "-device", "cpu",
            "-output_dir", str(tmp_path)]


def _num_classes(recipe):
    cfg = port_params.load_dataset_config(recipe)
    return cfg[port_params.DATASET_DEFAULT_TASK[recipe]]["num_classes"]


@pytest.mark.parametrize("recipe", ["ACIDS", "PAMAP2", "RealWorld_HAR"])
def test_deepsense_pretrain_finetune_test_with_pallas_conv(recipe, tmp_path, monkeypatch):
    towers = []
    real = layers.fused_conv_tower

    def spy(x0, cfgs, *args, **kw):
        towers.append((cfgs[0][1], x0.shape[1]))  # the first conv's input channels, S
        return real(x0, cfgs, *args, **kw)

    monkeypatch.setattr(layers, "fused_conv_tower", spy)
    argv = _common(recipe, "DeepSense", tmp_path) + ["-pallas_conv", "-learn_framework", "FOCAL"]
    state, _, points = train_cli.main(argv)
    assert state.step > 0 and len(points) == 1
    assert np.isfinite([v for k, v in points[0].items() if k.endswith("loss")]).all()
    n_mod = len(port_params.load_dataset_config(recipe)["modality_names"])
    assert len(towers) == state.step * n_mod  # one tower a modality and step
    # ACIDS: the strided [1, 5] first conv runs outside the tower, which takes S 41
    assert set(towers) == {{"ACIDS": (2, 41), "PAMAP2": (6, 20), "RealWorld_HAR": (6, 25)}[recipe]}
    _, _, points = train_cli.main(argv + ["-stage", "finetune"])
    assert len(points) == 1 and np.isfinite(points[0]["test_loss"])
    loss, acc, f1 = test_cli.main(argv + ["-stage", "finetune"])
    assert np.isfinite([loss, acc, f1]).all() and 0.0 <= acc <= 1.0


@pytest.mark.parametrize("recipe", ["ACIDS", "PAMAP2", "RealWorld_HAR"])
def test_sw_transformer_supervised_test_and_serving(recipe, tmp_path):
    flags = SW_FLAGS[recipe]
    argv = _common(recipe, "SW_Transformer", tmp_path) + ["-learn_framework", "no"] + flags
    state, _, points = train_cli.main(argv)
    assert state.step > 0 and len(points) == 1 and np.isfinite(points[0]["test_loss"])
    loss, acc, f1 = test_cli.main(argv)
    assert np.isfinite([loss, acc, f1]).all() and 0.0 <= acc <= 1.0
    task = port_params.DATASET_DEFAULT_TASK[recipe]
    best = sorted((tmp_path / "weights").rglob(f"*_{task}_best.pt"))
    assert len(best) == 1
    result = predict_cli.main(["-dataset", recipe, "-synthetic", "-synthetic_samples", "12",
                               "-batch_size", "8", "-model_weight", str(best[0]), "-device",
                               "cpu"] + flags)
    assert result["probs"].shape == (12, _num_classes(recipe))
    np.testing.assert_allclose(result["probs"].sum(-1), 1.0, atol=1e-5)
