"""End to end: a JAX SW_Transformer checkpoint served by the JAX Predictor
and, carried across by params_from_flax, by the port's Predictor on the CPU.

Tolerance 1e-5 on probabilities: logits agree to ~1e-5 (f32, summation
order) and softmax over 7 classes does not amplify that.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from focal_tpu.data.synthetic import synthetic_arrays
from focal_tpu.serve import Predictor as JaxPredictor
from focal_tpu.train import checkpoint as ckpt
from focal_tpu.train.state import init_state
from focal_tpu_torch.serve import Predictor, write_predictions
from focal_tpu_torch.weights import params_from_flax
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from focal_tpu.models import build_backbone
    from focal_tpu.ops import build_augmenter
    from focal_tpu.params.auto import set_auto_params
    from focal_tpu.params.cli import build_parser

    tmp = tmp_path_factory.mktemp("serve_port")
    args = build_parser().parse_args(
        ["-dataset", "MOD_TINY", "-model", "SW_Transformer", "-learn_framework", "no",
         "-synthetic", "-batch_size", "8"]
    )
    args.option = "train"
    args.output_dir = str(tmp)
    args = set_auto_params(args)
    model = build_backbone(args)
    augmenter = build_augmenter(args)
    data, labels, names = synthetic_arrays(args.dataset_config, args.task, 20, seed=5)
    sample = jax.jit(augmenter.no)(jax.tree_util.tree_map(lambda a: jax.numpy.asarray(a[:2]), data))
    state = init_state(args, model, sample, optax.identity(), jax.random.key(0))
    # move every parameter off its init so biases and norms carry signal
    rng = np.random.default_rng(9)
    state = state.replace(params=jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=np.shape(a))).astype(np.float32),
        state.params))
    path = os.path.join(str(tmp), "ckpt_best")
    ckpt.save_state(path, state)
    jax_probs = JaxPredictor(args, checkpoint=path).predict(data)["probs"]

    saved = jax.tree_util.tree_map(np.asarray, ckpt.restore(path))
    sd = params_from_flax(saved["params"], saved.get("batch_stats", {}), args.dataset_config)
    predictor = Predictor(args.dataset_config, "SW_Transformer", args.task, sd,
                          batch_size=8, device="cpu")
    return args, predictor, jax_probs, sd, (data, labels, names), tmp


def test_port_predictor_matches_jax_predictor(served):
    args, predictor, jax_probs, _, (data, _, names), _ = served
    result = predictor.predict(data)
    assert result["probs"].shape == (len(names), 7)
    np.testing.assert_allclose(result["probs"], jax_probs, atol=1e-5)
    np.testing.assert_allclose(result["probs"].sum(-1), 1.0, rtol=1e-5)
    lat = result["latency"]
    assert lat["batches"] == 3 and lat["batch_size"] == 8 and lat["windows_per_s"] > 0
    assert set(lat) == {"batch_size", "batches", "mean_s", "p50_s", "p99_s",
                        "windows_per_s", "compile_s"}


def test_ragged_tail_padding_is_inert(served):
    _, predictor, _, _, (data, _, _), _ = served
    full = predictor.predict(data)  # 20 = 2 full batches + ragged 4
    tail = {loc: {m: a[16:] for m, a in mods.items()} for loc, mods in data.items()}
    alone = predictor.predict(tail)
    np.testing.assert_allclose(full["probs"][16:], alone["probs"], rtol=1e-5, atol=1e-7)


def test_state_dict_file_and_cli(served, tmp_path):
    """A saved state_dict serves the same probabilities through the CLI."""
    args, predictor, _, sd, (data, labels, names), _ = served
    pt = tmp_path / "model.pt"
    torch.save(sd, pt)
    again = Predictor(args.dataset_config, "SW_Transformer", args.task, str(pt),
                      batch_size=8, device="cpu").predict(data)
    np.testing.assert_array_equal(again["probs"], predictor.predict(data)["probs"])
    out = tmp_path / "preds.json"
    write_predictions(str(out), names, again, labels)
    assert out.exists()

    cli_out = tmp_path / "cli.json"
    proc = subprocess.run(
        [sys.executable, "-m", "focal_tpu_torch.predict", "-dataset", "MOD_TINY",
         "-model", "SW_Transformer", "-learn_framework", "no", "-synthetic",
         "-synthetic_samples", "12", "-batch_size", "8", "-model_weight", str(pt),
         "-device", "cpu", "-predictions_out", str(cli_out)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "windows/s" in proc.stdout and cli_out.exists()
