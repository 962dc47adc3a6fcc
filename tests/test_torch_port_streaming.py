"""Host->device streaming of the train split (``focal_tpu_torch.streaming``)
on the CPU.

  * a run whose train split exceeds -hbm_budget_gb streams it in blocks of
    -stream_block_steps steps and computes bit for bit what the resident
    run computes: the same losses and metrics at every validation point
    and the same parameters, in pretraining (whose KNN features come from
    the streamed split) and in supervised training, with and without
    -grad_accum 2 (GradCache micro-batches that straddle two blocks among
    them), and under -model_parallel 2, each rank streaming the whole
    batch;
  * ``BlockStream.feed`` hands each step its rows, in order, in blocks of
    K steps and a shorter last one;
  * the budget: -hbm_budget_gb in GiB, else 8 GiB off the card.
"""

import importlib
import logging

import numpy as np
import pytest
import torch

from focal_tpu_torch import streaming
from focal_tpu_torch.params import parse_train_params
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")

COMMON = ["-dataset", "MOD_TINY", "-synthetic", "-synthetic_samples", "64", "-batch_size", "16",
          "-epochs", "1", "-device", "cpu"]
STREAM = ["-hbm_budget_gb", "1e-9", "-stream_block_steps", "3"]
CASES = {
    "pretrain": ["-model", "SW_Transformer"],
    "pretrain_gradcache": ["-model", "SW_Transformer", "-grad_accum", "2"],
    "supervised": ["-model", "DeepSense", "-learn_framework", "no"],
    "supervised_multisteps": ["-model", "DeepSense", "-learn_framework", "no", "-grad_accum", "2"],
}


@pytest.fixture(scope="module", autouse=True)
def _root_logger_restored():
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


def _latest(out):
    (path,) = (out / "weights").rglob("*_latest.pt")
    return torch.load(path, weights_only=True)


@pytest.mark.parametrize("case", list(CASES))
def test_streamed_run_equals_the_resident_run(case, tmp_path, monkeypatch):
    starts = []
    start = streaming.BlockStream.start
    monkeypatch.setattr(streaming.BlockStream, "start",
                        lambda self, rows: starts.append(len(rows)) or start(self, rows))
    flags = COMMON + CASES[case]
    resident, _, want = train_cli.main(flags + ["-output_dir", str(tmp_path / "resident")])
    assert not starts
    streamed, _, got = train_cli.main(flags + STREAM + ["-output_dir", str(tmp_path / "streamed")])
    assert got == want and streamed.step == resident.step
    # 4 steps of 16 rows: blocks of 3 steps and 1; pretraining's KNN plan
    # streams its 4 batches of the train split the same way
    blocks = [48, 16] * (2 if case.startswith("pretrain") else 1)
    assert starts == blocks
    a, b = _latest(tmp_path / "resident"), _latest(tmp_path / "streamed")
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_feed_hands_out_each_steps_rows():
    data = {"loc": {"mod": np.arange(40, dtype=np.float32).reshape(20, 2)}}
    labels = np.arange(20) % 3
    stream = streaming.BlockStream(data, labels, "cpu", block_steps=2)
    steps = torch.randperm(20, generator=torch.Generator().manual_seed(0))[:15].view(5, 3)
    fed = list(stream.feed(steps))
    assert len(fed) == 5 and len({id(block) for block, _, _ in fed}) == 3
    for (block, block_labels, idx), rows in zip(fed, steps):
        np.testing.assert_array_equal(block["loc"]["mod"][idx].numpy(), data["loc"]["mod"][rows])
        np.testing.assert_array_equal(block_labels[idx].numpy(), labels[rows.numpy()])
    assert fed[0][0] is fed[1][0] and fed[1][0] is not fed[2][0]


def test_budget_in_gib_or_eight_off_the_card():
    args = parse_train_params(["-device", "cpu", "-hbm_budget_gb", "0.5"])
    assert streaming.device_budget_bytes(args, torch.device("cpu")) == 1 << 29
    args.hbm_budget_gb = 0
    assert streaming.device_budget_bytes(args, torch.device("cpu")) == 8 << 30


def test_streaming_composes_with_tensor_parallelism(tmp_path):
    """-model_parallel 2 on two processes, each streaming the whole batch:
    the same validation log and parameters as the resident mp 2 run."""
    from test_torch_port_distributed import COMMON as DIST, _run

    for name, extra in (("resident", []), ("streamed", STREAM)):
        _run("focal_tpu_torch.train", DIST + ["-epochs", "1", "-model_parallel", "2",
                                              "-output_dir", str(tmp_path / name)] + extra,
             world=2)
    logs = {}
    for name in ("resident", "streamed"):
        (log,) = (tmp_path / name / "weights").rglob("pretrain_log.txt")
        logs[name] = [ln.split("(")[0] for ln in log.read_text().splitlines()
                      if ("loss" in ln or "acc" in ln) and "total time" not in ln]
    assert logs["resident"] == logs["streamed"] and logs["resident"]
    assert "(streamed)" in (next((tmp_path / "streamed" / "weights").rglob("pretrain_log.txt"))
                            .read_text())
    a, b = _latest(tmp_path / "resident"), _latest(tmp_path / "streamed")
    for name in a:
        assert torch.equal(a[name], b[name]), name
