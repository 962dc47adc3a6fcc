"""The JAX CLI's last flags in the port, and the train loss of its epoch
blocks.

  * the block schedule (``loops._block_size``, ``loops._next_block``) equals
    the JAX package's on a grid of flags, val intervals, epochs and run
    lengths, exactly;
  * pretraining and the supervised stage on MOD_TINY with -val_epochs 2 over
    10 epochs (auto: blocks of 2), over 5 with -epochs_per_call 3 (blocks
    of 2, the cap) and with -profile_dir (epoch 1 a traced block of its
    own): each validation point's train loss (and the classifier's train
    accuracy) is the mean of the epoch means of the block that ends there,
    the blocks taken from the JAX package's loop logic run on its own
    functions; the epoch means are recorded from the steps the loop takes,
    so the check is exact. The trace is one epoch's, and the only one;
  * -knn_backend: both names run the probe, another is refused;
  * -gpu in the train, test and predict parsers: cuda:N, ignored with
    -device cpu, refused with several processes, an index past the cards
    refused by select_device;
  * -dataset_config in all three parsers resolves as the JAX package's
    ``resolve_dataset_yaml`` (the explicit path, ./data/{dataset}.yaml in
    the working directory, the packaged recipe);
  * -prng_impl is refused by name;
  * the parser diff: every flag of the JAX CLI's parser is in the port's
    training parser, or (-input, -predictions_out) in its serving parser.
"""

import argparse
import importlib
import json
import logging
import os
from types import SimpleNamespace

import pytest
import torch

from focal_tpu.train import loops as jax_loops
from focal_tpu_torch.train import loops
from torch_port_threads import one_torch_thread  # noqa: F401

train_cli = importlib.import_module("focal_tpu_torch.train.__main__")

TINY = ["-dataset", "MOD_TINY", "-model", "SW_Transformer", "-synthetic",
        "-synthetic_samples", "32", "-batch_size", "16", "-device", "cpu"]
STAGES = {"pretrain": ["-learn_framework", "FOCAL", "-stage", "pretrain"],
          "supervised": ["-learn_framework", "no"]}


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


def test_block_schedule_equals_the_jax_package():
    for override in range(0, 8):
        args = argparse.Namespace(epochs_per_call=override)
        for val_epochs in range(1, 13):
            for remaining in range(0, 71):
                assert (loops._block_size(args, val_epochs, remaining)
                        == jax_loops._block_size(args, val_epochs, remaining)), (
                    override, val_epochs, remaining)
    for k in range(1, 13):
        for val_epochs in range(1, 13):
            for train_epochs in range(1, 46):
                for epoch in range(train_epochs):
                    assert (loops._next_block(epoch, k, val_epochs, train_epochs)
                            == jax_loops._next_block(epoch, k, val_epochs, train_epochs)), (
                        epoch, k, val_epochs, train_epochs)


def jax_blocks(epochs_per_call, val_epochs, train_epochs, start_epoch=0, profile=False):
    """{validation epoch: the epochs of the block that ends there}, by the
    JAX package's loop (train/loops.py's block walk, its profiled epoch a
    block of one) on its own ``_block_size``/``_next_block``."""
    k = jax_loops._block_size(SimpleNamespace(epochs_per_call=epochs_per_call), val_epochs,
                              train_epochs - start_epoch)
    out, epoch, profiled = {}, start_epoch, False
    while epoch < train_epochs:
        blk = jax_loops._next_block(epoch, k, val_epochs, train_epochs)
        if profile and not profiled and epoch > start_epoch:
            blk, profiled = 1, True
        block = list(range(epoch, epoch + blk))
        epoch += blk
        if (epoch - 1) % val_epochs == 0 or epoch == train_epochs:
            out[epoch - 1] = block
    return out


def record_steps(monkeypatch):
    """{epoch: [the metrics of each step the loop took in it]}, filled as
    the loops run."""
    seen, current = {}, []
    epoch_steps = loops.Run.epoch_steps

    def recording_epoch_steps(self, epoch):
        seen[epoch] = []
        current[:] = [epoch]
        return epoch_steps(self, epoch)

    monkeypatch.setattr(loops.Run, "epoch_steps", recording_epoch_steps)
    for name in ("make_pretrain_step", "make_supervised_train_step"):
        def make(*a, _make=getattr(loops, name), **kw):
            step = _make(*a, **kw)

            def recorded(*sa, **skw):
                out = step(*sa, **skw)
                seen[current[0]].append(out[1])
                return out

            return recorded

        monkeypatch.setattr(loops, name, make)
    return seen


def block_mean(seen, block, key):
    """The mean of the block's epoch means, as the loop forms it."""
    return float(torch.stack([torch.stack([m[key] for m in seen[e]]).mean()
                              for e in block]).mean())


@pytest.mark.parametrize("epochs_per_call, epochs, profile", [
    pytest.param(0, 10, False, id="auto"),
    pytest.param(3, 5, False, id="epochs_per_call"),
    pytest.param(2, 5, True, id="profile_dir"),
])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_train_loss_is_the_mean_of_its_block(stage, epochs_per_call, epochs, profile, tmp_path,
                                             monkeypatch):
    seen = record_steps(monkeypatch)
    trace_dir = tmp_path / "trace"
    flags = ["-epochs_per_call", str(epochs_per_call)] + (
        ["-profile_dir", str(trace_dir)] if profile else [])
    if stage == "pretrain" and epochs_per_call:
        flags += ["-knn_backend", "jnp"]
    _, _, points = train_cli.main(TINY + STAGES[stage] + flags + [
        "-val_epochs", "2", "-epochs", str(epochs), "-output_dir", str(tmp_path / "run")])
    want = jax_blocks(epochs_per_call, 2, epochs, profile=profile)
    assert [p["epoch"] for p in points] == sorted(want)
    assert sorted(seen) == list(range(epochs))
    assert any(len(b) > 1 for b in want.values())  # blocks of several epochs were taken
    if profile:
        assert want[2] == [2]  # the traced epoch 1 shifted the blocks
        (trace,) = trace_dir.iterdir()
        assert trace.name == f"{stage}_epoch1.pt.trace.json"
        events = json.loads(trace.read_text())["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)
    keys = ("loss", "acc") if stage == "supervised" else ("loss",)
    for p in points:
        for key in keys:
            assert p[f"train_{key}"] == block_mean(seen, want[p["epoch"]], key), (p, key)


def test_knn_backend_names():
    from focal_tpu_torch.params import parse_train_params

    for name in ("sklearn", "jnp"):
        assert parse_train_params(TINY + ["-knn_backend", name]).knn_backend == name
    with pytest.raises(SystemExit):
        parse_train_params(TINY + ["-knn_backend", "faiss"])


def test_gpu_flag(monkeypatch):
    from focal_tpu_torch.params import (parse_predict_params, parse_test_params,
                                        parse_train_params, select_device)

    base = ["-dataset", "MOD_TINY", "-synthetic"]
    for parse in (parse_train_params, parse_test_params, parse_predict_params):
        assert parse(base + ["-gpu", "1"]).device == "cuda:1"
        assert parse(base + ["-gpu", "1", "-device", "cpu"]).device == "cpu"
        assert parse(base).device == "cuda"
        with pytest.raises(SystemExit):
            parse(base + ["-gpu", "-1"])
    with pytest.raises(ValueError, match="several processes"):
        parse_train_params(base + ["-gpu", "0", "-data_parallel", "2"])
    monkeypatch.setenv("FOCAL_DIST_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="several processes"):
        parse_test_params(base + ["-gpu", "0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert select_device("cuda:0") == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="1 CUDA device"):
        select_device("cuda:1")


def test_dataset_config_resolves_as_the_jax_package(tmp_path, monkeypatch):
    import yaml

    from focal_tpu.params.yaml_utils import resolve_dataset_yaml as jax_resolve
    from focal_tpu_torch.params import (CONFIG_DIR, load_yaml, parse_predict_params,
                                        parse_test_params, parse_train_params,
                                        resolve_dataset_yaml)

    packaged = load_yaml(os.path.join(CONFIG_DIR, "MOD_TINY.yaml"))
    own = dict(packaged, pretrain_index_file="own/pretrain_index.txt")
    explicit = tmp_path / "own.yaml"
    explicit.write_text(yaml.safe_dump(own))
    cwd = tmp_path / "cwd"
    (cwd / "data").mkdir(parents=True)
    local = dict(packaged, pretrain_index_file="local/pretrain_index.txt")
    (cwd / "data" / "MOD_TINY.yaml").write_text(yaml.safe_dump(local))
    cases = [(None, packaged, "packaged"), (str(explicit), own, "explicit"),
             (str(tmp_path / "missing.yaml"), packaged, "packaged")]
    for where in ("repo", "cwd"):
        if where == "cwd":
            monkeypatch.chdir(cwd)
            cases = [(None, local, "local"), (str(explicit), own, "explicit"),
                     (str(tmp_path / "missing.yaml"), local, "local")]
        for path, recipe, kind in cases:
            got, want = resolve_dataset_yaml("MOD_TINY", path), jax_resolve("MOD_TINY", path)
            if kind == "packaged":  # each package's own copy of the recipe
                assert load_yaml(got) == load_yaml(want) == packaged
                assert os.path.dirname(os.path.abspath(got)) == CONFIG_DIR
            else:
                assert got == want
            flags = ["-dataset", "MOD_TINY", "-synthetic"] + (
                ["-dataset_config", path] if path else [])
            for parse in (parse_train_params, parse_test_params, parse_predict_params):
                assert parse(flags).dataset_config == recipe, (where, path, parse)
    with pytest.raises(FileNotFoundError, match="NO_SUCH"):
        resolve_dataset_yaml("NO_SUCH")


def test_prng_impl_is_refused_by_name():
    from focal_tpu_torch.params import parse_test_params, parse_train_params

    for parse in (parse_train_params, parse_test_params):
        with pytest.raises(ValueError, match="-prng_impl rbg: the flag selects JAX's PRNG "
                                             "implementation.*Philox"):
            parse(TINY + ["-prng_impl", "rbg"])


def test_every_jax_flag_has_a_port_parser():
    from focal_tpu.params.cli import build_parser as jax_parser
    from focal_tpu_torch.params import build_parser, build_train_parser

    def flags(parser):
        return {o for a in parser._actions for o in a.option_strings}

    jax_only = flags(jax_parser()) - flags(build_train_parser())
    assert jax_only == {"-input", "-predictions_out"}  # predict.py's, in the serving parser
    assert jax_only <= flags(build_parser())
    assert {"-gpu", "-dataset_config"} <= flags(build_parser())
