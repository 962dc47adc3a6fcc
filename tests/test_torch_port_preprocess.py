"""The port's offline MOD preprocessing (``focal_tpu_torch.preprocess``)
against the JAX package's (``focal_tpu.data.preprocess``), on the same
numpy-seeded inputs. Both run the same numpy operations, so every array,
file name, archive member and index file is equal bit for bit:

  * the sinc kernel, resampling (16 kHz -> 8 kHz and 3 -> 2), windows with
    and without overlap, the time/frequency extraction, segmentation and
    whole samples from signals;
  * ``process_shake`` end to end on raw CSVs in tests/test_preprocess.py's
    layout (with a trim, and with the frequency-domain files), the sample
    files' members byte for byte, then loaded by the port's split and the
    JAX package's dataset alike; the speed/distance labels of a folder
    name under each task;
  * the allowlists (both flows), the trim tables and ``process_dataset``'s
    use of them;
  * ``partition_samples``: the index files of tests/test_preprocess.py's
    layouts (extra pretrain pool, the incomplete-sample drop of .npz and
    .pt samples, ``require_complete=False``, the name allowlists).
"""

import os
import zipfile

import numpy as np
import pytest
import torch

from focal_tpu.data.dataset import ArrayDataset
from focal_tpu.data.preprocess import mod as jax_mod
from focal_tpu.data.preprocess import mod_tables as jax_tables
from focal_tpu.data.preprocess import partition as jax_partition
from focal_tpu.data.preprocess import signal as jax_signal
from focal_tpu_torch.data import Split
from focal_tpu_torch.preprocess import mod, mod_tables, partition, signal
from torch_port_threads import one_torch_thread  # noqa: F401


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_signal_primitives_bitwise():
    for o, n in ((2, 1), (3, 2), (5, 4), (160, 80)):
        (k1, w1), (k2, w2) = signal._sinc_resample_kernel(o, n), jax_signal._sinc_resample_kernel(o, n)
        assert w1 == w2
        _same(k1, k2)
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    tone = np.sin(2 * np.pi * 100 * t)[:, None]
    for x, o, n in ((tone, 16000, 8000), (rng.normal(size=(4001, 2)), 16000, 8000),
                    (rng.normal(size=(10, 1)), 3, 2), (rng.normal(size=(64, 3)).astype(np.float32),
                                                       5, 4), (tone, 100, 100)):
        _same(signal.resample(x, o, n), jax_signal.resample(x, o, n))
    x = rng.normal(size=(1000, 3))
    for overlap, length, count in ((0.0, 20, None), (0.5, 20, None), (0.25, None, 7)):
        _same(signal.split_with_overlap(x, overlap, length, count),
              jax_signal.split_with_overlap(x, overlap, length, count))
    seg = rng.normal(size=(200, 3)).astype(np.float32)
    for got, want in zip(signal.extract_time_freq(seg, 0.2, 100),
                         jax_signal.extract_time_freq(seg, 0.2, 100)):
        _same(got, want)
    _same(signal.segment_recording(x, 100, 2, 0.5), jax_signal.segment_recording(x, 100, 2, 0.5))


def test_samples_from_signals_bitwise():
    rng = np.random.default_rng(1)
    signals = {"audio": rng.normal(size=(int(mod.FREQS["audio"] * 5), 1)).astype(np.float32),
               "seismic": rng.normal(size=(int(mod.FREQS["seismic"] * 5), 1)).astype(np.float32)}
    assert mod.FREQS == jax_mod.FREQS
    got, want = mod.extract_samples_from_signals(signals), jax_mod.extract_samples_from_signals(signals)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for part in ("data", "freq_data"):
            for m in ("audio", "seismic"):
                _same(g[part]["shake"][m], w[part]["shake"][m])


def _write_raw_recording(root, run, shake, seconds=5, seed=0):
    """tests/test_preprocess.py's raw layout: aud16000.csv and ehz.csv."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, run, shake)
    os.makedirs(d)
    np.savetxt(os.path.join(d, "aud16000.csv"), rng.normal(size=16000 * seconds), delimiter=",")
    np.savetxt(os.path.join(d, "ehz.csv"), rng.normal(size=100 * seconds), delimiter=",")


def _same_files(got, want):
    """The same file names, and each archive's members byte for byte (the
    zip headers hold the time of writing)."""
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
            assert za.namelist() == zb.namelist(), a
            assert all(za.read(n) == zb.read(n) for n in za.namelist()), a


def test_process_shake_end_to_end(tmp_path):
    raw = str(tmp_path / "raw")
    _write_raw_recording(raw, "Polaris0150pm", "rs1", seconds=7)
    _write_raw_recording(raw, "tesla_10mph_distance2", "rs1", seed=1)
    for run, shifts in (("Polaris0150pm", (1.0, 0.5)), ("tesla_10mph_distance2", (0.0, 0.0))):
        got = mod.process_shake(run, "rs1", raw, str(tmp_path / "port" / "s"), *shifts,
                                save_freq=True)
        want = jax_mod.process_shake(run, "rs1", raw, str(tmp_path / "jax" / "s"), *shifts,
                                     save_freq=True)
        assert len(got) == 2
        _same_files(got, want)
        _same_files([p.replace(os.sep + "s" + os.sep, os.sep + "s_freq" + os.sep) for p in got],
                    [p.replace(os.sep + "s" + os.sep, os.sep + "s_freq" + os.sep) for p in want])
        tasks = ["vehicle_classification"] + (
            ["speed_classification", "distance_classification"] if "mph" in run else [])
        for task in tasks:
            index = tmp_path / f"{run}_{task}.txt"
            index.write_text("\n".join(got) + "\n")
            split = Split.from_index_file(str(index), task, seq_len=2)
            ds = ArrayDataset.from_index_file(str(index), task, seq_len=2)
            _same(split.labels, ds.labels)
            _same(split.data["shake"]["audio"], ds.data["shake"]["audio"])
            _same(split.data["shake"]["seismic"], ds.data["shake"]["seismic"])
            _same(split.subseq_idx, ds.subseq_idx)
            assert split.data["shake"]["audio"].shape == (2, 1, 10, 1600)
        assert split.labels.tolist() == ([1, 1] if "mph" in run else [0, 0])


def test_labels_of_folder_names():
    names = ["Polaris0150pm", "Warhog1135am", "tesla_5mph", "mustang_20mph_distance3", "walk2",
             "scooter_15mph_distance1", "bicycle2", "pickup", "motor10mph"]
    for name in names:
        assert mod.folder_to_label(name) == jax_mod.folder_to_label(name)
        assert mod.parse_aux_labels(name) == jax_mod.parse_aux_labels(name)
    for m in (mod, jax_mod):
        with pytest.raises(ValueError, match="No vehicle label"):
            m.folder_to_label("randomjunk")
    assert mod.VEHICLE_LABELS == jax_mod.VEHICLE_LABELS
    assert mod.SPEED_LABELS == jax_mod.SPEED_LABELS


def _mkdirs(root, layout):
    for run, shakes in layout.items():
        for s in shakes:
            os.makedirs(os.path.join(root, run, s), exist_ok=True)


def test_allowlists_and_trim_tables(tmp_path, monkeypatch):
    root = str(tmp_path / "raw")
    _mkdirs(root, {"tesla": ["rs1", "rs2", "rs3", "rs7"], "Polaris0150pm": ["rs1", "rs3"],
                   "bicycle2": ["rs1", "rs3"], "randomjunk": ["rs3"]})
    for pretrain in (False, True):
        for allow in ("auto", True, False):
            assert (mod.select_jobs(root, pretrain, allow)
                    == jax_mod.select_jobs(root, pretrain, allow)), (pretrain, allow)
    root2 = str(tmp_path / "raw2")
    _mkdirs(root2, {"myrun": ["rs1"]})
    assert mod.select_jobs(root2) == jax_mod.select_jobs(root2) == [("myrun", "rs1")]

    for name in ("START_TIME_SHIFT", "END_TIME_SHIFT", "PRESERVED_CLEAN_FOLDERS",
                 "PRESERVED_CLEAN_FOLDERS_2", "PRESERVED_EXTRA_FOLDERS", "SUBJECTS"):
        assert getattr(mod_tables, name) == getattr(jax_tables, name), name
    for run in list(jax_tables.START_TIME_SHIFT) + ["Warhog1135am", "unknownfolder"]:
        for shake in ("rs1", "rs2", "rs3", "rs7", "rs9"):
            assert mod_tables.default_shift(run, shake) == jax_tables.default_shift(run, shake)

    calls = {}
    for m in (mod, jax_mod):
        seen = calls[m.__name__] = []
        monkeypatch.setattr(m, "process_shake",
                            lambda run, shake, inp, out, start=0.0, end=0.0, save_freq=False,
                            seen=seen: seen.append((run, shake, start, end)) or [])
        for pretrain in (False, True):
            m.process_dataset(root, str(tmp_path / "out"), pretrain=pretrain)
    assert calls[mod.__name__] == calls[jax_mod.__name__]
    assert ("tesla", "rs3", 80, 90) in calls[mod.__name__]


def _index_files(idx):
    return {name: open(path).read() for name, path in idx.items()}


def test_partition_bitwise(tmp_path):
    d, extra = tmp_path / "samples", tmp_path / "extra"
    os.makedirs(d)
    os.makedirs(extra)
    full = {"data.shake.audio": np.zeros((1, 2, 3), np.float32),
            "data.shake.seismic": np.zeros((1, 2, 3), np.float32)}
    for i in range(10):
        np.savez(d / f"motor_rs{1 + i % 3}_{i}.npz", label=np.int32(0), **full)
    np.savez(d / "pickup_rs9_0.npz", label=np.int32(0), **full)
    np.savez(d / "motor_rs1_bad.npz", label=np.int32(0),
             **{"data.shake.audio": np.zeros((1, 2, 3), np.float32)})
    torch.save({"label": {"vehicle_type": 0}, "flag": {"shake": {"audio": 1, "seismic": 0}},
                "data": {"shake": {"audio": torch.zeros(1, 2, 3),
                                   "seismic": torch.zeros(1, 2, 3)}}}, d / "motor_rs1_badflag.pt")
    for i in range(4):
        np.savez(extra / f"x_{i}.npz", label=np.int32(0), **full)
    np.savez(extra / "x_bad.npz", label=np.int32(0),
             **{"data.shake.audio": np.zeros((1, 2, 3), np.float32)})
    cases = [dict(extra_dir=str(extra)), dict(extra_dir=str(extra), require_complete=False),
             dict(seed=3, train_ratio=0.6, val_equals_test=False),
             dict(targets={"motor"}, shakes={"rs1", "rs2"}), dict(extra_dir=str(tmp_path / "no"))]
    for i, kw in enumerate(cases):
        got = partition.partition_samples(str(d), str(tmp_path / f"port{i}"), **kw)
        want = jax_partition.partition_samples(str(d), str(tmp_path / f"jax{i}"), **kw)
        assert _index_files(got) == _index_files(want), kw
        listed = " ".join(_index_files(got).values())
        assert ("bad" in listed) == (kw.get("require_complete") is False), kw
    for p in sorted(os.listdir(d)):
        path = str(d / p)
        assert partition.sample_is_complete(path) == jax_partition.sample_is_complete(path)
