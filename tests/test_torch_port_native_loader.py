"""The port's bulk .npz loader (``focal_tpu_torch.native``) and the split
it loads, against the JAX package's.

  * ``write_synthetic_sample_files`` writes the JAX package's sample files
    (each archive's members byte for byte) and index files;
  * the loader's arrays and labels equal a per-file numpy read and
    ``focal_tpu.native``'s, bitwise; a split from index files equals
    ``ArrayDataset.from_index_file``'s (arrays, labels, names,
    subsequences), exactly;
  * a compressed archive in a split is read with numpy (and logged), the
    rest by the loader: the split equals the per-file read; a corrupt one
    is reported by the loader and raises in the split, as in the JAX
    package;
  * the library is built from the repository's source into
    build/focal_tpu_torch/, named by a content hash; a failed build raises
    with g++'s output.
"""

import logging
import os
import zipfile

import numpy as np
import pytest

from focal_tpu import native as jax_native
from focal_tpu.data.dataset import ArrayDataset
from focal_tpu.data.synthetic import write_synthetic_sample_files as jax_write
from focal_tpu_torch import native
from focal_tpu_torch.data import Split, _load_sample_file, write_synthetic_sample_files
from focal_tpu_torch.ops._build import BUILD_DIR
from focal_tpu_torch.params import load_dataset_config
from torch_port_threads import one_torch_thread  # noqa: F401

TASK = "vehicle_classification"


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    cfg = load_dataset_config("MOD_TINY")
    port = write_synthetic_sample_files(cfg, TASK, str(tmp_path_factory.mktemp("port")), 48,
                                        seed=3)
    jax = jax_write(cfg, TASK, str(tmp_path_factory.mktemp("jax")), 48, seed=3)
    return port, jax


def members(path):
    """{member name: its bytes} of an .npz archive: the files' contents
    (the zip headers hold the time of writing)."""
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def _paths(index_file):
    return [str(p) for p in np.loadtxt(index_file, dtype=str, ndmin=1)]


def test_sample_files_equal_the_jax_package(written):
    port, jax = written
    assert sorted(port) == sorted(jax) == ["pretrain", "test", "train", "val"]
    for split in port:
        mine, theirs = _paths(port[split]), _paths(jax[split])
        assert [os.path.basename(p) for p in mine] == [os.path.basename(p) for p in theirs]
        for a, b in zip(mine, theirs):
            assert members(a) == members(b), a


def test_loader_equals_numpy_and_the_jax_loader(written):
    paths = _paths(written[0]["pretrain"])
    with np.load(paths[0]) as z:
        keys = {k: z[k].shape for k in z.files if k.startswith("data.")}
    assert len(keys) == 2
    for key, shape in keys.items():
        got, ok = native.load_batch_f32(paths, key, shape)
        assert ok.all()
        want = np.stack([np.load(p)[key] for p in paths])
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
        assert np.array_equal(got, jax_native.load_batch_f32(paths, key, shape))
    labels, ok = native.load_scalar_i64(paths, "label.vehicle_type")
    assert ok.all()
    assert np.array_equal(labels, [int(np.load(p)["label.vehicle_type"]) for p in paths])
    assert np.array_equal(labels, jax_native.load_scalar_i64(paths, "label.vehicle_type"))


@pytest.mark.parametrize("split, seq_len", [("pretrain", 4), ("train", None), ("test", None)])
def test_split_equals_array_dataset(written, split, seq_len):
    port, jax = written
    got = Split.from_index_file(port[split], TASK, seq_len)
    want = ArrayDataset.from_index_file(jax[split], TASK, seq_len)
    assert got.data.keys() == want.data.keys()
    for loc in want.data:
        assert got.data[loc].keys() == want.data[loc].keys()
        for mod in want.data[loc]:
            assert got.data[loc][mod].dtype == want.data[loc][mod].dtype
            assert np.array_equal(got.data[loc][mod], want.data[loc][mod])
    assert got.labels.dtype == want.labels.dtype and np.array_equal(got.labels, want.labels)
    assert got.names == want.sample_names
    if seq_len is None:
        assert got.subseq_idx is None and want.subseq_idx is None
    else:
        assert np.array_equal(got.subseq_idx, want.subseq_idx)


def _per_file(paths):
    samples = [_load_sample_file(p, TASK) for p in paths]
    data = {loc: {m: np.stack([d[loc][m] for d, _ in samples]) for m in mods}
            for loc, mods in samples[0][0].items()}
    return data, np.asarray([label for _, label in samples], np.int32)


def test_compressed_archive_is_read_with_numpy(written, tmp_path, caplog):
    paths = _paths(written[0]["val"])
    squeezed = tmp_path / "squeezed_0.npz"
    with np.load(paths[1]) as z:
        np.savez_compressed(squeezed, **{k: z[k] for k in z.files})
    mixed = [paths[0], str(squeezed)] + paths[2:]
    key = "data.shake.audio"
    _, ok = native.load_batch_f32(mixed, key, np.load(paths[0])[key].shape)
    assert ok.tolist() == [True, False] + [True] * (len(paths) - 2)
    assert jax_native.load_batch_f32(mixed, key, np.load(paths[0])[key].shape) is None
    index = tmp_path / "index.txt"
    index.write_text("\n".join(mixed) + "\n")
    with caplog.at_level(logging.INFO):
        got = Split.from_index_file(str(index), TASK)
    assert f"1 of {len(mixed)} archives not in its format" in caplog.text
    assert "squeezed_0.npz" in caplog.text
    data, labels = _per_file(mixed)
    want = ArrayDataset.from_index_file(str(index), TASK)  # the JAX package's Python path
    for loc in data:
        for mod in data[loc]:
            assert np.array_equal(got.data[loc][mod], data[loc][mod])
            assert np.array_equal(got.data[loc][mod], want.data[loc][mod])
    assert np.array_equal(got.labels, labels) and np.array_equal(got.labels, want.labels)


def test_corrupt_archive_is_reported_and_raises(written, tmp_path):
    paths = _paths(written[0]["val"])
    bad = tmp_path / "bad_0.npz"
    bad.write_bytes(b"not a zip at all")
    mixed = paths + [str(bad)]
    _, ok = native.load_scalar_i64(mixed, "label.vehicle_type")
    assert ok.tolist() == [True] * len(paths) + [False]
    index = tmp_path / "index.txt"
    index.write_text("\n".join(mixed) + "\n")
    with pytest.raises(Exception) as port_err:
        Split.from_index_file(str(index), TASK)
    with pytest.raises(Exception) as jax_err:
        ArrayDataset.from_index_file(str(index), TASK)
    assert type(port_err.value) is type(jax_err.value)


def test_library_built_into_build_by_content_hash(tmp_path, monkeypatch):
    path = native.build()
    assert os.path.dirname(path) == BUILD_DIR and os.path.isfile(path)
    assert os.path.basename(path).startswith("libnpz_loader_")
    broken = tmp_path / "npz_loader.cpp"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    assert native.library_path() != path  # another source, another library
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on npz_loader.cpp") as err:
        native.build()
    assert "error" in str(err.value)
    assert not os.path.exists(native.library_path())
