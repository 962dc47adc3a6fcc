"""Sample files and synthetic data (numpy; same arrays as the JAX package),
and device-resident datasets for the training step.

Sample schema: each sample file holds
    {"label": int or {task: int}, "data": {loc: {mod: [c, i, s] float32}}}
as either a torch ``.pt`` or an ``.npz`` with keys ``label.<task>`` /
``label`` and ``data.<loc>.<mod>``.
"""

from types import SimpleNamespace

import numpy as np
import torch

TASK_LABEL_KEYS = {
    "vehicle_classification": "vehicle_type",
    "distance_classification": "distance",
    "speed_classification": "speed",
}


def _label_for_task(label, task):
    """Pick the right label out of a possibly task-keyed dict."""
    if isinstance(label, dict):
        key = TASK_LABEL_KEYS.get(task)
        if key is None or key not in label:
            raise ValueError(f"Unknown task {task} for label dict with keys {list(label)}")
        label = label[key]
    return int(np.asarray(label))


def _load_sample_file(path, task):
    """Load one sample file (.npz or torch .pt) -> (data_dict, int label or None)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            data = {}
            label = None
            label_dict = {}
            for key in z.files:
                if key == "label":
                    label = int(z[key])
                elif key.startswith("label."):
                    label_dict[key.split(".", 1)[1]] = int(z[key])
                elif key.startswith("data."):
                    _, loc, mod = key.split(".")
                    data.setdefault(loc, {})[mod] = np.asarray(z[key], dtype=np.float32)
            if label_dict:
                label = _label_for_task(label_dict, task)
            return data, label
    sample = torch.load(path, map_location="cpu", weights_only=False)
    data = {
        loc: {mod: np.asarray(t, dtype=np.float32) for mod, t in mods.items()}
        for loc, mods in sample["data"].items()
    }
    label = sample.get("label")  # serving inputs may be unlabeled
    return data, None if label is None else _label_for_task(label, task)


def synthetic_arrays(dataset_config, task, num_samples, seed=0, num_seqs=None):
    """Build {loc:{mod:[N,c,i,s]}}, labels[N], names[N] for a recipe: each
    class gets its own per-modality carrier frequencies plus noise."""
    rng = np.random.default_rng(seed)
    num_classes = dataset_config[task]["num_classes"]
    num_segments = dataset_config["num_segments"]
    locations = dataset_config["location_names"]
    seq_len = dataset_config.get("seq_len", 4)
    if num_seqs is None:
        num_seqs = max(1, num_samples // seq_len)
    num_samples = num_seqs * seq_len

    # temporal sequences share a class (samples of one recording)
    seq_labels = rng.integers(0, num_classes, size=num_seqs)
    labels = np.repeat(seq_labels, seq_len).astype(np.int32)
    names = [f"seq{s}_{t}.npz" for s in range(num_seqs) for t in range(seq_len)]

    data = {}
    for loc in locations:
        data[loc] = {}
        for mod in dataset_config["loc_modalities"][loc]:
            if mod not in dataset_config["loc_mod_spectrum_len"][loc]:
                continue
            c = dataset_config["loc_mod_in_time_channels"][loc][mod]
            s = dataset_config["loc_mod_spectrum_len"][loc][mod]
            t = np.arange(num_segments * s, dtype=np.float32) / float(s)
            x = np.zeros((num_samples, c, num_segments * s), np.float32)
            for ch in range(c):
                freq = 1.0 + (labels[:, None] + 1) * (0.37 + 0.11 * ch) * (1.0 + 0.23 * len(mod))
                phase = rng.uniform(0, 2 * np.pi, size=(num_samples, 1)).astype(np.float32)
                x[:, ch, :] = np.sin(2 * np.pi * freq * t[None, :] + phase)
            x += rng.normal(0, 0.3, size=x.shape).astype(np.float32)
            data[loc][mod] = x.reshape(num_samples, c, num_segments, s)
    return data, labels, names


def to_device(data, device):
    """{loc: {mod: numpy}} -> {loc: {mod: tensor on device}}."""
    return {loc: {m: torch.from_numpy(np.ascontiguousarray(a)).to(device) for m, a in mods.items()}
            for loc, mods in data.items()}


def make_synthetic_dataset(dataset_config, task, num_samples, seed=0, device="cpu"):
    """Synthetic split resident on ``device``: ``data`` {loc: {mod: [N, c,
    i, s]}}, ``labels`` [N], ``names``, and ``subseq_idx`` [N / seq_len,
    seq_len], the sample rows of each temporal subsequence (samples of one
    recording are stored together, as synthetic_arrays names them)."""
    data, labels, names = synthetic_arrays(dataset_config, task, num_samples, seed)
    seq_len = dataset_config.get("seq_len", 4)
    return SimpleNamespace(
        data=to_device(data, device),
        labels=torch.from_numpy(labels).to(device),
        names=names,
        subseq_idx=torch.arange(len(names), device=device).reshape(-1, seq_len),
    )
