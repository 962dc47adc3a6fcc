"""Sample files and synthetic data (numpy; same arrays as the JAX package),
device-resident splits, and their batch plans (port of the JAX package's
``data/dataset.py``, ``data/synthetic.py`` and ``data/loader.py``).

Sample schema: each sample file holds
    {"label": int or {task: int}, "data": {loc: {mod: [c, i, s] float32}}}
as either a torch ``.pt`` or an ``.npz`` with keys ``label.<task>`` /
``label`` and ``data.<loc>.<mod>``. A split of ``.npz`` files loads through
the bulk loader (``focal_tpu_torch.native``), as the JAX package's does;
the archives it cannot read (compressed, zip64, unreadable) and ``.pt``
files are read one by one here.

A split lives on the device whole; a loader yields only index arrays, which
the step gathers from it. Train batches drop the ragged tail; eval batches
pad it by repeating the last unit and carry a 0/1 weight per row.
"""

import logging
import os
import re

import numpy as np
import torch

from focal_tpu_torch import native

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


def write_synthetic_sample_files(dataset_config, task, out_dir, num_samples, seed=0,
                                 splits=(0.7, 0.15, 0.15)):
    """Write ``synthetic_arrays``' samples as .npz files and the index
    files {train,val,test,pretrain}_index.txt in the reference's layout
    (the JAX package's arrays and index files); split boundaries fall on
    sequence boundaries, so subsequences never straddle splits. Returns
    {split: index file path}."""
    os.makedirs(out_dir, exist_ok=True)
    data, labels, names = synthetic_arrays(dataset_config, task, num_samples, seed)
    label_key = TASK_LABEL_KEYS.get(task)
    paths = []
    for i, name in enumerate(names):
        path = os.path.join(out_dir, name)
        arrays = {f"label.{label_key}" if label_key else "label": np.int32(labels[i])}
        for loc in data:
            for mod in data[loc]:
                arrays[f"data.{loc}.{mod}"] = data[loc][mod][i]
        np.savez(path, **arrays)
        paths.append(path)
    seq_len = dataset_config.get("seq_len", 4)
    n_seq = len(paths) // seq_len
    n_train_seq, n_val_seq = int(n_seq * splits[0]), int(n_seq * splits[1])
    cut1, cut2 = n_train_seq * seq_len, (n_train_seq + n_val_seq) * seq_len
    index = {"train": paths[:cut1], "val": paths[cut1:cut2], "test": paths[cut2:],
             "pretrain": paths[:cut2]}
    index_files = {}
    for split, files in index.items():
        index_files[split] = os.path.join(out_dir, f"{split}_index.txt")
        with open(index_files[split], "w") as f:
            f.write("\n".join(files) + "\n")
    return index_files


def _bulk_load(files, task):
    """({loc: {mod: [N, ...] float32}}, int32 labels [N]) of .npz sample
    files through the bulk loader, the JAX package's ``_bulk_load_native``:
    the members and the label key are those of the first file (``label``,
    else ``label.<the task's key>``); None where the files are not all
    .npz or the first names no data or label. Archives the loader cannot
    read are read with numpy, and logged."""
    if not all(f.endswith(".npz") for f in files):
        return None
    with np.load(files[0]) as z:
        data_keys = {k: z[k].shape for k in z.files if k.startswith("data.")}
        label_keys = [k for k in z.files if k == "label" or k.startswith("label.")]
    wanted = TASK_LABEL_KEYS.get(task)
    label_key = ("label" if "label" in label_keys else
                 f"label.{wanted}" if wanted and f"label.{wanted}" in label_keys else None)
    if not data_keys or label_key is None:
        return None
    stacked, read = {}, np.ones(len(files), bool)
    for key, shape in data_keys.items():
        _, loc, mod = key.split(".")
        arr, ok = native.load_batch_f32(files, key, shape)
        stacked.setdefault(loc, {})[mod] = arr
        read &= ok
    labels, ok = native.load_scalar_i64(files, label_key)
    labels, read = labels.astype(np.int32), read & ok
    missed = np.flatnonzero(~read)
    if len(missed):
        logging.info(f"= Bulk loader: {len(missed)} of {len(files)} archives not in its format "
                     f"(compressed, zip64 or unreadable), read with numpy: {files[missed[0]]}"
                     + (" and others" if len(missed) > 1 else ""))
    for i in missed:
        data, label = _load_sample_file(files[i], task)
        if label is None:
            raise ValueError(f"Sample without a label in a training index: {files[i]}")
        for loc, mods in stacked.items():
            for mod, a in mods.items():
                a[i] = data[loc][mod]
        labels[i] = label
    return stacked, labels


def to_device(data, device):
    """{loc: {mod: numpy}} -> {loc: {mod: tensor on device}}."""
    return {loc: {m: torch.from_numpy(np.ascontiguousarray(a)).to(device) for m, a in mods.items()}
            for loc, mods in data.items()}


def partition_subsequences(sample_names, seq_len, delimiter="_"):
    """int32 [n_subseq, seq_len] sample rows of fixed-length temporal
    subsequences: the sequence id is the basename up to the last delimiter,
    the order its trailing integer; a short final window repeats its last
    sample."""
    seq_to_samples = {}
    for idx, name in enumerate(sample_names):
        base = os.path.basename(name)
        seq, tail = base.rsplit(delimiter, 1) if delimiter in base else (base, "0")
        m = re.match(r"(\d+)", tail.split(".")[0])
        seq_to_samples.setdefault(seq, []).append((int(m.group(1)) if m else 0, idx))
    subseqs = []
    for samples in seq_to_samples.values():
        ordered = [i for _, i in sorted(samples)]
        for i in range(0, len(ordered), seq_len):
            window = ordered[i:i + seq_len]
            window += window[-1:] * (seq_len - len(window))
            subseqs.append(window)
    return np.asarray(subseqs, dtype=np.int32)


class Split:
    """One split, stacked on the host (numpy) and, after ``to(device)``,
    resident on the device: ``data`` {loc: {mod: [N, c, i, s]}}, ``labels``
    [N] int32 (numpy, for the metrics; after ``to`` also ``device_labels``,
    int64 on the device, for the classifier steps), ``subseq_idx`` [n,
    seq_len] or None."""

    def __init__(self, data, labels, names, seq_len=None, delimiter="_"):
        self.data = data
        self.labels = np.asarray(labels, dtype=np.int32)
        self.names = list(names)
        self.seq_len, self.delimiter = seq_len, delimiter
        self.subseq_idx = (partition_subsequences(names, seq_len, delimiter)
                           if seq_len is not None else None)
        self.device_labels = None

    def __len__(self):
        return len(self.labels)

    @property
    def num_subseqs(self):
        return 0 if self.subseq_idx is None else len(self.subseq_idx)

    def to(self, device):
        self.data = to_device(self.data, device)
        self.device_labels = torch.from_numpy(self.labels.astype(np.int64)).to(device)
        return self

    def subsample(self, label_ratio, seed=0):
        """The rows the JAX package's ``ArrayDataset.subsample`` keeps: the
        first round(N * label_ratio) of a permutation from
        ``np.random.default_rng(seed)``, in that order (host arrays)."""
        keep = np.random.default_rng(seed).permutation(len(self))[: round(len(self) * label_ratio)]
        data = {loc: {m: a[keep] for m, a in mods.items()} for loc, mods in self.data.items()}
        return Split(data, self.labels[keep], [self.names[i] for i in keep], self.seq_len,
                     self.delimiter)

    @classmethod
    def from_index_file(cls, index_file, task, seq_len=None, delimiter="_"):
        """The split an index file lists: .npz files through the bulk
        loader (``_bulk_load``), else one file at a time."""
        files = [str(f) for f in np.loadtxt(index_file, dtype=str, ndmin=1)]
        if not files:
            raise ValueError(f"Empty index file: {index_file}")
        names = [os.path.basename(f) for f in files]
        bulk = _bulk_load(files, task)
        if bulk is not None:
            return cls(*bulk, names, seq_len, delimiter)
        samples = [_load_sample_file(f, task) for f in files]
        for f, (_, label) in zip(files, samples):
            if label is None:
                raise ValueError(f"Sample without a label in a training index: {f}")
        first = samples[0][0]
        data = {loc: {m: np.stack([d[loc][m] for d, _ in samples]).astype(np.float32)
                      for m in mods} for loc, mods in first.items()}
        return cls(data, [label for _, label in samples], names, seq_len, delimiter)


def sequence_batches(args):
    """Whole temporal subsequences per batch: FOCAL pretraining only."""
    return args.train_mode == "contrastive" and args.stage == "pretrain"


def load_split(option, args):
    """The "train", "val" or "test" split of a run, on the host. Synthetic
    splits hold -synthetic_samples train samples and a quarter of that for
    val and test, seeded seed, seed + 1, seed + 2. The supervised and
    finetune stages train on -label_ratio of the train split
    (``Split.subsample`` with -seed), as the JAX package's loader does."""
    seq_len = args.dataset_config.get("seq_len") if sequence_batches(args) else None
    pretrain = args.train_mode == "contrastive" and args.stage == "pretrain"
    if args.synthetic:
        n = {"train": args.synthetic_samples, "val": args.synthetic_samples // 4,
             "test": args.synthetic_samples // 4}[option]
        seed = args.seed + {"train": 0, "val": 1, "test": 2}[option]
        data, labels, names = synthetic_arrays(args.dataset_config, args.task, n, seed)
        split = Split(data, labels, names, seq_len)
    else:
        # pretraining reads the recipe's pretrain index; the rest the task's
        cfg = args.dataset_config
        index = (cfg["pretrain_index_file"] if option == "train" and pretrain
                 else cfg[args.task][f"{option}_index_file"])
        delimiter = "-" if args.dataset == "RealWorld_HAR" else "_"
        split = Split.from_index_file(index, args.task, seq_len, delimiter)
    if option == "train" and args.label_ratio < 1 and not pretrain:
        split = split.subsample(args.label_ratio, seed=args.seed)
    return split


class BatchPlan:
    """One batch: int64 sample rows ``idx`` and float32 validity ``weight``."""

    __slots__ = ("idx", "weight")

    def __init__(self, idx, weight):
        self.idx = idx
        self.weight = weight


class DeviceDataLoader:
    """Yields BatchPlans over a Split, in order, with static shapes: with
    ``sequence``, whole subsequences (``batch_size // seq_len`` of them) per
    batch. ``drop_last`` drops the ragged tail (training); otherwise it is
    padded by repeating its last unit, with weight 0 (evaluation). Training
    takes only the loader's shape (``units``, ``per``, ``len``): the loop
    draws its own permutation each epoch."""

    def __init__(self, split, batch_size, drop_last=False, sequence=False):
        self.split = split
        self.sequence = sequence
        if sequence:
            if split.subseq_idx is None:
                raise ValueError("sequence batching needs a split with subsequences")
            self.seq_len = split.subseq_idx.shape[1]
            n = split.num_subseqs
            per = max(1, min(batch_size // self.seq_len, n))
            self.batch_size = per * self.seq_len
        else:
            n = len(split)
            per = self.batch_size = min(batch_size, n)
        if drop_last:
            self.num_batches = max(1, n // per) if n >= per else 0
        else:
            self.num_batches = -(-n // per)
        self.units, self.per = n, per

    def __len__(self):
        return self.num_batches

    def rows(self, units):
        """Sample rows of the given units (subsequences or samples)."""
        return self.split.subseq_idx[units].reshape(-1) if self.sequence else units

    def __iter__(self):
        order = np.arange(self.units)
        for b in range(self.num_batches):
            chunk = order[b * self.per:(b + 1) * self.per]
            valid = len(chunk)
            if valid < self.per:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], self.per - valid)])
            weight = np.arange(self.per) < valid
            if self.sequence:
                weight = np.repeat(weight, self.seq_len)
            yield BatchPlan(self.rows(chunk).astype(np.int64), weight.astype(np.float32))


def create_dataloader(option, split, args):
    """The loader of a split as the JAX package builds it: the train split's
    drops the ragged tail, the others pad it."""
    return DeviceDataLoader(split, args.batch_size, drop_last=option == "train",
                            sequence=sequence_batches(args))
