"""Split partitioning: write {train,val,test,pretrain}_index.txt files (the
port's copy of the JAX package's ``data/preprocess/partition.py``)
(reference: src/data_preprocess/MOD/partition_data.py:44-117,
partition_data_pretrain.py:24-68).

Reference semantics preserved: only samples with the COMPLETE modality set
enter the splits (the reference torch.loads each sample and multiplies its
flag[loc][mod] entries, partition_data.py:75-82); random train/remainder
split with val == test (the reference evaluates on the same held-out pool
for both); the pretrain index is the union of unlabeled extra samples and
the supervised train split. Optional target/shake filename allowlists mirror
partition_data.py:60-66.

Usage:
  python -m focal_tpu_torch.preprocess.partition --samples OUT_DIR \
      [--extra EXTRA_DIR] [--output INDEX_DIR]
"""

import argparse
import os
import random


def sample_is_complete(path, required_keys=None):
    """True if the sample carries its complete modality set.

    ``.pt`` samples (reference format) carry an explicit per-(loc,mod) flag
    dict; the product over flags decides, exactly as the reference's
    partitioner (partition_data.py:75-82). ``.npz`` samples (this framework's
    extractor only writes complete segments, but third-party .npz may not)
    are complete when every ``required_keys`` entry is present — pass the
    union of ``data.{loc}.{mod}`` keys observed across the directory."""
    if path.endswith(".pt"):
        import torch

        sample = torch.load(path, map_location="cpu", weights_only=False)
        flags = sample.get("flag")
        if flags is None:
            return True
        for loc in flags:
            for mod in flags[loc]:
                if not flags[loc][mod]:
                    return False
        return True
    import numpy as np

    with np.load(path) as z:
        keys = set(k for k in z.files if k.startswith("data."))
    return required_keys is None or required_keys <= keys


def _complete_only(samples):
    """Filter to samples with the complete modality set. The required set for
    .npz files is the union of data keys across the directory, so a sample
    missing a (loc, mod) other samples have is dropped."""
    import numpy as np

    required = set()
    for p in samples:
        if p.endswith(".npz"):
            with np.load(p) as z:
                required |= {k for k in z.files if k.startswith("data.")}
    return [p for p in samples if sample_is_complete(p, required)]


def _name_filtered(samples, targets=None, shakes=None):
    """Optional filename allowlists, reference partition_data.py:60-66:
    ``{target}_{shake}_{segment}`` basenames keep only allowed targets (the
    reference's PRESERVED_FOLDERS) and shakes (e.g. rs1/rs2/rs3/rs7)."""
    if targets is None and shakes is None:
        return samples
    kept = []
    for p in samples:
        parts = os.path.basename(p).split("_")
        if targets is not None and parts[0] not in targets:
            continue
        if shakes is not None and (len(parts) < 2 or parts[1] not in shakes):
            continue
        kept.append(p)
    return kept


def partition_samples(sample_dir, output_dir=None, train_ratio=0.8, val_equals_test=True,
                      seed=0, extra_dir=None, require_complete=True, targets=None, shakes=None):
    output_dir = output_dir or sample_dir
    os.makedirs(output_dir, exist_ok=True)
    samples = sorted(
        os.path.join(sample_dir, f) for f in os.listdir(sample_dir) if f.endswith((".npz", ".pt"))
    )
    samples = _name_filtered(samples, targets, shakes)
    if require_complete:
        samples = _complete_only(samples)
    rng = random.Random(seed)
    rng.shuffle(samples)

    cut = int(len(samples) * train_ratio)
    train, rest = samples[:cut], samples[cut:]
    if val_equals_test:
        val, test = rest, rest
    else:
        half = len(rest) // 2
        val, test = rest[:half], rest[half:]

    extra = []
    if extra_dir and os.path.isdir(extra_dir):
        extra = sorted(
            os.path.join(extra_dir, f) for f in os.listdir(extra_dir) if f.endswith((".npz", ".pt"))
        )
        if require_complete:
            # the pretrain partitioner applies the same completeness filter to
            # the extra pool (partition_data_pretrain.py:39-47), no name filter
            extra = _complete_only(extra)
    pretrain = extra + train

    index_files = {}
    for name, files in (("train", train), ("val", val), ("test", test), ("pretrain", pretrain)):
        path = os.path.join(output_dir, f"{name}_index.txt")
        with open(path, "w") as f:
            f.write("\n".join(files) + ("\n" if files else ""))
        index_files[name] = path
    return index_files


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--samples", required=True, help="Directory of extracted samples")
    parser.add_argument("--output", default=None, help="Where to write index files")
    parser.add_argument("--extra", default=None, help="Unlabeled extra samples for pretraining")
    parser.add_argument("--train-ratio", type=float, default=0.8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--keep-incomplete", action="store_true",
        help="Skip the complete-modality filter (reference partition_data.py:75-82 "
        "drops samples missing any (loc, mod); this flag keeps them).",
    )
    parser.add_argument(
        "--targets", nargs="*", default=None,
        help="Optional filename target allowlist ({target}_{shake}_{id} basenames), "
        "e.g. the reference's PRESERVED_FOLDERS vehicle list.",
    )
    parser.add_argument(
        "--shakes", nargs="*", default=None,
        help="Optional shake allowlist, e.g. rs1 rs2 rs3 rs7.",
    )
    args = parser.parse_args()
    idx = partition_samples(
        args.samples, args.output, args.train_ratio, seed=args.seed, extra_dir=args.extra,
        require_complete=not args.keep_incomplete, targets=args.targets, shakes=args.shakes,
    )
    for k, v in idx.items():
        print(k, "->", v)


if __name__ == "__main__":
    main()
