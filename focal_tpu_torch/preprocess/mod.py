"""MOD raw-data extraction: CSV sensor dumps -> per-2s-segment sample files
(the port's copy of the JAX package's ``data/preprocess/mod.py``: the same
numpy operations, the same files).

Rebuild of the reference's offline pipeline
(reference: src/data_preprocess/MOD/extract_samples.py:15-382,
extract_pretrain_samples.py, extract_samples_speed_distance.py):

  raw shake folders {run}/{shake}/{aud16000.csv|aud.csv, ehz.csv}
  -> trim per-recording start/end shifts
  -> resample audio 16 kHz -> 8 kHz
  -> split into 2 s segments, each into 10 x 0.2 s intervals
  -> save time-domain (and optionally freq-domain) .npz samples named
     {run}_{shake}_{segment_id}.npz  (the trailing id drives subsequence
     grouping in the sequence dataset).

Speed/distance labels are parsed from folder names ("5mph", "distance2", ...)
into a task-keyed label dict, mirroring extract_samples_speed_distance.py.

Usage:
  python -m focal_tpu_torch.preprocess.mod --input RAW_DIR --output OUT_DIR \
      [--pretrain] [--save-freq]
"""

import argparse
import os
import re

import numpy as np

from focal_tpu_torch.preprocess import mod_tables as mt
from focal_tpu_torch.preprocess.signal import extract_time_freq, resample, segment_recording

SEGMENT_SPAN = 2
INTERVAL_SPAN = 0.2
AUD_DOWNSAMPLE_RATE = 2
FREQS = {"audio": 16000 / AUD_DOWNSAMPLE_RATE, "seismic": 100, "acc": 100}

VEHICLE_LABELS = {
    "Polaris": 0, "Warhog": 1, "Silverado": 2, "motor": 3, "tesla": 4,
    "mustang": 5, "walk": 6, "bicycle": 7, "forester": 8, "pickup": 9, "scooter": 10,
}

SPEED_LABELS = {"5mph": 0, "10mph": 1, "15mph": 2, "20mph": 3}
DISTANCE_PATTERN = re.compile(r"distance(\d+)")


def folder_to_label(folder):
    """Vehicle-class label from a run folder name
    (reference: extract_samples.py:93-103)."""
    for name, idx in VEHICLE_LABELS.items():
        if name in folder:
            return name, idx
    raise ValueError(f"No vehicle label found in folder name: {folder}")


def parse_aux_labels(folder):
    """Optional speed/distance labels parsed from the folder name
    (reference: extract_samples_speed_distance.py:60-90)."""
    labels = {}
    for token, idx in SPEED_LABELS.items():
        if token in folder:
            labels["speed"] = idx
    m = DISTANCE_PATTERN.search(folder)
    if m:
        labels["distance"] = int(m.group(1)) - 1
    return labels


def load_shake_csvs(shake_path, start_shift=0.0, end_shift=0.0):
    """Load one shake's audio + seismic CSVs, trim shifts, resample audio.
    Returns {"audio": [t, 1], "seismic": [t, 1]} at FREQS rates.

    Parity details (reference: extract_samples.py:254-279): audio is
    comma-delimited, seismic SPACE-delimited; multi-column files keep only
    column 0; the trim is applied to the RAW signal (audio at 16 kHz, before
    resampling), not the resampled one."""
    files = os.listdir(shake_path)
    audio_file = "aud16000.csv" if "aud16000.csv" in files else "aud.csv"
    raw_audio = np.loadtxt(os.path.join(shake_path, audio_file), dtype=float, delimiter=",")
    if raw_audio.ndim > 1:
        raw_audio = raw_audio[:, 0]
    raw_audio = raw_audio[:, None]
    raw_audio = raw_audio[int(16000 * start_shift) : len(raw_audio) - int(16000 * end_shift)]
    if AUD_DOWNSAMPLE_RATE > 1:
        audio = resample(raw_audio, 16000, FREQS["audio"])
    else:
        audio = raw_audio

    raw_seismic = np.loadtxt(os.path.join(shake_path, "ehz.csv"), dtype=float, delimiter=" ")
    if raw_seismic.ndim > 1:
        raw_seismic = raw_seismic[:, 0]
    raw_seismic = raw_seismic[:, None]
    f = FREQS["seismic"]
    seismic = raw_seismic[int(f * start_shift) : len(raw_seismic) - int(f * end_shift)]

    return {"audio": audio.astype(np.float32), "seismic": seismic.astype(np.float32)}


def extract_samples_from_signals(signals, loc="shake"):
    """{mod: [t, c]} -> list of {"data": {loc: {mod: [c,i,s]}},
    "freq_data": {...}} 2-second samples (complete segments only)."""
    segments = {
        mod: segment_recording(arr, FREQS[mod], SEGMENT_SPAN) for mod, arr in signals.items()
    }
    n = min(len(s) for s in segments.values())
    samples = []
    for i in range(n):
        time_data, freq_data = {}, {}
        for mod in signals:
            t, f = extract_time_freq(segments[mod][i], INTERVAL_SPAN, FREQS[mod])
            time_data[mod] = t
            freq_data[mod] = f
        samples.append({"data": {loc: time_data}, "freq_data": {loc: freq_data}})
    return samples


def save_sample(path, data, label):
    """Write one sample .npz in the framework schema
    (see focal_tpu_torch.data)."""
    arrays = {}
    if isinstance(label, dict):
        for k, v in label.items():
            arrays[f"label.{k}"] = np.int32(v)
    else:
        arrays["label"] = np.int32(label)
    for loc, mods in data.items():
        for mod, arr in mods.items():
            arrays[f"data.{loc}.{mod}"] = arr
    np.savez(path, **arrays)


def process_shake(run_folder, shake, input_path, output_dir, start_shift=0.0, end_shift=0.0, save_freq=False):
    """Process one (run, shake) recording into sample files. Returns paths."""
    shake_path = os.path.join(input_path, run_folder, shake)
    signals = load_shake_csvs(shake_path, start_shift, end_shift)
    _, vehicle_id = folder_to_label(run_folder)
    aux = parse_aux_labels(run_folder)
    label = {"vehicle_type": vehicle_id, **aux} if aux else vehicle_id

    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i, sample in enumerate(extract_samples_from_signals(signals)):
        path = os.path.join(output_dir, f"{run_folder}_{shake}_{i}.npz")
        save_sample(path, sample["data"], label)
        paths.append(path)
        if save_freq:
            fpath = os.path.join(output_dir + "_freq", f"{run_folder}_{shake}_{i}.npz")
            os.makedirs(os.path.dirname(fpath), exist_ok=True)
            save_sample(fpath, sample["freq_data"], label)
    return paths


def select_jobs(input_path, pretrain=False, use_allowlists="auto"):
    """Folder/shake selection with the reference allowlists.

    Labeled flow (reference: extract_samples.py:330-360): run folders in
    PRESERVED_CLEAN_FOLDERS; folders in PRESERVED_CLEAN_FOLDERS_2 use only
    their "rs1" sensor, others use sensors in SUBJECTS.
    Pretrain flow (extract_pretrain_samples.py:153-165): the
    PRESERVED_EXTRA_FOLDERS {run: [shakes]} table.

    use_allowlists="auto" applies them only when at least one folder matches,
    so fabricated test layouts still extract; True/False force.
    Returns [(run_folder, shake)] sorted.
    """
    entries = sorted(
        e for e in os.listdir(input_path) if os.path.isdir(os.path.join(input_path, e))
    )
    if use_allowlists == "auto":
        table = mt.PRESERVED_EXTRA_FOLDERS if pretrain else mt.PRESERVED_CLEAN_FOLDERS
        use_allowlists = any(e in table for e in entries)

    jobs = []
    if pretrain and use_allowlists:
        for folder in entries:
            if folder in mt.PRESERVED_EXTRA_FOLDERS:
                for shake in mt.PRESERVED_EXTRA_FOLDERS[folder]:
                    if os.path.isdir(os.path.join(input_path, folder, shake)):
                        jobs.append((folder, shake))
        return jobs
    for folder in entries:
        if use_allowlists and folder not in mt.PRESERVED_CLEAN_FOLDERS:
            continue
        if use_allowlists and folder in mt.PRESERVED_CLEAN_FOLDERS_2:
            if os.path.isdir(os.path.join(input_path, folder, "rs1")):
                jobs.append((folder, "rs1"))
            continue
        for shake in sorted(os.listdir(os.path.join(input_path, folder))):
            if not os.path.isdir(os.path.join(input_path, folder, shake)):
                continue
            if use_allowlists and shake not in mt.SUBJECTS:
                continue
            jobs.append((folder, shake))
    return jobs


def process_dataset(input_path, output_dir, shifts=None, save_freq=False, workers=0,
                    pretrain=False, use_allowlists="auto"):
    """Extract every selected recording under {run}/{shake}/ folders.
    shifts: optional {run: {shake: (start_s, end_s)}} trim override; by
    default the per-recording data_trunk tables apply
    (reference: data_trunk.py via mod_tables.py; 0 for unknown folders)."""
    jobs = []
    for run_folder, shake in select_jobs(input_path, pretrain, use_allowlists):
        if shifts is not None:
            start, end = shifts.get(run_folder, {}).get(shake, (0.0, 0.0))
        else:
            start, end = mt.default_shift(run_folder, shake)
        jobs.append((run_folder, shake, start, end))

    all_paths = []
    if workers and workers > 1:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=workers) as pool:
            futures = [
                pool.submit(process_shake, r, s, input_path, output_dir, st, en, save_freq)
                for r, s, st, en in jobs
            ]
            for f in futures:
                all_paths.extend(f.result())
    else:
        for r, s, st, en in jobs:
            all_paths.extend(process_shake(r, s, input_path, output_dir, st, en, save_freq))
    return all_paths


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input", required=True, help="Raw MOD root ({run}/{shake}/*.csv)")
    parser.add_argument("--output", required=True, help="Output sample directory")
    parser.add_argument("--save-freq", action="store_true", help="Also save freq-domain samples")
    parser.add_argument(
        "--pretrain",
        action="store_true",
        help="Extract the unlabeled 'extra' pretrain recordings "
        "(PRESERVED_EXTRA_FOLDERS) instead of the labeled clean set",
    )
    parser.add_argument("--workers", type=int, default=0)
    args = parser.parse_args()
    paths = process_dataset(
        args.input, args.output, save_freq=args.save_freq, workers=args.workers,
        pretrain=args.pretrain,
    )
    print(f"Extracted {len(paths)} samples to {args.output}")


if __name__ == "__main__":
    main()
