"""Serving / batch inference (port of the JAX package's ``serve.py``).

Load a state_dict, run a fixed-batch classifier forward (augmenter "no"
-> FFT -> backbone -> softmax) over arbitrary sample batches, pad the
ragged tail by repeating the last row, and account per-batch latency.
Probabilities are computed in f32 on the device; only [B, num_classes]
comes back per batch.
"""

import glob
import json
import os
import time

import numpy as np
import torch

from focal_tpu_torch.data import _load_sample_file
from focal_tpu_torch.models import build_backbone, init_params
from focal_tpu_torch.ops.augment import Augmenter
from focal_tpu_torch.params import select_device


class Predictor:
    """State dict -> fixed-batch classifier on one device.

    Args:
      dataset_config: the recipe (shapes, classes, backbone settings).
      model: backbone name ("SW_Transformer" or "DeepSense"; DeepSense's
        state_dict carries its BatchNorm running statistics).
      task: downstream task key of the recipe.
      state_dict: a port state_dict, or the path of one saved with
        ``torch.save``; None serves a seeded random init (``seed``).
      batch_size: the fixed serving batch.
      device: "cuda" (default) or "cpu"; "cuda" with no card raises.
      pallas_mlp: SW_Transformer's MLPs through the fused MLP kernel (#10),
        as the CLI's -pallas_mlp.
      pallas_block: SW_Transformer's window attention through the
        whole-block kernel (#1, #4 for wide blocks); False takes the
        attention-only kernel (#6) between the qkv and proj Linears, as the
        CLI's -no_pallas_block.
      compute_dtype: "float32" (default) or "bfloat16", as the CLI's
        -compute_dtype: the activations' type (the weights stay f32; bf16
        serves SW_Transformer through #1-bf16, DeepSense on cuDNN's bf16
        convs). The probabilities are computed in f32 either way.
    """

    def __init__(self, dataset_config, model, task, state_dict=None, batch_size=128,
                 device="cuda", learn_framework="no", seed=0, pallas_mlp=False,
                 pallas_block=True, compute_dtype="float32"):
        self.device = select_device(device)
        self.task = task
        self.batch_size = int(batch_size or 128)
        self.num_classes = dataset_config[task]["num_classes"]
        self.augmenter = Augmenter(dataset_config)
        net = build_backbone(dataset_config, model, task, learn_framework, pallas_mlp=pallas_mlp,
                             pallas_block=pallas_block, compute_dtype=compute_dtype)
        if state_dict is None:
            init_params(net, seed)
            self.checkpoint_path = f"random init (seed {seed})"
        else:
            if isinstance(state_dict, (str, os.PathLike)):
                self.checkpoint_path = str(state_dict)
                state_dict = torch.load(state_dict, map_location="cpu", weights_only=True)
            else:
                self.checkpoint_path = "in-memory state_dict"
            net.load_state_dict(state_dict, strict=True)
        self.model = net.to(self.device).eval()

        # sample-shape template from the recipe (time domain [c, i, s])
        self._template = {}
        for loc in dataset_config["location_names"]:
            self._template[loc] = {}
            for mod in dataset_config["loc_modalities"][loc]:
                if mod not in dataset_config["loc_mod_spectrum_len"][loc]:
                    continue
                c = dataset_config["loc_mod_in_time_channels"][loc][mod]
                i = dataset_config["num_segments"]
                s = dataset_config["loc_mod_spectrum_len"][loc][mod]
                self._template[loc][mod] = (c, i, s)

        # warm-up on a zero batch: builds the kernels, primes the allocator
        t0 = time.time()
        zeros = {
            loc: {m: np.zeros((self.batch_size,) + shp, np.float32) for m, shp in mods.items()}
            for loc, mods in self._template.items()
        }
        self._forward(zeros)
        self.compile_seconds = time.time() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _forward(self, batch):
        """{loc: {mod: [B, c, i, s] numpy}} -> probs [B, num_classes] numpy."""
        x = {
            loc: {m: torch.from_numpy(a).to(self.device) for m, a in mods.items()}
            for loc, mods in batch.items()
        }
        logits = self.model(self.augmenter.no(x), head="class")
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        out = probs.cpu().numpy()
        self._sync()
        return out

    def predict(self, data):
        """data: {loc: {mod: [N, c, i, s]}} numpy arrays.

        Returns dict with "probs" [N, num_classes] f32, "preds" [N] int,
        and latency stats (seconds per batch: mean/p50/p99, windows_per_s;
        includes host-device copies; ``compile_s`` is the warm-up batch,
        kernel build included)."""
        n = next(iter(next(iter(data.values())).values())).shape[0]
        B = self.batch_size
        probs = np.empty((n, self.num_classes), np.float32)
        lat = []
        for lo in range(0, n, B):
            hi = min(lo + B, n)
            batch = {
                loc: {m: np.ascontiguousarray(a[lo:hi], np.float32) for m, a in mods.items()}
                for loc, mods in data.items()
            }
            if hi - lo < B:  # pad the ragged tail by repeating the last row
                pad = B - (hi - lo)
                batch = {
                    loc: {m: np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) for m, a in mods.items()}
                    for loc, mods in batch.items()
                }
            self._sync()
            t0 = time.time()
            out = self._forward(batch)
            lat.append(time.time() - t0)
            probs[lo:hi] = out[: hi - lo]
        lat = np.asarray(lat)
        return {
            "probs": probs,
            "preds": probs.argmax(-1).astype(np.int32),
            "latency": {
                "batch_size": B,
                "batches": int(lat.size),
                "mean_s": float(lat.mean()),
                "p50_s": float(np.percentile(lat, 50)),
                "p99_s": float(np.percentile(lat, 99)),
                "windows_per_s": float(n / lat.sum()),
                "compile_s": float(self.compile_seconds),
            },
        }


def load_input(path, task):
    """Load samples for prediction from an index file (.txt of sample paths)
    or a directory of .npz/.pt sample files (sorted by name). Files without
    a label get label -1.

    Returns ({loc: {mod: [N, ...]}}, labels [N] int32, names [N])."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.npz")) + glob.glob(os.path.join(path, "*.pt")))
    else:
        files = [str(s) for s in np.loadtxt(path, dtype=str, ndmin=1)]
    if not files:
        raise ValueError(f"No sample files found at {path}")
    datas, labels = [], []
    for f in files:
        d, lab = _load_sample_file(f, task)
        datas.append(d)
        labels.append(-1 if lab is None else lab)
    stacked = {
        loc: {mod: np.stack([d[loc][mod] for d in datas]).astype(np.float32) for mod in datas[0][loc]}
        for loc in datas[0]
    }
    return stacked, np.asarray(labels, np.int32), [os.path.basename(f) for f in files]


def write_predictions(path, names, result, labels=None):
    """Write a predictions JSON: one record per sample + latency summary."""
    records = []
    for i, name in enumerate(names):
        rec = {
            "sample": name,
            "pred": int(result["preds"][i]),
            "probs": [round(float(p), 6) for p in result["probs"][i]],
        }
        if labels is not None and labels[i] >= 0:
            rec["label"] = int(labels[i])
        records.append(rec)
    payload = {"latency": result["latency"], "predictions": records}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return payload
