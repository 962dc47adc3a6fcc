"""Augmentation pipelines: ``no`` (serving, eval, finetune), ``random``
(pretrain views) and ``fixed`` (supervised training).

Port of the JAX package's ``ops/augment.py``. Every augmenter is split into
a draw, made on a host ``torch.Generator`` (gate, choice, scale, angle,
permutation, curve knots, mask bounds, mixup's lambda: a few scalars), and
an apply, made with device tensor ops from those values. So a step moves
no random scalar off the device, and a test can feed the port the very
values the JAX package drew. (Jitter's noise is the one draw the size of
its input; it is drawn on the host too.)

Semantics, as in the JAX package:
  * the ``random`` pipeline draws ONE augmenter uniformly from the combined
    time+freq pool per view and applies it in its domain (time augmenters
    before the FFT, frequency augmenters after it);
  * ``fixed`` applies every time augmenter of the pool in order, then the
    FFT, then every frequency augmenter; mixup's soft labels are dropped
    (the reference's quirk) unless ``mixup_labels``;
  * each applied augmenter gates once per (loc, mod) per batch with its
    ``prob``, not per sample;
  * time_warp/mag_warp are smooth random curves: knots ~ N(1, magnitude)
    linearly interpolated over the flattened [i*s] time axis;
  * time_mask zeroes a run of intervals, freq_mask a band of the spectrum;
    jitter adds noise scaled by the modality's value range (the per-(loc,
    mod) ``ctx`` table).

A data rank of the sharded layout holds only its rows of a batch: its
augmenter (``Augmenter.for_rows``) makes every draw of the global batch,
so that every rank draws the same values, and applies them to its rows;
jitter keeps its rows of the global noise, and mixup takes its partners
from the data ranks' rows gathered.
"""

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F

from focal_tpu_torch.ops.fft import fft_preprocess

# --------------------------------------------------------------------------
# helpers


def _gated(gen, p):
    """One Bernoulli(p) draw for the whole batch of one (loc, mod)."""
    return float(torch.rand((), generator=gen)) < p


def _random_curve(knots, length):
    """Smooth curve through ``knots`` (a device tensor) placed evenly over
    ``length`` points, linearly interpolated (jnp.interp's rule)."""
    n = knots.shape[0]
    dev = knots.device
    xs = torch.arange(length, dtype=torch.float32, device=dev)
    xp = torch.linspace(0.0, length - 1.0, n, dtype=torch.float32, device=dev)
    i = torch.searchsorted(xp, xs, right=True).clamp(1, n - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = knots[i - 1], knots[i]
    curve = f0 + (xs - x0) / (x1 - x0) * (f1 - f0)
    return torch.where(xs >= xp[-1], knots[-1], curve)


def _linear_interp_time(x, positions):
    """Linearly sample x [b, c, L] at float positions [L]."""
    L = x.shape[-1]
    pos = positions.clamp(0.0, L - 1.0)
    i0 = pos.floor().long()
    i1 = (i0 + 1).clamp(max=L - 1)
    frac = pos - i0
    return x[..., i0] * (1.0 - frac) + x[..., i1] * frac


# --------------------------------------------------------------------------
# augmenters: draw(gen, shape, cfg) -> values on the host;
#             apply(x [b, c, i, s], values, cfg) -> x on x's device


def draw_none(gen, shape, cfg, ctx=None):
    return None


def aug_permutation(x, perm, cfg):
    """Permute the interval axis, same order for the whole batch."""
    return x[:, :, perm.to(x.device), :]


def draw_permutation(gen, shape, cfg, ctx=None):
    return torch.randperm(shape[2], generator=gen)


def aug_scaling(x, z, cfg):
    """One N(1, std) scale per (loc, mod): z is the standard-normal draw."""
    return x * (1.0 + cfg["std"] * z)


def draw_scaling(gen, shape, cfg, ctx=None):
    return float(torch.randn((), generator=gen))


def aug_negation(x, _, cfg):
    return -x


def aug_horizontal_flip(x, _, cfg):
    """Flip interval + sample axes."""
    return torch.flip(x, dims=(2, 3))


def aug_time_warp(x, knots, cfg):
    """Smooth random time warping over the flattened [i*s] axis."""
    b, c, i, s = x.shape
    L = i * s
    curve = _random_curve(knots.to(x.device), L)
    cum = torch.cumsum(curve, 0)
    cum = (cum - cum[0]) / torch.clamp(cum[-1] - cum[0], min=1e-8)
    positions = cum.clamp(0.0, 1.0) * (L - 1)
    return _linear_interp_time(x.reshape(b, c, L), positions).reshape(b, c, i, s)


def draw_knots(gen, shape, cfg, ctx=None):
    """Curve knots ~ N(1, magnitude), 3 * (order - 1) + 1 of them."""
    n_knots = 3 * (max(cfg["order"], 2) - 1) + 1
    return 1.0 + cfg["magnitude"] * torch.randn(n_knots, generator=gen)


def aug_mag_warp(x, knots, cfg):
    """Smooth random magnitude envelope."""
    b, c, i, s = x.shape
    curve = _random_curve(knots.to(x.device), i * s)
    return (x.reshape(b, c, i * s) * curve).reshape(b, c, i, s)


def aug_phase_shift(x, theta, cfg):
    """Rotate the complex spectrum by one angle theta, on the interleaved
    layout [b, 2c, i, s] with (re, im) channel pairs adjacent."""
    cos_t, sin_t = math.cos(theta), math.sin(theta)
    re, im = x[:, 0::2], x[:, 1::2]
    b, c, i, s = re.shape
    return torch.stack([re * cos_t - im * sin_t, re * sin_t + im * cos_t], dim=2).reshape(
        b, 2 * c, i, s)


def draw_phase_shift(gen, shape, cfg, ctx=None):
    """One uniform angle in (-pi, pi)."""
    return (float(torch.rand((), generator=gen)) - 0.5) * 2.0 * math.pi


def aug_channel_shuffle(x, perm, cfg):
    """Permute the channel axis, same order for the whole batch."""
    return x[:, perm.to(x.device)]


def draw_channel_shuffle(gen, shape, cfg, ctx=None):
    return torch.randperm(shape[1], generator=gen)


def aug_jitter(x, noise, cfg):
    """x + noise: the draw is already scaled by the modality's value range."""
    return x + noise.to(x.device)


def draw_jitter(gen, shape, cfg, ctx):
    """ctx["jitter_std"] * standard normal noise of x's shape (f32)."""
    return torch.tensor(ctx["jitter_std"], dtype=torch.float32) * torch.randn(tuple(shape),
                                                                              generator=gen)


def _zero_run(x, dim, start, width):
    keep = torch.ones(x.shape[dim], dtype=torch.bool, device=x.device)
    keep[start:start + width] = False
    view = [1] * x.dim()
    view[dim] = -1
    return torch.where(keep.view(view), x, 0.0)


def aug_time_mask(x, run, cfg):
    """Zero the intervals [start, start + duration) (axis 2)."""
    return _zero_run(x, 2, *run)


def draw_time_mask(gen, shape, cfg, ctx):
    """(start, duration): duration uniform in [1, ctx["time_mask_max"]],
    start uniform in [0, intervals - duration]."""
    duration = int(torch.randint(1, ctx["time_mask_max"] + 1, (), generator=gen))
    return int(torch.randint(0, shape[2] - duration + 1, (), generator=gen)), duration


def aug_freq_mask(x, band, cfg):
    """Zero the spectrum positions [start, start + width) (axis 3)."""
    return _zero_run(x, 3, *band)


def draw_freq_mask(gen, shape, cfg, ctx):
    """(start, width): width uniform in [1, ctx["freq_mask_max"]], start
    uniform in [0, s - width]."""
    width = int(torch.randint(1, ctx["freq_mask_max"] + 1, (), generator=gen))
    return int(torch.randint(0, shape[3] - width + 1, (), generator=gen)), width


# name -> (draw, apply); None = identity. mixup works on the whole batch
# (one lambda and permutation for every (loc, mod)) and has its own pair.
TIME_AUGMENTERS = {
    "no": None,
    "permutation": (draw_permutation, aug_permutation),
    "scaling": (draw_scaling, aug_scaling),
    "negation": (draw_none, aug_negation),
    "horizontal_flip": (draw_none, aug_horizontal_flip),
    "channel_shuffle": (draw_channel_shuffle, aug_channel_shuffle),
    "jitter": (draw_jitter, aug_jitter),
    "time_warp": (draw_knots, aug_time_warp),
    "mag_warp": (draw_knots, aug_mag_warp),
    "time_mask": (draw_time_mask, aug_time_mask),
    "mixup": None,
}

FREQ_AUGMENTERS = {
    "no": None,
    "freq_mask": (draw_freq_mask, aug_freq_mask),
    "phase_shift": (draw_phase_shift, aug_phase_shift),
}

# Per-dataset max-abs time-domain value ranges that scale jitter's noise
# (the JAX package's table, from the reference's normalize.py)
TIME_VALUE_RANGES = {"MOD": {"audio": 44778.1953125, "seismic": 71805.0}}

_ROW_DRAWS = {draw_jitter}  # draws the size of the batch: a rank keeps its rows


# --------------------------------------------------------------------------
# mixup / cutmix (one lambda and permutation for the batch, a cutmix box per
# modality)


def _beta(gen, a):
    """One Beta(a, a) draw from a numpy generator seeded by ``gen``."""
    seed = int(torch.randint(0, 2**62, (), generator=gen))
    return float(np.random.default_rng(seed).beta(a, a))


def draw_mixup(gen, b, shapes, cfg):
    """The draws of one mixup_batch: {"apply", "cutmix", "lam_mix",
    "lam_cut", "rand_index" [b], "centers" {(loc, mod): (cy, cx)}}, shapes
    {(loc, mod): [b, c, i, s]}. 'batch' mode mixes against the flipped
    batch instead of a random permutation."""
    mode = cfg.get("mode", "random_batch")
    if mode not in ("random_batch", "batch"):
        raise ValueError(f"Unsupported mixup mode: {mode}")
    cutmix_alpha = cfg.get("cutmix_alpha", 0)
    d = {"apply": _gated(gen, cfg["prob"]),
         "cutmix": _gated(gen, cfg["switch_prob"]) and cutmix_alpha > 0,
         "lam_mix": _beta(gen, cfg["mixup_alpha"])}
    d["lam_cut"] = _beta(gen, cutmix_alpha) if cutmix_alpha > 0 else d["lam_mix"]
    d["rand_index"] = (torch.arange(b - 1, -1, -1) if mode == "batch"
                       else torch.randperm(b, generator=gen))
    d["centers"] = {key: (int(torch.randint(0, shp[2], (), generator=gen)),
                          int(torch.randint(0, shp[3], (), generator=gen)))
                    for key, shp in shapes.items()}
    return d


def mixup_lambda(d):
    """The batch's mixing weight: lam_cut or lam_mix when applied, else 1."""
    if not d["apply"]:
        return 1.0
    return d["lam_cut"] if d["cutmix"] else d["lam_mix"]


def _cut_bounds(center, size, ratio):
    """[lo, hi) of one cutmix box side: the cut is int(size * ratio) in f32,
    centred on ``center`` and clipped to [0, size]."""
    cut = int(np.float32(size) * ratio)
    return min(max(center - cut // 2, 0), size), min(max(center + cut // 2, 0), size)


def mixup_batch(loc_inputs, labels, d, cfg, num_classes, rows=None, gather=None):
    """timm-style Mixup/CutMix given draw_mixup's draws ``d`` -> (mixed
    inputs, soft targets [b, num_classes] with label smoothing). Mixup
    blends every sample with its partner rand_index[n] by lambda; cutmix
    copies the partner's box, one box per modality. With ``rows`` the
    inputs and labels are rows lo:hi of the global batch, whose whole
    ``gather`` returns."""
    index = d["rand_index"] if rows is None else d["rand_index"][rows[0]:rows[1]]
    whole = (lambda t: t) if rows is None else gather
    lam = np.float32(mixup_lambda(d))
    ratio = np.sqrt(np.maximum(np.float32(1.0) - lam, np.float32(0.0)))
    out = {}
    for loc, mods in loc_inputs.items():
        out[loc] = {}
        for mod, x in mods.items():
            if not d["apply"]:
                out[loc][mod] = x
                continue
            partner = whole(x)[index.to(x.device)]
            if d["cutmix"]:
                cy, cx = d["centers"][(loc, mod)]
                yl, yh = _cut_bounds(cy, x.shape[2], ratio)
                xl, xh = _cut_bounds(cx, x.shape[3], ratio)
                mixed = x.clone()
                mixed[:, :, yl:yh, xl:xh] = partner[:, :, yl:yh, xl:xh]
            else:
                mixed = float(lam) * x + float(np.float32(1.0) - lam) * partner
            out[loc][mod] = mixed
    smoothing = cfg.get("label_smoothing", 0.0)
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y1 = F.one_hot(labels.long(), num_classes).to(torch.float32) * (on - off) + off
    y2 = (F.one_hot(whole(labels).long(), num_classes).to(torch.float32) * (on - off)
          + off)[index.to(labels.device)]
    return out, y1 * float(lam) + y2 * float(np.float32(1.0) - lam)


class Augmenter:
    """Static pipeline built from the dataset recipe.

    ``no(time_x) -> freq_x`` (FFT only); with a pool, ``random(gen,
    time_x) -> freq_x`` (one augmenter of the pool per call) and
    ``fixed(gen, time_x, labels) -> (freq_x, targets)`` (all of them).
    ``pool`` is a recipe section with ``time_augmenters`` and
    ``freq_augmenters`` (``build_augmenter`` picks it as the JAX package
    does). ``dataset`` names the value-range row of jitter's noise, ``task``
    the class count of mixup's targets."""

    def __init__(self, dataset_config, pool=None, dataset=None, task=None, mixup_labels=False):
        cfgs = dataset_config
        self.modalities = cfgs["modality_names"]
        self.locations = cfgs["location_names"]
        self.time_aug_names = list(pool["time_augmenters"]) if pool else ["no"]
        self.freq_aug_names = list(pool["freq_augmenters"]) if pool else ["no"]
        for name, table in [(n, TIME_AUGMENTERS) for n in self.time_aug_names] + [
                (n, FREQ_AUGMENTERS) for n in self.freq_aug_names]:
            if name not in table:
                raise ValueError(f"Invalid augmenter: {name}")
        self.aug_cfgs = {
            name: cfgs.get(name, {}) for name in set(self.time_aug_names + self.freq_aug_names)
        }
        self.num_classes = cfgs[task]["num_classes"] if task else None
        self.mixup_labels = bool(mixup_labels)
        # static per-(loc, mod) context: mask bounds and jitter's scale
        ranges = TIME_VALUE_RANGES.get(dataset, {})
        jitter_pct = cfgs.get("jitter", {}).get("std_in_percent", 0.2)
        self.ctx = {}
        for loc in self.locations:
            for mod in cfgs["loc_modalities"][loc]:
                if mod not in cfgs["loc_mod_spectrum_len"][loc]:
                    continue
                spectrum_len = cfgs["loc_mod_spectrum_len"][loc][mod]
                self.ctx[(loc, mod)] = {
                    "time_mask_max": max(1, math.floor(
                        cfgs["num_segments"] * cfgs.get("time_mask", {}).get("mask_ratio", 0.3))),
                    "freq_mask_max": max(1, math.floor(
                        spectrum_len * cfgs.get("freq_mask", {}).get("mask_ratio", 0.3))),
                    "jitter_std": ranges.get(mod, 1.0) / 100.0 * jitter_pct,
                }

    rows = None  # (lo, hi, global rows) of a data rank's batches (for_rows)
    gather = None  # a rank's tensor -> the data ranks' whole one, in rank order

    def for_rows(self, rows, gather):
        """This augmenter on a data rank that holds rows lo:hi of each global
        batch of n rows (``rows`` (lo, hi, n)); ``gather`` concatenates the
        data ranks' tensors."""
        view = copy.copy(self)
        view.rows, view.gather = rows, gather
        return view

    def _apply_one(self, name, table, gen, loc_inputs):
        """Apply one named augmenter across all (loc, mod), each gated once."""
        rows = self.rows
        entry = table[name]
        if entry is None:
            return loc_inputs
        draw, apply = entry
        cfg = self.aug_cfgs[name]
        out = {}
        for loc, mods in loc_inputs.items():
            out[loc] = {}
            for mod, x in mods.items():
                if _gated(gen, cfg["prob"]):
                    shape = x.shape if rows is None else (rows[2],) + tuple(x.shape[1:])
                    value = draw(gen, shape, cfg, self.ctx[(loc, mod)])
                    if rows is not None and draw in _ROW_DRAWS:
                        value = value[rows[0]:rows[1]]
                    x = apply(x, value, cfg)
                out[loc][mod] = x
        return out

    def random(self, gen, time_loc_inputs, force_aug_id=None):
        """One random augmenter from the combined pool, in its domain.
        ``force_aug_id`` (an index into the pool, time augmenters first)
        replaces the drawn choice; the draw is still made, so the
        augmenter's own draws come from ``gen`` as they would unforced."""
        n_time = len(self.time_aug_names)
        aug_id = int(torch.randint(0, n_time + len(self.freq_aug_names), (), generator=gen))
        if force_aug_id is not None:
            aug_id = int(force_aug_id)
        x = time_loc_inputs
        if aug_id < n_time:
            x = self._apply_one(self.time_aug_names[aug_id], TIME_AUGMENTERS, gen, x)
        x = fft_preprocess(x)
        if aug_id >= n_time:
            x = self._apply_one(self.freq_aug_names[aug_id - n_time], FREQ_AUGMENTERS, gen, x)
        return x

    def fixed(self, gen, time_loc_inputs, labels):
        """Every time augmenter in order, the FFT, every freq augmenter ->
        (freq_x, targets): the hard labels, or with ``mixup_labels``
        mixup's soft targets [b, num_classes]."""
        x = time_loc_inputs
        soft = None
        for name in self.time_aug_names:
            if name == "mixup":
                shapes = {(loc, m): a.shape for loc, mods in x.items() for m, a in mods.items()}
                b = labels.shape[0] if self.rows is None else self.rows[2]
                d = draw_mixup(gen, b, shapes, self.aug_cfgs["mixup"])
                x, soft = mixup_batch(x, labels, d, self.aug_cfgs["mixup"], self.num_classes,
                                      self.rows, self.gather)
            else:
                x = self._apply_one(name, TIME_AUGMENTERS, gen, x)
        x = fft_preprocess(x)
        for name in self.freq_aug_names:
            x = self._apply_one(name, FREQ_AUGMENTERS, gen, x)
        if self.mixup_labels and soft is not None:
            return x, soft
        return x, labels

    def no(self, time_loc_inputs):
        """FFT only."""
        return fft_preprocess(time_loc_inputs)


def build_augmenter(args):
    """The augmenter of a run, as the JAX package picks its pool: the
    framework's random pool for contrastive pretraining, else the
    backbone's fixed pool (supervised training uses it; finetuning runs
    ``no``)."""
    cfgs = args.dataset_config
    if args.train_mode != "supervised" and args.stage == "pretrain":
        pool = cfgs[args.learn_framework]["random_augmenters"]
        if "mixup" in pool["time_augmenters"]:
            raise ValueError("mixup is label-dependent and not supported in the random (pretrain) pool")
    else:
        pool = cfgs[args.model]["fixed_augmenters"]
    return Augmenter(cfgs, pool, dataset=args.dataset, task=args.task,
                     mixup_labels=getattr(args, "mixup_labels", False))
