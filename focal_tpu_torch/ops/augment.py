"""Augmentation pipeline: ``no`` (serving) and ``random`` (pretrain views).

Port of the JAX package's ``ops/augment.py``. Every augmenter is split into
a draw, made on a host ``torch.Generator`` (gate, choice, scale, angle,
permutation, curve knots: a few scalars), and an apply, made with device
tensor ops from those values. So a step moves no random scalar off the
device, and a test can feed the port the very values the JAX package drew.

Semantics, as in the JAX package:
  * the ``random`` pipeline draws ONE augmenter uniformly from the combined
    time+freq pool per view and applies it in its domain (time augmenters
    before the FFT, frequency augmenters after it);
  * each applied augmenter gates once per (loc, mod) per batch with its
    ``prob``, not per sample;
  * time_warp/mag_warp are smooth random curves: knots ~ N(1, magnitude)
    linearly interpolated over the flattened [i*s] time axis.

Ported: the MOD FOCAL pool (permutation, negation, time_warp,
horizontal_flip, mag_warp, scaling; phase_shift) and ``no``. ``fixed``,
``mixup_batch`` and jitter, channel_shuffle, time_mask, freq_mask wait
for the supervised and finetune stages (ROADMAP A4).
"""

import math

import torch

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


def draw_none(gen, shape, cfg):
    return None


def aug_permutation(x, perm, cfg):
    """Permute the interval axis, same order for the whole batch."""
    return x[:, :, perm.to(x.device), :]


def draw_permutation(gen, shape, cfg):
    return torch.randperm(shape[2], generator=gen)


def aug_scaling(x, z, cfg):
    """One N(1, std) scale per (loc, mod): z is the standard-normal draw."""
    return x * (1.0 + cfg["std"] * z)


def draw_scaling(gen, shape, cfg):
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


def draw_knots(gen, shape, cfg):
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


def draw_phase_shift(gen, shape, cfg):
    """One uniform angle in (-pi, pi)."""
    return (float(torch.rand((), generator=gen)) - 0.5) * 2.0 * math.pi


# name -> (draw, apply); None = identity
TIME_AUGMENTERS = {
    "no": None,
    "permutation": (draw_permutation, aug_permutation),
    "scaling": (draw_scaling, aug_scaling),
    "negation": (draw_none, aug_negation),
    "horizontal_flip": (draw_none, aug_horizontal_flip),
    "time_warp": (draw_knots, aug_time_warp),
    "mag_warp": (draw_knots, aug_mag_warp),
}

FREQ_AUGMENTERS = {
    "no": None,
    "phase_shift": (draw_phase_shift, aug_phase_shift),
}

# in the JAX package's pools but not ported yet
_WAITING = {"jitter", "channel_shuffle", "time_mask", "mixup", "freq_mask"}


class Augmenter:
    """Static pipeline built from the dataset recipe.

    ``no(time_x) -> freq_x`` (FFT only) and, with a pool,
    ``random(gen, time_x) -> freq_x``: one augmenter of the pool per call.
    ``pool`` is a recipe section with ``time_augmenters`` and
    ``freq_augmenters`` (``build_augmenter`` picks it as the JAX package
    does)."""

    def __init__(self, dataset_config, pool=None):
        cfgs = dataset_config
        self.modalities = cfgs["modality_names"]
        self.locations = cfgs["location_names"]
        self.time_aug_names = list(pool["time_augmenters"]) if pool else ["no"]
        self.freq_aug_names = list(pool["freq_augmenters"]) if pool else ["no"]
        for name, table in [(n, TIME_AUGMENTERS) for n in self.time_aug_names] + [
                (n, FREQ_AUGMENTERS) for n in self.freq_aug_names]:
            if name in _WAITING:
                raise NotImplementedError(
                    f"augmenter {name} is not ported yet: ROADMAP A4")
            if name not in table:
                raise ValueError(f"Invalid augmenter: {name}")
        self.aug_cfgs = {
            name: cfgs.get(name, {}) for name in set(self.time_aug_names + self.freq_aug_names)
        }

    def _apply_one(self, name, table, gen, loc_inputs):
        """Apply one named augmenter across all (loc, mod), each gated once."""
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
                    x = apply(x, draw(gen, x.shape, cfg), cfg)
                out[loc][mod] = x
        return out

    def random(self, gen, time_loc_inputs):
        """One random augmenter from the combined pool, in its domain."""
        n_time = len(self.time_aug_names)
        aug_id = int(torch.randint(0, n_time + len(self.freq_aug_names), (), generator=gen))
        x = time_loc_inputs
        if aug_id < n_time:
            x = self._apply_one(self.time_aug_names[aug_id], TIME_AUGMENTERS, gen, x)
        x = fft_preprocess(x)
        if aug_id >= n_time:
            x = self._apply_one(self.freq_aug_names[aug_id - n_time], FREQ_AUGMENTERS, gen, x)
        return x

    def no(self, time_loc_inputs):
        """FFT only."""
        return fft_preprocess(time_loc_inputs)


def build_augmenter(args):
    """The augmenter of a run: the framework's random pool for contrastive
    pretraining (the only stage ported so far)."""
    cfgs = args.dataset_config
    if args.train_mode != "supervised" and args.stage == "pretrain":
        return Augmenter(cfgs, cfgs[args.learn_framework]["random_augmenters"])
    raise NotImplementedError("the fixed (supervised/finetune) pool is not ported yet: ROADMAP A4")
