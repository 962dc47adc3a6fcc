"""Dropout of the training path, on explicit generators.

Port of the JAX package's ``ops/dropout.py::remat_dropout``: the mask is an
8-bit threshold compare, so the drop probability is quantized to t/256 with
t = round(rate * 256) (clamped to 1..255), and survivors are scaled by the
REALIZED keep probability, 256 / (256 - t), so E[output] == input exactly.
The JAX version regenerates its mask from the key in the backward; here
autograd saves the boolean mask (one byte per element) instead.

It serves the attention output's ``proj_drop`` and the two MLP dropouts.
Attention dropout itself is in-kernel (``ops.pallas_kernels.window_block``).

``keep_mask`` draws the scale-factor masks of DeepSense: Dropout2d's
[b, C] per (sample, channel), broadcast over intervals and spectrum, and
the GRU's [b, t, 2H] between stacked layers.
"""

import torch


def _threshold(rate):
    """Quantized u8 drop threshold: drop iff bits < t, P(drop) = t/256."""
    return max(1, min(255, round(rate * 256.0)))


def keep_scale(rate):
    """Inverse of the realized keep probability."""
    return 256.0 / (256 - _threshold(rate))


def remat_dropout(x, rate, generator):
    """Inverted dropout: zero with probability ``rate`` (quantized to
    1/256ths), scale survivors by 1/keep. ``generator`` lives on x's device.
    Callers gate rate == 0 and eval mode themselves (identity there)."""
    bits = torch.empty(x.shape, dtype=torch.uint8, device=x.device).random_(0, 256,
                                                                          generator=generator)
    return torch.where(bits >= _threshold(rate), x * keep_scale(rate), 0.0)


def keep_mask(shape, rate, generator):
    """Float mask of ``shape`` on the generator's device: 1 / (1 - rate)
    with probability 1 - rate, else 0 (the JAX package's bernoulli keep
    divided by the keep probability; not quantized)."""
    keep = torch.rand(shape, generator=generator, device=generator.device) < 1.0 - rate
    return keep.to(torch.float32) / (1.0 - rate)


def needs_rng(rng, what):
    """The step's StepRngs, or an error naming what in training needed it."""
    if rng is None:
        raise ValueError(f"{what} in training needs the step's rng (ops.dropout.StepRngs)")
    return rng


class StepRngs:
    """The randomness of one training step: ``host``, a CPU generator for
    scalar draws (augmenter choices, gates, kernel seeds), and ``device``, a
    generator on the model's device for masks.

    Across processes (``train.state.TrainState`` over a plan) ``device``
    differs between data ranks and agrees between the model ranks of one,
    for the masks of what they hold whole; ``split`` differs between every
    two ranks, for the masks of what the model ranks split between them (a
    column-parallel output, a rank's heads), so that they draw one mask
    over the whole tensor, as one process does. In one process it is
    ``device``. ``offset`` and ``split_offset`` are the shard's offsets of
    the kernel seeds (``seed``)."""

    def __init__(self, host, device, split=None, offset=0, split_offset=0):
        self.host = host
        self.device = device
        self.split = device if split is None else split
        self.offset = offset
        self.split_offset = split_offset

    def seed(self, split=False):
        """A fresh 31-bit seed from the host generator (one per dropout
        kernel launch, as the JAX package draws one per block), plus the
        data shard's offset, or with ``split`` the (data, model) shard's."""
        draw = int(torch.randint(0, 2**31 - 1, (1,), generator=self.host))
        return draw + (self.split_offset if split else self.offset)
