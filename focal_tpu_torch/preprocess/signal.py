"""Signal-processing primitives for offline sample extraction (the port's
copy of the JAX package's ``data/preprocess/signal.py``, the same numpy
operations).

Vectorised numpy counterparts of the reference's per-interval python loops
(reference: src/data_preprocess/MOD/extract_samples.py:66-171). Layout parity:
time samples are [c, i, s]; frequency samples interleave per-channel
real/imag as [c0_re, c0_im, c1_re, c1_im, ...] exactly like the on-device FFT
(focal_tpu_torch.ops.fft).
"""

import math

import numpy as np


def _sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width=6, rolloff=0.99):
    """Polyphase hann-windowed-sinc kernel, one row per output phase.

    This is torchaudio's published bandlimited-sinc interpolation algorithm
    (torchaudio.transforms.Resample defaults: sinc_interp_hann,
    lowpass_filter_width=6, rolloff=0.99), which the reference applies at
    extract_samples.py:107-126 with dtype=float (float64). Each row p holds
    F(u) = sinc(pi*base*u) * hann(base*u) * base/orig sampled at
    u = (k - width)/orig - p/new, so output sample m*new + p is the dot of
    row p with input samples starting at m*orig - width.

    Returns (kernel [new_freq, taps] float64, width).
    """
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = -np.arange(new_freq, dtype=np.float64)[:, None] / new_freq + idx[None, :]
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t_pi = t * np.pi
    kernel = np.where(t_pi == 0.0, 1.0, np.sin(t_pi) / np.where(t_pi == 0.0, 1.0, t_pi))
    return kernel * window * (base_freq / orig_freq), width


def resample(x, orig_freq, new_freq, lowpass_filter_width=6, rolloff=0.99):
    """Bandlimited-sinc resampling of [time, channel] data.

    Bit-for-bit the algorithm the reference runs (torchaudio Resample with
    default hann-sinc parameters, float64 kernels; reference:
    extract_samples.py:107-126): pad by (width, width + orig), strided
    polyphase dot products, trim to ceil(new * len / orig).
    """
    g = math.gcd(int(orig_freq), int(new_freq))
    o, n = int(orig_freq) // g, int(new_freq) // g
    if o == n:
        return x
    x = np.asarray(x)
    length = x.shape[0]
    kernel, width = _sinc_resample_kernel(o, n, lowpass_filter_width, rolloff)
    taps = kernel.shape[1]
    xt = x.T.astype(np.float64)  # [c, time]
    padded = np.pad(xt, ((0, 0), (width, width + o)))
    # windows[c, m, k] = padded[c, m*o + k]
    windows = np.lib.stride_tricks.sliding_window_view(padded, taps, axis=1)[:, ::o]
    out = np.einsum("cmk,pk->cmp", windows, kernel)  # [c, m, p]
    out = out.reshape(xt.shape[0], -1)[:, : math.ceil(n * length / o)]
    return out.T.astype(x.dtype, copy=False)


def split_with_overlap(x, overlap_ratio, interval_len=None, num_interval=None):
    """Split [time, c] into complete fixed-length windows with overlap
    (reference: extract_samples.py:66-90). Returns [n, interval_len, c]."""
    assert interval_len is not None or num_interval is not None
    if interval_len is None:
        interval_len = int(len(x) // (1 + (num_interval - 1) * (1 - overlap_ratio)))
    interval_len = int(interval_len)
    step = int((1 - overlap_ratio) * interval_len)
    starts = range(0, len(x) - interval_len + 1, step)
    return np.stack([x[s : s + interval_len] for s in starts])


def extract_time_freq(segment, interval_span, freq):
    """One segment [seg_len*freq, c] -> (time [c,i,s], freq [2c,i,s]).

    Vectorised version of extract_loc_mod_tensor
    (reference: extract_samples.py:129-171).
    """
    intervals = split_with_overlap(segment, 0.0, interval_len=int(interval_span * freq))
    # [i, s, c] -> [c, i, s]
    time = intervals.transpose(2, 0, 1).astype(np.float32)

    spec = np.fft.fft(intervals, axis=1)  # [i, s, c] complex
    c = spec.shape[2]
    interleaved = np.stack([spec.real, spec.imag], axis=3)  # [i, s, c, 2]
    freq_arr = interleaved.transpose(2, 3, 0, 1).reshape(2 * c, *time.shape[1:])
    return time, freq_arr.astype(np.float32)


def segment_recording(data, freq, segment_span, overlap_ratio=0.0):
    """[time, c] -> [n_segments, segment_span*freq, c]."""
    return split_with_overlap(data, overlap_ratio, interval_len=int(segment_span * freq))
