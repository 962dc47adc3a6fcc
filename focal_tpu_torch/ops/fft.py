"""Time -> frequency preprocessing.

Same layout as the JAX package's ``ops/fft.py``: full complex FFT over the
last (sample) axis with real/imag interleaved along the channel axis, so
``[b, c, i, s] -> [b, 2c, i, s]`` with channel order
``[c0_re, c0_im, c1_re, c1_im, ...]``, computed in float32. The FFT is a
library call here as it is in the JAX package.
"""

import torch


def fft_mod(x):
    """FFT one modality tensor [b, c, i, s] -> [b, 2c, i, s] (interleaved).

    The input is real, so the full spectrum is an rfft plus its conjugate
    mirror (X[k] = conj(X[s-k])); odd lengths take the complex FFT.
    """
    b, c, i, s = x.shape
    xf = x.to(torch.float32)
    if s % 2 == 0:
        half = torch.fft.rfft(xf, dim=-1)  # [b, c, i, s//2 + 1]
        re, im = half.real, half.imag
        mirror = torch.arange(s // 2 - 1, 0, -1, device=x.device)
        re_full = torch.cat([re, re[..., mirror]], dim=-1)
        im_full = torch.cat([im, -im[..., mirror]], dim=-1)
        out = torch.stack([re_full, im_full], dim=2)  # [b, c, 2, i, s]
    else:
        freq = torch.fft.fft(xf, dim=-1)
        out = torch.stack([freq.real, freq.imag], dim=2)
    return out.reshape(b, 2 * c, i, s)


def fft_preprocess(time_loc_inputs):
    """Apply fft_mod across a {loc: {mod: tensor}} tree."""
    return {
        loc: {mod: fft_mod(x) for mod, x in mods.items()}
        for loc, mods in time_loc_inputs.items()
    }


def ifft_mod(x):
    """Inverse of fft_mod: [b, 2c, i, s] interleaved -> the real signal
    [b, c, i, s] (for tests and signal tooling)."""
    b, c2, i, s = x.shape
    z = x.to(torch.float32).reshape(b, c2 // 2, 2, i, s)
    return torch.fft.ifft(torch.complex(z[:, :, 0], z[:, :, 1]), dim=-1).real
