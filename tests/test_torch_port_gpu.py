"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests import neither JAX nor the JAX package, so they run on a machine
with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Without a card each test skips. Tolerance 1e-4: kernel and plain version are
both full f32 (TF32 off), so they differ only in summation order.
"""

import numpy as np
import pytest
import torch

from focal_tpu_torch.ops.pallas_kernels import fused_window_block, fused_window_block_reference


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(rng, B, N, C, H, nW, dev):
    """Inputs at a trained model's scale: unit activations, weights of
    std C**-0.5, small biases, so outputs are O(1) and 1e-4 is ~1e3 ulps."""
    shapes = [(B, N, C), (C, 3 * C), (3 * C,), (C, C), (C,), (H, N, N)]
    scales = [1.0, C**-0.5, 0.1, C**-0.5, 0.1, 0.02]
    args = [torch.from_numpy((rng.normal(size=s) * k).astype(np.float32)).to(dev)
            for s, k in zip(shapes, scales)]
    mask = None
    if nW:
        mask = torch.from_numpy(
            np.where(rng.random((nW, N, N)) < 0.3, -100.0, 0.0).astype(np.float32)).to(dev)
    return args + [mask]


# (windows, tokens per window, channels, heads, shift-mask windows or 0):
# the MOD stage widths, a window batch that is not a multiple of the
# windows per block or of nW, and the smallest and largest window.
@pytest.mark.gpu
@pytest.mark.parametrize("B,N,C,H,nW", [
    (512, 9, 64, 4, 64), (509, 9, 128, 4, 16), (511, 9, 256, 4, 0),
    (37, 4, 32, 2, 3), (64, 16, 64, 4, 8),
])
def test_kernel_matches_plain_on_card(B, N, C, H, nW):
    dev = _card()
    args = _args(np.random.default_rng(B + C), B, N, C, H, nW, dev)
    before = fused_window_block.launches
    y = fused_window_block(*args)
    torch.cuda.synchronize()
    assert fused_window_block.launches == before + 1
    ref = fused_window_block_reference(*args)
    assert y.shape == ref.shape and float((y - ref).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_kernel_wrapper_raises_on_cuda_input_it_cannot_take():
    dev = _card()
    args = _args(np.random.default_rng(0), 8, 9, 64, 4, 0, dev)
    with pytest.raises(TypeError):
        fused_window_block(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        fused_window_block(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:])
    with pytest.raises(ValueError):
        fused_window_block(args[0], args[1][:, :96].contiguous(), *args[2:])
    with pytest.raises(ValueError):  # N above the kernel's register tile
        fused_window_block(*_args(np.random.default_rng(1), 2, 17, 64, 4, 0, dev))
