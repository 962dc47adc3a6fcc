"""Hand-written Hopper kernels that replace the JAX package's Pallas kernels.

Named after ``focal_tpu/ops/pallas_kernels.py`` so each kernel sits where a
reader looks for its TPU counterpart. Every kernel has beside it:
  * a plain PyTorch version of the same function (``*_reference``), which
    the wrapper takes only for tensors on the CPU;
  * a launch count on the wrapper (``fused_window_block.launches``), raised
    by one each time the kernel itself is launched.
A CUDA tensor goes to the kernel or the wrapper raises; there is no fallback.
"""

import ctypes

import torch

from focal_tpu_torch.ops import _build

_WINDOW_BLOCK_SRC = "window_block.cu"
_MAX_N = 16  # kMaxN in csrc/window_block.cu


def fused_window_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None):
    """Plain PyTorch whole-block window attention (the math of the JAX
    package's ``_xla_attention`` with the bias and shift mask summed as
    ``expand_bias_lanes`` does). Window w takes mask[w % nW]."""
    B, N, C = x.shape
    H = rel_bias.shape[0]
    hd = C // H
    qkv = torch.matmul(x, wqkv) + bqkv  # [B, N, 3C], q pre-scaled
    qkv = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)  # [3, B, H, N, hd]
    q, k, v = qkv[0], qkv[1], qkv[2]
    scores = torch.matmul(q, k.transpose(-1, -2)) + rel_bias[None]
    if mask is not None:
        idx = torch.arange(B, device=x.device) % mask.shape[0]
        scores = scores + mask[idx][:, None]
    attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
    return torch.matmul(out, wproj) + bproj


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"fused_window_block: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_window_block: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"fused_window_block: {name} is on {t.device}, x on {device}")
    if not t.is_contiguous():
        raise ValueError(f"fused_window_block: {name} must be contiguous")


def fused_window_block(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None):
    """proj(softmax(q k^T + rel_bias + mask) v) over windows, with the qkv
    projection, attention and output projection fused in one kernel.

    x: [B_, N, C] f32; wqkv: [C, 3C] (column order part|head|dim, q columns
    pre-scaled by hd**-0.5); bqkv: [3C]; wproj: [C, C]; bproj: [C];
    rel_bias: [H, N, N]; mask: [nW, N, N] or None (window w takes
    mask[w % nW], windows sample-major as window_partition emits them).
    Returns [B_, N, C] f32.

    Replaces focal_tpu/ops/pallas_kernels.py::fused_window_block (forward,
    seed=None). CPU tensors take the plain version; CUDA tensors launch
    csrc/window_block.cu.
    """
    if x.device.type == "cpu":
        return fused_window_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask)
    if x.device.type != "cuda":
        raise ValueError(f"fused_window_block: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"fused_window_block: x must be [B_, N, C], got {tuple(x.shape)}")
    B, N, C = x.shape
    H = rel_bias.shape[0]
    if not 1 <= N <= _MAX_N or C % 4 or C % H:
        raise ValueError(f"fused_window_block: unsupported geometry N={N} C={C} H={H}")
    dev = x.device
    _check("x", x, (B, N, C), dev)
    _check("wqkv", wqkv, (C, 3 * C), dev)
    _check("bqkv", bqkv, (3 * C,), dev)
    _check("wproj", wproj, (C, C), dev)
    _check("bproj", bproj, (C,), dev)
    _check("rel_bias", rel_bias, (H, N, N), dev)
    nW = 1
    if mask is not None:
        nW = mask.shape[0]
        _check("mask", mask, (nW, N, N), dev)
    if x.data_ptr() % 16:
        raise ValueError("fused_window_block: x must be 16-byte aligned")
    y = torch.empty_like(x)
    lib = _window_block_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.focal_wblock_fwd(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
            bproj.data_ptr(), rel_bias.data_ptr(),
            None if mask is None else mask.data_ptr(), y.data_ptr(),
            B, N, C, H, nW, stream,
        )
    if err != 0:
        msg = lib.focal_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_window_block launch failed ({err}): {msg}")
    fused_window_block.launches += 1
    return y


fused_window_block.launches = 0


def _window_block_lib():
    lib = _build.load(_WINDOW_BLOCK_SRC)
    fn = lib.focal_wblock_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * 8 + [ctypes.c_int] * 5 + [p]
        fn.restype = ctypes.c_int
        lib.focal_cuda_error_string.argtypes = [ctypes.c_int]
        lib.focal_cuda_error_string.restype = ctypes.c_char_p
    return lib
