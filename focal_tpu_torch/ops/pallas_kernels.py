"""Hand-written Hopper kernels that replace the JAX package's Pallas kernels.

Named after ``focal_tpu/ops/pallas_kernels.py`` so each kernel sits where a
reader looks for its TPU counterpart. Every kernel has beside it:
  * a plain PyTorch version of the same function (``*_reference``), which
    the wrapper takes only for tensors on the CPU;
  * a launch count on the wrapper (``fused_window_block.launches``), raised
    by one each time the kernel itself is launched.
A CUDA tensor goes to the kernel or the wrapper raises; there is no fallback.

Whole-block kernels (``csrc/window_block.cu``): the qkv projection,
attention and output projection of a window block, as row-tiled
projections over every row of the call (tensor cores, 3xTF32) around an
attention kernel per (window, head):
  #1 ``fused_window_block``: forward;
  #2 ``fused_window_block_dropout``: #1 with attention dropout, returning
     its uint8 keep mask [B_, H, N, N];
  #3 ``fused_window_block_backward``: the VJP of #1 and #2, the same way;
  #4 ``fused_window_block_perhead``: #1 or #2 for the blocks that the JAX
     package's ``wblock_fits`` sends to its per-head kernels;
  #5 ``fused_window_block_perhead_backward``: the VJP of #4.
#1, #2 and #4 (#3 and #5) launch the same CUDA code; each counts its own
launches. ``window_block_forward`` (eval) and ``window_block`` (training,
an autograd pair) route each geometry to #1-#3 or to #4/#5.

The bf16 forms (``-compute_dtype bfloat16``): ``fused_window_block_bf16``
(#1-bf16), ``fused_window_block_dropout_bf16`` (#2-bf16) and
``fused_window_block_backward_bf16`` (#3-bf16) take bf16 x, weights and dy
and give bf16 y and dx, the products on the bf16 tensor cores (the
backward's on ``wgmma``, its attention on #8/#9's ``cp.async`` ring),
rounding where the JAX package's kernel does when it is fed bf16 (see
``fused_window_block_bf16_reference``); ``fused_window_block_perhead_bf16``
(#4-bf16) and ``fused_window_block_perhead_backward_bf16`` (#5-bf16) are
the same for the blocks that ``wblock_fits`` sends to #4/#5, whose JAX
kernels fed bf16 round at the same points. The routes take them for a bf16
x, by ``wblock_fits`` as in f32.

Attention-only kernels (``csrc/window_attention.cu``), the route of the
CLI's ``-no_pallas_block``: softmax(q k^T + bias) v on q, k, v [B_, H, N,
hd], the projections outside:
  #6 ``fused_window_attention``: forward;
  #7 ``fused_window_attention_dropout``: #6 with attention dropout, the mask
     drawn from #2's Philox counters and not stored;
  #8 ``fused_window_attention_backward``: the VJP of #6;
  #9 ``fused_window_attention_dropout_backward``: the VJP of #7, its mask
     drawn again from the seed.
``window_attention_qkv`` is their autograd pair (#6 or #7 forward, #8 or
#9 backward) on the qkv projection's [B_, N, 3C] output, whose gradient
#8/#9 write in that layout; ``window_attention_keep_mask`` writes #7's mask
out for checks. Their bf16 forms, ``fused_window_attention_bf16`` (#6-bf16),
``fused_window_attention_dropout_bf16`` (#7-bf16),
``fused_window_attention_backward_bf16`` (#8-bf16) and
``fused_window_attention_dropout_backward_bf16`` (#9-bf16), take bf16 q, k,
v and g and give bf16 out, dq, dk and dv (f32 drel_bias), the math in f32
between, as the JAX package's kernels fed bf16 compute it (see
``fused_window_attention_bf16_reference``); ``window_attention_qkv`` takes
them for a bf16 qkv.

Multi-process forms (``parallel``): #4-TP ``fused_window_block_tp`` and
#5-TP ``fused_window_block_tp_backward`` run #4/#5's f32 CUDA code on a
tensor-parallel shard's heads, at an inner width D = H hd below C (wqkv [C,
3D], wproj [D, C]), their y and dx partial sums; #4-TP-bf16
``fused_window_block_tp_bf16`` and #5-TP-bf16
``fused_window_block_tp_backward_bf16`` run #4-bf16/#5-bf16's code there
on bf16 rows; ``sharded_window_block_tp`` is their autograd pair with the
sums over the model ranks. The JAX
package's data-parallel wrappers (``sharded_window_block``,
``sharded_window_attention``, ``sharded_fused_mlp``) have no form of their
own: a data rank calls ``window_block``, ``window_attention_qkv`` and the
fused MLP on its rows with its shard's kernel seed (``ops.dropout.StepRngs.
seed``), and the training step sums the weight gradients over ``data``.
"""

import ctypes
import functools

import torch

from focal_tpu_torch.ops import _build

_WINDOW_BLOCK_SRC = "window_block.cu"
_WINDOW_ATTENTION_SRC = "window_attention.cu"
_MAX_N = 16  # kMaxN in csrc/window_block.cu and csrc/window_attention.cu
_MAX_HD = 256  # kMaxHd in csrc/window_attention.cu
_MONO_BWD_BUDGET = 112640  # bytes: the first port's per-window #3 on two blocks an SM
_SMEM_OPTIN = 232448  # bytes of shared memory a block may opt in to on the H100 (sm_90)


def wblock_fits(N, C, H):
    """Whether window size N, width C and H heads go to #1-#3; where not, to
    #4 and #5. The gate is the first port's per-window #3: its shared memory
    for one window, N (8C + 10) + 2 H N^2 floats, against the budget that
    kept two of its blocks on an SM. At N = 9 that is C <= 256 (MOD and
    MOD_WIDE stage 0) to #1-#3 and C = 512, 1024 (MOD_WIDE stages 1, 2) to
    #4/#5, as the JAX package's ``wblock_fits`` routes them. #2/#3 and #4/#5
    now run the same code, so the gate only sorts the launch counts."""
    return 4 * (N * (8 * C + 10) + 2 * H * N * N) <= _MONO_BWD_BUDGET


def wblock_takes(N, C, H, dtype=torch.float32):
    """Whether the whole-block kernels (#1-#5, csrc/window_block.cu), or
    with ``dtype`` bf16 their bf16 forms, take window size N, width C and H
    heads: N <= 16, C a multiple of 4 (the projections stage rows 16 bytes
    at a time; of 8 in bf16) and of H, and one (window, head) pair's rows in
    the backward's attention within a block's shared memory (attn_geo;
    heads up to ~1,500 floats at N = 9). The block's route: where not, it
    takes the attention-only route, as with ``-no_pallas_block``. The JAX
    package runs a whole-block kernel at such widths (C not a multiple of 4
    among them), a difference from it that no packaged recipe meets."""
    mult = _row_multiple(dtype)
    if not 1 <= N <= _MAX_N or C < mult or C % mult or C % H:
        return False
    stride = 4 * ((C // H + 3) // 4) + 4  # a head's row in shared memory (window_rows.cuh)
    return 4 * (4 * N * stride + (2 + H) * N * N) <= _SMEM_OPTIN


def attention_takes(N, hd, dtype=torch.float32):
    """Whether the attention-only kernels (#6-#9, csrc/window_attention.cu),
    or with ``dtype`` bf16 their bf16 forms, take window size N and head
    width hd: N <= 16, hd a multiple of 4 (of 8 in bf16) up to 256 (rows are
    staged 16 bytes at a time; a row's scores stay in registers). Where not,
    the block runs the attention in plain PyTorch between its Linears, as
    the JAX package's XLA route does; the JAX package runs its kernel at such
    widths, a difference from it that no packaged recipe meets."""
    mult = _row_multiple(dtype)
    return 1 <= N <= _MAX_N and hd % mult == 0 and mult <= hd <= _MAX_HD


def _row_multiple(dtype):
    """Elements of ``dtype`` in the 16 bytes the kernels stage rows by: 4
    f32, 8 bf16."""
    return 8 if dtype == torch.bfloat16 else 4


def _keep_threshold(rate):
    """u32 drop threshold: keep iff bits >= rate * 2**32, as the TPU kernel's
    ``jnp.uint32(rate * 4294967296.0)``."""
    return min(int(rate * 4294967296.0), 2**32 - 1)


def fused_window_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None,
                                 keep=None, rate=0.0):
    """Plain PyTorch whole-block window attention (the math of the JAX
    package's ``_xla_attention`` with the bias and shift mask summed as
    ``expand_bias_lanes`` does). Window w takes mask[w % nW]. With ``keep``
    (uint8 [B_, H, N, N]) the attention weights are dropped where keep is 0
    and scaled by 1 / (1 - rate) where it is 1. The attention's rows are D =
    wqkv.shape[1] / 3 wide (wqkv [C, 3D], wproj [D, C]): D = C, or a
    tensor-parallel shard's H heads, whose y is then a partial sum. A bf16 x
    takes fused_window_block_bf16_reference."""
    if x.dtype == torch.bfloat16:
        return fused_window_block_bf16_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep,
                                                 rate)
    B, N, _ = x.shape
    H, D = rel_bias.shape[0], wqkv.shape[1] // 3
    qkv = torch.matmul(x, wqkv) + bqkv  # [B, N, 3D], q pre-scaled
    qkv = qkv.reshape(B, N, 3, H, D // H).permute(2, 0, 3, 1, 4)  # [3, B, H, N, hd]
    out = fused_window_attention_reference(qkv[0], qkv[1], qkv[2], rel_bias, mask, keep, rate)
    return torch.matmul(out.transpose(1, 2).reshape(B, N, D), wproj) + bproj


def fused_window_attention_reference(q, k, v, rel_bias, mask=None, keep=None, rate=0.0):
    """Plain PyTorch window attention, the math of the JAX package's
    ``fused_window_attention``: softmax(q k^T + rel_bias + mask[w % nW]) v
    per (window w, head), q pre-scaled. q, k, v: [B_, H, N, hd]; rel_bias
    [H, N, N]; mask [nW, N, N] or None. With ``keep`` (uint8 [B_, H, N, N])
    the weights are dropped where keep is 0 and scaled by 1 / (1 - rate)
    where it is 1. Returns [B_, H, N, hd]."""
    scores = torch.matmul(q, k.transpose(-1, -2)) + rel_bias[None]
    if mask is not None:
        idx = torch.arange(q.shape[0], device=q.device) % mask.shape[0]
        scores = scores + mask[idx][:, None]
    attn = torch.softmax(scores, dim=-1)
    if keep is not None:
        attn = torch.where(keep.bool(), attn * (1.0 / (1.0 - rate)), 0.0)
    return torch.matmul(attn, v)


def draw_keep_mask(seed, shape, rate, device):
    """The plain version's keep mask: uint8, 1 with probability 1 - rate,
    from torch's generator seeded with ``seed`` (the kernel draws Philox bits
    instead; the two agree in distribution, not bit for bit)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    bits = torch.randint(0, 2**32, shape, generator=gen, device=device, dtype=torch.int64)
    return (bits >= _keep_threshold(rate)).to(torch.uint8)


def fused_window_block_dropout_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep,
                                         rate):
    """Plain version of #2, given its keep mask."""
    return fused_window_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep, rate)


def fused_window_block_backward_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy,
                                          keep=None, rate=0.0):
    """Plain version of #3: autograd through fused_window_block_reference
    with the keep mask applied. Returns (dx, dwqkv, dbqkv, dwproj, dbproj,
    drel_bias). A bf16 x takes fused_window_block_backward_bf16_reference."""
    if x.dtype == torch.bfloat16:
        return fused_window_block_backward_bf16_reference(x, wqkv, bqkv, wproj, bproj, rel_bias,
                                                          mask, dy, keep, rate)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, wqkv, bqkv, wproj, bproj, rel_bias)]
        y = fused_window_block_reference(*leaves, mask, keep, rate)
        return torch.autograd.grad(y, leaves, dy)


def fused_window_block_bf16_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None,
                                      keep=None, rate=0.0, acc=torch.float32):
    """Plain version of #1-bf16 (and of #2-bf16 given its keep mask): the
    rounding points of the JAX package's ``_wblock_fwd_math`` fed bf16 x,
    wqkv and wproj (``focal_tpu/ops/pallas_kernels.py:908-938``). The bf16
    operands are upcast, so each f32 product is exact and only its
    summation order differs from the kernel's: qkv = x Wqkv + bqkv in f32,
    the softmax and dropout in f32, the attention output rounded to bf16,
    y = ao Wproj + bproj rounded to bf16. bqkv, bproj, rel_bias and the
    mask are f32. ``acc`` is the type the f32 steps run in: float64 gives
    an exact reference, its values rounded to f32 where they are rounded to
    bf16. The attention's rows are D = wqkv.shape[1] / 3 wide, as in
    fused_window_block_reference: D = C, or a tensor-parallel shard's heads
    (#4-TP-bf16), whose y is then a partial sum rounded to bf16 once."""
    f32, bf16 = torch.float32, torch.bfloat16
    B, N, _ = x.shape
    qkv = torch.matmul(x.to(acc), wqkv.to(acc)) + bqkv.to(acc)
    q, k, v = _head_views(qkv, rel_bias.shape[0])
    out = fused_window_attention_reference(q, k, v, rel_bias.to(acc),
                                           None if mask is None else mask.to(acc), keep, rate)
    ao = out.transpose(1, 2).reshape(B, N, -1).to(f32).to(bf16).to(acc)
    return (torch.matmul(ao, wproj.to(acc)) + bproj.to(acc)).to(f32).to(bf16)


def fused_window_block_backward_bf16_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy,
                                               keep=None, rate=0.0, acc=torch.float32):
    """Plain version of #3-bf16: the rounding points of the JAX package's
    ``_wblock_bwd_kernel`` fed bf16 (``pk:971-1072``). qkv and g = dy
    Wproj^T recomputed in f32 from the bf16 operands; the attention
    backward in f32 (autograd through fused_window_attention_reference);
    dq, dk, dv rounded to bf16 for dx = dqkv Wqkv^T (stored as bf16) and
    dWqkv = x^T dqkv; the attention output rounded to bf16 for dWproj = ao^T
    dy; dbqkv and d rel_bias from the f32 values, dbproj the f32 sum of dy.
    ``acc`` as fused_window_block_bf16_reference's; at D < C (#5-TP-bf16) dx
    is a partial sum rounded to bf16 once. Returns (dx bf16, dwqkv, dbqkv,
    dwproj, dbproj, drel_bias f32)."""
    f32, bf16 = torch.float32, torch.bfloat16
    B, N, C = x.shape
    D = wqkv.shape[1] // 3
    x, wqkv, bqkv, wproj, dy = (t.detach() for t in (x, wqkv, bqkv, wproj, dy))
    xf, dyf, wq = x.to(acc).reshape(B * N, C), dy.to(acc), wqkv.to(acc)
    g = torch.matmul(dyf, wproj.to(acc).t())
    with torch.enable_grad():
        qkv = (torch.matmul(xf, wq) + bqkv.to(acc)).reshape(B, N, 3 * D).requires_grad_(True)
        rb = rel_bias.detach().to(acc).requires_grad_(True)
        q, k, v = _head_views(qkv, rel_bias.shape[0])
        out = fused_window_attention_reference(q, k, v, rb, None if mask is None else mask.to(acc),
                                               keep, rate)
        ao = out.transpose(1, 2).reshape(B, N, D)
        dqkv, drel_bias = torch.autograd.grad(ao, (qkv, rb), g)
    dqkv = dqkv.reshape(B * N, 3 * D)
    dqkv_b = dqkv.to(f32).to(bf16).to(acc)
    ao_b = ao.detach().reshape(B * N, D).to(f32).to(bf16).to(acc)
    dyf = dyf.reshape(B * N, C)
    dx = torch.matmul(dqkv_b, wq.t()).to(f32).to(bf16).reshape(B, N, C)
    return tuple(t.to(f32) if t.dtype != bf16 else t for t in (
        dx, torch.matmul(xf.t(), dqkv_b), dqkv.sum(0), torch.matmul(ao_b.t(), dyf), dyf.sum(0),
        drel_bias))


def _check(name, t, shape, device, dtype=torch.float32, who="fused_window_block"):
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check_block_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dtype=torch.float32):
    """Validate the CUDA path's inputs, x, wqkv and wproj of ``dtype`` (f32,
    or bf16 for the bf16 forms, whose rows are staged 8 values at a time: C
    and D multiples of 8); returns (B, N, C, D, H, nW). The attention's rows
    are D = wqkv.shape[1] / 3 wide: D = C, or a tensor-parallel shard's H
    heads (#4-TP, #5-TP and their bf16 forms: wqkv [C, 3D], wproj [D, C])."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_window_block: unsupported device {x.device}")
    if x.dim() != 3 or wqkv.dim() != 2:
        raise ValueError(f"fused_window_block: x must be [B_, N, C], got {tuple(x.shape)}")
    B, N, C = x.shape
    H, D = rel_bias.shape[0], wqkv.shape[1] // 3
    mult = _row_multiple(dtype)
    if not 1 <= N <= _MAX_N or C % mult or D < mult or D % mult or D % H:
        raise ValueError(f"fused_window_block: unsupported geometry N={N} C={C} D={D} H={H} "
                         f"({dtype})")
    dev = x.device
    _check("x", x, (B, N, C), dev, dtype)
    _check("wqkv", wqkv, (C, 3 * D), dev, dtype)
    _check("bqkv", bqkv, (3 * D,), dev)
    _check("wproj", wproj, (D, C), dev, dtype)
    _check("bproj", bproj, (C,), dev)
    _check("rel_bias", rel_bias, (H, N, N), dev)
    nW = 1
    if mask is not None:
        nW = mask.shape[0]
        _check("mask", mask, (nW, N, N), dev)
    if x.data_ptr() % 16:
        raise ValueError("fused_window_block: x must be 16-byte aligned")
    return B, N, C, D, H, nW


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, fn, dev, *args, lib=None):
    """Run one C entry point on the current stream of ``dev``, with ``dev``
    the current device; raise on error (``lib``, the library of ``fn``,
    names it: window_block.cu's by default)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        msg = (lib or _window_block_lib()).focal_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed ({err}): {msg}")


def fused_window_block(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None):
    """proj(softmax(q k^T + rel_bias + mask) v) over windows (#1): the qkv
    projection, the attention and the output projection.

    x: [B_, N, C] f32; wqkv: [C, 3C] (column order part|head|dim, q columns
    pre-scaled by hd**-0.5); bqkv: [3C]; wproj: [C, C]; bproj: [C];
    rel_bias: [H, N, N]; mask: [nW, N, N] or None (window w takes
    mask[w % nW], windows sample-major as window_partition emits them).
    Returns [B_, N, C] f32.

    On the card it is #2 at rate 0: qkv = x Wqkv + bqkv over all B_ N rows
    of the call, the attention per (window, head) pair, y = ao Wproj +
    bproj, the projections on the tensor cores (3xTF32, f32-accurate); x,
    wqkv and wproj must be 16-byte aligned.

    Replaces focal_tpu/ops/pallas_kernels.py::fused_window_block (forward,
    seed=None). CPU tensors take the plain version; CUDA tensors launch
    csrc/window_block.cu.
    """
    if x.device.type == "cpu":
        return fused_window_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask)
    y, _ = _launch_forward("fused_window_block", x, wqkv, bqkv, wproj, bproj, rel_bias, mask, 0,
                           0.0)
    fused_window_block.launches += 1
    return y


fused_window_block.launches = 0


def fused_window_block_dropout(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, seed, rate):
    """#1 with attention dropout (#2): each (window, head, query, key)
    weight is kept with probability 1 - rate (a u32 threshold of
    rate * 2**32, as the TPU kernel draws it) and scaled by 1 / (1 - rate).
    ``seed`` (an int) keys the kernel's Philox generator, counted by
    (window, head, row): the same seed gives the same mask.

    Returns (y [B_, N, C] f32, keep uint8 [B_, H, N, N]); the backward (#3)
    takes the keep mask back, as the TPU kernel stores its own.

    On the card: qkv = x Wqkv + bqkv over all B_ N rows of the call, the
    attention per (window, head) pair, y = ao Wproj + bproj, the
    projections on the tensor cores (3xTF32, f32-accurate); x, wqkv and
    wproj must be 16-byte aligned.

    Replaces focal_tpu/ops/pallas_kernels.py::fused_window_block_dropout
    (_wblock_fwd_impl with rate > 0). On the CPU the keep mask comes from
    draw_keep_mask and y from the plain version.
    """
    if not 0.0 < rate < 1.0:
        raise ValueError(f"fused_window_block_dropout: rate must be in (0, 1), got {rate}")
    if x.device.type == "cpu":
        B, N, _ = x.shape
        keep = draw_keep_mask(seed, (B, rel_bias.shape[0], N, N), rate, x.device)
        y = fused_window_block_dropout_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                                                 keep, rate)
        return y, keep
    y, keep = _launch_forward("fused_window_block_dropout", x, wqkv, bqkv, wproj, bproj, rel_bias,
                              mask, seed, rate)
    fused_window_block_dropout.launches += 1
    return y, keep


fused_window_block_dropout.launches = 0


def fused_window_block_backward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy, keep=None,
                                rate=0.0, wqkv_t=None, wproj_t=None):
    """VJP of #1 (keep None) or #2 (its keep mask and rate) (#3): recomputes
    qkv and the softmax from x, as the TPU kernel does, and returns
    (dx [B_, N, C], dwqkv [C, 3C], dbqkv [3C], dwproj [C, C], dbproj [C],
    drel_bias [H, N, N]). The weight and bias-table gradients are sums over
    every window, taken in a fixed order: two calls give the same bits.

    The kernel reads wqkv and wproj transposed as well (dx and d(attention
    output) are products with them). ``wqkv_t`` [3C, C] and ``wproj_t``
    [C, C] pass those in, as nn.Linear stores its weights; without them the
    wrapper makes a transposed copy of each.

    On the card: qkv and g = dy Wproj^T recomputed over all B_ N rows, the
    attention backward per (window, head) pair, dx = dqkv Wqkv^T, and the
    weight gradients as fixed row-split partials, every product on the
    tensor cores (3xTF32); x, dy and the weights must be 16-byte aligned.

    Replaces focal_tpu/ops/pallas_kernels.py::_wblock_bwd_impl
    (_wblock_bwd_kernel). CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return fused_window_block_backward_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                                                     dy, keep, rate)
    grads = _launch_backward("fused_window_block_backward", x, wqkv, bqkv, wproj, bproj,
                             rel_bias, mask, dy, keep, rate, wqkv_t, wproj_t)
    fused_window_block_backward.launches += 1
    return grads


fused_window_block_backward.launches = 0


def _check_aligned(name, *operands):
    """The projections copy their operands into shared memory 16 bytes at a
    time: each must be 16-byte aligned."""
    for t in operands:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def _workspace(name, lib, fn, dev, *geometry):
    """A workspace of the floats the C entry point ``fn`` asks for this
    geometry (its launch plan); raises if it has none."""
    floats = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        err = fn(*geometry, ctypes.byref(floats))
    if err != 0:
        msg = lib.focal_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: no launch plan ({err}): {msg}")
    return torch.empty(floats.value, dtype=torch.float32, device=dev)


def _launch_forward(name, x, wqkv, bqkv, wproj, bproj, rel_bias, mask, seed, rate, bf16=False):
    """The CUDA path of #1, #2 and #4 (with ``bf16``, #1-bf16, #2-bf16 and
    #4-bf16, whose workspace comes from focal_wblock_fwd_workspace_bf16;
    #4-TP and #4-TP-bf16 at D < C):
    validate, size the workspace, launch. Returns (y, keep), keep None at
    rate 0."""
    B, N, C, D, H, nW = _check_block_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                                          torch.bfloat16 if bf16 else torch.float32)
    _check_aligned(name, wqkv, wproj)
    lib = _window_block_lib()
    y = torch.empty_like(x)
    keep = torch.empty((B, H, N, N), dtype=torch.uint8, device=x.device) if rate > 0.0 else None
    ptrs = (x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            rel_bias.data_ptr(), _ptr(mask), y.data_ptr(), _ptr(keep))
    dropout = (int(seed) % 2**64, _keep_threshold(rate) if rate > 0.0 else 0, 1.0 / (1.0 - rate))
    if bf16:
        ws = _workspace(name, lib, lib.focal_wblock_fwd_workspace_bf16, x.device, B, N, C, D, H,
                        int(rate > 0.0))
        _launch(name, lib.focal_wblock_fwd_bf16, x.device, *ptrs, ws.data_ptr(), B, N, C, D, H,
                nW, *dropout)
    else:
        ws = _workspace(name, lib, lib.focal_wblock_fwd_workspace, x.device, B, N, C, D, H)
        _launch(name, lib.focal_wblock_fwd_dropout, x.device, *ptrs, ws.data_ptr(), B, N, C, D, H,
                nW, *dropout)
    return y, keep


def _backward_args(name, x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy, keep, rate, dtype):
    """Validate the backward's inputs (#3 and #5, or their bf16 forms);
    returns (B, N, C, D, H, nW)."""
    B, N, C, D, H, nW = _check_block_args(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dtype)
    _check("dy", dy, (B, N, C), x.device, dtype)
    if keep is not None:
        if not 0.0 < rate < 1.0:
            raise ValueError(f"{name}: rate must be in (0, 1), got {rate}")
        _check("keep", keep, (B, H, N, N), x.device, torch.uint8)
    return B, N, C, D, H, nW


def _split_grads(dweights, C, D):
    """(dwqkv [C, 3D], dbqkv, dwproj [D, C], dbproj): views of the flat
    weight gradients."""
    q = 3 * C * D
    return (dweights[:q].view(C, 3 * D), dweights[q:q + 3 * D],
            dweights[q + 3 * D:q + 3 * D + D * C].view(D, C), dweights[q + 3 * D + D * C:])


def _launch_backward(name, x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy, keep, rate, wqkv_t,
                     wproj_t):
    """The CUDA path of #3 and #5: validate, size the workspace, launch, and
    split the flat weight gradients."""
    B, N, C, D, H, nW = _backward_args(name, x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy,
                                       keep, rate, torch.float32)
    dev = x.device
    if wqkv_t is None:
        wqkv_t = wqkv.t().contiguous()
    if wproj_t is None:
        wproj_t = wproj.t().contiguous()
    _check("wqkv_t", wqkv_t, (3 * D, C), dev)
    _check("wproj_t", wproj_t, (C, D), dev)
    _check_aligned(name, wqkv, wqkv_t, wproj_t, dy)
    lib = _window_block_lib()
    ws = _workspace(name, lib, lib.focal_wblock_bwd_workspace, dev, B, N, C, D, H,
                    int(keep is not None))
    dx = torch.empty_like(x)
    dweights = torch.empty(4 * C * D + 3 * D + C, dtype=torch.float32, device=dev)
    drel_bias = torch.empty((H, N, N), dtype=torch.float32, device=dev)
    inv_keep = 1.0 / (1.0 - rate) if keep is not None else 1.0
    _launch(name, lib.focal_wblock_bwd, dev,
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wqkv_t.data_ptr(), wproj_t.data_ptr(),
            rel_bias.data_ptr(), _ptr(mask), dy.data_ptr(), _ptr(keep), inv_keep,
            dx.data_ptr(), dweights.data_ptr(), drel_bias.data_ptr(), ws.data_ptr(),
            B, N, C, D, H, nW)
    return (dx, *_split_grads(dweights, C, D), drel_bias)


def _launch_backward_bf16(name, x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy, keep, rate):
    """The CUDA path of #3-bf16, #5-bf16 and #5-TP-bf16: validate, size the workspace
    (focal_wblock_bwd_workspace_bf16), launch, and split the flat weight
    gradients. The kernels read wqkv and wproj as they lie (TMA), so every
    operand must be 16-byte aligned."""
    B, N, C, D, H, nW = _backward_args(name, x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy,
                                       keep, rate, torch.bfloat16)
    dev = x.device
    _check_aligned(name, wqkv, wproj, dy)
    lib = _window_block_lib()
    ws = _workspace(name, lib, lib.focal_wblock_bwd_workspace_bf16, dev, B, N, C, D, H,
                    int(keep is not None))
    dx = torch.empty_like(x)
    dweights = torch.empty(4 * C * D + 3 * D + C, dtype=torch.float32, device=dev)
    drel_bias = torch.empty((H, N, N), dtype=torch.float32, device=dev)
    inv_keep = 1.0 / (1.0 - rate) if keep is not None else 1.0
    _launch(name, lib.focal_wblock_bwd_bf16, dev,
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(), rel_bias.data_ptr(),
            _ptr(mask), dy.data_ptr(), _ptr(keep), inv_keep, dx.data_ptr(), dweights.data_ptr(),
            drel_bias.data_ptr(), ws.data_ptr(), B, N, C, D, H, nW)
    return (dx, *_split_grads(dweights, C, D), drel_bias)


def fused_window_block_perhead(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None, seed=0,
                               rate=0.0):
    """The function of #1 (rate 0) or #2 (rate > 0) for the blocks that
    ``wblock_fits`` sends away from them (#4), computed as #2 computes it:
    the qkv projection over all B_ N rows of the call, the attention per
    (window, head) pair, the output projection, the projections on the
    tensor cores (3xTF32, f32-accurate). Arguments as
    fused_window_block_dropout; with rate > 0 #2 and #4 give the same mask
    for the same seed and geometry.

    Returns (y [B_, N, C] f32, keep uint8 [B_, H, N, N], or None at rate 0).

    Replaces focal_tpu/ops/pallas_kernels.py::_wblock_ph_fwd_impl
    (_wblock_ph_fwd_kernel). CPU tensors take the plain version, with
    draw_keep_mask's mask at rate > 0.
    """
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_window_block_perhead: rate must be in [0, 1), got {rate}")
    if x.device.type == "cpu":
        keep = None
        if rate > 0.0:
            B, N, _ = x.shape
            keep = draw_keep_mask(seed, (B, rel_bias.shape[0], N, N), rate, x.device)
        return fused_window_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep,
                                            rate), keep
    y, keep = _launch_forward("fused_window_block_perhead", x, wqkv, bqkv, wproj, bproj, rel_bias,
                              mask, seed, rate)
    fused_window_block_perhead.launches += 1
    return y, keep


fused_window_block_perhead.launches = 0


def fused_window_block_perhead_backward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy,
                                        keep=None, rate=0.0, wqkv_t=None, wproj_t=None):
    """VJP of #4 (#5), computed as #3 computes it: fused_window_block_backward's
    arguments and results; ``keep`` is #4's mask. The projections (qkv and
    g = dy Wproj^T recomputed, dx) and the weight gradients are row-tiled
    tensor-core products (3xTF32); the weight and bias-table gradients are
    fixed-order split sums: two calls give the same bits.

    Replaces focal_tpu/ops/pallas_kernels.py::_wblock_ph_bwd_impl
    (_wblock_ph_bwd_kernel). CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return fused_window_block_backward_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                                                     dy, keep, rate)
    grads = _launch_backward("fused_window_block_perhead_backward", x, wqkv, bqkv, wproj, bproj,
                             rel_bias, mask, dy, keep, rate, wqkv_t, wproj_t)
    fused_window_block_perhead_backward.launches += 1
    return grads


fused_window_block_perhead_backward.launches = 0


def tf32_round(t):
    """``t`` (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest on the low 13 mantissa bits, ties away from zero, those bits
    then clear (an f32 with 11 significant bits)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def gemm_3xtf32_reference(a, b, passes=3):
    """Plain emulation of the training kernels' tensor-core product (csrc/
    gemm_3xtf32.cuh): a = a_hi + a_lo, b = b_hi + b_lo, each part rounded to
    TF32, and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi in f32. ``passes=1``
    is one TF32 product, a_hi b_hi alone."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def gemm_3xtf32(a, b, transpose_a=False):
    """a b (a [M, K]), or a^T b (a [K, M]) with ``transpose_a``, by the
    tensor-core product core of #2-#5 alone: the projections' kernel, or
    with ``transpose_a`` the weight gradients' (one split), f32 [K, N] b.
    For the checks; the training wrappers launch it themselves. CPU tensors
    take gemm_3xtf32_reference."""
    if a.device.type == "cpu":
        return gemm_3xtf32_reference(a.t() if transpose_a else a, b)
    K, M = a.shape if transpose_a else a.shape[::-1]
    N = b.shape[1]
    for name, t, shape in (("a", a, tuple(a.shape)), ("b", b, (K, N))):
        _check(name, t, shape, a.device, who="gemm_3xtf32")
        if t.data_ptr() % 16:
            raise ValueError(f"gemm_3xtf32: {name} must be 16-byte aligned")
    c = torch.empty(M * N + (N if transpose_a else 0), dtype=torch.float32, device=a.device)
    _launch("gemm_3xtf32", _window_block_lib().focal_gemm_3xtf32, a.device, a.data_ptr(),
            b.data_ptr(), c.data_ptr(), M, N, K, int(transpose_a))
    gemm_3xtf32.launches += 1
    return c[:M * N].view(M, N)


gemm_3xtf32.launches = 0


def window_block_forward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None):
    """The eval forward, routed: #1 where ``wblock_fits``, else #4 at rate 0;
    a bf16 x takes #1-bf16 or #4-bf16 alike (its weights rounded to bf16
    where they come in f32). Arguments and result as fused_window_block."""
    fits = wblock_fits(x.shape[1], x.shape[2], rel_bias.shape[0])
    if x.dtype == torch.bfloat16:
        wq, wp = wqkv.to(x.dtype), wproj.to(x.dtype)
        if fits:
            return fused_window_block_bf16(x, wq, bqkv, wp, bproj, rel_bias, mask)
        return fused_window_block_perhead_bf16(x, wq, bqkv, wp, bproj, rel_bias, mask)[0]
    if fits:
        return fused_window_block(x, wqkv, bqkv, wproj, bproj, rel_bias, mask)
    return fused_window_block_perhead(x, wqkv, bqkv, wproj, bproj, rel_bias, mask)[0]


class _WindowBlock(torch.autograd.Function):
    """#2 (or #1 at rate 0) forward and #3 backward where ``wblock_fits``,
    else #4 forward and #5 backward, with the keep mask as the saved
    residual."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, rel_bias, mask, seed, rate, wqkv_t, wproj_t):
        keep = None
        ctx.mono = wblock_fits(x.shape[1], x.shape[2], rel_bias.shape[0])
        if not ctx.mono:
            y, keep = fused_window_block_perhead(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                                                 seed, rate)
        elif rate > 0.0:
            y, keep = fused_window_block_dropout(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                                                 seed, rate)
        else:
            y = fused_window_block(x, wqkv, bqkv, wproj, bproj, rel_bias, mask)
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep, wqkv_t, wproj_t)
        ctx.rate = rate
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep, wqkv_t, wproj_t = ctx.saved_tensors
        backward = (fused_window_block_backward if ctx.mono
                    else fused_window_block_perhead_backward)
        grads = backward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy.contiguous(), keep,
                         ctx.rate, wqkv_t, wproj_t)
        # wqkv_t and wproj_t are wqkv and wproj in another layout: their
        # gradient reaches the parameters through wqkv and wproj
        return (*grads, None, None, None, None, None)


def window_block(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None, seed=0, rate=0.0,
                 wqkv_t=None, wproj_t=None):
    """Differentiable whole-block window attention for training: forward by
    #2 (rate > 0) or #1 and backward by #3 where ``wblock_fits``, else
    forward by #4 and backward by #5; gradients in x, wqkv, bqkv, wproj,
    bproj and rel_bias. ``wqkv_t`` and ``wproj_t``, when given, are the same
    weights transposed, which #3 and #5 read (see
    fused_window_block_backward). A bf16 x takes #2-bf16 (or #1-bf16) and
    #3-bf16, or #4-bf16 and #5-bf16, by the same gate (``_WindowBlockBf16``:
    f32 weights rounded inside, their gradients f32; its backward reads the
    weights as they lie, so the transposed ones go unread)."""
    if x.dtype == torch.bfloat16:
        return _WindowBlockBf16.apply(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, seed,
                                      float(rate), False)
    return _WindowBlock.apply(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, seed, float(rate),
                              wqkv_t, wproj_t)


def window_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None, seed=0, rate=0.0,
                           wqkv_t=None, wproj_t=None):
    """Plain version of window_block on any device: the keep mask from
    draw_keep_mask, autograd through fused_window_block_reference. It takes
    window_block's arguments so that it can stand in for it; the
    transposed weights go unread. A bf16 x takes the bf16 plain versions
    (``_WindowBlockBf16`` with ``plain``)."""
    if x.dtype == torch.bfloat16:
        return _WindowBlockBf16.apply(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, seed,
                                      float(rate), True)
    keep = None
    if rate > 0.0:
        B, N, _ = x.shape
        keep = draw_keep_mask(seed, (B, rel_bias.shape[0], N, N), rate, x.device)
    return fused_window_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep, rate)


# ---------------------------------------------------------------------------
# the tensor-parallel forms: #4-TP/#5-TP on a shard's heads


def wblock_tp_takes(N, C, H, mp, dtype=torch.float32):
    """Whether #4-TP/#5-TP (with ``dtype`` bf16, #4-TP-bf16/#5-TP-bf16) take
    a block of window size N, width C and H heads split over mp model
    ranks: whole heads a rank (H % mp == 0), the whole block in the kernels'
    reach in that type (``wblock_takes``, whose shared memory depends on the
    head width only) and the shard's width D = C / mp a multiple of 4 (of 8
    in bf16: 16-byte rows). Where not, the block runs the plain attention
    route with whole heads a rank (models/swin.py), as the JAX package falls
    back to XLA there."""
    return (H % mp == 0 and wblock_takes(N, C, H, dtype)
            and (C // mp) % _row_multiple(dtype) == 0)


def fused_window_block_tp(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None, seed=0, rate=0.0):
    """#4 on a tensor-parallel shard's heads (#4-TP): the qkv projection of
    the shard's H heads, their attention and their rows of the output
    projection, a partial y that the sum over the model ranks completes.

    x: [B_, N, C] f32; wqkv: [C, 3D] (the shard's columns of each of q, k
    and v, part|head|dim, q pre-scaled), D = H hd; bqkv: [3D]; wproj: [D, C]
    (the shard's rows); bproj: [C] (zero on every model rank but one, so the
    sum adds it once); rel_bias: [H, N, N], the shard's heads; mask as #4.
    Returns (y [B_, N, C], keep uint8 [B_, H, N, N] or None at rate 0).

    On the card: #4's CUDA code at the inner width D (csrc/window_block.cu,
    wblock_fwd): qkv = x Wqkv + bqkv [R, 3D], the attention per (window,
    head), y = ao Wproj + bproj, the products on the tensor cores (3xTF32).

    Replaces focal_tpu/ops/pallas_kernels.py::_wblock_ph_fwd_impl with
    head_dim, inside sharded_window_block_tp. CPU tensors take the plain
    version, with draw_keep_mask's mask at rate > 0.
    """
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_window_block_tp: rate must be in [0, 1), got {rate}")
    if x.device.type == "cpu":
        keep = None
        if rate > 0.0:
            B, N, _ = x.shape
            keep = draw_keep_mask(seed, (B, rel_bias.shape[0], N, N), rate, x.device)
        return fused_window_block_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep,
                                            rate), keep
    y, keep = _launch_forward("fused_window_block_tp", x, wqkv, bqkv, wproj, bproj, rel_bias,
                              mask, seed, rate)
    fused_window_block_tp.launches += 1
    return y, keep


fused_window_block_tp.launches = 0


def fused_window_block_tp_backward(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy, keep=None,
                                   rate=0.0, wqkv_t=None, wproj_t=None):
    """VJP of #4-TP (#5-TP): fused_window_block_backward's arguments at the
    shard's geometry (wqkv_t [3D, C], wproj_t [C, D]). Returns (dx [B_, N,
    C], a partial sum over the model ranks; dwqkv [C, 3D], dbqkv [3D],
    dwproj [D, C], d rel_bias [H, N, N], the shard's own; dbproj [C], the
    same on every model rank), fixed-order sums: two calls give the same
    bits.

    On the card: #5's CUDA code at the inner width D (wblock_bwd).

    Replaces focal_tpu/ops/pallas_kernels.py::_wblock_ph_bwd_impl with
    head_dim, inside sharded_window_block_tp. CPU tensors take the plain
    version.
    """
    if x.device.type == "cpu":
        return fused_window_block_backward_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                                                     dy, keep, rate)
    grads = _launch_backward("fused_window_block_tp_backward", x, wqkv, bqkv, wproj, bproj,
                             rel_bias, mask, dy, keep, rate, wqkv_t, wproj_t)
    fused_window_block_tp_backward.launches += 1
    return grads


fused_window_block_tp_backward.launches = 0


def fused_window_block_tp_bf16(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None, seed=0,
                               rate=0.0):
    """#4-TP in bf16 (#4-TP-bf16): fused_window_block_tp's function on bf16
    x [B_, N, C], wqkv [C, 3D] and wproj [D, C] (D = H hd, the shard's
    heads, a multiple of 8), with f32 bqkv, bproj, rel_bias and mask,
    rounding where #4-bf16 does: qkv in f32, the attention output rounded to
    bf16 once, the partial y = ao Wproj + bproj rounded to bf16 once (the
    TPU kernel casts its f32 output to bf16 before the psum). Returns (y
    bf16 [B_, N, C], keep uint8 [B_, H, N, N] or None at rate 0).

    On the card: #4-bf16's three launches at the inner width D
    (csrc/window_block.cu, wblock_fwd_bf16): qkv [R, 3D] on ``wgmma``, the
    attention on the ``cp.async`` ring, y on ``wgmma`` over K = D.

    Replaces focal_tpu/ops/pallas_kernels.py::_wblock_ph_fwd_impl fed bf16
    with head_dim, inside sharded_window_block_tp. CPU tensors take
    fused_window_block_bf16_reference, with draw_keep_mask's mask at rate >
    0.
    """
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_window_block_tp_bf16: rate must be in [0, 1), got {rate}")
    if x.device.type == "cpu":
        keep = None
        if rate > 0.0:
            B, N, _ = x.shape
            keep = draw_keep_mask(seed, (B, rel_bias.shape[0], N, N), rate, x.device)
        return fused_window_block_bf16_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep,
                                                 rate), keep
    y, keep = _launch_forward("fused_window_block_tp_bf16", x, wqkv, bqkv, wproj, bproj, rel_bias,
                              mask, seed, rate, bf16=True)
    fused_window_block_tp_bf16.launches += 1
    return y, keep


fused_window_block_tp_bf16.launches = 0


def fused_window_block_tp_backward_bf16(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy,
                                        keep=None, rate=0.0):
    """VJP of #4-TP-bf16 (#5-TP-bf16): fused_window_block_backward_bf16's
    arguments and results at the shard's geometry (wqkv [C, 3D], wproj [D,
    C] bf16). dx [B_, N, C] bf16 is a partial sum over the model ranks,
    rounded to bf16 once; dwqkv [C, 3D], dbqkv [3D], dwproj [D, C] and d
    rel_bias [H, N, N] are the shard's own, dbproj [C] the same on every
    model rank, all f32 fixed-order sums: two calls give the same bits.

    On the card: #5-bf16's five launches at the inner width D
    (wblock_bwd_bf16).

    Replaces focal_tpu/ops/pallas_kernels.py::_wblock_ph_bwd_impl fed bf16
    with head_dim, inside sharded_window_block_tp. CPU tensors take
    fused_window_block_backward_bf16_reference.
    """
    if x.device.type == "cpu":
        return fused_window_block_backward_bf16_reference(x, wqkv, bqkv, wproj, bproj, rel_bias,
                                                          mask, dy, keep, rate)
    grads = _launch_backward_bf16("fused_window_block_tp_backward_bf16", x, wqkv, bqkv, wproj,
                                  bproj, rel_bias, mask, dy, keep, rate)
    fused_window_block_tp_backward_bf16.launches += 1
    return grads


fused_window_block_tp_backward_bf16.launches = 0


class _WindowBlockTP(torch.autograd.Function):
    """#4-TP forward and #5-TP backward with the model axis's sums: y and
    dx summed over the model ranks, the weight gradients the shard's own.
    A bf16 x takes #4-TP-bf16 and #5-TP-bf16: the f32 weights rounded to
    bf16 here, so their gradients leave in f32, and each rank's bf16 y and
    dx partials summed in f32 and rounded once (``distributed.all_reduce_``)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, rel_bias, mask, seed, rate, wqkv_t, wproj_t,
                plan):
        bp = bproj if plan.m == 0 else torch.zeros_like(bproj)
        ctx.bf16 = x.dtype == torch.bfloat16
        if ctx.bf16:
            wqkv, wproj = wqkv.to(x.dtype), wproj.to(x.dtype)
            y, keep = fused_window_block_tp_bf16(x, wqkv, bqkv, wproj, bp, rel_bias, mask, seed,
                                                 rate)
        else:
            y, keep = fused_window_block_tp(x, wqkv, bqkv, wproj, bp, rel_bias, mask, seed, rate)
        plan.sum_model_(y)
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bp, rel_bias, mask, keep, wqkv_t, wproj_t)
        ctx.rate, ctx.plan = rate, plan
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wqkv, bqkv, wproj, bp, rel_bias, mask, keep, wqkv_t, wproj_t = ctx.saved_tensors
        if ctx.bf16:
            dx, *dws = fused_window_block_tp_backward_bf16(x, wqkv, bqkv, wproj, bp, rel_bias,
                                                           mask, dy.contiguous(), keep, ctx.rate)
        else:
            dx, *dws = fused_window_block_tp_backward(x, wqkv, bqkv, wproj, bp, rel_bias, mask,
                                                      dy.contiguous(), keep, ctx.rate, wqkv_t,
                                                      wproj_t)
        return (ctx.plan.sum_model_(dx), *dws) + (None,) * 6


def sharded_window_block_tp(plan, x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None, seed=0,
                            rate=0.0, wqkv_t=None, wproj_t=None):
    """Differentiable whole-block window attention on a tensor-parallel
    shard's heads, for training: forward #4-TP, then y summed over the model
    ranks; backward #5-TP on the same dy, dx summed over the model ranks,
    dwqkv, dbqkv, dwproj and d rel_bias left the shard's own, dbproj the
    same on every model rank. ``seed`` is the shard's kernel seed (the
    step's ``StepRngs.seed(split=True)``: a draw + (d mp + m) 1000003, the
    JAX package's for shard (d, m)). Arguments as fused_window_block_tp,
    with bproj whole (the model rank 0 adds it); ``wqkv_t`` and ``wproj_t``
    as window_block's. The weight gradients' sum over the data ranks is the
    training step's.

    Replaces focal_tpu/ops/pallas_kernels.py::sharded_window_block_tp
    (_sharded_wblock_tp_op). On CPU tensors the kernels' plain versions
    run, between the same sums. A bf16 x takes #4-TP-bf16 forward and
    #5-TP-bf16 backward over the f32 weights (rounded inside; the
    transposed ones go unread), y and dx leaving in bf16, as the JAX wrapper
    fed bf16 psums its bf16 partials.
    """
    return _WindowBlockTP.apply(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, seed, float(rate),
                                wqkv_t, wproj_t, plan)


# ---------------------------------------------------------------------------
# the bf16 forms of the whole-block kernels (#1-bf16 to #5-bf16)


def fused_window_block_bf16(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None):
    """#1 in bf16 (#1-bf16): fused_window_block's function on bf16 x [B_, N,
    C], wqkv [C, 3C] (q columns pre-scaled) and wproj [C, C], with f32 bqkv,
    bproj, rel_bias and mask; returns bf16 y. C a multiple of 8.

    On the card, three launches: qkv = x Wqkv + bqkv over all B_ N rows in
    f32 on ``wgmma`` (TMA-fed, the weights read as they lie); the attention
    per (window, head) in f32 on a persistent ``cp.async`` ring, its output
    ao rounded once to bf16; y = ao Wproj + bproj on ``wgmma``, rounded to
    bf16 once after the bias. x, wqkv and wproj 16-byte aligned.

    Replaces focal_tpu/ops/pallas_kernels.py::fused_window_block fed bf16
    (_wblock_fwd_kernel at rate 0). CPU tensors take
    fused_window_block_bf16_reference; CUDA tensors launch
    csrc/window_block.cu's focal_wblock_fwd_bf16.
    """
    if x.device.type == "cpu":
        return fused_window_block_bf16_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask)
    y, _ = _launch_forward("fused_window_block_bf16", x, wqkv, bqkv, wproj, bproj, rel_bias, mask,
                           0, 0.0, bf16=True)
    fused_window_block_bf16.launches += 1
    return y


fused_window_block_bf16.launches = 0


def fused_window_block_dropout_bf16(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, seed, rate):
    """#2 in bf16 (#2-bf16): #1-bf16 with attention dropout, the mask drawn
    as #2 draws it (the same seed and geometry give #2's mask). Returns (y
    bf16, keep uint8 [B_, H, N, N]).

    Replaces focal_tpu/ops/pallas_kernels.py::fused_window_block_dropout fed
    bf16. On the CPU the keep mask comes from draw_keep_mask and y from
    fused_window_block_bf16_reference.
    """
    _check_rate("fused_window_block_dropout_bf16", rate)
    if x.device.type == "cpu":
        B, N, _ = x.shape
        keep = draw_keep_mask(seed, (B, rel_bias.shape[0], N, N), rate, x.device)
        return fused_window_block_bf16_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep,
                                                 rate), keep
    y, keep = _launch_forward("fused_window_block_dropout_bf16", x, wqkv, bqkv, wproj, bproj,
                              rel_bias, mask, seed, rate, bf16=True)
    fused_window_block_dropout_bf16.launches += 1
    return y, keep


fused_window_block_dropout_bf16.launches = 0


def fused_window_block_backward_bf16(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy, keep=None,
                                     rate=0.0):
    """VJP of #1-bf16 or #2-bf16 (#3-bf16): fused_window_block_backward's
    arguments, but no transposed weights, with bf16 x, weights and dy.
    Returns (dx bf16, dwqkv, dbqkv, dwproj, dbproj, drel_bias f32), the
    weight and bias-table gradients fixed-order sums: two calls give the
    same bits.

    On the card, five launches: qkv and g = dy Wproj^T recomputed in f32 on
    ``wgmma`` (the weights read by TMA as they lie); the attention backward
    in f32 on #8/#9's persistent ``cp.async`` ring, dq, dk, dv and the
    attention output rounded once to bf16, dbqkv, dbproj and d rel_bias
    summed in f32 as per-block partials; dx = dqkv Wqkv^T and the weight
    gradients x^T dqkv and ao^T dy on ``wgmma``; one ordered reduction. x,
    dy and the weights 16-byte aligned.

    Replaces focal_tpu/ops/pallas_kernels.py::_wblock_bwd_impl fed bf16
    (_wblock_bwd_kernel). CPU tensors take
    fused_window_block_backward_bf16_reference.
    """
    if x.device.type == "cpu":
        return fused_window_block_backward_bf16_reference(x, wqkv, bqkv, wproj, bproj, rel_bias,
                                                          mask, dy, keep, rate)
    grads = _launch_backward_bf16("fused_window_block_backward_bf16", x, wqkv, bqkv, wproj, bproj,
                                  rel_bias, mask, dy, keep, rate)
    fused_window_block_backward_bf16.launches += 1
    return grads


fused_window_block_backward_bf16.launches = 0


def fused_window_block_perhead_bf16(x, wqkv, bqkv, wproj, bproj, rel_bias, mask=None, seed=0,
                                    rate=0.0):
    """#4 in bf16 (#4-bf16): the function of #1-bf16 (rate 0) or #2-bf16
    (rate > 0) for the blocks that ``wblock_fits`` sends away from them,
    computed as #2-bf16 computes it (the same CUDA code: the products on
    ``wgmma`` over all B_ N rows, the attention per (window, head) in f32 on
    the ``cp.async`` ring, ao rounded to bf16 once before the output
    projection). Arguments as
    fused_window_block_dropout_bf16; returns (y bf16, keep uint8 [B_, H, N,
    N], or None at rate 0), the mask #2's for the same seed and geometry.

    The JAX per-head kernel fed bf16 rounds where the whole-block one does
    (y and dx summed over the heads in f32, then stored as bf16), so its
    plain version is fused_window_block_bf16_reference.

    Replaces focal_tpu/ops/pallas_kernels.py::_wblock_ph_fwd_impl
    (_wblock_ph_fwd_kernel) fed bf16. CPU tensors take the plain version,
    with draw_keep_mask's mask at rate > 0.
    """
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_window_block_perhead_bf16: rate must be in [0, 1), got {rate}")
    if x.device.type == "cpu":
        keep = None
        if rate > 0.0:
            B, N, _ = x.shape
            keep = draw_keep_mask(seed, (B, rel_bias.shape[0], N, N), rate, x.device)
        return fused_window_block_bf16_reference(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, keep,
                                                 rate), keep
    y, keep = _launch_forward("fused_window_block_perhead_bf16", x, wqkv, bqkv, wproj, bproj,
                              rel_bias, mask, seed, rate, bf16=True)
    fused_window_block_perhead_bf16.launches += 1
    return y, keep


fused_window_block_perhead_bf16.launches = 0


def fused_window_block_perhead_backward_bf16(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, dy,
                                             keep=None, rate=0.0):
    """VJP of #4-bf16 (#5-bf16), computed as #3-bf16 computes it:
    fused_window_block_backward_bf16's arguments and results; ``keep`` is
    #4-bf16's mask. Two calls give the same bits.

    Replaces focal_tpu/ops/pallas_kernels.py::_wblock_ph_bwd_impl
    (_wblock_ph_bwd_kernel) fed bf16. CPU tensors take
    fused_window_block_backward_bf16_reference.
    """
    if x.device.type == "cpu":
        return fused_window_block_backward_bf16_reference(x, wqkv, bqkv, wproj, bproj, rel_bias,
                                                          mask, dy, keep, rate)
    grads = _launch_backward_bf16("fused_window_block_perhead_backward_bf16", x, wqkv, bqkv,
                                  wproj, bproj, rel_bias, mask, dy, keep, rate)
    fused_window_block_perhead_backward_bf16.launches += 1
    return grads


fused_window_block_perhead_backward_bf16.launches = 0


class _WindowBlockBf16(torch.autograd.Function):
    """#2-bf16 (or #1-bf16 at rate 0) forward and #3-bf16 backward where
    ``wblock_fits``, else #4-bf16 forward and #5-bf16 backward, or with
    ``plain`` their plain versions (the mask from draw_keep_mask). The
    weights come in f32 and are rounded to bf16 here, so their gradients
    leave in f32 unrounded, as the JAX package's VJP hands them to the f32
    parameters; dx leaves in bf16."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, rel_bias, mask, seed, rate, plain):
        bf16 = torch.bfloat16
        wq, wp = wqkv.to(bf16), wproj.to(bf16)
        keep = None
        ctx.mono = wblock_fits(x.shape[1], x.shape[2], rel_bias.shape[0])
        if plain:
            if rate > 0.0:
                B, N, _ = x.shape
                keep = draw_keep_mask(seed, (B, rel_bias.shape[0], N, N), rate, x.device)
            y = fused_window_block_bf16_reference(x, wq, bqkv, wp, bproj, rel_bias, mask, keep, rate)
        elif not ctx.mono:
            y, keep = fused_window_block_perhead_bf16(x, wq, bqkv, wp, bproj, rel_bias, mask, seed,
                                                      rate)
        elif rate > 0.0:
            y, keep = fused_window_block_dropout_bf16(x, wq, bqkv, wp, bproj, rel_bias, mask, seed,
                                                      rate)
        else:
            y = fused_window_block_bf16(x, wq, bqkv, wp, bproj, rel_bias, mask)
        ctx.save_for_backward(x, wq, bqkv, wp, bproj, rel_bias, mask, keep)
        ctx.rate, ctx.plain = rate, plain
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wq, bqkv, wp, bproj, rel_bias, mask, keep = ctx.saved_tensors
        if ctx.plain:
            grads = fused_window_block_backward_bf16_reference(x, wq, bqkv, wp, bproj, rel_bias,
                                                               mask, dy, keep, ctx.rate)
        else:
            backward = (fused_window_block_backward_bf16 if ctx.mono
                        else fused_window_block_perhead_backward_bf16)
            grads = backward(x, wq, bqkv, wp, bproj, rel_bias, mask, dy.contiguous(), keep,
                             ctx.rate)
        return (*grads, None, None, None, None)


# ---------------------------------------------------------------------------
# the attention-only kernels (#6-#9)


def fused_window_attention_dropout_reference(q, k, v, rel_bias, mask, keep, rate):
    """Plain version of #7, given its keep mask."""
    return fused_window_attention_reference(q, k, v, rel_bias, mask, keep, rate)


def fused_window_attention_backward_reference(q, k, v, rel_bias, mask, g, keep=None, rate=0.0):
    """Plain version of #8 (keep None) and #9: autograd through
    fused_window_attention_reference with the keep mask applied. Returns
    (dq, dk, dv, drel_bias)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, rel_bias)]
        out = fused_window_attention_reference(*leaves, mask, keep, rate)
        return torch.autograd.grad(out, leaves, g)


def _takes_rows(t):
    """Whether the attention kernels read (or write) ``t`` in place: rows of
    hd contiguous elements, 16-byte aligned, every stride a multiple of 16
    bytes (4 f32, 8 bf16)."""
    mult = _row_multiple(t.dtype)
    return (t.stride(-1) == 1 and all(s % mult == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check_rows(who, name, t, shape, device, dtype=torch.float32):
    """A [B_, H, N, hd] operand of ``dtype``: any strides the kernels read
    (``_takes_rows``)."""
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} must be {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, expected {device}")
    if not _takes_rows(t):
        raise ValueError(f"{who}: {name} needs contiguous, 16-byte aligned rows "
                         f"(strides {t.stride()})")


def _check_attention_args(who, q, k, v, rel_bias, mask, *more, dtype=torch.float32):
    """Validate the CUDA path's inputs and the further [B_, H, N, hd]
    operands ``more`` (name, tensor), the row operands of ``dtype`` (f32 for
    #6-#9, bf16 for their bf16 forms), rel_bias and the mask f32; returns
    (B, H, N, hd, nW, the (B_, H, N) element strides of q, k, v and ``more``
    as the C side reads them). One test a row operand on the per-call path;
    _check_rows names what failed."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: unsupported device {dev}")
    if q.dim() != 4:
        raise ValueError(f"{who}: q must be [B_, H, N, hd], got {tuple(q.shape)}")
    shape = q.shape
    B, H, N, hd = shape
    if not attention_takes(N, hd, dtype):
        raise ValueError(f"{who}: unsupported geometry N={N} hd={hd} ({dtype})")
    index, strides, m = dev.index, [], _row_multiple(dtype)
    for name, t in (("q", q), ("k", k), ("v", v), *more):
        st = t.stride()
        if (t.dtype != dtype or t.shape != shape or t.get_device() != index or st[3] != 1
                or st[0] % m or st[1] % m or st[2] % m or t.data_ptr() % 16):
            _check_rows(who, name, t, shape, dev, dtype)
            raise ValueError(f"{who}: {name} cannot be read in place")
        strides += st[:3]
    _check("rel_bias", rel_bias, (H, N, N), dev, who=who)
    nW = 1
    if mask is not None:
        nW = mask.shape[0]
        _check("mask", mask, (nW, N, N), dev, who=who)
    return B, H, N, hd, nW, _stride_array(tuple(strides))


@functools.lru_cache(maxsize=1024)
def _stride_array(strides):
    """A ctypes array of ``strides``, made once: the route calls each
    geometry with the same layouts on every step."""
    return (ctypes.c_longlong * len(strides))(*strides)


def _dropout_args(seed, rate):
    """(dropout flag, seed, u32 threshold, 1 / (1 - rate)) for the C side."""
    if rate > 0.0:
        return 1, int(seed) % 2**64, _keep_threshold(rate), 1.0 / (1.0 - rate)
    return 0, 0, 0, 1.0


def _scaled(q, q_scale):
    """q times ``q_scale`` as the plain versions take it (q itself at 1)."""
    return q if q_scale == 1.0 else q * q_scale


def _into(out, y):
    """``y``, or ``out`` with y written into it."""
    return y if out is None else out.copy_(y)


def _attention_forward(who, q, k, v, rel_bias, mask, seed, rate, q_scale, out,
                       dtype=torch.float32):
    """The CUDA path of #6 and #7, or with ``dtype`` bf16 of #6-bf16 and
    #7-bf16: validate, launch; returns ``out`` (a new contiguous [B_, H, N,
    hd] tensor where it is None)."""
    if out is None:
        out = torch.empty(q.shape, dtype=dtype, device=q.device)
    B, H, N, hd, nW, strides = _check_attention_args(who, q, k, v, rel_bias, mask, ("out", out),
                                                     dtype=dtype)
    lib = _window_attention_lib()
    fn = lib.focal_wattn_fwd_bf16 if dtype == torch.bfloat16 else lib.focal_wattn_fwd
    _launch(who, fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
            _ptr(mask), out.data_ptr(), strides, float(q_scale), B, H, N, hd, nW,
            *_dropout_args(seed, rate), lib=lib)
    return out


def _head_views(qkv, H):
    """q, k, v [B_, H, N, hd] as views of the head columns of a [B_, N, 3C]
    tensor (column order part | head | dim)."""
    B, N, C3 = qkv.shape
    return qkv.view(B, N, 3, H, C3 // (3 * H)).permute(2, 0, 3, 1, 4).unbind(0)


def _heads(y, H):
    """A [B_, N, C] tensor as its [B_, H, N, hd] head view (no copy where y
    is contiguous)."""
    B, N, C = y.shape
    return y.reshape(B, N, H, C // H).transpose(1, 2)


def _attention_backward(who, q, k, v, rel_bias, mask, g, seed, rate, dqkv=None, dq_scale=1.0,
                        q_scale=1.0, dtype=torch.float32):
    """The CUDA path of #8 and #9, or with ``dtype`` bf16 of #8-bf16 and
    #9-bf16: (dq, dk, dv, drel_bias) for q times ``q_scale``, dq (the
    gradient of the scaled q) times ``dq_scale`` (in bf16 both scales
    rounded to bf16, dq to bf16 before its product). With ``dqkv`` (a
    contiguous [B_, N, 3C] tensor of q's device and type) the kernel writes
    dq, dk and dv into its head columns and they are returned as views of
    it."""
    B, H, N, hd, nW, strides = _check_attention_args(who, q, k, v, rel_bias, mask, ("g", g),
                                                     dtype=dtype)
    dev = q.device
    lib = _window_attention_lib()
    bf16 = dtype == torch.bfloat16
    dropout = _dropout_args(seed, rate)
    ws = _workspace(who, lib, lib.focal_wattn_bwd_workspace_bf16 if bf16
                    else lib.focal_wattn_bwd_workspace, dev, B, H, N, hd, dropout[0])
    if dqkv is None:
        outs = [torch.empty((B, H, N, hd), dtype=dtype, device=dev) for _ in range(3)]
    else:
        outs = _head_views(dqkv, H)
    drel_bias = (torch.zeros if B == 0 else torch.empty)((H, N, N), dtype=torch.float32, device=dev)
    fn = lib.focal_wattn_bwd_bf16 if bf16 else lib.focal_wattn_bwd
    _launch(who, fn, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            strides, rel_bias.data_ptr(), _ptr(mask), *(t.data_ptr() for t in outs),
            _stride_array(tuple(s for t in outs for s in t.stride()[:3])), float(q_scale),
            float(dq_scale), drel_bias.data_ptr(), ws.data_ptr(), B, H, N, hd, nW, *dropout,
            lib=lib)
    return (*outs, drel_bias)


def _check_rate(who, rate):
    if not 0.0 < rate < 1.0:
        raise ValueError(f"{who}: rate must be in (0, 1), got {rate}")


def fused_window_attention(q, k, v, rel_bias, mask=None, q_scale=1.0, out=None):
    """softmax(q k^T + rel_bias + mask[w % nW]) v over windows, one kernel
    (#6): q, k, v [B_, H, N, hd] f32 (q pre-scaled by hd**-0.5, or scaled
    by ``q_scale`` in the kernel; any strides whose rows of hd floats are
    contiguous and 16-byte aligned, such as the views of the qkv
    projection), rel_bias [H, N, N], mask [nW, N, N] or None (window w
    takes mask[w % nW]). Returns contiguous [B_, H, N, hd], or ``out``
    written (a [B_, H, N, hd] destination at such strides: the head view of
    the output projection's [B_, N, C] input, which then needs no copy).
    N <= 16 and hd a multiple of 4 up to 256; anything else raises.
    ``q_scale`` rounds as ``q * q_scale`` does: the same bits as the call on
    the scaled q.

    Replaces focal_tpu/ops/pallas_kernels.py::fused_window_attention
    (_attn_fwd_kernel). CPU tensors take the plain version (on q times
    q_scale); CUDA tensors launch csrc/window_attention.cu.
    """
    if q.device.type == "cpu":
        return _into(out, fused_window_attention_reference(_scaled(q, q_scale), k, v, rel_bias,
                                                           mask))
    out = _attention_forward("fused_window_attention", q, k, v, rel_bias, mask, 0, 0.0, q_scale,
                             out)
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0


def fused_window_attention_dropout(q, k, v, rel_bias, mask, seed, rate, q_scale=1.0, out=None):
    """#6 with attention dropout (#7): each (window, head, query, key) weight
    is kept iff its 32 Philox bits are >= rate * 2**32 (#2's counters, keyed
    by ``seed``: #2's mask bit for bit) and scaled by 1 / (1 - rate). No
    mask is stored: the backward (#9) draws it again from the seed, and
    ``window_attention_keep_mask`` writes it out for checks. ``q_scale`` and
    ``out`` as fused_window_attention. Returns [B_, H, N, hd].

    Replaces focal_tpu/ops/pallas_kernels.py::fused_window_attention_dropout
    (_attn_fwd_dropout_kernel). On the CPU the mask comes from
    draw_keep_mask and the output from the plain version.
    """
    _check_rate("fused_window_attention_dropout", rate)
    if q.device.type == "cpu":
        B, H, N, _ = q.shape
        keep = draw_keep_mask(seed, (B, H, N, N), rate, q.device)
        return _into(out, fused_window_attention_dropout_reference(
            _scaled(q, q_scale), k, v, rel_bias, mask, keep, rate))
    out = _attention_forward("fused_window_attention_dropout", q, k, v, rel_bias, mask, seed, rate,
                             q_scale, out)
    fused_window_attention_dropout.launches += 1
    return out


fused_window_attention_dropout.launches = 0


def fused_window_attention_backward(q, k, v, rel_bias, mask, g, seed=None, rate=0.0, q_scale=1.0):
    """VJP of #6 (#8): recomputes the softmax from q and k, as the TPU kernel
    does, and returns (dq, dk, dv [B_, H, N, hd], drel_bias [H, N, N]).
    drel_bias sums the score gradients over every window in a fixed order:
    two calls give the same bits. The mask gets no gradient. With ``seed``
    (and its ``rate``) it is the VJP of #7 instead, which
    fused_window_attention_dropout_backward (#9) computes. ``g`` takes the
    strides q does. With ``q_scale`` q is scaled in the kernel, as the
    forward scales it, and dq is the gradient of the scaled q: the same
    bits as the call on the scaled q.

    Replaces focal_tpu/ops/pallas_kernels.py::_bwd_impl (_attn_bwd_kernel).
    CPU tensors take the plain version.
    """
    if seed is not None:
        return fused_window_attention_dropout_backward(q, k, v, rel_bias, mask, g, seed, rate,
                                                       q_scale)
    if q.device.type == "cpu":
        return fused_window_attention_backward_reference(_scaled(q, q_scale), k, v, rel_bias,
                                                         mask, g)
    grads = _attention_backward("fused_window_attention_backward", q, k, v, rel_bias, mask, g,
                                0, 0.0, q_scale=q_scale)
    fused_window_attention_backward.launches += 1
    return grads


fused_window_attention_backward.launches = 0


def fused_window_attention_dropout_backward(q, k, v, rel_bias, mask, g, seed, rate, q_scale=1.0):
    """VJP of #7 (#9): #8 with #7's mask drawn again from ``seed``; dv takes
    the dropped weights, the score gradients the softmax before dropout.
    Returns (dq, dk, dv, drel_bias), bitwise repeatable; ``q_scale`` as
    fused_window_attention_backward.

    Replaces focal_tpu/ops/pallas_kernels.py::_bwd_impl with a seed
    (_attn_bwd_dropout_kernel). On the CPU the plain version with
    draw_keep_mask's mask, the one the CPU forward drew.
    """
    _check_rate("fused_window_attention_dropout_backward", rate)
    if q.device.type == "cpu":
        B, H, N, _ = q.shape
        keep = draw_keep_mask(seed, (B, H, N, N), rate, q.device)
        return fused_window_attention_backward_reference(_scaled(q, q_scale), k, v, rel_bias,
                                                         mask, g, keep, rate)
    grads = _attention_backward("fused_window_attention_dropout_backward", q, k, v, rel_bias, mask,
                                g, seed, rate, q_scale=q_scale)
    fused_window_attention_dropout_backward.launches += 1
    return grads


fused_window_attention_dropout_backward.launches = 0


# ---------------------------------------------------------------------------
# the bf16 forms of the attention-only kernels (#6-bf16 to #9-bf16)


def scale_bf16(q, q_scale):
    """bf16 q times ``q_scale`` as the JAX package's bf16 ``qkv[0] * scale``
    rounds it (focal_tpu/models/swin.py:270): the scale rounded to bf16,
    then the product (exact in f32) rounded to bf16; q itself at 1."""
    if q_scale == 1.0:
        return q
    return q * torch.tensor(q_scale, dtype=torch.bfloat16, device=q.device)


def fused_window_attention_bf16_reference(q, k, v, rel_bias, mask=None, keep=None, rate=0.0,
                                          q_scale=1.0):
    """Plain version of #6-bf16 (and of #7-bf16 given its keep mask): the
    rounding points of the JAX package's ``_attn_fwd_kernel`` fed bf16
    (``pk:119-137``), which upcasts q, k and v to f32, computes as in f32
    and stores the output in the inputs' type: q (times ``q_scale``, rounded
    as ``scale_bf16``), k and v upcast, fused_window_attention_reference's
    f32 math, the output rounded to bf16 once. rel_bias and the mask f32."""
    f32 = torch.float32
    out = fused_window_attention_reference(scale_bf16(q, q_scale).to(f32), k.to(f32), v.to(f32),
                                           rel_bias, mask, keep, rate)
    return out.to(torch.bfloat16)


def fused_window_attention_backward_bf16_reference(q, k, v, rel_bias, mask, g, keep=None,
                                                   rate=0.0, q_scale=1.0):
    """Plain version of #8-bf16 (keep None) and #9-bf16: the JAX package's
    ``_attn_bwd_kernel`` fed bf16 (``pk:189-210``): q (scaled as in the
    forward), k, v and g upcast, the f32 VJP of
    fused_window_attention_backward_reference, dq, dk and dv rounded to
    bf16, drel_bias f32. dq is the gradient of the scaled q. Returns (dq,
    dk, dv, drel_bias)."""
    f32 = torch.float32
    grads = fused_window_attention_backward_reference(
        scale_bf16(q, q_scale).to(f32), k.to(f32), v.to(f32), rel_bias, mask, g.to(f32), keep,
        rate)
    return (*(t.to(torch.bfloat16) for t in grads[:3]), grads[3])


def fused_window_attention_bf16(q, k, v, rel_bias, mask=None, q_scale=1.0, out=None):
    """#6 in bf16 (#6-bf16): fused_window_attention's function on bf16 q, k,
    v [B_, H, N, hd] (rows 16-byte aligned, strides multiples of 8) with f32
    rel_bias and mask; returns bf16 out (or ``out`` written, a bf16
    destination at such strides). hd a multiple of 8 up to 256. ``q_scale``
    is rounded to bf16 and each q to bf16(q * scale), as the JAX caller's
    bf16 multiply rounds; the math between is f32, the output rounded once.

    Replaces focal_tpu/ops/pallas_kernels.py::fused_window_attention fed
    bf16 (_attn_fwd_kernel). CPU tensors take
    fused_window_attention_bf16_reference; CUDA tensors launch
    csrc/window_attention.cu's focal_wattn_fwd_bf16.
    """
    if q.device.type == "cpu":
        return _into(out, fused_window_attention_bf16_reference(q, k, v, rel_bias, mask,
                                                                q_scale=q_scale))
    out = _attention_forward("fused_window_attention_bf16", q, k, v, rel_bias, mask, 0, 0.0,
                             q_scale, out, torch.bfloat16)
    fused_window_attention_bf16.launches += 1
    return out


fused_window_attention_bf16.launches = 0


def fused_window_attention_dropout_bf16(q, k, v, rel_bias, mask, seed, rate, q_scale=1.0,
                                        out=None):
    """#7 in bf16 (#7-bf16): #6-bf16 with attention dropout, the mask #7's
    (and #2's) for the same seed and geometry, not stored. Returns bf16 [B_,
    H, N, hd] (or ``out``).

    Replaces focal_tpu/ops/pallas_kernels.py::fused_window_attention_dropout
    fed bf16 (_attn_fwd_dropout_kernel). On the CPU the mask comes from
    draw_keep_mask and the output from the plain version.
    """
    _check_rate("fused_window_attention_dropout_bf16", rate)
    if q.device.type == "cpu":
        B, H, N, _ = q.shape
        keep = draw_keep_mask(seed, (B, H, N, N), rate, q.device)
        return _into(out, fused_window_attention_bf16_reference(q, k, v, rel_bias, mask, keep,
                                                                rate, q_scale))
    out = _attention_forward("fused_window_attention_dropout_bf16", q, k, v, rel_bias, mask, seed,
                             rate, q_scale, out, torch.bfloat16)
    fused_window_attention_dropout_bf16.launches += 1
    return out


fused_window_attention_dropout_bf16.launches = 0


def fused_window_attention_backward_bf16(q, k, v, rel_bias, mask, g, seed=None, rate=0.0,
                                         q_scale=1.0):
    """VJP of #6-bf16 (#8-bf16): bf16 q, k, v and g (any strides #6-bf16
    reads); returns (dq, dk, dv bf16 [B_, H, N, hd], drel_bias f32 [H, N,
    N]), drel_bias summed in a fixed order: two calls give the same bits.
    With ``seed`` (and its ``rate``) it is the VJP of #7-bf16, which
    fused_window_attention_dropout_backward_bf16 (#9-bf16) computes.
    ``q_scale`` as #6-bf16's; dq is the gradient of the scaled q.

    Replaces focal_tpu/ops/pallas_kernels.py::_bwd_impl fed bf16
    (_attn_bwd_kernel). CPU tensors take
    fused_window_attention_backward_bf16_reference.
    """
    if seed is not None:
        return fused_window_attention_dropout_backward_bf16(q, k, v, rel_bias, mask, g, seed,
                                                            rate, q_scale)
    if q.device.type == "cpu":
        return fused_window_attention_backward_bf16_reference(q, k, v, rel_bias, mask, g,
                                                              q_scale=q_scale)
    grads = _attention_backward("fused_window_attention_backward_bf16", q, k, v, rel_bias, mask, g,
                                0, 0.0, q_scale=q_scale, dtype=torch.bfloat16)
    fused_window_attention_backward_bf16.launches += 1
    return grads


fused_window_attention_backward_bf16.launches = 0


def fused_window_attention_dropout_backward_bf16(q, k, v, rel_bias, mask, g, seed, rate,
                                                 q_scale=1.0):
    """VJP of #7-bf16 (#9-bf16): #8-bf16 with #7's mask drawn again from
    ``seed``. Returns (dq, dk, dv bf16, drel_bias f32), bitwise repeatable.

    Replaces focal_tpu/ops/pallas_kernels.py::_bwd_impl with a seed fed bf16
    (_attn_bwd_dropout_kernel). On the CPU the plain version with
    draw_keep_mask's mask, the one the CPU forward drew.
    """
    _check_rate("fused_window_attention_dropout_backward_bf16", rate)
    if q.device.type == "cpu":
        B, H, N, _ = q.shape
        keep = draw_keep_mask(seed, (B, H, N, N), rate, q.device)
        return fused_window_attention_backward_bf16_reference(q, k, v, rel_bias, mask, g, keep,
                                                              rate, q_scale)
    grads = _attention_backward("fused_window_attention_dropout_backward_bf16", q, k, v, rel_bias,
                                mask, g, seed, rate, q_scale=q_scale, dtype=torch.bfloat16)
    fused_window_attention_dropout_backward_bf16.launches += 1
    return grads


fused_window_attention_dropout_backward_bf16.launches = 0


def window_attention_keep_mask(seed, B, H, N, rate, device):
    """The keep mask that #7 and #9 draw for ``seed`` over B windows of H
    heads and N tokens, as uint8 [B, H, N, N] (1 kept): on a CUDA device
    written by a kernel from their Philox counters, on the CPU
    draw_keep_mask's (the mask the CPU wrappers draw). For checks; the
    kernels never store it."""
    _check_rate("window_attention_keep_mask", rate)
    device = torch.device(device)
    if device.type == "cpu":
        return draw_keep_mask(seed, (B, H, N, N), rate, device)
    if not 1 <= N <= _MAX_N:
        raise ValueError(f"window_attention_keep_mask: unsupported window size N={N}")
    keep = torch.empty((B, H, N, N), dtype=torch.uint8, device=device)
    lib = _window_attention_lib()
    _launch("window_attention_keep_mask", lib.focal_wattn_keep_mask, device, keep.data_ptr(), B, H,
            N, int(seed) % 2**64, _keep_threshold(rate), lib=lib)
    return keep


def _rows(t):
    """``t``, or a contiguous copy of it where the kernels cannot read its
    layout (the plain versions read any)."""
    return t if t.device.type == "cpu" or _takes_rows(t) else t.contiguous()


class _WindowAttentionQKV(torch.autograd.Function):
    """#7 (or #6 at rate 0) forward and #9 (or #8) backward on the qkv
    projection's output, or for a bf16 qkv their bf16 forms: q, k, v are
    head views of ``qkv`` [B_, N, 3C], q scaled by hd**-0.5 in the kernels;
    the forward writes its output as one [B_, N, C] tensor (the output
    projection's input), the backward d(qkv) as one [B_, N, 3C] tensor of
    qkv's type, dq times the scale (in bf16 bf16(bf16(dq) bf16(scale)), the
    VJP of the JAX caller's bf16 multiply), so nothing scales, stacks or
    copies q, the output or the three gradients. The residuals are qkv,
    rel_bias and the mask; the seed is the only one of the dropout."""

    @staticmethod
    def forward(ctx, qkv, rel_bias, mask, H, seed, rate):
        q, k, v = _head_views(qkv, H)
        scale = q.shape[-1] ** -0.5
        B, N, C3 = qkv.shape
        y = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
        bf16 = qkv.dtype == torch.bfloat16
        if rate > 0.0:
            fwd = fused_window_attention_dropout_bf16 if bf16 else fused_window_attention_dropout
            fwd(q, k, v, rel_bias, mask, seed, rate, q_scale=scale, out=_heads(y, H))
        else:
            fwd = fused_window_attention_bf16 if bf16 else fused_window_attention
            fwd(q, k, v, rel_bias, mask, q_scale=scale, out=_heads(y, H))
        ctx.save_for_backward(qkv, rel_bias, mask)
        ctx.H, ctx.seed, ctx.rate = H, (seed if rate > 0.0 else None), rate
        return y

    @staticmethod
    def backward(ctx, gy):
        qkv, rel_bias, mask = ctx.saved_tensors
        q, k, v = _head_views(qkv, ctx.H)
        scale = q.shape[-1] ** -0.5
        g = _heads(gy, ctx.H)
        bf16 = qkv.dtype == torch.bfloat16
        if qkv.device.type == "cpu":
            bwd = fused_window_attention_backward_bf16 if bf16 else fused_window_attention_backward
            dq, dk, dv, drel_bias = bwd(q, k, v, rel_bias, mask, g, ctx.seed, ctx.rate,
                                        q_scale=scale)
            dq = scale_bf16(dq, scale) if bf16 else dq * scale
            B, H, N, hd = dq.shape
            dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B, N, 3 * H * hd)
            return dqkv, drel_bias, None, None, None, None
        dqkv = torch.empty_like(qkv)
        if ctx.seed is None:
            kernel = (fused_window_attention_backward_bf16 if bf16
                      else fused_window_attention_backward)
        else:
            kernel = (fused_window_attention_dropout_backward_bf16 if bf16
                      else fused_window_attention_dropout_backward)
        drel_bias = _attention_backward(kernel.__name__, q, k, v, rel_bias, mask, _rows(g),
                                        ctx.seed, ctx.rate, dqkv=dqkv, dq_scale=scale,
                                        q_scale=scale, dtype=qkv.dtype)[3]
        kernel.launches += 1
        return dqkv, drel_bias, None, None, None, None


def window_attention_qkv(qkv, num_heads, rel_bias, mask=None, seed=0, rate=0.0):
    """Differentiable window attention on the qkv projection's output, as
    the attention-only route of the Swin block hands it over: qkv [B_, N,
    3C] (column order part | head | dim, q unscaled), ``num_heads`` heads;
    q scaled by hd**-0.5 in the kernels, #7 (rate > 0) or #6 forward and #9
    or #8 backward (for a bf16 qkv #7-bf16 or #6-bf16 and #9-bf16 or
    #8-bf16), whose d(qkv) comes out as one [B_, N, 3C] tensor.
    Returns [B_, H, N, hd], the head view of a contiguous [B_, N, C] tensor
    (``out.transpose(1, 2).reshape(B_, N, C)`` is a view); gradients in qkv
    and rel_bias. qkv must be contiguous (the Linear's output). CPU tensors
    take the plain versions."""
    y = _WindowAttentionQKV.apply(qkv.contiguous(), rel_bias, mask, int(num_heads), seed,
                                  float(rate))
    return _heads(y, int(num_heads))


def window_attention_qkv_reference(qkv, num_heads, rel_bias, mask=None, seed=0, rate=0.0):
    """Plain version of window_attention_qkv on any device (autograd
    through window_attention_reference on the scaled head views; for a
    bf16 qkv on them scaled as ``scale_bf16`` and upcast, the output
    rounded to bf16: autograd then rounds d(qkv) where the kernels do)."""
    q, k, v = _head_views(qkv, num_heads)
    scale = q.shape[-1] ** -0.5
    if qkv.dtype == torch.bfloat16:
        f32 = torch.float32
        out = window_attention_reference(scale_bf16(q, scale).to(f32), k.to(f32), v.to(f32),
                                         rel_bias, mask, seed, rate)
        return out.to(torch.bfloat16)
    return window_attention_reference(q * scale, k, v, rel_bias, mask, seed, rate)


def window_attention_reference(q, k, v, rel_bias, mask=None, seed=0, rate=0.0):
    """The attention of window_attention_qkv_reference on q, k, v [B_, H,
    N, hd] (q scaled): draw_keep_mask's mask, autograd through
    fused_window_attention_reference."""
    keep = None
    if rate > 0.0:
        B, H, N, _ = q.shape
        keep = draw_keep_mask(seed, (B, H, N, N), rate, q.device)
    return fused_window_attention_reference(q, k, v, rel_bias, mask, keep, rate)


def _window_attention_lib():
    lib = _build.load(_WINDOW_ATTENTION_SRC)
    if lib.focal_wattn_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
        drop = [i, ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float, p]  # dropout .. stream
        f = ctypes.c_float
        lib.focal_wattn_fwd.argtypes = [p] * 6 + [ll, f] + [i] * 5 + drop
        lib.focal_wattn_bwd_workspace.argtypes = [i] * 5 + [ll]
        lib.focal_wattn_bwd.argtypes = [p] * 4 + [ll] + [p] * 5 + [ll, f, f] + [p] * 2 + [i] * 5 + drop
        lib.focal_wattn_keep_mask.argtypes = [p, i, i, i, ctypes.c_ulonglong, ctypes.c_uint, p]
        lib.focal_wattn_fwd_bf16.argtypes = lib.focal_wattn_fwd.argtypes
        lib.focal_wattn_bwd_workspace_bf16.argtypes = lib.focal_wattn_bwd_workspace.argtypes
        lib.focal_wattn_bwd_bf16.argtypes = lib.focal_wattn_bwd.argtypes
        for fn in (lib.focal_wattn_fwd, lib.focal_wattn_bwd_workspace, lib.focal_wattn_bwd,
                   lib.focal_wattn_keep_mask, lib.focal_wattn_fwd_bf16,
                   lib.focal_wattn_bwd_workspace_bf16, lib.focal_wattn_bwd_bf16):
            fn.restype = ctypes.c_int
        lib.focal_cuda_error_string.argtypes = [ctypes.c_int]
        lib.focal_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _window_block_lib():
    lib = _build.load(_WINDOW_BLOCK_SRC)
    if lib.focal_wblock_fwd_dropout.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.POINTER(ctypes.c_longlong)
        dropout = [ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float, p]
        # the entry points take the attention's width D after C
        lib.focal_wblock_fwd_workspace.argtypes = [i] * 5 + [ll]
        lib.focal_wblock_fwd_dropout.argtypes = [p] * 10 + [i] * 6 + dropout
        lib.focal_wblock_bwd_workspace.argtypes = [i] * 6 + [ll]
        lib.focal_wblock_bwd.argtypes = [p] * 9 + [ctypes.c_float] + [p] * 4 + [i] * 6 + [p]
        lib.focal_wblock_fwd_bf16.argtypes = [p] * 10 + [i] * 6 + dropout
        lib.focal_wblock_bwd_workspace_bf16.argtypes = [i] * 6 + [ll]
        lib.focal_wblock_fwd_workspace_bf16.argtypes = [i] * 6 + [ll]
        lib.focal_wblock_bwd_bf16.argtypes = [p] * 8 + [ctypes.c_float] + [p] * 4 + [i] * 6 + [p]
        for fn in (lib.focal_wblock_fwd_workspace, lib.focal_wblock_fwd_dropout,
                   lib.focal_wblock_bwd_workspace, lib.focal_wblock_bwd, lib.focal_wblock_fwd_bf16,
                   lib.focal_wblock_fwd_workspace_bf16, lib.focal_wblock_bwd_workspace_bf16,
                   lib.focal_wblock_bwd_bf16):
            fn.restype = ctypes.c_int
        lib.focal_gemm_3xtf32.argtypes = [p] * 3 + [i] * 4 + [p]
        lib.focal_gemm_3xtf32.restype = ctypes.c_int
        lib.focal_cuda_error_string.argtypes = [ctypes.c_int]
        lib.focal_cuda_error_string.restype = ctypes.c_char_p
    return lib
