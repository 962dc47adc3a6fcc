"""Fused Swin MLP (port of the JAX package's ``fused_mlp`` and
``fused_mlp_dropout``, ``focal_tpu/ops/pallas_kernels.py``): fc1 -> exact
GELU -> fc2 on [T, C] token rows. Autograd saves only x and the weights:
the [T, 4C] hidden lives in a workspace for one call (chunks of rows, 128
MiB at most, ``csrc/fused_mlp.cu``) and the backward computes it again.

Kernels (``csrc/fused_mlp.cu``), each with a launch count on its wrapper:
  #10 ``fused_mlp_forward``: the forward at rate 0 (``_mlp_fwd_kernel``);
  #11 ``fused_mlp_dropout_forward``: the forward with a keep mask after the
      GELU and one after fc2, drawn from a seed (``_mlp_fwd_dropout_kernel``);
  #12 ``fused_mlp_backward``: dx, dW1, db1, dW2, db2, with the masks drawn
      again from the seed or without them (``_mlp_bwd_kernel``,
      ``_mlp_bwd_dropout_kernel``).
``fused_mlp`` and ``fused_mlp_dropout`` are the autograd functions over
them. A CPU tensor takes the plain versions (``*_reference``, autograd
through torch ops); a CUDA tensor takes the kernels or raises.

The bf16 forms (``-compute_dtype bfloat16``): ``fused_mlp_forward_bf16``
(#10-bf16), ``fused_mlp_dropout_forward_bf16`` (#11-bf16) and
``fused_mlp_backward_bf16`` (#12-bf16) take a bf16 x (and g) with the f32
weights and biases as they lie, and give a bf16 y (and dx) and f32 weight
and bias gradients, rounding where the JAX package's kernel does when it is
fed bf16 (see ``fused_mlp_bf16_reference``), the GELU with the TPU
kernel's erf (ROADMAP C6). ``fused_mlp`` and ``fused_mlp_dropout`` take
them for a bf16 x (``_FusedMlpBf16``). On the card they run on Hopper's
``wgmma`` with TMA-fed shared memory (``csrc/gemm_wgmma.cuh``): the
forward is one launch where C <= 256, h kept on chip (fc2 summed over
64-column hidden chunks, each h chunk rounded to bf16 in registers); the
backward stores h and dz as bf16 and sums db1 and db2 from f32 per-tile
partials in a fixed order.

Dropout is the TPU kernel's: a 32-bit draw per element, kept iff bits >=
rate * 2**32, survivors scaled by 1 / (1 - rate) (not ``ops.dropout``'s
1/256 quantisation, which the JAX package uses only off the fused route).
The kernels draw Philox bits by (seed, row, column, site); the CPU draws
the masks from torch's generator, so the two agree in distribution.
"""

import ctypes

import torch
import torch.nn.functional as F

from focal_tpu_torch.ops import _build
from focal_tpu_torch.ops.conv_tower import gelu_exact, gelu_grad_exact

_FUSED_MLP_SRC = "fused_mlp.cu"
MLP_TILE = 1024  # the JAX kernel's max token rows per tile
BF16_FUSED_MAX_C = 256  # kFusedMaxC: #10-bf16/#11-bf16 run in one launch up to this width


# ---------------------------------------------------------------------------
# the gate (the JAX package's _mlp_tile / mlp_fits, copied)


def _mlp_tile(C, H):
    tile = MLP_TILE
    while tile > 128 and tile * (4 * H + 3 * C) * 4 > 7 * 1024 * 1024:
        tile //= 2
    return tile


def mlp_fits(C, H):
    """Whether the fused route takes width C and hidden H: exactly where the
    JAX package's ``mlp_fits`` does (its TPU kernel keeps both weights and
    their gradients whole in 16 MB of VMEM), so both packages take the same
    route at every width: MOD's C 64/128/256, MOD_WIDE's stage 0 (C 256) and
    not its C 512/1024 stages. It admits C up to 412 at H = 4C, every one
    of which the CUDA kernels take where C and H are multiples of 4
    (``kernel_refuses``); ``mlp_takes`` is the route's gate."""
    weights = 4 * C * H * 4
    working = _mlp_tile(C, H) * (4 * H + 3 * C) * 4
    return weights + working <= int(16 * 1024 * 1024 * 0.9)


def kernel_refuses(T, C, H, dtype=torch.float32):
    """Why the CUDA kernels (csrc/fused_mlp.cu, check_dims) cannot take T
    rows of width C and hidden H in ``dtype``, or None where they can: their
    products stage rows 16 bytes at a time, so C and H must be multiples of
    4, or of 8 for the bf16 forms."""
    mult = 8 if dtype == torch.bfloat16 else 4
    if C % mult or C < mult or H % mult or H < mult or T < 1:
        return (f"unsupported width C={C} H={H} T={T} (the kernels take C and H multiples of "
                f"{mult} in {dtype})")
    if T * max(C, H) >= 2**31:
        return f"unsupported rows T={T} at C={C} H={H} (32-bit element offsets)"
    return None


def mlp_takes(C, H, dtype=torch.float32):
    """The fused route's gate in ``dtype``: ``mlp_fits`` (the JAX package's
    gate) where the kernels take the width. A width that is not a multiple
    of 4 (of 8 in bf16, whose forms stage 8 values at a time) runs the
    plain Linears, as the route would with the flag off; the JAX package
    runs its kernel there, a difference from it that no packaged recipe
    meets (all give C and H multiples of 16)."""
    return mlp_fits(C, H) and kernel_refuses(1, C, H, dtype) is None


def _keep_threshold(rate):
    """u32 drop threshold: keep iff bits >= rate * 2**32, as the TPU kernel."""
    return min(int(rate * 4294967296.0), 2**32 - 1)


# ---------------------------------------------------------------------------
# the plain versions


def fused_mlp_reference(x, w1, b1, w2, b2):
    """Plain fc1 -> exact GELU -> fc2: x [T, C] @ w1 [C, H] + b1, GELU,
    @ w2 [H, C] + b2. Differentiable by autograd."""
    return torch.matmul(F.gelu(torch.matmul(x, w1) + b1, approximate="none"), w2) + b2


def fused_mlp_dropout_reference(x, w1, b1, w2, b2, keep1, keep2, rate):
    """The dropout form given its masks (keep1 [T, H], keep2 [T, C], bool or
    uint8): h and y are zeroed where the mask is 0 and scaled by 1 / (1 -
    rate) where it is 1."""
    inv = 1.0 / (1.0 - rate)
    h = F.gelu(torch.matmul(x, w1) + b1, approximate="none")
    h = torch.where(keep1.bool(), h * inv, 0.0)
    y = torch.matmul(h, w2) + b2
    return torch.where(keep2.bool(), y * inv, 0.0)


def fused_mlp_backward_reference(x, w1, b1, w2, b2, g, keep1=None, keep2=None, rate=0.0):
    """(dx, dw1, db1, dw2, db2) by autograd through the plain forward, with
    the masks when given."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        if keep1 is None:
            y = fused_mlp_reference(*leaves)
        else:
            y = fused_mlp_dropout_reference(*leaves, keep1, keep2, rate)
        return torch.autograd.grad(y, leaves, g)


def fused_mlp_bf16_reference(x, w1, b1, w2, b2, keep1=None, keep2=None, rate=0.0):
    """Plain version of #10-bf16 (and of #11-bf16 given its masks): the
    rounding points of the JAX package's ``_mlp_fwd_core`` fed a bf16 x and
    f32 weights (``focal_tpu/ops/pallas_kernels.py:516-534``). The weights
    are rounded to bf16 and every operand upcast, so each f32 product is
    exact and only its summation order differs from the kernel's: z = x W1
    + b1 in f32, h = GELU(z) with the TPU kernel's erf (keep1 in f32),
    rounded to bf16, y = h W2 + b2 in f32 (keep2), stored as bf16."""
    f32, bf16 = torch.float32, torch.bfloat16
    inv = 1.0 / (1.0 - rate) if keep1 is not None else 1.0
    z = torch.matmul(x.to(f32), w1.to(bf16).to(f32)) + b1
    h = gelu_exact(z)
    if keep1 is not None:
        h = torch.where(keep1.bool(), h * inv, 0.0)
    y = torch.matmul(h.to(bf16).to(f32), w2.to(bf16).to(f32)) + b2
    if keep2 is not None:
        y = torch.where(keep2.bool(), y * inv, 0.0)
    return y.to(bf16)


def fused_mlp_backward_bf16_reference(x, w1, b1, w2, b2, g, keep1=None, keep2=None, rate=0.0):
    """Plain version of #12-bf16: the rounding points of the JAX package's
    ``_mlp_bwd_math`` fed a bf16 x and g and f32 weights (``pk:548-568``):
    z and h recomputed in f32; g2 = g keep2 / (1 - rate) in f32, rounded to
    bf16 for dh = g2 W2^T and dW2; dz = dh keep1 / (1 - rate) GELU'(z) in
    f32, rounded to bf16 for dx = dz W1^T (stored as bf16) and dW1 = x^T
    dz; db1 the sum of the f32 dz, db2 of the f32 g2; dW2 = bf16(h as
    used)^T g2. Returns (dx bf16, dw1, db1, dw2, db2 f32); b2 takes no part."""
    f32, bf16 = torch.float32, torch.bfloat16
    x, w1, b1, w2, g = (t.detach() for t in (x, w1, b1, w2, g))
    inv = 1.0 / (1.0 - rate)
    xf, w1b, w2b = x.to(f32), w1.to(bf16).to(f32), w2.to(bf16).to(f32)
    z = torch.matmul(xf, w1b) + b1
    h = gelu_exact(z)
    g2 = g.to(f32)
    if keep2 is not None:
        g2 = torch.where(keep2.bool(), g2 * inv, 0.0)
    g2b = g2.to(bf16).to(f32)
    dh = torch.matmul(g2b, w2b.t())
    if keep1 is not None:
        h = torch.where(keep1.bool(), h * inv, 0.0)
        dh = torch.where(keep1.bool(), dh * inv, 0.0)
    dz = dh * gelu_grad_exact(z)
    dzb = dz.to(bf16).to(f32)
    dx = torch.matmul(dzb, w1b.t()).to(bf16)
    return (dx, torch.matmul(xf.t(), dzb), dz.sum(0),
            torch.matmul(h.to(bf16).to(f32).t(), g2b), g2.sum(0))


def draw_mlp_masks(seed, T, C, H, rate, device):
    """The plain version's masks: uint8 keep1 [T, H] and keep2 [T, C], 1
    where a 32-bit draw from torch's generator seeded with ``seed`` is >=
    rate * 2**32."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    thr = _keep_threshold(rate)
    bits1 = torch.randint(0, 2**32, (T, H), generator=gen, device=device, dtype=torch.int64)
    bits2 = torch.randint(0, 2**32, (T, C), generator=gen, device=device, dtype=torch.int64)
    return (bits1 >= thr).to(torch.uint8), (bits2 >= thr).to(torch.uint8)


# ---------------------------------------------------------------------------
# the kernels' wrappers (CUDA tensors only)


def _lib():
    lib = _build.load(_FUSED_MLP_SRC)
    if lib.focal_mlp_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        seed = [ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_float]
        lib.focal_mlp_fwd.argtypes = [p] * 7 + [i] * 4 + seed + [p]
        lib.focal_mlp_workspace.argtypes = [i] * 4 + [ctypes.POINTER(ctypes.c_longlong),
                                                      ctypes.POINTER(ctypes.c_int)]
        lib.focal_mlp_bwd.argtypes = [p] * 9 + [i] * 4 + seed + [p]
        lib.focal_mlp_masks.argtypes = [ctypes.c_ulonglong, ctypes.c_uint] + [i] * 3 + [p] * 3
        lib.focal_mlp_fwd_bf16.argtypes = lib.focal_mlp_fwd.argtypes
        lib.focal_mlp_bwd_bf16.argtypes = [p] * 8 + [i] * 4 + seed + [p]
        lib.focal_mlp_workspace_bf16.argtypes = lib.focal_mlp_workspace.argtypes
        for fn in (lib.focal_mlp_fwd, lib.focal_mlp_workspace, lib.focal_mlp_bwd,
                   lib.focal_mlp_masks, lib.focal_mlp_fwd_bf16, lib.focal_mlp_bwd_bf16,
                   lib.focal_mlp_workspace_bf16):
            fn.restype = ctypes.c_int
        lib.focal_cuda_error_string.argtypes = [i]
        lib.focal_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, device, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"fused_mlp: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_mlp: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"fused_mlp: {name} is on {t.device}, x on {device}")
    if not t.is_contiguous():
        raise ValueError(f"fused_mlp: {name} must be contiguous")


def _check_dims(x, w1, dtype=torch.float32):
    """Validate x (of ``dtype``: f32, or bf16 for #10-bf16 to #12-bf16) and
    w1 (f32) for the kernels; returns (T, C, H)."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    if x.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"fused_mlp: x must be [T, C] and w1 [C, H], got {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}")
    T, C = x.shape
    H = w1.shape[1]
    reason = kernel_refuses(T, C, H, dtype)
    if reason:
        raise ValueError(f"fused_mlp: {reason}")
    _check("x", x, (T, C), x.device, dtype)
    _check("w1", w1, (C, H), x.device)
    return T, C, H


def _check_aligned(name, **operands):
    """The products read their operands 16 bytes at a time."""
    for key, t in operands.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _launch(name, fn, dev, *args):
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed ({err}): "
                           f"{_lib().focal_cuda_error_string(err).decode()}")


def _dropout_args(seed, rate):
    if not 0.0 < rate < 1.0:
        raise ValueError(f"fused_mlp: rate must be in (0, 1), got {rate}")
    return int(seed) % 2**64, _keep_threshold(rate), 1.0 / (1.0 - rate)


def mlp_launch_plan(T, C, H, backward, device, dtype=torch.float32):
    """(workspace floats, row chunks) of a #10/#11 call (``backward`` False)
    or a #12 call at rows T, width C and hidden H on a CUDA ``device``, or
    of their bf16 forms (``dtype`` bf16): the kernels' own plan
    (csrc/fused_mlp.cu). Raises where they have none."""
    lib = _lib()
    fn = lib.focal_mlp_workspace_bf16 if dtype == torch.bfloat16 else lib.focal_mlp_workspace
    floats, chunks = ctypes.c_longlong(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(T, C, H, int(backward), ctypes.byref(floats), ctypes.byref(chunks))
    if err != 0:
        raise RuntimeError(f"fused_mlp: no launch plan ({err}): "
                           f"{lib.focal_cuda_error_string(err).decode()}")
    return floats.value, chunks.value


def _forward(name, x, w1, b1, w2, b2, dropout, seed, rate, bf16=False):
    """The CUDA path of #10 and #11 (with ``bf16``, #10-bf16 and #11-bf16):
    validate, size the workspace, launch; returns y."""
    T, C, H = _check_dims(x, w1, torch.bfloat16 if bf16 else torch.float32)
    dev = x.device
    _check("b1", b1, (H,), dev)
    _check("w2", w2, (H, C), dev)
    _check("b2", b2, (C,), dev)
    if bf16:
        _check_aligned(name, x=x, w1=w1, b1=b1, w2=w2, b2=b2)
    else:
        _check_aligned(name, x=x, w1=w1, w2=w2)
    seed_, thr, inv = _dropout_args(seed, rate) if dropout else (0, 0, 1.0)
    ws = torch.empty(mlp_launch_plan(T, C, H, False, dev, x.dtype)[0], dtype=torch.float32,
                     device=dev)
    y = torch.empty_like(x)
    lib = _lib()
    _launch(name, lib.focal_mlp_fwd_bf16 if bf16 else lib.focal_mlp_fwd, dev, x.data_ptr(),
            w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), y.data_ptr(), ws.data_ptr(), T, C, H, int(dropout),
            seed_, thr, inv)
    return y


def fused_mlp_forward(x, w1, b1, w2, b2):
    """#10: y = GELU(x w1 + b1) w2 + b2 for x [T, C], w1 [C, H], b1 [H], w2
    [H, C], b2 [C] (f32, contiguous). Replaces
    focal_tpu/ops/pallas_kernels.py::_mlp_fwd_impl (_mlp_fwd_kernel). CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return fused_mlp_reference(x, w1, b1, w2, b2)
    y = _forward("fused_mlp_forward", x, w1, b1, w2, b2, False, 0, 0.0)
    fused_mlp_forward.launches += 1
    return y


fused_mlp_forward.launches = 0


def fused_mlp_dropout_forward(x, w1, b1, w2, b2, seed, rate):
    """#11: #10 with both dropouts: each element of h [T, H] and of y [T, C]
    is kept iff its Philox word (keyed by ``seed``, counted by row, column
    and site) is >= rate * 2**32, and scaled by 1 / (1 - rate). The same
    seed gives the same masks (``mlp_keep_masks`` materialises them).
    Replaces focal_tpu/ops/pallas_kernels.py::_mlp_fwd_impl with a seed
    (_mlp_fwd_dropout_kernel). On the CPU the masks come from
    draw_mlp_masks and y from the plain version."""
    if x.device.type == "cpu":
        T, C = x.shape
        keep1, keep2 = draw_mlp_masks(seed, T, C, w1.shape[1], rate, x.device)
        return fused_mlp_dropout_reference(x, w1, b1, w2, b2, keep1, keep2, rate)
    y = _forward("fused_mlp_dropout_forward", x, w1, b1, w2, b2, True, seed, rate)
    fused_mlp_dropout_forward.launches += 1
    return y


fused_mlp_dropout_forward.launches = 0


def fused_mlp_backward(x, w1, b1, w1_t, w2_t, g, seed=None, rate=0.0):
    """#12: (dx [T, C], dw1 [C, H], db1 [H], dw2 [H, C], db2 [C]) for the
    gradient g [T, C] of #10 (seed None) or of #11 (its seed and rate,
    the masks drawn again). It recomputes z and h from x, as the TPU kernel
    does; w1_t [H, C] and w2_t [C, H] are w1 and w2 transposed (nn.Linear's
    own layouts), which dx and dh read. The weight gradients are sums over
    fixed row splits added in a fixed order: two calls give the same bits.
    Replaces focal_tpu/ops/pallas_kernels.py::_mlp_bwd_impl
    (_mlp_bwd_kernel, _mlp_bwd_dropout_kernel). CPU tensors take autograd
    of the plain version, with draw_mlp_masks' masks for a seed."""
    if x.device.type == "cpu":
        keep1 = keep2 = None
        if seed is not None:
            keep1, keep2 = draw_mlp_masks(seed, x.shape[0], x.shape[1], w1.shape[1], rate, x.device)
        b2 = torch.zeros(x.shape[1], dtype=x.dtype)  # y's bias: no part in the gradients
        return fused_mlp_backward_reference(x, w1, b1, w2_t.t(), b2, g, keep1, keep2, rate)
    grads = _backward("fused_mlp_backward", x, w1, b1, w1_t, w2_t, g, seed, rate)
    fused_mlp_backward.launches += 1
    return grads


fused_mlp_backward.launches = 0


def _backward(name, x, w1, b1, w1_t, w2_t, g, seed, rate, bf16=False):
    """The CUDA path of #12 (with ``bf16``, #12-bf16): validate, size the
    workspace, launch, and split the flat weight gradients."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    T, C, H = _check_dims(x, w1, dtype)
    dev = x.device
    _check("b1", b1, (H,), dev)
    if not bf16:  # the bf16 kernels read W1 in both orders as it lies
        _check("w1_t", w1_t, (H, C), dev)
    _check("w2_t", w2_t, (C, H), dev)
    _check("g", g, (T, C), dev, dtype)
    if bf16:
        _check_aligned(name, x=x, w1=w1, b1=b1, w2_t=w2_t, g=g)
    else:
        _check_aligned(name, x=x, w1=w1, w1_t=w1_t, w2_t=w2_t, g=g)
    dropout = seed is not None
    seed_, thr, inv = _dropout_args(seed, rate) if dropout else (0, 0, 1.0)
    ws = torch.empty(mlp_launch_plan(T, C, H, True, dev, dtype)[0], dtype=torch.float32,
                     device=dev)
    dx = torch.empty_like(x)
    dweights = torch.empty(2 * C * H + H + C, dtype=torch.float32, device=dev)
    lib = _lib()
    if bf16:
        _launch(name, lib.focal_mlp_bwd_bf16, dev, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                w2_t.data_ptr(), g.data_ptr(), dx.data_ptr(), dweights.data_ptr(), ws.data_ptr(),
                T, C, H, int(dropout), seed_, thr, inv)
    else:
        _launch(name, lib.focal_mlp_bwd, dev, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                w1_t.data_ptr(), w2_t.data_ptr(), g.data_ptr(), dx.data_ptr(),
                dweights.data_ptr(), ws.data_ptr(), T, C, H, int(dropout), seed_, thr, inv)
    dw1 = dweights[:C * H].view(C, H)
    db1 = dweights[C * H:C * H + H]
    dw2 = dweights[C * H + H:2 * C * H + H].view(H, C)
    db2 = dweights[2 * C * H + H:]
    return dx, dw1, db1, dw2, db2


def fused_mlp_forward_bf16(x, w1, b1, w2, b2):
    """#10-bf16: #10's function on a bf16 x [T, C] with the f32 w1 [C, H],
    b1, w2 [H, C] and b2 as they lie (rounded to bf16 once a call); returns
    bf16 y. C and H multiples of 8. On the card: h = GELU(x W1 + b1) in f32
    rounded to bf16, y = h W2 + b2 in f32 stored as bf16, the products on
    the bf16 tensor cores (wgmma); where C <= 256 one launch keeps h on chip,
    y summed over 64-column hidden chunks. Replaces
    focal_tpu/ops/pallas_kernels.py::_mlp_fwd_impl (_mlp_fwd_kernel) fed
    bf16. CPU tensors take fused_mlp_bf16_reference."""
    if x.device.type == "cpu":
        return fused_mlp_bf16_reference(x, w1, b1, w2, b2)
    y = _forward("fused_mlp_forward_bf16", x, w1, b1, w2, b2, False, 0, 0.0, bf16=True)
    fused_mlp_forward_bf16.launches += 1
    return y


fused_mlp_forward_bf16.launches = 0


def fused_mlp_dropout_forward_bf16(x, w1, b1, w2, b2, seed, rate):
    """#11-bf16: #10-bf16 with both dropouts, the masks #11 draws for the
    same seed (``mlp_keep_masks``). Replaces
    focal_tpu/ops/pallas_kernels.py::_mlp_fwd_impl with a seed
    (_mlp_fwd_dropout_kernel) fed bf16. On the CPU the masks come from
    draw_mlp_masks and y from fused_mlp_bf16_reference."""
    if x.device.type == "cpu":
        T, C = x.shape
        keep1, keep2 = draw_mlp_masks(seed, T, C, w1.shape[1], rate, x.device)
        return fused_mlp_bf16_reference(x, w1, b1, w2, b2, keep1, keep2, rate)
    y = _forward("fused_mlp_dropout_forward_bf16", x, w1, b1, w2, b2, True, seed, rate, bf16=True)
    fused_mlp_dropout_forward_bf16.launches += 1
    return y


fused_mlp_dropout_forward_bf16.launches = 0


def fused_mlp_backward_bf16(x, w1, b1, w1_t, w2_t, g, seed=None, rate=0.0):
    """#12-bf16: fused_mlp_backward's arguments with a bf16 x and g (the
    weights f32); returns (dx bf16, dw1, db1, dw2, db2 f32), the weight
    gradients fixed-order sums: two calls give the same bits. ``w1_t`` is
    not read (the kernels read w1 in both orders); ``w2_t`` gives W2. On the
    card: z and dh = g2 W2^T over one tile, dz in f32 (db1 sums it in
    per-tile partials) stored as bf16 with the h the forward used; g2 stored
    as bf16 (db2 from its f32 values); dx = dz W1^T, dW1 = x^T dz and dW2 =
    h^T g2 on the bf16 tensor cores (wgmma). Replaces
    focal_tpu/ops/pallas_kernels.py::
    _mlp_bwd_impl (_mlp_bwd_kernel, _mlp_bwd_dropout_kernel) fed bf16. CPU
    tensors take fused_mlp_backward_bf16_reference, with draw_mlp_masks'
    masks for a seed."""
    if x.device.type == "cpu":
        keep1 = keep2 = None
        if seed is not None:
            keep1, keep2 = draw_mlp_masks(seed, x.shape[0], x.shape[1], w1.shape[1], rate, x.device)
        return fused_mlp_backward_bf16_reference(x, w1, b1, w2_t.t(), None, g, keep1, keep2, rate)
    grads = _backward("fused_mlp_backward_bf16", x, w1, b1, w1_t, w2_t, g, seed, rate, bf16=True)
    fused_mlp_backward_bf16.launches += 1
    return grads


fused_mlp_backward_bf16.launches = 0


def mlp_keep_masks(seed, T, C, H, rate, device):
    """uint8 keep1 [T, H] and keep2 [T, C] of ``seed``: on a CUDA device the
    very masks #11 and #12 draw (a small kernel calling the same Philox
    function; never on the training path), on the CPU draw_mlp_masks'."""
    device = torch.device(device)
    if device.type == "cpu":
        return draw_mlp_masks(seed, T, C, H, rate, device)
    reason = kernel_refuses(T, C, H)
    if reason:
        raise ValueError(f"mlp_keep_masks: {reason}")
    seed_, thr, _ = _dropout_args(seed, rate)
    keep1 = torch.empty((T, H), dtype=torch.uint8, device=device)
    keep2 = torch.empty((T, C), dtype=torch.uint8, device=device)
    _launch("mlp_keep_masks", _lib().focal_mlp_masks, device, seed_, thr, T, C, H,
            keep1.data_ptr(), keep2.data_ptr())
    return keep1, keep2


# ---------------------------------------------------------------------------
# the autograd functions


class _FusedMlp(torch.autograd.Function):
    """#10 (seed None) or #11 forward, #12 backward (the JAX package's
    jax.custom_vjp pair). The masks are not saved: #12 draws them again."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, rate, w1_t, w2_t):
        if seed is None:
            y = fused_mlp_forward(x, w1, b1, w2, b2)
        else:
            y = fused_mlp_dropout_forward(x, w1, b1, w2, b2, seed, rate)
        ctx.save_for_backward(x, w1, b1, w1_t, w2_t)
        ctx.seed, ctx.rate = seed, rate
        return y

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w1_t, w2_t = ctx.saved_tensors
        grads = fused_mlp_backward(x, w1, b1, w1_t, w2_t, g.contiguous(), ctx.seed, ctx.rate)
        # w1_t and w2_t are w1 and w2 in another layout: their gradient
        # reaches the parameters through w1 and w2
        return (*grads, None, None, None, None)


class _FusedMlpBf16(torch.autograd.Function):
    """#10-bf16 (seed None) or #11-bf16 forward and #12-bf16 backward, or
    with ``plain`` their plain versions (the masks from draw_mlp_masks). The
    f32 weights go to the kernels as they lie, so their gradients leave in
    f32 unrounded, as the JAX package's VJP hands them to the f32
    parameters; dx leaves in bf16."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, rate, w1_t, w2_t, plain):
        keep1 = keep2 = None
        if plain:
            if seed is not None:
                keep1, keep2 = draw_mlp_masks(seed, x.shape[0], x.shape[1], w1.shape[1], rate,
                                              x.device)
            y = fused_mlp_bf16_reference(x, w1, b1, w2, b2, keep1, keep2, rate)
        elif seed is None:
            y = fused_mlp_forward_bf16(x, w1, b1, w2, b2)
        else:
            y = fused_mlp_dropout_forward_bf16(x, w1, b1, w2, b2, seed, rate)
        ctx.save_for_backward(x, w1, b1, w2, w1_t, w2_t, keep1, keep2)
        ctx.seed, ctx.rate, ctx.plain = seed, rate, plain
        return y

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, w1_t, w2_t, keep1, keep2 = ctx.saved_tensors
        if ctx.plain:
            grads = fused_mlp_backward_bf16_reference(x, w1, b1, w2, None, g, keep1, keep2,
                                                      ctx.rate)
        else:
            grads = fused_mlp_backward_bf16(x, w1, b1, w1_t, w2_t, g.contiguous(), ctx.seed,
                                            ctx.rate)
        return (*grads, None, None, None, None, None)


def _transposes(w1, w2, w1_t, w2_t):
    return (w1.t().contiguous() if w1_t is None else w1_t,
            w2.t().contiguous() if w2_t is None else w2_t)


def fused_mlp(x, w1, b1, w2, b2, w1_t=None, w2_t=None):
    """Differentiable fused MLP on [T, C] rows: forward #10, backward #12;
    gradients in x, w1, b1, w2 and b2. ``w1_t`` [H, C] and ``w2_t`` [C, H],
    when given, are w1 and w2 transposed (nn.Linear's weights), which #12
    reads; else the wrapper makes them. On the CPU: the plain version under
    autograd. A bf16 x takes #10-bf16 and #12-bf16 (``_FusedMlpBf16``; on
    the CPU their plain versions)."""
    if x.dtype == torch.bfloat16:
        return _FusedMlpBf16.apply(x, w1, b1, w2, b2, None, 0.0, *_transposes(w1, w2, w1_t, w2_t),
                                   x.device.type == "cpu")
    if x.device.type == "cpu":
        return fused_mlp_reference(x, w1, b1, w2, b2)
    w1_t, w2_t = _transposes(w1, w2, w1_t, w2_t)
    return _FusedMlp.apply(x, w1, b1, w2, b2, None, 0.0, w1_t, w2_t)


def fused_mlp_plain(x, w1, b1, w2, b2, w1_t=None, w2_t=None):
    """Plain version of fused_mlp on any device, with its arguments (the
    transposed weights go unread): autograd through fused_mlp_reference, or
    for a bf16 x the bf16 plain pair (``_FusedMlpBf16`` with ``plain``)."""
    if x.dtype == torch.bfloat16:
        return _FusedMlpBf16.apply(x, w1, b1, w2, b2, None, 0.0, None, None, True)
    return fused_mlp_reference(x, w1, b1, w2, b2)


def fused_mlp_dropout(x, w1, b1, w2, b2, seed, rate, w1_t=None, w2_t=None):
    """fused_mlp with dropout after the GELU and after fc2 (the rate of the
    Swin Mlp, one mask each): forward #11, backward #12 with the masks of
    ``seed`` drawn again. On the CPU: the plain version with
    draw_mlp_masks' masks, under autograd. A bf16 x takes #11-bf16 and
    #12-bf16 (``_FusedMlpBf16``)."""
    if x.dtype == torch.bfloat16:
        return _FusedMlpBf16.apply(x, w1, b1, w2, b2, int(seed), float(rate),
                                   *_transposes(w1, w2, w1_t, w2_t), x.device.type == "cpu")
    if x.device.type == "cpu":
        keep1, keep2 = draw_mlp_masks(seed, x.shape[0], x.shape[1], w1.shape[1], rate, x.device)
        return fused_mlp_dropout_reference(x, w1, b1, w2, b2, keep1, keep2, rate)
    w1_t, w2_t = _transposes(w1, w2, w1_t, w2_t)
    return _FusedMlp.apply(x, w1, b1, w2, b2, int(seed), float(rate), w1_t, w2_t)
