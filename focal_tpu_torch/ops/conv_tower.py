"""Fused DeepSense conv tower, train mode (port of the JAX package's
``ops/conv_tower.py``).

A chain of ConvLayer2D blocks: conv2d (1, KW) SAME + bias -> BatchNorm with
the batch's statistics (f32, fast variance E[x^2] - E[x]^2 clipped at 0,
eps 1e-5) -> exact GELU -> Dropout2d mask -> residual add (every layer but
the first). Activations are [R*S, C] row-major: R rows of (sample,
interval), S spectrum positions, C channels (NHWC flattened).

Kernels (``csrc/conv_tower.cu``), each with a launch count on its public
function:
  #13 ``fused_conv_tower`` (forward): per layer one call, either the first
      conv with its per-channel sums (``_conv0_kernel``) or the apply of
      layer k (BN + GELU + mask + residual) fused with layer k+1's conv and
      sums (``_apply_kernel``); ``fused_conv_tower.launches`` counts them;
  #14 ``fused_conv_tower_backward``: per layer the sums Σgy and Σgy·x̂
      (``_bwd_stats_kernel``), then the BN input gradient dc, the
      transposed conv into the previous layer (+ the residual) and dW, db
      (``_bwd_apply_kernel``), or dc alone for an external first conv
      (``_bwd_dc_kernel``); ``fused_conv_tower_backward.launches`` counts
      them.
The [C]-sized finalize between calls (statistics to BN coefficients, the
per-tap weight transpose) is torch, as the JAX package does it in XLA.

``fused_conv_tower`` is an autograd function over the whole chain. A CPU
tensor takes the plain version (``fused_conv_tower_reference``, autograd
through torch ops); a CUDA tensor takes the kernels or raises.
"""

import collections
import ctypes

import torch
import torch.nn.functional as F

from focal_tpu_torch.ops import _build

BN_EPS = 1e-5
_CONV_TOWER_SRC = "conv_tower.cu"
_KINDS = {"forward": 0, "bwd_stats": 1, "bwd_apply": 2}  # kinds of focal_ct_workspace


# ---------------------------------------------------------------------------
# the gate (the JAX package's _pick_trr / tower_fits, copied)


def _pick_trr(R, S, C, dtype=torch.float32, kw_max=5):
    """Samples-per-tile of the TPU kernels: the largest power of two TR_r
    with R % TR_r == 0, TR_r*S sublane-aligned and ~(8 + KW) [TR_r*S,
    C-padded] f32 buffers within 8 MB; None when there is none."""
    pad_c = ((C + 127) // 128) * 128
    sub = 16 if dtype == torch.bfloat16 else 8
    budget = 8 * 1024 * 1024
    tr = 256
    while tr >= 1:
        trs = tr * S
        if R % tr == 0 and trs % sub == 0 and trs * pad_c * 4 * (8 + kw_max) <= budget:
            return tr
        tr //= 2
    return None


def tower_fits(R, S, C, dtype=torch.float32, kw_max=5):
    """Whether the fused path takes this geometry: exactly where the JAX
    package's ``tower_fits`` does, so both packages take the same path at
    every geometry. kw_max is the widest conv that runs in the chain (an
    external first conv excluded)."""
    return _pick_trr(R, S, C, dtype, kw_max=kw_max) is not None


# ---------------------------------------------------------------------------
# GELU as the TPU kernels compute it (focal_tpu/ops/pallas_kernels.py:484-503)


def _erf(x):
    """Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7), as the TPU kernel."""
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t - 0.284496736) * t
            + 0.254829592) * t
    return s * (1.0 - poly * torch.exp(-ax * ax))


def gelu_exact(z):
    return 0.5 * z * (1.0 + _erf(z * 0.7071067811865476))


# ---------------------------------------------------------------------------
# the plain version


def _rows_of(mask, R):
    """[M, C] per-sample mask -> [R, C]: row r takes mask[r // (R / M)]."""
    return mask.repeat_interleave(R // mask.shape[0], dim=0)


def _conv_same(x, w, kw):
    """(1, KW) SAME convolution of x [R, S, Cin] with im2col weights w
    [KW*Cin, Cout]: tap k reads position s + k - (KW-1)//2, zero outside."""
    S = x.shape[1]
    lo = (kw - 1) // 2
    xp = F.pad(x, (0, 0, lo, kw - 1 - lo))
    cols = torch.cat([xp[:, k:k + S] for k in range(kw)], dim=-1) if kw > 1 else xp
    return torch.matmul(cols, w)


def fused_conv_tower_reference(x0, layer_cfgs, ws, bs, scales, biases, masks,
                               external_c0=False):
    """Plain PyTorch version of fused_conv_tower (the math of the JAX
    package's tests/test_conv_tower.py replica), differentiable by
    autograd. Arguments and results as fused_conv_tower."""
    R = x0.shape[0]
    a = None
    mus, vars_ = [], []
    for k, (kw, _, _, residual) in enumerate(layer_cfgs):
        if k == 0 and external_c0:
            c = x0
        else:
            c = _conv_same(a if k > 0 else x0, ws[k], kw) + bs[k]
        mu = c.mean(dim=(0, 1))
        var = torch.clamp((c * c).mean(dim=(0, 1)) - mu * mu, min=0.0)
        y = (c - mu) * torch.rsqrt(var + BN_EPS) * scales[k] + biases[k]
        z = gelu_exact(y) * _rows_of(masks[k], R)[:, None, :]
        a = z + a if residual else z
        mus.append(mu.detach())
        vars_.append(var.detach())
    return a, tuple(mus), tuple(vars_)


# ---------------------------------------------------------------------------
# the kernels' wrappers (CUDA tensors only)


def _lib():
    lib = _build.load(_CONV_TOWER_SRC)
    if lib.focal_ct_conv0.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.focal_ct_workspace.argtypes = [i] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.focal_ct_conv0.argtypes = [p] * 6 + [i] * 5 + [p]
        lib.focal_ct_apply.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.focal_ct_bwd_stats.argtypes = [p] * 6 + [i] * 4 + [p]
        lib.focal_ct_bwd_apply.argtypes = [p] * 10 + [i] * 7 + [p]
        lib.focal_ct_bwd_dc.argtypes = [p] * 6 + [i] * 4 + [p]
        for fn in (lib.focal_ct_workspace, lib.focal_ct_conv0, lib.focal_ct_apply,
                   lib.focal_ct_bwd_stats, lib.focal_ct_bwd_apply, lib.focal_ct_bwd_dc):
            fn.restype = ctypes.c_int
        lib.focal_cuda_error_string.argtypes = [i]
        lib.focal_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"conv tower: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"conv tower: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"conv tower: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"conv tower: {name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _workspace(kind, R, S, cin, cout, kw, dev):
    lib = _lib()
    floats = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        err = lib.focal_ct_workspace(_KINDS[kind], R, S, cin, cout, kw, ctypes.byref(floats))
    if err != 0:
        raise RuntimeError(f"conv tower {kind}: no launch plan for R={R} S={S} Cin={cin} "
                           f"Cout={cout} KW={kw} ({err}): {lib.focal_cuda_error_string(err).decode()}")
    return torch.empty(floats.value, dtype=torch.float32, device=dev)


def _launch(name, fn, dev, *args):
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv tower {name} launch failed ({err}): "
                           f"{_lib().focal_cuda_error_string(err).decode()}")


def _conv0(x2, w, b, kw, R, S):
    """First conv of an internal-c0 tower: x [R*S, Cin] -> (c [R*S, Cout],
    per-channel sums [2, Cout] of c and c^2)."""
    dev = x2.device
    cin = x2.shape[1]
    cout = w.shape[1]
    _check("w", w, (kw * cin, cout), dev)
    _check("b", b, (cout,), dev)
    ws = _workspace("forward", R, S, cin, cout, kw, dev)
    c = torch.empty((R * S, cout), dtype=torch.float32, device=dev)
    sums = torch.empty((2, cout), dtype=torch.float32, device=dev)
    _launch("conv0", _lib().focal_ct_conv0, dev, x2.data_ptr(), w.data_ptr(), b.data_ptr(),
            c.data_ptr(), sums.data_ptr(), ws.data_ptr(), R, S, cin, cout, kw)
    fused_conv_tower.launches += 1
    return c, sums


def _apply(c, rows, mask, aprev, nxt, R, S):
    """Layer k's apply: a = GELU(c*A + B) * mask [+ aprev]; with ``nxt`` =
    (w, b, kw) of layer k+1 also its conv and sums in the same pass.
    Returns (a, c_next, sums_next), the last two None without ``nxt``."""
    dev = c.device
    C = c.shape[1]
    _check("rows", rows, (5, C), dev)
    _check("mask", mask, (mask.shape[0], C), dev)
    if aprev is not None:
        _check("aprev", aprev, (R * S, C), dev)
    a = torch.empty_like(c)
    c_next = sums = ws = w = b = None
    kw, cout = 0, 0
    if nxt is not None:
        w, b, kw = nxt
        cout = w.shape[1]
        _check("w", w, (kw * C, cout), dev)
        _check("b", b, (cout,), dev)
        ws = _workspace("forward", R, S, C, cout, kw, dev)
        c_next = torch.empty((R * S, cout), dtype=torch.float32, device=dev)
        sums = torch.empty((2, cout), dtype=torch.float32, device=dev)
    _launch("apply", _lib().focal_ct_apply, dev, c.data_ptr(), rows.data_ptr(), mask.data_ptr(),
            _ptr(aprev), _ptr(w), _ptr(b), a.data_ptr(), _ptr(c_next), _ptr(sums), _ptr(ws),
            R, S, mask.shape[0], C, cout, kw)
    fused_conv_tower.launches += 1
    return a, c_next, sums


def _bwd_stats(da, c, mask, rows, R, S):
    """[2, C]: Σ gy and Σ gy·x̂ over every row (gy the gradient at the BN
    output, x̂ the normalised conv output)."""
    dev = c.device
    C = c.shape[1]
    _check("da", da, (R * S, C), dev)
    ws = _workspace("bwd_stats", R, S, C, C, 1, dev)
    s2 = torch.empty((2, C), dtype=torch.float32, device=dev)
    _launch("bwd_stats", _lib().focal_ct_bwd_stats, dev, da.data_ptr(), c.data_ptr(),
            mask.data_ptr(), rows.data_ptr(), s2.data_ptr(), ws.data_ptr(), R, S, mask.shape[0], C)
    fused_conv_tower_backward.launches += 1
    return s2


def _bwd_apply(da, c, mask, rows, m, aprev, w, kw, residual, R, S):
    """dc (the BN input gradient), then dprev = convT(dc, W) [+ da], dW
    [KW*Cin, Cout] and db [Cout]. Returns (dprev, dW, db)."""
    dev = c.device
    C = c.shape[1]
    cin = aprev.shape[1]
    _check("da", da, (R * S, C), dev)
    _check("aprev", aprev, (R * S, cin), dev)
    _check("w", w, (kw * cin, C), dev)
    if residual and cin != C:
        raise ValueError(f"conv tower: a residual layer needs Cin == Cout, got {cin} and {C}")
    wt = w.view(kw, cin, C).transpose(1, 2).reshape(kw * C, cin).contiguous()  # per-tap W^T
    ws = _workspace("bwd_apply", R, S, cin, C, kw, dev)
    dprev = torch.empty((R * S, cin), dtype=torch.float32, device=dev)
    dwb = torch.empty(kw * cin * C + C, dtype=torch.float32, device=dev)
    _launch("bwd_apply", _lib().focal_ct_bwd_apply, dev, da.data_ptr(), c.data_ptr(),
            mask.data_ptr(), rows.data_ptr(), m.data_ptr(), aprev.data_ptr(), wt.data_ptr(),
            dprev.data_ptr(), dwb.data_ptr(), ws.data_ptr(), R, S, mask.shape[0], C, cin, kw,
            int(bool(residual)))
    fused_conv_tower_backward.launches += 1
    return dprev, dwb[:kw * cin * C].view(kw * cin, C), dwb[kw * cin * C:]


def _bwd_dc(da, c, mask, rows, m, R, S):
    """dc alone: the input gradient of an external first conv's output."""
    dev = c.device
    C = c.shape[1]
    _check("da", da, (R * S, C), dev)
    dc = torch.empty_like(c)
    _launch("bwd_dc", _lib().focal_ct_bwd_dc, dev, da.data_ptr(), c.data_ptr(), mask.data_ptr(),
            rows.data_ptr(), m.data_ptr(), dc.data_ptr(), R, S, mask.shape[0], C)
    fused_conv_tower_backward.launches += 1
    return dc


# ---------------------------------------------------------------------------
# the chain


def _finalize_stats(sums, n, scale, bias):
    """sums [2, C] -> BN rows [5, C] (A = invstd*scale, B = bias - mu*A,
    P = invstd, Q = mu*invstd, SC = scale: y = c*A + B, x̂ = c*P - Q) and
    (mu, biased var)."""
    mu = sums[0] / n
    var = torch.clamp(sums[1] / n - mu * mu, min=0.0)
    invstd = torch.rsqrt(var + BN_EPS)
    a_row = invstd * scale
    rows = torch.stack([a_row, bias - mu * a_row, invstd, mu * invstd, scale]).contiguous()
    return rows, mu, var


TowerSaved = collections.namedtuple(
    "TowerSaved", "cfgs external_c0 R S x2 a_list c_list rows_list ws masks")


def _check_tower(x0, cfgs, masks, external_c0):
    dev = x0.device
    if x0.device.type != "cuda":
        raise ValueError(f"fused_conv_tower: unsupported device {x0.device}")
    if x0.dim() != 3:
        raise ValueError(f"fused_conv_tower: x0 must be [R, S, C], got {tuple(x0.shape)}")
    R, S = x0.shape[:2]
    _check("x0", x0, (R, S, cfgs[0][2] if external_c0 else cfgs[0][1]), dev)
    for k, (kw, cin, cout, residual) in enumerate(cfgs):
        if k > 0 and cin != cfgs[k - 1][2]:
            raise ValueError(f"fused_conv_tower: layer {k} takes {cin} channels, gets {cfgs[k - 1][2]}")
        if residual and k == 0:
            raise ValueError("fused_conv_tower: the first layer has no residual")
        M = masks[k].shape[0]
        if masks[k].dim() != 2 or M < 1 or R % M:
            raise ValueError(f"fused_conv_tower: mask {k} of shape {tuple(masks[k].shape)} does "
                             f"not divide R = {R}")
        _check(f"mask {k}", masks[k], (M, cout), dev)


def tower_forward(x0, cfgs, ws, bs, scales, biases, masks, external_c0):
    """#13 over the chain on the card: (a_last [R, S, C], mus, vars,
    TowerSaved for the backward)."""
    _check_tower(x0, cfgs, masks, external_c0)
    R, S, _ = x0.shape
    n = float(R * S)
    x2 = x0.reshape(R * S, x0.shape[-1])
    L = len(cfgs)
    if external_c0:
        c = x2
        sums = torch.stack([c.sum(dim=0), (c * c).sum(dim=0)])
    else:
        c, sums = _conv0(x2, ws[0], bs[0], cfgs[0][0], R, S)
    a = None
    a_list, c_list, rows_list, mus, vars_ = [], [], [], [], []
    for k in range(L):
        rows, mu, var = _finalize_stats(sums, n, scales[k], biases[k])
        nxt = (ws[k + 1], bs[k + 1], cfgs[k + 1][0]) if k + 1 < L else None
        aprev = (a if k > 0 else x2) if cfgs[k][3] else None
        a, c_next, sums_next = _apply(c, rows, masks[k], aprev, nxt, R, S)
        a_list.append(a)
        c_list.append(c)
        rows_list.append(rows)
        mus.append(mu)
        vars_.append(var)
        c, sums = c_next, sums_next
    saved = TowerSaved(cfgs, external_c0, R, S, x2, a_list, c_list, rows_list, ws, masks)
    return a.view(R, S, cfgs[-1][2]), tuple(mus), tuple(vars_), saved


def fused_conv_tower_backward(saved, da_last):
    """#14 over the chain in reverse on the card: the VJP of
    fused_conv_tower at ``saved`` (tower_forward's) for the gradient
    da_last [R, S, C] of its output. Returns (dx0, dws, dbs, dscales,
    dbiases); with an external first conv dws[0] and dbs[0] are zeros (its
    gradient flows on through dx0). Every cross-row sum is a fixed-order
    reduction: two calls give the same bits.

    Replaces focal_tpu/ops/conv_tower.py's op_bwd (_bwd_stats_kernel,
    _bwd_apply_kernel, _bwd_dc_kernel); fused_conv_tower_backward.launches
    counts its kernel calls."""
    cfgs, R, S = saved.cfgs, saved.R, saved.S
    n = float(R * S)
    L = len(cfgs)
    da = da_last.reshape(R * S, cfgs[-1][2]).contiguous()
    dws, dbs, dscales, dbiases = [None] * L, [None] * L, [None] * L, [None] * L
    dx0 = None
    for k in range(L - 1, -1, -1):
        kw, cin, cout, residual = cfgs[k]
        rows = saved.rows_list[k]
        s2 = _bwd_stats(da, saved.c_list[k], saved.masks[k], rows, R, S)
        m = (s2 * rows[4] / n).contiguous()  # mean dx̂ and mean dx̂·x̂ (dx̂ = gy * scale)
        dscales[k], dbiases[k] = s2[1], s2[0]
        if k == 0 and saved.external_c0:
            dx0 = _bwd_dc(da, saved.c_list[0], saved.masks[0], rows, m, R, S)
            dws[0] = torch.zeros_like(saved.ws[0])
            dbs[0] = torch.zeros(cout, dtype=torch.float32, device=da.device)
            break
        aprev = saved.a_list[k - 1] if k > 0 else saved.x2
        dprev, dws[k], dbs[k] = _bwd_apply(da, saved.c_list[k], saved.masks[k], rows, m, aprev,
                                           saved.ws[k], kw, residual, R, S)
        if k > 0:
            da = dprev
        else:
            dx0 = dprev
    return dx0.view(R, S, dx0.shape[-1]), dws, dbs, dscales, dbiases


fused_conv_tower_backward.launches = 0


class _ConvTower(torch.autograd.Function):
    """#13 forward, #14 backward (the JAX package's jax.custom_vjp)."""

    @staticmethod
    def forward(ctx, cfgs, external_c0, x0, *flat):
        L = len(cfgs)
        ws, bs, scales, biases, masks = (list(flat[i * L:(i + 1) * L]) for i in range(5))
        ws = [w.contiguous() for w in ws]
        aL, mus, vars_, saved = tower_forward(x0, cfgs, ws, bs, scales, biases, masks, external_c0)
        ctx.meta = (cfgs, external_c0, saved.R, saved.S)
        ctx.save_for_backward(saved.x2, *saved.a_list, *saved.c_list, *saved.rows_list,
                              *saved.ws, *saved.masks)
        ctx.mark_non_differentiable(*mus, *vars_)
        return (aL, *mus, *vars_)

    @staticmethod
    def backward(ctx, da, *_):
        cfgs, external_c0, R, S = ctx.meta
        L = len(cfgs)
        t = ctx.saved_tensors
        x2, parts = t[0], [list(t[1 + i * L:1 + (i + 1) * L]) for i in range(5)]
        saved = TowerSaved(cfgs, external_c0, R, S, x2, *parts)
        dx0, dws, dbs, dscales, dbiases = fused_conv_tower_backward(saved, da)
        return (None, None, dx0, *dws, *dbs, *dscales, *dbiases, *([None] * L))


def fused_conv_tower(x0, layer_cfgs, ws, bs, scales, biases, masks, external_c0=False):
    """Run the ConvLayer2D chain in train mode (#13, with #14 as its
    backward).

    x0: [R, S, Cin] rows (R = batch * intervals), or with ``external_c0``
        the first conv's output [R, S, C], computed outside (audio's
        strided (1, 80) input conv).
    layer_cfgs: (kw, cin, cout, residual) per layer.
    ws[k]: [KW*Cin, Cout] im2col weights (flax HWIO kernels reshaped);
        bs, scales, biases: [C]; masks[k]: [M, C] Dropout2d scale factors
        (0 or 1/(1-rate)) with R % M == 0, row r taking mask[r // (R/M)]:
        [R, C] as the JAX package passes them, or [batch, C].

    Returns (a_last [R, S, C], mus, vars): per layer the batch mean and the
    biased batch variance, for the caller's running averages (flax
    semantics); they carry no gradient.

    Replaces focal_tpu/ops/conv_tower.py::fused_conv_tower (_conv0_kernel,
    _apply_kernel; their VJP #14). CPU tensors take the plain version."""
    cfgs = tuple(tuple(int(v) for v in c) for c in layer_cfgs)
    if x0.device.type == "cpu":
        return fused_conv_tower_reference(x0, cfgs, ws, bs, scales, biases, masks, external_c0)
    L = len(cfgs)
    out = _ConvTower.apply(cfgs, bool(external_c0), x0, *ws, *bs, *scales, *biases, *masks)
    return out[0], tuple(out[1:1 + L]), tuple(out[1 + L:])


fused_conv_tower.launches = 0

