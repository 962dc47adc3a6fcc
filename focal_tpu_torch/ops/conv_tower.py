"""Fused DeepSense conv tower, train mode (port of the JAX package's
``ops/conv_tower.py``).

A chain of ConvLayer2D blocks: conv2d (1, KW) SAME + bias -> BatchNorm with
the batch's statistics (f32, fast variance E[x^2] - E[x]^2 clipped at 0,
eps 1e-5) -> exact GELU -> Dropout2d mask -> residual add (every layer but
the first). Activations are [R*S, C] row-major: R rows of (sample,
interval), S spectrum positions, C channels (NHWC flattened).

Kernels (``csrc/conv_tower.cu``: the convs, transposed convs and weight
gradients as implicit-im2col 3xTF32 products on the tensor cores, the
elementwise work in byte-bound passes), each with a launch count on its
public function:
  #13 ``fused_conv_tower`` (forward): per layer one call, either the first
      conv with its batch statistics and BN coefficients (``_conv0_kernel``)
      or the apply of layer k (BN + GELU + mask + residual) and then layer
      k+1's conv with its statistics (``_apply_kernel``);
      ``fused_conv_tower.launches`` counts them;
  #14 ``fused_conv_tower_backward``: per layer the sums Σgy and Σgy·x̂ with
      the means the BN backward needs (``_bwd_stats_kernel``), then the BN
      input gradient dc, the transposed conv into the previous layer (+ the
      residual) and dW, db (``_bwd_apply_kernel``), or dc alone for an
      external first conv (``_bwd_dc_kernel``);
      ``fused_conv_tower_backward.launches`` counts them.
An external first conv's statistics are torch's (``_finalize_stats``), as
the JAX package computes that layer's in XLA.

``layer_plan``, ``stages_forward`` and ``stages_backward`` model the
kernels' plan and the order of their sums in plain PyTorch, for the tests.

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
# the kernels' plan and phase order in plain PyTorch, for the tests: what
# csrc/conv_tower.cu launches and in which order it sums, every product
# through ``gemm`` (torch.matmul, or the 3xTF32 emulation
# pallas_kernels.gemm_3xtf32_reference)

GEMM_BM = 128     # rows of a product tile (kGemmBM)
STAT_ROWS = 256   # rows of a column-sum block and of the narrow first conv (kStatRows)


def on_tensor_cores(cin):
    """Whether a conv over cin input channels runs as products on the tensor
    cores: a float4 of its im2col rows never straddles two taps."""
    return cin % 4 == 0


def _ceil(a, b):
    return -(-a // b)


def tile_bn(n):
    """A product's output tile width (gemm_splitk.cuh's tile_bn)."""
    return 128 if n % 128 == 0 else 64


def split_rows(rows, tiles, sms):
    """(splits, rows a split) of a split-K weight gradient (gemm_splitk.cuh's
    split_rows): about four blocks an SM, >= 256 rows a split, a multiple
    of 32."""
    splits = max(1, min(_ceil(4 * sms, tiles), _ceil(rows, 256)))
    rps = _ceil(_ceil(rows, splits), 32) * 32
    return _ceil(rows, rps), rps


def layer_plan(R, S, kw, cin, C, sms=132):
    """The launch plan of one layer on a card of ``sms`` SMs, as
    csrc/conv_tower.cu sets it: the route of its conv, its transposed conv
    and its weight gradient; the forward conv's column-sum partials, the
    backward sums' blocks, the weight gradient's tiles and row splits, and
    the workspaces in floats (focal_ct_workspace's kinds 0, 1, 2)."""
    RS = R * S
    tc = on_tensor_cores(cin)
    E = kw * cin * C + C
    tiles = _ceil(kw * cin, GEMM_BM) * _ceil(C, tile_bn(C)) if tc else 1
    splits, rps = split_rows(RS, tiles, sms)
    partials = _ceil(RS, GEMM_BM) if tc else _ceil(RS, STAT_ROWS)
    return {"tensor_cores": tc, "bn": tile_bn(C) if tc else None, "fwd_partials": partials,
            "stat_blocks": _ceil(RS, STAT_ROWS), "wgrad_tiles": tiles, "splits": splits,
            "rows_per_split": rps, "E": E,
            "workspace": {"forward": partials * 2 * C, "bwd_stats": _ceil(RS, STAT_ROWS) * 2 * C,
                          "bwd_apply": RS * C + (kw * C * cin if tc else 0) + splits * E}}


def shift_rows(x, d, S):
    """x [R*S, cin] with row g replaced by row g + d where its position
    g % S + d stays inside the sample, else by zeros: the loaders' tap
    shift and cp.async's zero-fill (the SAME padding)."""
    g = torch.arange(x.shape[0])
    ok = ((g % S + d) >= 0) & ((g % S + d) < S)
    return torch.where(ok[:, None], x[torch.clamp(g + d, 0, x.shape[0] - 1)], 0.0)


def im2col_rows(x, kw, S, sign=1):
    """The im2col [R*S, kw*cin] that the products read in place: column
    j*cin + ci of row g is x[g + sign*(j - lo), ci] (sign -1: the transposed
    conv)."""
    lo = (kw - 1) // 2
    return torch.cat([shift_rows(x, sign * (j - lo), S) for j in range(kw)], dim=1)


def tap_transpose(w, kw, cin, C):
    """W [kw*cin, C] -> its per-tap transpose [kw*C, cin], the transposed
    conv's B (tap_transpose_kernel)."""
    return w.view(kw, cin, C).transpose(1, 2).reshape(kw * C, cin)


def ordered_sum(partials):
    """The partials summed in order (reduce_partials_kernel)."""
    total = torch.zeros_like(partials[0])
    for p in partials:
        total = total + p
    return total


def _tile_sums(c, rows):
    return [torch.stack([t.sum(0), (t * t).sum(0)]) for t in c.split(rows)]


def stages_conv(x, w, b, kw, S, gemm=torch.matmul):
    """A forward conv as #13 runs it: c = im2col(x) w + b, through ``gemm``
    on the tensor cores or in f32 on the CUDA cores (the narrow first conv),
    and its sums [2, C]: per 128-row tile (256-row block) Σc and Σc²,
    summed in tile order. Returns (c, sums, partials)."""
    tc = on_tensor_cores(x.shape[1])
    c = (gemm if tc else torch.matmul)(im2col_rows(x, kw, S), w) + b
    partials = _tile_sums(c, GEMM_BM if tc else STAT_ROWS)
    return c, ordered_sum(partials), partials


def stages_forward(x0, cfgs, ws, bs, scales, biases, masks, external_c0=False, gemm=torch.matmul):
    """#13's phase order: per layer the BN coefficients from the sums, the
    apply pass a_k = GELU(c_k A + B) mask (+ a_{k-1}), then the next conv
    with its tile sums. Returns (a_last [R, S, C], mus, vars, saved) with
    saved = {x2, a, c, rows} per layer for stages_backward."""
    R, S, _ = x0.shape
    n = float(R * S)
    x2 = x0.reshape(R * S, x0.shape[-1])
    if external_c0:
        c = x2
        sums = torch.stack([c.sum(dim=0), (c * c).sum(dim=0)])  # tower_forward's, in torch
    else:
        c, sums, _ = stages_conv(x2, ws[0], bs[0], cfgs[0][0], S, gemm)
    saved = {"x2": x2, "a": [], "c": [], "rows": []}
    mus, vars_ = [], []
    a = None
    for k, (_, _, _, residual) in enumerate(cfgs):
        rows, mu, var = _finalize_stats(sums, n, scales[k], biases[k])
        z = gelu_exact(c * rows[0] + rows[1]) * _rows_of(masks[k], R).repeat_interleave(S, dim=0)
        aprev = (a if k > 0 else x2) if residual else None
        a = z + aprev if aprev is not None else z
        for key, v in (("a", a), ("c", c), ("rows", rows)):
            saved[key].append(v)
        mus.append(mu)
        vars_.append(var)
        if k + 1 < len(cfgs):
            c, sums, _ = stages_conv(a, ws[k + 1], bs[k + 1], cfgs[k + 1][0], S, gemm)
    return a.view(R, S, cfgs[-1][2]), tuple(mus), tuple(vars_), saved


def stages_backward(saved, cfgs, ws, masks, da_last, external_c0=False, gemm=torch.matmul,
                    sms=132):
    """#14's phase order from stages_forward's saved: per layer in reverse
    Σgy and Σgy·x̂ per 256-row block summed in block order, dc, the
    transposed conv (the shifts negated, B the per-tap W^T; + da for a
    residual) and dW | db as partials over the layer plan's fixed row
    splits summed in split order. Returns (dx0, dws, dbs, dscales,
    dbiases) as fused_conv_tower_backward, and the layers' partials."""
    x2 = saved["x2"]
    RS = x2.shape[0]
    R, S, C = da_last.shape
    n = float(RS)
    da = da_last.reshape(RS, C)
    L = len(cfgs)
    dws, dbs, dscales, dbiases, partials = ([None] * L for _ in range(5))
    for k in range(L - 1, -1, -1):
        kw, cin, cout, residual = cfgs[k]
        c, rows = saved["c"][k], saved["rows"][k]
        mask = _rows_of(masks[k], R).repeat_interleave(S, dim=0)
        gy = da * mask * _gelu_grad(c * rows[0] + rows[1])
        xhat = c * rows[2] - rows[3]
        s2 = ordered_sum([torch.stack([g.sum(0), (g * x).sum(0)])
                          for g, x in zip(gy.split(STAT_ROWS), xhat.split(STAT_ROWS))])
        m = s2 * rows[4] / n
        dscales[k], dbiases[k] = s2[1], s2[0]
        dc = rows[2] * (gy * rows[4] - m[0] - xhat * m[1])
        if k == 0 and external_c0:
            dws[0], dbs[0] = torch.zeros_like(ws[0]), torch.zeros(cout)
            dx0 = dc
            break
        aprev = saved["a"][k - 1] if k > 0 else x2
        tc = on_tensor_cores(cin)
        dprev = (gemm if tc else torch.matmul)(im2col_rows(dc, kw, S, sign=-1),
                                              tap_transpose(ws[k], kw, cin, cout))
        if residual:
            dprev = dprev + da
        cols = im2col_rows(aprev, kw, S)
        rps = layer_plan(R, S, kw, cin, cout, sms)["rows_per_split"]
        parts = [torch.cat([(gemm if tc else torch.matmul)(cols[r0:r0 + rps].t().contiguous(),
                                                           dc[r0:r0 + rps]).flatten(),
                            dc[r0:r0 + rps].sum(0)]) for r0 in range(0, RS, rps)]
        total = ordered_sum(parts)
        dws[k], dbs[k] = total[:-cout].view(kw * cin, cout), total[-cout:]
        partials[k] = parts
        da = dprev
        dx0 = dprev
    return (dx0.view(R, S, dx0.shape[-1]), dws, dbs, dscales, dbiases), partials


def _gelu_grad(z):
    """GELU'(z) with the kernels' erf."""
    return (0.5 * (1.0 + _erf(z * 0.7071067811865476))
            + z * torch.exp(-0.5 * z * z) * 0.3989422804014327)


# ---------------------------------------------------------------------------
# the kernels' wrappers (CUDA tensors only)


def _lib():
    lib = _build.load(_CONV_TOWER_SRC)
    if lib.focal_ct_conv0.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.focal_ct_workspace.argtypes = [i] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.focal_ct_conv0.argtypes = [p] * 10 + [i] * 5 + [p]
        lib.focal_ct_apply.argtypes = [p] * 14 + [i] * 6 + [p]
        lib.focal_ct_bwd_stats.argtypes = [p] * 7 + [i] * 4 + [p]
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


def _aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned: the kernels
    read their arrays 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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


def _bn_outputs(cout, dev):
    """rows [5, cout], mu and var [cout], for a conv's BatchNorm."""
    return (torch.empty((5, cout), dtype=torch.float32, device=dev),
            torch.empty(cout, dtype=torch.float32, device=dev),
            torch.empty(cout, dtype=torch.float32, device=dev))


def _conv0(x2, w, b, scale, bias, kw, R, S):
    """First conv of an internal-c0 tower: x [R*S, Cin] -> c [R*S, Cout] and
    from its batch statistics the BN rows [5, Cout] (scale and bias: its
    BatchNorm's affine), mu and var. Returns (c, rows, mu, var)."""
    dev = x2.device
    cin = x2.shape[1]
    cout = w.shape[1]
    _check("w", w, (kw * cin, cout), dev)
    for name, t in (("b", b), ("scale", scale), ("bias", bias)):
        _check(name, t, (cout,), dev)
    ws = _workspace("forward", R, S, cin, cout, kw, dev)
    c = torch.empty((R * S, cout), dtype=torch.float32, device=dev)
    rows, mu, var = _bn_outputs(cout, dev)
    _launch("conv0", _lib().focal_ct_conv0, dev, x2.data_ptr(), w.data_ptr(), b.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), c.data_ptr(), rows.data_ptr(), mu.data_ptr(),
            var.data_ptr(), ws.data_ptr(), R, S, cin, cout, kw)
    fused_conv_tower.launches += 1
    return c, rows, mu, var


def _apply(c, rows, mask, aprev, nxt, R, S):
    """Layer k's apply: a = GELU(c*A + B) * mask [+ aprev]; with ``nxt`` =
    (w, b, kw, scale, bias) of layer k+1 also its conv and, from that conv's
    batch statistics, its BN rows, mu and var. Returns (a, c_next,
    rows_next, mu_next, var_next), all but a None without ``nxt``."""
    dev = c.device
    C = c.shape[1]
    _check("rows", rows, (5, C), dev)
    _check("mask", mask, (mask.shape[0], C), dev)
    if aprev is not None:
        _check("aprev", aprev, (R * S, C), dev)
    a = torch.empty_like(c)
    c_next = ws = w = b = scale = bias = None
    st = (None, None, None)
    kw, cout = 0, 0
    if nxt is not None:
        w, b, kw, scale, bias = nxt
        cout = w.shape[1]
        _check("w", w, (kw * C, cout), dev)
        for name, t in (("b", b), ("scale", scale), ("bias", bias)):
            _check(name, t, (cout,), dev)
        ws = _workspace("forward", R, S, C, cout, kw, dev)
        c_next = torch.empty((R * S, cout), dtype=torch.float32, device=dev)
        st = _bn_outputs(cout, dev)
    _launch("apply", _lib().focal_ct_apply, dev, c.data_ptr(), rows.data_ptr(), mask.data_ptr(),
            _ptr(aprev), _ptr(w), _ptr(b), _ptr(scale), _ptr(bias), a.data_ptr(), _ptr(c_next),
            *(_ptr(t) for t in st), _ptr(ws), R, S, mask.shape[0], C, cout, kw)
    fused_conv_tower.launches += 1
    return (a, c_next, *st)


def _bwd_stats(da, c, mask, rows, R, S):
    """(s2, m), each [2, C]: s2 = [Σ gy; Σ gy·x̂] over every row (gy the
    gradient at the BN output, x̂ the normalised conv output) and m = s2
    scale / n, the means of dx̂ and dx̂·x̂ (dx̂ = gy scale)."""
    dev = c.device
    C = c.shape[1]
    _check("da", da, (R * S, C), dev)
    ws = _workspace("bwd_stats", R, S, C, C, 1, dev)
    s2 = torch.empty((2, C), dtype=torch.float32, device=dev)
    m = torch.empty((2, C), dtype=torch.float32, device=dev)
    _launch("bwd_stats", _lib().focal_ct_bwd_stats, dev, da.data_ptr(), c.data_ptr(),
            mask.data_ptr(), rows.data_ptr(), s2.data_ptr(), m.data_ptr(), ws.data_ptr(), R, S,
            mask.shape[0], C)
    fused_conv_tower_backward.launches += 1
    return s2, m


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
    ws = _workspace("bwd_apply", R, S, cin, C, kw, dev)
    dprev = torch.empty((R * S, cin), dtype=torch.float32, device=dev)
    dwb = torch.empty(kw * cin * C + C, dtype=torch.float32, device=dev)
    _launch("bwd_apply", _lib().focal_ct_bwd_apply, dev, da.data_ptr(), c.data_ptr(),
            mask.data_ptr(), rows.data_ptr(), m.data_ptr(), aprev.data_ptr(), w.data_ptr(),
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
    x2 = _aligned(x0.reshape(R * S, x0.shape[-1]))
    masks = [_aligned(m) for m in masks]
    L = len(cfgs)
    if external_c0:  # its BN statistics in torch: no conv of the tower produced them
        c = x2
        rows, mu, var = _finalize_stats(torch.stack([c.sum(dim=0), (c * c).sum(dim=0)]), n,
                                        scales[0], biases[0])
    else:
        c, rows, mu, var = _conv0(x2, ws[0], bs[0], scales[0], biases[0], cfgs[0][0], R, S)
    a = None
    a_list, c_list, rows_list, mus, vars_ = [], [], [], [], []
    for k in range(L):
        nxt = None if k + 1 == L else (ws[k + 1], bs[k + 1], cfgs[k + 1][0], scales[k + 1],
                                       biases[k + 1])
        aprev = (a if k > 0 else x2) if cfgs[k][3] else None
        a, c_next, rows_next, mu_next, var_next = _apply(c, rows, masks[k], aprev, nxt, R, S)
        a_list.append(a)
        c_list.append(c)
        rows_list.append(rows)
        mus.append(mu)
        vars_.append(var)
        c, rows, mu, var = c_next, rows_next, mu_next, var_next
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
    L = len(cfgs)
    da = _aligned(da_last.reshape(R * S, cfgs[-1][2]).contiguous())
    dws, dbs, dscales, dbiases = [None] * L, [None] * L, [None] * L, [None] * L
    dx0 = None
    for k in range(L - 1, -1, -1):
        kw, cin, cout, residual = cfgs[k]
        rows = saved.rows_list[k]
        s2, m = _bwd_stats(da, saved.c_list[k], saved.masks[k], rows, R, S)
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

