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

The bf16 forms (``-compute_dtype bfloat16``), #13-bf16 and #14-bf16: the
same wrapper calls on bf16 rows (x0, c, a, da, dc and dprev stored in bf16;
the weights rounded to bf16; the BN rows, masks, sums and parameter
gradients f32), the products on ``wgmma`` fed by TMA (``csrc/gemm_wgmma.cuh``:
row tiles of whole samples read through a 3-D map, the SAME padding TMA's
zero fill), rounding where the JAX package's tower does at ``store_dtype``
bfloat16 (``tower_forward_bf16_reference``,
``tower_backward_bf16_reference``). Their cross-block sums are partials of
the persistent blocks summed in slices (no sum walked on one SM), and a
layer's Σgy and Σgy·x̂ come from the next layer's transposed conv's
epilogue (``_bwd_apply``'s fold), the last layer's from its own pass. A
bf16 x0 takes them; ``fused_conv_tower_bf16.launches`` and
``fused_conv_tower_backward_bf16.launches`` count their calls.

Over several data ranks (``plan``, a ``parallel.mesh.MeshPlan`` with dp >
1: the JAX package's tower over a data mesh normalises with the global
batch's statistics) the same launches write each conv's raw per-channel
sums [2, C] in place of its BatchNorm rows; they are summed over the data
ranks and ``_finalize_stats`` turns them into the rows at the global count
before the next launch; in the backward the sums Σgy and Σgy·x̂ are summed
over the data ranks before their means (the rank's own sums stay its
scale and bias gradients, which the training step sums). The DP-13-14 and
DP-13-14-bf16 rows of ``PERF.md`` are these calls; one process keeps its
launches and bits.

``layer_plan``, ``stages_forward`` and ``stages_backward`` model the
kernels' plan and the order of their sums in plain PyTorch, for the tests.

``fused_conv_tower`` is an autograd function over the whole chain. A CPU
tensor takes the plain version (``fused_conv_tower_reference``, autograd
through torch ops; in bf16 the plain forward and its VJP written out); a
CUDA tensor takes the kernels or raises.
"""

import collections
import ctypes

import torch
import torch.nn.functional as F

from focal_tpu_torch.ops import _build

BN_EPS = 1e-5
_CONV_TOWER_SRC = "conv_tower.cu"
_KINDS = {"forward": 0, "bwd_stats": 1, "bwd_apply": 2, "fold": 3}  # kinds of focal_ct_workspace


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


MAX_CHANNELS = 4096  # kMaxChannels in csrc/conv_tower.cu


def channel_multiple(dtype=torch.float32):
    """The multiple of C the kernels take: 4 in f32 (the products' outputs
    move four channels at a time), 8 in bf16 (the bf16 products stage 16
    bytes, eight channels, of a row at a time, and every layer after the
    first runs on the tensor cores)."""
    return 8 if dtype == torch.bfloat16 else 4


def kernel_refuses(R, S, C, cin, dtype=torch.float32):
    """Why the CUDA kernels (csrc/conv_tower.cu, check_rows and the entry
    points' checks) cannot take a tower of R rows of S positions, C
    channels and a first conv over cin channels in ``dtype``, or None where
    they can: C a multiple of ``channel_multiple(dtype)``, at most
    MAX_CHANNELS channels, 32-bit element offsets."""
    mult = channel_multiple(dtype)
    if C % mult or not mult <= C <= MAX_CHANNELS or not 1 <= cin <= MAX_CHANNELS:
        return (f"unsupported channels C={C} Cin={cin} (C a multiple of {mult}, both <= "
                f"{MAX_CHANNELS})")
    if R < 1 or S < 1 or R * S * max(C, cin) >= 2**31:
        return f"unsupported rows R={R} S={S} at C={C} Cin={cin} (32-bit element offsets)"
    return None


def tower_takes(R, S, C, cin, dtype=torch.float32, kw_max=5):
    """The fused route's gate: ``tower_fits`` (the JAX package's gate, in
    ``dtype``: a bf16 row tile is a multiple of 16 rows) where the kernels
    take the geometry (``kernel_refuses``). Elsewhere the block runs its
    cuDNN convs in its dtype, as with the flag off; the JAX package runs
    its kernel at such widths (C not a multiple of 4, or of 8 in bf16,
    among them), a difference from it that no packaged recipe meets."""
    return tower_fits(R, S, C, dtype, kw_max) and kernel_refuses(R, S, C, cin, dtype) is None


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


def _over_data(plan):
    """Whether a tower's BatchNorm statistics are summed over data ranks."""
    return plan is not None and plan.dp > 1


def fused_conv_tower_reference(x0, layer_cfgs, ws, bs, scales, biases, masks,
                               external_c0=False, plan=None):
    """Plain PyTorch version of fused_conv_tower (the math of the JAX
    package's tests/test_conv_tower.py replica), differentiable by
    autograd. Arguments and results as fused_conv_tower; over several data
    ranks the statistics' sums go through the differentiable sum over
    ``plan.data``. A bf16 x0 takes the bf16 plain versions
    (``_ConvTowerBf16`` with ``plain``)."""
    if x0.dtype == torch.bfloat16:
        cfgs = tuple(tuple(int(v) for v in c) for c in layer_cfgs)
        L = len(cfgs)
        out = _ConvTowerBf16.apply(cfgs, bool(external_c0), True, plan, x0, *ws, *bs, *scales,
                                   *biases, *masks)
        return out[0], tuple(out[1:1 + L]), tuple(out[1 + L:])
    R, S = x0.shape[:2]
    a = None
    mus, vars_ = [], []
    for k, (kw, _, _, residual) in enumerate(layer_cfgs):
        if k == 0 and external_c0:
            c = x0
        else:
            c = _conv_same(a if k > 0 else x0, ws[k], kw) + bs[k]
        if _over_data(plan):
            sums = plan.sum_data(torch.stack([c.sum(dim=(0, 1)), (c * c).sum(dim=(0, 1))]))
            mu = sums[0] / (R * S * plan.dp)
            var = torch.clamp(sums[1] / (R * S * plan.dp) - mu * mu, min=0.0)
        else:
            mu = c.mean(dim=(0, 1))
            var = torch.clamp((c * c).mean(dim=(0, 1)) - mu * mu, min=0.0)
        y = (c - mu) * torch.rsqrt(var + BN_EPS) * scales[k] + biases[k]
        z = gelu_exact(y) * _rows_of(masks[k], R)[:, None, :]
        a = z + a if residual else z
        mus.append(mu.detach())
        vars_.append(var.detach())
    return a, tuple(mus), tuple(vars_)


def round_bf16(t):
    """t rounded to bf16 (round to nearest even), kept in t's type."""
    return t.to(torch.bfloat16).to(t.dtype)


def _data_sums(sums, plan):
    """A rank's raw statistics [2, C] summed over the data ranks (in place),
    and the count they are over: (sums, the ranks' count)."""
    if _over_data(plan):
        return plan.sum_data_(sums), plan.dp
    return sums, 1


def tower_forward_bf16_reference(x0, cfgs, ws, bs, scales, biases, masks, external_c0=False,
                                 plan=None):
    """Plain version of #13-bf16: the JAX package's tower at store_dtype
    bfloat16 (focal_tpu/ops/conv_tower.py:163-203, 403-421): c = im2col(x)
    W (bf16 operands, f32 sums) + b rounded to bf16; the BN sums of the
    stored bf16 c; the statistics, y = c A + B, GELU (the kernels' erf), the
    mask and the residual in f32, a rounded to bf16 once. x0 bf16 (or its
    values in f32), ws f32 or bf16 (rounded here). The f32 steps run in the
    biases' type: float64 biases give a version whose only rounding is to
    bf16, against which a conv bias's true gradient of 0 shows as ~0.
    Returns (a_last bf16 [R, S, C], mus, vars, saved) with saved = {x2, a,
    c, rows, ws} in that type holding bf16 values, for
    tower_backward_bf16_reference. Over several data ranks (``plan``) the
    statistics are the global batch's."""
    R, S, _ = x0.shape
    n = float(R * S * (plan.dp if _over_data(plan) else 1))
    work = bs[0].dtype
    x2 = x0.reshape(R * S, x0.shape[-1]).to(work)
    wb = [round_bf16(w.detach().to(work)) for w in ws]
    if external_c0:
        c = x2
    else:
        c = round_bf16(_conv_same(x2.view(R, S, -1), wb[0], cfgs[0][0]).view(R * S, -1) + bs[0])
    saved = {"x2": x2, "a": [], "c": [], "rows": [], "ws": wb}
    a = None
    mus, vars_ = [], []
    for k, (_, _, cout, residual) in enumerate(cfgs):
        sums = _data_sums(torch.stack([c.sum(0), (c * c).sum(0)]), plan)[0]
        rows, mu, var = _finalize_stats(sums, n, scales[k].detach(), biases[k].detach())
        z = gelu_exact(c * rows[0] + rows[1]) * _rows_of(masks[k], R).repeat_interleave(S, dim=0)
        a = round_bf16(z + (a if k > 0 else x2) if residual else z)
        for key, v in (("a", a), ("c", c), ("rows", rows)):
            saved[key].append(v)
        mus.append(mu)
        vars_.append(var)
        if k + 1 < len(cfgs):
            kw = cfgs[k + 1][0]
            c = round_bf16(_conv_same(a.view(R, S, -1), wb[k + 1], kw).view(R * S, -1) + bs[k + 1])
    return a.view(R, S, cfgs[-1][2]).to(torch.bfloat16), tuple(mus), tuple(vars_), saved


def tower_backward_bf16_reference(saved, cfgs, masks, da_last, external_c0=False, plan=None):
    """Plain version of #14-bf16, the JAX tower's VJP at store_dtype
    bfloat16 (focal_tpu/ops/conv_tower.py:146-160, 206-270, 474-511): gy and
    x̂ in f32 from the bf16 da and c; dc in f32, rounded to bf16 for the
    transposed conv and dW; db the sum of the f32 dc; dprev = convT(dc, W) +
    da rounded to bf16 once; dW in f32. Over several data ranks (``plan``)
    the means m come from the sums over the data ranks. Returns (dx0 bf16,
    dws, dbs, dscales, dbiases) as fused_conv_tower_backward."""
    x2 = saved["x2"]
    RS = x2.shape[0]
    R, S, C = da_last.shape
    n = float(RS * (plan.dp if _over_data(plan) else 1))
    da = da_last.reshape(RS, C).to(x2.dtype)
    L = len(cfgs)
    dws, dbs, dscales, dbiases = ([None] * L for _ in range(4))
    for k in range(L - 1, -1, -1):
        kw, cin, cout, residual = cfgs[k]
        c, rows = saved["c"][k], saved["rows"][k]
        mask = _rows_of(masks[k], R).repeat_interleave(S, dim=0)
        gy = da * mask * gelu_grad_exact(c * rows[0] + rows[1])
        xhat = c * rows[2] - rows[3]
        s2 = torch.stack([gy.sum(0), (gy * xhat).sum(0)])
        m = _data_sums(s2.clone(), plan)[0] * rows[4] / n
        dscales[k], dbiases[k] = s2[1], s2[0]
        dc = rows[2] * (gy * rows[4] - m[0] - xhat * m[1])
        if k == 0 and external_c0:
            dws[0], dbs[0] = torch.zeros_like(saved["ws"][0]), torch.zeros_like(dc[0])
            dx0 = dc
            break
        dcs = round_bf16(dc)
        aprev = saved["a"][k - 1] if k > 0 else x2
        dprev = torch.matmul(im2col_rows(dcs, kw, S, sign=-1),
                             tap_transpose(saved["ws"][k], kw, cin, cout))
        da = round_bf16(dprev + da if residual else dprev)
        dws[k] = torch.matmul(im2col_rows(aprev, kw, S).t(), dcs)
        dbs[k] = dc.sum(0)
        dx0 = da
    return (dx0.to(torch.bfloat16).view(R, S, dx0.shape[-1]), dws, dbs, dscales, dbiases)


class _ConvTowerBf16(torch.autograd.Function):
    """#13-bf16 forward and #14-bf16 backward, or with ``plain`` their plain
    versions. The weights come in f32 and are rounded to bf16 here, so
    their gradients leave in f32 unrounded, as the JAX package's VJP hands
    them to the f32 parameters; dx0 leaves in bf16."""

    @staticmethod
    def forward(ctx, cfgs, external_c0, plain, plan, x0, *flat):
        L = len(cfgs)
        ws, bs, scales, biases, masks = (list(flat[i * L:(i + 1) * L]) for i in range(5))
        ctx.meta = (cfgs, external_c0, plain, plan)
        if plain:
            aL, mus, vars_, saved = tower_forward_bf16_reference(x0, cfgs, ws, bs, scales, biases,
                                                                 masks, external_c0, plan)
            ctx.saved = (saved, masks)
        else:
            wb = [w.to(torch.bfloat16).contiguous() for w in ws]
            aL, mus, vars_, saved = tower_forward(x0, cfgs, wb, bs, scales, biases, masks,
                                                  external_c0, plan)
            ctx.save_for_backward(saved.x2, *saved.a_list, *saved.c_list, *saved.rows_list,
                                  *saved.ws, *saved.masks)
            ctx.R, ctx.S = saved.R, saved.S
        ctx.mark_non_differentiable(*mus, *vars_)
        return (aL, *mus, *vars_)

    @staticmethod
    def backward(ctx, da, *_):
        cfgs, external_c0, plain, plan = ctx.meta
        L = len(cfgs)
        if plain:
            saved, masks = ctx.saved
            grads = tower_backward_bf16_reference(saved, cfgs, masks, da, external_c0, plan)
        else:
            t = ctx.saved_tensors
            x2, parts = t[0], [list(t[1 + i * L:1 + (i + 1) * L]) for i in range(5)]
            grads = fused_conv_tower_backward(
                TowerSaved(cfgs, external_c0, ctx.R, ctx.S, x2, *parts), da, plan)
        return (None, None, None, None, *grads[0:1], *grads[1], *grads[2], *grads[3], *grads[4],
                *([None] * L))


# ---------------------------------------------------------------------------
# the kernels' plan and phase order in plain PyTorch, for the tests: what
# csrc/conv_tower.cu launches and in which order it sums, every product
# through ``gemm`` (torch.matmul, or the 3xTF32 emulation
# pallas_kernels.gemm_3xtf32_reference)

GEMM_BM = 128     # rows of a product tile (kGemmBM)
STAT_ROWS = 256   # rows of a column-sum block and of the narrow first conv (kStatRows)


def on_tensor_cores(cin, dtype=torch.float32):
    """Whether a conv over cin input channels runs as products on the tensor
    cores: a 16-byte piece of its im2col rows (four f32 channels, eight
    bf16) never straddles two taps."""
    return cin % channel_multiple(dtype) == 0


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


def bf16_floats(n):
    """Floats a workspace gives n bf16 values, rounded up to 16 bytes."""
    return _ceil(n, 8) * 4


# the bf16 products' plan (csrc/conv_tower.cu's SampleTiles, ConvPlan16,
# WgradPlan16; gemm_wgmma.cuh's kBM, kBK and wgrad_splits)
WG_BM = 128   # rows of a wgmma product tile
WG_BK = 64    # rows of a weight gradient's K stage


def sample_tiles(R, S, rows):
    """Row tiles of whole samples of rows [R, S, C] (sample_tiles): rb
    samples of sb positions a tile (rb * sb <= rows), or, where a sample is
    longer than ``rows``, s_tiles boxes of sb positions a sample (rb 1).
    Tile t starts at sample t // s_tiles * rb and position t % s_tiles *
    sb."""
    if S <= rows:
        sb, rb, s_tiles = S, min(rows // S, R), 1
    else:
        s_tiles = _ceil(S, rows)
        sb, rb = _ceil(S, s_tiles), 1
    r_tiles = _ceil(R, rb)
    return {"rb": rb, "sb": sb, "s_tiles": s_tiles, "r_tiles": r_tiles,
            "tiles": r_tiles * s_tiles, "rows": rb * sb}


def tile_row_range(st, t, R, S):
    """[start, end) of tile t's rows in [R*S, C] (a tile's rows are
    contiguous there; rows past R or S, and the tile's rows past rb * sb,
    are masked out of it)."""
    r0, s0 = t // st["s_tiles"] * st["rb"], t % st["s_tiles"] * st["sb"]
    if st["s_tiles"] == 1:
        return r0 * S, min(R, r0 + st["rb"]) * S
    return r0 * S + s0, r0 * S + min(S, s0 + st["sb"])


def conv_plan16(R, S, N, sms=132):
    """A bf16 conv's or transposed conv's plan over N output channels
    (conv_plan16): 128-row tiles of whole samples, column tiles of bn (128
    where N is a multiple of 128, else 64), and per column tile per_n
    persistent blocks: block i sums tiles i, i + per_n, ... into its
    partial, per_n column-sum partials."""
    st = sample_tiles(R, S, WG_BM)
    bn = 128 if N % 128 == 0 else 64
    tiles_n = _ceil(N, bn)
    return {"tile": st, "bn": bn, "tiles_n": tiles_n,
            "per_n": max(1, min(st["tiles"], sms // tiles_n))}


def wgrad_splits(rows, wtiles, sms):
    """(splits, rows a split) of a weight gradient over ``rows`` K rows in
    ``wtiles`` output tiles (gemm_wgmma.cuh's wgrad_splits)."""
    best = None
    for n in range(1, max(1, min(_ceil(rows, 256), 8 * sms // wtiles + 1)) + 1):
        r = _ceil(_ceil(rows, n), WG_BK) * WG_BK
        k = _ceil(rows, r)
        span = _ceil(k * wtiles, sms) * (r // WG_BK)
        if best is None or span < best:
            best, splits, rps = span, k, r
    return splits, rps


def wgrad_plan16(R, S, cin, N, kw, sms=132):
    """A bf16 weight gradient's plan (wgrad_plan16): K stages of whole
    samples (up to 64 rows), dW's rows padded per tap to 64-channel blocks
    (m_pad), bn-wide columns, wtiles output tiles, and the stages in
    ``splits`` runs of ``per_split``."""
    st = sample_tiles(R, S, WG_BK)
    m_pad = kw * _ceil(cin, 64) * 64
    bn = 128 if N % 128 == 0 else 64
    wtiles = _ceil(m_pad, WG_BM) * _ceil(N, bn)
    splits, rps = wgrad_splits(st["tiles"] * WG_BK, wtiles, sms)
    return {"tile": st, "m_pad": m_pad, "bn": bn, "wtiles": wtiles, "per_split": rps // WG_BK,
            "splits": splits}


def layer_plan(R, S, kw, cin, C, sms=132, dtype=torch.float32):
    """The launch plan of one layer on a card of ``sms`` SMs, as
    csrc/conv_tower.cu sets it: the route of its conv, its transposed conv
    and its weight gradient; the forward conv's column-sum partials, the
    backward sums' blocks, the weight gradient's tiles and row splits, and
    the workspaces in floats (focal_ct_workspace's kinds 0, 1, 2). In bf16
    on the tensor cores: the products' plan (``conv``: conv_plan16 of the
    conv, ``fold``: of the transposed conv, whose N is cin) with one
    column-sum partial a persistent block, the weight gradient's
    (``wgrad``: wgrad_plan16, ``rows_per_split`` None), and the workspace
    of the fold's partials (kind 3, ``fold``); the weight gradient's
    partials hold dW alone (E = KW*cin*C: db is the sum of the f32 dc, per
    256-row block of the dc pass, ``stat_blocks``) and the backward apply's
    workspace holds dc in bf16, those blocks' sums [blocks, C] and the
    split partials."""
    RS = R * S
    bf16 = dtype == torch.bfloat16
    tc = on_tensor_cores(cin, dtype)
    blocks = _ceil(RS, STAT_ROWS)
    if bf16:
        E = kw * cin * C
        out = {"tensor_cores": tc, "stat_blocks": blocks, "E": E}
        if tc:
            conv, wgrad = conv_plan16(R, S, C, sms), wgrad_plan16(R, S, cin, C, kw, sms)
            fold = conv_plan16(R, S, cin, sms)
            out.update(bn=conv["bn"], conv=conv, fold=fold, wgrad=wgrad,
                       fwd_partials=conv["per_n"], wgrad_tiles=wgrad["wtiles"],
                       splits=wgrad["splits"], rows_per_split=None)
        else:
            splits, rps = split_rows(RS, 1, sms)
            out.update(bn=None, fwd_partials=blocks, wgrad_tiles=1, splits=splits,
                       rows_per_split=rps)
        out["workspace"] = {"forward": out["fwd_partials"] * 2 * C, "bwd_stats": blocks * 2 * C,
                            "bwd_apply": bf16_floats(RS * C) + blocks * C + out["splits"] * E}
        if tc:
            out["workspace"]["fold"] = out["fold"]["per_n"] * 2 * cin
        return out
    E = kw * cin * C + C
    tiles = _ceil(kw * cin, GEMM_BM) * _ceil(C, tile_bn(C)) if tc else 1
    splits, rps = split_rows(RS, tiles, sms)
    partials = _ceil(RS, GEMM_BM) if tc else _ceil(RS, STAT_ROWS)
    bwd_apply = RS * C + (kw * C * cin if tc else 0) + splits * E
    return {"tensor_cores": tc, "bn": tile_bn(C) if tc else None, "fwd_partials": partials,
            "stat_blocks": blocks, "wgrad_tiles": tiles, "splits": splits,
            "rows_per_split": rps, "E": E,
            "workspace": {"forward": partials * 2 * C, "bwd_stats": blocks * 2 * C,
                          "bwd_apply": bwd_apply}}


def shift_rows(x, d, S):
    """x [R*S, cin] with row g replaced by row g + d where its position
    g % S + d stays inside the sample, else by zeros: the loaders' tap
    shift and cp.async's zero-fill (the SAME padding)."""
    g = torch.arange(x.shape[0], device=x.device)
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


SLICES = 8  # kSlices: the slices of the bf16 forms' cross-block sums


def sliced_sum(partials):
    """The bf16 forms' cross-block sum (sliced_sums, and wg_reduce_kernel's
    column part): SLICES runs of consecutive partials, each summed in order,
    then the runs in order."""
    per = _ceil(len(partials), SLICES)
    return ordered_sum([ordered_sum(partials[i:i + per]) if partials[i:i + per]
                        else torch.zeros_like(partials[0]) for i in range(0, SLICES * per, per)])


def block_partials(t, plan, R, S):
    """Column sums of t [R*S, N] as a bf16 product's persistent blocks take
    them (conv_plan16's ``plan``): block i sums its tiles i, i + per_n, ...
    in order, each tile's rows (tile_row_range) summed on their own; one
    partial a block."""
    st, per_n = plan["tile"], plan["per_n"]
    out = []
    for i in range(per_n):
        tiles = [t[a:b].sum(0) for a, b in (tile_row_range(st, k, R, S)
                                             for k in range(i, st["tiles"], per_n))]
        out.append(ordered_sum(tiles))
    return out


def _tile_sums(c, rows):
    return [torch.stack([t.sum(0), (t * t).sum(0)]) for t in c.split(rows)]


def _store(t, dtype):
    """t as the kernels store it: rounded to bf16 (kept in f32) in bf16."""
    return round_bf16(t) if dtype == torch.bfloat16 else t


def stages_conv(x, w, b, kw, S, gemm=torch.matmul, dtype=torch.float32, sms=132):
    """A forward conv as #13 runs it: c = im2col(x) w + b, through ``gemm``
    on the tensor cores or in f32 on the CUDA cores (the narrow first conv),
    and its sums [2, C]: per 128-row tile (256-row block) Σc and Σc²,
    summed in tile order. In bf16 (#13-bf16) x and w hold bf16 values, c is
    rounded to bf16 before its sums, and on the tensor cores the partials
    are the persistent blocks' (block_partials over tiles of whole samples),
    the narrow conv's its 256-row blocks', summed by sliced_sum. Returns (c,
    sums, partials)."""
    tc = on_tensor_cores(x.shape[1], dtype)
    c = _store((gemm if tc else torch.matmul)(im2col_rows(x, kw, S), w) + b, dtype)
    if dtype == torch.bfloat16:
        if tc:
            sq = torch.cat([c, c * c], dim=1)
            n = c.shape[1]
            partials = [torch.stack([p[:n], p[n:]])
                        for p in block_partials(sq, conv_plan16(c.shape[0] // S, S, n, sms),
                                                c.shape[0] // S, S)]
        else:
            partials = _tile_sums(c, STAT_ROWS)
        return c, sliced_sum(partials), partials
    partials = _tile_sums(c, GEMM_BM if tc else STAT_ROWS)
    return c, ordered_sum(partials), partials


def stages_forward(x0, cfgs, ws, bs, scales, biases, masks, external_c0=False, gemm=torch.matmul,
                   dtype=torch.float32, sms=132):
    """#13's phase order: per layer the BN coefficients from the sums, the
    apply pass a_k = GELU(c_k A + B) mask (+ a_{k-1}), then the next conv
    with its tile sums. With ``dtype`` bf16, #13-bf16's: x0 and the weights
    rounded to bf16, c and a stored in bf16 (f32 tensors of bf16 values
    here), the sums stages_conv's on a card of ``sms`` SMs. Returns (a_last
    [R, S, C], mus, vars, saved) with saved = {x2, a, c, rows, ws} per layer
    for stages_backward."""
    R, S, _ = x0.shape
    n = float(R * S)
    x2 = _store(x0.reshape(R * S, x0.shape[-1]).to(torch.float32), dtype)
    ws = [_store(w.to(torch.float32), dtype) for w in ws]
    if external_c0:
        c = x2
        sums = torch.stack([c.sum(dim=0), (c * c).sum(dim=0)])  # tower_forward's, in torch
    else:
        c, sums, _ = stages_conv(x2, ws[0], bs[0], cfgs[0][0], S, gemm, dtype, sms)
    saved = {"x2": x2, "a": [], "c": [], "rows": [], "ws": ws}
    mus, vars_ = [], []
    a = None
    for k, (_, _, _, residual) in enumerate(cfgs):
        rows, mu, var = _finalize_stats(sums, n, scales[k], biases[k])
        z = gelu_exact(c * rows[0] + rows[1]) * _rows_of(masks[k], R).repeat_interleave(S, dim=0)
        aprev = (a if k > 0 else x2) if residual else None
        a = _store(z + aprev if aprev is not None else z, dtype)
        for key, v in (("a", a), ("c", c), ("rows", rows)):
            saved[key].append(v)
        mus.append(mu)
        vars_.append(var)
        if k + 1 < len(cfgs):
            c, sums, _ = stages_conv(a, ws[k + 1], bs[k + 1], cfgs[k + 1][0], S, gemm, dtype,
                                     sms)
    return a.view(R, S, cfgs[-1][2]), tuple(mus), tuple(vars_), saved


def stages_backward(saved, cfgs, ws, masks, da_last, external_c0=False, gemm=torch.matmul,
                    sms=132, dtype=torch.float32):
    """#14's phase order from stages_forward's saved: per layer in reverse
    Σgy and Σgy·x̂ per 256-row block summed in block order, dc, the
    transposed conv (the shifts negated, B the per-tap W^T; + da for a
    residual) and dW | db as partials over the layer plan's fixed row
    splits summed in split order. With ``dtype`` bf16, #14-bf16's: da
    rounded to bf16, dc rounded to bf16 for the transposed conv and dW
    (the weights saved's bf16 ones), dprev stored in bf16; Σgy and Σgy·x̂
    per 256-row block for the last layer, and for every other layer from
    the stored dprev of the layer after it (its da) as that transposed
    conv's persistent blocks take them (block_partials at conv_plan16 over
    the layer's C), summed by sliced_sum; dW over wgrad_plan16's splits of
    whole-sample K stages (split_rows' row splits for a narrow first conv)
    summed in split order; db the f32 dc's column sums per 256-row block of
    the dc pass, summed by sliced_sum. Returns (dx0, dws, dbs, dscales,
    dbiases) as fused_conv_tower_backward, and the layers' partials."""
    x2 = saved["x2"]
    RS = x2.shape[0]
    R, S, C = da_last.shape
    n = float(RS)
    bf16 = dtype == torch.bfloat16
    ws = saved["ws"] if bf16 else ws
    da = _store(da_last.reshape(RS, C).to(torch.float32), dtype)
    L = len(cfgs)
    dws, dbs, dscales, dbiases, partials = ([None] * L for _ in range(5))
    for k in range(L - 1, -1, -1):
        kw, cin, cout, residual = cfgs[k]
        c, rows = saved["c"][k], saved["rows"][k]
        mask = _rows_of(masks[k], R).repeat_interleave(S, dim=0)
        gy = da * mask * gelu_grad_exact(c * rows[0] + rows[1])
        xhat = c * rows[2] - rows[3]
        if bf16 and k + 1 < L:  # the fold: layer k+1's transposed conv's blocks
            both = torch.cat([gy, gy * xhat], dim=1)
            s2 = sliced_sum([torch.stack([p[:cout], p[cout:]]) for p in block_partials(
                both, conv_plan16(R, S, cout, sms), R, S)])
        else:
            blocks = [torch.stack([g.sum(0), (g * x).sum(0)])
                      for g, x in zip(gy.split(STAT_ROWS), xhat.split(STAT_ROWS))]
            s2 = sliced_sum(blocks) if bf16 else ordered_sum(blocks)
        m = s2 * rows[4] / n
        dscales[k], dbiases[k] = s2[1], s2[0]
        dc = rows[2] * (gy * rows[4] - m[0] - xhat * m[1])
        if k == 0 and external_c0:
            dws[0], dbs[0] = torch.zeros_like(ws[0]), torch.zeros(cout)
            dx0 = _store(dc, dtype)
            break
        aprev = saved["a"][k - 1] if k > 0 else x2
        tc = on_tensor_cores(cin, dtype)
        dcs = _store(dc, dtype)
        dprev = (gemm if tc else torch.matmul)(im2col_rows(dcs, kw, S, sign=-1),
                                              tap_transpose(ws[k], kw, cin, cout))
        if residual:
            dprev = dprev + da
        dprev = _store(dprev, dtype)
        cols = im2col_rows(aprev, kw, S)
        plan = layer_plan(R, S, kw, cin, cout, sms, dtype)
        if bf16 and tc:
            spans = wgrad_split_rows(plan["wgrad"], R, S)
        else:
            rps = plan["rows_per_split"]
            spans = [(r0, min(RS, r0 + rps)) for r0 in range(0, RS, rps)]
        parts = [torch.cat([(gemm if tc else torch.matmul)(cols[a:b].t().contiguous(),
                                                           dcs[a:b]).flatten()]
                           + ([] if bf16 else [dc[a:b].sum(0)]))
                 for a, b in spans]
        total = ordered_sum(parts)
        if bf16:
            dws[k] = total.view(kw * cin, cout)
            dbs[k] = sliced_sum([t.sum(0) for t in dc.split(STAT_ROWS)])
        else:
            dws[k], dbs[k] = total[:-cout].view(kw * cin, cout), total[-cout:]
        partials[k] = parts
        da = dprev
        dx0 = dprev
    return (dx0.view(R, S, dx0.shape[-1]), dws, dbs, dscales, dbiases), partials


def wgrad_split_rows(wplan, R, S):
    """[start, end) rows of each split of a bf16 weight gradient
    (wgrad_plan16's ``wplan``): its run of K stages, tiles of whole samples,
    is a contiguous range of rows."""
    st, per = wplan["tile"], wplan["per_split"]
    out = []
    for k in range(wplan["splits"]):
        first, last = k * per, min(st["tiles"], (k + 1) * per) - 1
        out.append((tile_row_range(st, first, R, S)[0], tile_row_range(st, last, R, S)[1]))
    return out


def gelu_grad_exact(z):
    """GELU'(z) with the kernels' erf."""
    return (0.5 * (1.0 + _erf(z * 0.7071067811865476))
            + z * torch.exp(-0.5 * z * z) * 0.3989422804014327)


# ---------------------------------------------------------------------------
# the kernels' wrappers (CUDA tensors only)


def _lib():
    lib = _build.load(_CONV_TOWER_SRC)
    if lib.focal_ct_conv0.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.focal_ct_workspace.argtypes = [i] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.focal_ct_conv0.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.focal_ct_apply.argtypes = [p] * 14 + [i] * 7 + [p]
        lib.focal_ct_bwd_stats.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.focal_ct_bwd_apply.argtypes = [p] * 14 + [i] * 9 + [p]
        lib.focal_ct_bwd_dc.argtypes = [p] * 6 + [i] * 5 + [p]
        for fn in (lib.focal_ct_workspace, lib.focal_ct_conv0, lib.focal_ct_apply,
                   lib.focal_ct_bwd_stats, lib.focal_ct_bwd_apply, lib.focal_ct_bwd_dc):
            fn.restype = ctypes.c_int
        lib.focal_cuda_error_string.argtypes = [i]
        lib.focal_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, device, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"conv tower: {name} must be {dtype}, got {t.dtype}")
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


def _is_bf16(t):
    """The kernels' row-type flag: 1 for bf16 rows (#13-bf16, #14-bf16)."""
    return int(t.dtype == torch.bfloat16)


def _forward_count(t):
    """The function whose launch count a forward call on rows t adds to."""
    return fused_conv_tower_bf16 if _is_bf16(t) else fused_conv_tower


def _backward_count(t):
    return fused_conv_tower_backward_bf16 if _is_bf16(t) else fused_conv_tower_backward


def _workspace(kind, R, S, cin, cout, kw, dev, bf16=0):
    lib = _lib()
    floats = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        err = lib.focal_ct_workspace(_KINDS[kind], R, S, cin, cout, kw, bf16,
                                     ctypes.byref(floats))
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


def _bn_outputs(cout, dev, sums=False):
    """rows [5, cout], mu and var [cout], for a conv's BatchNorm; with
    ``sums`` the raw sums [2, cout] alone (several data ranks), mu and var
    None."""
    f32 = torch.float32
    if sums:
        return torch.empty((2, cout), dtype=f32, device=dev), None, None
    return (torch.empty((5, cout), dtype=f32, device=dev), torch.empty(cout, dtype=f32, device=dev),
            torch.empty(cout, dtype=f32, device=dev))


def _conv0(x2, w, b, scale, bias, kw, R, S):
    """First conv of an internal-c0 tower: x [R*S, Cin] -> c [R*S, Cout] and
    from its batch statistics the BN rows [5, Cout] (scale and bias: its
    BatchNorm's affine), mu and var. Returns (c, rows, mu, var). With scale
    and bias None: (c, the raw sums [Σc; Σc²] [2, Cout], None, None), for
    the caller to sum over data ranks. x, w and c are f32, or bf16 for
    #13-bf16."""
    dev = x2.device
    cin = x2.shape[1]
    cout = w.shape[1]
    _check("w", w, (kw * cin, cout), dev, x2.dtype)
    for name, t in (("b", b), ("scale", scale), ("bias", bias)):
        if t is not None:
            _check(name, t, (cout,), dev)
    bf16 = _is_bf16(x2)
    ws = _workspace("forward", R, S, cin, cout, kw, dev, bf16)
    c = torch.empty((R * S, cout), dtype=x2.dtype, device=dev)
    rows, mu, var = _bn_outputs(cout, dev, sums=scale is None)
    _launch("conv0", _lib().focal_ct_conv0, dev, x2.data_ptr(), w.data_ptr(), b.data_ptr(),
            _ptr(scale), _ptr(bias), c.data_ptr(), rows.data_ptr(), _ptr(mu), _ptr(var),
            ws.data_ptr(), R, S, cin, cout, kw, bf16)
    _forward_count(x2).launches += 1
    return c, rows, mu, var


def _apply(c, rows, mask, aprev, nxt, R, S):
    """Layer k's apply: a = GELU(c*A + B) * mask [+ aprev]; with ``nxt`` =
    (w, b, kw, scale, bias) of layer k+1 also its conv and, from that conv's
    batch statistics, its BN rows, mu and var (scale and bias None: the raw
    sums [2, cout] in place of the rows, as _conv0). Returns (a, c_next,
    rows_next, mu_next, var_next), all but a None without ``nxt``. The rows
    (c, aprev, a, w, c_next) are f32, or bf16 for #13-bf16."""
    dev = c.device
    C = c.shape[1]
    _check("rows", rows, (5, C), dev)
    _check("mask", mask, (mask.shape[0], C), dev)
    if aprev is not None:
        _check("aprev", aprev, (R * S, C), dev, c.dtype)
    a = torch.empty_like(c)
    c_next = ws = w = b = scale = bias = None
    st = (None, None, None)
    kw, cout = 0, 0
    if nxt is not None:
        w, b, kw, scale, bias = nxt
        cout = w.shape[1]
        _check("w", w, (kw * C, cout), dev, c.dtype)
        for name, t in (("b", b), ("scale", scale), ("bias", bias)):
            if t is not None:
                _check(name, t, (cout,), dev)
        ws = _workspace("forward", R, S, C, cout, kw, dev, _is_bf16(c))
        c_next = torch.empty((R * S, cout), dtype=c.dtype, device=dev)
        st = _bn_outputs(cout, dev, sums=scale is None)
    _launch("apply", _lib().focal_ct_apply, dev, c.data_ptr(), rows.data_ptr(), mask.data_ptr(),
            _ptr(aprev), _ptr(w), _ptr(b), _ptr(scale), _ptr(bias), a.data_ptr(), _ptr(c_next),
            *(_ptr(t) for t in st), _ptr(ws), R, S, mask.shape[0], C, cout, kw, _is_bf16(c))
    _forward_count(c).launches += 1
    return (a, c_next, *st)


def _bwd_stats(da, c, mask, rows, R, S, means=True, folded=None):
    """(s2, m), each [2, C]: s2 = [Σ gy; Σ gy·x̂] over every row (gy the
    gradient at the BN output, x̂ the normalised conv output) and m = s2
    scale / n, the means of dx̂ and dx̂·x̂ (dx̂ = gy scale); without
    ``means`` m is None (several data ranks: the caller sums s2 first).
    ``folded`` (bf16): the partials of those sums that the next layer's
    backward apply took in its transposed conv's epilogue (``_bwd_apply``'s
    fold), which this launch only adds up; da is then not read."""
    dev = c.device
    C = c.shape[1]
    _check("da", da, (R * S, C), dev, c.dtype)
    ws = None if folded is not None else _workspace("bwd_stats", R, S, C, C, 1, dev, _is_bf16(c))
    s2 = torch.empty((2, C), dtype=torch.float32, device=dev)
    m = torch.empty((2, C), dtype=torch.float32, device=dev) if means else None
    _launch("bwd_stats", _lib().focal_ct_bwd_stats, dev, da.data_ptr(), c.data_ptr(),
            mask.data_ptr(), rows.data_ptr(), s2.data_ptr(), _ptr(m), _ptr(ws), _ptr(folded), R,
            S, mask.shape[0], C, _is_bf16(c))
    _backward_count(c).launches += 1
    return s2, m


def _bwd_apply(da, c, mask, rows, m, aprev, w, kw, residual, R, S, fold=None):
    """dc (the BN input gradient), then dprev = convT(dc, W) [+ da], dW
    [KW*Cin, Cout] and db [Cout]. Returns (dprev, dW, db, folded): dprev in
    the rows' type (bf16 for #14-bf16), dW and db f32. ``fold`` (bf16
    only): the previous layer's (c, mask, rows), whose BatchNorm backward
    sums the transposed conv's epilogue takes from the stored dprev, its da;
    folded is then their partials for that layer's ``_bwd_stats``, else
    None."""
    dev = c.device
    C = c.shape[1]
    cin = aprev.shape[1]
    _check("da", da, (R * S, C), dev, c.dtype)
    _check("aprev", aprev, (R * S, cin), dev, c.dtype)
    _check("w", w, (kw * cin, C), dev, c.dtype)
    if residual and cin != C:
        raise ValueError(f"conv tower: a residual layer needs Cin == Cout, got {cin} and {C}")
    bf16 = _is_bf16(c)
    ws = _workspace("bwd_apply", R, S, cin, C, kw, dev, bf16)
    dprev = torch.empty((R * S, cin), dtype=c.dtype, device=dev)
    dwb = torch.empty(kw * cin * C + C, dtype=torch.float32, device=dev)
    fc = fmask = frows = folded = None
    if fold is not None:
        fc, fmask, frows = fold
        _check("fold c", fc, (R * S, cin), dev, c.dtype)
        _check("fold mask", fmask, (fmask.shape[0], cin), dev)
        _check("fold rows", frows, (5, cin), dev)
        folded = _workspace("fold", R, S, cin, cin, kw, dev, bf16)
    _launch("bwd_apply", _lib().focal_ct_bwd_apply, dev, da.data_ptr(), c.data_ptr(),
            mask.data_ptr(), rows.data_ptr(), m.data_ptr(), aprev.data_ptr(), w.data_ptr(),
            dprev.data_ptr(), dwb.data_ptr(), ws.data_ptr(), _ptr(fc), _ptr(fmask), _ptr(frows),
            _ptr(folded), R, S, mask.shape[0], C, cin, kw, int(bool(residual)),
            0 if fmask is None else fmask.shape[0], bf16)
    _backward_count(c).launches += 1
    return dprev, dwb[:kw * cin * C].view(kw * cin, C), dwb[kw * cin * C:], folded


def _bwd_dc(da, c, mask, rows, m, R, S):
    """dc alone: the input gradient of an external first conv's output."""
    dev = c.device
    C = c.shape[1]
    _check("da", da, (R * S, C), dev, c.dtype)
    dc = torch.empty_like(c)
    _launch("bwd_dc", _lib().focal_ct_bwd_dc, dev, da.data_ptr(), c.data_ptr(), mask.data_ptr(),
            rows.data_ptr(), m.data_ptr(), dc.data_ptr(), R, S, mask.shape[0], C, _is_bf16(c))
    _backward_count(c).launches += 1
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
    if x0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_conv_tower: x0 must be float32 or bfloat16, got {x0.dtype}")
    _check("x0", x0, (R, S, cfgs[0][2] if external_c0 else cfgs[0][1]), dev, x0.dtype)
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


def tower_forward(x0, cfgs, ws, bs, scales, biases, masks, external_c0, plan=None):
    """#13 over the chain on the card (#13-bf16 for a bf16 x0, whose
    weights ws must then be bf16): (a_last [R, S, C], mus, vars, TowerSaved
    for the backward). Over several data ranks (``plan``) each conv's
    launch writes its raw sums, summed over the ranks and finalised here."""
    _check_tower(x0, cfgs, masks, external_c0)
    R, S, _ = x0.shape
    dp = plan.dp if _over_data(plan) else 1
    n = float(R * S * dp)
    x2 = _aligned(x0.reshape(R * S, x0.shape[-1]))
    masks = [_aligned(m) for m in masks]
    L = len(cfgs)

    def affine(k):  # what a conv's launch takes: the affine, or None for its raw sums
        return (scales[k], biases[k]) if dp == 1 else (None, None)

    def finish(k, c, rows, mu, var):  # the global rows from a rank's raw sums
        if dp == 1:
            return c, rows, mu, var
        return (c, *_finalize_stats(_data_sums(rows, plan)[0], n, scales[k], biases[k]))

    if external_c0:  # its BN statistics in torch: no conv of the tower produced them
        c = x2
        cf = c.float()
        sums = _data_sums(torch.stack([cf.sum(dim=0), (cf * cf).sum(dim=0)]), plan)[0]
        rows, mu, var = _finalize_stats(sums, n, scales[0], biases[0])
    else:
        c, rows, mu, var = finish(0, *_conv0(x2, ws[0], bs[0], *affine(0), cfgs[0][0], R, S))
    a = None
    a_list, c_list, rows_list, mus, vars_ = [], [], [], [], []
    for k in range(L):
        nxt = None if k + 1 == L else (ws[k + 1], bs[k + 1], cfgs[k + 1][0], *affine(k + 1))
        aprev = (a if k > 0 else x2) if cfgs[k][3] else None
        a, *rest = _apply(c, rows, masks[k], aprev, nxt, R, S)
        c_next, rows_next, mu_next, var_next = rest if nxt is None else finish(k + 1, *rest)
        a_list.append(a)
        c_list.append(c)
        rows_list.append(rows)
        mus.append(mu)
        vars_.append(var)
        c, rows, mu, var = c_next, rows_next, mu_next, var_next
    saved = TowerSaved(cfgs, external_c0, R, S, x2, a_list, c_list, rows_list, ws, masks)
    return a.view(R, S, cfgs[-1][2]), tuple(mus), tuple(vars_), saved


def fused_conv_tower_backward(saved, da_last, plan=None):
    """#14 over the chain in reverse on the card: the VJP of
    fused_conv_tower at ``saved`` (tower_forward's) for the gradient
    da_last [R, S, C] of its output. Returns (dx0, dws, dbs, dscales,
    dbiases); with an external first conv dws[0] and dbs[0] are zeros (its
    gradient flows on through dx0). Every cross-row sum is a fixed-order
    reduction: two calls give the same bits. Over several data ranks
    (``plan``) the BatchNorm backward's means come from its sums over the
    ranks, m = Σ s2 scale / n at the global count.

    Replaces focal_tpu/ops/conv_tower.py's op_bwd (_bwd_stats_kernel,
    _bwd_apply_kernel, _bwd_dc_kernel); fused_conv_tower_backward.launches
    counts its kernel calls."""
    cfgs, R, S = saved.cfgs, saved.R, saved.S
    L = len(cfgs)
    da = _aligned(da_last.reshape(R * S, cfgs[-1][2]).contiguous())
    dws, dbs, dscales, dbiases = [None] * L, [None] * L, [None] * L, [None] * L
    dx0 = folded = None
    dp = plan.dp if _over_data(plan) else 1
    bf16 = saved.x2.dtype == torch.bfloat16
    for k in range(L - 1, -1, -1):
        kw, cin, cout, residual = cfgs[k]
        rows = saved.rows_list[k]
        s2, m = _bwd_stats(da, saved.c_list[k], saved.masks[k], rows, R, S, means=dp == 1,
                           folded=folded)
        if dp > 1:  # the kernel's m = s2 scale / n, over every data rank's rows
            m = _data_sums(s2.clone(), plan)[0] * rows[4] / float(R * S * dp)
        dscales[k], dbiases[k] = s2[1], s2[0]
        if k == 0 and saved.external_c0:
            dx0 = _bwd_dc(da, saved.c_list[0], saved.masks[0], rows, m, R, S)
            dws[0] = torch.zeros_like(saved.ws[0])
            dbs[0] = torch.zeros(cout, dtype=torch.float32, device=da.device)
            break
        aprev = saved.a_list[k - 1] if k > 0 else saved.x2
        fold = ((saved.c_list[k - 1], saved.masks[k - 1], saved.rows_list[k - 1])
                if bf16 and k > 0 else None)
        dprev, dws[k], dbs[k], folded = _bwd_apply(da, saved.c_list[k], saved.masks[k], rows, m,
                                                   aprev, saved.ws[k], kw, residual, R, S, fold)
        if k > 0:
            da = dprev
        else:
            dx0 = dprev
    return dx0.view(R, S, dx0.shape[-1]), dws, dbs, dscales, dbiases


fused_conv_tower_backward.launches = 0


class _ConvTower(torch.autograd.Function):
    """#13 forward, #14 backward (the JAX package's jax.custom_vjp)."""

    @staticmethod
    def forward(ctx, cfgs, external_c0, plan, x0, *flat):
        L = len(cfgs)
        ws, bs, scales, biases, masks = (list(flat[i * L:(i + 1) * L]) for i in range(5))
        ws = [w.contiguous() for w in ws]
        aL, mus, vars_, saved = tower_forward(x0, cfgs, ws, bs, scales, biases, masks, external_c0,
                                              plan)
        ctx.meta = (cfgs, external_c0, saved.R, saved.S, plan)
        ctx.save_for_backward(saved.x2, *saved.a_list, *saved.c_list, *saved.rows_list,
                              *saved.ws, *saved.masks)
        ctx.mark_non_differentiable(*mus, *vars_)
        return (aL, *mus, *vars_)

    @staticmethod
    def backward(ctx, da, *_):
        cfgs, external_c0, R, S, plan = ctx.meta
        L = len(cfgs)
        t = ctx.saved_tensors
        x2, parts = t[0], [list(t[1 + i * L:1 + (i + 1) * L]) for i in range(5)]
        saved = TowerSaved(cfgs, external_c0, R, S, x2, *parts)
        dx0, dws, dbs, dscales, dbiases = fused_conv_tower_backward(saved, da, plan)
        return (None, None, None, dx0, *dws, *dbs, *dscales, *dbiases, *([None] * L))


def fused_conv_tower(x0, layer_cfgs, ws, bs, scales, biases, masks, external_c0=False,
                     plan=None):
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

    A bf16 x0 takes #13-bf16 and #14-bf16 (``-compute_dtype bfloat16``):
    ws stay f32 (the parameters' views) and are rounded to bf16 inside,
    a_last and the gradient of x0 are bf16, the other gradients f32.

    ``plan`` (a ``parallel.mesh.MeshPlan``): over several data ranks x0 is
    the rank's rows and the BatchNorm statistics (mus, vars too) are the
    global batch's (DP-13-14, DP-13-14-bf16), the JAX tower's under a data
    mesh; the scale and bias gradients stay the rank's part.

    Replaces focal_tpu/ops/conv_tower.py::fused_conv_tower (_conv0_kernel,
    _apply_kernel; their VJP #14), fed f32 or bf16. CPU tensors take the
    plain version."""
    cfgs = tuple(tuple(int(v) for v in c) for c in layer_cfgs)
    if x0.device.type == "cpu":
        return fused_conv_tower_reference(x0, cfgs, ws, bs, scales, biases, masks, external_c0,
                                          plan)
    L = len(cfgs)
    if x0.dtype == torch.bfloat16:
        out = _ConvTowerBf16.apply(cfgs, bool(external_c0), False, plan, x0, *ws, *bs, *scales,
                                   *biases, *masks)
    else:
        out = _ConvTower.apply(cfgs, bool(external_c0), plan, x0, *ws, *bs, *scales, *biases,
                               *masks)
    return out[0], tuple(out[1:1 + L]), tuple(out[1 + L:])


fused_conv_tower.launches = 0



def fused_conv_tower_bf16(x0, layer_cfgs, ws, bs, scales, biases, masks, external_c0=False,
                          plan=None):
    """#13-bf16, with #14-bf16 (``fused_conv_tower_backward_bf16``) as its
    backward: ``fused_conv_tower`` on a bf16 x0 (f32 ws rounded inside).
    ``fused_conv_tower_bf16.launches`` counts #13-bf16's kernel calls, as
    ``fused_conv_tower.launches`` counts #13's.

    Replaces focal_tpu/ops/conv_tower.py::fused_conv_tower fed bf16
    (store_dtype bfloat16)."""
    if x0.dtype != torch.bfloat16:
        raise TypeError(f"fused_conv_tower_bf16: x0 must be bfloat16, got {x0.dtype}")
    return fused_conv_tower(x0, layer_cfgs, ws, bs, scales, biases, masks, external_c0, plan)


fused_conv_tower_bf16.launches = 0


def fused_conv_tower_backward_bf16(saved, da_last, plan=None):
    """#14-bf16: ``fused_conv_tower_backward`` at a bf16 tower's saved
    (tower_forward on bf16 rows and weights); dx0 bf16, the rest f32.
    ``fused_conv_tower_backward_bf16.launches`` counts its kernel calls.

    Replaces focal_tpu/ops/conv_tower.py's op_bwd at store_dtype bfloat16."""
    if saved.x2.dtype != torch.bfloat16:
        raise TypeError(f"fused_conv_tower_backward_bf16: saved rows are {saved.x2.dtype}")
    return fused_conv_tower_backward(saved, da_last, plan)


fused_conv_tower_backward_bf16.launches = 0
