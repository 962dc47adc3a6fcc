"""Shared building blocks (port of the JAX package's ``models/layers.py``):
DeepSense's conv blocks and bidirectional GRU, the heads and fusion
blocks of both backbones, and SW_Transformer's location-context layer.

Conv blocks take NHWC input ([b, interval, spectrum, channel]), as the JAX
package's do. The unfused path convolves in NCHW with cuDNN in full f32
(TF32 off, as the JAX package computes in f32); the fused path
(``use_pallas``, training only) runs the conv tower of
``ops/conv_tower.py``, whose kernels are #13/#14. Module names are the flax
tree's (``ConvLayer2D_{k}.Conv_0``, ``.BatchNorm_0``, ``out_proj``,
``gru{k}``); BatchNorm keeps ``weight``/``bias`` and the buffers ``mean``
and ``var``.

In ``train()`` mode the dropout of a block takes the step's ``rng``
(``ops.dropout.StepRngs``) and draws its masks from ``rng.device``.

``compute_dtype`` bf16 rounds where flax does at ``dtype=bfloat16``: a conv
block's convs, BatchNorms, GELUs, dropouts, residual adds and ``out_proj``
in bf16 (``conv2d_low``, ``BatchNorm``'s f32 normalisation rounded once),
its fused tower through #13-bf16/#14-bf16; the GRU in f32.

Across processes (``plan``, a ``parallel.mesh.MeshPlan``, set by
``models.registry.apply_plan``): a ``Dense`` that ``parallel.tp`` cut runs its
part of a column- or row-parallel product, with the model axis's sums
(``tp_role``); the attentions run the heads of their cut q, k and v; a
training ``BatchNorm`` takes its statistics over the global batch, summed
over the data ranks (the fused tower too: ``ops.conv_tower``'s ``plan``).
A ``ConvBlock`` whose convs ``parallel.tp`` cut by output channels computes
the rank's channels of each layer from the whole input (the model ranks'
channels gathered with autograd before every conv after the first and
before ``out_proj``), its BatchNorms on those channels (their running
statistics the rank's slice), the residual adds on them, its Dropout2d
masks from the split generator; ``out_proj`` is column-parallel, its
output gathered.
"""

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from focal_tpu_torch.ops.conv_tower import BN_EPS, fused_conv_tower, tower_takes
from focal_tpu_torch.ops.dropout import keep_mask, needs_rng
from focal_tpu_torch.parallel.distributed import copy_to, gather_from, reduce_from

BN_MOMENTUM = 0.9  # flax's: running = 0.9 running + 0.1 batch (torch momentum 0.1)


class Dense(nn.Linear):
    """nn.Linear that computes in ``compute_dtype`` as flax's ``nn.Dense(dtype=
    ...)`` does: the f32 parameters cast at use, x W^T rounded to the dtype,
    then the bias added in it (two roundings, as flax's dot and ``y +=
    bias``). In f32 it is nn.Linear. The parameters stay f32 whatever the
    dtype; their gradients reach them through the casts.

    ``tp_role`` says how the product splits once ``parallel.tp.shard_model``
    has cut its weight (``tp_sharded``): "column" (the rank's output columns;
    x enters by ``copy_to``, so its gradient sums over the model ranks),
    "column_gather" (the same, the columns gathered after) or "row" (the
    rank's input columns; the partial products summed over the model ranks,
    then the whole bias added)."""

    def __init__(self, in_features, out_features, bias=True, compute_dtype=torch.float32,
                 tp_role=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        self.tp_role = tp_role
        self.plan = None
        self.tp_sharded = False

    def _linear(self, x, bias):
        dt = self.compute_dtype
        if dt == torch.float32:
            return F.linear(x, self.weight, bias)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if bias is None else y + bias.to(dt)

    def forward(self, x):
        if not self.tp_sharded:
            return self._linear(x, self.bias)
        group = self.plan.model
        if self.tp_role == "row":
            y = reduce_from(self._linear(x, None), group)
            return y if self.bias is None else y + self.bias.to(y.dtype)
        y = self._linear(copy_to(x, group), self.bias)
        return gather_from(y, group, dim=-1) if self.tp_role == "column_gather" else y


def gelu(x):
    """Exact (erf) GELU in x's type. f32 is F.gelu; a lower precision rounds
    where the JAX package's ``nn.gelu(approximate=False)`` does, each op in
    the type: (0.5 x) erfc(-x sqrt(0.5)), sqrt(0.5) itself rounded (F.gelu
    on bf16 rounds once, at the end, and differs in a third of the values)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    return (0.5 * x) * torch.special.erfc(-x * torch.tensor(0.5**0.5, dtype=x.dtype))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm that computes in ``compute_dtype`` as flax 0.12's
    ``nn.LayerNorm(dtype=...)`` does (``force_float32_reductions``): the
    statistics, the normalisation, scale and bias in f32 on the upcast
    input, the result rounded to the dtype. In f32 it is nn.LayerNorm. (The
    f32 statistics are PyTorch's, as the f32 path's are, where flax takes
    E[x^2] - E[x]^2: they differ in f32 rounding only, far below the bf16
    rounding of the output; one fused op, where the formula written out cost
    ~30 eager ops a LayerNorm in a training step.)"""

    def __init__(self, dim, eps=1e-5, compute_dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        return super().forward(x.to(torch.float32)).to(self.compute_dtype)


def conv2d_low(x, weight, bias, stride, dtype):
    """flax's ``nn.Conv(dtype=...)`` below f32 (NCHW, no padding): x and the
    f32 kernel cast to ``dtype``, the conv's f32 sums rounded to it once,
    then the bias added in it (flax's ``y += bias``). On the card a cuDNN
    conv in ``dtype``; on the CPU an f32 conv of the cast operands rounded
    once, which is what XLA's CPU conv gives bit for bit (torch's CPU bf16
    conv lands 1 ulp off in ~0.02 % of the outputs). The gradients of x,
    the kernel and the bias come back through the casts, rounded to the
    dtype as the JAX package's are."""
    xd, wd = x.to(dtype), weight.to(dtype)
    if x.device.type == "cpu":
        y = F.conv2d(xd.to(torch.float32), wd.to(torch.float32), None, stride).to(dtype)
    else:
        y = F.conv2d(xd, wd, None, stride)
    return y + bias.to(dtype)[:, None, None]


def conv2d_f32(x, weight, bias, stride):
    """F.conv2d (NCHW, no padding) with cuDNN's TF32 off: full f32."""
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    benchmark=torch.backends.cudnn.benchmark,
                                    deterministic=torch.backends.cudnn.deterministic,
                                    allow_tf32=False):
        return F.conv2d(x, weight, bias, stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over every axis but
    the channels (dim 1). Training normalises with the batch's mean and its
    biased variance by the fast formula, E[x^2] - E[x]^2 clipped at 0, and
    folds them into the running ``mean``/``var`` with momentum 0.9; eval
    normalises with the running ones. A bf16 x is upcast: the statistics
    and the normalisation run in f32 and the result is rounded to bf16
    once (flax 0.12's ``force_float32_reductions``); the running
    statistics stay f32. ``statistics_frozen`` stops the fold for a
    replayed forward (GradCache's second pass)."""

    fold = True

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.plan = None  # over several data ranks: the global batch's statistics

    @torch.no_grad()
    def update(self, mu, var):
        """Fold one batch's statistics into the running ones."""
        if not self.fold:
            return
        self.mean.copy_(BN_MOMENTUM * self.mean + (1.0 - BN_MOMENTUM) * mu)
        self.var.copy_(BN_MOMENTUM * self.var + (1.0 - BN_MOMENTUM) * var)

    def forward(self, x):
        dtype = x.dtype
        x = x.to(torch.float32)
        dims = [d for d in range(x.dim()) if d != 1]
        if self.training and self.plan is not None and self.plan.dp > 1:
            # E[x] and E[x^2] over every data rank's rows, a differentiable sum
            sums = self.plan.sum_data(torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims)]))
            n = x.numel() // x.shape[1] * self.plan.dp
            mu = sums[0] / n
            var = torch.clamp(sums[1] / n - mu * mu, min=0.0)
            self.update(mu.detach(), var.detach())
        elif self.training:
            mu = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mu * mu, min=0.0)
            self.update(mu.detach(), var.detach())
        else:
            mu, var = self.mean, self.var
        shape = [1, -1] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x - mu.view(shape)) * mul.view(shape) + self.bias.view(shape)).to(dtype)


@contextlib.contextmanager
def statistics_frozen(model):
    """No BatchNorm of ``model`` folds its batch statistics inside the
    block: a forward replayed for its gradient (the JAX package discards
    the second pass's ``batch_stats``)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.fold = False
    try:
        yield
    finally:
        for m in norms:
            del m.fold


class ConvLayer2D(nn.Module):
    """conv2d + BatchNorm + exact GELU + Dropout2d (whole (sample, channel)
    planes), NCHW in and out. Padding SAME at stride 1 (flax's split:
    (k-1)//2 before), VALID otherwise. Below f32 (``compute_dtype``) each
    step rounds as flax's does: ``conv2d_low``, the BatchNorm rounded once,
    ``gelu`` in the dtype, and the dropout as flax's ``nn.Dropout``, the
    kept values divided by 1 - rate rounded to the dtype."""

    def __init__(self, cin, features, kernel_size, stride=(1, 1), dropout_ratio=0.0,
                 compute_dtype=torch.float32):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.dropout_ratio = float(dropout_ratio)
        self.compute_dtype = compute_dtype
        self.Conv_0 = nn.Conv2d(cin, features, self.kernel_size, self.stride)
        self.BatchNorm_0 = BatchNorm(features)

    def conv(self, x):
        if max(self.stride) == 1:
            kh, kw = self.kernel_size
            x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
        if self.compute_dtype == torch.float32:
            return conv2d_f32(x, self.Conv_0.weight, self.Conv_0.bias, self.stride)
        return conv2d_low(x, self.Conv_0.weight, self.Conv_0.bias, self.stride, self.compute_dtype)

    @property
    def tp_sharded(self):
        """Whether ``parallel.tp`` cut this layer's output channels."""
        return getattr(self.Conv_0, "tp_sharded", False)

    def forward(self, x, rng=None):
        x = gelu(self.BatchNorm_0(self.conv(x)))
        if self.training and self.dropout_ratio > 0.0:
            rng = needs_rng(rng, "Dropout2d")
            gen = rng.split if self.tp_sharded else rng.device
            mask = keep_mask(x.shape[:2], self.dropout_ratio, gen)[:, :, None, None]
            if x.dtype == torch.float32:
                x = x * mask
            else:  # flax: select(keep, x / keep_prob, 0), keep_prob a weak-typed scalar
                keep_prob = torch.tensor(1.0 - self.dropout_ratio, dtype=x.dtype)
                x = torch.where(mask != 0, x / keep_prob, torch.zeros((), dtype=x.dtype))
        return x


class ConvBlock(nn.Module):
    """Per-(loc, mod) encoder: input conv (strided for audio) -> N residual
    SAME convs -> per-interval flatten -> ``out_proj``.
    Input [b, i, s, cin] (NHWC) -> [b, i_out, out_channels] (i_out 1 when
    conv_lens[1][0] > 1 folds the intervals).

    With ``use_pallas``, a training forward whose geometry ``tower_takes``
    (as the JAX package's ConvBlock decides, where the kernels take its
    widths) runs the layers as the fused
    conv tower; a strided input conv stays a cuDNN conv and feeds the tower
    its output. Parameters and buffers are the same on both paths.
    ``compute_dtype`` bf16: the layers, the residual adds and ``out_proj``
    in bf16, the fused tower through #13-bf16/#14-bf16 (the gate in bf16:
    a geometry it refuses runs the cuDNN bf16 convs)."""

    def __init__(self, cin, in_size, out_channels, conv_lens, num_inter_layers,
                 in_stride=(1, 1), dropout_ratio=0.0, use_pallas=False,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.half = out_channels // 2
        self.conv_lens = [tuple(c) for c in conv_lens]
        self.stride = tuple(in_stride) if not isinstance(in_stride, int) else (1, in_stride)
        self.num_layers = 1 + num_inter_layers
        self.dropout_ratio = float(dropout_ratio)
        self.use_pallas = use_pallas
        self.add_module("ConvLayer2D_0", ConvLayer2D(cin, self.half, self.conv_lens[0], self.stride,
                                                     dropout_ratio, compute_dtype))
        for k in range(1, self.num_layers):
            self.add_module(f"ConvLayer2D_{k}", ConvLayer2D(self.half, self.half, self.conv_lens[1],
                                                            (1, 1), dropout_ratio, compute_dtype))
        i, s = in_size
        if self.strided:
            i = (i - self.conv_lens[0][0]) // self.stride[0] + 1
            s = (s - self.conv_lens[0][1]) // self.stride[1] + 1
        self.out_size = (i, s)
        flat = i * s * self.half if self.conv_lens[1][0] > 1 else s * self.half
        self.out_proj = Dense(flat, out_channels, compute_dtype=compute_dtype,
                              tp_role="column_gather")
        self.plan = None

    @property
    def strided(self):
        return max(self.stride) > 1

    def layers(self):
        return [getattr(self, f"ConvLayer2D_{k}") for k in range(self.num_layers)]

    def fused_geometry(self, x):
        """Whether the fused tower takes input x [b, i, s, c]: the JAX
        package's ConvBlock._fused_geometry, where the kernels take the
        widths (``tower_takes``)."""
        if self.conv_lens[0][0] != 1 or self.conv_lens[1][0] != 1:
            return False  # tall kernels fold the intervals
        b, i, _, cin = x.shape
        kw_max = self.conv_lens[1][1] if self.strided else max(self.conv_lens[0][1],
                                                                self.conv_lens[1][1])
        cin = self.half if self.strided else cin
        return tower_takes(b * i, self.out_size[1], self.half, cin, self.compute_dtype,
                           kw_max=kw_max)

    def _whole(self, x, dim=None):
        """x as a conv cut by output channels reads it: the model ranks'
        channels (axis ``dim``) gathered, where given, and the gradient
        summed over the model ranks, each of whose convs reads all of it.
        x itself where the tower is whole."""
        if not self.ConvLayer2D_0.tp_sharded:
            return x
        x = x if dim is None else gather_from(x, self.plan.model, dim)
        return copy_to(x, self.plan.model)

    def forward(self, x, rng=None):
        if self.use_pallas and self.training and self.fused_geometry(x):
            x = self._fused_tower(x, rng)
        else:
            layers = self.layers()
            x = layers[0](self._whole(x.permute(0, 3, 1, 2)), rng)  # NCHW
            for layer in layers[1:]:
                x = x + layer(self._whole(x, dim=1), rng)
            x = x.permute(0, 2, 3, 1)  # back to NHWC before the flatten
            if self.ConvLayer2D_0.tp_sharded:  # out_proj reads every channel
                x = gather_from(x.contiguous(), self.plan.model, dim=-1)
        b, i, s, c = x.shape
        x = x.reshape(b, 1, i * s * c) if self.conv_lens[1][0] > 1 else x.reshape(b, i, s * c)
        return self.out_proj(x)

    def _fused_tower(self, x, rng):
        b, i, s, cin = x.shape
        layers = self.layers()
        s_out = self.out_size[1]
        kws = [self.conv_lens[0][1]] + [self.conv_lens[1][1]] * (self.num_layers - 1)
        cins = [cin] + [self.half] * (self.num_layers - 1)
        if self.strided:
            c0 = layers[0].conv(x.permute(0, 3, 1, 2))  # [b, half, i, s_out]
            x0 = c0.permute(0, 2, 3, 1).reshape(b * i, s_out, self.half)
        else:
            x0 = x.reshape(b * i, s, cin).contiguous()
        cfgs, ws, bs, scales, biases, masks = [], [], [], [], [], []
        for k, layer in enumerate(layers):
            cfgs.append((kws[k], cins[k], self.half, k > 0))
            if k == 0 and self.strided:
                ws.append(x0.new_zeros((1, 1)))  # external first conv: a placeholder
            else:  # [cout, cin, 1, kw] -> flax HWIO [1, kw, cin, cout] -> [kw*cin, cout]
                ws.append(layer.Conv_0.weight.permute(2, 3, 1, 0).reshape(kws[k] * cins[k], self.half))
            bs.append(layer.Conv_0.bias)
            scales.append(layer.BatchNorm_0.weight)
            biases.append(layer.BatchNorm_0.bias)
            if self.dropout_ratio > 0.0:
                masks.append(keep_mask((b, self.half), self.dropout_ratio,
                                       needs_rng(rng, "Dropout2d").device))
            else:
                masks.append(torch.ones((b, self.half), device=x0.device))  # f32, as keep_mask's
        a, mus, vars_ = fused_conv_tower(x0, cfgs, ws, bs, scales, biases, masks,
                                         external_c0=self.strided, plan=self.plan)
        for layer, mu, var in zip(layers, mus, vars_):
            layer.BatchNorm_0.update(mu, var)
        return a.reshape(b, i, s_out, self.half)


class BiGRULayer(nn.Module):
    """One bidirectional GRU layer, each direction its own parameters,
    stacked on a leading axis as in flax: wi [2, C, 3H], bi [2, 3H], wh
    [2, H, 3H], bh [2, 3H], gates in the order r, z, n:
      r = s(x Wir + bir + h Whr + bhr), z = s(... z ...),
      n = tanh(x Win + bin + r * (h Whn + bhn)), h' = (1 - z) n + z h.
    The reverse direction reads the time-reversed input and its outputs are
    reversed back. Input [b, t, C] -> [b, t, 2H] (forward ++ reverse)."""

    def __init__(self, cin, hidden):
        super().__init__()
        self.hidden = hidden
        self.wi = nn.Parameter(torch.zeros(2, cin, 3 * hidden))
        self.bi = nn.Parameter(torch.zeros(2, 3 * hidden))
        self.wh = nn.Parameter(torch.zeros(2, hidden, 3 * hidden))
        self.bh = nn.Parameter(torch.zeros(2, 3 * hidden))

    def forward(self, x):
        B, T, _ = x.shape
        H = self.hidden
        both = torch.stack([x, x.flip(1)])  # [2, b, t, C]
        xproj = torch.einsum("dbtc,dcg->tdbg", both, self.wi) + self.bi[:, None]  # [t, 2, b, 3H]
        h = x.new_zeros((2, B, H))
        ys = []
        for t in range(T):
            hp = torch.baddbmm(self.bh[:, None], h, self.wh)  # [2, b, 3H]
            xp = xproj[t]
            r = torch.sigmoid(xp[..., :H] + hp[..., :H])
            z = torch.sigmoid(xp[..., H:2 * H] + hp[..., H:2 * H])
            n = torch.tanh(xp[..., 2 * H:] + r * hp[..., 2 * H:])
            h = (1.0 - z) * n + z * h
            ys.append(h)
        ys = torch.stack(ys)  # [t, 2, b, H]
        return torch.cat([ys[:, 0].transpose(0, 1), ys.flip(0)[:, 1].transpose(0, 1)], dim=-1)


class BiGRU(nn.Module):
    """num_layers bidirectional GRU layers (``gru{k}``), dropout between
    them (a [b, t, 2H] mask on the layer's output, as the JAX package
    applies it inside its scan), mean over time. [b, t, C] -> [b, 2H]."""

    def __init__(self, cin, hidden, num_layers=2, dropout_ratio=0.0):
        super().__init__()
        self.num_layers = num_layers
        self.dropout_ratio = float(dropout_ratio)
        for k in range(num_layers):
            self.add_module(f"gru{k}", BiGRULayer(cin if k == 0 else 2 * hidden, hidden))

    def forward(self, x, rng=None):
        x = x.to(torch.float32)
        for k in range(self.num_layers):
            x = getattr(self, f"gru{k}")(x)
            if self.training and self.dropout_ratio > 0.0 and k < self.num_layers - 1:
                x = x * keep_mask(x.shape, self.dropout_ratio, needs_rng(rng, "GRU dropout").device)
        return x.mean(dim=1)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (no mask): per-head q/k/v
    projections, query scaled by hd**-0.5, softmax over keys, output
    projection. Each flax DenseGeneral kernel ([c, H, hd] for q/k/v,
    [H, hd, c] for out) is held as an ``nn.Linear`` over the flattened heads.

    In ``train()`` mode with ``dropout_rate`` > 0 the softmaxed weights are
    dropped as flax's ``broadcast_dropout`` does: one keep mask of shape
    [1, 1, Lq, Lk] a call, shared by every sample and head, scaling the
    kept weights by 1 / (1 - rate); it is drawn from ``rng.device``.

    In bf16 (``compute_dtype``) every step rounds as flax's does at
    ``dtype=bfloat16``: q divided by sqrt(hd) rounded to bf16, the scores,
    the softmax's exp, sum and quotient, the dropout and the weighted sum
    each in bf16.

    Under tensor parallelism query, key and value are column- and out
    row-parallel: a rank attends over its whole heads."""

    def __init__(self, dim, num_heads, dropout_rate=0.0, compute_dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = float(dropout_rate)
        self.compute_dtype = compute_dtype
        self.query = Dense(dim, dim, compute_dtype=compute_dtype, tp_role="column")
        self.key = Dense(dim, dim, compute_dtype=compute_dtype, tp_role="column")
        self.value = Dense(dim, dim, compute_dtype=compute_dtype, tp_role="column")
        self.out = Dense(dim, dim, compute_dtype=compute_dtype, tp_role="row")

    def forward(self, q_in, kv_in, rng=None):
        b, lq, c = q_in.shape
        lk = kv_in.shape[1]
        hd = c // self.num_heads
        dt = self.compute_dtype
        q = self.query(q_in).reshape(b, lq, -1, hd).transpose(1, 2)  # this rank's heads
        k = self.key(kv_in).reshape(b, lk, -1, hd).transpose(1, 2)
        v = self.value(kv_in).reshape(b, lk, -1, hd).transpose(1, 2)
        if dt == torch.float32:
            attn = torch.softmax(torch.matmul(q / hd**0.5, k.transpose(-1, -2)), dim=-1)
        else:
            scores = torch.matmul(q / torch.tensor(hd**0.5, dtype=dt), k.transpose(-1, -2))
            e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
            attn = e / e.sum(dim=-1, keepdim=True)
        if self.training and self.dropout_rate > 0.0:
            gen = needs_rng(rng, "attention dropout").device
            attn = attn * keep_mask((1, 1, lq, lk), self.dropout_rate, gen).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, lq, -1)
        return self.out(out)


class AttentionFusion(nn.Module):
    """LayerNorm + mean-query multi-head attention pooling, with the
    attention's broadcast dropout at ``dropout_ratio`` in training.

    Input [b, i, n, c] -> Output [b, i, c]: the mean over the n fused items
    queries them."""

    def __init__(self, dim, num_heads, dropout_ratio=0.0, compute_dtype=torch.float32):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, eps=1e-5, compute_dtype=compute_dtype)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, num_heads, dropout_ratio, compute_dtype=compute_dtype)

    def forward(self, x, rng=None):
        b, i, n, c = x.shape
        x = self.LayerNorm_0(x.reshape(b * i, n, c))
        query = x.mean(dim=1, keepdim=True)
        return self.MultiHeadDotProductAttention_0(query, x, rng).reshape(b, i, c)


class MeanFusion(nn.Module):
    """Mean over the location axis: [b, i, n_loc, c] -> [b, i, c]; a bf16 x
    summed in f32 and the mean rounded to bf16 once (``jnp.mean``)."""

    def forward(self, x):
        return x.to(torch.float32).mean(dim=2).to(x.dtype)


class TransformerEncoderLayer(nn.Module):
    """Post-norm self-attention + ReLU FFN layer (the JAX package's
    multi-location context layer): x = LN0(x + drop(MHA(x))), then
    LN1(x + drop(Dense_1(drop(relu(Dense_0(x)))))), LayerNorm eps 1e-5.
    In training the attention drops its weights with flax's broadcast mask
    and the three ``drop`` are elementwise masks, all at ``dropout`` and
    drawn from ``rng.device``. [b, n, dim] -> [b, n, dim]. ``compute_dtype``
    as the layers it is made of."""

    def __init__(self, dim, num_heads, ffn_dim, dropout=0.0, compute_dtype=torch.float32):
        super().__init__()
        self.dropout = float(dropout)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, num_heads, dropout, compute_dtype=compute_dtype)
        self.LayerNorm_0 = LayerNorm(dim, eps=1e-5, compute_dtype=compute_dtype)
        self.Dense_0 = Dense(dim, ffn_dim, compute_dtype=compute_dtype)
        self.Dense_1 = Dense(ffn_dim, dim, compute_dtype=compute_dtype)
        self.LayerNorm_1 = LayerNorm(dim, eps=1e-5, compute_dtype=compute_dtype)

    def _drop(self, x, rng):
        if self.training and self.dropout > 0.0:
            return x * keep_mask(x.shape, self.dropout, needs_rng(rng, "Dropout").device).to(x.dtype)
        return x

    def forward(self, x, rng=None):
        attn = self.MultiHeadDotProductAttention_0(x, x, rng)
        x = self.LayerNorm_0(x + self._drop(attn, rng))
        y = self.Dense_1(self._drop(F.relu(self.Dense_0(x)), rng))
        return self.LayerNorm_1(x + self._drop(y, rng))


class ProjectionHead(nn.Module):
    """Linear -> ReLU -> Linear, in ``compute_dtype``; under tensor
    parallelism column- then row-parallel."""

    def __init__(self, in_dim, out_dim, compute_dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_dim, out_dim, compute_dtype=compute_dtype, tp_role="column")
        self.Dense_1 = Dense(out_dim, out_dim, compute_dtype=compute_dtype, tp_role="row")

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))


class ClassHead(nn.Module):
    """Linear classifier, or Linear -> exact GELU -> Linear (SSL head), in
    ``compute_dtype``."""

    def __init__(self, in_dim, num_classes, fc_dim, linear=True, compute_dtype=torch.float32):
        super().__init__()
        self.linear = linear
        if linear:
            self.Dense_0 = Dense(in_dim, num_classes, compute_dtype=compute_dtype)
        else:
            self.Dense_0 = Dense(in_dim, fc_dim, compute_dtype=compute_dtype)
            self.Dense_1 = Dense(fc_dim, num_classes, compute_dtype=compute_dtype)

    def forward(self, x):
        if self.linear:
            return self.Dense_0(x)
        return self.Dense_1(gelu(self.Dense_0(x)))
