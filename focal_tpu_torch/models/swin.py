"""Shifted-window transformer blocks.

Port of the JAX package's ``models/swin.py``. Geometry (padded sizes,
window shrink, shift sizes, SW-MSA masks, relative position indices) is
resolved to constants when a block is built. Window attention goes through
the whole-block kernels with the q scale folded into the qkv weights, as the
JAX path does: ``window_block_forward`` (#1, or #4 for blocks too wide for
it) in eval, ``window_block`` (#2 or #1 forward and #3 backward, or #4 and
#5) in training. With ``pallas_block`` off (the CLI's ``-no_pallas_block``)
it takes the JAX package's attention-only route instead: the qkv and proj
Linears around ``fused_window_attention`` (#6) in eval and
``window_attention_qkv`` (#7 or #6 forward, #9 or #8 backward) in training.
With ``pallas_mlp`` each block's MLP goes through the fused MLP kernels
(#10-#12) where ``mlp_takes``. A width that no kernel takes (C not a
multiple of 4, N above 16: ``wblock_takes``, ``attention_takes``) runs the
JAX package's XLA attention in plain PyTorch between the Linears, where
the JAX package would run its kernel.

In training every module takes ``rng``, the step's ``ops.dropout.StepRngs``:
one kernel seed per block from its host generator, DropPath and the other
dropouts from its device generator (under tensor parallelism, those of a
split tensor from its split generator).

``compute_dtype`` (the CLI's ``-compute_dtype``) is the activations' type,
as flax's ``dtype=``: in bf16 each Linear and LayerNorm casts its f32
parameters at use (``models.layers.Dense``, ``models.layers.LayerNorm``),
the residual stream, the MLP and the dropouts run in bf16, and window
attention takes the bf16 whole-block kernels (#1-bf16 in eval, #2-bf16 or
#1-bf16 forward and #3-bf16 backward in training; #4-bf16 and #5-bf16 for
the blocks ``wblock_fits`` sends to the per-head kernels) with the q scale
folded into the f32 qkv weights before they are rounded; with
``pallas_mlp`` the MLP takes #10-bf16 to #12-bf16 over its f32 weights.
With ``pallas_block`` off it takes the bf16 qkv and proj Linears around
the bf16 attention-only kernels (#6-bf16 in eval, #7-bf16 or #6-bf16
forward and #9-bf16 or #8-bf16 backward in training); a width that no bf16
kernel takes runs the XLA route in bf16, rounding where the JAX package's
does op by op.

Across processes (``plan``, set by ``models.registry.apply_plan``): a data
rank runs the same kernels on its rows, with its shard's kernel seeds (the
JAX package's data-parallel wrappers: ``StepRngs.seed``); a rank's windows
are whole samples', so each holds a multiple of nW windows, as the JAX
package's gate asks. Under tensor parallelism a block whose qkv, proj and
bias table ``parallel.tp`` cut by whole heads runs
``sharded_window_block_tp`` (#4-TP forward, #5-TP backward) where
``wblock_tp_takes``, else the plain attention route on the rank's heads (as
the JAX package falls back to XLA there, ``-no_pallas_block`` too), in bf16
through #4-TP-bf16/#5-TP-bf16; its MLP is column- then row-parallel
(``models.layers.Dense``), ``-pallas_mlp`` or not, as the JAX package takes
its flag-off route there (``models.registry.apply_plan``). The masks of what a
rank holds alone of a tensor (its heads' attention weights, its columns of
the MLP's hidden layer) come from ``StepRngs.split``, so the model ranks
draw one mask over the whole tensor.

Parameter names follow the flax tree (``norm1``, ``attn.qkv``, ``mlp.Dense_0``,
``downsample.reduction`` ...) so a reader can map one to the other; weights
use torch's ``nn.Linear`` layout ``[out, in]``.
"""

import numpy as np
import torch
import torch.nn as nn

from focal_tpu_torch.models.layers import Dense, LayerNorm, gelu
from focal_tpu_torch.ops.dropout import needs_rng, remat_dropout
from focal_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_dropout, mlp_takes
from focal_tpu_torch.ops.pallas_kernels import (attention_takes, fused_window_attention,
                                                fused_window_attention_bf16, scale_bf16,
                                                sharded_window_block_tp, wblock_takes,
                                                wblock_tp_takes, window_attention_qkv,
                                                window_block, window_block_forward)


def window_partition(x, wh, ww):
    """[B, H, W, C] -> [B*nW, wh*ww, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def window_reverse(windows, wh, ww, H, W):
    """[B*nW, wh*ww, C] -> [B, H, W, C]."""
    C = windows.shape[-1]
    B = windows.shape[0] // (H * W // wh // ww)
    x = windows.reshape(B, H // wh, W // ww, wh, ww, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def relative_position_index(wh, ww):
    """Static [wh*ww, wh*ww] index into the bias table (numpy)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))  # [2, wh, ww]
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, N, N]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)  # [N, N]


def shifted_window_mask(H, W, wh, ww, sh, sw):
    """Static additive mask [nW, N, N] for SW-MSA (numpy)."""
    img_mask = np.zeros((H, W), np.float32)
    h_slices = (slice(0, -wh), slice(-wh, -sh), slice(-sh, None))
    w_slices = (slice(0, -ww), slice(-ww, -sw), slice(-sw, None))
    cnt = 0
    for h in h_slices:
        for w in w_slices:
            img_mask[h, w] = cnt
            cnt += 1
    mask_windows = (
        img_mask.reshape(H // wh, wh, W // ww, ww).transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    )
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def block_geometry(input_resolution, window_size, shift_size):
    """Window-shrink rule: an axis no larger than the window collapses the
    window to it and its shift to 0; the mask exists only when both shifts
    are positive. Returns (wh, ww, sh, sw, shifted)."""
    H, W = input_resolution
    wh, ww = window_size
    sh, sw = shift_size
    if H <= wh:
        sh, wh = 0, H
    if W <= ww:
        sw, ww = 0, W
    return wh, ww, sh, sw, min(sh, sw) > 0


class WindowAttention(nn.Module):
    """W-MSA with relative position bias, through the whole-block kernels, or
    with ``pallas_block`` off through the attention-only kernels between the
    qkv and proj Linears; attention dropout in the kernel, ``proj_drop`` on
    its output. Each route has its bf16 form, the Linears ``Dense`` layers
    that compute in ``compute_dtype``; a width that no kernel takes in that
    type runs the plain XLA route."""

    def __init__(self, dim, window_size, num_heads, qkv_bias=True, attn_drop=0.0, proj_drop=0.0,
                 pallas_block=True, compute_dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.pallas_block = bool(pallas_block)
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        self.attn_drop = float(attn_drop)
        self.proj_drop = float(proj_drop)
        self.compute_dtype = compute_dtype
        wh, ww = self.window_size
        # columns part|head|dim; under tensor parallelism a rank's whole heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, compute_dtype=compute_dtype,
                         tp_role="column")
        self.proj = Dense(dim, dim, compute_dtype=compute_dtype, tp_role="row")
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads)
        )
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(wh, ww).reshape(-1)).long(),
            persistent=False,
        )
        self._kernel_key = None  # (data_ptr, _version) of each parameter when folded
        self.plan = None
        self.tp_sharded = False  # parallel.tp cut the heads: this rank's alone

    def _rel_bias(self):
        """[H, N, N]: the bias table gathered by the relative position index
        (this rank's heads under tensor parallelism)."""
        N = self.window_size[0] * self.window_size[1]
        bias = self.relative_position_bias_table[self.relative_position_index]
        return bias.reshape(N, N, -1).permute(2, 0, 1).contiguous()

    def _fold(self):
        """(wqkv_t [3D, C] with the q scale folded in, bqkv, wproj_t [C, D],
        bproj, rel_bias [H, N, N]): the weights in nn.Linear's [out, in]
        layout, the transpose of what the kernels take; D = C, or under
        tensor parallelism the width of the rank's heads."""
        scale = (self.dim // self.num_heads) ** -0.5
        D = self.qkv.weight.shape[0] // 3
        dev = self.qkv.weight.device
        scale_vec = torch.cat([torch.full((D,), scale, device=dev), torch.ones(2 * D, device=dev)])
        wqkv_t = self.qkv.weight * scale_vec[:, None]
        bqkv = self.qkv.bias if self.qkv.bias is not None else torch.zeros(3 * D, device=dev)
        bqkv = (bqkv * scale_vec).contiguous()
        return wqkv_t, bqkv, self.proj.weight, self.proj.bias, self._rel_bias()

    def kernel_args(self):
        """(wqkv [C, 3C] with the q scale folded in, bqkv, wproj [C, C],
        bproj, rel_bias [H, N, N]) as the kernel takes them; in bf16 wqkv
        (folded in f32 first) and wproj rounded to bf16, the rest f32."""
        wqkv_t, bqkv, wproj_t, bproj, rel_bias = self._fold()
        dt = self.compute_dtype
        return (wqkv_t.t().contiguous().to(dt), bqkv, wproj_t.t().contiguous().to(dt), bproj,
                rel_bias)

    def folded_kernel_args(self):
        """kernel_args(), folded (and in bf16 rounded) once and reused until a
        parameter is replaced (load_state_dict, .to()) or written in place:
        a served model pays for the folding on its first batch only. Eval
        only: the fold carries no gradient."""
        key = [(p.data_ptr(), p._version) for p in self.parameters()]
        if key != self._kernel_key:
            with torch.no_grad():
                self._kernel_args = self.kernel_args()
            # holding the folded-from storages keeps their addresses out of reuse
            self._kernel_key, self._kernel_src = key, [p.detach() for p in self.parameters()]
        return self._kernel_args

    def _attention_only(self, x, mask, rng):
        """The JAX package's route without the whole-block kernel
        (``focal_tpu/models/swin.py:258-295``): qkv Linear, the attention
        kernels on [B_, H, N, hd] views of its output with q * scale in the
        kernel, proj Linear. The kernels write their output as the head view
        of the proj Linear's [B_, N, C] input, so nothing scales q or lays
        the output out in between. In training the kernels' backward hands
        the qkv Linear its gradient as one [B_, N, 3C] tensor
        (``window_attention_qkv``). In bf16 the Linears compute in bf16 and
        the bf16 kernels (#6-bf16 to #9-bf16) round q * scale as the JAX
        package's bf16 multiply does."""
        B_, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x)
        if self.training:
            seed = needs_rng(rng, "attention dropout").seed() if self.attn_drop > 0.0 else 0
            out = window_attention_qkv(qkv, H, self._rel_bias(), mask, seed, self.attn_drop)
        else:
            q, k, v = qkv.reshape(B_, N, 3, H, hd).permute(2, 0, 3, 1, 4).unbind(0)
            y = torch.empty((B_, N, C), dtype=qkv.dtype, device=qkv.device)
            attend = (fused_window_attention_bf16 if qkv.dtype == torch.bfloat16
                      else fused_window_attention)
            out = attend(q, k, v, self._rel_bias(), mask, q_scale=hd**-0.5,
                         out=y.view(B_, N, H, hd).transpose(1, 2))
        return self.proj(out.transpose(1, 2).reshape(B_, N, C))

    def _plain_attention(self, x, mask, rng):
        """The JAX package's XLA route (``focal_tpu/models/swin.py:296-317``)
        for the widths no kernel takes (``wblock_takes``,
        ``attention_takes``): qkv Linear, softmax(q k^T + bias + mask) with
        the quantised dropout of ``remat_dropout``, proj Linear. In bf16 it
        rounds where JAX's route does when run op by op: q * scale as
        ``scale_bf16``; at N <= 16 (its ``small_window``) the scores and
        the weighted sum as bf16 products summed in f32 and rounded once,
        else bf16 matmuls; the bias, mask and softmax in f32, the weights
        rounded to bf16 before the dropout. Under tensor parallelism
        (``tp_sharded``) the rank's H heads, the qkv and proj Linears column-
        and row-parallel, the dropout's mask from the split generator."""
        B_, N, _ = x.shape
        hd = self.dim // self.num_heads
        H = self.relative_position_bias_table.shape[-1]
        q, k, v = self.qkv(x).reshape(B_, N, 3, H, hd).permute(2, 0, 3, 1, 4).unbind(0)
        low = q.dtype != torch.float32
        if low:
            q = scale_bf16(q, hd**-0.5)
            if N <= 16:
                attn = (q[:, :, :, None, :] * k[:, :, None, :, :]).sum(-1)
            else:
                attn = torch.matmul(q, k.transpose(-1, -2))
            attn = attn.float() + self._rel_bias()[None]
        else:
            attn = torch.matmul(q * hd**-0.5, k.transpose(-1, -2)) + self._rel_bias()[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, H, N, N) + mask[None, :, None]).reshape(B_, H, N, N)
        attn = torch.softmax(attn, dim=-1).to(q.dtype)
        if self.training and self.attn_drop > 0.0:
            rng = needs_rng(rng, "attention dropout")
            attn = remat_dropout(attn, self.attn_drop, rng.split if self.tp_sharded else rng.device)
        if low and N <= 16:
            out = (attn[..., None] * v[:, :, None, :, :]).sum(-2)
        else:
            out = torch.matmul(attn, v)
        return self.proj(out.transpose(1, 2).reshape(B_, N, H * hd))

    def forward(self, x, mask=None, rng=None):
        N, C, H, dt = x.shape[1], self.dim, self.num_heads, self.compute_dtype
        if self.tp_sharded:
            out = self._tensor_parallel(x, mask, rng)
        elif not (self.pallas_block and wblock_takes(N, C, H, dt)):
            if attention_takes(N, C // H, dt):
                out = self._attention_only(x, mask, rng)
            else:
                out = self._plain_attention(x, mask, rng)
        elif not self.training:
            return window_block_forward(x.contiguous(), *self.folded_kernel_args(), mask)
        else:
            # training folds with grad, so the weights' gradients flow back
            # through the q scale, the transposes and the bias-table gather
            # (in bf16 window_block rounds the folded weights itself)
            seed = needs_rng(rng, "attention dropout").seed() if self.attn_drop > 0.0 else 0
            wqkv_t, bqkv, wproj_t, bproj, rel_bias = self._fold()
            out = window_block(x.contiguous(), wqkv_t.t().contiguous(), bqkv,
                               wproj_t.t().contiguous(), bproj, rel_bias, mask, seed,
                               self.attn_drop, wqkv_t=wqkv_t, wproj_t=wproj_t)
        if self.training and self.proj_drop > 0.0:
            out = remat_dropout(out, self.proj_drop, needs_rng(rng, "proj_drop").device)
        return out

    def _tensor_parallel(self, x, mask, rng):
        """The rank's heads: #4-TP/#5-TP (``sharded_window_block_tp``, in eval
        too; in bf16 #4-TP-bf16/#5-TP-bf16) where ``wblock_tp_takes``, else
        the plain route."""
        N, C, H = x.shape[1], self.dim, self.num_heads
        if not (self.pallas_block and wblock_tp_takes(N, C, H, self.plan.mp, x.dtype)):
            return self._plain_attention(x, mask, rng)
        rate = self.attn_drop if self.training else 0.0
        seed = needs_rng(rng, "attention dropout").seed(split=True) if rate > 0.0 else 0
        wqkv_t, bqkv, wproj_t, bproj, rel_bias = self._fold()
        return sharded_window_block_tp(self.plan, x.contiguous(), wqkv_t.t().contiguous(), bqkv,
                                       wproj_t.t().contiguous(), bproj, rel_bias, mask, seed,
                                       rate, wqkv_t=wqkv_t, wproj_t=wproj_t)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath): in training each sample
    is kept with probability 1 - rate and scaled by 1 / keep; identity in
    eval."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, rng=None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        gen = needs_rng(rng, "DropPath").device
        kept = torch.rand(x.shape[0], generator=gen, device=x.device) < keep
        return torch.where(kept.view((-1,) + (1,) * (x.dim() - 1)), x / keep, 0.0)


class Mlp(nn.Module):
    """fc -> exact-erf GELU -> drop -> fc -> drop.

    With ``use_pallas`` (the CLI's ``-pallas_mlp``) and ``mlp_takes`` at this
    width in ``compute_dtype`` (the JAX package's ``mlp_fits``, where the
    kernels take the width), the whole MLP runs on the [rows, C]
    tokens as the fused kernels: ``fused_mlp`` (#10, backward #12) in eval
    and at rate 0, ``fused_mlp_dropout`` (#11, backward #12) in training at
    rate > 0, one kernel seed per call from the step's host generator; in
    bf16 their bf16 forms (#10-bf16 to #12-bf16) over the f32 weights.
    Otherwise two nn.Linear layers with the dropouts of
    ``ops.dropout.remat_dropout``, in ``compute_dtype``. Under tensor
    parallelism the Linears are column- then row-parallel, the hidden
    layer's mask from the split generator; ``models.registry.apply_plan``
    turns ``fused`` off there, as the JAX package builds its MLP without
    the kernels under a model axis."""

    def __init__(self, dim, hidden, out, drop=0.0, use_pallas=False, compute_dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden, compute_dtype=compute_dtype, tp_role="column")
        self.Dense_1 = Dense(hidden, out, compute_dtype=compute_dtype, tp_role="row")
        self.drop = float(drop)
        self.fused = bool(use_pallas) and out == dim and mlp_takes(dim, hidden, compute_dtype)

    def _drop(self, x, rng, split=False):
        if not self.training or self.drop == 0.0:
            return x
        rng = needs_rng(rng, "Mlp dropout")
        return remat_dropout(x, self.drop, rng.split if split else rng.device)

    def forward(self, x, rng=None):
        if self.fused:
            lead, C = x.shape[:-1], x.shape[-1]
            x2 = x.reshape(-1, C).contiguous()
            w1_t, w2_t = self.Dense_0.weight, self.Dense_1.weight  # [H, C], [C, H]
            w = (w1_t.t().contiguous(), self.Dense_0.bias, w2_t.t().contiguous(), self.Dense_1.bias)
            if self.training and self.drop > 0.0:
                seed = needs_rng(rng, "Mlp dropout").seed()
                y = fused_mlp_dropout(x2, *w, seed, self.drop, w1_t=w1_t, w2_t=w2_t)
            else:
                y = fused_mlp(x2, *w, w1_t=w1_t, w2_t=w2_t)
            return y.reshape(*lead, C)
        x = self._drop(gelu(self.Dense_0(x)), rng, split=self.Dense_0.tp_sharded)
        return self._drop(self.Dense_1(x), rng)


class SwinBlock(nn.Module):
    """One (S)W-MSA + MLP block."""

    def __init__(self, dim, input_resolution, num_heads, window_size, shift_size,
                 mlp_ratio=4.0, qkv_bias=True, drop=0.0, attn_drop=0.0, drop_path=0.0,
                 pallas_mlp=False, pallas_block=True, compute_dtype=torch.float32):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        H, W = self.input_resolution
        self.wh, self.ww, self.sh, self.sw, self.shifted = block_geometry(
            self.input_resolution, window_size, shift_size
        )
        mask = (
            torch.from_numpy(shifted_window_mask(H, W, self.wh, self.ww, self.sh, self.sw))
            if self.shifted else None
        )
        self.register_buffer("attn_mask", mask, persistent=False)
        self.norm1 = LayerNorm(dim, eps=1e-5, compute_dtype=compute_dtype)
        self.attn = WindowAttention(dim, (self.wh, self.ww), num_heads, qkv_bias,
                                    attn_drop=attn_drop, proj_drop=drop, pallas_block=pallas_block,
                                    compute_dtype=compute_dtype)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5, compute_dtype=compute_dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop, use_pallas=pallas_mlp,
                       compute_dtype=compute_dtype)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x, rng=None):
        H, W = self.input_resolution
        B, L, C = x.shape
        shortcut = x
        x = self.norm1(x).reshape(B, H, W, C)
        if self.shifted:
            x = torch.roll(x, shifts=(-self.sh, -self.sw), dims=(1, 2))
        windows = window_partition(x, self.wh, self.ww)
        x = window_reverse(self.attn(windows, self.attn_mask, rng), self.wh, self.ww, H, W)
        if self.shifted:
            x = torch.roll(x, shifts=(self.sh, self.sw), dims=(1, 2))
        x = shortcut + self.drop_path1(x.reshape(B, L, C), rng)
        return x + self.drop_path2(self.mlp(self.norm2(x), rng), rng)


class PatchMerging(nn.Module):
    """2x2 patch concat + LayerNorm + linear reduce."""

    def __init__(self, input_resolution, dim, compute_dtype=torch.float32):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.LayerNorm_0 = LayerNorm(4 * dim, eps=1e-5, compute_dtype=compute_dtype)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, compute_dtype=compute_dtype)

    def forward(self, x):
        H, W = self.input_resolution
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        )
        x = x.reshape(B, (H // 2) * (W // 2), 4 * C)
        return self.reduction(self.LayerNorm_0(x))


class BasicLayer(nn.Module):
    """Stage: depth blocks with alternating shift + optional merging.
    Blocks are registered as ``block{i}``, as the flax tree names them."""

    def __init__(self, dim, input_resolution, depth, num_heads, window_size, mlp_ratio=4.0,
                 qkv_bias=True, drop=0.0, attn_drop=0.0, drop_path=(0.0,), downsample=False,
                 pallas_mlp=False, pallas_block=True, compute_dtype=torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            shift = [0, 0] if i % 2 == 0 else [window_size[0] // 2, window_size[1] // 2]
            dp = drop_path[i] if i < len(drop_path) else drop_path[-1]
            self.add_module(f"block{i}", SwinBlock(
                dim, input_resolution, num_heads, window_size, shift,
                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, drop=drop, attn_drop=attn_drop,
                drop_path=dp, pallas_mlp=pallas_mlp, pallas_block=pallas_block,
                compute_dtype=compute_dtype,
            ))
        self.downsample = (PatchMerging(input_resolution, dim, compute_dtype=compute_dtype)
                           if downsample else None)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    def forward(self, x, rng=None):
        for blk in self.blocks():
            x = blk(x, rng)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


class PatchEmbed(nn.Module):
    """Patchify + optional LayerNorm. The flax package uses a conv with
    kernel = stride; here it is a patch reshape plus a matmul, which is the
    same sum and stays in full f32 on the card (cuDNN convolutions default
    to TF32), or in bf16 rounds as flax's bf16 conv does (``compute_dtype``).
    ``proj.weight`` is the conv kernel [kh, kw, in, out] flattened to
    [(kh*kw*in), out] and transposed."""

    def __init__(self, patch_size, in_chans, embed_dim, norm=True, compute_dtype=torch.float32):
        super().__init__()
        self.patch_size = tuple(patch_size)
        ph, pw = self.patch_size
        self.proj = Dense(ph * pw * in_chans, embed_dim, compute_dtype=compute_dtype)
        self.LayerNorm_0 = (LayerNorm(embed_dim, eps=1e-5, compute_dtype=compute_dtype) if norm
                            else None)

    def forward(self, x):
        # x: [B, H, W, C] NHWC
        B, H, W, C = x.shape
        ph, pw = self.patch_size
        Hp, Wp = H // ph, W // pw
        x = x.reshape(B, Hp, ph, Wp, pw, C).permute(0, 1, 3, 2, 4, 5)
        x = self.proj(x.reshape(B, Hp * Wp, ph * pw * C))
        if self.LayerNorm_0 is not None:
            x = self.LayerNorm_0(x)
        return x
