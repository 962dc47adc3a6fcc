"""DeepSense backbone (port of the JAX package's ``models/deepsense.py``):
per-(loc, mod) conv encoder -> (several locations: the mean over
locations, ``loc_fusion_{mod}``, then a conv block over the fused
features, ``mod_extractor_{mod}``) -> per-mod bidirectional GRU over the
intervals -> heads.

Inputs are the frequency-domain {loc: {mod: [b, 2c, i, s]}}, read as NHWC
[b, i, s, 2c] by the conv blocks. ``use_pallas`` (the CLI's
``-pallas_conv``) runs the conv blocks' training forward as the fused conv
tower (kernels #13/#14); eval never does, so serving and validation launch
no kernel. In ``train()`` mode the forward takes the step's ``rng``
(``ops.dropout.StepRngs``) and updates the BatchNorm running statistics.

Heads (``head=``): ``class`` -> logits [b, num_classes]; ``proj`` -> {mod:
[b, emb_dim]} (FOCAL pretrain views); ``feat`` -> {mod: [b, 2H]} (the KNN
probe's features); ``both`` -> (logits, proj). Submodules carry the flax
tree's names (``loc_mod_extractor_{loc}_{mod}``, ``mod_extractor_{mod}``,
``recurrent_{mod}``, ``mod_projector_{mod}``, ``class_layer``). The
``mod_extractor`` reads the fused [b, i, c] map as NHWC [b, i, c, 1]: one
input channel, spectrum c; with ``use_pallas`` it trains through the fused
tower where ``tower_takes`` admits it, as every conv block does.

``compute_dtype`` (the CLI's ``-compute_dtype``) is the activations' type,
as flax's ``dtype=``: in bf16 the inputs are cast to it, the conv blocks,
the location mean and the projection and class heads compute in it (the
fused towers through #13-bf16/#14-bf16), the GRUs in f32 (so the ``feat``
head is f32), and the class logits are cast to f32. Parameters stay f32.

Under tensor parallelism (``models.registry.apply_plan``) each conv block
computes its rank's output channels (``models.layers.ConvBlock``), its
``out_proj`` gathered after; the projector pair is column- then
row-parallel; the GRUs and the class head stay whole on every rank.
"""

import math
from collections.abc import Mapping

import torch
import torch.nn as nn

from focal_tpu_torch.models.layers import (BatchNorm, BiGRU, BiGRULayer, ClassHead, ConvBlock,
                                           MeanFusion, ProjectionHead)
from focal_tpu_torch.models.sw_transformer import trunc_normal


class DeepSense(nn.Module):
    def __init__(self, dataset_config, task, linear_class_head=True, use_pallas=False,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        cfgs = dataset_config
        config = cfgs["DeepSense"]
        self.modalities = cfgs["modality_names"]
        self.locations = cfgs["location_names"]
        self.multi_location = len(self.locations) > 1
        out_channels = config["loc_mod_out_channels"]
        H = config["recurrent_dim"]
        for mod in self.modalities:
            if isinstance(config["loc_mod_conv_lens"], Mapping):
                conv_lens = config["loc_mod_conv_lens"][mod]
                in_stride = config["loc_mod_in_conv_stride"][mod]
            else:
                conv_lens, in_stride = config["loc_mod_conv_lens"], (1, 1)
            for loc in self.locations:
                self.add_module(f"loc_mod_extractor_{loc}_{mod}", ConvBlock(
                    cfgs["loc_mod_in_freq_channels"][loc][mod],
                    (cfgs["num_segments"], cfgs["loc_mod_spectrum_len"][loc][mod]),
                    out_channels, conv_lens, config["loc_mod_conv_inter_layers"], in_stride,
                    config["dropout_ratio"], use_pallas, compute_dtype))
            feat_channels = out_channels
            if self.multi_location:
                i_out = 1 if conv_lens[1][0] > 1 else cfgs["num_segments"]
                self.add_module(f"loc_fusion_{mod}", MeanFusion())
                self.add_module(f"mod_extractor_{mod}", ConvBlock(
                    1, (i_out, out_channels), config["loc_out_channels"],
                    config["loc_conv_lens"], config["loc_conv_inter_layers"], (1, 1),
                    config["dropout_ratio"], use_pallas, compute_dtype))
                feat_channels = config["loc_out_channels"]
            self.add_module(f"recurrent_{mod}", BiGRU(
                feat_channels, H, config["recurrent_layers"], config["dropout_ratio"]))
        emb_dim = cfgs["FOCAL"]["emb_dim"]
        for mod in self.modalities:
            self.add_module(f"mod_projector_{mod}", ProjectionHead(2 * H, emb_dim, compute_dtype))
        self.class_layer = ClassHead(len(self.modalities) * 2 * H, cfgs[task]["num_classes"],
                                     config["fc_dim"], linear=linear_class_head,
                                     compute_dtype=compute_dtype)

    def encode(self, freq_x, rng=None):
        """-> {mod: [b, 2 * recurrent_dim]}."""
        feats = {}
        for mod in self.modalities:
            per_loc = [
                getattr(self, f"loc_mod_extractor_{loc}_{mod}")(
                    freq_x[loc][mod].to(self.compute_dtype).permute(0, 2, 3, 1), rng)  # [b, i, s, c]
                for loc in self.locations
            ]
            if self.multi_location:
                fused = getattr(self, f"loc_fusion_{mod}")(torch.stack(per_loc, dim=2))
                x = getattr(self, f"mod_extractor_{mod}")(fused[..., None], rng)
            else:
                x = per_loc[0]
            feats[mod] = getattr(self, f"recurrent_{mod}")(x, rng)
        return feats

    def forward(self, freq_x, head="class", rng=None):
        feats = self.encode(freq_x, rng)
        if head == "feat":
            return feats
        proj = {m: getattr(self, f"mod_projector_{m}")(feats[m]) for m in self.modalities}
        if head == "proj":
            return proj
        logits = self.class_layer(torch.cat([feats[m] for m in self.modalities], dim=1)
                                  ).to(torch.float32)
        if head == "class":
            return logits
        if head == "both":
            return logits, proj
        raise ValueError(f"Unknown head: {head}")


def _lecun(t, fan_in, g):
    """flax lecun_normal: truncated normal whose values have std fan_in**-0.5."""
    t.copy_(trunc_normal(t.shape, fan_in**-0.5 / 0.87962566, g))


def init_params(model, seed=0):
    """Seeded init in the flax package's style, from an explicit generator:
    lecun-normal Dense and conv kernels (fan_in = in, and kh*kw*cin for a
    conv), the GRU's wi lecun-normal over its stacked [2, C, 3H] shape
    (flax's fan_in is then 2C), wh orthogonal as ONE [2H, 3H] matrix with
    orthonormal rows viewed as [2, H, 3H] (flax's draw), zero biases,
    BatchNorm scale 1, bias 0, running mean 0 and variance 1."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                _lecun(mod.weight, mod.weight.shape[1], g)
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                _lecun(mod.weight, math.prod(mod.weight.shape[1:]), g)
                mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
            elif isinstance(mod, BiGRULayer):
                _lecun(mod.wi, mod.wi.shape[0] * mod.wi.shape[1], g)
                two, H, H3 = mod.wh.shape
                wh = torch.empty(two * H, H3)
                torch.nn.init.orthogonal_(wh, generator=g)
                mod.wh.copy_(wh.view(two, H, H3))
                mod.bi.zero_()
                mod.bh.zero_()
    return model
