"""SW_Transformer backbone: hierarchical shifted-window attention over
time-frequency patches per (loc, mod), with attention fusion over
modalities; with several locations each modality's per-location features
first pass ``loc_block_num`` location-context layers
(``TransformerEncoderLayer``) and an attention fusion over the locations.
Port of the JAX package's ``models/sw_transformer.py``. In
``train()`` mode the forward takes the step's ``rng`` (``ops.dropout.
StepRngs``); the pretrain path reads ``head="proj"`` and does not run
``mod_fusion_layer``.

Input spectra are folded by ``in_stride`` and zero-padded to a
Swin-divisible size; stages halve the resolution and double the channels.
Submodules are registered under the flax tree's names
(``patch_embed_{loc}_{mod}``, ``stage{i}_{loc}_{mod}``,
``mod_in_layer_{loc}_{mod}``, ``loc_context_{mod}_{i}``, ``loc_fusion_{mod}``,
``mod_projector_{mod}``, ``mod_fusion_layer``, ``class_layer``).
``pallas_mlp`` (the CLI's ``-pallas_mlp``) routes each
Swin block's MLP through the fused MLP kernels where ``mlp_takes``;
``pallas_block`` off (the CLI's ``-no_pallas_block``) routes its window
attention through the attention-only kernels (#6-#9) instead of the
whole-block ones. ``compute_dtype`` (the CLI's ``-compute_dtype``) is the
activations' type, as the JAX package's ``dtype``: the input spectra and
the position embedding are cast to it, every layer computes in it over f32
parameters (``models.swin``), and the class logits come out in f32.

Under tensor parallelism (``models.registry.apply_plan``) the Swin blocks
split their heads and MLP widths, ``mod_in_layer`` its output columns
(gathered after it), the projectors and fusion attentions theirs
(``parallel.tp``); the rest runs whole on every model rank.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from focal_tpu_torch.models.layers import (AttentionFusion, ClassHead, Dense, ProjectionHead,
                                           TransformerEncoderLayer)
from focal_tpu_torch.models.swin import BasicLayer, PatchEmbed


def get_padded_size(img_size, window_size, patch_size, num_stages):
    """Smallest size >= img_size divisible by window*patch*2^(stages-1)."""
    scale = 2 ** (num_stages - 1)
    unit_h = window_size[0] * patch_size[0] * scale
    unit_w = window_size[1] * patch_size[1] * scale
    out = [max(unit_h, img_size[0]), max(unit_w, img_size[1])]
    for i, unit in enumerate((unit_h, unit_w)):
        if out[i] % unit != 0:
            out[i] = unit * math.ceil(out[i] / unit)
    return tuple(out)


def mod_geometry(dataset_config, loc, mod):
    """Static input geometry of one (loc, mod): stride, img_size, padded
    size, patch grid and the per-stage (resolution, channels)."""
    config = dataset_config["SW_Transformer"]
    stride = config["in_stride"][mod]
    spectrum_len = dataset_config["loc_mod_spectrum_len"][loc][mod]
    img_size = (dataset_config["num_segments"], spectrum_len // stride)
    block_num = list(config["time_freq_block_num"][mod])
    window = list(config["window_size"][mod])
    patch = list(config["patch_size"]["freq"][mod])
    padded = get_padded_size(img_size, window, patch, len(block_num))
    patches_res = (padded[0] // patch[0], padded[1] // patch[1])
    embed_dim = config["time_freq_out_channels"]
    stages = [
        ((patches_res[0] // 2**i, patches_res[1] // 2**i), embed_dim * 2**i)
        for i in range(len(block_num))
    ]
    return {
        "stride": stride, "img_size": img_size, "padded": padded, "patch": patch,
        "window": window, "block_num": block_num, "patches_res": patches_res,
        "stages": stages,
    }


class SWTransformer(nn.Module):
    def __init__(self, dataset_config, task, linear_class_head=True, pallas_mlp=False,
                 pallas_block=True, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dt = compute_dtype
        cfgs = dataset_config
        config = cfgs["SW_Transformer"]
        self.modalities = cfgs["modality_names"]
        self.locations = cfgs["location_names"]
        self.multi_location = len(self.locations) > 1
        embed_dim = config["time_freq_out_channels"]
        self.geometries = {}
        for loc in self.locations:
            for mod in self.modalities:
                geo = mod_geometry(cfgs, loc, mod)
                self.geometries[(loc, mod)] = geo
                in_chans = 2 * cfgs["loc_mod_in_time_channels"][loc][mod] * geo["stride"]
                self.add_module(f"patch_embed_{loc}_{mod}", PatchEmbed(
                    geo["patch"], in_chans, embed_dim, norm=config.get("patch_norm", True),
                    compute_dtype=dt))
                if config.get("APE", False):
                    n_patches = geo["patches_res"][0] * geo["patches_res"][1]
                    self.register_parameter(
                        f"absolute_pos_embed_{loc}_{mod}",
                        nn.Parameter(torch.zeros(1, n_patches, embed_dim)),
                    )
                block_num = geo["block_num"]
                dpr = list(np.linspace(0, config.get("drop_path_rate", 0.0), sum(block_num)))
                for i, depth in enumerate(block_num):
                    res, dim = geo["stages"][i]
                    self.add_module(f"stage{i}_{loc}_{mod}", BasicLayer(
                        dim=dim, input_resolution=res, depth=depth,
                        num_heads=config["time_freq_head_num"], window_size=geo["window"],
                        mlp_ratio=float(config.get("mlp_ratio", 4.0)),
                        qkv_bias=bool(config.get("qkv_bias", True)),
                        drop=config["dropout_ratio"],
                        attn_drop=config.get("attn_drop_rate", 0.0),
                        drop_path=tuple(dpr[sum(block_num[:i]): sum(block_num[: i + 1])]),
                        downsample=i < len(block_num) - 1, pallas_mlp=pallas_mlp,
                        pallas_block=pallas_block, compute_dtype=dt,
                    ))
                (fh, fw), final_dim = geo["stages"][-1]
                self.add_module(f"mod_in_layer_{loc}_{mod}",
                                Dense(fh * fw * final_dim, config["loc_out_channels"],
                                      compute_dtype=dt, tp_role="column_gather"))

        loc_out = config["loc_out_channels"]
        self.loc_block_num = config["loc_block_num"] if self.multi_location else 0
        if self.multi_location:  # per-mod location context, then fusion over locations
            for mod in self.modalities:
                for i in range(self.loc_block_num):
                    self.add_module(f"loc_context_{mod}_{i}", TransformerEncoderLayer(
                        loc_out, config["loc_head_num"], loc_out, config["dropout_ratio"],
                        compute_dtype=dt))
                self.add_module(f"loc_fusion_{mod}", AttentionFusion(
                    loc_out, config["loc_head_num"], config["dropout_ratio"], compute_dtype=dt))
        emb_dim = cfgs["FOCAL"]["emb_dim"]
        for mod in self.modalities:
            self.add_module(f"mod_projector_{mod}",
                            ProjectionHead(loc_out, emb_dim, compute_dtype=dt))
        self.mod_fusion_layer = AttentionFusion(loc_out, config["loc_head_num"],
                                                config["dropout_ratio"], compute_dtype=dt)
        self.class_layer = ClassHead(
            loc_out, cfgs[task]["num_classes"], config["fc_dim"], linear=linear_class_head,
            compute_dtype=dt,
        )

    def stages(self, loc, mod):
        n = len(self.geometries[(loc, mod)]["block_num"])
        return [getattr(self, f"stage{i}_{loc}_{mod}") for i in range(n)]

    def pad_input(self, x, loc, mod):
        """Fold spectrum by stride, pad to the Swin-divisible size, NHWC out."""
        geo = self.geometries[(loc, mod)]
        stride = geo["stride"]
        b, c, i, s = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, i, s // stride, c * stride)
        pad_h = geo["padded"][0] - geo["img_size"][0]
        pad_w = geo["padded"][1] - geo["img_size"][1]
        return F.pad(x, (0, 0, 0, pad_w, 0, pad_h))

    def encode(self, freq_x, rng=None):
        """-> {mod: [b, loc_out_channels]}."""
        mod_loc_features = {mod: [] for mod in self.modalities}
        for loc in self.locations:
            for mod in self.modalities:
                x = self.pad_input(freq_x[loc][mod].to(self.compute_dtype), loc, mod)
                x = getattr(self, f"patch_embed_{loc}_{mod}")(x)
                ape = getattr(self, f"absolute_pos_embed_{loc}_{mod}", None)
                if ape is not None:
                    x = x + ape.to(self.compute_dtype)
                for stage in self.stages(loc, mod):
                    x = stage(x, rng)
                mod_loc_features[mod].append(
                    getattr(self, f"mod_in_layer_{loc}_{mod}")(x.reshape(x.shape[0], -1)))
        if not self.multi_location:
            return {mod: feats[0] for mod, feats in mod_loc_features.items()}
        mod_features = {}
        for mod, feats in mod_loc_features.items():
            x = torch.stack(feats, dim=1)  # [b, n_loc, c]
            for i in range(self.loc_block_num):
                x = getattr(self, f"loc_context_{mod}_{i}")(x, rng)
            mod_features[mod] = getattr(self, f"loc_fusion_{mod}")(x[:, None], rng)[:, 0]
        return mod_features

    def forward(self, freq_x, head="class", rng=None):
        mod_features = self.encode(freq_x, rng)
        if head == "feat":
            return mod_features
        proj = {m: getattr(self, f"mod_projector_{m}")(mod_features[m]) for m in self.modalities}
        if head == "proj":
            return proj
        stacked = torch.stack([mod_features[m] for m in self.modalities], dim=1)  # [b, n_mod, c]
        fused = self.mod_fusion_layer(stacked[:, None], rng)[:, 0]
        logits = self.class_layer(fused.to(self.compute_dtype)).to(torch.float32)
        if head == "class":
            return logits
        if head == "both":
            return logits, proj
        raise ValueError(f"Unknown head: {head}")


def trunc_normal(shape, std, generator):
    """flax's truncated normal: N(0, std^2) restricted to [-2 std, 2 std]
    (resampled, not clipped), on the CPU from ``generator``."""
    t = torch.empty(shape)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def init_params(model, seed=0):
    """Seeded init in the flax package's style, drawn from an explicit
    generator: lecun-normal weights (``nn.initializers.lecun_normal``:
    truncated normal with std fan_in**-0.5 / 0.8796, so the truncated
    values have std fan_in**-0.5), zero biases, unit LayerNorm scales, bias
    tables and position embeddings ``truncated_normal(0.02)``. An
    attention's q/k/v and out Linears take fan_in C (= H * hd for out), as
    flax's DenseGeneral kernels [C, H, hd] and [H, hd, C] do."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                fan_in = mod.weight.shape[1]
                mod.weight.copy_(trunc_normal(mod.weight.shape, fan_in**-0.5 / 0.87962566, g))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table") or "absolute_pos_embed" in name:
                p.copy_(trunc_normal(p.shape, 0.02, g))
    return model
