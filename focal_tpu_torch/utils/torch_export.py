"""Export the port's state_dict as the reference's (the port's copy of the
JAX package's ``utils/torch_export.py``).

The inverse of ``torch_import``: checkpoints trained here become plain
``state_dict()`` files the reference stack loads with its own
``weight_utils.load_model_weight`` or with ``model.load_state_dict(sd)``.
Strict loading works because the exporters also emit the registered
geometry buffers (``relative_position_index``, shifted-window ``attn_mask``,
BatchNorm ``num_batches_tracked``) that appear in the reference models'
state_dicts; the geometry comes from the port's own ``models/swin.py`` and
``models/sw_transformer.py``.

The port's state_dict becomes a flax tree (``weights.flax_from_params``)
and the JAX package's numpy mapping runs on it line for line, so the
export of ``params_from_flax(tree)`` equals the JAX package's export of
``tree`` key for key and bitwise. One difference: a single-location
DeepSense carries the reference's dead ``mod_extractors`` blocks, which
the JAX package fills with a flax init from its own random key (whose
values follow its configured PRNG: threefry on the CPU, rbg on the TPU);
the port fills them with its own seeded init of the same ConvBlock (the
same shapes; the reference never runs them).

Use ``export_state_dict`` to build the dict from the port's state_dict
(``export_deepsense_state_dict`` and ``export_sw_transformer_state_dict``
are the JAX package's mapping on the flax tree), then
``save_torch_state_dict`` for a ``.pt`` file.
"""

from collections.abc import Mapping

import numpy as np
import torch

from focal_tpu_torch.models.deepsense import _lecun
from focal_tpu_torch.models.layers import ConvBlock
from focal_tpu_torch.models.sw_transformer import get_padded_size
from focal_tpu_torch.models.swin import relative_position_index, shifted_window_mask
from focal_tpu_torch.utils.torch_import import _out_proj_rows
from focal_tpu_torch.weights import flax_from_params


def _f32(v):
    """flax param leaf (possibly bf16 jax array) -> float32 numpy."""
    return np.asarray(v).astype(np.float32)


def save_torch_state_dict(sd, path):
    """Write a {name: numpy} dict as a torch ``.pt`` state_dict file."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


def _conv_layer(out, pt, layer_params, layer_stats):
    k = _f32(layer_params["Conv_0"]["kernel"])  # [kh, kw, in, out]
    out[pt + "conv.weight"] = k.transpose(3, 2, 0, 1)
    out[pt + "conv.bias"] = _f32(layer_params["Conv_0"]["bias"])
    out[pt + "batch_norm.weight"] = _f32(layer_params["BatchNorm_0"]["scale"])
    out[pt + "batch_norm.bias"] = _f32(layer_params["BatchNorm_0"]["bias"])
    out[pt + "batch_norm.running_mean"] = _f32(layer_stats["BatchNorm_0"]["mean"])
    out[pt + "batch_norm.running_var"] = _f32(layer_stats["BatchNorm_0"]["var"])
    # registered buffer of torch BatchNorm2d (only consumed under
    # momentum=None, which the reference never uses) — emitted so
    # load_state_dict(strict=True) finds every key
    out[pt + "batch_norm.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _conv_block(out, pt, block_params, block_stats, fuse_time, interval_num):
    _conv_layer(out, pt + "conv_layer_in.", block_params["ConvLayer2D_0"],
                block_stats["ConvLayer2D_0"])
    i = 0
    while f"ConvLayer2D_{i + 1}" in block_params:
        _conv_layer(out, pt + f"conv_layers_inter.{i}.",
                    block_params[f"ConvLayer2D_{i + 1}"],
                    block_stats[f"ConvLayer2D_{i + 1}"])
        i += 1
    kernel = _f32(block_params["out_proj"]["kernel"])  # [in_total, out]
    half = np.shape(block_params["ConvLayer2D_0"]["Conv_0"]["kernel"])[-1]
    rows = _out_proj_rows(kernel.shape[0], half, fuse_time, interval_num)
    wout_t = np.empty_like(kernel)
    wout_t[rows] = kernel  # invert: import set flax_kernel = wout.T[rows]
    out[pt + "conv_layer_out.weight"] = wout_t.T[:, :, None]  # Conv1d [out, in, 1]
    out[pt + "conv_layer_out.bias"] = _f32(block_params["out_proj"]["bias"])


def _gru(out, pt, src):
    layer = 0
    while f"gru{layer}" in src:
        g = src[f"gru{layer}"]
        wi, wh, bi, bh = (_f32(g[k]) for k in ("wi", "wh", "bi", "bh"))
        for d, suffix in ((0, ""), (1, "_reverse")):
            out[f"{pt}weight_ih_l{layer}{suffix}"] = wi[d].T
            out[f"{pt}weight_hh_l{layer}{suffix}"] = wh[d].T
            out[f"{pt}bias_ih_l{layer}{suffix}"] = bi[d]
            out[f"{pt}bias_hh_l{layer}{suffix}"] = bh[d]
        layer += 1


def _linear(out, pt, src):
    # multi-dim feature kernels (head-aligned qkv [C, 3, H, hd]) flatten back
    # to torch Linear's [out, in]
    k = _f32(src["kernel"])
    out[pt + "weight"] = k.reshape(k.shape[0], -1).T
    if "bias" in src:
        out[pt + "bias"] = _f32(src["bias"]).reshape(-1)


def _class_layer(out, params):
    if "class_layer" not in params:
        # backbone-only (pretrain) checkpoints may omit the head; the
        # reference loader tolerates missing keys (weight_utils.py:17-23
        # filters trained_dict into model_dict), only strict loads need it
        return
    _linear(out, "class_layer.0.", params["class_layer"]["Dense_0"])
    if "Dense_1" in params["class_layer"]:
        _linear(out, "class_layer.2.", params["class_layer"]["Dense_1"])


def _dead_mod_extractor(dataset_config, interval_num):
    """Correctly-shaped params/stats for the reference's dead (single-loc)
    mod_extractor ConvBlocks: the port's ConvBlock on the MeanFusion output
    shape [1, intervals, loc_mod_out_channels, 1], in the port's seeded
    init (seed 0), as a flax tree."""
    config = dataset_config["DeepSense"]
    block = ConvBlock(1, (interval_num, config["loc_mod_out_channels"]),
                      config["loc_out_channels"], config["loc_conv_lens"],
                      config["loc_conv_inter_layers"])
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for mod in block.modules():
            if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
                _lecun(mod.weight, int(np.prod(mod.weight.shape[1:])), g)
                mod.bias.zero_()
    return flax_from_params(block.state_dict(), dataset_config)


def export_deepsense_state_dict(params, batch_stats, dataset_config, interval_num=None):
    """Flax DeepSense (params, batch_stats) -> reference torch state_dict.

    Key schema matches src/models/DeepSense.py:11-167 (+ ConvModules.py,
    RecurrentModule.py); ``torch.nn.Module.load_state_dict`` on a
    freshly-constructed reference model succeeds with strict=True."""
    config = dataset_config["DeepSense"]
    mods = dataset_config["modality_names"]
    locs = dataset_config["location_names"]
    interval_num = interval_num or dataset_config.get("num_segments", 9)
    out = {}

    def conv_lens_for(mod):
        cl = config["loc_mod_conv_lens"]
        return cl[mod] if isinstance(cl, Mapping) else cl

    for loc in locs:
        for mod in mods:
            fuse = conv_lens_for(mod)[1][0] > 1
            _conv_block(out, f"loc_mod_extractors.{loc}.{mod}.",
                        params[f"loc_mod_extractor_{loc}_{mod}"],
                        batch_stats[f"loc_mod_extractor_{loc}_{mod}"],
                        fuse, interval_num)
    fuse_loc = config["loc_conv_lens"][1][0] > 1
    if len(locs) > 1:
        for mod in mods:
            _conv_block(out, f"mod_extractors.{mod}.",
                        params[f"mod_extractor_{mod}"],
                        batch_stats[f"mod_extractor_{mod}"],
                        fuse_loc, interval_num)
    else:
        # the reference constructs mod_extractors unconditionally but only
        # calls them multi-location (DeepSense.py:64-71,127-131) — on a
        # single-location recipe they are dead parameters that still appear
        # in state_dict(). Emit correctly-shaped placeholders (from a
        # seeded init of the same ConvBlock the multi-loc path uses) so
        # load_state_dict(strict=True) succeeds.
        dead_p, dead_s = _dead_mod_extractor(dataset_config, interval_num)
        for mod in mods:
            _conv_block(out, f"mod_extractors.{mod}.", dead_p, dead_s,
                        fuse_loc, interval_num)
    for mod in mods:
        _gru(out, f"recurrent_layers.{mod}.gru.", params[f"recurrent_{mod}"])
        _linear(out, f"mod_projectors.{mod}.0.", params[f"mod_projector_{mod}"]["Dense_0"])
        _linear(out, f"mod_projectors.{mod}.2.", params[f"mod_projector_{mod}"]["Dense_1"])
    _class_layer(out, params)
    return out


def _layer_norm(out, pt, src):
    out[pt + "weight"] = _f32(src["scale"])
    out[pt + "bias"] = _f32(src["bias"])


def _mha(out, pt, src):
    """flax MultiHeadDotProductAttention -> torch nn.MultiheadAttention
    (inverse of torch_import._mha: per-head [E, H, D] kernels back into the
    stacked [3E, E] in_proj rows)."""
    e = _f32(src["query"]["kernel"]).shape[0]
    out[pt + "in_proj_weight"] = np.concatenate(
        [_f32(src[name]["kernel"]).reshape(e, e).T for name in ("query", "key", "value")]
    )
    out[pt + "in_proj_bias"] = np.concatenate(
        [_f32(src[name]["bias"]).reshape(e) for name in ("query", "key", "value")]
    )
    out[pt + "out_proj.weight"] = _f32(src["out"]["kernel"]).reshape(e, e).T
    out[pt + "out_proj.bias"] = _f32(src["out"]["bias"])


def _attention_fusion(out, pt, src):
    _layer_norm(out, pt + "norm1.", src["LayerNorm_0"])
    _mha(out, pt + "mha.", src["MultiHeadDotProductAttention_0"])


def _torch_encoder_layer(out, pt, src):
    _mha(out, pt + "self_attn.", src["MultiHeadDotProductAttention_0"])
    _linear(out, pt + "linear1.", src["Dense_0"])
    _linear(out, pt + "linear2.", src["Dense_1"])
    _layer_norm(out, pt + "norm1.", src["LayerNorm_0"])
    _layer_norm(out, pt + "norm2.", src["LayerNorm_1"])


def _shrunk_geometry(H, W, window, shift):
    """The static window-shrink rule both frameworks apply
    (reference: SwinModules.py:222-236)."""
    wh, ww = window
    sh, sw = shift
    if H <= wh:
        sh, wh = 0, H
    if W <= ww:
        sw, ww = 0, W
    return wh, ww, sh, sw


def _swin_block(out, pt, src, H, W, window, shift):
    _layer_norm(out, pt + "norm1.", src["norm1"])
    out[pt + "attn.relative_position_bias_table"] = _f32(
        src["attn"]["relative_position_bias_table"]
    )
    _linear(out, pt + "attn.qkv.", src["attn"]["qkv"])
    _linear(out, pt + "attn.proj.", src["attn"]["proj"])
    _layer_norm(out, pt + "norm2.", src["norm2"])
    _linear(out, pt + "mlp.fc1.", src["mlp"]["Dense_0"])
    _linear(out, pt + "mlp.fc2.", src["mlp"]["Dense_1"])
    # registered geometry buffers (reference: SwinModules.py:111,291) —
    # deterministic functions of the block geometry, emitted for strict loads
    wh, ww, sh, sw = _shrunk_geometry(H, W, window, shift)
    out[pt + "attn.relative_position_index"] = (
        relative_position_index(wh, ww).astype(np.int64)
    )
    if min(sh, sw) > 0:  # the reference registers attn_mask=None otherwise
        out[pt + "attn_mask"] = shifted_window_mask(H, W, wh, ww, sh, sw)


def export_sw_transformer_state_dict(params, dataset_config):
    """Flax SW_Transformer params -> reference torch state_dict.

    Key schema matches src/models/SW_Transformer.py:17-182 + SwinModules.py,
    including per-block geometry buffers, so strict loading works. Stage
    geometry (padded size, patch grid, per-stage halving, window shrink,
    alternating shift) is rederived exactly as the model's setup does."""
    config = dataset_config["SW_Transformer"]
    mods = dataset_config["modality_names"]
    locs = dataset_config["location_names"]
    num_segments = dataset_config["num_segments"]
    out = {}

    for loc in locs:
        for mod in mods:
            pe = params[f"patch_embed_{loc}_{mod}"]
            out[f"patch_embed.{loc}.{mod}.proj.weight"] = (
                _f32(pe["proj"]["kernel"]).transpose(3, 2, 0, 1)
            )
            out[f"patch_embed.{loc}.{mod}.proj.bias"] = _f32(pe["proj"]["bias"])
            if "LayerNorm_0" in pe:
                _layer_norm(out, f"patch_embed.{loc}.{mod}.norm.", pe["LayerNorm_0"])
            # same derivation as SWTransformer.setup
            stride = config["in_stride"][mod]
            spectrum_len = dataset_config["loc_mod_spectrum_len"][loc][mod]
            block_num = list(config["time_freq_block_num"][mod])
            window = list(config["window_size"][mod])
            patch = list(config["patch_size"]["freq"][mod])
            padded = get_padded_size(
                (num_segments, spectrum_len // stride), window, patch, len(block_num)
            )
            patches_res = (padded[0] // patch[0], padded[1] // patch[1])

            if f"absolute_pos_embed_{loc}_{mod}" in params:
                out[f"absolute_pos_embed.{loc}.{mod}"] = _f32(
                    params[f"absolute_pos_embed_{loc}_{mod}"]
                )
            else:
                # the reference creates the APE Parameter unconditionally and
                # only ADDS it when APE: True (SW_Transformer.py:76-79,
                # 223-224) — with APE off it is a dead parameter that still
                # appears in state_dict(); emit a zero placeholder
                embed_dim = config["time_freq_out_channels"]
                out[f"absolute_pos_embed.{loc}.{mod}"] = np.zeros(
                    (1, patches_res[0] * patches_res[1], embed_dim), np.float32
                )

            for i_layer, depth in enumerate(block_num):
                stage = params[f"stage{i_layer}_{loc}_{mod}"]
                base = f"freq_interval_layers.{loc}.{mod}.{i_layer}."
                down = 2**i_layer
                H, W = patches_res[0] // down, patches_res[1] // down
                for j in range(depth):
                    shift = [0, 0] if j % 2 == 0 else [window[0] // 2, window[1] // 2]
                    _swin_block(out, base + f"blocks.{j}.", stage[f"block{j}"],
                                H, W, window, shift)
                if "downsample" in stage:
                    _linear(out, base + "downsample.reduction.",
                            stage["downsample"]["reduction"])
                    _layer_norm(out, base + "downsample.norm.",
                                stage["downsample"]["LayerNorm_0"])
            _linear(out, f"mod_in_layers.{loc}.{mod}.", params[f"mod_in_layer_{loc}_{mod}"])

    if len(locs) > 1:
        for mod in mods:
            i = 0
            while f"loc_context_{mod}_{i}" in params:
                _torch_encoder_layer(out, f"loc_context_layers.{mod}.{i}.",
                                     params[f"loc_context_{mod}_{i}"])
                i += 1
            _attention_fusion(out, f"loc_fusion_layer.{mod}.", params[f"loc_fusion_{mod}"])

    for mod in mods:
        _linear(out, f"mod_projectors.{mod}.0.", params[f"mod_projector_{mod}"]["Dense_0"])
        _linear(out, f"mod_projectors.{mod}.2.", params[f"mod_projector_{mod}"]["Dense_1"])
    _attention_fusion(out, "mod_fusion_layers.", params["mod_fusion_layer"])
    _class_layer(out, params)
    return out



def export_state_dict(model_name, state_dict, dataset_config):
    """The port's state_dict of the backbone ``model_name`` -> the
    reference's torch state_dict {name: numpy}."""
    params, batch_stats = flax_from_params(state_dict, dataset_config)
    if model_name == "DeepSense":
        return export_deepsense_state_dict(params, batch_stats, dataset_config)
    if model_name == "SW_Transformer":
        return export_sw_transformer_state_dict(params, dataset_config)
    raise ValueError(f"Invalid model provided: {model_name}")
