"""Import reference PyTorch checkpoints into the port's state_dict (the
port's copy of the JAX package's ``utils/torch_import.py``).

The reference saves plain ``state_dict()`` files and loads them by key
intersection. This module maps a reference-trained DeepSense or
SW_Transformer state_dict onto the port's, through the flax tree: the port's
state_dict becomes a flax tree (``weights.flax_from_params``), the JAX
package's numpy mapping runs on it line for line, and the result comes back
(``weights.params_from_flax``), so both packages share one mapping.

Layout conversions handled:
  - Conv2d  [out, in, kh, kw]  ->  flax NHWC kernel [kh, kw, in, out]
  - the ConvBlock output Conv1d flattens torch [b, c, s, i] channel-major
    (index c*S + s) while the flax block flattens NHWC spectrum-major
    (index s*C + c): rows are permuted to match (``_out_proj_rows``)
  - torch nn.GRU per-direction weight_ih/hh_l{k}(_reverse) [3H, in] ->
    BiGRULayer stacked [2, in, 3H] (gate order r, z, n is identical)
  - nn.Linear [out, in] -> Dense kernel [in, out]
  - nn.MultiheadAttention's packed in_proj -> per-head query/key/value

Use ``load_torch_state_dict`` for a ``.pt`` file, then
``import_state_dict`` with the port model's own state_dict as the schema
(``import_deepsense_state_dict`` and ``import_sw_transformer_state_dict``
are the JAX package's mapping on the flax tree). Saved with ``torch.save``
(the ``train.checkpoint.save_params`` format), the result starts a run
through ``-init_weight``.
"""

import copy
from collections.abc import Mapping

import numpy as np
import torch

from focal_tpu_torch.weights import flax_from_params, params_from_flax


def _np(v):
    """torch tensor / array -> numpy array."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def load_torch_state_dict(path):
    """Load a reference ``.pt`` checkpoint into a {name: numpy} dict."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _np(v) for k, v in obj.items()}


def _set(dst, key, value):
    """Shape-checked, dtype-preserving assignment into a param subtree."""
    old = dst[key]
    value = np.asarray(value)
    if tuple(np.shape(old)) != value.shape:
        raise ValueError(
            f"Shape mismatch importing '{key}': checkpoint {value.shape}, model {np.shape(old)}"
        )
    dst[key] = value.astype(np.asarray(old).dtype)


def _conv_layer(sd, pt, layer_params, layer_stats):
    w = _np(sd[pt + "conv.weight"])  # [out, in, kh, kw]
    _set(layer_params["Conv_0"], "kernel", w.transpose(2, 3, 1, 0))
    _set(layer_params["Conv_0"], "bias", _np(sd[pt + "conv.bias"]))
    _set(layer_params["BatchNorm_0"], "scale", _np(sd[pt + "batch_norm.weight"]))
    _set(layer_params["BatchNorm_0"], "bias", _np(sd[pt + "batch_norm.bias"]))
    _set(layer_stats["BatchNorm_0"], "mean", _np(sd[pt + "batch_norm.running_mean"]))
    _set(layer_stats["BatchNorm_0"], "var", _np(sd[pt + "batch_norm.running_var"]))


def _out_proj_rows(in_total, half_channels, fuse_time, interval_num):
    """Row permutation mapping flax flatten order onto torch flatten order.

    Non-fused: flax row s*C + c  <- torch row c*S + s
    Fused:     flax row i*S*C + s*C + c  <- torch row c*S*I + s*I + i
    (reference: ConvModules.py:208-216)."""
    C = half_channels
    if fuse_time:
        I = interval_num
        S = in_total // (C * I)
        f = np.arange(in_total)
        i, rest = f // (S * C), f % (S * C)
        s, c = rest // C, rest % C
        return c * S * I + s * I + i
    S = in_total // C
    f = np.arange(in_total)
    s, c = f // C, f % C
    return c * S + s


def _conv_block(sd, pt, block_params, block_stats, fuse_time, interval_num):
    _conv_layer(sd, pt + "conv_layer_in.", block_params["ConvLayer2D_0"], block_stats["ConvLayer2D_0"])
    i = 0
    while pt + f"conv_layers_inter.{i}.conv.weight" in sd:
        _conv_layer(
            sd,
            pt + f"conv_layers_inter.{i}.",
            block_params[f"ConvLayer2D_{i + 1}"],
            block_stats[f"ConvLayer2D_{i + 1}"],
        )
        i += 1
    wout = _np(sd[pt + "conv_layer_out.weight"])[:, :, 0]  # [out, in_total]
    half = _np(sd[pt + "conv_layer_in.conv.weight"]).shape[0]
    rows = _out_proj_rows(wout.shape[1], half, fuse_time, interval_num)
    _set(block_params["out_proj"], "kernel", wout.T[rows])
    _set(block_params["out_proj"], "bias", _np(sd[pt + "conv_layer_out.bias"]))


def _gru(sd, pt, dst):
    layer = 0
    while f"{pt}weight_ih_l{layer}" in sd:
        g = dst[f"gru{layer}"]
        _set(g, "wi", np.stack([
            _np(sd[f"{pt}weight_ih_l{layer}"]).T,
            _np(sd[f"{pt}weight_ih_l{layer}_reverse"]).T,
        ]))
        _set(g, "wh", np.stack([
            _np(sd[f"{pt}weight_hh_l{layer}"]).T,
            _np(sd[f"{pt}weight_hh_l{layer}_reverse"]).T,
        ]))
        _set(g, "bi", np.stack([
            _np(sd[f"{pt}bias_ih_l{layer}"]),
            _np(sd[f"{pt}bias_ih_l{layer}_reverse"]),
        ]))
        _set(g, "bh", np.stack([
            _np(sd[f"{pt}bias_hh_l{layer}"]),
            _np(sd[f"{pt}bias_hh_l{layer}_reverse"]),
        ]))
        layer += 1


def _linear(sd, pt, dst):
    # multi-dim feature kernels (head-aligned qkv [C, 3, H, hd]) ravel
    # losslessly to/from torch's [out, in]: transpose then reshape
    w = _np(sd[pt + "weight"]).T
    _set(dst, "kernel", _sized_reshape(w, np.shape(dst["kernel"]), pt + "weight"))
    if pt + "bias" in sd:
        _set(dst, "bias", _sized_reshape(_np(sd[pt + "bias"]), np.shape(dst["bias"]), pt + "bias"))


def _sized_reshape(value, shape, key):
    """Reshape with the import's own error type (not numpy's) on size mismatch."""
    if value.size != int(np.prod(shape)):
        raise ValueError(
            f"Shape mismatch importing '{key}': checkpoint {value.shape}, model {tuple(shape)}"
        )
    return value.reshape(shape)


def _plain(tree):
    """FrozenDict / dict pytree -> mutable nested dict copy."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return copy.copy(tree)


def import_deepsense_state_dict(sd, variables, dataset_config, interval_num=None,
                                load_class_layer=True):
    """Map a reference torch DeepSense state_dict into (params, batch_stats).

    ``variables`` ({"params": ..., "batch_stats": ...}) is the flax tree
    (``flax_from_params``) of the port's DeepSense built from the same
    ``dataset_config``;
    the shapes act as the schema check. Missing keys raise KeyError, shape
    mismatches ValueError. ``load_class_layer=False`` mirrors the reference
    finetune loading rule (weight_utils.py:18-21)."""
    config = dataset_config["DeepSense"]
    mods = dataset_config["modality_names"]
    locs = dataset_config["location_names"]
    params = _plain(variables["params"])
    stats = _plain(variables.get("batch_stats", {}))
    interval_num = interval_num or dataset_config.get("num_segments", 9)

    def conv_lens_for(mod):
        cl = config["loc_mod_conv_lens"]
        return cl[mod] if isinstance(cl, Mapping) else cl

    for loc in locs:
        for mod in mods:
            fuse = conv_lens_for(mod)[1][0] > 1
            _conv_block(
                sd, f"loc_mod_extractors.{loc}.{mod}.",
                params[f"loc_mod_extractor_{loc}_{mod}"],
                stats[f"loc_mod_extractor_{loc}_{mod}"],
                fuse, interval_num,
            )
    if len(locs) > 1:
        for mod in mods:
            fuse = config["loc_conv_lens"][1][0] > 1
            _conv_block(
                sd, f"mod_extractors.{mod}.",
                params[f"mod_extractor_{mod}"], stats[f"mod_extractor_{mod}"],
                fuse, interval_num,
            )
    for mod in mods:
        _gru(sd, f"recurrent_layers.{mod}.gru.", params[f"recurrent_{mod}"])
        _linear(sd, f"mod_projectors.{mod}.0.", params[f"mod_projector_{mod}"]["Dense_0"])
        _linear(sd, f"mod_projectors.{mod}.2.", params[f"mod_projector_{mod}"]["Dense_1"])
    if load_class_layer and "class_layer.0.weight" in sd:
        _linear(sd, "class_layer.0.", params["class_layer"]["Dense_0"])
        if "class_layer.2.weight" in sd:
            _linear(sd, "class_layer.2.", params["class_layer"]["Dense_1"])
    return params, stats


def _layer_norm(sd, pt, dst):
    _set(dst, "scale", _np(sd[pt + "weight"]))
    _set(dst, "bias", _np(sd[pt + "bias"]))


def _mha(sd, pt, dst, num_heads):
    """torch nn.MultiheadAttention -> flax MultiHeadDotProductAttention.

    in_proj_weight stacks [Wq; Wk; Wv] as [3E, E] rows; flax wants per-head
    [E, H, D] kernels (column-major application), so each slice transposes
    then splits the output axis into heads. out_proj [E, E] -> [H, D, E]."""
    w = _np(sd[pt + "in_proj_weight"])  # [3E, E]
    b = _np(sd[pt + "in_proj_bias"])
    e = w.shape[1]
    h, d = num_heads, e // num_heads
    for i, name in enumerate(("query", "key", "value")):
        _set(dst[name], "kernel", w[i * e : (i + 1) * e].T.reshape(e, h, d))
        _set(dst[name], "bias", b[i * e : (i + 1) * e].reshape(h, d))
    _set(dst["out"], "kernel", _np(sd[pt + "out_proj.weight"]).T.reshape(h, d, e))
    _set(dst["out"], "bias", _np(sd[pt + "out_proj.bias"]))


def _attention_fusion(sd, pt, dst, num_heads):
    """Reference TransformerFusionBlock (FusionModules.py:63-140) ->
    AttentionFusion (LayerNorm + mean-query MHA)."""
    _layer_norm(sd, pt + "norm1.", dst["LayerNorm_0"])
    _mha(sd, pt + "mha.", dst["MultiHeadDotProductAttention_0"], num_heads)


def _swin_block(sd, pt, dst):
    """Reference SwinTransformerBlock (SwinModules.py:171-343) -> SwinBlock."""
    _layer_norm(sd, pt + "norm1.", dst["norm1"])
    _set(dst["attn"], "relative_position_bias_table",
         _np(sd[pt + "attn.relative_position_bias_table"]))
    _linear(sd, pt + "attn.qkv.", dst["attn"]["qkv"])
    _linear(sd, pt + "attn.proj.", dst["attn"]["proj"])
    _layer_norm(sd, pt + "norm2.", dst["norm2"])
    _linear(sd, pt + "mlp.fc1.", dst["mlp"]["Dense_0"])
    _linear(sd, pt + "mlp.fc2.", dst["mlp"]["Dense_1"])


def _torch_encoder_layer(sd, pt, dst, num_heads):
    """torch nn.TransformerEncoderLayer (post-norm) -> TransformerEncoderLayer."""
    _mha(sd, pt + "self_attn.", dst["MultiHeadDotProductAttention_0"], num_heads)
    _linear(sd, pt + "linear1.", dst["Dense_0"])
    _linear(sd, pt + "linear2.", dst["Dense_1"])
    _layer_norm(sd, pt + "norm1.", dst["LayerNorm_0"])
    _layer_norm(sd, pt + "norm2.", dst["LayerNorm_1"])


def import_sw_transformer_state_dict(sd, variables, dataset_config, load_class_layer=True):
    """Map a reference torch SW_Transformer state_dict into flax params.

    Covers the full surface (reference: src/models/SW_Transformer.py:17-182 +
    SwinModules.py): patch embeds, APE (when the flax model was built with
    APE: True), Swin stages with PatchMerging, mod_in layers, multi-location
    context/fusion, projectors, mod fusion, class head. The model has no
    BatchNorm, so only params are returned (batch_stats stays empty)."""
    config = dataset_config["SW_Transformer"]
    mods = dataset_config["modality_names"]
    locs = dataset_config["location_names"]
    params = _plain(variables["params"])

    for loc in locs:
        for mod in mods:
            pe = params[f"patch_embed_{loc}_{mod}"]
            w = _np(sd[f"patch_embed.{loc}.{mod}.proj.weight"])  # [E, C, ph, pw]
            _set(pe["proj"], "kernel", w.transpose(2, 3, 1, 0))
            _set(pe["proj"], "bias", _np(sd[f"patch_embed.{loc}.{mod}.proj.bias"]))
            if f"patch_embed.{loc}.{mod}.norm.weight" in sd and "LayerNorm_0" in pe:
                _layer_norm(sd, f"patch_embed.{loc}.{mod}.norm.", pe["LayerNorm_0"])
            if f"absolute_pos_embed_{loc}_{mod}" in params:
                _set(params, f"absolute_pos_embed_{loc}_{mod}",
                     _np(sd[f"absolute_pos_embed.{loc}.{mod}"]))

            for i_layer in range(len(config["time_freq_block_num"][mod])):
                stage = params[f"stage{i_layer}_{loc}_{mod}"]
                base = f"freq_interval_layers.{loc}.{mod}.{i_layer}."
                j = 0
                while base + f"blocks.{j}.norm1.weight" in sd:
                    _swin_block(sd, base + f"blocks.{j}.", stage[f"block{j}"])
                    j += 1
                if base + "downsample.reduction.weight" in sd:
                    _linear(sd, base + "downsample.reduction.",
                            stage["downsample"]["reduction"])
                    _layer_norm(sd, base + "downsample.norm.",
                                stage["downsample"]["LayerNorm_0"])
            _linear(sd, f"mod_in_layers.{loc}.{mod}.", params[f"mod_in_layer_{loc}_{mod}"])

    if len(locs) > 1:
        for mod in mods:
            i = 0
            while f"loc_context_layers.{mod}.{i}.norm1.weight" in sd:
                _torch_encoder_layer(sd, f"loc_context_layers.{mod}.{i}.",
                                     params[f"loc_context_{mod}_{i}"],
                                     config["loc_head_num"])
                i += 1
            _attention_fusion(sd, f"loc_fusion_layer.{mod}.",
                              params[f"loc_fusion_{mod}"], config["loc_head_num"])

    for mod in mods:
        _linear(sd, f"mod_projectors.{mod}.0.", params[f"mod_projector_{mod}"]["Dense_0"])
        _linear(sd, f"mod_projectors.{mod}.2.", params[f"mod_projector_{mod}"]["Dense_1"])
    _attention_fusion(sd, "mod_fusion_layers.", params["mod_fusion_layer"],
                      config["loc_head_num"])
    if load_class_layer and "class_layer.0.weight" in sd:
        _linear(sd, "class_layer.0.", params["class_layer"]["Dense_0"])
        if "class_layer.2.weight" in sd:
            _linear(sd, "class_layer.2.", params["class_layer"]["Dense_1"])
    return params, _plain(variables.get("batch_stats", {}))



IMPORTERS = {"DeepSense": import_deepsense_state_dict,
             "SW_Transformer": import_sw_transformer_state_dict}


def import_state_dict(model_name, sd, model_state, dataset_config, load_class_layer=True):
    """A reference state_dict ``sd`` ({name: array}) of the backbone
    ``model_name`` -> the port's state_dict {name: tensor}. ``model_state``
    is the state_dict of the port's backbone built from ``dataset_config``:
    its shapes are the schema (a missing key raises KeyError, a shape that
    differs ValueError) and, without ``load_class_layer``, its class head
    is kept."""
    if model_name not in IMPORTERS:
        raise ValueError(f"Invalid model provided: {model_name}")
    params, batch_stats = flax_from_params(model_state, dataset_config)
    params, batch_stats = IMPORTERS[model_name](
        sd, {"params": params, "batch_stats": batch_stats}, dataset_config,
        load_class_layer=load_class_layer)
    return params_from_flax(params, batch_stats, dataset_config)
