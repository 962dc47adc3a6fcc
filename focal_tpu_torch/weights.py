"""Carry a flax parameter tree into the port's state_dict, and back.

The flax tree is read as nested dicts of numpy arrays (as ``jax.device_get``
gives them); the port's module names are the flax names joined by dots, so
``stage0_shake_audio/block1/attn/qkv/kernel`` becomes
``stage0_shake_audio.block1.attn.qkv.weight``. Layout changes:
  * Dense / DenseGeneral kernels [in, *features] ravel to [in, out] and
    transpose to ``nn.Linear``'s [out, in]. The head-aligned qkv kernel
    [C, 3, H, hd] ravels with column order part|head|dim, the fused layout
    the kernel takes.
  * A DenseGeneral whose kernel contracts leading axes (flax MHA ``out``,
    [H, hd, c]) ravels to [H*hd, c].
  * The PatchEmbed conv kernel [kh, kw, in, out] (NHWC) ravels to
    [kh*kw*in, out], the port's patch-reshape order.
  * A ConvLayer2D's ``Conv_0`` kernel [kh, kw, in, out] (HWIO) becomes
    ``nn.Conv2d``'s [out, in, kh, kw].
  * LayerNorm and BatchNorm ``scale`` become ``weight``; other leaves keep
    their names (the GRU's stacked wi, bi, wh, bh among them).
  * ``batch_stats`` (BatchNorm's running ``mean`` and ``var``) become the
    buffers of the same names.

``flax_from_params`` is the exact inverse: it takes the flax shapes the
flattening lost (the heads of the qkv and attention kernels, the patch
grid of a PatchEmbed kernel) from the recipe, so the reference-format
mapping (``utils/torch_import.py``, ``utils/torch_export.py``) runs on the
flax tree as the JAX package's does.
"""

from collections.abc import Mapping

import numpy as np
import torch


def _linear_weight(kernel, contract_leading):
    k = np.asarray(kernel, np.float32)
    flat = k.reshape(-1, k.shape[-1]) if contract_leading else k.reshape(k.shape[0], -1)
    return flat.T


def params_from_flax(params, batch_stats, dataset_config):
    """flax ``params`` (+ ``batch_stats``) -> port state_dict {name: tensor}.

    ``dataset_config`` is the recipe the tree was built for; every layout
    below is the same at one location or several."""
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            sub = path + [key]
            if isinstance(val, Mapping):
                walk(val, sub)
                continue
            name = ".".join(path)
            if key == "kernel" and path[-1] == "Conv_0":
                arr, key = np.transpose(np.asarray(val, np.float32), (3, 2, 0, 1)), "weight"
            elif key == "kernel":
                conv = len(path) >= 2 and path[-2].startswith("patch_embed")
                contract = conv or path[-1] == "out"
                arr = _linear_weight(val, contract)
                key = "weight"
            elif key == "scale":
                arr, key = np.asarray(val, np.float32), "weight"
            elif key == "bias" and np.ndim(val) > 1:
                arr = np.asarray(val, np.float32).reshape(-1)  # DenseGeneral bias
            else:
                arr = np.asarray(val, np.float32)
            full = f"{name}.{key}" if name else key
            out[full] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    walk(params, [])
    walk(batch_stats or {}, [])
    return out


def _patch_size(name, dataset_config):
    """The (ph, pw) of the PatchEmbed module ``patch_embed_{loc}_{mod}``."""
    for loc in dataset_config["location_names"]:
        for mod in dataset_config["modality_names"]:
            if name == f"patch_embed_{loc}_{mod}":
                return dataset_config["SW_Transformer"]["patch_size"]["freq"][mod]
    raise KeyError(f"no (location, modality) of the recipe names {name}")


def _flax_leaf(path, key, arr, dataset_config):
    """(flax key, flax array) of one state_dict entry: params_from_flax's
    layout changes undone."""
    module = path[-1] if path else ""
    mha = len(path) >= 2 and path[-2].startswith("MultiHeadDotProductAttention")
    if key == "weight" and module == "Conv_0":
        return "kernel", np.transpose(arr, (2, 3, 1, 0))
    if key == "weight" and arr.ndim == 1:
        return "scale", arr
    if key == "weight":
        k = arr.T
        if len(path) >= 2 and path[-2].startswith("patch_embed"):
            ph, pw = _patch_size(path[-2], dataset_config)
            return "kernel", k.reshape(ph, pw, -1, k.shape[-1])
        if module == "qkv":
            heads = dataset_config["SW_Transformer"]["time_freq_head_num"]
            return "kernel", k.reshape(k.shape[0], 3, heads, -1)
        if mha and module in ("query", "key", "value"):
            heads = dataset_config["SW_Transformer"]["loc_head_num"]
            return "kernel", k.reshape(k.shape[0], heads, -1)
        if mha and module == "out":
            heads = dataset_config["SW_Transformer"]["loc_head_num"]
            return "kernel", k.reshape(heads, -1, k.shape[-1])
        return "kernel", k
    if key == "bias" and module == "qkv":
        return key, arr.reshape(3, dataset_config["SW_Transformer"]["time_freq_head_num"], -1)
    if key == "bias" and mha and module in ("query", "key", "value"):
        return key, arr.reshape(dataset_config["SW_Transformer"]["loc_head_num"], -1)
    return key, arr


def flax_from_params(state_dict, dataset_config):
    """Port state_dict {name: tensor} -> flax (params, batch_stats) as
    nested dicts of float32 numpy arrays: the inverse of params_from_flax,
    ``flax_from_params(params_from_flax(p, s, cfg), cfg) == (p, s)``
    bitwise. ``dataset_config`` is the recipe the model was built for."""
    params, batch_stats = {}, {}
    for name, t in state_dict.items():
        *path, key = name.split(".")
        arr = t.detach().cpu().numpy().astype(np.float32) if hasattr(t, "detach") else t
        arr = np.asarray(arr, np.float32)
        stats = key in ("mean", "var") and bool(path) and path[-1].startswith("BatchNorm")
        if not stats:
            key, arr = _flax_leaf(path, key, arr, dataset_config)
        node = batch_stats if stats else params
        for part in path:
            node = node.setdefault(part, {})
        node[key] = np.array(arr, np.float32, order="C")
    return params, batch_stats
