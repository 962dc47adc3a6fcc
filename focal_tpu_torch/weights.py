"""Carry a flax parameter tree into the port's state_dict.

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
