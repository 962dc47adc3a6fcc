"""Tensor parallelism over the ``model`` axis (the port's form of the JAX
package's ``parallel/tp.py``): which parameters shard, and how.

The rules are the JAX package's, matched against the port's dotted
state_dict names (the flax names joined by dots, ``weights.py``) and turned
to the port's layouts: nn.Linear keeps [out, in], so a column-parallel
product shards axis 0 and a row-parallel one axis 1; the fused qkv weight
[3C, C] has rows part|head|dim, so one head's rows are three strided blocks
("qkv": the axis is 3 parts of H heads). A leaf whose sharded unit does not
divide by mp stays whole on every rank, as in the JAX package.

DeepSense:
  * every conv tower's convs (``(loc_)?mod_extractor_*.ConvLayer2D_k``)
    by output channels, their BatchNorms' scale and bias and running mean
    and variance (buffers) with them: one channel split across a tower, so
    the residual adds stay a rank's own;
  * ``out_proj`` column-wise, its output gathered after (the GRUs and the
    class head stay whole);
  * the projector pair, Dense_0 column- and Dense_1 row-parallel.
SW_Transformer:
  * every Swin block: the window attention by whole heads (qkv columns,
    proj rows, the bias table's heads), the MLP's Dense_0 column- and
    Dense_1 row-parallel;
  * ``mod_in_layer`` column-wise, its output gathered after;
  * the projector pair, Dense_0 column- and Dense_1 row-parallel;
  * the fusion attentions (MultiHeadDotProductAttention) by whole heads:
    query, key and value column-, out row-parallel.
The port shards the attention's proj by heads where the JAX package shards
its rows wherever C divides: the two differ only where H does not divide by
mp, where the port keeps the whole attention on every rank.

``shard_model`` cuts each rank's slice out of a model built and initialised
whole, so every layout starts from the single-process init; the modules
whose parameters it cut (``tp_sharded``) then compute their part and the
collectives (models/layers.py ``Dense`` and ``ConvBlock``, models/swin.py
``WindowAttention``). The optimizer's moments follow their parameter's
slice, the BatchNorm statistics their channels'; ``full_state_dict`` and
``load_local`` carry checkpoints across layouts.
"""

import re
from typing import NamedTuple

import torch

from focal_tpu_torch.parallel import distributed

# (regex searched in the name, axis of the port's layout, unit): unit "dim"
# shards the axis itself, "heads" the owner's num_heads blocks of it, "qkv"
# 3 parts of num_heads blocks
_RULES = (
    (re.compile(r"mod_extractor_[^.]+\.ConvLayer2D_\d+\.Conv_0\.(weight|bias)$"), 0, "dim"),
    (re.compile(r"mod_extractor_[^.]+\.ConvLayer2D_\d+\.BatchNorm_0\.(weight|bias|mean|var)$"), 0,
     "dim"),
    (re.compile(r"mod_extractor_[^.]+\.out_proj\.(weight|bias)$"), 0, "dim"),
    (re.compile(r"\.mlp\.Dense_0\.(weight|bias)$"), 0, "dim"),
    (re.compile(r"\.mlp\.Dense_1\.weight$"), 1, "dim"),
    (re.compile(r"\.attn\.qkv\.(weight|bias)$"), 0, "qkv"),
    (re.compile(r"\.attn\.proj\.weight$"), 1, "heads"),
    (re.compile(r"\.attn\.relative_position_bias_table$"), -1, "dim"),
    (re.compile(r"\.(query|key|value)\.(weight|bias)$"), 0, "heads"),
    (re.compile(r"\.out\.weight$"), 1, "heads"),
    (re.compile(r"^mod_in_layer_[^.]+\.(weight|bias)$"), 0, "dim"),
    (re.compile(r"^mod_projector_[^.]+\.Dense_0\.(weight|bias)$"), 0, "dim"),
    (re.compile(r"^mod_projector_[^.]+\.Dense_1\.weight$"), 1, "dim"),
)


class Spec(NamedTuple):
    """Axis ``axis`` is ``parts`` runs of ``blocks`` equal blocks; model
    rank m keeps blocks [m b / mp, (m + 1) b / mp) of every run."""
    axis: int
    parts: int
    blocks: int


def leaf_spec(name, shape, mp, heads=None):
    """The Spec of parameter ``name`` of ``shape`` under mp-way tensor
    parallelism, or None (whole on every rank). ``heads``: the head count of
    the attention that owns it (for the "heads" and "qkv" units)."""
    if mp <= 1:
        return None
    for rx, axis, unit in _RULES:
        if rx.search(name) is None:
            continue
        axis = axis % len(shape)
        parts, blocks = (3, heads) if unit == "qkv" else (1, heads if unit == "heads" else
                                                           shape[axis])
        if not blocks or blocks % mp or shape[axis] % (parts * blocks):
            return None
        return Spec(axis, parts, blocks)
    return None


def local_slice(t, spec, mp, m):
    """Model rank m's slice of the whole tensor ``t``."""
    shape = list(t.shape)
    a = spec.axis
    v = t.reshape(shape[:a] + [spec.parts, spec.blocks, -1] + shape[a + 1:])
    per = spec.blocks // mp
    v = v.narrow(a + 1, m * per, per)
    return v.reshape(shape[:a] + [shape[a] // mp] + shape[a + 1:]).contiguous()


def whole(t, spec, mp, group):
    """The whole tensor from every model rank's slice ``t`` (a collective)."""
    shape = list(t.shape)
    a = spec.axis
    v = t.reshape(shape[:a] + [spec.parts, spec.blocks // mp, -1] + shape[a + 1:])
    full = distributed.all_gather(v.contiguous(), group, dim=a + 1)
    return full.reshape(shape[:a] + [shape[a] * mp] + shape[a + 1:])


def _owner_heads(model, name):
    """num_heads of the nearest module on ``name``'s path that has one."""
    parts = name.split(".")[:-1]
    for k in range(len(parts), -1, -1):
        mod = model.get_submodule(".".join(parts[:k]))
        if hasattr(mod, "num_heads"):
            return mod.num_heads
    return None


def model_specs(model, mp, buffers=False):
    """{parameter name: Spec} of the parameters that shard at mp ways, from
    the whole model; with ``buffers`` the same of its buffers (BatchNorm
    statistics)."""
    specs = {}
    named = model.named_buffers() if buffers else model.named_parameters()
    for name, p in named:
        spec = leaf_spec(name, tuple(p.shape), mp, _owner_heads(model, name))
        if spec is not None:
            specs[name] = spec
    return specs


def sharded_leaf_count(model, mp):
    """How many parameters shard at mp ways (the JAX package's count of
    leaves with a ``model`` axis, over its params)."""
    return len(model_specs(model, mp))


def shard_model(model, plan):
    """Replace each sharding parameter of the whole ``model`` by this rank's
    slice (``tp_spec`` on the parameter names its Spec) and mark the module
    that owns it ``tp_sharded``; each sharding buffer likewise (their specs
    in ``model.tp_buffer_specs``). Returns the {name: Spec} of the cut
    parameters."""
    specs = model_specs(model, plan.mp)
    model.tp_buffer_specs = model_specs(model, plan.mp, buffers=True)
    with torch.no_grad():
        for name, spec in (*specs.items(), *model.tp_buffer_specs.items()):
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            t = getattr(owner, leaf)
            local = local_slice(t.data, spec, plan.mp, plan.m)
            if name in specs:
                local = torch.nn.Parameter(local, requires_grad=t.requires_grad)
                local.tp_spec = spec
                owner.tp_sharded = True
            setattr(owner, leaf, local)
    return specs


def is_sharded(p):
    return getattr(p, "tp_spec", None) is not None


def _state_specs(model):
    """{state_dict name: Spec} of the entries a rank holds a slice of."""
    specs = {n: p.tp_spec for n, p in model.named_parameters() if is_sharded(p)}
    return {**specs, **getattr(model, "tp_buffer_specs", {})}


def full_state_dict(model, plan):
    """The model's state_dict in the single-process layout: each sharded
    parameter and buffer gathered whole over the model axis (every model
    rank takes part)."""
    specs = _state_specs(model) if plan is not None and plan.mp > 1 else {}
    return {name: whole(t, specs[name], plan.mp, plan.model) if name in specs else t
            for name, t in model.state_dict().items()}


def load_local(model, state, plan, skip=()):
    """Copy a single-process state_dict into ``model``, each sharded
    parameter's and buffer's slice (entries it lacks and names containing a
    ``skip`` string keep theirs; a shape that differs raises)."""
    specs = _state_specs(model)
    own = model.state_dict()
    with torch.no_grad():
        for name, t in own.items():
            if name not in state or any(s in name for s in skip):
                continue
            src = state[name]
            spec = specs.get(name)
            if spec is not None:
                want = list(t.shape)
                want[spec.axis] *= plan.mp
                if list(src.shape) != want:
                    raise ValueError(f"{name} has shape {tuple(src.shape)}, the model "
                                     f"{tuple(want)}")
                src = local_slice(src, spec, plan.mp, plan.m)
            elif tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name} has shape {tuple(src.shape)}, the model "
                                 f"{tuple(t.shape)}")
            t.copy_(src)
