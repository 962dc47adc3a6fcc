"""Backbone registry: build a backbone by name, and its flax-style init."""

import torch

from focal_tpu_torch.params import get_train_mode

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_backbone(dataset_config, model, task, learn_framework="no", pallas_conv=False,
                   pallas_mlp=False, pallas_block=True, compute_dtype="float32"):
    """Instantiate the backbone named `model` (on the CPU; move it after).

    The class head is linear for supervised training or when the recipe's
    ``pretrained_head`` says so, as in the JAX package. ``pallas_conv``
    (DeepSense only) trains the conv blocks through the fused conv-tower
    kernels, as the JAX package's ``-pallas_conv``; ``pallas_mlp``
    (SW_Transformer only) runs the Swin MLPs through the fused MLP kernels,
    as its ``-pallas_mlp``; ``pallas_block=False`` (SW_Transformer only; the
    DeepSense branch never reads it, as in the JAX package) runs window
    attention through the attention-only kernels, as its
    ``-no_pallas_block``. ``compute_dtype`` ("float32" or "bfloat16", the
    JAX package's ``-compute_dtype``) is the activations' type over f32
    parameters; bf16 runs every route of both backbones in its bf16 form:
    SW_Transformer's whole-block route (#1-bf16 to #5-bf16), with
    ``pallas_mlp`` its MLPs through #10-bf16 to #12-bf16, with
    ``pallas_block=False`` its attention through #6-bf16 to #9-bf16, and
    the XLA attention in bf16 at widths no bf16 kernel takes; DeepSense on
    cuDNN's bf16 convs, or with ``pallas_conv`` through the conv tower's
    bf16 forms #13-bf16/#14-bf16."""
    if model not in ("SW_Transformer", "DeepSense"):
        raise ValueError(f"Invalid model provided: {model}")
    dtype = COMPUTE_DTYPES[compute_dtype]
    linear_head = (
        get_train_mode(learn_framework) == "supervised"
        or dataset_config[model].get("pretrained_head", "linear") == "linear"
    )
    if model == "SW_Transformer":
        from focal_tpu_torch.models.sw_transformer import SWTransformer

        return SWTransformer(dataset_config, task, linear_class_head=linear_head,
                             pallas_mlp=pallas_mlp, pallas_block=pallas_block,
                             compute_dtype=dtype)
    from focal_tpu_torch.models.deepsense import DeepSense

    return DeepSense(dataset_config, task, linear_class_head=linear_head, use_pallas=pallas_conv,
                     compute_dtype=dtype)


def init_params(model, seed=0):
    """The flax-style seeded init of a backbone built by build_backbone."""
    from focal_tpu_torch.models import deepsense, sw_transformer

    if isinstance(model, deepsense.DeepSense):
        return deepsense.init_params(model, seed)
    if isinstance(model, sw_transformer.SWTransformer):
        return sw_transformer.init_params(model, seed)
    raise ValueError(f"No init for {type(model).__name__}")


def apply_plan(model, plan):
    """Place a built and initialised backbone on a process layout
    (``parallel.mesh.MeshPlan``; None: one process): every module that takes
    part (``plan`` attribute: the Dense layers, window attentions, conv
    blocks and BatchNorms) learns the plan, and under tensor parallelism
    ``parallel.tp.shard_model`` keeps this rank's slice of each parameter
    (and BatchNorm statistic) the rules cut. Under tensor parallelism the
    fused MLP and the fused conv tower are off: the Swin MLPs run their
    Dense pair and the conv blocks their cuDNN convs, as the JAX package
    builds both backbones without those kernels on a model axis
    (``focal_tpu/models/registry.py``: ``-pallas_mlp`` and ``-pallas_conv``
    only where mp is 1)."""
    if plan is None:
        return model
    from focal_tpu_torch.models.layers import ConvBlock
    from focal_tpu_torch.models.swin import Mlp
    from focal_tpu_torch.parallel import tp

    for mod in model.modules():
        if hasattr(mod, "plan"):
            mod.plan = plan
        if plan.mp > 1 and isinstance(mod, Mlp):
            mod.fused = False
        if plan.mp > 1 and isinstance(mod, ConvBlock):
            mod.use_pallas = False
    model.plan = plan  # the train state's layout
    if plan.mp > 1:
        tp.shard_model(model, plan)
    return model
