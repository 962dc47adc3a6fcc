"""Backbone registry."""

from focal_tpu_torch.params import get_train_mode


def build_backbone(dataset_config, model, task, learn_framework="no"):
    """Instantiate the backbone named `model` (on the CPU; move it after).

    The class head is linear for supervised training or when the recipe's
    ``pretrained_head`` says so, as in the JAX package."""
    if model == "SW_Transformer":
        from focal_tpu_torch.models.sw_transformer import SWTransformer

        linear_head = (
            get_train_mode(learn_framework) == "supervised"
            or dataset_config[model].get("pretrained_head", "linear") == "linear"
        )
        return SWTransformer(dataset_config, task, linear_class_head=linear_head)
    if model == "DeepSense":
        raise NotImplementedError("DeepSense is not ported yet: ROADMAP A5")
    raise ValueError(f"Invalid model provided: {model}")
