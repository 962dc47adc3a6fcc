"""Backbones of the port."""

from focal_tpu_torch.models.registry import apply_plan, build_backbone, init_params

__all__ = ["apply_plan", "build_backbone", "init_params"]
