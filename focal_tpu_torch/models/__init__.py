"""Backbones of the port."""

from focal_tpu_torch.models.registry import build_backbone, init_params

__all__ = ["build_backbone", "init_params"]
