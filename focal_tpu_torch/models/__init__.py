"""Backbones of the port."""

from focal_tpu_torch.models.registry import build_backbone

__all__ = ["build_backbone"]
