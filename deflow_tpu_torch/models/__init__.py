"""Models."""

from deflow_tpu_torch.models.deflow import DeFlow, build_model

__all__ = ["DeFlow", "build_model"]
