"""Host-side metrics (numpy)."""

from deflow_tpu_torch.metrics.threeway import ThreewayEPE

__all__ = ["ThreewayEPE"]
