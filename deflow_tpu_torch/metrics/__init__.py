"""Host-side metrics (numpy)."""

from deflow_tpu_torch.metrics.bucketed import BucketedEPE
from deflow_tpu_torch.metrics.threeway import ThreewayEPE

__all__ = ["BucketedEPE", "ThreewayEPE", "frame_metrics"]


def frame_metrics(args):
    """Both accumulators' contributions of one frame; ``args`` are
    ``update``'s (pred_flow, gt_flow, classes, pose_flow, mask).  In a
    module that imports only numpy, so a worker process can run it."""
    return ThreewayEPE.frame_stats(*args), BucketedEPE.frame_stats(*args)
