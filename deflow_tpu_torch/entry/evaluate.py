"""Validation sweep (counterpart of ``deflow_tpu/entry/evaluate.py``
``run_validation``).

Batches come from any iterable of host batches prepped with
``data.host_prep.attach_host_prep``; labels and masks were co-permuted with
the points, so the metric needs no unsort.  Outputs destined for the
original point order are restored with ``pc0_unsort`` on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

from deflow_tpu_torch.metrics.threeway import ThreewayEPE


def run_validation(eval_step: Callable, batches: Iterable[Dict],
                   three: Optional[ThreewayEPE] = None) -> Dict[str, float]:
    """Stream host batches through ``eval_step`` into the 3-way metric.

    Pass ``three`` to keep the accumulator (for its table)."""
    three = ThreewayEPE() if three is None else three
    for host_batch in batches:
        if "flow" not in host_batch or "flow_is_valid" not in host_batch:
            raise ValueError(
                "run_validation needs ground-truth flow labels (keys 'flow' "
                "and 'flow_is_valid')")
        out = eval_step(host_batch)
        pred = out["pred_flow"].float().cpu().numpy()
        pose_flow = out["pose_flow"].float().cpu().numpy()
        for b in range(pred.shape[0]):
            mask = host_batch["pc0_mask"][b] & host_batch["flow_is_valid"][b]
            if "eval_mask" in host_batch:
                mask &= host_batch["eval_mask"][b]
            three.update(pred[b], host_batch["flow"][b],
                         host_batch["flow_category_indices"][b],
                         pose_flow[b], mask)
    return three.compute()
