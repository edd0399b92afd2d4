"""Bounds of the program's hand-written kernels from a step's shapes, and
the names that find them in a trace.

A frozen copy of the repository's roofline arithmetic (``chip_smoke.py``
``bound``, ``hold_segment_sum``, ``hold_gather``, and the kernel
categories of ``_category``; a head's own in its file): the bound of a
call is the larger of its operations over the peak rate and its bytes
over the HBM rate, bytes read and written once.  Peaks: NVIDIA H100 SXM data sheet, dense bf16 989
TFLOP/s, HBM 3.35 TB/s.

``step_calls`` lists, for a train or eval step of the supervised DeFlow /
FastFlow3D model on the host-sorted path, each wrapper call the step
makes and its bound: the embedder's two segment-sums (33 lanes), the
decoder's gather (128 lanes), their backwards (a 33-lane gather each, a
128-lane segment-sum), and the head's own calls
(``counts/heads/<decoder_option>.py``); remat runs each forward call twice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from portbench.counts import heads

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TRASH_PAD = 8
TABLE_LANES = 128           # the decoder's gathered [pc0 | pc1 | U-Net] features

# wrapper counters of the program's trunk (module, function): each
# function's ``launches`` attribute counts its calls; a head adds its own
WRAPPERS = {
    "segment_sum": ("deflow_tpu_torch.ops.scatter", "sorted_segment_sum"),
    "sorted_gather": ("deflow_tpu_torch.ops.gather", "sorted_rows_gather"),
    "cbg_fwd": ("deflow_tpu_torch.ops.cbg", "cbg_block_fwd"),
    "cbg_bwd": ("deflow_tpu_torch.ops.cbg", "cbg_block_bwd"),
    "segment_sum_lanes": ("deflow_tpu_torch.ops.scatter", "segment_sum_lanes"),
    "cell_sweep": ("deflow_tpu_torch.ops.sweep", "cell_sweep"),
    "chamfer_brute": ("deflow_tpu_torch.ops.nn", "chamfer_min"),
}

# device kernel names → wrapper of the trunk (chip_smoke ``_category``, in
# its order); a head's keys are tried first
_NAME_KEYS = (("cell_sweep", ("cell_sweep",)),
              ("segment_sum_lanes", ("lane_sum",)),
              ("chamfer_brute", ("chamfer_brute",)),
              ("cbg_fwd", ("cbg_fwd",)),
              ("cbg_bwd", ("cbg_dgrad", "cbg_wgrad", "wgrad_reduce")),
              ("segment_sum", ("segment_sum",)),
              ("sorted_gather", ("rows_kernel", "chunk_kernel")))


def wrappers(cfg: Dict) -> Dict[str, Tuple[str, str]]:
    """The counters a step of ``cfg``'s model reads: the trunk's and its head's."""
    return {**WRAPPERS, **heads.of(cfg).WRAPPERS}


def kernel_of(name: str, cfg: Optional[Dict] = None):
    """The wrapper a device kernel belongs to, or None: among the trunk's
    and the head's of ``cfg`` (None: of every head)."""
    n = name.lower()
    if any(k in n for k in ("sort", "searchsorted", "index_put", "fill_index")):
        return None
    found = heads.every() if cfg is None else [heads.of(cfg)]
    for wrapper, keys in tuple(k for h in found for k in h.NAME_KEYS) + _NAME_KEYS:
        if any(k in n for k in keys):
            return wrapper
    return None


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def segment_sum_bound(n: int, nv: int, c: int, rows: int, isz: int = 2) -> float:
    """``n`` rows (``nv`` below the sentinel) of ``c`` lanes into ``rows``."""
    return bound_s(nv * c * isz + n * 4 + rows * c * isz, nv * c)


def gather_bound(m: int, read: int, c: int, isz: int = 2) -> float:
    """``m`` ids reading ``read`` distinct rows of ``c`` lanes."""
    return bound_s(m * 4 + read * c * isz + m * c * isz, 0.0)


def step_calls(cfg: Dict, mode: str, remat: bool, stats: List[Dict],
               slots: int) -> List[Tuple[str, float]]:
    """(wrapper, bound seconds) of each call of one step over the samples
    ``stats`` (each: ``valid0``, ``valid1``, ``occupied0``, ``occupied1``)."""
    lo, hi = cfg["point_cloud_range"][:3], cfg["point_cloud_range"][3:]
    gw, gh = (int(round((h - l) / v)) for l, h, v in list(zip(lo, hi, cfg["voxel_size"]))[:2])
    p, b = gw * gh, len(stats)
    n = b * slots
    v0, v1 = (sum(s[k] for s in stats) for k in ("valid0", "valid1"))
    o0, o1 = (sum(s[k] for s in stats) for k in ("occupied0", "occupied1"))
    c = int(cfg["feat_channels"]) + 1
    head_fwd, head_bwd = heads.of(cfg).step_calls(cfg, stats, slots)
    fwd = [("segment_sum", segment_sum_bound(n, v0, c, b * (p + TRASH_PAD))),
           ("segment_sum", segment_sum_bound(n, v1, c, b * (p + TRASH_PAD))),
           ("sorted_gather", gather_bound(n, o0, TABLE_LANES))] + head_fwd
    if mode != "train":
        return fwd
    bwd = [("segment_sum", segment_sum_bound(n, v0, TABLE_LANES, b * p)),
           ("sorted_gather", gather_bound(n, o0, c)),
           ("sorted_gather", gather_bound(n, o1, c))] + head_bwd
    return fwd * (2 if remat else 1) + bwd


def bound_by_wrapper(calls: List[Tuple[str, float]]) -> Dict[str, Tuple[int, float]]:
    """wrapper → (calls, summed bound seconds)."""
    out: Dict[str, Tuple[int, float]] = {}
    for name, s in calls:
        k, t = out.get(name, (0, 0.0))
        out[name] = (k + 1, t + s)
    return out
