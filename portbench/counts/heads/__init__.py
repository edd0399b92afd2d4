"""Each head's counts, one file a head: ``<decoder_option>.py`` in a
directory of ``SEARCH`` (``lib/heads.py``).  A head's file defines:

- ``forward_flops(cfg, stats)``: the head's forward FLOPs over the samples
  ``stats`` (each a ``samples.sample_stats``), counted as ``flops.py``
  counts;
- ``point_flops(cfg)``, for a head whose count is a number a valid pc0
  point: that number (``flops.point_flops``, ``flops.step_flops``);
- ``WRAPPERS``: wrapper → (module, function) of the head's hand-written
  kernels, each function's ``launches`` counting its calls;
- ``NAME_KEYS``: ((wrapper, (substring, ...)), ...), the device kernel
  names of each wrapper, tried before the trunk's;
- ``step_calls(cfg, stats, slots)``: (the forward's calls, the backward's),
  each a list of (wrapper, bound seconds) over the samples ``stats`` of
  ``slots`` point slots a cloud (``kernels.step_calls`` runs the forward's
  twice under remat).
"""

from pathlib import Path

from portbench.lib.heads import find, names

SEARCH = [Path(__file__).resolve().parent]


def of(cfg):
    """The counts of the configuration's head."""
    return find(SEARCH, cfg["decoder_option"], "counts")


def every():
    """The counts of every head on ``SEARCH``."""
    return [find(SEARCH, name, "counts") for name in names(SEARCH)]
