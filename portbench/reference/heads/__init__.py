"""Each head's plain reference, one file a head: ``<decoder_option>.py`` in a
directory of ``SEARCH`` (``lib/heads.py``).  A head's file defines:

- ``BLOCK``: the samples ``model.forward`` hands it at a time, each block
  under checkpoint; None, the whole batch (a head whose dropout masks are
  drawn over the whole batch);
- ``param_spec(cfg)``: name → ``weights.Leaf`` of the head's leaves, drawn
  after the trunk's, in this order;
- ``forward(feats, flat, offsets, valid, W, cfg, quant, step)``: the flow
  [b, N, 3] of a block of ``b`` samples, in plain f32 torch (with
  ``model``'s product helpers, which round in ``quant``), from the pillar
  features gathered at each pc0 point ``feats`` [b, N, 128] (zero at
  invalid points), the flat pillar ids ``flat`` [b, N], the offsets from
  the pillar centre [b, N, 3], the valid mask [b, N], the weights ``W``,
  and the train step ``step`` (0, 1, 2 in ``train.follow``: the program's
  step count after the restart).
"""

from pathlib import Path

from portbench.lib.heads import find

SEARCH = [Path(__file__).resolve().parent]


def of(cfg):
    """The reference of the configuration's head."""
    return find(SEARCH, cfg["decoder_option"], "reference")
