"""Exact nearest neighbours by brute force, in blocks: for each query
point the squared distance to its nearest candidate, with the gradient of
the matched pair (the reference chamfer extension's subgradient).

The search itself runs without gradient, in f64 (``torch.cdist`` by its
matrix product: |q|² + |c|² − 2q·c, whose cancellation at coordinates of
tens of metres stays near 1e-12 m² in f64); the matched distance is then
recomputed in f32 from the gathered neighbour, so autograd carries
``2(q − c*)`` to the query and, where the candidate needs a gradient, the
mirror term to the matched candidate.
"""

from __future__ import annotations

import torch


def nearest(q: torch.Tensor, qmask: torch.Tensor, c: torch.Tensor, cmask: torch.Tensor,
            block: int = 8192) -> torch.Tensor:
    """Squared distance [N] from each of ``q`` [N, 3] to its nearest point
    of ``c`` [M, 3] among ``cmask``; 0 where ``qmask`` is false, 3e38 where
    no candidate exists."""
    cand = c[cmask]
    out = torch.zeros(q.shape[0], dtype=q.dtype, device=q.device)
    if cand.shape[0] == 0:
        return torch.where(qmask, torch.full_like(out, 3e38), out)
    rows = torch.nonzero(qmask).flatten()
    idx = torch.empty_like(rows)
    with torch.no_grad():
        qd, cd = q.detach().double(), cand.detach().double()
        for s in range(0, rows.numel(), block):
            r = rows[s:s + block]
            d = torch.cdist(qd[r], cd, compute_mode="use_mm_for_euclid_dist")
            idx[s:s + block] = d.argmin(dim=1)
    matched = ((q[rows] - cand[idx]) ** 2).sum(-1)
    return out.index_put((rows,), matched)
