"""BatchNorm running statistics: the in-place momentum update, and a switch
that holds them still while remat recomputes a forward pass.

The port updates its BN running statistics inside the forward (the JAX
package returns them as a functional output).  Under
``torch.utils.checkpoint`` the forward runs a second time in the backward,
which would apply the momentum twice; ``trainer.make_train_step(remat=True)``
runs that recompute under :func:`frozen_running_stats`.  The switch is per
thread: the recompute runs on the thread of the autograd engine that enters
it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """Within this context (on this thread) :func:`update_running_` leaves
    the statistics as they are."""
    prev = getattr(_state, "frozen", False)
    _state.frozen = True
    try:
        yield
    finally:
        _state.frozen = prev


def update_running_(buf: torch.Tensor, batch: torch.Tensor, momentum: float) -> None:
    """``buf = (1 − momentum)·buf + momentum·batch`` in place, outside
    autograd; nothing under :func:`frozen_running_stats`."""
    if getattr(_state, "frozen", False):
        return
    with torch.no_grad():
        buf.mul_(1 - momentum).add_(momentum * batch)


def remat_contexts():
    """``context_fn`` of a remat checkpoint: the forward as it is, the
    recompute with the BN running statistics held still (they moved once,
    in the forward)."""
    return contextlib.nullcontext(), frozen_running_stats()
