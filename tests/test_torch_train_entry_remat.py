"""Remat in the port's train step (``make_train_step(..., remat=True)``)
on the CPU in f32: against ``deflow_tpu.trainer.make_train_step(...,
remat=True)``, and against the port's own step without remat.

Shapes are those of ``tests/test_torch_train_step.py`` (B = 2, N = 512,
32² grid, 4 GRU iterations).  Torch runs on one thread
(``torch_threads.one_torch_thread``).

Tolerances, each with its reason:
- the remat step against the JAX remat step: the f32 tolerances of
  ``test_torch_train_step.py`` (loss and aux 1e-5 relative; gradients 1e-4
  of each parameter's largest element; parameters after one Adam step
  1e-6 + lr·1e-2, the zero-gradient conv biases before a train-mode BN
  2·lr; BN statistics 1e-5);
- the remat step against the plain step: bit for bit (the same operations
  in the same order on the CPU).
"""

import pytest
import torch

from deflow_tpu_torch import trainer as TT
from deflow_tpu_torch.data.host_prep import attach_host_prep
from deflow_tpu_torch.models import unet

from test_torch_host_prep import RANGE, make_host_batch
from test_torch_modules import VOXEL
from test_torch_ssl_kernels import interpret_pallas  # noqa: F401 (a fixture)
from test_torch_ssl_step import ssl_batch
from test_torch_train_entry import _same_state, _small_state
from test_torch_train_step import assert_step_matches_jax, run_steps
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("loss_name", ["deflowLoss", "seflowLoss"])
def test_remat_step_matches_jax(request, loss_name):
    hb = make_host_batch(21, 2, 512, VOXEL)
    if loss_name == "seflowLoss":
        request.getfixturevalue("interpret_pallas")
        hb = ssl_batch(31)
    assert_step_matches_jax(*run_steps(hb, loss_name, remat=True))


def _count_wrappers(monkeypatch):
    """Count the calls of every kernel wrapper (on the CPU each takes its
    plain version, and the launch counters stay 0)."""
    from deflow_tpu_torch.ops import cbg, gather, gru, nn, scatter, sweep

    calls = {}
    for mod, name in ((scatter, "sorted_segment_sum"), (gather, "sorted_rows_gather"),
                      (gru, "fused_gru"), (gru, "fused_gru_bwd"),
                      (cbg, "cbg_block_fwd"), (cbg, "cbg_block_bwd"),
                      (scatter, "segment_sum_lanes"), (sweep, "cell_sweep"),
                      (nn, "chamfer_min")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


# wrapper calls per step, plain and remat.  Forward: two segment-sums (the
# embedder, pc0 and pc1), one gather, one GRU, and, unless the plain U-Net
# is selected, two chains of three fused blocks.  Backward: each segment-sum's is a gather, the
# gather's a segment-sum; the GRU backward, three fused-block backwards a
# chain.  Remat runs every forward call a second time in the backward.
PER_STEP = {"sorted_segment_sum": (3, 5), "sorted_rows_gather": (3, 4),
            "fused_gru": (1, 2), "fused_gru_bwd": (1, 1),
            "cbg_block_fwd": (6, 12), "cbg_block_bwd": (6, 6)}


@pytest.mark.parametrize("loss_name,b,chains", [("deflowLoss", 2, True),
                                                ("deflowLoss", 3, False),
                                                ("seflowLoss", 2, True)],
                         ids=["chains", "plain_unet", "seflow"])
def test_remat_step_equals_plain_bit_for_bit(monkeypatch, loss_name, b, chains):
    """Two steps from the same state with and without remat: the loss, aux,
    every gradient, every parameter after Adam, the Adam state, every BN
    running statistic and ``num_batches_tracked`` are identical (a second
    momentum update in the recompute would move the statistics).
    ``plain_unet`` chains no encoder group (the U-Net's chained groups
    substituted by none), so that remat is held bit for bit on the path
    without chains too."""
    if not chains:
        monkeypatch.setattr(unet, "_CHAINED_GROUPS", ())
    calls = _count_wrappers(monkeypatch)
    batches = [(ssl_batch(40 + s, b=b) if loss_name == "seflowLoss"
                else make_host_batch(40 + s, b, 512, VOXEL)) for s in range(2)]
    batches = [attach_host_prep(hb, list(VOXEL), RANGE) for hb in batches]
    runs = []
    for remat in (False, True):
        state = _small_state(5)
        step = TT.make_train_step(state.model, loss_name, device="cpu", remat=remat)
        trace = []
        for hb in batches:
            calls.clear()
            state, aux = step(state, hb)
            trace.append((dict(aux), {k: p.grad.clone() for k, p in
                                      state.model.named_parameters()}, dict(calls)))
        runs.append((state, trace))
    (plain, t_plain), (remat, t_remat) = runs
    _same_state(plain, remat)
    for (aux_p, g_p, c_p), (aux_r, g_r, c_r) in zip(t_plain, t_remat):
        for k in aux_p:
            assert torch.equal(aux_p[k], aux_r[k]), k
        for k in g_p:
            assert torch.equal(g_p[k], g_r[k]), k
        for name, (n_plain, n_remat) in PER_STEP.items():
            if name.startswith("cbg") and not chains:
                n_plain = n_remat = 0
            assert c_p.get(name, 0) == n_plain, (name, c_p)
            assert c_r.get(name, 0) == n_remat, (name, c_r)
        ssl = {k: v for k, v in c_p.items() if k not in PER_STEP}
        assert ssl == {k: v for k, v in c_r.items() if k not in PER_STEP}
        assert bool(ssl) == (loss_name == "seflowLoss")
