"""The SeFlow SSL train step of the port vs
``deflow_tpu.trainer.make_train_step(model, "seflowLoss")`` on the CPU in
f32 (B = 2, N = 512, 32x32 grid, 4 GRU iterations, DUFO labels), with the
same random weights carried across by ``convert.py``.  The JAX side's
chamfer runs its Pallas kernels in interpret mode; its model stays on XLA.

- the grid branch (``_AUTO_GRID_PAIRS`` lowered on both sides, so that
  512² pairs take it): the fused sweep with pc1's host cell prep, two
  sweeps and one lane segment-sum per step;
- the brute branch (the default rule at 512² pairs): four brute searches.

Tolerances are ``test_torch_train_step.py``'s f32 ones: loss, epe,
valid_points and grad_norm 1e-5 relative; each parameter's gradient within
1e-4 of its largest element (the conv biases before a train-mode BN, zero
in exact arithmetic, below 1e-4 of their weight's largest gradient);
parameters after one Adam step 1e-6 + lr·1e-2 (those biases 2·lr); BN
statistics 1e-5.  The host cell prep is exact.
"""

import copy

import numpy as np
import pytest

from deflow_tpu.data.host_prep import attach_host_prep as jax_attach
from deflow_tpu_torch.data.host_prep import CHAMFER_CELL_KEYS, attach_host_prep

from test_torch_host_prep import RANGE, make_host_batch
from test_torch_modules import VOXEL
from test_torch_ssl_kernels import interpret_pallas  # noqa: F401 (a fixture)
from test_torch_train_step import assert_step_matches_jax, run_steps
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def ssl_batch(seed, b=2, n=512):
    """The train-step fixture with pc1 near pc0 (so that the truncated
    chamfer has matches below 2 m) and ~30% DUFO-dynamic points."""
    hb = make_host_batch(seed, b, n, VOXEL)
    rng = np.random.default_rng(seed + 1)
    hb["pc1"] = (hb["pc0"] + rng.normal(0, 0.7, (b, n, 3))).astype(np.float32)
    hb["dufo_label0"] = (rng.random((b, n)) < 0.3).astype(np.int32)
    hb["dufo_label1"] = (rng.random((b, n)) < 0.3).astype(np.int32)
    return hb


def _count_calls(monkeypatch):
    """Count the port's calls of its three SSL kernel wrappers (on the CPU
    they take the plain versions, and their launch counters stay 0)."""
    from deflow_tpu_torch.ops import nn, scatter, sweep

    calls = {}
    for mod, name in ((sweep, "cell_sweep"), (scatter, "segment_sum_lanes"),
                      (nn, "chamfer_min")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


def test_host_cell_prep_matches_jax():
    hb = ssl_batch(3, b=3, n=700)
    want = jax_attach(copy.deepcopy(hb), list(VOXEL), RANGE, sort=True)
    got = attach_host_prep(copy.deepcopy(hb), list(VOXEL), RANGE)
    for k in CHAMFER_CELL_KEYS + ("pc1", "pc1_mask", "dufo_label0", "dufo_label1"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["pc1_cell_start"].shape == (3, 53 * 52 + 1)
    plain = attach_host_prep({k: v for k, v in copy.deepcopy(hb).items()
                              if k != "dufo_label1"}, list(VOXEL), RANGE)
    assert not set(CHAMFER_CELL_KEYS) & set(plain)


@pytest.mark.parametrize("branch", ["grid", "brute"])
def test_ssl_train_step_matches_jax(interpret_pallas, monkeypatch, branch):
    from deflow_tpu_torch.ops import chamfer as TC

    if branch == "grid":
        monkeypatch.setattr(interpret_pallas, "_AUTO_GRID_PAIRS", 0)
        monkeypatch.setattr(TC, "_AUTO_GRID_PAIRS", 0)
    calls = _count_calls(monkeypatch)
    assert_step_matches_jax(*run_steps(ssl_batch(31), "seflowLoss"))
    want = ({"cell_sweep": 2, "segment_sum_lanes": 1} if branch == "grid"
            else {"chamfer_min": 4})
    assert calls == want
