"""The whole eval step, port vs JAX, on the CPU in f32.

Same random weights and BN statistics, same host batch (B=2, N=512, 32x32
grid, num_iters 4).  ``pred_flow`` is held to 2e-4 abs, the bound
``tests/test_parity.py`` holds the torch twin to; the validity masks must be
identical.  The port's ``run_validation`` (its form over prepped batches)
must give the same 3-way and bucketed tables as the JAX package's
``ThreewayEPE`` and ``BucketedEPE`` on the same outputs.
"""

import numpy as np
import torch

import jax.numpy as jnp

from deflow_tpu import trainer as T
from deflow_tpu.metrics import BucketedEPE as JaxBucketedEPE
from deflow_tpu.metrics import ThreewayEPE as JaxThreewayEPE
from deflow_tpu_torch.entry.evaluate import run_validation
from deflow_tpu_torch.metrics import ThreewayEPE
from deflow_tpu_torch.trainer import make_eval_step

from test_torch_modules import make_pair
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def test_eval_step_matches_jax():
    jm, variables, port, jb, tb = make_pair(seed=11)
    want = T.make_eval_step(jm)(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in jb.items()})
    step = make_eval_step(port, device="cpu")
    got = step(tb)

    np.testing.assert_array_equal(got["pc0_valid"].numpy(),
                                  np.asarray(want["pc0_valid"]))
    valid = got["pc0_valid"].numpy()
    assert valid.any() and not valid.all()
    for k in ("pred_flow", "net_flow", "pose_flow"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (2, 512, 3) and np.isfinite(g).all()
        err = np.abs(g - w).max()
        assert err < 2e-4, f"{k}: max |Δ| = {err}"

    three = ThreewayEPE()
    metrics = run_validation(step, [tb], three=three)
    ref, ref_bucketed = JaxThreewayEPE(), JaxBucketedEPE()
    pred, pose_flow = got["pred_flow"].numpy(), got["pose_flow"].numpy()
    for b in range(2):
        for acc in (ref, ref_bucketed):
            acc.update(pred[b], tb["flow"][b], tb["flow_category_indices"][b],
                       pose_flow[b], tb["pc0_mask"][b] & tb["flow_is_valid"][b])
    want_metrics = dict(ref.compute(), **ref_bucketed.compute())
    assert metrics.keys() == want_metrics.keys()
    np.testing.assert_allclose([metrics[k] for k in sorted(metrics)],
                               [want_metrics[k] for k in sorted(metrics)],
                               rtol=1e-12, equal_nan=True)
    assert three.point_counts == ref.point_counts
    assert torch.isfinite(torch.tensor(metrics["EPE_3way_mean"]))
