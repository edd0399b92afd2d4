"""The port's numpy host prep vs ``deflow_tpu.data.host_prep`` (sort=True)."""

import copy

import numpy as np
import pytest

from deflow_tpu.data.host_prep import attach_host_prep as jax_attach
from deflow_tpu_torch.data.host_prep import attach_host_prep
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

RANGE = [-51.2, -51.2, -3.0, 51.2, 51.2, 3.0]


def make_host_batch(seed, b, n, voxel):
    """Ragged clouds with padding, out-of-range points and a moving ego."""
    rng = np.random.default_rng(seed)

    def cloud():
        return np.stack([rng.uniform(-56, 56, (b, n)), rng.uniform(-56, 56, (b, n)),
                         rng.uniform(-3.5, 3.5, (b, n))], -1).astype(np.float32)

    mask = rng.random((b, n)) < 0.85
    pose0 = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose1 = pose0.copy()
    for i in range(b):
        a = rng.uniform(-0.1, 0.1)
        pose0[i, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        pose0[i, :3, 3] = rng.uniform(-2, 2, 3)
        pose1[i, :3, 3] = rng.uniform(-2, 2, 3)
    return {
        "pc0": cloud(), "pc1": cloud(), "pose0": pose0, "pose1": pose1,
        "pc0_mask": mask, "pc1_mask": rng.random((b, n)) < 0.85,
        "flow": rng.normal(0, 0.5, (b, n, 3)).astype(np.float32),
        "flow_is_valid": rng.random((b, n)) < 0.95,
        "flow_category_indices": rng.integers(0, 30, (b, n)).astype(np.int32),
    }


@pytest.mark.parametrize("voxel", [(3.2, 3.2, 6.0), (3.3, 3.2, 6.0)],
                         ids=["s2d", "row_major"])
def test_host_prep_matches_jax(voxel):
    hb = make_host_batch(0, 3, 700, voxel)
    want = jax_attach(copy.deepcopy(hb), list(voxel), RANGE, sort=True)
    got = attach_host_prep(copy.deepcopy(hb), list(voxel), RANGE)

    for k in ("pc0_ids", "pc0_sorted", "pc1_ids", "pc1_sorted",
              "pc0_unsort", "pc1_unsort", "pc0_mask", "pc1_mask",
              "flow_is_valid", "flow_category_indices", "pc0", "pc1", "flow"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("pc0_transformed", "pc0_sorted_rec", "pc1_sorted_rec"):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert not {"pc0_order", "pc0_iperm", "pc1_order", "pc1_iperm"} & set(got)
    # the fixture reaches the trash id, and unsort restores dataset order
    trash = round(102.4 / voxel[0]) * round(102.4 / voxel[1])
    assert (got["pc0_ids"] == trash).any() and (got["pc0_ids"] < trash).any()
    np.testing.assert_array_equal(got["pc0"][0][got["pc0_unsort"][0]],
                                  hb["pc0"][0])
