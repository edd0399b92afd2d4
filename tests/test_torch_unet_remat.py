"""The train-mode U-Net against the JAX package on the CPU in f32:
``DEFLOW_REMAT`` (per-block remat of the encoder's ``ConvWithNorms``), and
the plain path at siamese batch 2B > 4, where ``auto`` chains no group.
The helpers, the fixture and the tolerances are ``test_torch_unet_policy.py``'s;
remat against no remat on the port is bit for bit (the recompute is the same
CPU arithmetic).
"""

import jax
import numpy as np
import pytest
import torch

from deflow_tpu_torch.models import unet as TU

from test_torch_unet_policy import (_hold, _jax_grad_fn, _jax_step, _jax_variables,
                                    _port_chain_spy, _port_step,
                                    interpret_cbg)  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def test_unet_train_at_2b_above_4_matches_jax(interpret_cbg, monkeypatch):
    """2B = 8 under ``auto``: no group chains, and the chain-capable 256 and
    128 groups run the JAX package's ``CBGBlock`` fallback (the variance not
    clipped).  Output, BN statistics and gradients against the JAX U-Net's
    plain path; under ``all`` both chain all three groups at that batch
    (traced only on the JAX side)."""
    b = 4
    variables = _jax_variables(b)
    monkeypatch.setenv("DEFLOW_FUSED_CBG", "all")
    port_calls = _port_chain_spy(monkeypatch)
    jax.eval_shape(_jax_grad_fn(variables, b), variables["params"])
    _port_step(variables, b)
    assert port_calls == interpret_cbg and len(port_calls) == 3
    del port_calls[:], interpret_cbg[:]
    monkeypatch.setenv("DEFLOW_FUSED_CBG", "auto")
    want = _jax_step(variables, b)
    got = _port_step(variables, b)
    assert port_calls == interpret_cbg == []
    _hold(got, want)


@pytest.mark.parametrize("mode", ["1", "conv"])
def test_remat_matches_plain_and_jax(interpret_cbg, monkeypatch, mode):
    """``DEFLOW_REMAT``: the port's gradients equal its own step without
    remat bit for bit, the BN running statistics move once, and both hold
    to the JAX U-Net under the same ``DEFLOW_REMAT`` (``DEFLOW_FUSED_CBG=0``,
    so every encoder block is a remat-wrapped ``ConvWithNorms``)."""
    monkeypatch.setenv("DEFLOW_FUSED_CBG", "0")
    variables = _jax_variables(1)
    monkeypatch.setenv("DEFLOW_REMAT", "0")
    plain = _port_step(variables, 1)
    monkeypatch.setenv("DEFLOW_REMAT", mode)
    recomputed = []
    norm_act = TU.ConvWithNorms.norm_act
    monkeypatch.setattr(TU.ConvWithNorms, "norm_act",
                        lambda self, y, twin=False: (recomputed.append(self),
                                                     norm_act(self, y, twin))[1])
    got = _port_step(variables, 1)
    # ten encoder blocks, each normalised twice: in the forward and again
    # in the backward's recompute
    assert len(recomputed) == 20
    np.testing.assert_array_equal(got[0], plain[0])
    for key in plain[1]:
        assert torch.equal(got[1][key], plain[1][key]), key
    for key in plain[2]:
        assert torch.equal(got[2][key], plain[2][key]), key
    _hold(got, _jax_step(variables, 1))
