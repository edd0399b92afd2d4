"""The train-mode U-Net against the JAX package on the CPU in f32:
``DEFLOW_REMAT`` (per-block remat of the encoder's ``ConvWithNorms``), and
siamese batch 2B > 4, where the JAX package's ``auto`` chains no group and
the port's chains the 256 and 128 groups in bf16 only.
The helpers, the fixture and the tolerances are ``test_torch_unet_policy.py``'s;
remat against no remat on the port is bit for bit (the recompute is the same
CPU arithmetic).
"""

import jax
import numpy as np
import pytest
import torch

from deflow_tpu_torch.models import unet as TU

from test_torch_unet_policy import (HW, _hold, _jax_grad_fn, _jax_step, _jax_variables,
                                    _port_chain_spy, _port_step, _stub_chain,
                                    interpret_cbg)  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def test_unet_train_at_2b_above_4_matches_jax(interpret_cbg, monkeypatch):
    """2B = 8.  Under ``all`` the port and the JAX U-Net chain all three
    groups (traced only on the JAX side).  Under ``auto`` the JAX U-Net
    chains no group (the TPU's 2B <= 4) and runs the ``CBGBlock`` fallback
    (the variance not clipped); the port keeps the card's rule: in f32, as
    here, no group chains, in bf16 the 256 and 128 groups do.  The port's
    output, BN statistics and gradients hold to the JAX fallback both
    unchained and with the 256 and 128 groups chained (``256,128``, the
    groups bf16's ``auto`` chains at this batch)."""
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
    monkeypatch.setenv("DEFLOW_FUSED_CBG", "256,128")
    got = _port_step(variables, b)
    assert port_calls == [("256", 3, True), ("128", 3, True)]
    _hold(got, want)
    monkeypatch.setenv("DEFLOW_FUSED_CBG", "auto")
    routed = _stub_chain(monkeypatch)
    with torch.no_grad():
        TU.FastFlow3DUNet(stem_cin=32).train()._encode(
            torch.zeros(2 * b, 32, HW, HW, dtype=torch.bfloat16), torch.bfloat16)
    assert routed == ["256", "128"]


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
