"""The train-mode U-Net against the JAX package on the CPU in f32 at siamese
batch 2B > 4, where the JAX package's ``auto`` chains no group and the
port chains the 256 and 128 groups in bf16 only.  Remat is the train
step's and is held in ``test_torch_train_entry_remat.py``.
The helpers, the fixture and the tolerances are ``test_torch_unet_policy.py``'s.
"""

import jax
import torch

from deflow_tpu_torch.models import unet as TU

from test_torch_unet_policy import (HW, _hold, _jax_grad_fn, _jax_step, _jax_variables,
                                    _port_chain_spy, _port_step, _stub_chain,
                                    interpret_cbg)  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def test_unet_train_at_2b_above_4_matches_jax(interpret_cbg, monkeypatch):
    """2B = 8.  With every group chained at every batch (the JAX package's
    ``all``; the port's constant and batch rule substituted) the port and
    the JAX U-Net chain all three groups (traced only on the JAX side).
    Under ``auto`` the JAX U-Net chains no group (the TPU's 2B <= 4) and
    runs the ``CBGBlock`` fallback (the variance not clipped); the port
    keeps the card's rule: in f32, as here, no group chains and each runs
    its modules, in bf16 the 256 and 128 groups chain.  The port's output,
    BN statistics and gradients hold to the JAX fallback both unchained
    and with the 256 and 128 groups chained (the groups bf16 chains at
    this batch)."""
    b = 4
    variables = _jax_variables(b)
    chained, chain_at_batch = TU._CHAINED_GROUPS, TU._chain_at_batch

    def route(groups, rule):
        monkeypatch.setattr(TU, "_CHAINED_GROUPS", groups)
        monkeypatch.setattr(TU, "_chain_at_batch", rule)

    monkeypatch.setenv("DEFLOW_FUSED_CBG", "all")
    route(("256", "128", "64"), lambda rows2b, dtype: True)
    port_calls = _port_chain_spy(monkeypatch)
    jax.eval_shape(_jax_grad_fn(variables, b), variables["params"])
    _port_step(variables, b)
    assert port_calls == interpret_cbg and len(port_calls) == 3
    del port_calls[:], interpret_cbg[:]
    monkeypatch.setenv("DEFLOW_FUSED_CBG", "auto")
    route(chained, chain_at_batch)
    want = _jax_step(variables, b)
    got = _port_step(variables, b)
    assert port_calls == interpret_cbg == []
    _hold(got, want)
    route(chained, lambda rows2b, dtype: True)
    got = _port_step(variables, b)
    assert port_calls == [("256", 3, True), ("128", 3, True)]
    _hold(got, want)
    route(chained, chain_at_batch)
    routed = _stub_chain(monkeypatch)
    with torch.no_grad():
        TU.FastFlow3DUNet(stem_cin=32).train()._encode(
            torch.zeros(2 * b, 32, HW, HW, dtype=torch.bfloat16), torch.bfloat16)
    assert routed == ["256", "128"]
