"""The plain reference held to the program's CPU path in f32, at a tiny size:
the same weights (``make_weights``) and the same raw frame pairs, through
the program's own loader prep and train step on one side and the
reference on the other."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import TINY_MODEL
from portbench.drivers.train import RAW_KEYS, raw_batch
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.reference.losses import loss_of
from portbench.reference.weights import make_weights
from portbench.traffic.generator import make_pool

HERE = Path(__file__).resolve().parents[1]
TRAFFIC = {"samples": 4, "slots": 2048, "valid": [1500, 1900]}
CASES = [("deflow", "deflowLoss"), ("deflow", "ff3dLoss"), ("deflow", "seflowLoss"),
         ("fastflow3d", "ff3dLoss"), ("fastflow3d", "deflowLoss")]


def _config(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["model"].update(TINY_MODEL)
    return cfg


def _port_step(model_cfg, loss, weights, host):
    from deflow_tpu_torch.data.h5dataset import collate
    from deflow_tpu_torch.entry.evaluate import _sorted_prep
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import (SSL_TRAIN_KEYS, TRAIN_KEYS, _model_inputs,
                                          device_batch, init_train_state, make_train_step)

    cfg = {"lr": 2e-4, "voxel_size": model_cfg["voxel_size"],
           "point_cloud_range": model_cfg["point_cloud_range"], "num_workers": 0}
    model = build_model(model_cfg, precision="fp32", device="cpu")
    model.load_state_dict(weights, strict=False)
    batch = _sorted_prep(cfg)(collate(host))
    b = device_batch(batch, "cpu", SSL_TRAIN_KEYS if loss == "seflowLoss" else TRAIN_KEYS)
    with torch.no_grad():
        model.train()
        out = model(b["pc0"], b["pc1"], b["pose0"], b["pose1"], b["pc0_mask"],
                    b["pc1_mask"], **_model_inputs(model, b))
    model.load_state_dict(weights, strict=False)
    state = init_train_state(model, cfg, "cpu")
    _, aux = make_train_step(model, loss, "cpu")(state, b)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    unsort = torch.from_numpy(batch["pc0_unsort"]).long()
    flow = torch.gather(out["flow"], 1, unsort[..., None].expand(-1, -1, 3))
    return float(aux["loss"]), grads, flow


@pytest.mark.parametrize("config,loss", CASES)
def test_one_step_matches_the_port(config, loss):
    """Forward flow, loss and every parameter's gradient of one f32 train
    step (a gradient to 1e-4 of its leaf's largest element, or of the
    median leaf's where that is larger: a conv bias before a train-mode
    BatchNorm has a zero gradient but for rounding)."""
    model_cfg = _config(config)["model"]
    pool = make_pool({**TRAFFIC, "dufo_share": 0.15}, 5)
    spec = ref_model.param_spec(model_cfg)
    weights = make_weights(spec, 5, "cpu")
    port_loss, port_grads, port_flow = _port_step(model_cfg, loss, weights, pool[:2])

    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()
              if spec[k][1] in ref_train.PARAM_KINDS}
    batch = raw_batch(pool, [0, 1], "cpu", RAW_KEYS)
    out = ref_model.forward(params, batch, model_cfg)
    ref_loss = loss_of(loss, out, batch)
    ref_loss.backward()

    assert set(port_grads) == set(params)
    ref_loss_value = float(ref_loss.detach())
    assert abs(port_loss - ref_loss_value) <= 1e-5 * abs(ref_loss_value)
    np.testing.assert_allclose(port_flow.numpy(), out["flow"].detach().numpy(),
                               atol=1e-5, rtol=1e-4)
    scale = {k: float(p.grad.abs().max()) for k, p in params.items()}
    floor = float(np.median(list(scale.values())))
    for k, p in params.items():
        tol = 1e-4 * max(scale[k], floor)
        assert float((port_grads[k] - p.grad).abs().max()) <= tol, k


@pytest.mark.parametrize("config", ["deflow", "fastflow3d"])
def test_three_steps_of_the_harness_match(config):
    """The numbers a run compares, f32 program against the reference over
    the window's first three Adam steps after a warm-up and the restart to
    the seed's weights: all far under any limit."""
    from portbench.drivers.train import TrainRun
    from portbench.lib.common import Spans
    from portbench.run import load_cell

    _, _, _, workload = load_cell("deflow.train-b16", {"traffic": TRAFFIC})
    cfg = _config(config)
    cfg["train"].update({"batch_size": 2, "num_workers": 0, "precision": "fp32"})
    r = TrainRun(cfg, workload, 9, torch.device("cpu"), Spans())
    r.setup_steps(2)
    r.restart()
    win = r.window(0.0)
    r.close()
    assert win["steps"] == 3 and r.checked_batches == win["timed_batches"]
    numbers = r.check()[None]
    assert max(numbers.values()) < 1e-4, numbers


def test_quantisers_round_as_named():
    x = torch.linspace(-3, 3, 1001, requires_grad=True)
    f = ref_model.Fp8.operand(x)
    assert len(torch.unique(f)) <= 256
    # half of e4m3's top spacing (32 at a scale of 3/448)
    assert float((f - x).abs().max()) <= 3 / 448 * 16 * (1 + 1e-5)
    g = torch.linspace(-1, 1, 1001)
    ref_model.Fp8.output(x * 1.0).backward(g)
    assert len(torch.unique(x.grad)) < 200          # e5m2: 2 mantissa bits
    assert float((x.grad - g).abs().max()) <= 0.13
