"""Heads are plug-ins of the yardstick, found by ``model.decoder_option``: a
head that exists only in this test runs through the weights' spec and
draw, the reference's steps, the FLOPs and the kernel bounds as two files
alone; a head with no file stops with the file's name; and the draw of
the benchmark's own specs is frozen bit for bit."""

import hashlib
import importlib
import json
import math
from pathlib import Path

import pytest
import torch

from conftest import TINY_MODEL
from portbench.counts import flops, kernels
from portbench.counts import heads as count_heads
from portbench.counts.samples import sample_stats
from portbench.drivers.train import RAW_KEYS, raw_batch
from portbench.reference import heads as ref_heads
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.reference.weights import make_weights
from portbench.traffic.generator import make_pool

HERE = Path(__file__).resolve().parents[1]
TRAFFIC = {"samples": 4, "slots": 2048, "valid": [1500, 1900]}

# one post-norm self-attention layer over 16-point chunks: a packed
# in-projection, a LayerNorm, and a dropout mask of the attention weights
# drawn from the step over the whole batch
REFERENCE = '''
import torch
import torch.nn.functional as F

from portbench.reference.model import linear, operand, output
from portbench.reference.weights import Leaf, dense

BLOCK = None
D, CHUNK = 128, 16
SEEN = []


def param_spec(cfg):
    spec = {}
    dense(spec, "head.offset_encoder", (D, 3))
    packed = "head.attn.in_proj_weight"
    spec[packed] = Leaf((3 * D, D), "dense", fan_in=packed)
    spec["head.attn.in_proj_bias"] = Leaf((3 * D,), "dense", fan_in=packed)
    dense(spec, "head.attn.out_proj", (D, D))
    spec["head.norm.weight"] = Leaf((D,), "layer_norm", draw=(0.9, 1.1), trains=True)
    spec["head.norm.bias"] = Leaf((D,), "layer_norm", draw=(-0.1, 0.1), trains=True)
    dense(spec, "head.decoder.0", (32, D))
    dense(spec, "head.decoder.2", (3, 32))
    return spec


def forward(feats, flat, offsets, valid, W, cfg, quant, step):
    SEEN.append(feats.shape[0])
    b, n, _ = feats.shape
    x = feats + linear(offsets, W, "head.offset_encoder", quant)
    qkv = output(quant, operand(quant, x) @ operand(quant, W["head.attn.in_proj_weight"]).t())
    qkv = qkv + W["head.attn.in_proj_bias"]
    q, k, v = (t.reshape(-1, CHUNK, D) for t in qkv.split(D, -1))
    keys = torch.where(valid.reshape(-1, 1, CHUNK), 0.0, -1e9)
    att = torch.softmax(q @ k.transpose(1, 2) / D ** 0.5 + keys, -1)
    gen = torch.Generator(device=feats.device).manual_seed(int(step))
    keep = torch.rand((CHUNK, CHUNK), generator=gen, device=feats.device) >= 0.1
    y = linear((att * keep / 0.9 @ v).reshape(b, n, D), W, "head.attn.out_proj", quant)
    x = F.layer_norm(x + y, (D,), W["head.norm.weight"], W["head.norm.bias"])
    flow = linear(F.gelu(linear(x, W, "head.decoder.0", quant)), W, "head.decoder.2", quant)
    return torch.where(valid[..., None], flow, 0.0)
'''

COUNTS = '''
from portbench.counts.kernels import bound_s

D, CHUNK = 128, 16
WRAPPERS = {"chunk_attention": ("no_such_program.ops.attention", "chunk_attention")}
NAME_KEYS = (("chunk_attention", ("chunk_attn",)),)


def forward_flops(cfg, stats):
    chunks = sum(-(-s["valid0"] // CHUNK) for s in stats)
    per_point = 3 * 128 + 3 * D * D + D * D + D * 32 + 32 * 3
    return 2.0 * chunks * CHUNK * (per_point + 2 * CHUNK * D)


def step_calls(cfg, stats, slots):
    n = len(stats) * slots
    one = bound_s(2 * n * 4 * D, 4.0 * n * CHUNK * D)
    return [("chunk_attention", one)], [("chunk_attention", 2 * one)]
'''


@pytest.fixture
def test_head(tmp_path, monkeypatch):
    """The configuration of a DeFlow whose head is ``attn_test``, whose two
    files lie first on the heads' search paths."""
    for part, text, pkg in (("reference", REFERENCE, ref_heads),
                            ("counts", COUNTS, count_heads)):
        (tmp_path / part).mkdir()
        (tmp_path / part / "attn_test.py").write_text(text)
        monkeypatch.setattr(pkg, "SEARCH", [tmp_path / part, *pkg.SEARCH])
    cfg = json.loads((HERE / "configs" / "deflow.json").read_text())
    cfg["model"].update(TINY_MODEL, decoder_option="attn_test")
    return cfg


def test_a_head_of_its_own_files_draws_and_trains(test_head):
    model_cfg, train_cfg = test_head["model"], test_head["train"]
    spec = ref_model.param_spec(model_cfg)
    trunk = ref_model.param_spec({**model_cfg, "decoder_option": "linear"})
    head_leaves = [k for k in spec if k.startswith("head.")]
    assert list(spec)[:len(spec) - len(head_leaves)] == [k for k in trunk if not k.startswith("head.")]
    w = make_weights(spec, 2 ** 31 + 3, "cpu")
    bound = 1 / math.sqrt(128)
    assert float(w["head.attn.in_proj_bias"].abs().max()) <= bound
    assert float(w["head.attn.in_proj_bias"].abs().max()) > 0.9 * bound
    assert 0.9 <= float(w["head.norm.weight"].min()) <= float(w["head.norm.weight"].max()) <= 1.1

    pool = make_pool(TRAFFIC, 2 ** 31 + 3)
    batch = raw_batch(pool, [0, 1], "cpu", RAW_KEYS)
    got = ref_train.follow(model_cfg, train_cfg["loss_fn"], train_cfg["lr"], 2 ** 31 + 3,
                           [batch], "cpu")
    assert len(got["loss"]) == 1 and math.isfinite(got["loss"][0])
    for leaf in ("head.attn.in_proj_weight", "head.attn.in_proj_bias", "head.norm.weight",
                 "head.norm.bias"):
        assert got["grad_norm"][leaf] > 0 and got["change_norm"][leaf] > 0, leaf

    head = ref_heads.of(model_cfg)
    head.SEEN.clear()
    flows = [ref_model.forward(w, batch, model_cfg, step=s)["flow"] for s in (0, 0, 1)]
    assert head.SEEN == [2, 2, 2]                    # BLOCK None: the whole batch at once
    assert torch.equal(flows[0], flows[1]) and not torch.equal(flows[0], flows[2])


def test_a_head_of_its_own_files_counts(test_head):
    cfg = test_head["model"]
    stats = [sample_stats(s, cfg) for s in make_pool(TRAFFIC, 2 ** 31 + 4)]
    head = count_heads.of(cfg)
    v0, v1 = (sum(s[k] for s in stats) for k in ("valid0", "valid1"))
    trunk = len(stats) * flops.unet_flops(cfg) + 2.0 * 9 * 32 * (v0 + v1)
    assert flops.batch_flops(cfg, "train", stats) == 3.0 * (trunk + head.forward_flops(cfg, stats))
    assert flops.batch_flops(cfg, "eval", stats) == trunk + head.forward_flops(cfg, stats)

    assert kernels.wrappers(cfg) == {**kernels.WRAPPERS, **head.WRAPPERS}
    calls = kernels.bound_by_wrapper(kernels.step_calls(cfg, "train", True, stats, 2048))
    assert {k: v[0] for k, v in calls.items()} == {
        "segment_sum": 5, "sorted_gather": 4, "chunk_attention": 3}
    fwd, bwd = head.step_calls(cfg, stats, 2048)
    assert calls["chunk_attention"][1] == pytest.approx(2 * fwd[0][1] + bwd[0][1])
    assert kernels.kernel_of("chunk_attn_fwd<bf16>", cfg) == "chunk_attention"
    assert kernels.kernel_of("segment_sum_kernel<__nv_bfloat16>", cfg) == "segment_sum"
    assert kernels.kernel_of("gru_fwd_kernel", cfg) is None

    from portbench.lib import readers

    ctx = {"mode": "train", "cfg": {"model": cfg, "remat": True}, "sample_stats": stats,
           "timed_s": 2.0, "timed_batches": [[0, 1], [2, 3]],
           "workload": {"traffic": TRAFFIC},
           "traced": {"batches": [[0, 1, 2, 3]], "calls": {"segment_sum": 5, "chunk_attention": 3},
                      "trace": {"by_kernel": {"segment_sum": 1e-3, "chunk_attention": 4e-3}}}}
    steps = [flops.batch_flops(cfg, "train", [stats[i] for i in ids]) for ids in ([0, 1], [2, 3])]
    assert readers.mfu(ctx) == pytest.approx(100 * sum(steps) / 2.0 / 989e12)
    want = (calls["segment_sum"][1] + calls["chunk_attention"][1]) / 5e-3
    assert readers.kernel_roofline(ctx) == pytest.approx(100 * want)


@pytest.mark.parametrize("call", [
    lambda cfg: ref_model.param_spec(cfg),
    lambda cfg: flops.batch_flops(cfg, "train", []),
    lambda cfg: kernels.step_calls(cfg, "train", True, [], 2048),
], ids=["reference", "flops", "kernels"])
def test_a_head_with_no_file_names_the_file(call):
    cfg = {**json.loads((HERE / "configs" / "deflow.json").read_text())["model"],
           "decoder_option": "no_such_head"}
    with pytest.raises(FileNotFoundError, match=r"no_such_head\.py"):
        call(cfg)


def test_every_head_has_its_reference_and_its_counts():
    from portbench.lib.heads import names

    assert names(ref_heads.SEARCH) == names(count_heads.SEARCH) == ["gru", "linear"]


@pytest.mark.parametrize("name", ["gru", "linear"])
def test_every_wrapper_of_a_head_has_its_counter(name):
    for wrapper, (mod, fn) in count_heads.of({"decoder_option": name}).WRAPPERS.items():
        assert isinstance(getattr(importlib.import_module(mod), fn).launches, int), wrapper


@pytest.mark.parametrize("config", ["deflow", "fastflow3d"])
def test_a_per_point_head_counts_the_same_from_sums(config):
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())["model"]
    stats = [sample_stats(s, cfg) for s in make_pool({**TRAFFIC, "samples": 3}, 8)]
    v0, v1 = (sum(s[k] for s in stats) for k in ("valid0", "valid1"))
    for mode in ("train", "eval"):
        assert flops.batch_flops(cfg, mode, stats) == flops.step_flops(cfg, mode, 3, v0, v1)


# sha256 of each leaf's name and little-endian f32 bytes, in the spec's
# order, drawn on the CPU from seed 2**31 + 77 at the published sizes
FROZEN = {"deflow": "c2e65fbd64579ff3def46a742e8cbb8ac3eed283bfb613e17dffb40865c152d9",
          "fastflow3d": "2ce74c2c739e4a96c8dd02bc0f87fc1b672b9fc1582792dfe2499d7c59bbe527"}


@pytest.mark.parametrize("config", sorted(FROZEN))
def test_the_draw_of_each_spec_is_frozen(config):
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())["model"]
    h = hashlib.sha256()
    for name, t in make_weights(ref_model.param_spec(cfg), 2 ** 31 + 77, "cpu").items():
        h.update(name.encode())
        h.update(t.numpy().astype("<f4").tobytes())
    assert h.hexdigest() == FROZEN[config]
