"""The encoder stems' k8/s2/p3 convolution over the space-to-depth view
(``deflow_tpu_torch/ops/stem.py``) on the CPU: the plain s2d versions
against ``F.conv2d``, the U-Net's bf16 route through ``stem_conv`` against
its ``F.conv2d`` route, the wrappers' refusals, and the kernels' names
against the benchmark's kernel table.  The kernels themselves run in
``test_torch_cuda_kernels.py`` on the card.
"""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from deflow_tpu_torch.models import unet
from deflow_tpu_torch.ops import _build, stem

from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

# the three stems' channel plans: encoder_step_1, _5, _9
STEM_PLANS = [(32, 64), (64, 128), (128, 256)]


def _rel(a, ref):
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("c,o", STEM_PLANS)
def test_stem_plain_matches_conv2d(c, o):
    """f32: the s2d forward, input, weight and bias gradients of
    ``stem_conv`` within 1e-5 of the largest element of ``F.conv2d``'s
    (k = 8, s = 2, p = 3) on small even maps."""
    g = torch.Generator().manual_seed(c + o)
    x = torch.randn(2, 12, 10, c, generator=g, dtype=torch.float64).float()
    w = torch.randn(o, c, 8, 8, generator=g) * (64 * c) ** -0.5
    b = torch.randn(o, generator=g)
    dy = torch.randn(2, 6, 5, o, generator=g)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = stem.stem_conv(*leaves)
    y.backward(dy)
    ref_leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    rx, rw, rb = ref_leaves
    ref = F.conv2d(rx.permute(0, 3, 1, 2), rw, rb, stride=2, padding=3).permute(0, 2, 3, 1)
    ref.backward(dy)
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert _rel(y, ref) <= 1e-5
    for got, want in zip(leaves, ref_leaves):
        assert got.grad.dtype == torch.float32
        assert _rel(got.grad, want.grad) <= 1e-5


def test_s2d_weight_round_trip():
    w = torch.randn(64, 32, 8, 8)
    wp = stem.s2d_weight(w)
    assert wp.shape == (64, 128, 4, 4)
    # W'[o, (p, q, c), a, b] = W[o, c, 2a + p, 2b + q]
    assert wp[5, 1 * 64 + 0 * 32 + 7, 2, 3].item() == w[5, 7, 5, 6].item()
    assert torch.equal(stem.d2s_weight(wp), w)


def _conv2d_route(conv, x, dtype):
    """The U-Net's convolution route before the stem kernels."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    conv.stride, conv.padding)


def _unet_run(net, imgs, dtype):
    """{name: value}: the output, the two images' gradients and every
    parameter gradient but the convolutions' biases ahead of a BN (zero in
    exact arithmetic: rounding noise)."""
    net.zero_grad()
    ins = [t.clone().requires_grad_() for t in imgs]
    out = net(*ins, dtype)
    out.float().square().mean().backward()
    res = {"out": out.detach().float(), "d_img0": ins[0].grad, "d_img1": ins[1].grad}
    for name, p in net.named_parameters():
        if p.grad is not None and not (name.startswith("encoder") and name.endswith("conv.bias")):
            res[name] = p.grad.clone()
    return res


def test_unet_bf16_stems_take_stem_conv(monkeypatch):
    """bf16 training (the 256 and 128 groups chained, the 64 group's
    modules): every stem goes through ``stem_conv``; the output and the
    images' gradients hold to the ``F.conv2d`` route within 2^-6 of the
    largest element, and every parameter gradient is no farther from the
    f32 route than the ``F.conv2d`` route's, give or take 2^-6 (the two
    bf16 routes lie 2-5% from f32 on the encoder's weight gradients at this
    size, BN on small maps amplifying bf16's roundings).  In f32 no stem
    goes through ``stem_conv`` and the output and gradients are bit for bit
    the ``F.conv2d`` route's."""
    torch.manual_seed(0)
    net = unet.FastFlow3DUNet().train()
    g = torch.Generator().manual_seed(3)
    imgs = [torch.randn(1, 32, 32, 32, generator=g) for _ in range(2)]
    calls = []

    def spy(x, weight, bias):
        calls.append(tuple(x.shape))
        return stem.stem_conv(x, weight, bias)

    monkeypatch.setattr(unet, "stem_conv", spy)
    got = _unet_run(net, imgs, torch.bfloat16)
    assert calls == [(2, 32, 32, 32), (2, 16, 16, 64), (2, 8, 8, 128)]
    f32 = _unet_run(net, imgs, torch.float32)
    assert len(calls) == 3
    monkeypatch.setattr(unet, "_conv", _conv2d_route)
    want = _unet_run(net, imgs, torch.bfloat16)
    assert got.keys() == want.keys() == f32.keys()
    for name in ("out", "d_img0", "d_img1"):
        assert _rel(got[name], want[name]) <= 2 ** -6, name
    for name in got:
        assert _rel(got[name], f32[name]) <= _rel(want[name], f32[name]) + 2 ** -6, name
    for name, value in _unet_run(net, imgs, torch.float32).items():
        assert torch.equal(value, f32[name]), name


def test_stem_wrappers_refuse_bad_inputs():
    """Odd maps and non-contiguous NHWC input raise on any device."""
    x = torch.randn(1, 16, 16, 32)
    w, b = torch.randn(64, 32, 8, 8), torch.randn(64)
    with pytest.raises(ValueError, match="even"):
        stem.stem_conv(x[:, :15].contiguous(), w, b)
    with pytest.raises(ValueError, match="even"):
        stem.stem_dgrad(torch.randn(1, 8, 8, 64), w, 15, 16)
    with pytest.raises(ValueError, match="contiguous"):
        stem.stem_conv(x.permute(0, 2, 1, 3), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        stem.stem_wgrad(x, torch.randn(1, 8, 8, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="weight"):
        stem.stem_conv(x, w[:, :16], b)


def _kernel_names():
    src = (Path(_build.CSRC) / "stem.cu").read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)", src)


def test_stem_kernel_names_are_not_counted_as_other_kernels():
    """No device kernel of ``csrc/stem.cu`` is taken for another wrapper by
    the benchmark's name table (as written, and as the profiler shows a
    template instance), and the source is one of the built kernels."""
    from portbench.counts import kernels

    names = _kernel_names()
    assert sorted(names) == ["stem_conv_kernel", "stem_wgrad_kernel", "stem_wsum_kernel"]
    for name in names:
        for shown in (name, f"void (anonymous namespace)::{name}<true, 2, 2>"
                            "((anonymous namespace)::ConvArgs)"):
            assert kernels.kernel_of(shown) is None, shown
    assert "stem" in _build.KERNELS
