"""FastFlow3D siamese U-Net in NCHW.

Counterpart of ``deflow_tpu/models/unet.py`` as the reference lineage writes
it: k8/s2/p3 stems, ``ConvWithNorms`` (conv + BN eps 1e-5 + exact-erf GELU,
BN skipped on a 1x1 map), ``UpsampleSkip`` with a 2x bilinear upsample
(align_corners=False) and a final 3x3 conv.  The JAX package's space-to-depth
rewrites are TPU layout tricks over the same parameters and are not ported.

Channel plan: enc 32 →(s2) 64 ×4 →(s2) 128 ×4 →(s2) 256 ×2, pair-concat
skips, dec 512→256, 256→128, 128→64, final 3x3 conv 64→64.

Compute dtype: convolutions run in ``dtype`` (weights cast per call); BN and
GELU of ``ConvWithNorms`` run in f32, as in the JAX package.

Training (``module.train()``): BN takes the batch statistics of the siamese
2B batch (under a process group: of every rank's, the global batch) with
flax ``BatchNorm`` semantics (fast variance E[x²] − E[x]²
clipped at 0; running ``ra = 0.9·ra + 0.1·batch`` with the BIASED variance).
The encoder has three groups, named by their map at the 512² grid: 256
(``encoder_step_1`` stem + three 3x3 blocks, 64 channels), 128 (step 5 +
three blocks, 128 channels) and 64 (step 9 + one block, 256 channels).
In training each group of ``_CHAINED_GROUPS`` (the 256 and 128 groups)
runs as one fused ``cbg_chain`` when :func:`_chain_at_batch` allows it (in
bf16 at every batch, in f32 at 2B <= 4) and its map is a multiple of 8,
with the stem's BN + GELU deferred into the chain's first block
(``StemHeadCBG`` in the JAX package).  Otherwise a group runs its
``ConvWithNorms`` modules one by one.  In bf16 the stems' k8/s2/p3
convolutions run on ``ops.stem.stem_conv`` (``csrc/stem.cu`` on the card)
over channels-last activations, in every mode and at every batch; in f32
they, like every other convolution here, are ``F.conv2d``.  The chained
groups are this module's constant and remat is the train step's
(``trainer.make_train_step``): the JAX package's environment switches for
either have no counterpart.
Parameter names do not change.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deflow_tpu_torch import dist
from deflow_tpu_torch.models.running_stats import update_running_
from deflow_tpu_torch.ops.cbg import cbg_chain
from deflow_tpu_torch.ops.stem import stem_conv


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` in ``dtype``; a bf16 stem (8x8, stride 2, padding 3) returns a
    channels-last NCHW view."""
    if (dtype == torch.bfloat16 and conv.kernel_size == (8, 8)
            and conv.stride == (2, 2) and conv.padding == (3, 3)):
        x = x.to(dtype, memory_format=torch.channels_last).permute(0, 2, 3, 1)
        y = stem_conv(x, conv.weight, conv.bias)
        return y.permute(0, 3, 1, 2)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    conv.stride, conv.padding)


class ConvWithNorms(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, p: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, p)
        self.batchnorm = nn.BatchNorm2d(cout)
        self.nonlinearity = nn.GELU()

    def update_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax BatchNorm's running update (momentum 0.9, biased var)."""
        update_running_(self.batchnorm.running_mean, mean, 0.1)
        update_running_(self.batchnorm.running_var, var, 0.1)

    def norm_act(self, y: torch.Tensor) -> torch.Tensor:
        """BN (batch statistics in training) + GELU of the conv output ``y``
        in f32; a 1x1 map skips the BN."""
        y = y.float()
        if not (y.shape[2] == 1 and y.shape[3] == 1):
            bn = self.batchnorm
            if self.training:
                # [Σy, Σy², n] over the global batch (summed over ranks)
                n = y.new_full((1,), y.numel() // y.shape[1])
                tot = dist.all_reduce_sum(torch.cat(
                    [y.sum((0, 2, 3)), (y * y).sum((0, 2, 3)), n]))
                c = y.shape[1]
                mean = tot[:c] / tot[-1]
                var = (tot[c:2 * c] / tot[-1] - mean * mean).clamp(min=0.0)
                self.update_stats(mean, var)
            else:
                mean, var = bn.running_mean, bn.running_var
            shape = (1, -1, 1, 1)
            mul = (torch.rsqrt(var + bn.eps) * bn.weight).view(shape)
            y = (y - mean.view(shape)) * mul + bn.bias.view(shape)
        return F.gelu(y)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.norm_act(_conv(self.conv, x, dtype))

    def chain_params(self, dtype: torch.dtype):
        """(wmat [3, 3, C, O], bias [O] in ``dtype``; gamma, beta f32) for
        :func:`cbg_chain`."""
        return (self.conv.weight.to(dtype).permute(2, 3, 1, 0).contiguous(),
                self.conv.bias.to(dtype), self.batchnorm.weight,
                self.batchnorm.bias)


class UpsampleSkip(nn.Module):
    """1x1 bottleneck, 2x bilinear upsample, 1x1; fuse with the skip tensor
    through two more 1x1 convs."""

    def __init__(self, skip_c: int, latent_c: int, out_c: int):
        super().__init__()
        self.u1_u2 = nn.Sequential(
            nn.Conv2d(skip_c, skip_c // 4, 1),
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
            nn.Conv2d(skip_c // 4, skip_c // 8, 1))
        self.u3 = nn.Conv2d(latent_c, skip_c // 8, 1)
        self.u4_u5 = nn.Sequential(
            nn.Conv2d(skip_c // 4, skip_c // 8, 1),
            nn.Conv2d(skip_c // 8, out_c, 1))

    def forward(self, a: torch.Tensor, b: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        u1 = _conv(self.u1_u2[0], a, dtype)
        up = F.interpolate(u1, scale_factor=2, mode="bilinear",
                           align_corners=False)
        u2 = _conv(self.u1_u2[2], up, dtype)
        u3 = _conv(self.u3, b, dtype)
        u4 = _conv(self.u4_u5[0], torch.cat([u2, u3], dim=1), dtype)
        return _conv(self.u4_u5[1], u4, dtype)


_ENCODER = ((64, 8, 2, 3), (64, 3, 1, 1), (64, 3, 1, 1), (64, 3, 1, 1),
            (128, 8, 2, 3), (128, 3, 1, 1), (128, 3, 1, 1), (128, 3, 1, 1),
            (256, 8, 2, 3), (256, 3, 1, 1))
# each group's encoder steps: the stem, then its 3x3 blocks
_GROUP_STEPS = {"256": (1, 2, 3, 4), "128": (5, 6, 7, 8), "64": (9, 10)}
# the groups that chain in training (the 64 group's chained backward read
# 0.75-0.91x its modules' on an H100: PERF.md section 6)
_CHAINED_GROUPS = ("256", "128")


def _chain_at_batch(rows2b: int, dtype: torch.dtype) -> bool:
    """Whether a group of ``_CHAINED_GROUPS`` chains at siamese batch
    ``rows2b`` in the compute ``dtype``: the port's own crossover, measured
    on an H100 with ``tools/unet_chain_sweep.py`` (each group under autograd
    against its modules, 512² grid, 2B = 4 to 32; PERF.md section 6):

    - bf16 chains at every batch: at 2B = 32 the 256 and 128 groups'
      forwards run 1.53x and 1.38x faster, their backwards 1.03x and
      0.97x, and each group's forward and backward together are faster
      at every 2B from 8 up.
    - f32 chains at 2B <= 4 only.  There the two routes are even within
      the runs' spread with cuDNN's TF32 on (PyTorch's default), and the
      chain is 1.26x and 1.37x faster with TF32 off, the setting of the
      card's f32 checks.  From 2B = 8 up the TF32 route is 1.1x to 1.7x
      faster."""
    return dtype == torch.bfloat16 or rows2b <= 4


class FastFlow3DUNet(nn.Module):
    """Two [B, C, H, W] pseudoimages → the 64-ch flow pseudoimage.  The
    encoder weights are shared: both images run as one 2B batch."""

    def __init__(self, stem_cin: int = 32):
        super().__init__()
        cin = stem_cin
        for i, (cout, k, s, p) in enumerate(_ENCODER, start=1):
            setattr(self, f"encoder_step_{i}", ConvWithNorms(cin, cout, k, s, p))
            cin = cout
        self.decoder_step1 = UpsampleSkip(512, 256, 256)
        self.decoder_step2 = UpsampleSkip(256, 128, 128)
        self.decoder_step3 = UpsampleSkip(128, 2 * stem_cin, 64)
        self.decoder_step4 = nn.Conv2d(64, 64, 3, 1, 1)

    def _chain_group(self, stem: ConvWithNorms, blocks, s: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
        """One fused chain over the stem's conv output ``s`` (NCHW,
        channels-last): the stem's BN + GELU, then the group's 3x3 blocks."""
        y, means, variances = cbg_chain(
            s.permute(0, 2, 3, 1), [m.chain_params(dtype) for m in blocks],
            (stem.batchnorm.weight, stem.batchnorm.bias), stem.batchnorm.eps)
        for m, mean, var in zip([stem, *blocks], means, variances):
            m.update_stats(mean, var)
        return y.float().permute(0, 3, 1, 2)

    def _encode(self, x: torch.Tensor, dtype: torch.dtype):
        """The three groups' outputs (stride 2, 4, 8 feature maps)."""
        chain = self.training and _chain_at_batch(x.shape[0], dtype)
        taps = []
        for tag in _GROUP_STEPS:
            x = self.encode_group(tag, x, dtype, chain and tag in _CHAINED_GROUPS)
            taps.append(x)
        return taps

    def encode_group(self, tag: str, x: torch.Tensor, dtype: torch.dtype,
                     chain: bool) -> torch.Tensor:
        """Group ``tag``'s output from its input ``x``: one fused chain when
        ``chain`` and the stem's map is a multiple of 8, else its modules
        one by one."""
        stem, *blocks = [getattr(self, f"encoder_step_{i}") for i in _GROUP_STEPS[tag]]
        if chain:
            s = _conv(stem.conv, x.contiguous(memory_format=torch.channels_last), dtype)
            if s.shape[2] % 8 == 0 and s.shape[3] % 8 == 0:
                return self._chain_group(stem, blocks, s, dtype)
            x = stem.norm_act(s)
        else:
            blocks = [stem, *blocks]
        for m in blocks:
            x = m(x, dtype)
        return x

    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        b = img0.shape[0]
        n_all, r_all, t_all = self._encode(torch.cat([img0, img1]), dtype)
        pair = lambda z: torch.cat([z[:b], z[b:]], dim=1)
        s = self.decoder_step1(pair(t_all), pair(r_all), dtype)
        l = self.decoder_step2(s, pair(n_all), dtype)
        u = self.decoder_step3(l, torch.cat([img0, img1], dim=1), dtype)
        return _conv(self.decoder_step4, u, dtype)
