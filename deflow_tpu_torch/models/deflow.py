"""DeFlow / FastFlow3D scene-flow model.

Counterpart of ``deflow_tpu/models/deflow.py``: ego-motion compensation →
two pillar embeddings → siamese U-Net → per-point decoder head (ConvGRU,
linear or the MMHead transformer).  With the fully sorted host prep
(``data/host_prep.attach_host_prep``) the embeddings read the host's sorted
record and every per-point array and output is in ascending pillar-id
order; without it (``host_prep=None``, or no ``pc*_sorted_rec``) the points
are binned and sorted on the device and the outputs stay in the batch's
point order.  ``model.embedder.scatter_mode = "max"`` (no config key, as in
the JAX package) takes each pillar's max in place of its mean; a
host-sorted batch then skips the sorted record and computes the centroids
on the device over the host's ids.  ``num_frames > 2`` adds ``num_frames − 2`` history frames
(``history``: each ``{"pc", "mask", "pose"}``), each compensated into pc1's
frame and embedded on the device path by the same embedder; a Linear
``history_fuse`` maps each pillar's [pc0 | history …] features back to C
before the U-Net (the JAX package's per-phase fuse: a table row is one
pillar).  ``model.train()`` selects the training forward: batch-statistics
BatchNorm (with running-stat updates in call order: pc0, pc1, then the
history) and the fused encoder chains; the MMHead's dropout then draws
from the ``dropout`` generator.  The embedder calls, the backbone and the
head are the spans ``deflow/embed``, ``deflow/unet`` and ``deflow/head``.

Returns, as the JAX model does:
    flow        [B, N, 3] f32  net flow at pc0 slots (zero where invalid)
    pose_flow   [B, N, 3] f32  rigid ego flow at all real pc0 points
    pc0_valid, pc1_valid [B, N] in-range masks
    pc0_points, pc1_points [B, N, 3]
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from deflow_tpu_torch.device import resolve_device
from deflow_tpu_torch.models.decoder import (ConvGRUDecoder, LinearDecoder, MMHeadDecoder,
                                             MultiheadAttention, _linear)
from deflow_tpu_torch.models.embedder import DynamicEmbedder
from deflow_tpu_torch.models.unet import FastFlow3DUNet
from deflow_tpu_torch.ops.pose import cal_pose0to1, transform_points
from deflow_tpu_torch.ops.voxel import (
    VoxelConfig, image_to_table, pillar_info_from_ids, table_to_image)
from deflow_tpu_torch.utils.timer import span


class DeFlow(nn.Module):
    """Hyperparameter defaults of the leaderboard configuration."""

    def __init__(self,
                 voxel_size: Sequence[float] = (0.2, 0.2, 6.0),
                 point_cloud_range: Sequence[float] = (
                     -51.2, -51.2, -3.0, 51.2, 51.2, 3.0),
                 grid_feature_size: Sequence[int] = (512, 512),
                 decoder_option: str = "gru",
                 num_iters: int = 4,
                 feat_channels: int = 32,
                 num_frames: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = VoxelConfig(tuple(voxel_size), tuple(point_cloud_range))
        gw, gh, _ = cfg.grid_size
        if (gw, gh) != tuple(grid_feature_size):
            raise ValueError(
                f"grid_feature_size {tuple(grid_feature_size)} inconsistent "
                f"with the voxel-derived grid {(gw, gh)}")
        self.voxel_cfg = cfg
        self.compute_dtype = dtype
        self.embedder = DynamicEmbedder(cfg, feat_channels)
        self.backbone = FastFlow3DUNet(stem_cin=feat_channels)
        if decoder_option == "gru":
            self.head = ConvGRUDecoder(num_iters=num_iters)
        elif decoder_option == "linear":
            self.head = LinearDecoder()
        elif decoder_option == "mmhead":
            self.head = MMHeadDecoder()
        else:
            raise ValueError(f"unsupported decoder_option: {decoder_option!r}")
        self.num_frames = max(2, int(num_frames))
        if self.num_frames > 2:
            self.history_fuse = nn.Linear(feat_channels * (self.num_frames - 1),
                                          feat_channels)

    def forward(self, pc0, pc1, pose0, pose1, pc0_mask, pc1_mask,
                ego_motion: Optional[torch.Tensor] = None,
                host_prep: Optional[Dict[str, torch.Tensor]] = None,
                history: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
                dropout: Optional[torch.Generator] = None):
        cfg, dt = self.voxel_cfg, self.compute_dtype
        hosted = host_prep is not None and "pc0_sorted_rec" in host_prep
        # ego compensation in f32: the host-transformed points are the ones
        # the host pillar ids were computed from
        if host_prep is not None and "pc0_transformed" in host_prep:
            tpc0 = host_prep["pc0_transformed"].float()
        else:
            pose = (cal_pose0to1(pose0.float(), pose1.float())
                    if ego_motion is None else ego_motion.float())
            tpc0 = transform_points(pc0.float(), pose)
        pose_flow = torch.where(pc0_mask[..., None], tpc0 - pc0.float(), 0.0)

        with span("deflow/embed"):
            if hosted and self.embedder.scatter_mode == "max":
                # the max scatter has no sorted-record shortcut: the centroids
                # and features run on the card over the host's ids
                tab0, info0, _ = self.embedder.embed_points(tpc0, pc0_mask, dt,
                                                            ids=host_prep["pc0_ids"])
                tab1, info1, _ = self.embedder.embed_points(pc1.float(), pc1_mask, dt,
                                                            ids=host_prep["pc1_ids"])
                plan0 = None
            elif hosted:
                tab0 = self.embedder(host_prep["pc0_sorted_rec"],
                                     host_prep["pc0_sorted"], dt)
                tab1 = self.embedder(host_prep["pc1_sorted_rec"],
                                     host_prep["pc1_sorted"], dt)
                info0 = pillar_info_from_ids(tpc0, pc0_mask, host_prep["pc0_ids"], cfg)
                info1 = pillar_info_from_ids(pc1.float(), pc1_mask,
                                             host_prep["pc1_ids"], cfg)
                plan0 = None
            else:
                tab0, info0, plan0 = self.embedder.embed_points(tpc0, pc0_mask, dt)
                tab1, info1, _ = self.embedder.embed_points(pc1.float(), pc1_mask, dt)

            if self.num_frames > 2:
                if history is None or len(history) != self.num_frames - 2:
                    raise ValueError(
                        f"a num_frames={self.num_frames} model needs "
                        f"{self.num_frames - 2} history frames (the loader's pch keys)")
                tabs = [tab0]
                for h in history:
                    pose_h1 = cal_pose0to1(h["pose"].float(), pose1.float())
                    pts = transform_points(h["pc"].float(), pose_h1)
                    tabs.append(self.embedder.embed_points(pts, h["mask"], dt)[0])
                tab0 = _linear(self.history_fuse, torch.cat(tabs, dim=-1), dt)

        with span("deflow/unet"):
            flow_img = self.backbone(table_to_image(tab0, cfg),
                                     table_to_image(tab1, cfg), dt)
        with span("deflow/head"):
            flow = self.head(torch.cat([tab0, tab1], dim=-1),
                             image_to_table(flow_img, cfg), info0, dt, plan=plan0,
                             dropout=dropout)
        return {
            "flow": flow.float(),
            "pose_flow": pose_flow,
            "pc0_valid": info0.valid,
            "pc1_valid": info1.valid,
            "pc0_points": info0.points,
            "pc1_points": info1.points,
        }


def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Random weights and BN running statistics from ``seed``: weights and
    biases uniform in ±1/sqrt(fan_in) (the attention's packed input
    projection too), BN and LayerNorm affine near identity, running
    variance in [0.5, 1.5]."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                for t, lo, hi in ((m.weight, 0.9, 1.1), (m.bias, -0.1, 0.1),
                                  (m.running_mean, -0.1, 0.1),
                                  (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=g))
            elif isinstance(m, nn.LayerNorm):
                for t, lo, hi in ((m.weight, 0.9, 1.1), (m.bias, -0.1, 0.1)):
                    t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=g))
            elif isinstance(m, MultiheadAttention):
                bound = m.in_proj_weight.shape[1] ** -0.5
                for t in (m.in_proj_weight, m.in_proj_bias):
                    t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=g))
            elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                bound = m.weight[0].numel() ** -0.5
                for t in (m.weight, m.bias):
                    if t is not None:
                        t.copy_(torch.empty(t.shape).uniform_(
                            -bound, bound, generator=g))
    return model


def build_model(model_cfg: Optional[Mapping] = None, precision: str = "fp32",
                device=None, seed: Optional[int] = None,
                train: bool = False, num_frames: int = 2) -> DeFlow:
    """DeFlow from a model-group mapping (``conf/model/*.yaml`` keys, bare or
    under ``target``) taking ``num_frames`` frames (the config's
    ``num_frames``), on ``device`` (the card unless ``"cpu"``), in eval
    mode, or train mode with ``train=True``.  ``seed`` gives random weights;
    load real ones with
    :func:`deflow_tpu_torch.convert.load_reference_state_dict`."""
    dev = resolve_device(device)
    target = dict(model_cfg or {})
    target = dict(target.get("target", target))
    voxel_size = tuple(target.get("voxel_size", (0.2, 0.2, 6.0)))
    pc_range = tuple(target.get("point_cloud_range",
                                (-51.2, -51.2, -3.0, 51.2, 51.2, 3.0)))
    gw, gh, _ = VoxelConfig(voxel_size, pc_range).grid_size
    dtype = (torch.bfloat16 if str(precision) in ("bf16", "bfloat16")
             else torch.float32)
    model = DeFlow(voxel_size=voxel_size, point_cloud_range=pc_range,
                   grid_feature_size=(gw, gh),
                   decoder_option=str(target.get("decoder_option", "gru")),
                   num_iters=int(target.get("num_iters", 4)),
                   feat_channels=int(target.get("feat_channels", 32)),
                   num_frames=num_frames, dtype=dtype)
    if seed is not None:
        init_random_(model, seed)
    return model.to(dev).train(train)
