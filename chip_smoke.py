#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deflow_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. the card's name and power limit (nvidia-smi);
2. build every kernel from ``deflow_tpu_torch/csrc`` with nvcc (sm_90a),
   and the C++ host ops (``csrc/pointops.cpp``) with g++; the host prep of
   each path timed on one batch (median of 3): numpy, the C++ ops on one
   thread and over a pool of min(8, cpu_count) threads (a thread a
   sample).  Every batch any phase preps goes through the C++ host prep
   and is held bit for bit against the numpy prep on every key;
3. each kernel at its path's shapes, in bf16 and in f32 (TF32 off): its
   error against its plain PyTorch version, its time, the plain version's
   time, a library call's (or call sequence's) time, and the bound (the GRU
   backward and the fused conv3x3+BN+GELU backward also split by the
   kernels they launch; the fused blocks at 256^2x64, 128^2x128 and
   64^2x256 at 2B = 4); the f32 routes of the GRU forward (at 4 x and 2 x
   98,304), the GRU backward and both fused blocks timed as well, against
   the f32 bound (67 TFLOP/s, f32 bytes) and their library sequences in
   f32 (cuBLAS sgemm, cuDNN, TF32 off), under each result's "f32" key (the
   GRU forward's train shape under "f32_train"; the f32 routes of the GRU
   backward and the fused block backward also split by kernel: main
   kernel, dW product, reductions; dgrad, wgrad, reduction); first, every plan fed to a segment-sum is
   checked to ascend within each sample, sentinels last; the segment-sum also bit
   for bit on integer features, at the train path's embedder shape and on
   the skewed clouds' pillar ids (points per occupied pillar); the
   segment-sum and the row gather also as each
   other's backward on the train path's ids; the fused conv3x3+BN+GELU
   kernels at both chain widths, and in bf16 at the 256^2 and 128^2
   groups' shapes at 2B = 32 (the config's batch_size 16, which the train
   path chains); the encoder stems' k8/s2/p3 kernels (forward, dgrad,
   wgrad) at the three stems' maps at 2B = 32, beside F.conv2d in bf16 and
   its autograd (with the library's kernels by name); the SSL kernels on an SSL batch: the cell
   sweep (both directions, and on skewed clouds: blocks per chunk and
   pieces), the lane segment-sum of the chamfer VJP (beside
   the pillar segment-sum at the same shape) and the brute search at 2 x
   16,384; the row gather, the
   lane segment-sum and their library calls also timed as 20 launches
   captured in one CUDA graph (no host launch overhead); then the
   full-width sweep against the brute search (truncated distances, both
   directions, all and dynamic candidates), on the SSL batch and on the
   skewed clouds, with the share of the rows whose neighbour lies below
   ring·cell on which both find the same distance (``tools/sweep_check.py``'s
   exactness check);
3b. the kernels on the device binning path's call patterns at 4 x 98,304
   (the points in their own order): the segment-sum on a device sort's
   ids, 4 bf16 lanes (the centroids) and 33 (the features), after the
   plan's order check; the row gather at unsorted flat ids (the
   centroids' gather back, the planned scatter's backward, the decoder);
4. the eval path: leaderboard DeFlow (512x512 grid, ConvGRU, 4 iterations,
   bf16 compute, random weights from a seed) evaluates 5 synthetic batches
   of 4 x 98,304 point slots (86,016 valid) through ``run_validation``
   (3-way and bucketed metrics); the launch counters must show 2 scatters,
   1 gather, 1 GRU and 3 stem forwards per batch; then two more steps under torch.profiler,
   the second read: device time by kernel and the device's idle share
   (every profiled step must show device time in the segment-sum
   categories of the kernels it launched);
4b. the eval entry: ``run_validation`` over an in-memory dataset of 16
   batches of 4 x 98,304 samples, three ways, in the order a b c c b a:
   (a) numpy prep, no overlap; (b) C++ prep, no overlap; (c) the
   reference's form, the C++ prep in the loader's prefetch thread and the
   copy by ``device_prefetch`` (all three with the metric terms in worker
   processes); wall ms per batch and the steady period between eval steps
   of each run, launches 2 / 1 / 1 / 3 per batch, the metrics of all runs
   equal to 1e-6 relative;
5. the train path: the same model in train mode takes 5 Adam steps (lr
   2e-4, deflowLoss) on synthetic batches of 2 x 98,304 slots through
   ``make_train_step``; per step 3 scatters, 3 gathers, 1 GRU forward and
   1 backward, 6 fused-block forwards and 6 backwards, 3 stem forwards, 3
   dgrads and 3 wgrads (every bf16 path counts the stems: a forward a stem
   an eval batch, and under remat two); then one more step
   under torch.profiler;
6. the SSL path: 5 Adam steps of seflowLoss (truncate 2 m, DUFO labels
   with 15% dynamic points, pc1's chamfer cell prep from the host) at
   2 x 98,304, which takes the grid branch: per step the train path's
   counts plus 2 cell sweeps and 1 lane segment-sum; peak memory and one
   profiled step; then 3 steps at 2 x 16,384 (the brute branch under the
   same rule): 4 brute searches and no sweep per step, and one profiled
   step;
5b. the train entry: ``entry.train.fit`` (the config's defaults: remat,
   bf16, Adam lr 2e-4, the leaderboard DeFlow) over in-memory splits of
   2 x 98,304 samples: (a) deflowLoss, 2 epochs of 8 steps, each validated
   on 2 batches of 4 and checkpointed (epoch_N.ckpt, best.ckpt); (b) three
   runs resumed from (a)'s epoch_0.ckpt for epoch 1, (a) against the
   first within 4x the largest difference between two resumed runs (the
   card's backward is not deterministic); (c) seflowLoss, 1 epoch of 6 steps (the grid
   branch).  Launches per step
   (remat: every forward kernel twice, 5 scatters, 4 gathers, 2 GRU
   forwards, 1 backward, 12 fused-block forwards, 6 backwards; SeFlow adds
   2 sweeps and 1 lane segment-sum) and per eval batch (2 / 1 / 1); finite
   metrics; the steady period between steps beside phase 5's and 6's
   device medians, the logged frames/s, the host prep; a checkpoint's
   round trip bit for bit with its save and load ms; one step with remat
   against two without (the same loss, gradients within 4x the plain
   steps' difference, BN statistics moved once) and the peak memory of
   each, also at the config's batch_size 16 (2B = 32, chained in bf16);
8. the rest of the model, each path at full width with its launch counts
   held: (a) the MMHead decoder's eval of 3 host-sorted batches of 4 x
   98,304 (device ms, peak memory, a profiled batch; its attention against
   ``scaled_dot_product_attention``), (b) 3 MMHead deflowLoss steps at 2 x
   98,304 with dropout (finite loss and gradients), (c) 3 num_frames=3
   deflowLoss steps (ConvGRU head, one history frame binned on the card),
   (d) the eval of 3 raw batches without host prep, held against the
   host-prep eval of the same batch (f32 within 2e-4; bf16 printed);
7. reference checks in f32 on small inputs, the card against the CPU
   (plain PyTorch versions): the eval output, and one train step's loss,
   gradient norm, per-parameter gradients and updated parameters, for
   deflowLoss and for seflowLoss on its grid and its brute branch; then
   phase 8's paths: the MMHead eval and the eval without host prep, the
   MMHead step (dropout 0 on both sides; its parameters not held, as
   seflowLoss's) and the num_frames=3 step;
9. data parallelism (``deflow_tpu_torch/dist.py``): (a) two ranks sharing
   the card over gloo (``dist.run_ranks``; nccl refuses two ranks on one
   card), each taking half of the host's prep threads: 3 f32 deflowLoss
   steps (64x64 grid, 2 x 4,096 slots a rank, the shards unlike in valid
   counts and speed buckets), 3 seflowLoss steps on the grid branch and 3
   on the brute branch, each against one process at the same global batch
   on the card (loss, grad_norm, first-step gradients, BN running
   statistics, deflowLoss's parameters after the steps: ratios to their
   tolerances) with the ranks bit for bit after every step; then 3
   leaderboard bf16 deflowLoss steps at 2 x 98,304 a rank (the fused
   chains at the per-card 2B = 4), each rank's launch deltas held to
   phase 5's per step; (c) the DP eval's pred_flow against one process,
   f32 (small) and bf16 (4 x 98,304), and ``run_validation`` over the
   ranks (5 samples in batches of 4) against one process's metrics (1e-3
   relative); (b) the full-width train step and
   ``entry.train.fit`` under an nccl group of world size 1 against the
   same without a group, and the device time of the nccl kernels a step;
11. the JAX package's last surface, each path at full width with its
   launch counts held: (a) SeFlow with dyn_cap at 20% and 5% of N: the
   first step's loss equal to the uncompacted one, 2 sweeps and 1 lane sum
   a step, the chamfer's d_pc0 on fixed clouds equal off the rows the
   truncated f-terms touch; (b) the eval with scatter_mode="max", with and
   without host prep, and its f32 small model against the CPU; (c) the
   DUFO labeller on a synthetic 20-frame drive of 98,304 points a frame,
   the card against the CPU;
12. the reference's ablation configurations, each path at full width with
   its launch counts held, its median and spread of 3 steady steps after
   a warm-up, and its peak memory: (a) the leaderboard DeFlow at the 0.1 m
   voxel (a 1024^2 grid), eval of 4 x 98,304, and (b) its deflowLoss step at
   2 x 98,304, each with a profiled step; (c) FastFlow3D (the linear head),
   eval, and (d) its ff3dLoss step at lr 4e-5; (e) num_iters=2; (f)
   zeroflowLoss under AdamW, SGD and Adam with a gradient clip; (g)
   precision fp32, eval and step, each with a profiled step; (h)
   ``entry.train.fit`` of FastFlow3D with ff3dLoss, one epoch validated and
   checkpointed; the wrappers' size
   limits as the largest batch at each grid; then the f32 checks of the
   card against the CPU: (a) on one sample at the 1024^2 grid itself, (c),
   and one step each of (d), (e), (f) at the small model; then the kernels
   at the 1024^2 grid's shapes, in phase 3's style: the embedder's
   segment-sum into 4 x 1,048,584 rows, the decoder's gather from a [4 x
   1,048,576, 128] table and its backward, the fused blocks at 512^2x64,
   256^2x128 and 128^2x256; last, the drift witness: one epoch of phase
   5b's train entry (a) and phase 5's leaderboard steps again, beside
   their first readings;
10. a JSON line of phase 8's numbers, one of phase 9's, one of phase 11's,
   one of phase 12's, one of each phase's wall seconds (also printed as
   each phase ends), one JSON line of kernels, the card line, and the
   result line.
Step times are medians of the steady steps (all but the first, which warms
cuDNN up); the eval phase also prints their mean.
Needs one CUDA card; exits non-zero without one.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

B, N, VALID = 4, 98304, 86016
TRAIN_B = 2          # per card: the JAX package trains 2 per chip
TRAIN_STEPS = 5
LR = 2e-4
VOXEL = [0.2, 0.2, 6.0]
RANGE = [-51.2, -51.2, -3.0, 51.2, 51.2, 3.0]
LEADERBOARD = {"voxel_size": VOXEL, "point_cloud_range": RANGE,
               "grid_feature_size": [512, 512], "feat_channels": 32,
               "decoder_option": "gru", "num_iters": 4}
NUM_BATCHES = 5
ENTRY_BATCHES = 16   # the eval-entry phase: 16 batches of B in-memory samples
# host threads of the C++ host prep (samples of a batch in parallel) and of
# the entry's loader
HOST_WORKERS = min(8, os.cpu_count() or 1)
SSL_STEPS = 5
BRUTE_N, BRUTE_VALID, BRUTE_STEPS = 16384, 14336, 3   # 2 x 16,384: the brute branch
TRUNCATE = 2.0
# H100 SXM data sheet: HBM 3.35 TB/s, dense bf16 tensor cores 989 TFLOP/s,
# f32 outside the tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
# f32 instructions outside the tensor cores, one operation each: 128 lanes
# x 132 SMs x 1.98 GHz.  The sweep and the brute search round once per
# operation, as their plain versions and the Pallas kernels do, so no FMA
# may fuse a product and a sum, and the 67 TFLOP/s above (an FMA counted
# as two flops) is out of their reach.
F32_NO_FMA_OPS_PER_S = 128 * 132 * 1.98e9
# the brute search's f32 operations per (p, q) pair: d is 8 (5 for the
# dot), and one compare
BRUTE_OPS_PER_PAIR = 9


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def make_batch(seed: int, b: int = B, n: int = N, valid: int = VALID,
               dufo: bool = False):
    """Synthetic AV2-shaped host batch: uniform clouds over the range, a
    moving ego, ~40% foreground points of which half move; with ``dufo``
    also DUFO labels, 15% dynamic points in each cloud (as the JAX
    package's SSL bench draws them)."""
    rng = np.random.default_rng(seed)
    pc0 = np.stack([rng.uniform(-51, 51, (b, n)), rng.uniform(-51, 51, (b, n)),
                    rng.uniform(-2.8, 2.8, (b, n))], -1).astype(np.float32)
    mask = np.tile(np.arange(n) < valid, (b, 1))
    pc0[~mask] = 0.0
    pose0 = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose1 = pose0.copy()
    pose1[:, 0, 3] = 1.3
    ego = np.linalg.inv(pose1[0].astype(np.float64)) @ pose0[0]
    cls = np.where(rng.random((b, n)) < 0.4, rng.integers(1, 30, (b, n)), 0)
    moving = (cls > 0) & (rng.random((b, n)) < 0.5)
    flow = (pc0 @ ego[:3, :3].T.astype(np.float32) + ego[:3, 3].astype(np.float32)
            - pc0 + moving[..., None] * rng.normal(0, 1.0, (b, n, 3)))
    flow = np.where(mask[..., None], flow, 0.0).astype(np.float32)
    pc1 = (pc0 + flow + rng.normal(0, 0.02, (b, n, 3))).astype(np.float32)
    pc1 = np.stack([p[np.concatenate([rng.permutation(valid),
                                      np.arange(valid, n)])] for p in pc1])
    pc1[~mask] = 0.0
    hb = {"pc0": pc0, "pc1": pc1, "pose0": pose0, "pose1": pose1,
          "pc0_mask": mask, "pc1_mask": mask.copy(), "flow": flow,
          "flow_is_valid": mask.copy(),
          "flow_category_indices": cls.astype(np.int32)}
    if dufo:
        hb["dufo_label0"] = (rng.random((b, n)) < 0.15).astype(np.int32)
        hb["dufo_label1"] = (rng.random((b, n)) < 0.15).astype(np.int32)
    return hb


def skewed_cloud(rng, n, valid):
    """Near-field-heavy radial density and two dense clusters, as AV2's near
    field (a copy of tools/sweep_check.py's ``skewed_cloud``)."""
    r = np.clip(rng.gamma(2.0, 8.0, n), 1.5, 51.0)
    th = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack([r * np.cos(th), r * np.sin(th),
                    rng.uniform(-2.8, 2.8, n)], -1).astype(np.float32)
    k = n // 16
    for c in ((8.0, 3.0), (-5.0, -12.0)):
        sel = rng.integers(0, n, k)
        pts[sel, :2] = np.asarray(c) + rng.normal(0, 0.6, (k, 2))
    mask = np.arange(n) < valid
    pts[~mask] = 0
    return pts, mask


def same_bits(got: dict, want: dict) -> list:
    """Keys whose arrays differ in dtype, shape or any bit (or are missing)."""
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray) and not (
                isinstance(g, np.ndarray) and g.dtype == w.dtype
                and g.shape == w.shape and g.tobytes() == w.tobytes()):
            bad.append(k)
    return bad


def held_prep(hb: dict, voxel=VOXEL):
    """The C++ host prep of ``hb`` (every path's), held bit for bit against
    the numpy prep on every key; exits on a mismatch.  Returns the prepped
    batch and the C++ call's host ms."""
    from deflow_tpu_torch.data.host_prep import attach_host_prep

    want = attach_host_prep(copy.deepcopy(hb), voxel, RANGE, backend="numpy")
    t0 = time.perf_counter()
    got = attach_host_prep(hb, voxel, RANGE, num_workers=HOST_WORKERS)
    ms = (time.perf_counter() - t0) * 1e3
    bad = same_bits(got, want)
    if bad:
        raise SystemExit(f"the C++ host prep differs from numpy on {bad}")
    return got, ms


def host_prep_times(reps: int = 3) -> dict:
    """Host ms per batch of each path's prep, median of ``reps``: numpy, the
    C++ ops on one thread (samples in turn) and over the shared pool of
    HOST_WORKERS threads (samples in parallel)."""
    from deflow_tpu_torch.data.host_prep import attach_host_prep

    out = {}
    for path, b, n, valid, dufo in (("eval", B, N, VALID, False),
                                    ("train", TRAIN_B, N, VALID, False),
                                    ("ssl", TRAIN_B, N, VALID, True),
                                    ("ssl 2 x 16,384", TRAIN_B, BRUTE_N,
                                     BRUTE_VALID, True)):
        hb = make_batch(1, b=b, n=n, valid=valid, dufo=dufo)
        row = {}
        for name, kw in (("numpy", {"backend": "numpy"}), ("cxx_1_thread", {}),
                         ("cxx_pool", {"num_workers": HOST_WORKERS})):
            attach_host_prep(copy.deepcopy(hb), VOXEL, RANGE, **kw)     # warm
            ms = []
            for _ in range(reps):
                c = copy.deepcopy(hb)
                t0 = time.perf_counter()
                attach_host_prep(c, VOXEL, RANGE, **kw)
                ms.append((time.perf_counter() - t0) * 1e3)
            row[name] = float(np.median(ms))
        out[path] = row
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after one
    warm-up call (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


GRAPH_LAUNCHES, GRAPH_REPLAYS = 20, 5


def graph_ms(fn) -> float:
    """Mean device time of ``fn`` over GRAPH_LAUNCHES calls captured in one
    CUDA graph, replayed GRAPH_REPLAYS times under CUDA events: no host
    launch overhead between the launches (one warm-up call first, on a side
    stream as capture requires)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (GRAPH_LAUNCHES * GRAPH_REPLAYS)


def ptxas_lines(log: str) -> list:
    """ptxas's register, stack and spill lines (and any warning) of an nvcc
    log, each prefixed by the function it describes (demangled by c++filt
    where the host has it, with the parameter list dropped)."""
    import re
    import shutil

    rows, fn = [], ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        elif "registers" in line or "spill" in line or "warning" in line:
            rows.append((fn, line.strip()))
    names = sorted({f for f, _ in rows if f})
    short = dict(zip(names, names))
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True).stdout.splitlines()
        if len(out) == len(names):
            for raw, dem in zip(names, out):
                dem = dem.replace("(anonymous namespace)::", "").removeprefix("void ")
                short[raw] = dem.split("(")[0]
    return [f"{short.get(f, f)}: {line}" if f else line for f, line in rows]


def kernel_split(fn, reps: int) -> dict:
    """Device ms per call of ``fn`` by kernel name (torch.profiler over
    ``reps`` calls after one warm-up call; template arguments and
    namespaces dropped from the names)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name.replace("(anonymous namespace)::", "").replace("void ", "")
            key = re.split(r"[<(]", key)[0].split("::")[-1].strip()
            out[key] = out.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def gru_loop(h0, x, wzr, bzr, wq, bq, iters: int):
    """The GRU loop as a PyTorch call sequence with operands in h0's dtype
    to every matmul (cuBLAS, f32 accumulation; f32 operands in true f32,
    TF32 off) and an f32 state: the library yardstick of the fused GRU and,
    under autograd, of its backward."""
    import torch

    hd = h0.shape[1]
    h = h0.float()
    for _ in range(iters):
        zr = torch.sigmoid((torch.cat([h.to(h0.dtype), x], -1) @ wzr).float() + bzr.float())
        z, r = zr[:, :hd], zr[:, hd:]
        q = torch.tanh((torch.cat([(r * h).to(h0.dtype), x], -1) @ wq).float() + bq.float())
        h = (1.0 - z) * h + z * q
    return h.to(h0.dtype)


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_plan(what: str, ids, s: int, samples: int) -> None:
    """Exit unless ``ids`` ascend within each of ``samples`` parts with
    the sentinels last, as the segment-sum kernels' searches and runs need
    (a plain torch diff on the card)."""
    from deflow_tpu_torch.ops import scatter

    ok = scatter.plan_is_sorted(ids, s, samples)
    print(f"plan {what}: {ids.shape[0]} ids into {s} rows in {samples} part(s), "
          f"{'ascending within each, sentinels last' if ok else 'NOT SORTED'}")
    if not ok:
        raise SystemExit(f"the plan {what} breaks the segment-sum's order")


def hold_segment_sum(what: str, feats32, ids, s: int, samples: int = 1) -> dict:
    """The segment-sum of ``feats32 [n, c]`` (zero at sentinel ids) by the
    flat ``ids`` into ``s`` rows in ``samples`` parts, in f32 and bf16,
    against its plain version (and bit for bit on integer features, whose
    sums are exact in any order: values in {-1, 0, 1}, so a sum stays
    within bf16's exact integers for runs up to 256); returns the bf16
    measurements and the points per occupied row."""
    import torch

    from deflow_tpu_torch.ops import scatter

    g = torch.Generator(device=ids.device).manual_seed(ids.shape[0])
    ints = torch.randint(-1, 2, feats32.shape, generator=g, device=ids.device).float()
    for dt in (torch.float32, torch.bfloat16):
        f = feats32.to(dt)
        k = scatter.sorted_segment_sum(f, ids, s, samples)
        ref = scatter.segment_sum_plain(f, ids, s)
        ki = scatter.sorted_segment_sum(ints.to(dt), ids, s, samples)
        same = torch.equal(ki, scatter.segment_sum_plain(ints.to(dt), ids, s))
        torch.cuda.synchronize()
        err = (k.float() - ref.float()).abs().max().item()
        rtol, atol = ((1e-5, 1e-5) if dt == torch.float32 else (2 ** -7, 1e-6))
        ok = torch.allclose(k.float(), ref.float(), rtol=rtol, atol=atol)
        print(f"segment_sum {what} {dt}: max_abs_err {err:.3e} "
              f"(tol rtol {rtol:g} atol {atol:g}) {'ok' if ok else 'FAIL'}; integer "
              f"features {'bit-identical to' if same else 'DIFFER from'} the plain version's")
        if not (ok and same):
            raise SystemExit(f"segment_sum ({what}) disagrees with its plain version")
    counts = torch.bincount(ids[ids < s].long(), minlength=s)
    occupied = counts[counts > 0]
    n, c = f.shape
    isz = f.element_size()
    nv = int((ids < s).sum())          # rows at a sentinel id are not read
    b_ms, b_by = bound(nv * c * isz + n * 4 + s * c * isz, nv * c,
                       BF16_FLOP_PER_S)
    idx_lib = torch.where(ids < s, ids, s).long()
    return {
        "max_abs_err": err, "shape": f"{n}x{c}->{s}",
        "points_per_occupied_row": {"mean": occupied.float().mean().item(),
                                    "max": int(occupied.max())},
        "ms": cuda_ms(lambda: scatter.sorted_segment_sum(f, ids, s, samples), 50),
        "plain_ms": cuda_ms(lambda: scatter.segment_sum_plain(f, ids, s), 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.zeros(
            s + 1, c, dtype=f.dtype, device=f.device).index_add_(0, idx_lib, f), 10),
    }


def hold_gather(what: str, table32, ids, rows: int, timed=None) -> dict:
    """The row gather of ``table32 [rows, c]`` at the flat ``ids`` (ids >=
    rows read zeros), in f32 and bf16, bit-exact against its plain
    version; returns the measurements in ``timed`` (default bf16)."""
    import torch

    from deflow_tpu_torch.ops import gather

    for dt in (torch.float32, torch.bfloat16):
        t = table32.to(dt)
        k = gather.sorted_rows_gather(t, ids, rows)
        ref = gather.gather_plain(t, ids, rows)
        torch.cuda.synchronize()
        exact = torch.equal(k, ref)
        err = (k.float() - ref.float()).abs().max().item()
        print(f"sorted_gather {what} {dt}: max_abs_err {err:.3e} (tol: bit-exact) "
              f"{'ok' if exact else 'FAIL'}")
        if not exact:
            raise SystemExit(f"sorted_gather ({what}) is not bit-exact")
    t = table32.to(timed or torch.bfloat16)
    c = t.shape[1]
    t_lib = torch.cat([t, t.new_zeros(1, c)])
    idx_lib = torch.where(ids < rows, ids, rows).long()
    m = ids.shape[0]
    read = torch.unique(ids[ids < rows]).numel()
    row_bytes = c * t.element_size()
    b_ms, b_by = bound(m * 4 + read * row_bytes + m * row_bytes, 0,
                       BF16_FLOP_PER_S)
    kernel = lambda: gather.sorted_rows_gather(t, ids, rows)
    library = lambda: torch.index_select(t_lib, 0, idx_lib)
    r = {"max_abs_err": err, "shape": f"{rows}x{c}@{m}",
         "ms": cuda_ms(kernel, 50),
         "plain_ms": cuda_ms(lambda: gather.gather_plain(t, ids, rows), 10),
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(library, 50),
         "graph_ms": graph_ms(kernel), "library_graph_ms": graph_ms(library)}
    print(f"sorted_gather {what} {r['shape']}: graph-captured {r['graph_ms']:.4f} ms, "
          f"index_select {r['library_graph_ms']:.4f} ms; back to back {r['ms']:.4f} ms, "
          f"index_select {r['library_ms']:.4f} ms")
    return r


def pillar_feats(ids, s: int, g):
    """The embedder's scatter input at the flat ``ids``: 32 feature lanes
    (relu of normals) and the count lane, zero at the sentinel."""
    import torch

    feats32 = torch.relu(torch.randn(ids.shape[0], 33, generator=g, device=ids.device))
    feats32[:, 32] = 1.0
    return torch.where((ids < s)[:, None], feats32, 0.0)


def gather_ids(db, cfg, b: int):
    """pc0's PillarInfo and the decoder gather's flat ids over B·P rows."""
    import torch

    from deflow_tpu_torch.ops import voxel

    info = voxel.pillar_info_from_ids(db["pc0_transformed"], db["pc0_mask"],
                                      db["pc0_ids"], cfg)
    boff = (torch.arange(b, dtype=torch.int32, device=info.valid.device)
            * cfg.num_pillars)[:, None]
    ids = torch.where(info.valid, info.pillar_id + boff, voxel.GATHER_SENTINEL)
    return info, ids.reshape(-1).to(torch.int32)


def check_kernels(model, host_batch):
    """Phase 3: every kernel against its plain version at the eval path's
    shapes; returns the bf16 (main path) measurements per kernel, the fused
    GRU's f32 route's under its "f32" key."""
    import torch

    from deflow_tpu_torch.ops import gru, voxel
    from deflow_tpu_torch.trainer import device_batch

    dev = torch.device("cuda")
    cfg = model.voxel_cfg
    p = cfg.num_pillars
    db = device_batch(host_batch, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # -- segment-sum: the embedder's 32 feature lanes + count lane, real ids
    seg = p + voxel.TRASH_PAD
    ids = voxel.make_presorted_plan(db["pc0_sorted"], seg)
    check_plan("(embedder)", ids, B * seg, B)
    results["segment_sum"] = hold_segment_sum("(embedder)", pillar_feats(ids, B * seg, g),
                                              ids, B * seg, B)

    # -- row gather: the decoder's [B*P, 128] table at pc0's real ids
    _, gids = gather_ids(db, cfg, B)
    results["sorted_gather"] = hold_gather(
        "(decoder)", torch.randn(B * p, 128, generator=g, device=dev), gids, B * p)

    # -- fused GRU: [B*N, 128] hidden, [B*N, 64] input, the model's weights
    iters = model.head.num_iters
    h32 = torch.randn(B * N, 128, generator=g, device=dev) * 0.5
    x32 = torch.randn(B * N, 64, generator=g, device=dev) * 0.5
    w32 = [w.detach().float().contiguous() for w in model.head.gru.merged_weights()]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        args = [h32.to(dt), x32.to(dt)] + [w.to(dt).contiguous() for w in w32]
        k = gru.fused_gru(*args, iters)
        ref = gru.fused_gru_plain(*args, iters)
        torch.cuda.synchronize()
        err = errs[dt] = (k.float() - ref.float()).abs().max().item()
        # f32: summation order over K = 192, four times.  bf16: the state is
        # f32 on both sides; an intermediate bf16 operand may round the other
        # way, and the output rounds once (<= 2 bf16 ulps).
        rtol, atol = ((1e-5, 1e-4) if dt == torch.float32 else (2 ** -6, 4e-3))
        ok = torch.allclose(k.float(), ref.float(), rtol=rtol, atol=atol)
        print(f"fused_gru {dt}: max_abs_err {err:.3e} "
              f"(tol rtol {rtol:g} atol {atol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("fused_gru disagrees with its plain version")
    m, xdim, hd = B * N, 64, 128
    # x·W_x is the same in every iteration: the function needs it once,
    # and the h part of both products in each iteration
    flops = 2.0 * m * (3 * hd) * (xdim + hd * iters)
    nbytes = 2 * m * (hd + xdim + hd) + 2 * (hd + xdim) * 3 * hd + 2 * 3 * hd
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)

    def library_fwd():
        with torch.no_grad():
            return gru_loop(*args, iters)

    results["fused_gru"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: gru.fused_gru(*args, iters), 10),
        "plain_ms": cuda_ms(lambda: gru.fused_gru_plain(*args, iters), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(library_fwd, 5),
        "library_call": "call sequence: the GRU loop with bf16 matmul operands "
                        "(cuBLAS, f32 accumulation), no autograd",
    }
    # the kernel's time by iteration count: what a tile's loads, x·W_x and
    # store take (0 iterations) and what each iteration adds
    by_iters = {n: cuda_ms(lambda n=n: gru.fused_gru(*args, n), 10) for n in (0, 1, 2, 8)}
    by_iters[iters] = results["fused_gru"]["ms"]
    print("fused_gru by iterations: " + ", ".join(
        f"{n}: {t:.4f} ms" for n, t in sorted(by_iters.items())))
    for name, r in results.items():
        print_timing(name, r)
    results["fused_gru"]["f32"] = gru_f32_timing(errs[torch.float32], h32, x32, w32, iters)
    print_timing("fused_gru f32", results["fused_gru"]["f32"])
    return results


def gru_f32_timing(err, h32, x32, w32: list, iters: int) -> dict:
    """The fused GRU's f32 route at [M, 128] + [M, 64]: its f32 row (``err``
    None: held against its plain version here first)."""
    import torch

    from deflow_tpu_torch.ops import gru

    m, xdim, hd = h32.shape[0], x32.shape[1], h32.shape[1]
    args = [h32, x32] + w32
    if err is None:
        k, ref = gru.fused_gru(*args, iters), gru.fused_gru_plain(*args, iters)
        err = (k - ref).abs().max().item()
        print(f"fused_gru f32 at {m} points: max_abs_err {err:.3e} (tol rtol 1e-05 atol 1e-4)")
        if not torch.allclose(k, ref, rtol=1e-5, atol=1e-4):
            raise SystemExit("fused_gru disagrees with its plain version")

    def library():
        with torch.no_grad():
            return gru_loop(*args, iters)

    return f32_timing(
        err, lambda: gru.fused_gru(*args, iters), lambda: gru.fused_gru_plain(*args, iters),
        library, 4 * m * (hd + xdim + hd) + 4 * (hd + xdim) * 3 * hd + 4 * 3 * hd,
        2.0 * m * (3 * hd) * (xdim + hd * iters),
        "call sequence: the GRU loop in f32 (cuBLAS sgemm, TF32 off), no autograd",
        f"{m}x{hd}+{xdim}, {iters} iterations")


def _rel_err(k, ref) -> float:
    """max |k - ref| over max(1, max |ref|)."""
    k, ref = k.float(), ref.float()
    return ((k - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()


# kernel vs plain at the path's shapes, relative to the largest reference
# element: f32 differs in summation order only; bf16 by one rounding of an
# f32 sum (2^-8) plus rare flips of a rounded operand
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}


def _hold(name, dt, pairs):
    """Check (what, kernel, plain) triples against TRAIN_TOL; returns the
    largest error."""
    import torch

    tol = TRAIN_TOL[str(dt).split(".")[-1]]
    worst = 0.0
    for what, k, ref in pairs:
        if k.shape != ref.shape or not torch.isfinite(k.float()).all():
            raise SystemExit(f"{name} {what}: shape {tuple(k.shape)} or not finite")
        worst = max(worst, _rel_err(k, ref))
    ok = worst <= tol
    print(f"{name} {dt}: max rel err {worst:.3e} (tol {tol:g} of max |ref|) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")
    return worst


def check_train_kernels(model, host_batch, splits: list):
    """Phase 3, training kernels at the train path's shapes (B = TRAIN_B):
    the segment-sum and the row gather as each other's backward, on the ids
    the autograd functions build from ``host_batch``; the GRU backward at
    [B*N] points; the fused conv3x3+BN+GELU forward and backward at both
    chain widths of the siamese 2B batch (the 64^2 group's 256 channels
    too); each against its plain version.
    Returns the bf16 measurements: the backward uses of the segment-sum and
    the gather under "as_gather_bwd" / "as_scatter_bwd", the fused blocks'
    256^2 width first, the 128^2 and 64^2 widths under "width_128" and
    "width_64"; the f32 routes' under "f32" (the GRU forward's at this
    shape under "f32_train").  Appends to
    ``splits`` (name, result, call) for the GRU backward and each fused
    block backward, whose split by kernel (``split_ms``) the caller
    measures after every other timing of the phase: torch.profiler leaves
    host overhead on later launches."""
    import torch

    from deflow_tpu_torch.ops import gru, voxel
    from deflow_tpu_torch.trainer import device_batch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    results = {}
    cfg = model.voxel_cfg
    seg = cfg.num_pillars + voxel.TRASH_PAD
    db = device_batch(host_batch, dev)

    # -- the scatter's backward (voxel._SegmentSum): a row gather of the
    # [B*(P+8), 33] cotangent at the scatter's flat ids, whose sentinel
    # (sentinel_for) runs sit between the samples
    sids = voxel.make_presorted_plan(db["pc0_sorted"], seg)
    check_plan("(embedder, train)", sids, TRAIN_B * seg, TRAIN_B)
    embedder = hold_segment_sum("(embedder, train)", pillar_feats(sids, TRAIN_B * seg, g),
                                sids, TRAIN_B * seg, TRAIN_B)
    scatter_bwd = hold_gather("(the scatter's backward)",
                              torch.randn(TRAIN_B * seg, 33, generator=g, device=dev),
                              sids, TRAIN_B * seg)
    gather_bwd = hold_gather_bwd("", db, cfg, TRAIN_B, g)

    # -- GRU backward: M = B*N points, the model's weights
    iters = model.head.num_iters
    m, xdim, hd = TRAIN_B * N, 64, 128
    h32 = torch.randn(m, hd, generator=g, device=dev) * 0.5
    x32 = torch.randn(m, xdim, generator=g, device=dev) * 0.5
    g32 = torch.randn(m, hd, generator=g, device=dev)
    w32 = [w.detach().float().contiguous() for w in model.head.gru.merged_weights()]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        args = [h32.to(dt), x32.to(dt)] + [w.to(dt).contiguous() for w in w32] + [g32.to(dt)]
        k = gru.fused_gru_bwd(*args, iters)
        ref = gru.fused_gru_bwd_plain(*args, iters)
        torch.cuda.synchronize()
        err = errs[dt] = _hold("fused_gru_bwd", dt, zip(
            ("dh0", "dx", "dw_zr", "db_zr", "dw_q", "db_q"), k, ref))

    def library_bf16():
        # the forward recomputed and its VJP through torch autograd
        leaves = [a.detach().requires_grad_() for a in args[:6]]
        return torch.autograd.grad(gru_loop(*leaves, iters), leaves, args[6])

    # three products (the forward recomputed, dh and dW), each with x·W_x
    # once and the h products every iteration
    flops = 3 * 2.0 * m * (3 * hd) * (xdim + hd * iters)
    nbytes = 2 * m * (hd + xdim + hd) * 2 + 2 * (hd + xdim) * 3 * hd * 2
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    results["fused_gru_bwd"] = {
        "max_abs_err": err, "shape": f"{m}x{hd}+{xdim}, {iters} iterations",
        "ms": cuda_ms(lambda: gru.fused_gru_bwd(*args, iters), 5),
        "plain_ms": cuda_ms(lambda: gru.fused_gru_bwd_plain(*args, iters), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(library_bf16, 3),
        "library_call": "call sequence: torch autograd of the GRU loop with bf16 "
                        "matmul operands (cuBLAS, f32 accumulation)",
    }
    splits.append(("fused_gru_bwd", results["fused_gru_bwd"],
                   lambda: gru.fused_gru_bwd(*args, iters)))
    a32 = [h32, x32] + w32 + [g32]

    def library_f32():
        leaves = [a.detach().requires_grad_() for a in a32[:6]]
        return torch.autograd.grad(gru_loop(*leaves, iters), leaves, a32[6])

    r32 = results["fused_gru_bwd"]["f32"] = f32_timing(
        errs[torch.float32], lambda: gru.fused_gru_bwd(*a32, iters),
        lambda: gru.fused_gru_bwd_plain(*a32, iters), library_f32,
        4 * m * (hd + xdim + hd) * 2 + 4 * (hd + xdim) * 3 * hd * 2, flops,
        "call sequence: torch autograd of the GRU loop in f32 (cuBLAS sgemm, TF32 off)",
        results["fused_gru_bwd"]["shape"])
    splits.append(("fused_gru_bwd f32", r32, lambda: gru.fused_gru_bwd(*a32, iters)))
    # the forward's f32 route at the train path's shape
    fwd32 = gru_f32_timing(None, h32, x32, w32, iters)
    print_timing("fused_gru f32", fwd32)
    print_timing("fused_gru_bwd f32", r32)

    # -- fused blocks at the chain widths of the siamese batch
    for name, pair in hold_cbg(model, g, splits).items():
        for kname, r in pair.items():
            if name == "256":
                results[kname] = r
            else:
                results[kname][f"width_{name}"] = r
    hold_cbg_config_batch(model, g)
    results["fused_gru"] = {"f32_train": fwd32}
    results["sorted_gather"] = {"as_scatter_bwd": scatter_bwd}
    results["segment_sum"] = {"as_gather_bwd": gather_bwd, "train_embedder": embedder}
    for name, r in results.items():
        for rr in (r, *(r.get(k) for k in ("width_128", "width_64", "as_scatter_bwd",
                                            "as_gather_bwd", "train_embedder"))):
            if rr and "ms" in rr:
                print_timing(name, rr)
    return results


def measure_splits(splits: list) -> None:
    """Each backward's split by the kernels it launches (``split_ms``, under
    torch.profiler), after every other timing of its phase; empties
    ``splits``, whose calls hold the kernels' inputs."""
    for name, r, fn in splits:
        r["split_ms"] = kernel_split(fn, 10)
        print(f"{name} {r['shape']} split by kernel: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in sorted(r["split_ms"].items())))
    splits.clear()


def f32_timing(err: float, fn, plain, library, nbytes: float, flops: float,
               library_call: str, shape: str, reps: tuple = (5, 3, 3)) -> dict:
    """An f32 route's row: its error, the kernel's, the plain version's and
    the f32 library sequence's ms (TF32 off), and the bound at the f32
    rate outside the tensor cores and f32 bytes."""
    b_ms, b_by = bound(nbytes, flops, F32_FLOP_PER_S)
    return {"max_abs_err": err, "shape": shape, "ms": cuda_ms(fn, reps[0]),
            "plain_ms": cuda_ms(plain, reps[1]), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(library, reps[2]), "library_call": library_call}


def print_timing(name: str, r: dict) -> None:
    print(f"{name} {r.get('shape', '')}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
          f"by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, library "
          f"{r['library_ms']:.4f} ms)")


def hold_gather_bwd(what: str, db, cfg, b: int, g) -> dict:
    """The gather's backward (voxel._Gather): a segment-sum of the [b*N,
    128] per-point cotangent, invalid slots zeroed and sent to the trash
    row, on the ids of the device batch ``db``."""
    import torch

    from deflow_tpu_torch.ops import voxel

    p, seg = cfg.num_pillars, cfg.num_pillars + voxel.TRASH_PAD
    info, _ = gather_ids(db, cfg, b)
    gplan = voxel.make_presorted_plan(torch.where(info.valid, info.pillar_id, p), seg)
    check_plan(f"(the gather's backward{what})", gplan, b * seg, b)
    cot = torch.where(info.valid.reshape(-1, 1),
                      torch.randn(info.valid.numel(), 128, generator=g,
                                  device=info.valid.device), 0.0)
    return hold_segment_sum(f"(the gather's backward{what})", cot, gplan, b * seg, b)


def cbg_case(net, step: int, rows: int, res: int, g) -> tuple:
    """Random inputs of ``net``'s encoder block ``step`` at siamese batch
    ``rows`` on ``res``^2 maps, in f32: (wmat, bias, x, si, dz, scal,
    scal_in), the BN slabs with the block's gamma and beta on the output
    side."""
    import torch

    from deflow_tpu_torch.ops import cbg

    dev = torch.device("cuda")
    wm, bias, gamma, beta = (t.detach() for t in
                             getattr(net, f"encoder_step_{step}").chain_params(torch.float32))
    c, o = wm.shape[2], wm.shape[3]
    x32 = torch.randn(rows, res, res, c, generator=g, device=dev)
    si32 = torch.randn(rows, res, res, o, generator=g, device=dev)
    dz32 = torch.randn(rows, res, res, o, generator=g, device=dev)
    scal = cbg.scal_slab(0.1 * torch.randn(c, generator=g, device=dev),
                         torch.rand(c, generator=g, device=dev) + 0.5, torch.full((c,), 1.05, device=dev),
                         torch.full((c,), 0.02, device=dev))
    scal_in = cbg.scal_slab(0.1 * torch.randn(o, generator=g, device=dev),
                            torch.rand(o, generator=g, device=dev) + 0.5, gamma, beta,
                            0.01 * torch.randn(o, generator=g, device=dev),
                            0.01 * torch.randn(o, generator=g, device=dev))
    return wm, bias, x32, si32, dz32, scal, scal_in


def hold_cbg_block(what: str, dt, case: tuple) -> tuple:
    """The fused block's forward and backward in ``dt`` on ``case``
    (:func:`cbg_case`) against their plain versions, every output held
    (s and its stats; dz_prev, dw, db and dz_prev's stats): (forward args,
    backward args, forward error, backward error)."""
    import torch

    from deflow_tpu_torch.ops import cbg

    wm, bias, x32, si32, dz32, scal, scal_in = case
    c, o = wm.shape[2], wm.shape[3]
    fa = (x32.to(dt), wm.to(dt).contiguous(), bias.to(dt), scal)
    kf = cbg.cbg_block_fwd(*fa)
    rf = cbg.cbg_block_fwd_plain(*fa)
    ba = (dz32.to(dt), si32.to(dt), x32.to(dt), wm.to(dt).contiguous(), scal_in, scal)
    kb = cbg.cbg_block_bwd(*ba)
    rb = cbg.cbg_block_bwd_plain(*ba)
    torch.cuda.synchronize()
    res = x32.shape[1]
    ef = _hold(f"cbg_fwd {res}^2x{c}->{o}{what}", dt,
               [("s", kf[0], rf[0]), ("stats", kf[1].sum(0), rf[1].sum(0))])
    eb = _hold(f"cbg_bwd {res}^2x{c}->{o}{what}", dt,
               [("dz_prev", kb[0], rb[0]), ("dw", kb[1], rb[1]),
                ("db", kb[2].sum(0), rb[2].sum(0)),
                ("stats", kb[3].sum(0), rb[3].sum(0))])
    return fa, ba, ef, eb


def hold_cbg_config_batch(model, g) -> None:
    """The bf16 fused-block forward and backward of the 256 and 128 groups
    at the config's siamese batch 2 x CONFIG_BATCH, where the train path
    chains them, against their plain versions: the partial-sum rows, the
    backward's scratch and its weight-gradient slabs are sized by the
    batch."""
    import torch

    net, hw = model.backbone, model.voxel_cfg.pseudoimage_hw
    for step, res in ((2, hw[0] // 2), (6, hw[0] // 4)):
        hold_cbg_block(f", 2B = {2 * CONFIG_BATCH}", torch.bfloat16,
                       cbg_case(net, step, 2 * CONFIG_BATCH, res, g))
        torch.cuda.empty_cache()


def hold_cbg(model, g, splits: list) -> dict:
    """The fused conv3x3+BN+GELU forward and backward of each encoder group
    of ``model`` ("256", "128", "64": the maps at a half, a quarter and an
    eighth of the grid) at the siamese batch 2 x TRAIN_B, against their plain
    versions in f32 and bf16; returns the bf16 measurements by group, each
    with its f32 route's under "f32", and appends each bf16 backward's
    (name, result, call) to ``splits``."""
    import torch
    import torch.nn.functional as F

    from deflow_tpu_torch.ops import cbg

    net = model.backbone
    hw = model.voxel_cfg.pseudoimage_hw
    results = {}
    for (name, step, res) in (("256", 2, hw[0] // 2), ("128", 6, hw[0] // 4),
                              ("64", 10, hw[0] // 8)):
        case = cbg_case(net, step, 2 * TRAIN_B, res, g)
        wm, bias, *_, scal, scal_in = case
        c, o = wm.shape[2], wm.shape[3]
        shape = (2 * TRAIN_B, res, res)
        held = {dt: hold_cbg_block("", dt, case) for dt in (torch.float32, torch.bfloat16)}
        fa, ba, ef, eb = held[torch.bfloat16]
        npix = shape[0] * res * res
        flops = 2.0 * npix * 9 * c * o
        x_cl = fa[0].permute(0, 3, 1, 2)           # NCHW view, channels-last
        w_by = {dt: (wm.to(dt).permute(3, 2, 0, 1).contiguous(), bias.to(dt))
                for dt in (torch.float32, torch.bfloat16)}

        def lib_fwd(dt=torch.bfloat16, x_cl=x_cl):
            w_, b_ = w_by[dt]
            u = F.gelu(cbg.bn_apply(x_cl.float().permute(0, 2, 3, 1), scal)).to(dt)
            s_ = F.conv2d(u.permute(0, 3, 1, 2), w_, b_, padding=1).float()
            return s_.sum((0, 2, 3)), (s_ * s_).sum((0, 2, 3))

        def lib_bwd(dt=torch.bfloat16, ba=ba):
            w_ = w_by[dt][0]
            zh = (ba[1].float() - scal_in[0]) * scal_in[1]
            ds = (scal_in[2] * scal_in[1] * (ba[0].float() - scal_in[4] - zh * scal_in[5])
                  ).to(dt).permute(0, 3, 1, 2)
            zp = cbg.bn_apply(ba[2].float(), scal)
            xa = F.gelu(zp).to(dt).permute(0, 3, 1, 2)
            dx = torch.nn.grad.conv2d_input(xa.shape, w_, ds, padding=1)
            dw = torch.nn.grad.conv2d_weight(xa, w_.shape, ds, padding=1)
            dzp = dx.float().permute(0, 2, 3, 1) * cbg.gelu_grad(zp)
            return dzp.sum((0, 1, 2)), dw, ds.float().sum((0, 2, 3))

        bf = bound(npix * (c + o) * 2 + 9 * c * o * 2, flops, BF16_FLOP_PER_S)
        bb = bound(npix * (2 * o + c) * 2 + npix * c * 2 + 9 * c * o * 4,
                   2 * flops, BF16_FLOP_PER_S)
        for kname, err, fn, plain, lib, (b_ms, b_by) in (
                ("cbg_fwd", ef, lambda: cbg.cbg_block_fwd(*fa),
                 lambda: cbg.cbg_block_fwd_plain(*fa), lib_fwd, bf),
                ("cbg_bwd", eb, lambda ba=ba: cbg.cbg_block_bwd(*ba),
                 lambda: cbg.cbg_block_bwd_plain(*ba), lib_bwd, bb)):
            r = {"max_abs_err": err, "ms": cuda_ms(fn, 10), "plain_ms": cuda_ms(plain, 3),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib, 5),
                 "library_call": "call sequence: torch BN+GELU, F.conv2d / "
                                 "torch.nn.grad.conv2d_* (cuDNN, bf16)",
                 "shape": f"{shape[0]}x{res}x{res}x{c}->{o}"}
            if kname == "cbg_bwd":
                splits.append((kname, r, fn))
            results.setdefault(name, {})[kname] = r
        # the f32 routes, against cuDNN's f32 convolutions (TF32 off)
        fa32, ba32, ef32, eb32 = held[torch.float32]
        x32_cl = fa32[0].permute(0, 3, 1, 2)
        call = ("call sequence: torch BN+GELU, F.conv2d / torch.nn.grad.conv2d_* "
                "(cuDNN, f32, TF32 off)")
        for kname, err, fn, plain, lib, nbytes, fl in (
                ("cbg_fwd", ef32, lambda: cbg.cbg_block_fwd(*fa32),
                 lambda: cbg.cbg_block_fwd_plain(*fa32),
                 lambda: lib_fwd(torch.float32, x32_cl),
                 npix * (c + o) * 4 + 9 * c * o * 4, flops),
                ("cbg_bwd", eb32, lambda ba32=ba32: cbg.cbg_block_bwd(*ba32),
                 lambda: cbg.cbg_block_bwd_plain(*ba32),
                 lambda: lib_bwd(torch.float32, ba32),
                 npix * (2 * o + c) * 4 + npix * c * 4 + 9 * c * o * 4, 2 * flops)):
            r = results[name][kname]["f32"] = f32_timing(
                err, fn, plain, lib, nbytes, fl, call, f"{shape[0]}x{res}x{res}x{c}->{o}",
                (10, 3, 5))
            print_timing(f"{kname} f32", r)
            if kname == "cbg_bwd":
                splits.append(("cbg_bwd f32", r, fn))
    return results


# row 10: the encoder stems at the config's siamese batch (2B = 32)
STEM_ROWS = 32


def library_kernels(fn, reps: int = 3) -> dict:
    """Device ms a call of ``fn`` by kernel name (torch.profiler): which
    library kernel runs it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:90]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def hold_stem(model, g) -> dict:
    """Row 10: each encoder stem of ``model`` (``encoder_step_1``, ``_5``,
    ``_9`` on the grid's map, a half and a quarter of it) at 2B =
    STEM_ROWS: the forward, dgrad and wgrad kernels against their plain s2d
    versions, timed beside their bound, the plain version and the library
    (``F.conv2d`` in bf16 on the channels-last view; its autograd's input
    and weight gradients), with the library's device kernels by name.
    Returns the rows by wrapper name; the launches of every path are read
    where that path runs."""
    import torch
    import torch.nn.functional as F

    from deflow_tpu_torch.ops import stem

    dev = torch.device("cuda")
    net, hw = model.backbone, model.voxel_cfg.pseudoimage_hw
    out = {"stem_fwd": {}, "stem_dgrad": {}, "stem_wgrad": {}}
    for step, div in ((1, 1), (5, 2), (9, 4)):
        conv = getattr(net, f"encoder_step_{step}").conv
        o, c = conv.weight.shape[:2]
        res = hw[0] // div
        x = torch.randn(STEM_ROWS, res, res, c, generator=g, device=dev).to(torch.bfloat16)
        dy = torch.randn(STEM_ROWS, res // 2, res // 2, o, generator=g,
                         device=dev).to(torch.bfloat16)
        wt, bias = conv.weight.detach(), conv.bias.detach()
        shape = f"{STEM_ROWS}x{res}x{res}x{c}->{o}"
        calls = {"stem_fwd": (lambda: (stem.stem_fwd(x, wt, bias),),
                              lambda: (stem.stem_fwd_plain(x, wt, bias),)),
                 "stem_dgrad": (lambda: (stem.stem_dgrad(dy, wt, res, res),),
                                lambda: (stem.stem_dgrad_plain(dy, wt, res, res),)),
                 "stem_wgrad": (lambda: stem.stem_wgrad(x, dy),
                                lambda: stem.stem_wgrad_plain(x, dy))}
        errs = {}
        for k, (fn, plain) in calls.items():
            got, want = fn(), plain()
            torch.cuda.synchronize()
            errs[k] = _hold(f"{k} {shape}", torch.bfloat16,
                            list(zip(("out", "bias grad"), got, want)))
            del got, want
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        wl = wt.to(torch.bfloat16).requires_grad_()
        bl = bias.to(torch.bfloat16).requires_grad_()
        yl, dyl = F.conv2d(xl, wl, bl, stride=2, padding=3), dy.permute(0, 3, 1, 2)
        library = {"stem_fwd": lambda: F.conv2d(xl, wl, bl, stride=2, padding=3),
                   "stem_dgrad": lambda: torch.autograd.grad(yl, xl, dyl, retain_graph=True),
                   "stem_wgrad": lambda: torch.autograd.grad(yl, (wl, bl), dyl,
                                                             retain_graph=True)}
        flops = 2.0 * STEM_ROWS * (res // 2) ** 2 * o * 64 * c
        b_ms, b_by = bound(STEM_ROWS * (res * res * c + (res // 2) ** 2 * o) * 2
                           + o * c * 64 * 2, flops, BF16_FLOP_PER_S)
        for k, (fn, plain) in calls.items():
            r = {"max_abs_err": errs[k], "shape": shape, "ms": cuda_ms(fn, 10),
                 "plain_ms": cuda_ms(plain, 3), "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": cuda_ms(library[k], 5),
                 "library_call": "F.conv2d (cuDNN, bf16, channels-last) / its autograd",
                 "library_kernels": library_kernels(library[k])}
            r["tflops"] = flops / r["ms"] / 1e9
            out[k][f"encoder_step_{step}"] = r
            print_timing(k, r)
            print(f"{k} {shape}: {r['tflops']:.1f} TFLOP/s, {100 * b_ms / r['ms']:.1f}% of "
                  "bound; library kernels " + ", ".join(
                      f"{n} {ms:.3f} ms" for n, ms in list(r["library_kernels"].items())[:3]))
        del x, dy, xl, wl, bl, yl, dyl, calls, library
        torch.cuda.empty_cache()
    return out


def ssl_clouds(db, spec):
    """The SSL loss's sweep clouds from a device batch: pc0 (ego-compensated,
    the warped cloud of an untrained flow) device-sorted with its DUFO
    flags, pc1 from the host cell prep; and the masked clouds and flags."""
    import torch

    from deflow_tpu_torch.ops import chamfer

    m0, m1 = db["pc0_mask"], db["pc1_mask"]
    f0, f1 = m0 & (db["dufo_label0"] > 0), m1 & (db["dufo_label1"] > 0)
    warped = torch.where(m0[..., None], db["pc0_transformed"], 0.0)
    pc1 = torch.where(m1[..., None], db["pc1"], 0.0)
    c0 = chamfer._sweep_sort(warped, m0, f0, spec)
    c1 = chamfer._sweep_cloud_from_host(db["pc1_cell_lanes"], db["pc1_cell_sid"],
                                        db["pc1_cell_start"], spec)
    return c0, c1, (warped, pc1, m0, m1, f0, f1)


def sweep_ops(args) -> float:
    """The f32 operations the dual sweep's inputs need: for every pair of a
    chunk's query and a visited candidate, d (8, 11 with the w term on a
    dirty chunk) and a compare; for every pair with a flagged candidate one
    more add and compare (the other rows can never win the flag lane)."""
    import torch

    from deflow_tpu_torch.ops import sweep

    _, c_slab, cs, cn, dirty = args
    ncc = c_slab.shape[0]
    lo = cs.long().clamp(0, ncc)
    hi = torch.maximum((cs.long() + cn.long()).clamp(max=ncc), lo)
    flagged = torch.cat([torch.zeros(1, dtype=torch.long, device=cs.device),
                         (c_slab[:, 4] < 3e38).sum(1).cumsum(0)])
    pairs = (hi - lo).sum(1) * (sweep.CHUNK_C * sweep.CHUNK_Q)
    flag_pairs = (flagged[hi] - flagged[lo]).sum(1) * sweep.CHUNK_Q
    ops = pairs * (9 + 3 * dirty.long()) + 2 * flag_pairs
    return float(ops.sum())


def hold_sweep(what: str, qc, cc, spec) -> dict:
    """The cell sweep of queries ``qc`` against candidates ``cc`` (dual, the
    SSL loss's), bit for bit against its plain version; its blocks per
    chunk, pieces, time and bound."""
    import torch

    from deflow_tpu_torch.ops import chamfer, sweep

    args = chamfer.sweep_inputs(qc, cc, spec)
    k = sweep.cell_sweep(*args, dual=True)
    ref = sweep.cell_sweep_plain(*args, dual=True)
    torch.cuda.synchronize()
    same = torch.equal(k, ref)
    blocks = args[3].sum(1)
    pieces = int(torch.where(blocks > 0, -(-blocks // sweep.PIECE_BLOCKS), 1).sum())
    pairs = int(blocks.sum()) * sweep.CHUNK_C * sweep.CHUNK_Q
    nq, ncc = args[0].shape[0], args[1].shape[0]
    print(f"cell_sweep {what}: {nq} queries, {ncc} candidate blocks, {pairs:.4g} "
          f"pairs visited, blocks per chunk mean {blocks.float().mean().item():.2f} "
          f"max {int(blocks.max())}, {pieces} pieces of at most "
          f"{sweep.PIECE_BLOCKS} blocks, {float(args[4].float().mean()):.3f} of the "
          f"chunks dirty; output {'bit-identical to' if same else 'DIFFERS from'} "
          "the plain version")
    if not same:
        raise SystemExit(f"cell_sweep ({what}) disagrees with its plain version")
    nbytes = (args[0].numel() + args[1].numel() + k.numel()) * 4 + 7 * nq // sweep.CHUNK_Q * 4
    b_ms, b_by = bound(nbytes, sweep_ops(args), F32_NO_FMA_OPS_PER_S)
    return {"max_abs_err": (k - ref).abs().max().item(), "pairs": pairs,
            "blocks_per_chunk_mean": blocks.float().mean().item(),
            "blocks_per_chunk_max": int(blocks.max()), "pieces": pieces,
            "ms": cuda_ms(lambda: sweep.cell_sweep(*args, dual=True), 20),
            "plain_ms": cuda_ms(lambda: sweep.cell_sweep_plain(*args, dual=True), 1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"{what}, {nq}x8 vs {ncc}x8x{sweep.CHUNK_C}"}


def check_ssl_kernels(ssl_batch, brute_batch):
    """Phase 3, the SSL kernels at the SSL path's shapes (B = TRAIN_B):
    the cell sweep on both directions of a 2 x 98,304 batch (pc1 from the
    host cell prep) and of two skewed 2 x 98,304 clouds (AV2's dense near
    field), the lane segment-sum of the pc1→pc0 matches (the chamfer VJP's
    one scatter), and the brute search at 2 x 16,384; each against its
    plain version: the sweep and the brute search bit-identical, the lane
    sums within 1e-6 of their largest element."""
    import torch

    from deflow_tpu_torch.ops import chamfer, nn, scatter, voxel
    from deflow_tpu_torch.trainer import SSL_TRAIN_KEYS, device_batch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    results = {}
    spec = chamfer._resolve_spec("grid", N, N, TRUNCATE, None)
    db = device_batch(ssl_batch, dev, SSL_TRAIN_KEYS)
    c0, c1, _ = ssl_clouds(db, spec)

    # -- kernel 8: both directions, dual (the SSL loss's sweeps), on the
    # SSL batch's uniform clouds and on skewed ones
    timed = {what: hold_sweep(what, qc, cc, spec)
             for what, (qc, cc) in (("pc0->pc1", (c0, c1)), ("pc1->pc0", (c1, c0)))}
    results["cell_sweep"] = {**timed["pc0->pc1"], "pc1_to_pc0": timed["pc1->pc0"]}
    s0, s1, (sk0, sk1, skm0, skm1, _, _) = skewed_ssl_clouds(spec)
    results["cell_sweep"]["skewed"] = {
        what: hold_sweep(f"{what} skewed", qc, cc, spec)
        for what, (qc, cc) in (("pc0->pc1", (s0, s1)), ("pc1->pc0", (s1, s0)))}

    # -- kernel 1 on the skewed clouds' pillar ids, the four as one eval
    # batch: long runs in the dense near field and the two clusters
    cfg = voxel.VoxelConfig(tuple(VOXEL), tuple(RANGE))
    seg = cfg.num_pillars + voxel.TRASH_PAD
    pid = voxel.compute_pillar_info(torch.cat([sk0, sk1]), torch.cat([skm0, skm1]),
                                    cfg).pillar_id
    sk_ids = voxel.make_presorted_plan(pid.sort(dim=1).values, seg)
    nb = pid.shape[0]
    check_plan("(embedder, skewed clouds)", sk_ids, nb * seg, nb)
    results["segment_sum"] = {"skewed": hold_segment_sum(
        "(embedder, skewed clouds)", pillar_feats(sk_ids, nb * seg, g), sk_ids,
        nb * seg, nb)}

    # -- kernel 7: the pc1->pc0 matches (all and dynamic) scattered into
    # pc0's B·N rows, sorted as the chamfer VJP sorts them
    _, i1a, _, i1f = chamfer._sweep_dir(c1, c0, spec, dual=True)
    idx = torch.cat([i1a, i1f], 1)
    bq, m = idx.shape
    segs = bq * N
    flat = torch.where((idx >= 0) & (idx < N),
                       idx + (torch.arange(bq, device=dev) * N)[:, None], segs)
    sid, order = torch.sort(flat.reshape(-1), stable=True)
    ids = sid.to(torch.int32)
    check_plan("(the lane segment-sum)", ids, segs, 1)
    rows = torch.randn(bq * m, 4, generator=g, device=dev)[order].contiguous()
    k = scatter.segment_sum_lanes(rows, ids, segs)
    ref = scatter.segment_sum_lanes_plain(rows, ids, segs)
    torch.cuda.synchronize()
    err = _rel_err(k, ref)
    # the kernel adds each run in row order, as index_add_ does on the CPU
    serial = torch.equal(k.cpu(), scatter.segment_sum_lanes_plain(rows.cpu(), ids.cpu(), segs))
    print(f"segment_sum_lanes {bq * m}x4->{segs}: max rel err {err:.3e} "
          f"(tol 1e-6 of max |ref|) {'ok' if err <= 1e-6 else 'FAIL'}; "
          f"{'bit-identical to' if serial else 'DIFFERS from'} the plain version on the CPU")
    if not (err <= 1e-6 and serial):
        raise SystemExit("segment_sum_lanes disagrees with its plain version")
    idx_lib = torch.where(ids < segs, ids, segs).long()
    b_ms, b_by = bound(rows.numel() * 4 + ids.numel() * 4 + segs * 4 * 4,
                       rows.numel(), F32_FLOP_PER_S)
    lanes = lambda: scatter.segment_sum_lanes(rows, ids, segs)
    lanes_lib = lambda: torch.zeros(segs + 1, 4, device=dev).index_add_(0, idx_lib, rows)
    results["segment_sum_lanes"] = {
        "max_abs_err": (k - ref).abs().max().item(),
        "shape": f"{bq * m}x4->{segs}",
        "ms": cuda_ms(lanes, 50),
        "plain_ms": cuda_ms(lambda: scatter.segment_sum_lanes_plain(rows, ids, segs), 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lanes_lib, 10),
        "graph_ms": graph_ms(lanes), "library_graph_ms": graph_ms(lanes_lib),
        "library_call": "index_add_",
        # the pillar segment-sum kernel (built for 33- to 128-wide rows) on the
        # same rows and ids
        "segment_sum_cu_ms": cuda_ms(lambda: scatter.sorted_segment_sum(rows, ids, segs), 50),
    }

    # -- kernel 9: the brute branch's search, pc0 -> pc1 at 2 x 16,384
    bdb = device_batch(brute_batch, dev, SSL_TRAIN_KEYS)
    m1 = bdb["pc1_mask"]
    p = torch.where(bdb["pc0_mask"][..., None], bdb["pc0_transformed"], 0.0)
    q = torch.where(m1[..., None], bdb["pc1"], 0.0)
    kd, ki = nn.chamfer_min(p, q, m1)
    rd, ri = nn.chamfer_min_plain(p, q, m1)
    torch.cuda.synchronize()
    same = torch.equal(kd, rd) and torch.equal(ki, ri)
    print(f"chamfer_brute {tuple(p.shape)} x {tuple(q.shape)}: distances and indices "
          f"{'bit-identical to' if same else 'DIFFER from'} the plain version's")
    if not same:
        raise SystemExit("chamfer_brute disagrees with its plain version")
    qf = torch.where(m1[..., None], q, 1e6)

    def library():
        # chunked torch.cdist (cuBLAS Gram product) and min over q
        for bi in range(p.shape[0]):
            for s0 in range(0, p.shape[1], 4096):
                torch.cdist(p[bi, s0:s0 + 4096], qf[bi]).min(-1)

    pairs = p.shape[0] * p.shape[1] * q.shape[1]
    b_ms, b_by = bound((p.numel() + q.numel() + m1.numel() / 4 + 2 * kd.numel()) * 4,
                       pairs * BRUTE_OPS_PER_PAIR, F32_NO_FMA_OPS_PER_S)
    results["chamfer_brute"] = {
        "max_abs_err": (kd - rd).abs().max().item(), "pairs": pairs,
        "shape": f"{p.shape[0]}x{p.shape[1]}x{q.shape[1]}",
        "ms": cuda_ms(lambda: nn.chamfer_min(p, q, m1), 10),
        "plain_ms": cuda_ms(lambda: nn.chamfer_min_plain(p, q, m1), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(library, 3),
        "library_call": "call sequence: torch.cdist in 4096-row chunks + min",
    }
    skewed = results["cell_sweep"]["skewed"]
    for name, r in results.items():
        for rr in (r, r.get("pc1_to_pc0"), *(skewed.values() if r is results["cell_sweep"]
                                            else ())):
            if rr and "ms" in rr:
                lib = "none" if rr["library_ms"] is None else f"{rr['library_ms']:.4f} ms"
                print(f"{name} {rr['shape']}: {rr['ms']:.4f} ms (bound "
                      f"{rr['bound_ms']:.4f} ms by {rr['bound_by']}, plain "
                      f"{rr['plain_ms']:.4f} ms, library {lib})")
    r = results["segment_sum_lanes"]
    print(f"segment_sum.cu on the lane sum's rows and ids: {r['segment_sum_cu_ms']:.4f} ms")
    print(f"segment_sum_lanes {r['shape']}: graph-captured {r['graph_ms']:.4f} ms, "
          f"index_add_ {r['library_graph_ms']:.4f} ms; back to back {r['ms']:.4f} ms, "
          f"index_add_ {r['library_ms']:.4f} ms")
    return results


def skewed_ssl_clouds(spec):
    """Phase 3's two skewed 2 x 98,304 clouds (the same seed): pc0 sorted on
    the device with 15% of its rows flagged, pc1 from the host cell prep;
    as :func:`ssl_clouds` returns them."""
    import torch

    from deflow_tpu_torch.data.host_prep import chamfer_cell_prep
    from deflow_tpu_torch.ops import chamfer

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    pts, masks = zip(*(skewed_cloud(rng, N, VALID) for _ in range(2 * TRAIN_B)))
    pts = torch.from_numpy(np.stack(pts)).reshape(2, TRAIN_B, N, 3)
    masks = torch.from_numpy(np.stack(masks)).reshape(2, TRAIN_B, N)
    flags = masks & torch.from_numpy(rng.random(masks.shape) < 0.15)
    c0 = chamfer._sweep_sort(pts[0].to(dev), masks[0].to(dev), flags[0].to(dev), spec)
    cps = [chamfer_cell_prep(pts[1, i].numpy(), masks[1, i].numpy(), flags[1, i].numpy(),
                             cell=spec.cell) for i in range(TRAIN_B)]
    c1 = chamfer._sweep_cloud_from_host(
        *(torch.from_numpy(np.stack([c[k] for c in cps])).to(dev)
          for k in ("lanes", "sid", "start")), spec)
    return c0, c1, tuple(t.to(dev) for t in (pts[0], pts[1], masks[0], masks[1],
                                             flags[0], flags[1]))


def sweep_vs_brute(ssl_batch=None, label: str = "") -> tuple:
    """The full-width sweep against the brute search on one SSL batch (or,
    without one, on phase 3's skewed clouds), both directions, all and
    dynamic candidates: min(d, truncate²) must agree on every valid query
    row.  The sweep's (dx² + dy²) + dz² is accurate to a few ulps; the
    brute search's |p|² + |q|² − 2p·q cancels, with an error below 10·u·R²
    (u = 2^-24, R² the largest squared norm: 2u for each squared norm, 4u
    for the doubled dot, 2u for their sum), held here to 8·eps32·R² =
    16·u·R².  Distances, not indices, are compared (the counterpart of
    ``tools/sweep_check.py``'s exactness below ring·cell).  Returns the
    largest difference over its tolerance and the share of the rows whose
    brute neighbour lies below ring·cell on which the sweep found the same
    distance within it."""
    from deflow_tpu_torch.ops import chamfer, nn
    from deflow_tpu_torch.trainer import SSL_TRAIN_KEYS, device_batch

    spec = chamfer._resolve_spec("grid", N, N, TRUNCATE, None)
    if ssl_batch is None:
        c0, c1, (warped, pc1, m0, m1, f0, f1) = skewed_ssl_clouds(spec)
    else:
        db = device_batch(ssl_batch, None, SSL_TRAIN_KEYS)
        c0, c1, (warped, pc1, m0, m1, f0, f1) = ssl_clouds(db, spec)
    d0a, _, d0f, _ = chamfer._sweep_dir(c0, c1, spec, dual=True)
    d1a, _, d1f, _ = chamfer._sweep_dir(c1, c0, spec, dual=True)
    r2 = max(warped.square().sum(-1).max().item(), pc1.square().sum(-1).max().item())
    tol = 8 * float(np.finfo(np.float32).eps) * r2
    t2 = TRUNCATE ** 2
    radius2 = (spec.ring * spec.cell) ** 2
    worst, near, same = 0.0, 0, 0
    for what, ds, p, q, qmask, rows in (
            ("pc0->pc1 all", d0a, warped, pc1, m1, m0),
            ("pc0->pc1 dynamic", d0f, warped, pc1, f1, f0),
            ("pc1->pc0 all", d1a, pc1, warped, m0, m1),
            ("pc1->pc0 dynamic", d1f, pc1, warped, f0, f1)):
        db_, _ = nn.chamfer_min(p, q, qmask)
        diff = (ds.clamp(max=t2) - db_.clamp(max=t2)).abs()[rows]
        below = (db_[rows] < t2).float().mean().item()
        close = rows & (db_ < radius2)
        near += int(close.sum())
        same += int(((ds - db_).abs() <= tol)[close].sum())
        print(f"sweep vs brute{label}, {what}: {int(rows.sum())} rows ({below:.3f} with a "
              f"neighbour below {TRUNCATE:g} m), max |d| difference "
              f"{diff.max().item():.3e} m^2 (tol {tol:.3e})")
        worst = max(worst, diff.max().item() / tol)
    return worst, same / max(near, 1)


def run_main_path(model, batches):
    """Phase 4: ``run_validation`` over the batches; returns the metrics,
    the two accumulators, per-batch device ms and the launch counts."""
    import torch

    from deflow_tpu_torch.entry.evaluate import run_validation
    from deflow_tpu_torch.metrics import BucketedEPE, ThreewayEPE
    from deflow_tpu_torch.trainer import device_batch, make_eval_step

    eval_step = make_eval_step(model)
    device_ms = []

    def timed_step(host_batch):
        db = device_batch(host_batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = eval_step(db)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
        for k, v in out.items():
            if v.shape[:2] != (B, N) or (v.is_floating_point()
                                         and not torch.isfinite(v).all()):
                raise SystemExit(f"eval output {k} not finite / wrong shape")
        return out

    reset_launches()
    three, bucketed = ThreewayEPE(), BucketedEPE()
    metrics = run_validation(timed_step, batches, three=three, bucketed=bucketed)
    launches = read_launches()
    db = device_batch(batches[0])
    profile_step(lambda: eval_step(db), launches)
    return metrics, (three, bucketed), device_ms, launches


def entry_dataset(seeds=None, b: int = B, dufo: bool = False) -> list:
    """An in-memory split: ``b`` samples for each of ``seeds`` (the eval
    entry's ENTRY_BATCHES by default) shaped like
    ``HDF5Dataset.__getitem__``'s (labels, an eval mask of |x|, |y| < 35 m;
    DUFO labels with ``dufo``)."""
    samples = []
    seeds = range(500, 500 + ENTRY_BATCHES) if seeds is None else seeds
    for k in seeds:
        hb = make_batch(k, b=b, dufo=dufo)
        for i in range(b):
            s = {key: v[i] for key, v in hb.items()}
            s["eval_mask"] = s["pc0_mask"] & (np.abs(s["pc0"][:, :2]) < 35).all(1)
            s.update(scene_id=f"scene_{k:03d}", timestamp=str(1_000_000_000 + i),
                     num_points0=np.int32(s["pc0_mask"].sum()))
            samples.append(s)
    return samples


def run_entry_phase(model, device_median_ms: float) -> dict:
    """Phase 4b: the eval entry over an in-memory dataset, three ways, in
    the order a b c c b a: (a) the numpy prep, no overlap; (b) the C++ prep
    on HOST_WORKERS threads, no overlap (loader prefetch 0, no
    device_prefetch); (c) ``run_validation(eval_step, ds, cfg)``: the C++
    prep in the loader's prefetch thread, the copy by ``device_prefetch``.
    All three compute the metric terms in HOST_WORKERS worker processes.
    Per run: wall ms per batch (the workers' start included) and the
    steady period, the median time between two eval steps, with pairs/s;
    launches 2 / 1 / 1 / 3 per batch; the metrics of (a), (b) and (c) equal to
    1e-6 relative.  Returns the launch counts of a run."""
    import torch

    from deflow_tpu_torch.data.h5dataset import DataLoader, collate
    from deflow_tpu_torch.data.host_prep import attach_host_prep
    from deflow_tpu_torch.entry.evaluate import _sorted_prep, run_validation
    from deflow_tpu_torch.metrics import BucketedEPE, ThreewayEPE
    from deflow_tpu_torch.trainer import make_eval_step

    ds = entry_dataset()
    cfg = {"batch_size": B, "num_workers": HOST_WORKERS, "voxel_size": VOXEL,
           "point_cloud_range": RANGE}
    step = make_eval_step(model)
    calls = []

    def eval_step(batch):
        calls.append(time.perf_counter())
        return step(batch)

    numpy_prep = lambda b: attach_host_prep(b, VOXEL, RANGE, backend="numpy")
    ways = {
        "a": ("numpy prep, no overlap", lambda: run_validation(
            eval_step, DataLoader(ds, B, prefetch=0, post_collate=numpy_prep),
            num_workers=HOST_WORKERS)),
        "b": ("C++ prep, no overlap", lambda: run_validation(
            eval_step, DataLoader(ds, B, prefetch=0, post_collate=_sorted_prep(cfg),
                                  num_workers=HOST_WORKERS),
            num_workers=HOST_WORKERS)),
        "c": ("C++ prep, loader prefetch + device_prefetch",
              lambda: run_validation(eval_step, ds, cfg)),
    }
    want = {name: 0 for name in _wrappers()}
    want.update(segment_sum=2 * ENTRY_BATCHES, sorted_gather=ENTRY_BATCHES,
                fused_gru=ENTRY_BATCHES, stem_fwd=3 * ENTRY_BATCHES)
    runs = {}
    for way in "abccba":
        torch.cuda.synchronize()
        reset_launches()
        calls.clear()
        t0 = time.perf_counter()
        metrics = ways[way][1]()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / ENTRY_BATCHES
        launches = read_launches()
        if launches != want:
            raise SystemExit(f"entry ({way}) launched {launches}, want {want}")
        period = float(np.median(np.diff(calls))) * 1e3
        runs.setdefault(way, []).append((ms, period, metrics))
    for way, (what, _) in ways.items():
        print(f"entry ({way}) {what}: " + "; ".join(
            f"{ms:.1f} ms per batch = {B / ms * 1e3:.2f} pairs/s, steady "
            f"{p:.1f} ms = {B / p * 1e3:.2f} pairs/s" for ms, p, _ in runs[way]))
    print(f"entry: eval step device median {device_median_ms:.3f} ms = "
          f"{B / device_median_ms * 1e3:.2f} pairs/s; launches per batch 2 / 1 / 1 / 3 "
          f"(segment_sum / sorted_gather / fused_gru / stem_fwd), {ENTRY_BATCHES} batches "
          f"of {B} x {N} slots, {HOST_WORKERS} host threads and metric processes")
    ref = runs["a"][0][2]
    worst = 0.0
    for way in "bc":
        for _, _, m in runs[way]:
            if m.keys() != ref.keys():
                raise SystemExit(f"entry ({way}) metrics have other keys")
            for k, v in m.items():
                if np.isnan(ref[k]) != np.isnan(v):
                    raise SystemExit(f"entry ({way}) {k}: {v} vs {ref[k]}")
                if not np.isnan(v):
                    worst = max(worst, abs(v - ref[k]) / max(abs(ref[k]), 1e-30))
    print(f"entry metrics (3-way and bucketed, {len(ref)} values): largest "
          f"relative difference of (b) and (c) from (a) {worst:.3e} (tol 1e-6)")
    if not worst <= 1e-6:
        raise SystemExit("the entry's metrics depend on the host prep or the overlap")
    # every entry batch's C++ prep, held against numpy bit for bit
    for k in range(ENTRY_BATCHES):
        held_prep(collate(ds[k * B:(k + 1) * B]))
    # the metric updates alone, per batch, serial on the host
    hb = collate(ds[:B])
    three, bucketed = ThreewayEPE(), BucketedEPE()
    t0 = time.perf_counter()
    for i in range(B):
        args = (hb["flow"][i] + 0.01, hb["flow"][i], hb["flow_category_indices"][i],
                hb["flow"][i] * 0.5, hb["pc0_mask"][i] & hb["eval_mask"][i])
        three.update(*args)
        bucketed.update(*args)
    print(f"entry: the 3-way and bucketed metric updates take "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms of host time per batch")
    return launches


def _wrappers():
    from deflow_tpu_torch.ops import cbg, gather, gru, nn, scatter, stem, sweep

    return {"segment_sum": scatter.sorted_segment_sum,
            "sorted_gather": gather.sorted_rows_gather,
            "fused_gru": gru.fused_gru, "fused_gru_bwd": gru.fused_gru_bwd,
            "cbg_fwd": cbg.cbg_block_fwd, "cbg_bwd": cbg.cbg_block_bwd,
            "segment_sum_lanes": scatter.segment_sum_lanes,
            "cell_sweep": sweep.cell_sweep, "chamfer_brute": nn.chamfer_min,
            "stem_fwd": stem.stem_fwd, "stem_dgrad": stem.stem_dgrad,
            "stem_wgrad": stem.stem_wgrad}


def reset_launches() -> None:
    for w in _wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def run_train_path(model, batches, loss_name="deflowLoss", label="train"):
    """Phases 5 and 6: ``make_train_step`` over the batches (one Adam step
    each); returns per-step aux, device ms per step and the launch counts."""
    import torch

    from deflow_tpu_torch.trainer import (SSL_TRAIN_KEYS, TRAIN_KEYS, device_batch,
                                          init_train_state, make_train_step)
    from deflow_tpu_torch.losses import SSL_LOSS_REGISTRY

    state = init_train_state(model, {"lr": LR, "optimizer": "adam"})
    train_step = make_train_step(model, loss_name)
    keys = SSL_TRAIN_KEYS if loss_name in SSL_LOSS_REGISTRY else TRAIN_KEYS
    device_batches = [device_batch(hb, keys=keys) for hb in batches]
    torch.cuda.synchronize()
    device_ms, auxes = [], []
    reset_launches()
    for db in device_batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, aux = train_step(state, db)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
        auxes.append({k: float(v) for k, v in aux.items()})
    launches = read_launches()
    for i, (a, ms) in enumerate(zip(auxes, device_ms)):
        print(f"{label} step {i + 1}: loss {a['loss']:.6f} epe {a['epe']:.6f} "
              f"grad_norm {a['grad_norm']:.6f} valid {a['valid_points']:.0f} "
              f"device {ms:.3f} ms")
    bad = [k for a in auxes for k, v in a.items() if not np.isfinite(v)]
    if bad or not all(torch.isfinite(p).all() for p in model.parameters()):
        raise SystemExit(f"{label} step gave non-finite values {bad}")
    profile_step(lambda: train_step(state, device_batches[0]), launches)
    return auxes, device_ms, launches


# the encoder stems' launches in bf16: an eval batch runs each of the three
# stems' forward, a train step adds its dgrad and wgrad (and under remat its
# forward once more); f32 takes F.conv2d
STEM_EVAL = {"stem_fwd": 3}
STEM_STEP = {"stem_fwd": 3, "stem_dgrad": 3, "stem_wgrad": 3}
NO_STEM = {"stem_fwd": 0, "stem_dgrad": 0, "stem_wgrad": 0}
# launches a train step without remat (phases 5 and 9)
PER_STEP = {"segment_sum": 3, "sorted_gather": 3, "fused_gru": 1, "fused_gru_bwd": 1,
            "cbg_fwd": 6, "cbg_bwd": 6, "segment_sum_lanes": 0, "cell_sweep": 0,
            "chamfer_brute": 0, **STEM_STEP}


# phase 5b: the train entry.  Steps an epoch at TRAIN_B, epochs, val
# batches of B, SeFlow steps, and the config's batch_size (probed for memory)
ENTRY_TRAIN_STEPS, ENTRY_EPOCHS, ENTRY_VAL_BATCHES, ENTRY_SSL_STEPS = 8, 2, 2, 6
CONFIG_BATCH = 16
# launches a train step with remat (the forward kernels twice) and an eval
# batch
REMAT_PER_STEP = {"segment_sum": 5, "sorted_gather": 4, "fused_gru": 2,
                  "fused_gru_bwd": 1, "cbg_fwd": 12, "cbg_bwd": 6,
                  "segment_sum_lanes": 0, "cell_sweep": 0, "chamfer_brute": 0,
                  "stem_fwd": 6, "stem_dgrad": 3, "stem_wgrad": 3}
PER_VAL_BATCH = {"segment_sum": 2, "sorted_gather": 1, "fused_gru": 1, **STEM_EVAL}
# the card's backward is not deterministic (the bilinear upsample's
# backward adds with atomics), so two runs of the same step or epoch differ
# in the last bits, which Adam carries on.  The resumed run and the remat
# step are held to SPREAD times that run-to-run difference, measured in the
# same call: a resume that lost the optimizer state or replayed an epoch,
# or a recompute that saw other values, differs by 30x and more
SPREAD = 4
REMAT_STATS_SHARE = 0.05

def entry_cfg(out: str, **kw):
    """The port's default config (the leaderboard DeFlow, bf16, remat) at
    this script's sizes, writing under ``out``; wandb off (``traced_fit``
    reads the logged records from the logger)."""
    from deflow_tpu_torch.config import compose

    over = {"batch_size": TRAIN_B, "epochs": ENTRY_EPOCHS, "lr": LR, "seed": 0,
            "num_workers": HOST_WORKERS, "max_points": N, "log_every": 4,
            "voxel_size": VOXEL, "point_cloud_range": RANGE,
            "model.target.grid_feature_size": LEADERBOARD["grid_feature_size"],
            "output_dir": out, "wandb_mode": "disabled"}
    over.update(kw)
    return compose("config", [f"{k}={v}".replace(" ", "") for k, v in over.items()])


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def traced_fit(cfg, train, val, label: str, per_step: dict,
               per_val: dict = PER_VAL_BATCH) -> tuple:
    """``entry.train.fit`` with the launches of each step and each
    validation sweep, and the host prep of each batch, recorded (the
    entry's ``make_train_step``, ``run_validation``, ``_sorted_prep`` and
    ``MetricLogger.log`` wrapped); every count set to 0 just before and read
    just after.  Exits unless every step launched ``per_step`` and every
    sweep ENTRY_VAL_BATCHES x ``per_val``.  Returns the fit's result
    (with the logged records as ``logged``, the host time of each step
    call as ``step_starts`` and each step's device ms, CUDA events around
    the step call, as ``device_ms``), the launches and the host prep ms of
    each batch."""
    import torch

    from deflow_tpu_torch.entry import train as TE

    steps, sweeps, prep_ms, logged = [], [], [], []
    orig = (TE.make_train_step, TE.run_validation, TE._sorted_prep, TE.MetricLogger)

    class Logger(orig[3]):
        def log(self, metrics, step=None):
            logged.append(dict(metrics))
            super().log(metrics, step)

    events, starts = [], []

    def make_train_step(*a, **k):
        step = orig[0](*a, **k)

        def counted(*sa):
            starts.append(time.perf_counter())
            before = read_launches()
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = step(*sa)
            ev[1].record()
            events.append(ev)
            steps.append(_delta(before, read_launches()))
            return out
        return counted

    def run_validation(*a, **k):
        before = read_launches()
        out = orig[1](*a, **k)
        sweeps.append(_delta(before, read_launches()))
        return out

    def sorted_prep(c):
        prep = orig[2](c)

        def timed(batch):
            t0 = time.perf_counter()
            out = prep(batch)
            prep_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    TE.make_train_step, TE.run_validation, TE._sorted_prep, TE.MetricLogger = (
        make_train_step, run_validation, sorted_prep, Logger)
    try:
        reset_launches()
        res = TE.fit(cfg, train, val, val_batch_size=B)
        launches = read_launches()
    finally:
        TE.make_train_step, TE.run_validation, TE._sorted_prep, TE.MetricLogger = orig
    torch.cuda.synchronize()
    res.logged = logged
    res.device_ms = [a.elapsed_time(b) for a, b in events]
    res.step_starts = starts
    want_step = {k: per_step.get(k, 0) for k in launches}
    want_val = {k: per_val.get(k, 0) * ENTRY_VAL_BATCHES for k in launches}
    bad = [d for d in steps if d != want_step] + [d for d in sweeps if d != want_val]
    print(f"{label}: {len(steps)} steps, {len(sweeps)} validation sweeps; launches "
          f"{launches}; per step {want_step if steps else None}, per eval batch "
          f"{per_val if sweeps else None}")
    total = {k: want_step[k] * len(steps) + want_val[k] * len(sweeps) for k in launches}
    if bad or launches != total:
        raise SystemExit(f"{label} launched {bad[:2] or launches}, want {want_step} a "
                         f"step and {want_val} a sweep")
    return res, launches, prep_ms


def entry_numbers(label: str, res, prep_ms: list, device_median_ms: float,
                  steps_per_epoch: int) -> float:
    """The steady period between step calls (median of the gaps within an
    epoch, the first gap of the run left out), the entry steps' device ms,
    the logged frames/s, the host prep of the run's batches and the stage
    timer, beside the device step median of the same path without remat
    (phase 5 or 6).  Returns the period in ms."""
    t = np.asarray(res.step_starts)
    gaps = [t[i + 1] - t[i] for i in range(1, len(t) - 1)
            if (i + 1) % steps_per_epoch]
    period = float(np.median(gaps)) * 1e3
    fps = [r["train/frames_per_sec"] for r in res.logged if "train/frames_per_sec" in r]
    stages = {k: (len(c.samples), c.mean * 1e3) for k, c in res.timer.children.items()}
    dev = float(np.median(res.device_ms[1:]))
    print(f"{label}: steady period {period:.1f} ms a step = {TRAIN_B / period * 1e3:.2f} "
          f"pairs/s; the entry's steps (remat) {dev:.3f} ms of device time (median, CUDA "
          f"events around each step call), against a device step median without remat of "
          f"{device_median_ms:.3f} ms ({TRAIN_B / device_median_ms * 1e3:.2f} pairs/s); "
          "logged train/frames_per_sec "
          + ", ".join(f"{f:.2f}" for f in fps)
          + f"; host prep (C++, pool of {HOST_WORKERS}) median "
          f"{float(np.median(prep_ms)):.1f} ms a batch (max {max(prep_ms):.1f}); stages "
          + ", ".join(f"{k} n={n} mean {ms:.1f} ms" for k, (n, ms) in stages.items()))
    return period


def _state_tensors(state) -> dict:
    """Every tensor of a train state: the model's state dict and the
    optimizer's per-parameter state, on the host."""
    out = {f"model.{k}": v.detach().cpu() for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"optimizer.{i}.{k}"] = v.detach().cpu()
    return out


def hold_round_trip(res, tmp: str) -> dict:
    """Save the run's final state, load it into a state built from another
    seed: every tensor (parameters, BN buffers, Adam moments and step) and
    the step bit for bit.  Returns the save and load ms."""
    import torch

    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import init_train_state, load_checkpoint, save_checkpoint

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(tmp, res.state, 7, name="round_trip")
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = init_train_state(build_model(LEADERBOARD, precision="bf16", seed=123),
                             {"lr": LR, "optimizer": "adam"})
    t0 = time.perf_counter()
    fresh, nxt = load_checkpoint(path, fresh)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    want, got = _state_tensors(res.state), _state_tensors(fresh)
    bad = sorted(set(want) ^ set(got)) + [
        k for k in set(want) & set(got)
        if not (want[k].dtype == got[k].dtype and torch.equal(want[k], got[k]))]
    size = os.path.getsize(path) / 2 ** 20
    print(f"checkpoint round trip: {len(want)} tensors ({size:.1f} MiB), "
          f"{'all bit-identical' if not bad else f'DIFFER: {bad[:5]}'}; step "
          f"{fresh.step} (want {res.state.step}), next epoch {nxt}; save "
          f"{save_ms:.1f} ms, load {load_ms:.1f} ms")
    if bad or fresh.step != res.state.step or nxt != 8:
        raise SystemExit("the checkpoint does not round-trip")
    return {"save_ms": save_ms, "load_ms": load_ms, "mib": size}


def _differences(a, b) -> dict:
    """Two train states: the last losses' difference and the largest
    difference of every floating tensor (parameters, BN buffers, Adam
    moments and steps), each over that tensor's largest magnitude, with the
    zero-gradient conv biases and their moments (rounding noise that the
    train-mode BN cancels) apart."""
    names = [k for k, _ in a.state.model.named_parameters()]
    ta, tb = _state_tensors(a.state), _state_tensors(b.state)
    worst = {"loss": abs(a.last_aux["loss"] - b.last_aux["loss"]),
             "tensors": (0.0, ""), "zero_grad_biases": (0.0, "")}
    for k, x in ta.items():
        if not x.is_floating_point():
            continue
        name = names[int(k.split(".")[1])] if k.startswith("optimizer.") else k[6:]
        d = ((x - tb[k]).abs().max() / x.abs().max().clamp(min=1e-30)).item()
        part = "zero_grad_biases" if _zero_grad_bias(name) else "tensors"
        worst[part] = max(worst[part], (d, k))
    return worst


def hold_resume(full, resumed, *others) -> None:
    """The run resumed from epoch_0.ckpt against the uninterrupted one after
    epoch 1, beside the card's spread: the largest difference between any
    two of the resumed runs (``resumed`` and ``others``, all from the same
    checkpoint).  The last loss, and every floating tensor's largest
    difference over its largest magnitude, each within SPREAD times the
    spread (plus 1e-7 of the loss); the steps equal.  The zero-gradient
    biases are printed, not held.  A single pair of runs estimates the
    spread of one scalar, the loss, poorly (two runs may agree to 1e-6 by
    chance where the uninterrupted one differs by 4e-5 in the same call),
    so every pair of three runs counts."""
    runs = (resumed,) + others
    pairs = [_differences(a, b) for i, a in enumerate(runs) for b in runs[i + 1:]]
    d = _differences(full, resumed)
    floor = {k: max(p[k] for p in pairs) for k in d}
    ok = (d["loss"] <= SPREAD * floor["loss"] + 1e-7 * abs(full.last_aux["loss"])
          and d["tensors"][0] <= SPREAD * floor["tensors"][0]
          and all(r.state.step == full.state.step for r in runs))
    print(f"resume: last loss {resumed.last_aux['loss']:.7f} against "
          f"{full.last_aux['loss']:.7f} uninterrupted (difference {d['loss']:.3e}; "
          f"{len(runs)} resumed runs, pairwise: "
          + ", ".join(f"{p['loss']:.3e}" for p in pairs)
          + f"); largest tensor difference over its largest "
          f"magnitude {d['tensors'][0]:.3e} in {d['tensors'][1]} (resumed runs "
          f"{floor['tensors'][0]:.3e} in {floor['tensors'][1]}; tol {SPREAD}x that); "
          f"zero-gradient biases {d['zero_grad_biases'][0]:.3e} ({floor['zero_grad_biases'][0]:.3e}); "
          f"step {resumed.state.step} against {full.state.step}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the resumed run does not agree with the uninterrupted one")


def step_peak(batch, remat: bool, seed: int = 11):
    """One train step of a fresh model (seed ``seed``) on ``batch``: the
    state after it, the aux, each parameter's gradient, the BN buffers
    before, and the peak memory above what was allocated before the step
    (GiB); (None, ..., 'does not fit') when the card runs out of memory."""
    import torch

    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import TRAIN_KEYS, device_batch, init_train_state, make_train_step

    model = build_model(LEADERBOARD, precision="bf16", seed=seed)
    state = init_train_state(model, {"lr": LR, "optimizer": "adam"})
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    db = device_batch(batch, keys=TRAIN_KEYS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        state, aux = make_train_step(model, "deflowLoss", remat=remat)(state, db)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        return None, None, None, before, "does not fit"
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    grads = {k: p.grad.detach().float().clone() for k, p in model.named_parameters()}
    return state, {k: float(v) for k, v in aux.items()}, grads, before, peak


def _grad_spread(a: dict, b: dict) -> tuple:
    """The largest difference of two steps' gradients over each parameter's
    largest gradient element (a zero-gradient conv bias: over its weight's),
    and its parameter."""
    return max(((g - b[k]).abs().max().item() / max(
        a[k[:-4] + "weight" if _zero_grad_bias(k) else k].abs().max().item(), 1e-30), k)
        for k, g in a.items())


def hold_remat(batch) -> dict:
    """Two bf16 steps without remat and one with, from the same state (seed
    11) and batch: the same loss (the forward kernels are deterministic);
    the remat step's gradients within SPREAD times the two plain steps'
    difference (``_grad_spread``), since the recompute feeds the backward
    the same forward values; every BN running statistic moved once: its
    difference from the plain step's value at most REMAT_STATS_SHARE of the
    plain step's move (a second momentum update would move it again by
    (1 − m) of that).  Returns the peak memory of each step (GiB above the
    state)."""
    plain, plain2 = step_peak(batch, remat=False), step_peak(batch, remat=False)
    remat = step_peak(batch, remat=True)
    grad, floor = _grad_spread(plain[2], remat[2]), _grad_spread(plain[2], plain2[2])
    sp, sr = plain[0].model.state_dict(), remat[0].model.state_dict()
    share = max(((sr[k] - sp[k]).abs().max() / (sp[k] - v).abs().max().clamp(min=1e-30)).item()
                for k, v in plain[3].items())
    moved = min((sp[k] - v).abs().max().item() for k, v in plain[3].items())
    ok = (remat[1]["loss"] == plain[1]["loss"] and grad[0] <= SPREAD * floor[0]
          and share <= REMAT_STATS_SHARE and moved > 0)
    print(f"remat against plain (one step, bf16, {TRAIN_B} x {N}): loss {remat[1]['loss']!r} "
          f"against {plain[1]['loss']!r}; largest gradient difference over the "
          f"parameter's largest {grad[0]:.3e} in {grad[1]} (two plain steps "
          f"{floor[0]:.3e} in {floor[1]}; tol {SPREAD}x that); BN running statistics: "
          f"largest difference {share:.3e} of the plain step's move (tol "
          f"{REMAT_STATS_SHARE:g}; every statistic moved, the least by {moved:.3e}); peak "
          f"memory of the step {remat[4]:.2f} GiB with remat, {plain[4]:.2f} GiB without: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the remat step disagrees with the plain step")
    return {"remat_gib": remat[4], "plain_gib": plain[4]}


def probe_config_batch() -> dict:
    """The peak memory of one step at the config's batch_size on one card
    (2B = 32: the 256 and 128 groups chained in bf16), with remat and
    without; 'does not fit' where the card runs out."""
    import torch

    from deflow_tpu_torch.data.host_prep import attach_host_prep

    batch = attach_host_prep(make_batch(600, b=CONFIG_BATCH), VOXEL, RANGE,
                             num_workers=HOST_WORKERS)
    out = {}
    for remat in (True, False):
        r = step_peak(batch, remat)
        out["remat_gib" if remat else "plain_gib"] = r[4]
        del r
        torch.cuda.empty_cache()
    show = lambda v: v if isinstance(v, str) else f"{v:.2f} GiB"
    print(f"batch_size {CONFIG_BATCH} on one card ({CONFIG_BATCH} x {N}, 2B = "
          f"{2 * CONFIG_BATCH}): peak memory of one step "
          f"{show(out['remat_gib'])} with remat, {show(out['plain_gib'])} without")
    return out


def run_train_entry(device_ms: dict, train_batch) -> dict:
    """Phase 5b: the train entry (``entry.train.fit``) over in-memory
    splits at TRAIN_B x N, the config's defaults (remat, bf16, Adam, the
    leaderboard DeFlow) but for the sizes: (a) deflowLoss, ENTRY_EPOCHS
    epochs of ENTRY_TRAIN_STEPS steps, each validated on ENTRY_VAL_BATCHES
    batches of B and checkpointed; (b1), (b2), (b3) resumed from (a)'s
    epoch_0.ckpt for its last epoch; (c) seflowLoss, one epoch of ENTRY_SSL_STEPS steps (the
    grid branch).  Launches per step and per eval batch, finite metrics,
    the resumed run against (a), the checkpoint round trip, remat against
    plain, the peak memory at TRAIN_B and at the config's batch_size.
    Returns the launches of (a) and (c)."""
    import shutil
    import tempfile

    import torch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        train = entry_dataset(range(700, 700 + ENTRY_TRAIN_STEPS), TRAIN_B)
        val = entry_dataset(range(800, 800 + ENTRY_VAL_BATCHES), B)
        full, launches, prep_ms = traced_fit(entry_cfg(os.path.join(tmp, "a")), train, val,
                                             "train entry (a)", REMAT_PER_STEP)
        ckpts = sorted(os.listdir(os.path.join(full.run_dir, "checkpoints")))
        print(f"train entry (a): checkpoints {ckpts}; val EPE_3way_mean "
              f"{full.metrics['EPE_3way_mean']:.6f}, Static_EPE_mean "
              f"{full.metrics['Static_EPE_mean']:.6f}, Dynamic_NormEPE_mean "
              f"{full.metrics['Dynamic_NormEPE_mean']:.6f}")
        if ckpts != ["best.ckpt", "epoch_0.ckpt", "epoch_1.ckpt"] or not all(
                np.isfinite(full.metrics[k]) for k in
                ("EPE_3way_mean", "Static_EPE_mean", "Dynamic_NormEPE_mean")):
            raise SystemExit("the train entry wrote other checkpoints or non-finite metrics")
        period = entry_numbers("train entry (a)", full, prep_ms, device_ms["train"],
                               ENTRY_TRAIN_STEPS)
        resumed = [traced_fit(entry_cfg(os.path.join(tmp, f"b{i}"), resume=os.path.join(
            full.run_dir, "checkpoints", "epoch_0.ckpt")), train, val,
            f"train entry (b{i}), resumed", REMAT_PER_STEP)[0] for i in (1, 2, 3)]
        hold_resume(full, *resumed)
        ckpt = hold_round_trip(full, tmp)
        ckpt["fit_ckpt_ms"] = [s * 1e3 for s in full.timer.child("ckpt").samples]
        print("train entry (a): checkpoint stage ms (best, epoch) "
              + ", ".join(f"{ms:.1f}" for ms in ckpt["fit_ckpt_ms"]))
        del resumed
        ssl_train = entry_dataset(range(900, 900 + ENTRY_SSL_STEPS), TRAIN_B, dufo=True)
        ssl, ssl_launches, ssl_prep = traced_fit(
            entry_cfg(os.path.join(tmp, "c"), loss_fn="seflowLoss", epochs=1),
            ssl_train, None, "train entry (c), seflowLoss",
            {**REMAT_PER_STEP, "cell_sweep": 2, "segment_sum_lanes": 1})
        if not np.isfinite(ssl.last_aux["loss"]):
            raise SystemExit("the SeFlow train entry gave a non-finite loss")
        entry_numbers("train entry (c), seflowLoss", ssl, ssl_prep, device_ms["ssl"],
                      ENTRY_SSL_STEPS)
        del full, ssl
        torch.cuda.empty_cache()
        mem = {"at_train_b": hold_remat(train_batch), "at_config_batch": probe_config_batch()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "ssl_launches": ssl_launches, "checkpoint": ckpt,
            "memory": mem, "period_ms": period}



# phase 8: the rest of the model.  Batches (eval) or steps (train) of each
# of its four paths, at full width
REST_STEPS = 3
MMHEAD = dict(LEADERBOARD, decoder_option="mmhead")
MMHEAD_CHUNK = 512
# launches a train step of the MMHead model (the train path's, without the
# GRU) and of the num_frames=3 model (the history frame's device path:
# centroid segment-sum + gather back, feature segment-sum, and the latter's
# backward gather), and an eval batch without host prep (per cloud the
# centroid segment-sum, its gather back and the feature segment-sum)
MMHEAD_PER_STEP = {"segment_sum": 3, "sorted_gather": 3, "fused_gru": 0,
                   "fused_gru_bwd": 0, "cbg_fwd": 6, "cbg_bwd": 6, **STEM_STEP}
HISTORY_PER_STEP = {"segment_sum": 5, "sorted_gather": 5, "fused_gru": 1,
                    "fused_gru_bwd": 1, "cbg_fwd": 6, "cbg_bwd": 6, **STEM_STEP}
DEVICE_EVAL_PER_BATCH = {"segment_sum": 4, "sorted_gather": 3, "fused_gru": 1, **STEM_EVAL}
MMHEAD_EVAL_PER_BATCH = {"segment_sum": 2, "sorted_gather": 1, **STEM_EVAL}


def with_history(hb: dict, seed: int) -> dict:
    """``hb`` plus one history frame as the loader emits it for
    num_frames=3 (``pch1``: pc0 one sweep earlier, the ego 1.3 m back)."""
    rng = np.random.default_rng(seed)
    pose = hb["pose0"].copy()
    pose[:, 0, 3] -= 1.3
    pch = hb["pc0"] - hb["flow"] + rng.normal(0, 0.02, hb["pc0"].shape)
    hb.update(pch1=np.where(hb["pc0_mask"][..., None], pch, 0).astype(np.float32),
              pch1_mask=hb["pc0_mask"].copy(), pose_pch1=pose)
    return hb


def device_plan(db, cfg):
    """pc0's device binning and sort, as the embedder's device path makes
    them (the points in the batch's own order)."""
    from deflow_tpu_torch.ops import voxel
    from deflow_tpu_torch.ops.pose import cal_pose0to1, transform_points

    tpc0 = transform_points(db["pc0"].float(), cal_pose0to1(db["pose0"].float(),
                                                            db["pose1"].float()))
    info = voxel.compute_pillar_info(tpc0, db["pc0_mask"], cfg)
    return info, voxel.make_batched_scatter_plan(info.pillar_id,
                                                 cfg.num_pillars + voxel.TRASH_PAD)


def check_new_patterns(model, raw_batch) -> dict:
    """Phase 3b: the kernels on the call patterns of the device binning
    path, at the eval path's shapes (4 x 98,304, the points in their own
    order): the segment-sum on a device sort's ids, 4 bf16 lanes (the
    centroids) and 33 (the features), after a check that the plan ascends
    within each sample, sentinels last; the row gather at unsorted flat ids
    (the centroids' gather back, the planned scatter's backward, the
    decoder's gather).  Returns the measurements by kernel."""
    import torch

    from deflow_tpu_torch.ops import voxel
    from deflow_tpu_torch.trainer import device_batch

    dev = torch.device("cuda")
    cfg = model.voxel_cfg
    p = cfg.num_pillars
    db = device_batch(raw_batch, dev)
    info, plan = device_plan(db, cfg)
    check_plan("(device sort)", plan.sorted_ids, plan.num_rows, B)
    g = torch.Generator(device=dev).manual_seed(1)
    data4 = torch.cat([info.offsets, info.valid.float()[..., None]], dim=-1)
    data4 = data4.reshape(-1, 4).index_select(0, plan.order)
    seg = {"device_sorted_4_lanes": hold_segment_sum(
               "(device sort, 4 lanes: the centroids)", data4, plan.sorted_ids,
               plan.num_rows, B),
           "device_sorted_33_lanes": hold_segment_sum(
               "(device sort, 33 lanes: the features)",
               pillar_feats(plan.sorted_ids, plan.num_rows, g), plan.sorted_ids,
               plan.num_rows, B)}
    boff = (torch.arange(B, dtype=torch.int32, device=dev) * p)[:, None]
    dec_ids = torch.where(info.valid, info.pillar_id + boff, voxel.GATHER_SENTINEL)
    gat = {"unsorted_4_lanes": hold_gather(     # an f32 table, as the model's
               "(unsorted ids: the centroids' gather back)",
               torch.randn(plan.num_rows, 4, generator=g, device=dev), plan.flat_ids,
               plan.num_rows, timed=torch.float32),
           "unsorted_33_lanes": hold_gather(
               "(unsorted ids: the planned scatter's backward)",
               torch.randn(plan.num_rows, 33, generator=g, device=dev), plan.flat_ids,
               plan.num_rows),
           "unsorted_128_lanes": hold_gather(
               "(unsorted ids: the decoder)",
               torch.randn(B * p, 128, generator=g, device=dev),
               dec_ids.reshape(-1).to(torch.int32), B * p)}
    for what, r in list(seg.items()) + list(gat.items()):
        print(f"{what} {r['shape']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms)")
    return {"segment_sum": seg, "sorted_gather": gat}


def _timed_steps(run, items, check):
    """``run(item)`` for each item under CUDA events; ``check(out)`` on
    each output.  Returns the outputs' checks and the device ms."""
    import torch

    ms, res = [], []
    for it in items:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(it)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        res.append(check(out))
    return res, ms


def _want(per: dict, n: int) -> dict:
    return {k: per.get(k, 0) * n for k in read_launches()}


def attention_library(out_valid) -> dict:
    """The MMHead's attention at the eval path's shapes (4 x 98,304 points:
    768 chunks of 512, 4 heads of 32, bf16, the keys masked as the batch's
    valid counts mask them): the port's (``models.decoder.masked_attention``,
    plain PyTorch ops, the counterpart of the JAX package's XLA attention)
    against ``F.scaled_dot_product_attention`` with the boolean key mask, on
    the chunks with a valid key (SDPA's all-masked rows are NaN)."""
    import torch
    import torch.nn.functional as F

    from deflow_tpu_torch.models.decoder import masked_attention

    dev = torch.device("cuda")
    counts = out_valid.sum(dim=1, keepdim=True)
    key_mask = (torch.arange(N, device=dev)[None, :] < counts).reshape(-1, MMHEAD_CHUNK)
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(key_mask.shape[0], 4, MMHEAD_CHUNK, 32, generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    ours = lambda: masked_attention(q, k, v, key_mask)
    lib = lambda: F.scaled_dot_product_attention(q, k, v,
                                                 attn_mask=key_mask[:, None, None, :])
    live = key_mask.any(dim=1)
    a, b = ours(), lib()
    torch.cuda.synchronize()
    err = (a[live].float() - b[live].float()).abs().max().item()
    dead_finite = bool(torch.isfinite(a[~live]).all())
    gch, heads, l, d = q.shape
    b_ms, b_by = bound(4 * gch * heads * l * d * 2 + key_mask.numel(),
                       4.0 * gch * heads * l * l * d, BF16_FLOP_PER_S)
    r = {"shape": f"{gch}x{heads}x{l}x{d}", "chunks_all_masked": int((~live).sum()),
         "max_abs_err_vs_sdpa": err, "all_masked_rows_finite": dead_finite,
         "ms": cuda_ms(ours, 10), "library_ms": cuda_ms(lib, 10),
         "bound_ms": b_ms, "bound_by": b_by}
    print(f"mmhead attention {r['shape']} bf16 ({r['chunks_all_masked']} chunks all "
          f"masked, finite there: {dead_finite}): port {r['ms']:.4f} ms, "
          f"scaled_dot_product_attention {r['library_ms']:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by}; max |d| on the chunks with a valid key {err:.3e}")
    if not dead_finite:
        raise SystemExit("the MMHead attention is not finite on all-masked chunks")
    return r


def hold_device_path(raw_batch, prepped_batch, bf16_model, bf16_out) -> dict:
    """Path (d) against the host-prep eval of the same batch: in f32 the
    device path on the host's compensated points (so both bin the same
    points) within 2e-4 of the host-prep eval, the validity masks equal;
    in bf16 the device path's eval of the raw batch against the host-prep
    eval, unsorted to the batch's order (the difference printed: the two
    paths compute the centroid differently, and the device path
    compensates pc0 in f32 on the card, the host in f64)."""
    import torch

    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import device_batch, make_eval_step

    m32 = build_model(LEADERBOARD, precision="fp32", seed=0)
    m32.load_state_dict(bf16_model.state_dict())
    db = device_batch(prepped_batch)
    hosted = make_eval_step(m32)(db)
    with torch.inference_mode():
        dev_out = m32(db["pc0"], db["pc1"], db["pose0"], db["pose1"], db["pc0_mask"],
                      db["pc1_mask"], host_prep={"pc0_transformed": db["pc0_transformed"]})
    same_valid = torch.equal(dev_out["pc0_valid"], hosted["pc0_valid"])
    err32 = (dev_out["flow"] - hosted["net_flow"]).abs().max().item()
    print(f"device path vs host prep (f32, 4 x {N:,}): validity "
          f"{'equal' if same_valid else 'DIFFERS'}, max |d flow| {err32:.3e} (tol 2e-4)")
    if not (same_valid and err32 < 2e-4):
        raise SystemExit("the device path disagrees with the host-prep eval in f32")
    del m32
    hb16 = make_eval_step(bf16_model)(db)
    unsort = torch.from_numpy(prepped_batch["pc0_unsort"]).long().cuda()
    back = torch.gather(hb16["pred_flow"], 1, unsort[..., None].expand(-1, -1, 3))
    valid_back = torch.gather(hb16["pc0_valid"], 1, unsort)
    both = valid_back & bf16_out["pc0_valid"]
    d16 = (back - bf16_out["pred_flow"]).norm(dim=-1)[both]
    flips = int((valid_back != bf16_out["pc0_valid"]).sum())
    r = {"f32_max_abs_err": err32, "bf16_max_abs_diff": d16.max().item(),
         "bf16_mean_abs_diff": d16.mean().item(), "bf16_validity_flips": flips}
    print(f"device path vs host prep (bf16, the raw batch): |d pred_flow| max "
          f"{r['bf16_max_abs_diff']:.3e} m, mean {r['bf16_mean_abs_diff']:.3e} m over "
          f"{int(both.sum())} points; points valid on one path only: {flips}")
    return r


def run_rest_of_model(model, eval_batches, train_batches) -> dict:
    """Phase 8: (a) the MMHead eval, (b) the MMHead deflowLoss step with
    dropout, (c) the num_frames=3 deflowLoss step (ConvGRU head, one history
    frame on the device path) and (d) the eval without host prep, each at
    full width with its launch counts held; peak memory of (a) and (b)
    above what was allocated before; the MMHead attention against
    scaled_dot_product_attention; (d) held against the host-prep eval."""
    import torch

    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import (TRAIN_KEYS, device_batch, init_train_state,
                                          make_eval_step, make_train_step)

    out = {}

    def finite_eval(o):
        for k, v in o.items():
            if v.shape[:2] != (B, N) or (v.is_floating_point()
                                         and not torch.isfinite(v).all()):
                raise SystemExit(f"eval output {k} not finite / wrong shape")
        return o["pc0_valid"]

    def finite_step(res):
        aux = {k: float(v) for k, v in res[1].items()}
        if not all(np.isfinite(v) for v in aux.values()):
            raise SystemExit(f"a train step gave non-finite values {aux}")
        return aux

    def path(label, per, n, run, items, check):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        res, ms = _timed_steps(run, items, check)
        launches = read_launches()
        want = _want(per, n)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        med = float(np.median(ms[1:]))
        print(f"{label}: device ms " + ", ".join(f"{t:.3f}" for t in ms)
              + f"; steady median {med:.3f} ms; peak memory {peak:.2f} GiB above "
              f"the {base / 2 ** 30:.2f} GiB before; launches {launches} (want {want})")
        if launches != want:
            raise SystemExit(f"{label} did not launch every kernel as expected")
        out[label] = {"device_ms": ms, "median_ms": med, "peak_gib": peak,
                      "launches": launches}
        return res

    # (a) the MMHead eval, host-sorted batches
    mm = build_model(MMHEAD, precision="bf16", seed=0)
    step = make_eval_step(mm)
    dbs = [device_batch(hb) for hb in eval_batches[:REST_STEPS]]
    valid = path("(a) mmhead eval", MMHEAD_EVAL_PER_BATCH, REST_STEPS, step, dbs,
                 finite_eval)
    profile_step(lambda: step(dbs[0]), out["(a) mmhead eval"]["launches"])
    out["attention"] = attention_library(valid[0])
    del dbs

    # (b) the MMHead deflowLoss step, dropout on
    state = init_train_state(mm, {"lr": LR, "optimizer": "adam"})
    tstep = make_train_step(mm, "deflowLoss")
    tdbs = [device_batch(hb, keys=TRAIN_KEYS) for hb in train_batches[:REST_STEPS]]
    auxes = path("(b) mmhead train", MMHEAD_PER_STEP, REST_STEPS,
                 lambda db: tstep(state, db), tdbs, finite_step)
    if not all(torch.isfinite(p.grad).all() for p in mm.parameters() if p.grad is not None):
        raise SystemExit("the MMHead train step gave non-finite gradients")
    print("(b) mmhead train: " + "; ".join(
        f"loss {a['loss']:.6f} grad_norm {a['grad_norm']:.6f}" for a in auxes))
    profile_step(lambda: tstep(state, tdbs[0]), out["(b) mmhead train"]["launches"])
    del state, tstep, mm
    torch.cuda.empty_cache()

    # (c) the num_frames=3 deflowLoss step, the ConvGRU head
    hm = build_model(LEADERBOARD, precision="bf16", seed=0, num_frames=3)
    state = init_train_state(hm, {"lr": LR, "optimizer": "adam"})
    tstep = make_train_step(hm, "deflowLoss")
    hdbs = [device_batch(with_history(dict(hb), 600 + i), keys=TRAIN_KEYS)
            for i, hb in enumerate(train_batches[:REST_STEPS])]
    auxes = path("(c) num_frames=3 train", HISTORY_PER_STEP, REST_STEPS,
                 lambda db: tstep(state, db), hdbs, finite_step)
    print("(c) num_frames=3 train: " + "; ".join(
        f"loss {a['loss']:.6f} grad_norm {a['grad_norm']:.6f}" for a in auxes))
    del state, tstep, hm, tdbs, hdbs
    torch.cuda.empty_cache()

    # (d) the eval without host prep: raw batches, the points in their order
    step = make_eval_step(model)
    raws = [make_batch(100 + i) for i in range(REST_STEPS)]
    rdbs = [device_batch(hb) for hb in raws]
    outs = path("(d) eval without host prep", DEVICE_EVAL_PER_BATCH, REST_STEPS,
                lambda db: step(db), rdbs, lambda o: (finite_eval(o), o)[1])
    out["device_vs_host"] = hold_device_path(raws[0], eval_batches[0], model, outs[0])
    return out


def _category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("cell_sweep", ("cell_sweep",)),
                      ("segment_sum_lanes", ("lane_sum",)),
                      ("chamfer_brute", ("chamfer_brute",)),
                      ("sort/unsort (torch.sort, searchsorted, index writes)",
                       ("sort", "searchsorted", "index_put", "fill_index_and_segment")),
                      ("fused_gru_bwd", ("gru_bwd", "reduce_partials")),
                      ("cbg_fwd", ("cbg_fwd",)),
                      ("cbg_bwd", ("cbg_dgrad", "cbg_wgrad", "wgrad_reduce")),
                      ("segment_sum", ("segment_sum",)),
                      ("sorted_gather", ("rows_kernel", "chunk_kernel")),
                      ("fused_gru", ("gru_fwd",)),
                      ("stem", ("stem_conv", "stem_wgrad", "stem_wsum")),
                      ("conv/matmul (cuDNN, cuBLAS)",
                       ("conv", "cudnn", "xmma", "fprop", "implicit",
                        "winograd", "gemm")),
                      ("copy/memset", ("memcpy", "memset"))):
        if any(k in n for k in keys):
            return cat
    return "other (elementwise, cat, permute, interpolate, optimizer)"


def profile_step(step, launched: dict) -> dict:
    """Two more steps (``step()``, its batch already on the card) under
    torch.profiler, the second read (the profiler can miss the first
    kernels it traces); device time by kernel category and name, and the
    device's idle share of the step.  Exits if the profiler recorded no
    device time, or a segment-sum kernel that the path ``launched`` shows
    none in its category."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
        with record_function("profiled step"):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    begin = min(e.time_range.start for e in events if e.name == "profiled step")
    # annotation ranges (e.g. "Optimizer.step#Adam.step") span kernels that
    # are listed on their own; counting them too would count time twice
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.time_range.start >= begin
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("Optimizer."))
    if not spans:
        raise SystemExit("profile: the profiler recorded no device time")
    by_name, by_cat = {}, {}
    busy, cur_end = 0.0, -1.0
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
        cat = _category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + (end - start) / 1e3
        busy += max(0.0, end - max(start, cur_end)) / 1e3
        cur_end = max(cur_end, end)
    print(f"profile: step wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall_ms:.3f}, {len(spans)} device ops")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {cat}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:9.3f} ms  {name[:110]}")
    for name in ("segment_sum", "segment_sum_lanes"):
        if launched[name] and not by_cat.get(name):
            raise SystemExit(f"profile: the path launched {name}, but its category "
                             "shows no device time")
    return {"wall_ms": wall_ms, "busy_ms": busy, "ops": len(spans), "by_name": by_name,
            "by_category": by_cat}


def reference_check(seed: int, model_cfg=None, hosted: bool = True,
                    scatter_mode: str = "avg", batch=(2, 4096, 3500)) -> float:
    """Phase 7a: f32 model on a small input, card vs CPU; max |Δ pred_flow|.
    ``model_cfg`` overrides the small model's keys (the MMHead; the 0.1 m
    voxel and its 1024^2 grid); ``hosted=False`` evaluates the raw batch
    (the device binning path); ``scatter_mode="max"`` gives the embedder the
    max scatter; ``batch`` is (samples, slots, valid slots)."""
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import make_eval_step

    small = {**LEADERBOARD, "voxel_size": [1.6, 1.6, 6.0],
             "grid_feature_size": [64, 64], **(model_cfg or {})}
    b, n, valid = batch
    hb = make_batch(seed, b=b, n=n, valid=valid)
    if hosted:
        hb, _ = held_prep(hb, small["voxel_size"])
    outs = []
    for dev in ("cuda", "cpu"):
        model = build_model(small, precision="fp32", device=dev, seed=seed)
        model.embedder.scatter_mode = scatter_mode
        outs.append(make_eval_step(model, device=dev)(hb)["pred_flow"].cpu())
    return (outs[0] - outs[1]).abs().max().item()


def _zero_grad_bias(key: str) -> bool:
    """A conv bias before a train-mode BN: its gradient is zero in exact
    arithmetic, so card and CPU each hold rounding noise."""
    return key.startswith("backbone.encoder_step_") and key.endswith("conv.bias")


def train_reference_check(seed: int, loss_name: str = "deflowLoss",
                          grid: bool = False, model_cfg=None,
                          num_frames: int = 2, opt=None) -> dict:
    """Phase 7b: one f32 train step of ``loss_name`` on a small input (64^2
    grid, 2 x 4,096 slots), card vs CPU; for seflowLoss with ``grid`` the
    chamfer's pair threshold is lowered so that the small clouds take the
    grid branch (the sweep and the lane segment-sum), else the brute
    branch.  Returns each quantity's largest difference over its tolerance
    (<= 1 passes): loss and grad_norm 1e-4 relative; each parameter's
    gradient 1e-3 of its largest CPU element (a zero-gradient conv bias:
    both sides below 1e-3 of the largest gradient of the conv's weight);
    parameters after the Adam step 1e-6 + lr*1e-2, since Adam's first step
    is +-lr for any gradient that is not tiny this checks the signs, and
    2*lr for the zero-gradient biases; the BN running statistics 1e-5.
    The caller holds the parameters for deflowLoss only: Adam's first step
    maps a gradient element near its eps (1e-8) to anywhere in [-lr, lr],
    so a gradient difference far inside the gradient tolerance moves such
    an element's step past 1e-6 + lr*1e-2; the gradient of the element
    farthest off is printed beside it.  ``model_cfg`` overrides the
    model's keys (the MMHead, whose dropout is set to 0 on both sides: the
    card's and the CPU's generators draw other masks); ``num_frames=3``
    adds a history frame; ``opt`` overrides the optimizer keys (``lr``,
    ``optimizer``, ``gradient_clip``; Adam at LR by default), and the
    parameters' tolerance takes its lr."""
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.ops import chamfer
    from deflow_tpu_torch.trainer import init_train_state, make_train_step

    small = dict(LEADERBOARD, voxel_size=[1.6, 1.6, 6.0],
                 grid_feature_size=[64, 64], **(model_cfg or {}))
    hb, _ = held_prep(make_batch(seed, b=2, n=4096, valid=3500,
                                 dufo=loss_name != "deflowLoss"), small["voxel_size"])
    if num_frames == 3:
        hb = with_history(hb, seed)
    auxes, grads, states = [], [], []
    threshold = chamfer._AUTO_GRID_PAIRS
    chamfer._AUTO_GRID_PAIRS = 0 if grid else threshold
    try:
        for dev in ("cuda", "cpu"):
            model = build_model(small, precision="fp32", device=dev, seed=seed,
                                num_frames=num_frames)
            if hasattr(model.head, "pts_off_transformer"):
                for layer in model.head.pts_off_transformer.layers:
                    layer.dropout = 0.0
            state = init_train_state(model, {"lr": LR, **(opt or {})}, device=dev)
            state, aux = make_train_step(model, loss_name, device=dev)(state, hb)
            auxes.append({k: float(v) for k, v in aux.items()})
            grads.append({k: p.grad.detach().cpu() for k, p in model.named_parameters()})
            states.append({k: v.detach().cpu() for k, v in model.state_dict().items()})
    finally:
        chamfer._AUTO_GRID_PAIRS = threshold
    ratio, worst = step_ratios(auxes, grads, states, (opt or {}).get("lr", LR))
    print(f"  {loss_name}: the parameter farthest off is an element of {worst[0]}, "
          f"whose CPU gradient is {worst[1]:.3e} (Adam's eps 1e-8); CPU grad_norm "
          f"{auxes[1]['grad_norm']:.6f}")
    clip = (opt or {}).get("gradient_clip", 0.0)
    if clip and not auxes[1]["grad_norm"] > clip:
        raise SystemExit(f"the clip {clip} does not act on a step of norm "
                         f"{auxes[1]['grad_norm']}")
    return ratio


def step_ratios(auxes, grads, states, lr: float = LR):
    """Two runs of one f32 train step (the second the reference), each
    quantity's largest difference over its tolerance (train_reference_check's
    tolerances at learning rate ``lr``), and the parameter element farthest
    off with its reference gradient."""
    ratio = {k: abs(auxes[0][k] - auxes[1][k]) / abs(auxes[1][k]) / 1e-4
             for k in ("loss", "grad_norm")}
    ratio["grad"] = ratio["param"] = 0.0
    for key, ref in grads[1].items():
        if _zero_grad_bias(key):
            scale = grads[1][key[:-4] + "weight"].abs().max().item()
            err = max(grads[0][key].abs().max().item(), ref.abs().max().item())
        else:
            scale = ref.abs().max().item()
            err = (grads[0][key] - ref).abs().max().item()
        ratio["grad"] = max(ratio["grad"], err / (1e-3 * scale))
    worst = ("", 0.0)     # the parameter element farthest off, and its gradient
    for key, ref in states[1].items():
        if "num_batches" in key:
            continue
        if "running" in key:
            tol = 1e-5
        elif _zero_grad_bias(key):
            tol = 2 * lr
        else:
            tol = 1e-6 + lr * 1e-2
        off = (states[0][key] - ref).abs().flatten() / tol
        if off.max().item() > ratio["param"]:
            ratio["param"] = off.max().item()
            g = grads[1].get(key)
            worst = (key, float("nan") if g is None else g.flatten()[off.argmax()].item())
    return ratio, worst


# phase 9: data parallelism.  Steps of each DP run; the small f32 check's
# model (train_reference_check's: 64^2 grid, 2 x 4,096 slots a rank) and
# the seeds of its global batches (2 rows a rank)
DP_STEPS = 3
DP_SMALL = dict(LEADERBOARD, voxel_size=[1.6, 1.6, 6.0], grid_feature_size=[64, 64])
DP_N, DP_VALID, DP_VALID_RANK1 = 4096, 3500, 1500
DP_RUNS = ("deflow", "seflow grid", "seflow brute", "full")


def dp_batch(seed: int, dufo: bool = False) -> dict:
    """A global batch of two ranks' rows (2 each) at DP_N slots whose shards
    differ: rank 0's rows have DP_VALID valid points and only the ego flow
    (the deflow loss's slow bucket), rank 1's DP_VALID_RANK1 and moving
    points (its fast bucket too); with ``dufo``, 15% DUFO-dynamic points on
    rank 0 and 45% on rank 1."""
    hb = make_batch(seed, b=4, n=DP_N, valid=DP_VALID, dufo=dufo)
    ego = np.linalg.inv(hb["pose1"][0].astype(np.float64)) @ hb["pose0"][0]
    still = hb["pc0"][:2] @ ego[:3, :3].T.astype(np.float32) + ego[:3, 3].astype(np.float32)
    hb["flow"][:2] = np.where(hb["pc0_mask"][:2, :, None], still - hb["pc0"][:2], 0.0)
    for k in ("pc0_mask", "pc1_mask", "flow_is_valid"):
        hb[k][2:, DP_VALID_RANK1:] = False
    for k in ("pc0", "pc1", "flow"):
        hb[k][2:, DP_VALID_RANK1:] = 0.0
    if dufo:
        rng = np.random.default_rng(seed + 1)
        for k in ("dufo_label0", "dufo_label1"):
            hb[k][2:] = (rng.random((2, DP_N)) < 0.45).astype(np.int32)
    return hb


def _own_rows(hb: dict) -> dict:
    """This rank's rows of a global host batch (all of them without a
    process group)."""
    from deflow_tpu_torch import dist

    b = len(hb["pc0"]) // dist.world()
    return {k: v[dist.rank() * b:(dist.rank() + 1) * b] for k, v in hb.items()}


def _digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class CollectiveClock:
    """Within this context, the host time of every ``all_reduce`` of
    ``torch.distributed`` after a ``torch.cuda.synchronize()`` (so that a
    gloo call's wait holds the collective alone, not the compute queued
    before it; a nccl call's holds its launch), with its bytes."""

    def __enter__(self):
        import torch
        import torch.distributed as tdist

        self.calls, self._orig = [], tdist.all_reduce

        def timed(t, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(t, *a, **k)
            torch.cuda.synchronize()
            self.calls.append(((time.perf_counter() - t0) * 1e3,
                               t.numel() * t.element_size()))
            return out

        tdist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist

        tdist.all_reduce = self._orig

    def summary(self) -> dict:
        """Calls, host ms in all, and the largest call's ms and bytes (the
        gradient buffer)."""
        ms, nbytes = max(self.calls, key=lambda c: c[1])
        return {"calls": len(self.calls), "ms": sum(c[0] for c in self.calls),
                "largest_ms": ms, "largest_bytes": nbytes}


def dp_train(model_cfg: dict, precision: str, hbs: list, loss_name: str,
             grid: bool = False, keep: bool = False, workers: int = HOST_WORKERS,
             clock: bool = False) -> dict:
    """Adam steps of ``loss_name`` (lr LR, no remat) on this rank's rows of
    each global host batch, prepped on this rank (the C++ prep over
    ``workers`` threads); ``grid`` lowers the SeFlow chamfer's pair
    threshold so that the small clouds take the grid branch.  Returns each
    step's aux and device ms (CUDA events around the step call) and a
    digest of the parameters and buffers after each step; with ``keep`` the
    first step's gradients and the state after the last, on the host; with
    ``clock`` the last step's collectives (``CollectiveClock``, left out
    of the step times)."""
    import contextlib

    import torch

    from deflow_tpu_torch.data.host_prep import attach_host_prep
    from deflow_tpu_torch.losses import SSL_LOSS_REGISTRY
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.ops import chamfer
    from deflow_tpu_torch.trainer import (SSL_TRAIN_KEYS, TRAIN_KEYS, device_batch,
                                          init_train_state, make_train_step)

    model = build_model(model_cfg, precision=precision, seed=7)
    state = init_train_state(model, {"lr": LR})
    step = make_train_step(model, loss_name)
    keys = SSL_TRAIN_KEYS if loss_name in SSL_LOSS_REGISTRY else TRAIN_KEYS
    out = {"aux": [], "ms": [], "digests": []}
    threshold = chamfer._AUTO_GRID_PAIRS
    chamfer._AUTO_GRID_PAIRS = 0 if grid else threshold
    try:
        for i, hb in enumerate(hbs):
            db = device_batch(attach_host_prep(_own_rows(hb), model_cfg["voxel_size"],
                                               RANGE, num_workers=workers), keys=keys)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            timed = clock and i == len(hbs) - 1
            with CollectiveClock() if timed else contextlib.nullcontext() as c:
                ev[0].record()
                state, aux = step(state, db)
                ev[1].record()
                ev[1].synchronize()
            if timed:
                out["collectives"] = c.summary()
            else:
                out["ms"].append(ev[0].elapsed_time(ev[1]))
            out["aux"].append({k: float(v) for k, v in aux.items()})
            if keep and i == 0:
                out["grads"] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
            out["digests"].append(_digest(model))
    finally:
        chamfer._AUTO_GRID_PAIRS = threshold
    if keep:
        out["state"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return out


def dp_eval(model_cfg: dict, precision: str, hb: dict, workers: int = HOST_WORKERS):
    """The eval step (seeded weights) on this rank's rows of ``hb``; every
    rank's ``pred_flow`` gathered in rank order, on the host."""
    from deflow_tpu_torch import dist
    from deflow_tpu_torch.data.host_prep import attach_host_prep
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import make_eval_step

    model = build_model(model_cfg, precision=precision, seed=7)
    out = make_eval_step(model)(attach_host_prep(_own_rows(hb), model_cfg["voxel_size"],
                                                 RANGE, num_workers=workers))
    return dist.gather_rows(out["pred_flow"].float()).cpu()


def dp_rank() -> dict:
    """Phase 9 on one rank of two sharing the card over gloo: (a) the small
    f32 runs (deflowLoss; seflowLoss on its grid branch and on its brute
    branch), each DP_STEPS steps, then the leaderboard bf16 deflowLoss run
    at full width (TRAIN_B x N a rank), with its launch-counter deltas;
    (c) the DP eval, f32 on the small model, bf16 on the leaderboard model
    at B x N, and ``dp_validation``.  The full-width run takes one more step, whose collectives
    are clocked.  Each rank takes half of the host's prep threads.  TF32 off,
    as in ``main``: a spawned rank starts with torch's defaults."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workers = max(1, HOST_WORKERS // 2)
    res = {}
    reset_launches()
    for name, loss_name, grid, dufo, seed in (("deflow", "deflowLoss", False, False, 40),
                                              ("seflow grid", "seflowLoss", True, True, 50),
                                              ("seflow brute", "seflowLoss", False, True, 60)):
        res[name] = dp_train(DP_SMALL, "fp32", [dp_batch(seed + i, dufo)
                                                for i in range(DP_STEPS)],
                             loss_name, grid=grid, keep=True, workers=workers)
        res[name]["launches"] = read_launches()
        reset_launches()
    res["full"] = dp_train(LEADERBOARD, "bf16",
                           [make_batch(70 + i, b=2 * TRAIN_B) for i in range(DP_STEPS + 1)],
                           "deflowLoss", workers=workers, clock=True)
    res["full"]["launches"] = read_launches()
    res["eval f32"] = dp_eval(DP_SMALL, "fp32", dp_batch(80), workers)
    res["eval bf16"] = dp_eval(LEADERBOARD, "bf16", make_batch(81, b=B), workers)
    res["validation"] = dp_validation()
    return res


def dp_validation() -> dict:
    """``run_validation`` (the eval entry's sweep: loader, host prep,
    prefetch, eval step, metrics) of the leaderboard bf16 model (seeded)
    over B + 1 in-memory samples in batches of B, the last batch ragged;
    over ranks, rank 0 computes the metrics of the gathered rows."""
    from deflow_tpu_torch.entry.evaluate import run_validation
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import make_eval_step

    step = make_eval_step(build_model(LEADERBOARD, precision="bf16", seed=7))
    val = entry_dataset([82], B) + entry_dataset([83], 1)
    return run_validation(step, val, {"batch_size": B, "num_workers": 1,
                                      "voxel_size": VOXEL, "point_cloud_range": RANGE})


def _dp_ratios(got: dict, want: dict, hold_params: bool) -> dict:
    """Largest differences of a DP run from the single-process run over
    their tolerances (train_reference_check's, the card's own noise, for
    DP_STEPS steps): loss and grad_norm of every step 1e-4 relative; every
    parameter's first-step gradient 1e-3 of its largest element (a
    zero-gradient conv bias: both sides below 1e-3 of the largest gradient
    of its conv's weight); the BN running statistics after the last step
    1e-5 of each buffer's largest element (at least 1e-5); with
    ``hold_params`` the parameters after the last step DP_STEPS x (1e-6 +
    lr·1e-2), the zero-gradient biases DP_STEPS x 2·lr."""
    r = {"loss": 0.0, "grad_norm": 0.0, "grad": 0.0, "running": 0.0, "param": 0.0}
    for a, w in zip(got["aux"], want["aux"]):
        for k in ("loss", "grad_norm"):
            r[k] = max(r[k], abs(a[k] - w[k]) / abs(w[k]) / 1e-4)
    for key, ref in want["grads"].items():
        if _zero_grad_bias(key):
            scale = want["grads"][key[:-4] + "weight"].abs().max().item()
            err = max(got["grads"][key].abs().max().item(), ref.abs().max().item())
        else:
            scale, err = ref.abs().max().item(), (got["grads"][key] - ref).abs().max().item()
        r["grad"] = max(r["grad"], err / (1e-3 * scale))
    for key, ref in want["state"].items():
        if "num_batches" in key:
            continue
        err = (got["state"][key] - ref).abs().max().item()
        if "running" in key:
            r["running"] = max(r["running"], err / (1e-5 * max(1.0, ref.abs().max().item())))
        elif hold_params:
            tol = 2 * LR if _zero_grad_bias(key) else 1e-6 + LR * 1e-2
            r["param"] = max(r["param"], err / (DP_STEPS * tol))
    if not hold_params:
        del r["param"]
    return r


def nccl_world1(model, batches, tmp: str) -> dict:
    """Phase 9b: the full-width train step (phase 5's batches, twice over)
    without a process group, then under an nccl group of world size 1
    (every collective runs), then without again; after each run one step
    profiled (``profile_step``: the device's busy time, and under the group
    its nccl kernels' device time) and one with its collectives clocked;
    and ``entry.train.fit`` (one epoch of ENTRY_TRAIN_STEPS steps at
    TRAIN_B x N, remat) without the group and under it.  Returns the step
    medians, the profiles' numbers, the collectives and the fits' steady
    periods."""
    import torch

    from deflow_tpu_torch import dist
    from deflow_tpu_torch.trainer import (TRAIN_KEYS, device_batch, init_train_state,
                                          make_train_step)

    device_batches = [device_batch(hb, keys=TRAIN_KEYS) for hb in batches] * 2
    train = entry_dataset(range(700, 700 + ENTRY_TRAIN_STEPS), TRAIN_B)

    def medians(label):
        state = init_train_state(model, {"lr": LR})
        step = make_train_step(model, "deflowLoss")
        ms = []
        for db in device_batches:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, aux = step(state, db)
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            if not np.isfinite(float(aux["loss"])):
                raise SystemExit(f"{label}: non-finite loss")
        print(f"9b {label} step device ms: " + ", ".join(f"{t:.3f}" for t in ms)
              + f"; steady median {float(np.median(ms[1:])):.3f} ms")
        prof = profile_step(lambda: step(state, device_batches[0]), PER_STEP)
        nccl = {k: v for k, v in prof.pop("by_name").items() if "nccl" in k.lower()}
        with CollectiveClock() as clock:
            step(state, device_batches[0])
        row = {"median_ms": float(np.median(ms[1:])), **prof,
               "nccl_kernel_ms": sum(nccl.values()), "nccl_kernels": sorted(nccl)[:4],
               "collectives": clock.summary() if clock.calls else None}
        print(f"9b {label}: {row}")
        return row

    def fit(label):
        res, launches, _ = traced_fit(entry_cfg(os.path.join(tmp, label), epochs=1),
                                      train, None, f"9b fit {label}", REMAT_PER_STEP)
        t = np.asarray(res.step_starts)
        period = float(np.median(np.diff(t)[1:])) * 1e3
        dev = float(np.median(res.device_ms[1:]))
        print(f"9b fit {label}: steady period {period:.1f} ms a step, device median "
              f"{dev:.3f} ms, last loss {res.last_aux['loss']:.6f}")
        if not np.isfinite(res.last_aux["loss"]):
            raise SystemExit(f"9b fit {label}: non-finite loss")
        return {"period_ms": period, "device_ms": dev}

    out = {"plain_1": medians("without a process group (1)"),
           "fit_plain": fit("plain")}
    dist.init_distributed("nccl", f"file://{os.path.join(tmp, 'nccl_store')}", 0, 1,
                          device="cuda")
    try:
        out["nccl"] = medians("nccl, world size 1")
        out["fit_nccl"] = fit("nccl")
    finally:
        dist.shutdown()
    out["plain_2"] = medians("without a process group (2)")
    return out


def run_data_parallel(model, train_batches) -> dict:
    """Phase 9: (a) and (c) on two ranks sharing the card over gloo
    (``dist.run_ranks``), against the single-process runs on the card; (b)
    nccl at world size 1.  Exits on any difference beyond its tolerance."""
    import shutil
    import tempfile

    import torch

    from deflow_tpu_torch import dist

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dist.run_ranks(dp_rank, 2, "gloo", "cuda", timeout=900)
    print(f"9 two ranks over gloo on one card: {time.perf_counter() - t0:.1f} s")
    out = {"ranks": [{run: {"launches": r[run]["launches"]} for run in DP_RUNS}
                     for r in ranks]}
    for name, loss_name, grid, dufo, seed in (("deflow", "deflowLoss", False, False, 40),
                                              ("seflow grid", "seflowLoss", True, True, 50),
                                              ("seflow brute", "seflowLoss", False, True, 60)):
        want = dp_train(DP_SMALL, "fp32", [dp_batch(seed + i, dufo) for i in range(DP_STEPS)],
                        loss_name, grid=grid, keep=True)
        same = ranks[0][name]["digests"] == ranks[1][name]["digests"]
        ratio = _dp_ratios(ranks[0][name], want, hold_params=loss_name == "deflowLoss")
        print(f"9a {name} (f32, 64x64 grid, 2 x {DP_N} a rank, valid {DP_VALID} / "
              f"{DP_VALID_RANK1}, {DP_STEPS} Adam steps), two ranks against one process "
              f"at the global batch: " + ", ".join(f"{k} {v:.3f}" for k, v in ratio.items())
              + f"; ranks bit for bit after every step: {same}; launches a rank "
              + str([r[name]["launches"] for r in ranks]))
        if not same or not all(v <= 1.0 for v in ratio.values()):
            raise SystemExit(f"9a: the two-rank {name} run differs")
        out[name] = {**ratio, "ranks_bit_for_bit": same}
    want = {k: v * (DP_STEPS + 1) for k, v in PER_STEP.items()}
    full = [r["full"] for r in ranks]
    same = full[0]["digests"] == full[1]["digests"]
    print(f"9a full width (bf16, 512^2 grid, {TRAIN_B} x {N} a rank, {DP_STEPS} steps): "
          + "; ".join(f"rank {i} loss " + ", ".join(f"{a['loss']:.6f}" for a in f["aux"])
                      + " device ms " + ", ".join(f"{t:.3f}" for t in f["ms"])
                      + f" launches {f['launches']}" for i, f in enumerate(full))
          + f"; bit for bit {same} (want {want} a rank); collectives of the clocked "
          + "step: " + "; ".join(f"rank {i} {f['collectives']}" for i, f in enumerate(full)))
    if not same or any(f["launches"] != want for f in full) or not all(
            np.isfinite(a["loss"]) for f in full for a in f["aux"]):
        raise SystemExit("9a: the full-width two-rank run failed")
    out["full_ms"] = [float(np.median(f["ms"][1:])) for f in full]
    out["full_collectives"] = [f["collectives"] for f in full]
    for key, cfg, precision, hb, tol in (
            ("eval f32", DP_SMALL, "fp32", dp_batch(80), 2e-4),
            ("eval bf16", LEADERBOARD, "bf16", make_batch(81, b=B), 5e-2)):
        want = dp_eval(cfg, precision, hb)
        err = (ranks[0][key] - want).abs()
        print(f"9c {key}: two ranks against one process, max |d pred_flow| "
              f"{err.max().item():.3e} m (tol {tol}), mean {err.mean().item():.3e}; ranks "
              f"equal {torch.equal(ranks[0][key], ranks[1][key])}")
        if not (err.max().item() <= tol and torch.equal(ranks[0][key], ranks[1][key])):
            raise SystemExit(f"9c: the two-rank {key} differs")
        out[key] = err.max().item()
    # bf16: cuDNN may round otherwise at 2 rows than at 4, so the metrics
    # are held to 1e-3 relative (the accuracies, shares of points, 1e-3)
    want = dp_validation()
    worst = 0.0
    for r in ranks:
        if r["validation"].keys() != want.keys():
            raise SystemExit("9c: run_validation over two ranks gave other metrics")
        for k, v in want.items():
            g = r["validation"][k]
            if np.isnan(v) or np.isnan(g):
                worst = max(worst, 0.0 if np.isnan(v) and np.isnan(g) else np.inf)
            else:
                worst = max(worst, abs(g - v) / (1e-3 if "Acc" in k else 1e-3 * abs(v)))
    print(f"9c run_validation over two ranks ({B + 1} samples in batches of {B}, the "
          f"last ragged) against one process: largest metric difference over its "
          f"tolerance {worst:.3f}; EPE_3way_mean {want['EPE_3way_mean']:.6f}")
    if not worst <= 1.0:
        raise SystemExit("9c: run_validation over two ranks differs")
    out["validation"] = worst
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        out["nccl"] = nccl_world1(model, train_batches, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# phase 11: the JAX package's last surface.  Steps (or batches) of each
# path; an SSL step's launches, a max-scatter eval batch's (either route:
# the centroid and count sums of both clouds, the centroids' gathers and
# the decoder's); the dyn_cap shares of N; the DUFO scene
SURFACE_STEPS = 3
SSL_PER_STEP = dict(PER_STEP, cell_sweep=2, segment_sum_lanes=1)
MAX_EVAL_PER_BATCH = {"segment_sum": 4, "sorted_gather": 3, "fused_gru": 1, **STEM_EVAL}
DYNCAP_SHARES = (0.20, 0.05)
DUFO_FRAMES, DUFO_WINDOW = 20, 10


class env:
    """Set environment variable ``name`` to ``value`` within the block."""

    def __init__(self, name: str, value: str):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ[self.name]
        else:
            os.environ[self.name] = self.old


def dyncap_grads(db, caps) -> dict:
    """(a) The chamfer-level d_pc0 of the SSL batch's fixed clouds (pc0
    ego-compensated, pc1 from the host cell prep, 15% flagged) for each
    ``dyn_cap``; and the rows the truncated f-terms touch at each cap (the
    flagged rows past it, and the pc0 f-matches of pc1's rows past it)."""
    import torch

    from deflow_tpu_torch.ops import chamfer

    spec = chamfer._resolve_spec("grid", N, N, TRUNCATE, None)
    m0, m1 = db["pc0_mask"], db["pc1_mask"]
    f0, f1 = m0 & (db["dufo_label0"] > 0), m1 & (db["dufo_label1"] > 0)
    host = (db["pc1_cell_lanes"], db["pc1_cell_sid"], db["pc1_cell_start"])
    out = {}
    for cap in caps:
        p0 = db["pc0_transformed"].detach().clone().requires_grad_()
        d = chamfer.ssl_chamfer_distances(p0, db["pc1"], m0, m1, f0, f1, truncate=TRUNCATE,
                                          spec=spec._replace(dyn_cap=cap), host_c1=host)
        sum(x.clamp(max=TRUNCATE ** 2).sum() for x in d).backward()
        touched = torch.zeros_like(m0)
        if cap is not None:
            masked = lambda p, m: torch.where(m[..., None], p, 0.0)
            i1f = chamfer._SSLNN.apply(masked(p0.detach(), m0), masked(db["pc1"], m1),
                                       m0, m1, f0, f1, spec, host)[7]
            touched = f0 & (f0.cumsum(-1) > cap)
            past1 = f1 & (f1.cumsum(-1) > cap)
            for s_ in range(m0.shape[0]):
                hit = i1f[s_][past1[s_]]
                touched[s_, hit[hit >= 0]] = True
        out[cap] = (p0.grad, touched, int(f0.sum(-1).max()), int(f1.sum(-1).max()))
    return out


def dufo_frames(seed: int = 9, frames: int = DUFO_FRAMES, n: int = N) -> list:
    """(c) A synthetic drive for the DUFO labeller: the ego at 10 m/s, a
    slight turn; four walls around it (rays cross empty space to reach
    them), 10% ground points (ground_mask), six boxes of ~1,600 points
    each moving at up to 10 m/s; ``n`` points a frame in the ego frame."""
    rng = np.random.default_rng(seed)
    k = 400_000
    side = rng.integers(0, 4, k)
    u = rng.random(k)
    x = np.where(side < 2, -40 + 100 * u, np.where(side == 2, -40.0, 60.0))
    y = np.where(side < 2, np.where(side == 0, -35.0, 35.0), -35 + 70 * u)
    walls = np.stack([x + rng.normal(0, 0.05, k), y + rng.normal(0, 0.05, k),
                      rng.uniform(0.2, 4.0, k)], -1)
    boxes = [(np.array([rng.uniform(-10, 30), rng.uniform(-25, 25), 1.0]),
              rng.uniform(-10, 10, 3) * [1, 1, 0],
              rng.uniform(-1, 1, (n // 60, 3)) * [2.2, 1.0, 0.8]) for _ in range(6)]
    n_box = sum(len(b[2]) for b in boxes)
    n_ground = n // 10
    n_wall = n - n_box - n_ground
    out = []
    for t in range(frames):
        yaw = 0.01 * t
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                        [0, 0, 1]])
        ego = np.array([1.0 * t, 0.2 * t, 1.8])
        ground = np.stack([rng.uniform(-40, 60, n_ground), rng.uniform(-35, 35, n_ground),
                           rng.uniform(-0.2, 0.05, n_ground)], -1)
        city = np.concatenate([walls[rng.integers(0, k, n_wall)], ground,
                               *(c + v * 0.1 * t + shape for c, v, shape in boxes)])
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = rot, ego
        gm = np.zeros(n, bool)
        gm[n_wall:n_wall + n_ground] = True
        out.append({"lidar": ((city - ego) @ rot).astype(np.float32), "pose": pose,
                    "ground_mask": gm})
    return out


def run_path(label: str, per: dict, items: list, run, check, out: dict,
             launched: dict):
    """One path of phases 11 and 12: every launch count set to 0 and the
    peak memory reset, ``run(item)`` for each item under CUDA events with
    ``check`` on each output, then the counts read.  Exits unless they are
    ``per`` an item.  Puts the device ms, the median and the spread
    (largest minus smallest) of the steady items (all but the first) and
    the peak memory (GiB, and the memory held before the first item) into
    ``out[label]``, the launches into ``launched[label]``; returns the
    checks' results."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, ms = _timed_steps(run, items, check)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = _want(per, len(items))
    med, spread = float(np.median(ms[1:])), float(max(ms[1:]) - min(ms[1:]))
    print(f"{label}: device ms " + ", ".join(f"{t:.3f}" for t in ms)
          + f"; steady median {med:.3f} ms, spread {spread:.3f} ms; peak memory "
          f"{peak:.3f} GiB ({base:.3f} held before); launches {launches} (want {want})")
    if launches != want:
        raise SystemExit(f"{label} did not launch every kernel as expected")
    out[label] = {"device_ms": ms, "median_ms": med, "spread_ms": spread,
                  "peak_gib": peak, "held_before_gib": base}
    launched[label] = launches
    return res


def run_last_surface(eval_batches, ssl_batches) -> dict:
    """Phase 11, each path at full width with its launch counts held:
    (a) SeFlow with dyn_cap above and below the dynamic counts; (b) the
    max-scatter eval with and without host prep; (c) the DUFO labeller on
    the card against the CPU."""
    import torch

    from deflow_tpu_torch.dataprocess.process import label_frames
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import (SSL_TRAIN_KEYS, device_batch, init_train_state,
                                          make_eval_step, make_train_step)

    out, launched = {}, {}

    def path(label, per, items, run, check=lambda o: o):
        return run_path(label, per, items, run, check, out, launched)

    def finite(res):
        aux = {k: float(v) for k, v in res[1].items()}
        if not all(np.isfinite(v) for v in aux.values()):
            raise SystemExit(f"a step gave non-finite values {aux}")
        return aux

    # (a) SeFlow with dyn_cap: the loss of the first step (the forward never
    # changes), 2 sweeps and 1 lane sum a step, and the chamfer's d_pc0
    sdbs = [device_batch(hb, keys=SSL_TRAIN_KEYS) for hb in ssl_batches[:SURFACE_STEPS]]
    caps = [None] + [int(share * N) for share in DYNCAP_SHARES]
    first = {}
    for cap in caps:
        with env("DEFLOW_SSL_DYNCAP", "0" if cap is None else str(cap)):
            model = build_model(LEADERBOARD, precision="bf16", seed=0)
            state = init_train_state(model, {"lr": LR, "optimizer": "adam"})
            step = make_train_step(model, "seflowLoss")
            auxes = path(f"(a) seflow, dyn_cap {cap}", SSL_PER_STEP, sdbs,
                         lambda db: step(state, db), finite)
        first[cap] = auxes[0]["loss"]
    del model, state, step
    print("(a) first-step loss by dyn_cap: " + ", ".join(f"{c}: {v!r}" for c, v in first.items()))
    if len(set(first.values())) != 1:
        raise SystemExit("dyn_cap changed the SeFlow loss")
    grads = dyncap_grads(sdbs[0], caps)
    full = grads[None][0]
    scale = full.abs().max().item()
    for cap in caps[1:]:
        g, touched, n0, n1 = grads[cap]
        diff = (g - full).abs().max(-1).values
        off = diff[~touched].max().item() / scale
        changed = int((diff > 1e-5 * scale).sum())
        print(f"(a) chamfer d_pc0, dyn_cap {cap} (flagged rows a sample up to {n0} / "
              f"{n1}): largest difference off the {int(touched.sum())} touched rows "
              f"{off:.3e} of the largest element (tol 1e-5); rows differing by more "
              f"{changed}, all touched: {bool((diff[~touched] <= 1e-5 * scale).all())}")
        if not off <= 1e-5 or (cap >= max(n0, n1)) != (int(touched.sum()) == 0):
            raise SystemExit(f"the compacted backward at dyn_cap {cap} disagrees")
        out[f"(a) d_pc0 at dyn_cap {cap}"] = {"off_touched_rel": off, "changed_rows": changed,
                                            "touched_rows": int(touched.sum()),
                                            "max_flagged": [n0, n1]}
    out["(a) first_step_loss"] = first[None]
    del sdbs, grads
    torch.cuda.empty_cache()

    # (b) the max scatter's eval, host-sorted batches and raw ones
    model = build_model(LEADERBOARD, precision="bf16", seed=0)
    model.embedder.scatter_mode = "max"
    step = make_eval_step(model)

    def finite_eval(o):
        if not all(torch.isfinite(v).all() for v in o.values() if v.is_floating_point()):
            raise SystemExit("the max-scatter eval gave non-finite values")
        return o
    for label, hbs in (("(b) max-scatter eval, host prep", eval_batches[:SURFACE_STEPS]),
                       ("(b) max-scatter eval, no host prep",
                        [make_batch(100 + i) for i in range(SURFACE_STEPS)])):
        path(label, MAX_EVAL_PER_BATCH, [device_batch(hb) for hb in hbs], step, finite_eval)
    del model, step
    for hosted in (True, False):
        err = reference_check(seed=7, hosted=hosted, scatter_mode="max")
        print(f"(b) reference check, max scatter{'' if hosted else ', no host prep'} "
              f"(f32, 64x64 grid, card vs CPU): max |d pred_flow| {err:.3e} (tol 2e-4)")
        if not err < 2e-4:
            raise SystemExit("card and CPU disagree on the max-scatter eval")
        out[f"(b) f32 card vs cpu{'' if hosted else ', no host prep'}"] = err

    # (c) the DUFO labeller, the card against the CPU
    frames = dufo_frames()
    labels, ms = {}, {}
    for where, dev in (("card", "cuda"), ("card", "cuda"), ("cpu", "cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels[where] = label_frames(frames, DUFO_WINDOW, device=dev)
        torch.cuda.synchronize()
        ms[where] = (time.perf_counter() - t0) * 1e3 / len(frames)
    card, cpu = np.concatenate(labels["card"]), np.concatenate(labels["cpu"])
    differ = float((card != cpu).mean())
    print(f"(c) DUFO labels, {len(frames)} frames x {N:,}, window {DUFO_WINDOW}: card "
          f"{ms['card']:.1f} ms a frame (the second run), CPU {ms['cpu']:.1f} ms; share "
          f"differing {differ:.3e}; dynamic fraction card {card.mean():.4f}, CPU "
          f"{cpu.mean():.4f}")
    if differ > 1e-4:
        raise SystemExit("the DUFO labels on the card disagree with the CPU's")
    out["(c) dufo"] = {"card_ms_per_frame": ms["card"], "cpu_ms_per_frame": ms["cpu"],
                       "share_differing": differ, "dynamic_fraction": float(card.mean())}
    return out, launched


# phase 12: the reference's ablation configurations, each at full width.
# Steps or batches a path (one warm-up, then the steady ones); the 0.1 m
# voxel (assets/slurm/1_train.sh:74,78: the grid follows from range / voxel,
# 1024^2); the FastFlow3D baseline (conf/model/fastflow3d.yaml, lr 4e-5 as
# in the reference README:68); the clip of (f) at full width and on the
# small model (below its step's norm, so that it acts); the sample of (a)'s
# card-against-CPU check at the 1024^2 grid (samples, slots, valid slots)
ABLATION_STEPS = 4
FINE_VOXEL = [0.1, 0.1, 6.0]
FINE = dict(LEADERBOARD, voxel_size=FINE_VOXEL, grid_feature_size=[1024, 1024])
FF3D = dict(LEADERBOARD, decoder_option="linear", num_iters=0)
FF3D_LR = 4e-5
CLIP, SMALL_CLIP = 0.5, 0.05
FINE_CHECK = (1, 16384, 14336)
# the linear head launches what the MMHead does: no GRU; under remat every
# forward kernel twice
LINEAR_REMAT_PER_STEP = dict(REMAT_PER_STEP, fused_gru=0, fused_gru_bwd=0)
ABLATION_OPTS = (("adamw", {"optimizer": "adamw"}), ("sgd", {"optimizer": "sgd"}),
                 ("adam, clip", {"optimizer": "adam", "gradient_clip": CLIP}))


def wrapper_limits(cfg: dict) -> dict:
    """The largest batch B that the wrappers' row limits let through at the
    grid of ``cfg``: B*(P+8) segment-sum rows, B*P rows of the decoder's
    128-lane gather, B*(P+8) rows of the scatter's backward (a gather of
    33 bf16 lanes)."""
    from deflow_tpu_torch.ops.gather import gather_max_rows
    from deflow_tpu_torch.ops.scatter import segment_sum_max_rows
    from deflow_tpu_torch.ops.voxel import TRASH_PAD, VoxelConfig

    p = VoxelConfig(tuple(cfg["voxel_size"]), tuple(cfg["point_cloud_range"])).num_pillars
    return {"segment_sum": segment_sum_max_rows() // (p + TRASH_PAD),
            "sorted_gather, 128 lanes": gather_max_rows(128, 2) // p,
            "sorted_gather, 33 lanes": gather_max_rows(33, 2) // (p + TRASH_PAD)}


def check_fine_kernels(model, eval_batch, splits: list) -> dict:
    """Phase 12, the kernels at the 1024^2 grid's shapes against their plain
    versions, in the style of phase 3: the embedder's segment-sum into B x
    (1,048,576 + 8) rows of 33 lanes; the decoder's gather from the [B x
    1,048,576, 128] table and its backward (in f32 a table of 2^31 bytes);
    the fused blocks at 512^2x64, 256^2x128 and 128^2x256, 2B = 4.  Returns
    the bf16 measurements by kernel, under "grid_1024"."""
    import torch

    from deflow_tpu_torch.ops import voxel
    from deflow_tpu_torch.trainer import device_batch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    cfg = model.voxel_cfg
    p, seg = cfg.num_pillars, cfg.num_pillars + voxel.TRASH_PAD
    db = device_batch(eval_batch, dev)
    ids = voxel.make_presorted_plan(db["pc0_sorted"], seg)
    check_plan("(embedder, 1024^2)", ids, B * seg, B)
    res = {"segment_sum": {"embedder": hold_segment_sum(
        "(embedder, 1024^2)", pillar_feats(ids, B * seg, g), ids, B * seg, B)}}
    _, gids = gather_ids(db, cfg, B)
    res["sorted_gather"] = {"decoder": hold_gather(
        "(decoder, 1024^2)", torch.randn(B * p, 128, generator=g, device=dev), gids, B * p)}
    res["segment_sum"]["as_gather_bwd"] = hold_gather_bwd(", 1024^2", db, cfg, B, g)
    for name, pair in hold_cbg(model, g, splits).items():
        for kname, r in pair.items():
            res.setdefault(kname, {})[f"width_{name}"] = r
    for name, rr in res.items():
        for r in rr.values():
            print_timing(name, r)
    return {name: {"grid_1024": r} for name, r in res.items()}


def drift_witness(model, train_batches, first: dict) -> dict:
    """Phase 12's last reading: one epoch of phase 5b's train entry (a), then
    phase 5's leaderboard steps, again after every other phase, beside their
    first readings ``first`` ("period_ms", "train_ms"): what the phases
    between them, and the host, left on the 512^2 paths."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_witness_")
    try:
        train = entry_dataset(range(700, 700 + ENTRY_TRAIN_STEPS), TRAIN_B)
        val = entry_dataset(range(800, 800 + ENTRY_VAL_BATCHES), B)
        res, _, prep_ms = traced_fit(entry_cfg(os.path.join(tmp, "a"), epochs=1), train, val,
                                     "(12) witness, train entry (a)", REMAT_PER_STEP)
        period = entry_numbers("(12) witness, train entry (a)", res, prep_ms,
                               first["train_ms"], ENTRY_TRAIN_STEPS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _, step_ms, launches = run_train_path(model, train_batches, label="(12) witness, train")
    if launches != {k: v * len(train_batches) for k, v in PER_STEP.items()}:
        raise SystemExit(f"the witness's train path launched {launches}")
    med = float(np.median(step_ms[1:]))
    print(f"(12) drift witness: the train entry's period {first['period_ms']:.1f} ms in "
          f"phase 5b, {period:.1f} ms at the end; the leaderboard step's device median "
          f"{first['train_ms']:.3f} ms in phase 5, {med:.3f} ms at the end")
    return {"period_ms": [first["period_ms"], period], "train_ms": [first["train_ms"], med],
            "train_step_ms": step_ms}


def run_ablations(eval_batches, train_batches) -> tuple:
    """Phase 12, the reference's ablation configurations that no other phase
    runs, each at full width with its launch counts held, its device ms
    (median and spread of the steady steps) and peak memory: (a) the
    leaderboard DeFlow at the 0.1 m voxel (1024^2 grid), eval; (b) its
    deflowLoss Adam step; (c) FastFlow3D (the linear head), eval; (d) its
    ff3dLoss Adam step at lr 4e-5; (e) num_iters=2, deflowLoss; (f)
    zeroflowLoss under AdamW, SGD and Adam with a clip; (g) precision fp32,
    eval and deflowLoss step; (h) ``entry.train.fit`` of FastFlow3D with
    ff3dLoss, one epoch, validated and checkpointed.  Then the f32 checks of
    the card against the CPU: (a) at the 1024^2 grid itself, (c) and (d),
    (e), (f) at the small 64^2 model."""
    import shutil
    import tempfile

    import torch

    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import (TRAIN_KEYS, device_batch, init_train_state,
                                          make_eval_step, make_train_step)

    out, launched = {}, {}
    for what, cfg in (("512^2", LEADERBOARD), ("1024^2", FINE)):
        lim = wrapper_limits(cfg)
        out[f"wrapper limits, {what}"] = lim
        print(f"(12) the wrappers' size limits at the {what} grid, as the largest batch: "
              + ", ".join(f"{k} {v}" for k, v in lim.items()))

    def finite_eval(o):
        if not all(torch.isfinite(v).all() for v in o.values() if v.is_floating_point()):
            raise SystemExit("an eval gave non-finite values")
        return None

    def finite_step(res):
        aux = {k: float(v) for k, v in res[1].items()}
        if not all(np.isfinite(v) for v in aux.values()) or not all(
                torch.isfinite(p.grad).all() for p in res[0].model.parameters()
                if p.grad is not None):
            raise SystemExit(f"a step gave non-finite values {aux}")
        return aux

    def evals(label, cfg, precision, hbs, per, profile=False):
        model = build_model(cfg, precision=precision, seed=0)
        step = make_eval_step(model)
        dbs = [device_batch(hb) for hb in hbs]
        run_path(label, per, dbs, step, finite_eval, out, launched)
        if profile:
            prof = profile_step(lambda: step(dbs[0]), launched[label])
            out[label]["profile"] = {k: v for k, v in prof.items() if k != "by_name"}
        del model, step, dbs
        torch.cuda.empty_cache()

    def trains(label, cfg, precision, hbs, loss_name, opt, per, profile=False):
        model = build_model(cfg, precision=precision, seed=0)
        state = init_train_state(model, {"lr": LR, "optimizer": "adam", **opt})
        step = make_train_step(model, loss_name)
        dbs = [device_batch(hb, keys=TRAIN_KEYS) for hb in hbs]
        auxes = run_path(label, per, dbs, lambda db: step(state, db), finite_step,
                         out, launched)
        out[label]["loss"] = [a["loss"] for a in auxes]
        out[label]["grad_norm"] = [a["grad_norm"] for a in auxes]
        print(f"{label}: loss " + ", ".join(f"{a['loss']:.6f}" for a in auxes)
              + "; grad_norm " + ", ".join(f"{a['grad_norm']:.6f}" for a in auxes))
        if profile:
            prof = profile_step(lambda: step(state, dbs[0]), launched[label])
            out[label]["profile"] = {k: v for k, v in prof.items() if k != "by_name"}
        del model, state, step, dbs
        torch.cuda.empty_cache()

    steps = ABLATION_STEPS
    # (a), (b): the 0.1 m voxel, host-sorted at its grid
    fine_eval = [held_prep(make_batch(1200 + i), FINE_VOXEL)[0] for i in range(steps)]
    fine_train = [held_prep(make_batch(1300 + i, b=TRAIN_B), FINE_VOXEL)[0]
                  for i in range(steps)]
    evals("(a) 1024^2 eval", FINE, "bf16", fine_eval, PER_VAL_BATCH, profile=True)
    trains("(b) 1024^2 train, deflowLoss", FINE, "bf16", fine_train, "deflowLoss", {},
           PER_STEP, profile=True)
    del fine_train
    # (c), (d): FastFlow3D
    evals("(c) fastflow3d eval", FF3D, "bf16", eval_batches[:steps], MMHEAD_EVAL_PER_BATCH)
    trains("(d) fastflow3d train, ff3dLoss", FF3D, "bf16", train_batches[:steps],
           "ff3dLoss", {"lr": FF3D_LR}, MMHEAD_PER_STEP)
    # (e) num_iters=2; (f) zeroflowLoss under each optimizer
    trains("(e) num_iters=2 train, deflowLoss", dict(LEADERBOARD, num_iters=2), "bf16",
           train_batches[:steps], "deflowLoss", {}, PER_STEP)
    for what, opt in ABLATION_OPTS:
        trains(f"(f) zeroflowLoss, {what}", LEADERBOARD, "bf16", train_batches[:steps],
               "zeroflowLoss", opt, PER_STEP)
    # (g) fp32 at full width, each with a profiled step (the f32 kernel routes)
    evals("(g) fp32 eval", LEADERBOARD, "fp32", eval_batches[:steps],
          {**PER_VAL_BATCH, **NO_STEM}, profile=True)
    trains("(g) fp32 train, deflowLoss", LEADERBOARD, "fp32", train_batches[:steps],
           "deflowLoss", {}, {**PER_STEP, **NO_STEM}, profile=True)

    # (h) the train entry of FastFlow3D
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ablation_")
    try:
        train = entry_dataset(range(1400, 1400 + steps), TRAIN_B)
        val = entry_dataset(range(1500, 1500 + ENTRY_VAL_BATCHES), B)
        torch.cuda.reset_peak_memory_stats()
        res, launches, _ = traced_fit(
            entry_cfg(os.path.join(tmp, "h"), model="fastflow3d", loss_fn="ff3dLoss",
                      lr=FF3D_LR, epochs=1), train, val,
            "(h) train entry, fastflow3d, ff3dLoss", LINEAR_REMAT_PER_STEP,
            MMHEAD_EVAL_PER_BATCH)
        ckpts = sorted(os.listdir(os.path.join(res.run_dir, "checkpoints")))
        keys = ("EPE_3way_mean", "Static_EPE_mean", "Dynamic_NormEPE_mean")
        print(f"(h) train entry: {res.state.step} steps, checkpoints {ckpts}; val "
              + ", ".join(f"{k} {res.metrics[k]:.6f}" for k in keys)
              + "; step device ms " + ", ".join(f"{t:.3f}" for t in res.device_ms)
              + f"; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        if (res.state.step != steps or ckpts != ["best.ckpt", "epoch_0.ckpt"]
                or not all(np.isfinite(res.metrics[k]) for k in keys)
                or not np.isfinite(res.last_aux["loss"])):
            raise SystemExit("the FastFlow3D train entry ran other steps, wrote other "
                             "checkpoints or gave non-finite metrics")
        out["(h) train entry, fastflow3d"] = {
            "device_ms": res.device_ms, "median_ms": float(np.median(res.device_ms[1:])),
            "spread_ms": float(max(res.device_ms[1:]) - min(res.device_ms[1:])),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "metrics": {k: res.metrics[k] for k in keys}}
        launched["(h) train entry, fastflow3d"] = launches
        del res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # the f32 checks, the card against the CPU
    err = reference_check(seed=7, model_cfg={k: FINE[k] for k in ("voxel_size",
                                                                  "grid_feature_size")},
                          batch=FINE_CHECK)
    print(f"(a) reference check at the 1024^2 grid (f32, {FINE_CHECK[0]} x "
          f"{FINE_CHECK[1]:,} slots, card vs CPU): max |d pred_flow| {err:.3e} (tol 2e-4)")
    if not err < 2e-4:
        raise SystemExit("card and CPU disagree at the 1024^2 grid")
    out["(a) f32 card vs cpu, 1024^2"] = err
    linear = {"decoder_option": "linear", "num_iters": 0}
    err = reference_check(seed=7, model_cfg=linear)
    print(f"(c) reference check, fastflow3d eval (f32, 64x64 grid, card vs CPU): max "
          f"|d pred_flow| {err:.3e} (tol 2e-4)")
    if not err < 2e-4:
        raise SystemExit("card and CPU disagree on the FastFlow3D eval")
    out["(c) f32 card vs cpu"] = err
    for what, kw in (("(d) fastflow3d, ff3dLoss, lr 4e-5",
                      {"loss_name": "ff3dLoss", "model_cfg": linear, "opt": {"lr": FF3D_LR}}),
                     ("(e) num_iters=2, deflowLoss", {"model_cfg": {"num_iters": 2}}),
                     *((f"(f) zeroflowLoss, {w}",
                        {"loss_name": "zeroflowLoss",
                         "opt": dict(o, gradient_clip=SMALL_CLIP) if "gradient_clip" in o
                         else o}) for w, o in ABLATION_OPTS)):
        ratio = train_reference_check(7, **kw)
        print(f"train reference check {what} (f32, 64x64 grid, 2 x 4,096 slots, one step, "
              "card vs CPU): largest difference over its tolerance: "
              + ", ".join(f"{k} {v:.3f}" for k, v in ratio.items()))
        if not all(v <= 1.0 for v in ratio.values()):
            raise SystemExit(f"card and CPU disagree on {what}")
        out[f"{what}, f32 card vs cpu"] = ratio
    return out, launched


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.ops import _build
    from deflow_tpu_torch.utils import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    walls, t_lap = {}, [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        walls[what] = now - t_lap[0]
        t_lap[0] = now
        print(f"wall: {what} {walls[what]:.1f} s")

    t0 = time.perf_counter()
    logs = _build.build_all(force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    for name, info in logs.items():
        for line in ptxas_lines(info["log"]):
            print(f"  {name}: {line}")
    t0 = time.perf_counter()
    native.build(force=True)
    print(f"host ops build (g++ {' '.join(native.CXX_FLAGS)}): "
          f"{time.perf_counter() - t0:.1f} s; host cpu_count {os.cpu_count()}")
    for path, row in host_prep_times().items():
        print(f"host prep {path}: numpy {row['numpy']:.1f} ms, C++ 1 thread "
              f"{row['cxx_1_thread']:.1f} ms, C++ pool of {HOST_WORKERS} "
              f"{row['cxx_pool']:.1f} ms per batch (median of 3)")
    lap("2 build, host prep")

    model = build_model(LEADERBOARD, precision="bf16", seed=0)

    def prep(what, seeds, b, n=N, valid=VALID, dufo=False):
        out, ms = [], []
        for sd in seeds:
            hb, t = held_prep(make_batch(sd, b=b, n=n, valid=valid, dufo=dufo))
            out.append(hb)
            ms.append(t)
        print(f"{what} host prep (C++, pool of {HOST_WORKERS}) ms per batch: "
              + ", ".join(f"{t:.1f}" for t in ms) + "; held bit for bit to numpy")
        return out

    batches = prep("eval", range(100, 100 + NUM_BATCHES), B)
    train_batches = prep("train", range(200, 200 + TRAIN_STEPS), TRAIN_B)
    ssl_batches = prep("ssl (with the pc1 cell prep)", range(300, 300 + SSL_STEPS),
                       TRAIN_B, dufo=True)
    brute_batches = prep("ssl 2 x 16,384", range(400, 400 + BRUTE_STEPS), TRAIN_B,
                         n=BRUTE_N, valid=BRUTE_VALID, dufo=True)
    lap("2 batches")

    kernels = check_kernels(model, batches[0])
    splits = []
    for name, r in check_train_kernels(model, train_batches[0], splits).items():
        kernels.setdefault(name, {}).update(r)
    for name, r in check_ssl_kernels(ssl_batches[0], brute_batches[0]).items():
        kernels.setdefault(name, {}).update(r)
    kernels.update(hold_stem(model, torch.Generator(device="cuda").manual_seed(10)))
    for what, r in (("eval", kernels["segment_sum"]),
                    ("train", kernels["segment_sum"]["train_embedder"]),
                    ("skewed, eval shape", kernels["segment_sum"]["skewed"])):
        print(f"segment_sum embedder ({what}) {r['shape']}: points per occupied "
              f"pillar mean {r['points_per_occupied_row']['mean']:.2f}, max "
              f"{r['points_per_occupied_row']['max']}; {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.0%}), plain "
              f"{r['plain_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} ms")
    measure_splits(splits)
    lap("3 kernels")
    for name, r in check_new_patterns(model, make_batch(100)).items():
        kernels[name].update(r)
    for what, args in (("", (ssl_batches[1],)), (" (skewed clouds)", (None, " (skewed)"))):
        worst, share = sweep_vs_brute(*args)
        print(f"sweep vs brute (full width){what}: largest difference over its "
              f"tolerance {worst:.3f}; same neighbour on {share:.6f} of the rows whose "
              f"neighbour lies below ring*cell")
        if not (worst <= 1.0 and share == 1.0):
            raise SystemExit("the sweep and the brute search disagree below the radius")
    lap("3b, sweep against brute")

    no_ssl = {"segment_sum_lanes": 0, "cell_sweep": 0, "chamfer_brute": 0}
    metrics, tables, device_ms, eval_launches = run_main_path(model, batches)
    want = {"segment_sum": 2 * NUM_BATCHES, "sorted_gather": NUM_BATCHES,
            "fused_gru": NUM_BATCHES, "fused_gru_bwd": 0, "cbg_fwd": 0, "cbg_bwd": 0,
            **no_ssl, **NO_STEM, "stem_fwd": 3 * NUM_BATCHES}
    print(f"launches on the eval path: {eval_launches} (want {want})")
    if eval_launches != want:
        raise SystemExit("the eval path did not launch every kernel as expected")
    for table in tables:
        print(table.table())
    med, mean = float(np.median(device_ms[1:])), float(np.mean(device_ms[1:]))
    print("eval step device ms per batch: "
          + ", ".join(f"{t:.3f}" for t in device_ms)
          + f"; steady median {med:.3f} ms = {B / med * 1e3:.2f} pairs/s"
          + f" (mean {mean:.3f} ms = {B / mean * 1e3:.2f} pairs/s)")
    if not all(np.isfinite(metrics[k]) for k in ("EPE_3way_mean", "Static_EPE_mean",
                                                   "Dynamic_NormEPE_mean")):
        raise SystemExit("the 3-way or bucketed EPE is not finite")
    lap("4 eval")
    entry_launches = run_entry_phase(model, med)
    lap("4b eval entry")

    runs = {}
    for label, loss_name, bts, extra in (
            ("train", "deflowLoss", train_batches, {}),
            ("ssl", "seflowLoss", ssl_batches, {"cell_sweep": 2, "segment_sum_lanes": 1}),
            ("ssl 2 x 16,384", "seflowLoss", brute_batches, {"chamfer_brute": 4})):
        torch.cuda.reset_peak_memory_stats()
        _, step_ms, launches = run_train_path(model, bts, loss_name, label)
        want = {k: (extra.get(k, v)) * len(bts) for k, v in PER_STEP.items()}
        print(f"launches on the {label} path: {launches} (want {want})")
        if launches != want:
            raise SystemExit(f"the {label} path did not launch every kernel as expected")
        med = float(np.median(step_ms[1:]))
        print(f"{label} step device ms: " + ", ".join(f"{t:.3f}" for t in step_ms)
              + f"; steady median {med:.3f} ms = {TRAIN_B / med * 1e3:.2f} pairs/s; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        runs[label] = (launches, len(bts), med)
    lap("5-6 train, ssl")

    entry = run_train_entry({"train": runs["train"][2], "ssl": runs["ssl"][2]},
                            train_batches[0])
    lap("5b train entry")
    rest = run_rest_of_model(model, batches, train_batches)
    lap("8 rest of the model")

    ref_err = reference_check(seed=7)
    print(f"reference check (f32, 64x64 grid, card vs CPU): max |d pred_flow| "
          f"{ref_err:.3e} (tol 2e-4)")
    if not ref_err < 2e-4:
        raise SystemExit("card and CPU disagree on the small f32 input")
    for what, loss_name, grid in (("deflowLoss", "deflowLoss", False),
                                  ("seflowLoss, grid branch", "seflowLoss", True),
                                  ("seflowLoss, brute branch", "seflowLoss", False)):
        ratio = train_reference_check(7, loss_name, grid)
        held = [k for k in ratio if k != "param" or loss_name == "deflowLoss"]
        print(f"train reference check ({what}; f32, 64x64 grid, 2 x 4,096 slots, "
              "one Adam step, card vs CPU): largest difference over its tolerance: "
              + ", ".join(f"{k} {v:.3f}" + ("" if k in held else " (not held)")
                          for k, v in ratio.items()))
        if not all(ratio[k] <= 1.0 for k in held):
            raise SystemExit(f"card and CPU disagree on the small f32 {what} step")
    for what, kw in (("(a) the MMHead eval", {"model_cfg": {"decoder_option": "mmhead"}}),
                     ("(d) the eval without host prep", {"hosted": False})):
        err = reference_check(seed=7, **kw)
        print(f"reference check {what} (f32, 64x64 grid, card vs CPU): max |d "
              f"pred_flow| {err:.3e} (tol 2e-4)")
        if not err < 2e-4:
            raise SystemExit(f"card and CPU disagree on {what}")
    # the MMHead's parameters after Adam's first step are not held, as
    # seflowLoss's are not: its f32 gradients are poorly conditioned (ReLU
    # inputs near 0 through four post-norm layers), and Adam maps a
    # gradient element near its eps anywhere in [-lr, lr]
    for what, kw, held in (("(b) the MMHead deflowLoss step, dropout 0",
                            {"model_cfg": {"decoder_option": "mmhead"}},
                            ("loss", "grad_norm", "grad")),
                           ("(c) the num_frames=3 deflowLoss step", {"num_frames": 3},
                            ("loss", "grad_norm", "grad", "param"))):
        ratio = train_reference_check(7, **kw)
        print(f"train reference check {what} (f32, 64x64 grid, 2 x 4,096 slots, one "
              "Adam step, card vs CPU): largest difference over its tolerance: "
              + ", ".join(f"{k} {v:.3f}" + ("" if k in held else " (not held)")
                          for k, v in ratio.items()))
        if not all(ratio[k] <= 1.0 for k in held):
            raise SystemExit(f"card and CPU disagree on {what}")

    lap("7 reference checks")
    dp = run_data_parallel(model, train_batches)
    lap("9 data parallelism")
    surface, surface_launches = run_last_surface(batches, ssl_batches)
    lap("11 last surface")
    ablations, ablation_launches = run_ablations(batches, train_batches)
    lap("12 ablation paths")
    fine_model = build_model(FINE, precision="bf16", seed=0)
    fine_batch, _ = held_prep(make_batch(1100), FINE_VOXEL)
    for name, r in check_fine_kernels(fine_model, fine_batch, splits).items():
        kernels[name].update(r)
    del fine_model, fine_batch
    measure_splits(splits)
    lap("12 kernels at 1024^2")
    ablations["drift witness"] = drift_witness(
        model, train_batches, {"period_ms": entry["period_ms"], "train_ms": runs["train"][2]})
    lap("12 drift witness")

    sources = {"segment_sum": ("deflow_tpu_torch/csrc/segment_sum.cu",
                               "deflow_tpu/ops/pallas_scatter.py:211"),
               "sorted_gather": ("deflow_tpu_torch/csrc/sorted_gather.cu",
                                 "deflow_tpu/ops/pallas_gather.py:129"),
               "fused_gru": ("deflow_tpu_torch/csrc/fused_gru.cu",
                             "deflow_tpu/ops/pallas_gru.py:196"),
               "fused_gru_bwd": ("deflow_tpu_torch/csrc/fused_gru_bwd.cu",
                                 "deflow_tpu/ops/pallas_gru.py:224"),
               "cbg_fwd": ("deflow_tpu_torch/csrc/cbg.cu",
                           "deflow_tpu/ops/pallas_cbg.py:241"),
               "cbg_bwd": ("deflow_tpu_torch/csrc/cbg.cu",
                           "deflow_tpu/ops/pallas_cbg.py:414"),
               "segment_sum_lanes": ("deflow_tpu_torch/csrc/segment_sum_lanes.cu",
                                     "deflow_tpu/ops/pallas_scatter.py:347"),
               "cell_sweep": ("deflow_tpu_torch/csrc/cell_sweep.cu",
                              "deflow_tpu/ops/pallas_sweep.py:205"),
               "chamfer_brute": ("deflow_tpu_torch/csrc/chamfer_brute.cu",
                                 "deflow_tpu/ops/pallas_chamfer.py:79"),
               **{name: ("deflow_tpu_torch/csrc/stem.cu", "none (XLA's convolution)")
                  for name in ("stem_fwd", "stem_dgrad", "stem_wgrad")}}
    # launches: kernels 1-6 from the train path's run, the sweep and the lane
    # sum from the SSL path's, the brute search from the 2 x 16,384 SSL run;
    # the per-step counts of every path (and the eval path's) beside them
    home = {"segment_sum_lanes": "ssl", "cell_sweep": "ssl",
            "chamfer_brute": "ssl 2 x 16,384"}
    per = lambda label, name: runs[label][0][name] / runs[label][1]
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": runs[home.get(name, "train")][0][name],
             "launches_per_train_step": per("train", name),
             "launches_per_ssl_step": per("ssl", name),
             "launches_per_ssl_brute_step": per("ssl 2 x 16,384", name),
             **({"eval_launches": eval_launches[name],
                 "entry_launches": entry_launches[name]} if eval_launches[name] else {}),
             "train_entry_launches": entry["ssl_launches" if name in (
                 "segment_sum_lanes", "cell_sweep") else "launches"][name],
             "ssl_train_entry_launches": entry["ssl_launches"][name],
             "mmhead_eval_launches": rest["(a) mmhead eval"]["launches"][name],
             "mmhead_train_launches": rest["(b) mmhead train"]["launches"][name],
             "history_train_launches": rest["(c) num_frames=3 train"]["launches"][name],
             "device_eval_launches": rest["(d) eval without host prep"]["launches"][name],
             "dp_launches_per_rank": [sum(r[run]["launches"][name] for run in DP_RUNS)
                                      for r in dp["ranks"]],
             "last_surface_launches": {k: v[name] for k, v in surface_launches.items()},
             "ablation_launches": {k: v[name] for k, v in ablation_launches.items()},
             **kernels[name]}
            for name, (src, rep) in sources.items()]
    print(json.dumps({"rest_of_model": {
        k: ({kk: vv for kk, vv in v.items() if kk != "launches"} if isinstance(v, dict)
            else v) for k, v in rest.items()}}))
    print(json.dumps({"data_parallel": {k: v for k, v in dp.items() if k != "ranks"}}))
    print(json.dumps({"last_surface": surface}))
    print(json.dumps({"ablations": ablations}))
    print(json.dumps({"phase_seconds": walls}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
