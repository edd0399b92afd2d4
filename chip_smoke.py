#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deflow_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. the card's name and power limit (nvidia-smi);
2. build every kernel from ``deflow_tpu_torch/csrc`` with nvcc (sm_90a);
3. each kernel at the main path's shapes, in bf16 and in f32 (TF32 off):
   its error against its plain PyTorch version, its time, the plain
   version's time, one library call's time, and the bound;
4. the main path: leaderboard DeFlow (512x512 grid, ConvGRU, 4 iterations,
   bf16 compute, random weights from a seed) evaluates 3 synthetic batches
   of 4 x 98,304 point slots (86,016 valid) through ``run_validation``; the
   launch counters must show 2 scatters, 1 gather and 1 GRU per batch;
   then one more step under torch.profiler: device time by kernel and the
   device's idle share;
5. a reference check: the same model in f32 on a small input, on the card
   against the CPU (plain PyTorch versions);
6. one JSON line of kernels, the card line, and the result line.
Needs one CUDA card; exits non-zero without one.
"""

import json
import subprocess
import sys
import time

import numpy as np

B, N, VALID = 4, 98304, 86016
VOXEL = [0.2, 0.2, 6.0]
RANGE = [-51.2, -51.2, -3.0, 51.2, 51.2, 3.0]
LEADERBOARD = {"voxel_size": VOXEL, "point_cloud_range": RANGE,
               "grid_feature_size": [512, 512], "feat_channels": 32,
               "decoder_option": "gru", "num_iters": 4}
NUM_BATCHES = 3
# H100 SXM data sheet: HBM 3.35 TB/s, dense bf16 tensor cores 989 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def make_batch(seed: int, b: int = B, n: int = N, valid: int = VALID):
    """Synthetic AV2-shaped host batch: uniform clouds over the range, a
    moving ego, ~40% foreground points of which half move."""
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
    return {"pc0": pc0, "pc1": pc1, "pose0": pose0, "pose1": pose1,
            "pc0_mask": mask, "pc1_mask": mask.copy(), "flow": flow,
            "flow_is_valid": mask.copy(),
            "flow_category_indices": cls.astype(np.int32)}


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


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(model, host_batch):
    """Phase 3: every kernel against its plain version at the main path's
    shapes; returns the bf16 (main path) measurements per kernel."""
    import torch

    from deflow_tpu_torch.ops import gather, gru, scatter, voxel
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
    s = B * seg
    valid = (ids < s)[:, None]
    feats32 = torch.relu(torch.randn(ids.shape[0], 33, generator=g, device=dev))
    feats32[:, 32] = 1.0
    feats32 = torch.where(valid, feats32, 0.0)
    idx_lib = torch.where(ids < s, ids, s).long()
    for dt in (torch.float32, torch.bfloat16):
        f = feats32.to(dt)
        k = scatter.sorted_segment_sum(f, ids, s)
        ref = scatter.segment_sum_plain(f, ids, s)
        torch.cuda.synchronize()
        err = (k.float() - ref.float()).abs().max().item()
        rtol, atol = ((1e-5, 1e-5) if dt == torch.float32 else (2 ** -7, 1e-6))
        ok = torch.allclose(k.float(), ref.float(), rtol=rtol, atol=atol)
        print(f"segment_sum {dt}: max_abs_err {err:.3e} "
              f"(tol rtol {rtol:g} atol {atol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("segment_sum disagrees with its plain version")
    f = feats32.to(torch.bfloat16)
    n, c = f.shape
    isz = f.element_size()
    b_ms, b_by = bound(n * c * isz + n * 4 + s * c * isz, n * c,
                       BF16_FLOP_PER_S)
    results["segment_sum"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: scatter.sorted_segment_sum(f, ids, s), 50),
        "plain_ms": cuda_ms(lambda: scatter.segment_sum_plain(f, ids, s), 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.zeros(
            s + 1, c, dtype=f.dtype, device=dev).index_add_(0, idx_lib, f), 10),
    }

    # -- row gather: the decoder's [B*P, 128] table at pc0's real ids
    info = voxel.pillar_info_from_ids(db["pc0_transformed"], db["pc0_mask"],
                                      db["pc0_ids"], cfg)
    boff = (torch.arange(B, dtype=torch.int32, device=dev) * p)[:, None]
    gids = torch.where(info.valid, info.pillar_id + boff,
                       voxel.GATHER_SENTINEL).reshape(-1).to(torch.int32)
    table32 = torch.randn(B * p, 128, generator=g, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        t = table32.to(dt)
        k = gather.sorted_rows_gather(t, gids, B * p)
        ref = gather.gather_plain(t, gids, B * p)
        torch.cuda.synchronize()
        exact = torch.equal(k, ref)
        err = (k.float() - ref.float()).abs().max().item()
        print(f"sorted_gather {dt}: max_abs_err {err:.3e} (tol: bit-exact) "
              f"{'ok' if exact else 'FAIL'}")
        if not exact:
            raise SystemExit("sorted_gather is not bit-exact")
    t = table32.to(torch.bfloat16)
    t_lib = torch.cat([t, t.new_zeros(1, 128)])
    idx_lib = torch.where(gids < B * p, gids, B * p).long()
    m = gids.shape[0]
    rows = torch.unique(gids[gids < B * p]).numel()
    row_bytes = 128 * t.element_size()
    b_ms, b_by = bound(m * 4 + rows * row_bytes + m * row_bytes, 0,
                       BF16_FLOP_PER_S)
    results["sorted_gather"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: gather.sorted_rows_gather(t, gids, B * p), 50),
        "plain_ms": cuda_ms(lambda: gather.gather_plain(t, gids, B * p), 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.index_select(t_lib, 0, idx_lib), 50),
    }

    # -- fused GRU: [B*N, 128] hidden, [B*N, 64] input, the model's weights
    iters = model.head.num_iters
    h32 = torch.randn(B * N, 128, generator=g, device=dev) * 0.5
    x32 = torch.randn(B * N, 64, generator=g, device=dev) * 0.5
    w32 = [w.detach().float().contiguous() for w in model.head.gru.merged_weights()]
    for dt in (torch.float32, torch.bfloat16):
        args = [h32.to(dt), x32.to(dt)] + [w.to(dt).contiguous() for w in w32]
        k = gru.fused_gru(*args, iters)
        ref = gru.fused_gru_plain(*args, iters)
        torch.cuda.synchronize()
        err = (k.float() - ref.float()).abs().max().item()
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
    flops = 2.0 * m * (hd + xdim) * (3 * hd) * iters
    nbytes = 2 * m * (hd + xdim + hd) + 2 * (hd + xdim) * 3 * hd + 2 * 3 * hd
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    results["fused_gru"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: gru.fused_gru(*args, iters), 10),
        "plain_ms": cuda_ms(lambda: gru.fused_gru_plain(*args, iters), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    for name, r in results.items():
        print(f"{name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']} ms)")
    return results


def run_main_path(model, batches):
    """Phase 4: ``run_validation`` over the batches; returns the metrics,
    the accumulator, per-batch device ms and the launch counts."""
    import torch

    from deflow_tpu_torch.entry.evaluate import run_validation
    from deflow_tpu_torch.metrics import ThreewayEPE
    from deflow_tpu_torch.ops import gather, gru, scatter
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

    wrappers = (scatter.sorted_segment_sum, gather.sorted_rows_gather,
                gru.fused_gru)
    for w in wrappers:
        w.launches = 0
    three = ThreewayEPE()
    metrics = run_validation(timed_step, batches, three)
    launches = {"segment_sum": scatter.sorted_segment_sum.launches,
                "sorted_gather": gather.sorted_rows_gather.launches,
                "fused_gru": gru.fused_gru.launches}
    profile_step(eval_step, batches[0])
    return metrics, three, device_ms, launches


def _category(name: str) -> str:
    n = name.lower()
    for cat, keys in (("segment_sum", ("segment_sum", "mark_runs")),
                      ("sorted_gather", ("gather_kernel",)),
                      ("fused_gru", ("gru_bf16", "gru_f32")),
                      ("conv/matmul (cuDNN, cuBLAS)",
                       ("conv", "cudnn", "xmma", "fprop", "implicit",
                        "winograd", "gemm")),
                      ("copy/memset", ("memcpy", "memset"))):
        if any(k in n for k in keys):
            return cat
    return "other (elementwise, cat, permute, interpolate)"


def profile_step(eval_step, host_batch) -> None:
    """Phase 4b: one more eval step under torch.profiler; device time by
    kernel category and name, and the device's idle share of the step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deflow_tpu_torch.trainer import device_batch

    db = device_batch(host_batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_step(db)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        print("profile: the profiler recorded no device time")
        return
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


def reference_check(seed: int) -> float:
    """Phase 5: f32 model on a small input, card vs CPU; max |Δ pred_flow|."""
    import torch

    from deflow_tpu_torch.data.host_prep import attach_host_prep
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import make_eval_step

    small = dict(LEADERBOARD, voxel_size=[1.6, 1.6, 6.0],
                 grid_feature_size=[64, 64])
    hb = attach_host_prep(make_batch(seed, b=2, n=4096, valid=3500),
                          small["voxel_size"], RANGE)
    outs = []
    for dev in ("cuda", "cpu"):
        model = build_model(small, precision="fp32", device=dev, seed=seed)
        outs.append(make_eval_step(model, device=dev)(hb)["pred_flow"].cpu())
    return (outs[0] - outs[1]).abs().max().item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from deflow_tpu_torch.data.host_prep import attach_host_prep
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build_all(force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    for name, info in logs.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"  {name}: {line.strip()}")

    model = build_model(LEADERBOARD, precision="bf16", seed=0)
    host_ms, batches = [], []
    for i in range(NUM_BATCHES):
        hb = make_batch(100 + i)
        t0 = time.perf_counter()
        batches.append(attach_host_prep(hb, VOXEL, RANGE))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    print("host prep ms per batch: " + ", ".join(f"{t:.1f}" for t in host_ms))

    kernels = check_kernels(model, batches[0])

    metrics, three, device_ms, launches = run_main_path(model, batches)
    want = {"segment_sum": 2 * NUM_BATCHES, "sorted_gather": NUM_BATCHES,
            "fused_gru": NUM_BATCHES}
    print(f"launches on the main path: {launches} (want {want})")
    if launches != want:
        raise SystemExit("the main path did not launch every kernel as expected")
    print(three.table())
    steady = float(np.mean(device_ms[1:]))
    print("eval step device ms per batch: "
          + ", ".join(f"{t:.3f}" for t in device_ms)
          + f"; steady {steady:.3f} ms = {B / steady * 1e3:.2f} pairs/s")
    if not np.isfinite(metrics["EPE_3way_mean"]):
        raise SystemExit("3-way EPE is not finite")

    ref_err = reference_check(seed=7)
    print(f"reference check (f32, 64x64 grid, card vs CPU): max |d pred_flow| "
          f"{ref_err:.3e} (tol 2e-4)")
    if not ref_err < 2e-4:
        raise SystemExit("card and CPU disagree on the small f32 input")

    sources = {"segment_sum": ("deflow_tpu_torch/csrc/segment_sum.cu",
                               "deflow_tpu/ops/pallas_scatter.py:211"),
               "sorted_gather": ("deflow_tpu_torch/csrc/sorted_gather.cu",
                                 "deflow_tpu/ops/pallas_gather.py:129"),
               "fused_gru": ("deflow_tpu_torch/csrc/fused_gru.cu",
                             "deflow_tpu/ops/pallas_gru.py:196")}
    rows = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], **kernels[name]}
            for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
