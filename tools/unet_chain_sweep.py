#!/usr/bin/env python3
"""Time each U-Net encoder group as the fused chain against its fallback.

    python3 tools/unet_chain_sweep.py [--grid 512] [--batches 4,8,16,32]
        [--dtypes bf16,f32] [--groups 256,128,64] [--iters 10] [--warm 3]
        [--device cuda] [--out FILE]

For each encoder group of ``deflow_tpu_torch``'s ``FastFlow3DUNet`` (the
stem and its 3x3 blocks, at the maps of a grid² pseudoimage), siamese batch
2B and compute dtype, runs the group under autograd in train mode both ways
(``FastFlow3DUNet.encode_group``): ``chain`` (the stem's convolution, then
``cbg_chain`` on ``csrc/cbg.cu``) and ``fallback`` (the group's
``ConvWithNorms`` modules one by one: library convolutions, BN + GELU in
f32 passes).  Either route runs for any group, whether the model chains it
or not.  Both routes take the same input, laid out as the model hands it
over: channels-last in the compute dtype into the 256 group (the pillar
table's view), channels-last f32 into the others (what either route of the
previous group returns; each row says whether its own output was
channels-last).  f32 runs each route twice, with cuDNN's TF32 on (PyTorch's
default, which the port's entries keep) and off.

Each row: forward and backward device ms (CUDA events from a drained card,
median over ``--iters`` after ``--warm``), the bytes autograd keeps after
the forward and the peak over forward and backward, both above what was
allocated before, and on the chain's rows its largest difference from the
fallback (output, input gradient and each weight's gradient, each
relative to the fallback's largest element; the weights' also by leaf).
A bf16 row also gives its route's differences from the fallback in f32
with TF32 off on the same input (``vs_f32``), which tells a route's own
error from the gap between two bf16 routes.  One JSON line a row, the
card's name and power limit first.  On a CPU device (tiny shapes only) the
chain takes the kernels' plain versions and the times are host times.

Imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from deflow_tpu_torch.models.unet import _GROUP_STEPS, FastFlow3DUNet  # noqa: E402

# each group's input channels and its input map over the grid's side
GROUP_IN = {"256": (32, 1), "128": (64, 2), "64": (128, 4)}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def card_line(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


class Clock:
    """Device ms between marks: CUDA events, or the host clock on a CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        import time
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b)
        return 1e3 * (b - a)


def make_input(tag, b2, grid, dtype, dev, seed):
    cin, div = GROUP_IN[tag]
    side = grid // div
    g = torch.Generator(device="cpu").manual_seed(seed)
    nhwc = torch.randn(b2, side, side, cin, generator=g)
    x = nhwc.to(dev, dtype if tag == "256" else torch.float32).permute(0, 3, 1, 2)
    return x.detach().requires_grad_()


def params_of(model, tag):
    return {f"encoder_step_{i}.{n}": p for i in _GROUP_STEPS[tag]
            for n, p in getattr(model, f"encoder_step_{i}").named_parameters()}


def measure(model, tag, x, dtype, route, dev, iters, warm, seed):
    clock = Clock(dev)
    params = list(params_of(model, tag).values())
    fwd, bwd, dy = [], [], None
    saved = peak = 0
    for it in range(warm + iters):
        x.grad = None
        for p in params:
            p.grad = None
        if clock.cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        t0 = clock.mark()
        y = model.encode_group(tag, x, dtype, route == "chain")
        t1 = clock.mark()
        if clock.cuda:
            saved = torch.cuda.memory_allocated(dev) - base
        if dy is None:
            g = torch.Generator(device="cpu").manual_seed(seed + 1)
            dy = torch.randn(y.shape[0], y.shape[2], y.shape[3], y.shape[1],
                             generator=g).to(dev).permute(0, 3, 1, 2)
            if y.is_contiguous():
                dy = dy.contiguous()
        y.backward(dy)
        t2 = clock.mark()
        f, b = clock.ms(t0, t1), clock.ms(t1, t2)
        if clock.cuda:
            peak = torch.cuda.max_memory_allocated(dev) - base
        if it >= warm:
            fwd.append(f)
            bwd.append(b)
    grads = [x.grad.detach().float().clone()] + [p.grad.detach().float().clone()
                                                 for p in params]
    return {"fwd_ms": statistics.median(fwd), "bwd_ms": statistics.median(bwd),
            "fwd_ms_range": [min(fwd), max(fwd)], "bwd_ms_range": [min(bwd), max(bwd)],
            "saved_bytes": saved, "peak_bytes": peak,
            "y_channels_last": y.is_contiguous(memory_format=torch.channels_last)
            }, y.detach().float(), grads


def rel_err(a, ref):
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def errors(got, ref, names):
    """(y, grads) against (y, grads): the output, the input gradient, the
    worst weight gradient and each weight gradient by leaf."""
    (y, grads), (ry, rg) = got, ref
    by_leaf = {n: rel_err(a, r) for n, a, r in zip(names, grads[1:], rg[1:]) if r.dim() > 1}
    return {"err_y": rel_err(y, ry), "err_dx": rel_err(grads[0], rg[0]),
            "err_dparams": max(by_leaf.values()), "err_dw": by_leaf}


def sweep(args):
    dev = torch.device(args.device)
    print(json.dumps({"card": card_line(dev), "torch": torch.__version__,
                      "cuda": torch.version.cuda, "grid": args.grid}), flush=True)
    torch.manual_seed(0)
    model = FastFlow3DUNet(stem_cin=32).to(dev).train()
    rows = []
    tf32_default = torch.backends.cudnn.allow_tf32
    for tag in args.groups.split(","):
        names = list(params_of(model, tag))
        for name in args.dtypes.split(","):
            dtype = DTYPES[name]
            for b2 in (int(v) for v in args.batches.split(",")):
                x = make_input(tag, b2, args.grid, dtype, dev, seed=7)
                ref = None
                if name == "bf16":
                    torch.backends.cudnn.allow_tf32 = False
                    x32 = x.detach().float().requires_grad_()
                    ref = measure(model, tag, x32, torch.float32, "fallback", dev, 1, 0,
                                  seed=7)[1:]
                    del x32
                for tf32 in ((True, False) if name == "f32" else (tf32_default,)):
                    torch.backends.cudnn.allow_tf32 = tf32
                    got = {}
                    for route in ("fallback", "chain"):
                        row, y, grads = measure(model, tag, x, dtype, route, dev,
                                                args.iters, args.warm, seed=7)
                        row.update(group=tag, b2=b2, dtype=name, route=route,
                                   tf32=tf32 if name == "f32" else None)
                        got[route] = (y, grads)
                        if ref is not None:
                            row["vs_f32"] = errors((y, grads), ref, names)
                        if route == "chain":
                            row.update(errors((y, grads), got["fallback"], names))
                            fb = rows[-1]
                            row["speedup_fwd"] = fb["fwd_ms"] / row["fwd_ms"]
                            row["speedup_bwd"] = fb["bwd_ms"] / row["bwd_ms"]
                        rows.append(row)
                        print(json.dumps(row), flush=True)
                    del got
                del x, ref
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = tf32_default
    print(json.dumps({"card": card_line(dev)}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--batches", default="4,8,16,32")
    ap.add_argument("--dtypes", default="bf16,f32")
    ap.add_argument("--groups", default="256,128,64")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    return sweep(ap.parse_args(argv))


if __name__ == "__main__":
    main()
