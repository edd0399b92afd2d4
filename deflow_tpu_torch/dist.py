"""Data parallelism over a ``torch.distributed`` process group.

Counterpart of the JAX package's ``data`` mesh (``deflow_tpu/trainer.py``
``create_mesh``, ``batch_sharding``, ``replicated``) and of the mesh
arguments threaded through its steps.  One process per card (a rank); each
rank holds a full replica of the parameters and its own rows of every global
batch.  A run over W ranks computes what the JAX package computes on a
W-device mesh:

- the loss is the global one: each rank's loss is its share of it (the
  masked means divide by the global counts, the SeFlow loss by the global
  sample count), so the gradients are SUMMED over ranks (``all_reduce_grads``),
  never averaged as ``DistributedDataParallel`` does;
- BatchNorm takes its statistics over the global batch (``all_reduce_sum``
  in the forward, whose backward sums the incoming gradients, as
  ``SyncBatchNorm`` does);
- parameters, optimizer state and BN running statistics start from rank 0's
  (``broadcast_module``) and stay bit for bit equal on every rank.

Every collective here is an ``all_reduce`` or a ``broadcast``, the two that
gloo offers on CUDA tensors, except ``gather_host``, which gathers host
objects (pickled into CPU tensors under gloo).  Without a process group
every helper is the identity, so single-process code runs unchanged; under a
group of any size, world 1 included, the collectives run.

Launch on cards with ``torchrun --nproc_per_node=W -m
deflow_tpu_torch.entry.train ...``; dry run on the CPU with ``python -m
deflow_tpu_torch.dist [W]`` (:func:`dryrun_multichip`).
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a rank that misses a collective fails the run after this long, instead of
# hanging it
TIMEOUT = timedelta(minutes=10)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    """This process's card on its host: torchrun's ``LOCAL_RANK`` (0 when
    unset)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     device=None) -> None:
    """Join the process group.  ``rank`` and ``world_size`` default to
    torchrun's ``RANK`` and ``WORLD_SIZE`` (0 and 1 when unset),
    ``init_method`` to ``env://`` (torchrun's ``MASTER_ADDR`` and
    ``MASTER_PORT``).  ``backend`` defaults to ``nccl`` on the card and
    ``gloo`` on the CPU (``device``: the card when one is visible, unless
    ``"cpu"``).  Under nccl the process's current card becomes
    ``cuda:LOCAL_RANK``."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=TIMEOUT)


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def launched(device=None):
    """Within this context, the process group of the launcher that started
    this process (torchrun sets ``WORLD_SIZE``), on the backend of
    ``device`` (``"cpu"``: gloo; else nccl); nothing when no launcher did,
    or a group exists already.  The group is left at the end."""
    if "WORLD_SIZE" not in os.environ or is_initialized():
        yield
        return
    init_distributed(device="cpu" if str(device) == "cpu" else "cuda")
    try:
        yield
    finally:
        shutdown()


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the incoming gradients over ranks
    (every rank's loss share reads the sum)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, differentiable (``x`` itself without a
    process group)."""
    return _AllReduceSum.apply(x) if is_initialized() else x


def all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over ranks in place, outside autograd (counts, partial
    sums inside a hand-written backward); returns ``x``."""
    if is_initialized():
        with torch.no_grad():
            dist.all_reduce(x)
    return x


def broadcast_module(model: torch.nn.Module) -> None:
    """Parameters and buffers (BN running statistics) from rank 0."""
    if not is_initialized():
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, 0)


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's ``.grad`` over ranks: one flat f32 buffer, one
    SUM.  A parameter without a gradient gets zeros first, so every rank
    packs the same layout."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if not is_initialized() or not params:
        return
    grads = [p.grad for p in params]
    if any(g.dtype != torch.float32 for g in grads):
        raise ValueError("all_reduce_grads packs f32 gradients only")
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t [b, ...]`` stacked in rank order, ``[W·b, ...]``, on
    every rank (each rank fills its rows of a zeroed buffer, and the buffer
    is summed: exact).  Floating and integer tensors; ``t`` itself without
    a process group."""
    if not is_initialized():
        return t
    b = t.shape[0]
    out = t.new_zeros((world() * b, *t.shape[1:]))
    out[rank() * b:(rank() + 1) * b] = t
    dist.all_reduce(out)
    return out


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_host(batch: Dict, keys: Sequence[str]) -> Optional[Dict]:
    """``keys`` of every rank's host batch, on rank 0, rows in rank order:
    arrays concatenated on axis 0, lists joined.  None on the other ranks;
    ``batch`` itself without a process group."""
    if not is_initialized():
        return batch
    mine = {k: batch[k] for k in keys if k in batch}
    parts: Optional[List[Dict]] = [None] * world() if is_main() else None
    dist.gather_object(mine, parts, dst=0)
    if not is_main():
        return None
    merged = {}
    for k in parts[0]:
        vals = [p[k] for p in parts]
        merged[k] = (np.concatenate(vals) if isinstance(vals[0], np.ndarray)
                     else [v for part in vals for v in part])
    return merged


# ----------------------------------------------------------- spawned ranks
def _rank_main(fn, r, world_size, backend, device, init_method, args, results):
    os.environ.update(RANK=str(r), WORLD_SIZE=str(world_size),
                      LOCAL_WORLD_SIZE=str(world_size))
    if torch.device(device).type == "cuda":
        # ranks beyond the host's cards share them (gloo only: nccl refuses
        # two ranks on one card)
        os.environ["LOCAL_RANK"] = str(r % torch.cuda.device_count())
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    else:
        os.environ["LOCAL_RANK"] = str(r)
    # one thread a rank: ranks spawned beside busy processes (a test run's
    # workers) slow everyone down many times over when their thread pools
    # spin against each other; on the card the work is the card's
    torch.set_num_threads(1)
    try:
        init_distributed(backend, init_method, r, world_size, device=device)
        out = fn(*args)
    except BaseException:
        results.put((r, False, traceback.format_exc()))
        raise
    else:
        # pickled here, so that tensors travel as bytes and not as shared
        # memory, which the parent could open only while this process lives
        results.put((r, True, pickle.dumps(out)))
    finally:
        shutdown()


def run_ranks(fn: Callable, world: int = 2, backend: str = "gloo", device: str = "cpu",
              args: Sequence = (), timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world`` spawned processes joined in a process
    group of ``backend`` (each rank on ``device``: the CPU, or the card
    ``cuda:rank % cards``), and return their results in rank order.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function).  The
    ranks meet at a ``file://`` store in a fresh temporary directory, so
    concurrent callers never race for a port.  Raises the first error a
    rank reports (the others are then killed), or ``TimeoutError`` after
    ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="deflow_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, device,
                               f"file://{os.path.join(tmp, 'store')}", tuple(args),
                               results))
             for r in range(world)]
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {world - len(out)} of {world} ranks "
                                   f"gave no result within {timeout:.0f} s")
            try:
                r, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {r} failed:\n{payload}")
            out[r] = pickle.loads(payload)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]


# --------------------------------------------------------------- dry run
def _dryrun_rank():
    """One data-parallel deflowLoss step of a tiny DeFlow on this rank's 2
    rows (512 slots each) of a seeded global batch; returns (global loss,
    grad_norm)."""
    from deflow_tpu_torch.data.host_prep import attach_host_prep
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import init_train_state, make_train_step

    voxel, pc_range = [3.2, 3.2, 6.0], [-51.2, -51.2, -3.0, 51.2, 51.2, 3.0]
    rng = np.random.default_rng(0)
    rows, n = 2, 512
    b = rows * world()
    cloud = lambda: np.concatenate([rng.uniform(-45, 45, (b, n, 2)),
                                    rng.uniform(-2, 2, (b, n, 1))], -1).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    hb = {"pc0": cloud(), "pc1": cloud(), "pose0": pose, "pose1": pose.copy(),
          "pc0_mask": rng.random((b, n)) < 0.9, "pc1_mask": rng.random((b, n)) < 0.9,
          "flow": rng.normal(0, 0.1, (b, n, 3)).astype(np.float32),
          "flow_is_valid": np.ones((b, n), bool),
          "flow_category_indices": rng.integers(0, 20, (b, n)).astype(np.int32)}
    lo = rank() * rows
    hb = attach_host_prep({k: v[lo:lo + rows] for k, v in hb.items()}, voxel, pc_range)
    model = build_model({"voxel_size": voxel, "point_cloud_range": pc_range,
                         "grid_feature_size": [32, 32], "num_iters": 2},
                        device="cpu", seed=0)
    state = init_train_state(model, {"lr": 2e-4}, device="cpu")
    state, aux = make_train_step(model, "deflowLoss", device="cpu")(state, hb)
    return float(aux["loss"]), float(aux["grad_norm"])


def dryrun_multichip(n: int) -> None:
    """The full data-parallel train step (global BN, global loss, summed
    gradients) on ``n`` gloo CPU ranks at tiny shapes (2 samples of 512
    slots a rank, a 32² grid); counterpart of ``__graft_entry__.py``
    ``dryrun_multichip``.  Raises unless every rank reports the same finite
    loss and gradient norm."""
    got = run_ranks(_dryrun_rank, n, "gloo", "cpu")
    if len(set(got)) != 1 or not np.all(np.isfinite(got[0])):
        raise RuntimeError(f"dryrun_multichip({n}): the ranks disagree: {got}")
    print(f"dryrun_multichip({n}): loss {got[0][0]:.6f}, grad_norm {got[0][1]:.6f} "
          f"on every rank")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
