"""Readings that a cell's limits are set from, many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds <s1,s2,...> \
        --kinds program+fp8,half_batch,unchanged [--out <file.jsonl>]

For each seed, set-up and the window's checked steps run as in a
benchmark run (a window of no seconds), then the numbers compared with
the reference are read:
``program`` the program as it is; ``fp8`` the control, the reference
computed with its operands rounded to float8 e4m3 in the program's place
(the precision below the configuration's bf16); ``half_batch`` the
program with each step given only the first half of its batch, the loss
its mean over the rest; ``unchanged`` the program with its optimizer step
skipped, so the step returns the state unchanged.  One JSON line a
reading.  The benchmark's own runs never run these.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def fault(kind: str):
    """The program's train step broken as ``kind`` says, while inside."""
    from deflow_tpu_torch import trainer

    original = trainer.make_train_step
    if kind == "half_batch":
        def make(*args, **kwargs):
            step = original(*args, **kwargs)

            def half(state, batch):
                b = next(iter(batch.values())).shape[0]
                return step(state, {k: v[: b // 2] for k, v in batch.items()})
            return half
    elif kind == "unchanged":
        def make(*args, **kwargs):
            step = original(*args, **kwargs)

            def still(state, batch):
                state.optimizer.step = lambda *a, **k: None
                return step(state, batch)
            return still
    else:
        make = original
    trainer.make_train_step = make
    try:
        yield
    finally:
        trainer.make_train_step = original


def readings(cell: str, seed: int, kind: str, device, overrides=None) -> list:
    """One seed's numbers: of the program and the control (``kind``
    "program,fp8"), or of the program with a fault (``kind`` a fault)."""
    from portbench import run
    from portbench.drivers.train import WARMUP_STEPS, TrainRun
    from portbench.lib.common import Spans

    _, _, config, workload = run.load_cell(cell, overrides)
    t0 = time.perf_counter()
    kinds = kind.split("+")
    with fault(kinds[0]):
        r = TrainRun(config, workload, seed, device, Spans())
        r.setup_steps(WARMUP_STEPS)
        r.restart()
        r.window(0.0)
    r.close()
    numbers = r.check(controls=kinds[1:], detail=True)
    return [{"cell": cell, "seed": seed, "kind": kinds[0] if q is None else q, **v,
             "seconds": time.perf_counter() - t0} for q, v in numbers.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="program")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    try:
        for kind in args.kinds.split(","):
            for seed in (int(s) for s in args.seeds.split(",")):
                for r in readings(args.workload, seed, kind, dev):
                    line = json.dumps(r)
                    print(line, flush=True)
                    if out:
                        print(line, file=out, flush=True)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
