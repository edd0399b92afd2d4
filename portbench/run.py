"""The benchmark of deflow_tpu_torch: one cell, one run, one result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Everything is found by name: the cell in ``BENCHMARK.json``, its
traffic, loop and limits in ``portbench/workloads/<cell>.json``, its
configuration in ``portbench/configs/<config>.json``, its loop in
``portbench/drivers/<mode>.py``, each metric's reader in
``portbench/metrics/<metric>.py``, and its head's plain reference and
counts in ``portbench/{reference,counts}/heads/<decoder_option>.py``.
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and a breakdown of the traced steps.
The last lines on standard error, and the line's last key ``checks``,
give each number compared with the plain reference beside its limit.

Exits 3 without the cards the cell needs, 4 when JAX or the JAX package is
loaded once the window has closed; either way no result is printed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deflow_tpu")


def load_cell(name: str, overrides=None):
    """(benchmark, cell entry, configuration, workload) of cell ``name``;
    ``overrides`` ({"model", "train", "traffic", "workload"}) shrink a run
    for the CPU tests."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    ov = overrides or {}
    config["model"].update(ov.get("model", {}))
    config["train"].update(ov.get("train", {}))
    workload["traffic"].update(ov.get("traffic", {}))
    workload.update(ov.get("workload", {}))
    return bench, cell, config, workload


def metric_names(bench, cell_name: str, trace: bool):
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def read_metric(name: str, ctx):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def loaded_forbidden():
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             overrides=None):
    """Run cell ``name`` on ``device``; returns the result dict (its
    ``checks`` last) and the context the metrics were read from."""
    import torch

    from portbench.lib.common import Spans, device_info

    bench, cell, config, workload = load_cell(name, overrides)
    driver = importlib.import_module(f"portbench.drivers.{workload['mode']}")
    ctx = driver.run(config, workload, seed, seconds, trace, device, Spans())
    ctx["setup_s"] = ctx["setup_end"] - T0
    metrics = {}
    for m in metric_names(bench, name, trace):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = ctx.pop("check_run").check()[None]
    limits = workload["limits"]
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and not ctx["failed"]
    dev = device_info(torch, int(cell["chips"]), ctx["peak_bytes"])
    result = {"correct": bool(correct), "attempted": int(ctx["attempted"]),
              "failed": int(ctx["failed"]), "metrics": metrics, "device": dev}
    result["host"] = host_summary(ctx)
    traced = ctx.get("traced")
    if trace and traced and traced.get("trace"):
        from portbench.lib.trace import breakdown

        tr = traced["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = breakdown(tr)
    result["checks"] = {k: {"value": _number(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    return result, ctx


def host_summary(ctx):
    """The harness's spans in ms each over the window (``prep`` a batch in
    the loader's thread, the others a step of the main thread): what the
    host did while the card ran."""
    return {f"{k}_ms": v["s"] / v["n"] * 1e3 for k, v in ctx["spans"].items() if v["n"]}


def _number(v: float):
    """A finite number as it is; inf or nan as a string (JSON has neither)."""
    return v if v == v and abs(v) != float("inf") else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    _, cell, _, _ = load_cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    result, _ = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0))
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: {bad} loaded in the benchmark's process", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
