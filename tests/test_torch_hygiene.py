"""The port stands alone and never hides the device or the kernel.

- no module of ``deflow_tpu_torch`` nor ``chip_smoke.py`` imports JAX, flax,
  optax or the JAX package;
- ``h5py``, ``pyarrow``, ``yaml`` and ``wandb`` (absent on the card's
  machine) are imported only inside functions, so every module imports
  without them;
- no module of ``deflow_tpu_torch`` reads a ``DEFLOW_*`` environment
  variable but those on an allow-list, each with its reason: a choice
  between code paths belongs to the code, not to a switch;
- without a visible card, the entry points raise unless asked for the CPU;
- CPU tensors take the plain versions without building any kernel; tensors
  on any other non-CUDA device are refused, not computed.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deflow_tpu")


def _port_files():
    return sorted((ROOT / "deflow_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in files
           for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


OPTIONAL = ("h5py", "pyarrow", "yaml", "wandb")


def _module_level_imports(tree):
    """Imports that run when the module is imported: outside any function."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        todo.extend(ast.iter_child_nodes(node))


def test_optional_modules_are_imported_inside_functions():
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in _port_files()
           for m in _module_level_imports(ast.parse(p.read_text()))
           if m.split(".")[0] in OPTIONAL]
    assert not bad, bad
    # the scan sees what it must reject
    assert list(_module_level_imports(ast.parse(
        "try:\n    import yaml\nexcept ImportError:\n    pass\n"
        "def f():\n    import h5py\n"))) == ["yaml"]


def test_port_imports_without_optional_modules():
    """Every module of the port imports where h5py, pyarrow, yaml and wandb
    are absent, as on the card's machine."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {OPTIONAL!r}:\n"
        "    sys.modules[name] = None\n"
        "import deflow_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'deflow_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 25


# the DEFLOW_* variables the port may read, each with its reason
ENV_ALLOWED = {
    "DEFLOW_SSL_DYNCAP": "the compacted SeFlow backward's budget, as the JAX package "
                         "reads it; read in losses.py and entry/train.py until it "
                         "becomes one config key",
}


def _deflow_names(tree):
    """The ``DEFLOW_*`` strings in a module's code (docstrings left out):
    each names an environment variable that the code reads or writes."""
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.startswith("DEFLOW_") and id(n) not in docs]


def test_port_reads_no_deflow_switch():
    files = sorted((ROOT / "deflow_tpu_torch").rglob("*.py"))
    bad = [(p.relative_to(ROOT).as_posix(), name) for p in files
           for name in _deflow_names(ast.parse(p.read_text()))
           if name not in ENV_ALLOWED]
    assert not bad, bad
    # the scan sees what it must reject, and passes over a docstring
    assert sorted(_deflow_names(ast.parse(
        '"""DEFLOW_DOC"""\nimport os\n'
        'def f():\n    """DEFLOW_DOC"""\n    return os.environ.get("DEFLOW_A", "0")\n'
        'B = os.getenv("DEFLOW_B")\n'))) == ["DEFLOW_A", "DEFLOW_B"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_cuda):
    from deflow_tpu_torch.device import resolve_device
    from deflow_tpu_torch.models import build_model
    from deflow_tpu_torch.trainer import (device_batch, init_train_state,
                                          make_eval_step, make_train_step)

    small = {"voxel_size": [12.8, 12.8, 6.0], "num_iters": 1}
    for call in (lambda: resolve_device(), lambda: build_model(small),
                 lambda: build_model(small, train=True),
                 lambda: device_batch({"pc0": torch.zeros(1, 4, 3)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = build_model(small, device="cpu", seed=0)
    for call in (lambda: make_eval_step(model),
                 lambda: make_train_step(model, "deflowLoss"),
                 lambda: init_train_state(model, {"lr": 2e-4})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    make_eval_step(model, device="cpu")
    make_train_step(model, "deflowLoss", device="cpu")
    init_train_state(model, {"lr": 2e-4}, device="cpu")


def test_eval_entry_raises_without_a_card(no_cuda, tmp_path):
    from deflow_tpu_torch.config import compose
    from deflow_tpu_torch.entry import evaluate, save
    from deflow_tpu_torch.trainer import device_prefetch

    cfg = compose("config", [f"dataset_path={tmp_path}"])    # no split there
    for main in (evaluate.main, save.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_prefetch([{"pc0": torch.zeros(1, 4, 3).numpy()}]))


def _wrapper_calls(device):
    from deflow_tpu_torch.ops.cbg import cbg_block_bwd, cbg_block_fwd
    from deflow_tpu_torch.ops.gather import sorted_rows_gather
    from deflow_tpu_torch.ops.gru import fused_gru, fused_gru_bwd
    from deflow_tpu_torch.ops.nn import chamfer_min
    from deflow_tpu_torch.ops.scatter import segment_sum_lanes, sorted_segment_sum
    from deflow_tpu_torch.ops.stem import stem_dgrad, stem_fwd, stem_wgrad
    from deflow_tpu_torch.ops.sweep import cell_sweep

    from deflow_tpu_torch.ops import voxel

    f = lambda *s: torch.zeros(*s, device=device)
    ids = torch.tensor([0, 1, 1, 2 ** 30], dtype=torch.int32, device=device)
    pid = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32, device=device)   # 3: trash
    plan = voxel.make_batched_scatter_plan(pid, 3 + voxel.TRASH_PAD)
    info = voxel.PillarInfo(pid, pid < 3, None, None, None)
    return {
        "segment_sum_planned": lambda: voxel.segment_sum_planned(f(1, 4, 33), plan),
        "gather_planned": lambda: voxel.pseudoimage_gather_batched(f(1, 3, 128), info,
                                                                   plan),
        "segment_sum": lambda: sorted_segment_sum(f(4, 33), ids, 3),
        "sorted_gather": lambda: sorted_rows_gather(f(3, 128), ids, 3),
        "fused_gru": lambda: fused_gru(f(4, 128), f(4, 64), f(192, 256),
                                       f(256), f(192, 128), f(128), 4),
        "fused_gru_bwd": lambda: fused_gru_bwd(f(4, 128), f(4, 64), f(192, 256),
                                               f(256), f(192, 128), f(128),
                                               f(4, 128), 4)[0],
        "cbg_fwd": lambda: cbg_block_fwd(f(1, 4, 4, 8), f(3, 3, 8, 8), f(8),
                                         f(6, 8))[0],
        "cbg_bwd": lambda: cbg_block_bwd(f(1, 4, 4, 8), f(1, 4, 4, 8),
                                         f(1, 4, 4, 8), f(3, 3, 8, 8), f(6, 8),
                                         f(6, 8))[0],
        "segment_sum_lanes": lambda: segment_sum_lanes(f(4, 4), ids, 3),
        "cell_sweep": lambda: cell_sweep(
            f(256, 8), f(1, 8, 512), ids.new_zeros(1, 3), ids.new_zeros(1, 3),
            ids.new_zeros(1)),
        "stem_fwd": lambda: stem_fwd(f(1, 4, 4, 16), f(64, 16, 8, 8), f(64)),
        "stem_dgrad": lambda: stem_dgrad(f(1, 2, 2, 64), f(64, 16, 8, 8), 4, 4),
        "stem_wgrad": lambda: stem_wgrad(f(1, 4, 4, 16), f(1, 2, 2, 64))[0],
        "chamfer_min": lambda: chamfer_min(f(2, 5, 3), f(2, 7, 3),
                                           torch.ones(2, 7, dtype=torch.bool,
                                                      device=device))[0],
    }


def test_cpu_tensors_never_build_a_kernel(monkeypatch):
    from deflow_tpu_torch.ops import _build

    def refuse(*a, **k):
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    for name, call in _wrapper_calls("cpu").items():
        out = call()
        assert out.device.type == "cpu", name


def test_other_devices_are_refused():
    for name, call in _wrapper_calls("meta").items():
        with pytest.raises(ValueError, match="unsupported device"):
            call()
