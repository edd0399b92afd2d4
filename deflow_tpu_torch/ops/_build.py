"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into its own shared library under ``deflow_tpu_torch/build/``
(listed in ``.gitignore``), at first use and only from the sources in the
checkout.  All sources compile in parallel, one ``nvcc`` each.  Libraries are
loaded with ``ctypes``; a library is rebuilt when its source is newer.

Nothing here runs at import time: the CPU tests import every module and have
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict

import torch

KERNELS = ("segment_sum", "sorted_gather", "fused_gru", "fused_gru_bwd", "cbg",
           "segment_sum_lanes", "cell_sweep", "chamfer_brute", "stem")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Missing, or older than its source or any shared header."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    srcs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in srcs)


def build_all(force: bool = False) -> Dict[str, dict]:
    """Compile every kernel library that is missing or stale, all in parallel.

    Returns ``{name: {"seconds": wall time, "log": nvcc/ptxas output}}`` for
    the libraries built by this call.  Raises if any build fails."""
    with _LOCK:
        todo = [k for k in KERNELS if force or _stale(k)]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        out, failed = {}, []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            out[name] = {"seconds": time.perf_counter() - t0, "log": log}
            if proc.returncode != 0:
                failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _lib_path(name))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return out


def load(name: str, setup: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building all kernels first if
    any is missing or stale.  ``setup`` declares the entry points' argtypes
    once, when the library is first loaded."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.error_string.restype = ctypes.c_char_p
            lib.error_string.argtypes = [ctypes.c_int]
            setup(lib)
            _LIBS[name] = lib
        return _LIBS[name]


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        msg = lib.error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg}) at launch")
