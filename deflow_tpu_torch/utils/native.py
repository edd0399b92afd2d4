"""ctypes loader and wrappers for the port's C++ host ops.

Counterpart of ``deflow_tpu/utils/native.py``.  ``csrc/pointops.cpp`` is
compiled with ``g++`` at first use into ``deflow_tpu_torch/build/
libpointops.so`` (listed in ``.gitignore``), from the checkout's source
only, and rebuilt when the source is newer than the library.  ``CXX``
names another compiler.

There is no numpy fallback: a library that cannot be built or loaded
raises.  The numpy versions of these ops (``data/host_prep.py``) run only
where a caller asks for them by name (``backend="numpy"``).  The wrappers
check sizes, bounds and dtypes before they pass pointers, and release the
GIL for the call (ctypes), so a thread pool runs samples in parallel.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pointops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# -ffp-contract=off: a fused multiply-add would round sorted_record's pillar
# centre once where numpy rounds twice (one ulp in lanes 6-7).  No OpenMP:
# the samples of a batch run in parallel on threads (shared_pool), and the
# card's host compiler has no libgomp.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17",
             "-ffp-contract=off", "-shared")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> Path:
    """Compile the library if it is missing or older than its source.

    Safe when several processes build at once: they take a file lock in
    the build directory, compile to a temporary name and rename it into
    place.  Raises ``RuntimeError`` when the compiler is missing or fails."""
    lib = BUILD_DIR / "libpointops.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libpointops.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (not force and lib.exists()
                and lib.stat().st_mtime >= SOURCE.stat().st_mtime):
            return lib
        cxx = os.environ.get("CXX") or "g++"
        tmp = BUILD_DIR / f"libpointops.so.tmp{os.getpid()}"
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(
                f"cannot run the C++ compiler {cxx!r} to build the host ops "
                f"({e}); install g++ or point CXX at a compiler") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _LIB = lib
    return _LIB


def _declare(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64, i32, vp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    for name, res, args in (
            ("select_pad", i64, [f32p, u8p, i64, i64, f32p, i32p, u8p,
                                 f32p, u8p, f32p, i32p, u8p]),
            ("se3_transform", None, [f32p, f64p, i64, f32p]),
            ("collate_points", None, [ctypes.POINTER(f32p), ctypes.POINTER(u8p),
                                      i64, i64, f32p, u8p]),
            ("bin_points", None, [f32p, i64, f32p, f32p, i32p, i32p, u8p]),
            ("sort_by_id", None, [i32p, i64, i64, i32p, i32p, i32p]),
            ("pillar_prep", None, [f32p, u8p, i64, f32p, f32p, i32p, i32,
                                   i32p, i32p, i32p, i32p]),
            ("gather_rows", None, [vp, i32p, i64, i64, vp]),
            ("sorted_record", None, [f32p, i64, f32p, f32p, i32p, i32,
                                     i32p, i32p, f32p]),
            ("chamfer_cell_prep", None, [f32p, u8p, u8p, i64, ctypes.c_float,
                                         f32p, i32, i32, f32p, i32p, i32p]),
            ("host_prep_sample", None, [ctypes.POINTER(_PrepBatch), i64])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


class _PrepBatch(ctypes.Structure):
    """``csrc/pointops.cpp`` ``PrepBatch``: one batch's arrays and grid."""
    _fields_ = [
        ("n", ctypes.c_int64), ("pc", ctypes.c_void_p * 2),
        ("pc_cols", ctypes.c_int64 * 2), ("mask", ctypes.c_void_p * 2),
        ("ego", ctypes.c_void_p), ("vmin", ctypes.c_float * 3),
        ("vsize", ctypes.c_float * 3), ("grid", ctypes.c_int32 * 3),
        ("s2d", ctypes.c_int32), ("transformed", ctypes.c_void_p),
        ("ids", ctypes.c_void_p * 2), ("sorted", ctypes.c_void_p * 2),
        ("unsort", ctypes.c_void_p * 2), ("rec", ctypes.c_void_p * 2),
        ("n_keys", ctypes.c_int32 * 2), ("key_src", ctypes.c_void_p * 2),
        ("key_dst", ctypes.c_void_p * 2), ("key_row_bytes", ctypes.c_void_p * 2),
        ("cell_flag", ctypes.c_void_p), ("cell", ctypes.c_float),
        ("cell_lo", ctypes.c_float * 2), ("cell_gx", ctypes.c_int32),
        ("cell_gy", ctypes.c_int32), ("cell_lanes", ctypes.c_void_p),
        ("cell_sid", ctypes.c_void_p), ("cell_start", ctypes.c_void_p)]


def _ptr(a: Optional[np.ndarray], ctype):
    if a is None:
        return ctypes.cast(None, ctypes.POINTER(ctype))
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _f32(a, cols: Optional[int] = None) -> np.ndarray:
    a = np.asarray(a)
    if cols is not None:
        if a.ndim != 2 or a.shape[1] < cols:
            raise ValueError(f"expected [n, >={cols}] points, got {a.shape}")
        a = a[:, :cols]
    return np.ascontiguousarray(a, np.float32)


def _rows(a, n: int, dtype, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype)
    if len(a) != n:
        raise ValueError(f"{what} has {len(a)} rows, expected {n}")
    return a


def _grid(grid) -> np.ndarray:
    return np.ascontiguousarray(grid, np.int32).reshape(3)


def _vec3(v) -> np.ndarray:
    return np.ascontiguousarray(v, np.float32).reshape(3)


def _check_index(idx: np.ndarray, bound: int, what: str) -> None:
    if len(idx) and (idx.min() < 0 or idx.max() >= bound):
        raise ValueError(f"{what} out of range [0, {bound})")


def use_s2d(grid) -> bool:
    """s2d pillar-id order on even grids."""
    return int(grid[0]) % 2 == 0 and int(grid[1]) % 2 == 0


def select_pad(pts: np.ndarray, ground: Optional[np.ndarray], max_points: int,
               flow: Optional[np.ndarray] = None,
               labels: Optional[np.ndarray] = None,
               valid: Optional[np.ndarray] = None):
    """Drop ground points (where ``ground`` is given), then keep the first
    ``max_points`` in order, zero-padded.  Returns (pts [max, 3], mask
    [max], flow?, labels?, valid?, n_kept), n_kept counted before the crop;
    the optional per-point payloads take the same selection."""
    pts = _f32(pts, 3)
    n = len(pts)
    ground = None if ground is None else _rows(ground, n, np.uint8, "ground")
    flow = None if flow is None else _rows(flow, n, np.float32, "flow")
    labels = None if labels is None else _rows(labels, n, np.int32, "labels")
    valid = None if valid is None else _rows(valid, n, np.uint8, "valid")
    if flow is not None and flow.shape[1:] != (3,):
        raise ValueError(f"flow must be [n, 3], got {flow.shape}")
    out_p = np.empty((max_points, 3), np.float32)
    out_m = np.empty(max_points, np.uint8)
    out_f = None if flow is None else np.empty((max_points, 3), np.float32)
    out_l = None if labels is None else np.empty(max_points, np.int32)
    out_v = None if valid is None else np.empty(max_points, np.uint8)
    kept = get_lib().select_pad(
        _ptr(pts, ctypes.c_float), _ptr(ground, ctypes.c_uint8), n, max_points,
        _ptr(flow, ctypes.c_float), _ptr(labels, ctypes.c_int32),
        _ptr(valid, ctypes.c_uint8),
        _ptr(out_p, ctypes.c_float), _ptr(out_m, ctypes.c_uint8),
        _ptr(out_f, ctypes.c_float), _ptr(out_l, ctypes.c_int32),
        _ptr(out_v, ctypes.c_uint8))
    return (out_p, out_m.view(bool), out_f, out_l,
            None if out_v is None else out_v.view(bool), int(kept))


def se3_transform(pts: np.ndarray, pose: np.ndarray) -> np.ndarray:
    """``p @ R^T + t`` evaluated in f64 and rounded once to f32."""
    pts = _f32(pts, 3)
    pose = np.ascontiguousarray(pose, np.float64).reshape(4, 4)
    out = np.empty_like(pts)
    get_lib().se3_transform(_ptr(pts, ctypes.c_float), _ptr(pose, ctypes.c_double),
                            len(pts), _ptr(out, ctypes.c_float))
    return out


def collate_points(sample_pts: Sequence[np.ndarray],
                   sample_masks: Sequence[np.ndarray]):
    """Stack B padded clouds [N, 3] and their masks [N] into one batch."""
    b = len(sample_pts)
    if b == 0 or len(sample_masks) != b:
        raise ValueError("need as many masks as clouds, and at least one")
    pts = [_f32(p, 3) for p in sample_pts]
    n = len(pts[0])
    masks = [_rows(m, n, np.uint8, "mask") for m in sample_masks]
    if any(len(p) != n for p in pts):
        raise ValueError("clouds of unequal length")
    out_p = np.empty((b, n, 3), np.float32)
    out_m = np.empty((b, n), np.uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    get_lib().collate_points(
        (f32p * b)(*[_ptr(p, ctypes.c_float) for p in pts]),
        (u8p * b)(*[_ptr(m, ctypes.c_uint8) for m in masks]),
        b, n, _ptr(out_p, ctypes.c_float), _ptr(out_m, ctypes.c_uint8))
    return out_p, out_m.view(bool)


def bin_points(pts: np.ndarray, vmin, vsize, grid):
    """Pillar coordinates ``floor((p - vmin) / vsize)`` in f32 ([n, 3]
    int32) and whether each lies inside the grid."""
    pts = _f32(pts, 3)
    coords = np.empty((len(pts), 3), np.int32)
    ok = np.empty(len(pts), np.uint8)
    get_lib().bin_points(
        _ptr(pts, ctypes.c_float), len(pts), _ptr(_vec3(vmin), ctypes.c_float),
        _ptr(_vec3(vsize), ctypes.c_float), _ptr(_grid(grid), ctypes.c_int32),
        _ptr(coords, ctypes.c_int32), _ptr(ok, ctypes.c_uint8))
    return coords, ok.view(bool)


def sort_by_id(ids: np.ndarray, num_buckets: int):
    """Stable counting sort of ids in [0, num_buckets]: (order, iperm,
    sorted_ids), each [n] int32."""
    ids = np.ascontiguousarray(ids, np.int32)
    _check_index(ids, num_buckets + 1, "ids")
    n = len(ids)
    order, iperm, sid = (np.empty(n, np.int32) for _ in range(3))
    get_lib().sort_by_id(_ptr(ids, ctypes.c_int32), n, num_buckets,
                         _ptr(order, ctypes.c_int32), _ptr(iperm, ctypes.c_int32),
                         _ptr(sid, ctypes.c_int32))
    return order, iperm, sid


def pillar_prep(pts: np.ndarray, mask: np.ndarray, vmin, vsize, grid):
    """Bin + stable sort of one padded cloud.

    Returns (pillar_id, order, iperm, sorted_id), each [N] int32; invalid
    and padding points carry the trash id ``W·H``."""
    pts = _f32(pts, 3)
    n = len(pts)
    mask = _rows(mask, n, np.uint8, "mask")
    grid = _grid(grid)
    pid, order, iperm, sid = (np.empty(n, np.int32) for _ in range(4))
    get_lib().pillar_prep(
        _ptr(pts, ctypes.c_float), _ptr(mask, ctypes.c_uint8), n,
        _ptr(_vec3(vmin), ctypes.c_float), _ptr(_vec3(vsize), ctypes.c_float),
        _ptr(grid, ctypes.c_int32), int(use_s2d(grid)),
        _ptr(pid, ctypes.c_int32), _ptr(order, ctypes.c_int32),
        _ptr(iperm, ctypes.c_int32), _ptr(sid, ctypes.c_int32))
    return pid, order, iperm, sid


def permute_rows(a: np.ndarray, order: np.ndarray) -> np.ndarray:
    """``a[order]`` along the first axis (C++ ``gather_rows``)."""
    a = np.ascontiguousarray(a)
    order = np.ascontiguousarray(order, np.int32)
    _check_index(order, len(a), "order")
    out = np.empty((len(order),) + a.shape[1:], a.dtype)
    row_bytes = a.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
    get_lib().gather_rows(a.ctypes.data_as(ctypes.c_void_p),
                          _ptr(order, ctypes.c_int32), len(order), row_bytes,
                          out.ctypes.data_as(ctypes.c_void_p))
    return out


def sorted_record(pts: np.ndarray, order: np.ndarray, sorted_id: np.ndarray,
                  vmin, vsize, grid) -> np.ndarray:
    """Sorted 9-lane record ``[xyz | p−centroid | p−center]`` (invalid rows
    0) from ``pillar_prep``'s order and ascending ids."""
    pts = _f32(pts, 3)
    n = len(pts)
    order = _rows(order, n, np.int32, "order")
    sorted_id = _rows(sorted_id, n, np.int32, "sorted_id")
    _check_index(order, n, "order")
    grid = _grid(grid)
    rec = np.empty((n, 9), np.float32)
    get_lib().sorted_record(
        _ptr(pts, ctypes.c_float), n, _ptr(_vec3(vmin), ctypes.c_float),
        _ptr(_vec3(vsize), ctypes.c_float), _ptr(grid, ctypes.c_int32),
        int(use_s2d(grid)), _ptr(order, ctypes.c_int32),
        _ptr(sorted_id, ctypes.c_int32), _ptr(rec, ctypes.c_float))
    return rec


def chamfer_cell_prep(pts: np.ndarray, mask: np.ndarray, flag: np.ndarray,
                      cell: float = 2.0,
                      lo: Sequence[float] = (-51.2, -51.2),
                      hi: Sequence[float] = (51.2, 51.2)):
    """One cloud's chamfer cell sort (``data/host_prep.py``
    ``chamfer_cell_prep``): ``lanes`` [5, N], ``sid`` [N], ``start``
    [kgap+1]."""
    gx, gy, kgap = _cell_grid(cell, lo, hi)
    pts = _f32(pts, 3)
    n = len(pts)
    mask = _rows(mask, n, np.uint8, "mask")
    flag = _rows(flag, n, np.uint8, "flag")
    lanes = np.empty((5, n), np.float32)
    sid = np.empty(n, np.int32)
    start = np.empty(kgap + 1, np.int32)
    get_lib().chamfer_cell_prep(
        _ptr(pts, ctypes.c_float), _ptr(mask, ctypes.c_uint8),
        _ptr(flag, ctypes.c_uint8), n, ctypes.c_float(cell),
        _ptr(np.ascontiguousarray(lo, np.float32).reshape(2), ctypes.c_float),
        gx, gy, _ptr(lanes, ctypes.c_float), _ptr(sid, ctypes.c_int32),
        _ptr(start, ctypes.c_int32))
    return {"lanes": lanes, "sid": sid, "start": start}


def _cell_grid(cell: float, lo: Sequence[float], hi: Sequence[float]):
    """(gx, gy, kgap) of the chamfer cell sort."""
    gx = int(np.ceil((hi[0] - lo[0]) / cell - 1e-6))
    gy = int(np.ceil((hi[1] - lo[1]) / cell - 1e-6))
    return gx, gy, (gy + 1) * gx


def _truth(a, shape, what: str) -> np.ndarray:
    """A C-ordered 0/1 uint8 copy of a mask (a view of a bool one)."""
    a = np.asarray(a)
    if a.shape != shape:
        raise ValueError(f"{what} is {a.shape}, expected {shape}")
    return np.ascontiguousarray(a if a.dtype == bool else a != 0).view(np.uint8)


def host_prep(keys, masks, ego, vmin, vsize, grid, cell_flag=None,
              cell: float = 2.0,
              lo: Sequence[float] = (-51.2, -51.2),
              hi: Sequence[float] = (51.2, 51.2)):
    """The fused host prep of one batch (``csrc/pointops.cpp``
    ``host_prep_sample``).

    ``keys``: for pc0 and pc1, a dict of the per-point arrays [B, n, ...]
    that ride the cloud's point order, the cloud itself under ``"pc0"``
    (``"pc1"``) as [B, n, >=3] float32.  ``masks``: the clouds' [B, n]
    masks; ``ego`` [B, 4, 4], pc0 into pc1's frame; ``cell_flag``: pc1's
    [B, n] chamfer flag, for the SSL cell sort of pc1's sorted rows
    (``chamfer_cell_prep``'s geometry), or None.

    Returns ``(out, run)``.  ``out`` holds the batch's new arrays, each
    allocated here once: every key's permuted copy under its name,
    ``pc0_transformed``, ``pc{0,1}_ids``, ``_sorted``, ``_unsort`` and
    ``_sorted_rec`` and, with ``cell_flag``, ``pc1_cell_lanes``, ``_sid``
    and ``_start``.  ``run(i)`` preps sample ``i`` in one GIL-free call that
    writes its rows of each."""
    pcs = [np.asarray(keys[c][f"pc{c}"]) for c in (0, 1)]
    b, n = pcs[0].shape[:2]
    for c, pc in enumerate(pcs):
        if (pc.dtype != np.float32 or pc.ndim != 3 or pc.shape[:2] != (b, n)
                or pc.shape[2] < 3):
            raise ValueError(f"pc{c} must be a [{b}, {n}, >=3] float32 array, "
                             f"got {pc.dtype} {pc.shape}")
    grid = _grid(grid)
    trash = int(grid[0]) * int(grid[1])
    if n >= 2 ** 31 or trash + 2 >= 2 ** 31:
        raise ValueError(f"{n} slots or a {grid[0]}x{grid[1]} grid overflow int32")
    masks = [_truth(m, (b, n), f"pc{c}_mask") for c, m in enumerate(masks)]
    ego = np.ascontiguousarray(ego, np.float64).reshape(b, 4, 4)
    st = _PrepBatch(n=n, s2d=int(use_s2d(grid)), ego=ego.ctypes.data)
    st.vmin[:], st.vsize[:] = _vec3(vmin).tolist(), _vec3(vsize).tolist()
    st.grid[:] = grid.tolist()
    out, refs = {}, [masks, ego]
    for c in (0, 1):
        # the cloud first: the record and the cell sort read its sorted rows
        names = [f"pc{c}"] + [k for k in keys[c] if k != f"pc{c}"]
        src = [np.ascontiguousarray(keys[c][k]) for k in names]
        for k, a in zip(names, src):
            if a.shape[:2] != (b, n):
                raise ValueError(f"{k} is {a.shape}, expected [{b}, {n}, ...]")
            out[k] = np.empty(a.shape, a.dtype)
        arrays = ((ctypes.c_void_p * len(src))(*(a.ctypes.data for a in src)),
                  (ctypes.c_void_p * len(src))(*(out[k].ctypes.data for k in names)),
                  (ctypes.c_int64 * len(src))(*(a.nbytes // (b * n) for a in src)))
        refs += [src, arrays]
        st.pc[c], st.pc_cols[c], st.mask[c] = src[0].ctypes.data, src[0].shape[2], masks[c].ctypes.data
        st.n_keys[c] = len(src)
        st.key_src[c], st.key_dst[c], st.key_row_bytes[c] = map(ctypes.addressof, arrays)
    out["pc0_transformed"] = np.empty((b, n, 3), np.float32)
    st.transformed = out["pc0_transformed"].ctypes.data
    for c in (0, 1):
        for k in ("ids", "sorted", "unsort"):
            out[f"pc{c}_{k}"] = np.empty((b, n), np.int32)
            getattr(st, k)[c] = out[f"pc{c}_{k}"].ctypes.data
        out[f"pc{c}_sorted_rec"] = np.empty((b, n, 9), np.float32)
        st.rec[c] = out[f"pc{c}_sorted_rec"].ctypes.data
    if cell_flag is not None:
        st.cell_gx, st.cell_gy, kgap = _cell_grid(cell, lo, hi)
        flag = _truth(cell_flag, (b, n), "the cell flag")
        refs.append(flag)
        st.cell_flag, st.cell = flag.ctypes.data, cell
        st.cell_lo[:] = np.asarray(lo, np.float32).reshape(2).tolist()
        for k, shape, dtype in (("lanes", (b, 5, n), np.float32), ("sid", (b, n), np.int32),
                                ("start", (b, kgap + 1), np.int32)):
            out[f"pc1_cell_{k}"] = np.empty(shape, dtype)
            setattr(st, f"cell_{k}", out[f"pc1_cell_{k}"].ctypes.data)
    refs.append(out)
    fn, arg = get_lib().host_prep_sample, ctypes.pointer(st)

    def run(i: int) -> None:
        if not 0 <= i < b:
            raise IndexError(f"sample {i} of a batch of {b}")
        fn(arg, i)

    run.arrays = refs       # what the struct points into lives as long as run
    return out, run


_POOL = None
_POOL_SIZE = 0
_POOL_LOCK = threading.Lock()


def shared_pool(num_workers: int):
    """Process-wide ``ThreadPoolExecutor`` for GIL-free host work, grown to
    the largest size asked for (a pool per batch would pay thread spawns on
    the loader's hot path, and a pool per loader leaks idle threads).  A
    replaced pool is not shut down: another thread may still be about to
    submit to it; its threads exit once it is no longer referenced."""
    global _POOL, _POOL_SIZE
    from concurrent.futures import ThreadPoolExecutor

    with _POOL_LOCK:
        if _POOL is None or num_workers > _POOL_SIZE:
            _POOL = ThreadPoolExecutor(max_workers=int(num_workers))
            _POOL_SIZE = int(num_workers)
        return _POOL
