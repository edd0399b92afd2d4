"""Sorted row gather: the decoder's unpillar step.

``sorted_rows_gather`` launches ``csrc/sorted_gather.cu`` on CUDA tensors
and takes the plain PyTorch version, ``gather_plain``, only for CPU tensors.
Counterpart of ``deflow_tpu/ops/pallas_gather.py``
(``sorted_rows_gather_pallas``).

Contract: ``table[ids]`` with ids ≥ ``num_rows`` (the ``2**30`` sentinel,
padding) reading exact zeros; a bit-exact copy in any dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deflow_tpu_torch.ops import _build


def gather_plain(table: torch.Tensor, ids: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """Masked ``index_select``."""
    ok = (ids >= 0) & (ids < num_rows)
    rows = table.index_select(0, torch.where(ok, ids, 0).long())
    return torch.where(ok[:, None], rows, 0)


def _setup(lib):
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.sorted_gather.restype = ctypes.c_int
    lib.sorted_gather.argtypes = [vp, vp, i64, i64, i64, vp, ctypes.c_int, vp]


def gather_max_rows(cols: int, element_size: int, aligned: bool = True) -> int:
    """The most table rows (and ids) ``sorted_rows_gather`` takes for rows of
    ``cols`` elements of ``element_size`` bytes: int32 ids name 2^31 - 1
    rows; rows that are not whole 16-byte vectors (or a table that is not
    16-byte aligned) take the route that indexes elements in 32 bits."""
    if aligned and (cols * element_size) % 16 == 0:
        return 2 ** 31 - 1
    return (2 ** 31 - 1) // max(cols, 1)


def sorted_rows_gather(table: torch.Tensor, ids: torch.Tensor,
                       num_rows: Optional[int] = None) -> torch.Tensor:
    """``table [R, C]`` rows at ``ids [M]`` → ``[M, C]``; ids ≥ ``num_rows``
    (default R) read zeros."""
    num_rows = table.shape[0] if num_rows is None else num_rows
    if table.dim() != 2 or ids.dim() != 1 or num_rows > table.shape[0]:
        raise ValueError(f"table {tuple(table.shape)} / ids {tuple(ids.shape)}"
                         f" / num_rows {num_rows}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table dtype {table.dtype}: f32 or bf16 only")
    if ids.dtype != torch.int32 or ids.device != table.device:
        raise ValueError("ids must be int32 on the table's device")
    if table.device.type == "cpu":
        return gather_plain(table, ids, num_rows)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("table and ids must be contiguous")
    cols = table.shape[1]
    if max(ids.shape[0], table.shape[0]) > gather_max_rows(cols, table.element_size(),
                                                           table.data_ptr() % 16 == 0):
        raise ValueError(f"table {tuple(table.shape)} / ids {tuple(ids.shape)}: "
                         "beyond the kernel's row limit")
    lib = _build.load("sorted_gather", _setup)
    out = torch.empty(ids.shape[0], cols, dtype=table.dtype, device=table.device)
    rc = lib.sorted_gather(table.data_ptr(), ids.data_ptr(), ids.shape[0], cols,
                           num_rows, out.data_ptr(), table.element_size(),
                           _build.stream_ptr(table))
    _build.check(lib, rc, "sorted_gather")
    sorted_rows_gather.launches += 1
    return out


sorted_rows_gather.launches = 0
