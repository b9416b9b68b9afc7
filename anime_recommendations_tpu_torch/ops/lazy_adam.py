"""Row-sparse (lazy) Adam update of embedding tables, in place: on a card,
one id sort and one kernel launch for every table of a step.

No counterpart kernel in the JAX package, which leaves this update to XLA
(anime_recommendations_tpu/train/lazy.py). train/lazy.py's module docstring
gives the semantics: each run of equal ids in a table's batch sums its
gradient rows and applies one Adam update with the L2 decay to its row,
with lr, bc1 = 1 - b1^step and bc2 = 1 - b2^step read from the step's row
``scal`` (ops/fused_adam.scalar_rows: [4] f32 on the tables' device, read as
0-dim device tensors, never on the host), so a CUDA graph can capture the
update. ``keep`` ([B] bool): positions marked False add nothing to their
run's sum, and a run none of whose positions is kept leaves its row as it
was (JAX's ``mode="drop"``).

On CUDA tensors ``lazy_adam_`` sorts the tables' ids once (table t's ids
offset by the rows of the tables before it, as int32: one stable sort for
all of them) and launches csrc/lazy_adam.cu once for the whole list (at most
MAX_TABLES tables of one width), counted as ``lazy_adam`` in
ops/_kernels.launches; on other tensors (the CPU's, or the meta device's, on
which the tests show that a step reads nothing on the host) it runs
``_lazy_row_adam_plain`` on each table, the torch chain, which the kernel
follows bit for bit on rows the batch touches once (a repeated id's row sums
in another order: the chain's ``index_add_`` in atomics' order, the kernel
in a fixed one). There is no fallback between them.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence
from typing import NamedTuple

import torch

from anime_recommendations_tpu_torch.ops import _kernels
from anime_recommendations_tpu_torch.ops.dense_adam import B1, B2, KERAS_ADAM_EPS

MAX_TABLES = 8  # kMaxTables in csrc/lazy_adam.cu
CHUNK = 8       # kChunk in csrc/lazy_adam.cu: sorted positions a warp takes
_INT32_MAX = 2**31 - 1


class LazyTable(NamedTuple):
    """One table's part of a lazy Adam step."""
    w: torch.Tensor              # [N, D] f32, updated in place
    mu: torch.Tensor             # [N, D] f32, updated in place
    nu: torch.Tensor             # [N, D] f32, updated in place
    ids: torch.Tensor            # [B] int32 or int64: the row each position touches
    g_rows: torch.Tensor         # [B, D] f32: the gradient w.r.t. the gathered rows
    keep: torch.Tensor | None = None   # [B] bool, or None: every position counts


@torch.no_grad()
def lazy_adam_(tables: Sequence[LazyTable], scal: torch.Tensor, l2: float, b1: float = B1,
               b2: float = B2, eps: float = KERAS_ADAM_EPS) -> None:
    """One lazy Adam step of each table in ``tables``, in place: w, mu and
    nu keep their storage and change only on the rows the ids touch. Every
    tensor on scal's device and contiguous; ``scal`` the step's [4] f32 row
    made with these b1 and b2. Ids must lie in [0, N) (on the card the
    kernel skips a position outside, and no other check is made)."""
    n = len(tables)
    if not 1 <= n <= MAX_TABLES:
        raise ValueError(f"lazy_adam_: 1 to {MAX_TABLES} tables, got {n}")
    if scal.shape != (4,) or scal.dtype != torch.float32:
        raise ValueError(f"lazy_adam_: scal must be a [4] f32 row, got {scal.dtype} "
                         f"{tuple(scal.shape)}")
    for i, t in enumerate(tables):
        _check_table(i, t, scal.device)
    if len({t.w.shape[1] for t in tables}) != 1:
        raise ValueError(f"lazy_adam_: the tables must share one width, got "
                         f"{[t.w.shape[1] for t in tables]}")
    if scal.device.type == "cuda":
        _lazy_adam_cuda(tables, scal, l2, b1, b2, eps)
    else:
        for t in tables:
            _lazy_row_adam_plain(*t[:5], scal, l2, b1, b2, eps, keep=t.keep)


def _check_table(i: int, t: LazyTable, device: torch.device) -> None:
    """Raise on what neither path takes: dtypes, shapes, devices, layout."""
    named = [("w", t.w), ("mu", t.mu), ("nu", t.nu), ("ids", t.ids), ("g_rows", t.g_rows)]
    if t.keep is not None:
        named.append(("keep", t.keep))
    for name, x in named:
        if x.device != device:
            raise ValueError(f"lazy_adam_: {name} of table {i} is on {x.device}, scal on "
                             f"{device}")
        if not x.is_contiguous():
            raise ValueError(f"lazy_adam_: {name} of table {i} must be contiguous")
    for name, x in named[:3] + [named[4]]:
        if x.dtype != torch.float32:
            raise TypeError(f"lazy_adam_: {name} of table {i} must be f32, got {x.dtype}")
    if t.ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lazy_adam_: ids of table {i} must be int32 or int64, got "
                        f"{t.ids.dtype}")
    if t.keep is not None and t.keep.dtype != torch.bool:
        raise TypeError(f"lazy_adam_: keep of table {i} must be bool, got {t.keep.dtype}")
    if t.w.dim() != 2 or t.mu.shape != t.w.shape or t.nu.shape != t.w.shape:
        raise ValueError(f"lazy_adam_: w, mu and nu of table {i} must be one [N, D] shape, "
                         f"got {tuple(t.w.shape)}, {tuple(t.mu.shape)}, {tuple(t.nu.shape)}")
    b = t.ids.shape[0] if t.ids.dim() == 1 else -1
    if b < 0 or t.g_rows.shape != (b, t.w.shape[1]) or (
            t.keep is not None and t.keep.shape != (b,)):
        raise ValueError(f"lazy_adam_: table {i} needs ids [B], g_rows [B, {t.w.shape[1]}] and "
                         f"keep [B], got {tuple(t.ids.shape)}, {tuple(t.g_rows.shape)}, "
                         f"{None if t.keep is None else tuple(t.keep.shape)}")


def _lazy_row_adam_plain(
    w: torch.Tensor,        # [N, D], updated in place
    mu: torch.Tensor,       # [N, D], updated in place
    nu: torch.Tensor,       # [N, D], updated in place
    ids: torch.Tensor,      # [B] int touched row per example
    g_rows: torch.Tensor,   # [B, D] gradient w.r.t. the gathered rows
    scal: torch.Tensor,     # [4] step row on w's device (trainer.step_row)
    l2: float,
    b1: float = B1,
    b2: float = B2,
    eps: float = KERAS_ADAM_EPS,
    keep: torch.Tensor | None = None,
) -> None:
    """One table's update in plain torch ops, in place: the reference for
    the kernel (same operations, same order). Every shape is fixed by B
    (train/lazy.py's module docstring): each sorted position computes its
    run's update from the run's sum and the row's old values, so the
    positions of one run compute the same bits and ``index_copy_`` writes
    them all."""
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order].long()
    g_s = g_rows[order]
    if keep is not None:
        keep_s = keep[order]
        g_s = torch.where(keep_s[:, None], g_s, 0.0)
    is_start = torch.ones_like(ids_s, dtype=torch.bool)
    is_start[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(is_start, 0) - 1                  # [B] run of each position
    g_run = torch.zeros_like(g_s).index_add_(0, seg, g_s)  # row r: run r's sum
    w_rows, mu_rows, nu_rows = w[ids_s], mu[ids_s], nu[ids_s]
    g_tot = g_run[seg] + (2.0 * l2) * w_rows             # decay once per run
    lr, bc1, bc2 = scal[0], scal[1], scal[2]
    mu_new = b1 * mu_rows + (1.0 - b1) * g_tot
    nu_new = b2 * nu_rows + (1.0 - b2) * (g_tot * g_tot)
    upd = -lr * (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
    w_new = w_rows + upd
    if keep is not None:
        live = torch.zeros_like(ids_s).index_add_(0, seg, keep_s.long())[seg] > 0
        w_new = torch.where(live[:, None], w_new, w_rows)
        mu_new = torch.where(live[:, None], mu_new, mu_rows)
        nu_new = torch.where(live[:, None], nu_new, nu_rows)
    # The positions of one run write the same bits.
    w.index_copy_(0, ids_s, w_new)
    mu.index_copy_(0, ids_s, mu_new)
    nu.index_copy_(0, ids_s, nu_new)


def _lazy_adam_cuda(tables: Sequence[LazyTable], scal: torch.Tensor, l2: float, b1: float,
                    b2: float, eps: float) -> None:
    """Sort every table's ids in one stable int32 sort (table t's offset by
    the rows before it, so each table's runs follow the previous table's),
    then launch csrc/lazy_adam.cu once on PyTorch's current stream."""
    if scal.data_ptr() % 4:
        raise ValueError("lazy_adam_: scal must be 4-byte aligned")
    rows = [t.w.shape[0] for t in tables]
    batch = [t.ids.shape[0] for t in tables]
    if sum(rows) > _INT32_MAX or sum(batch) > _INT32_MAX:
        raise ValueError(f"lazy_adam_: at most 2^31 - 1 rows and positions in all, got "
                         f"{sum(rows)} and {sum(batch)}")
    n_chunks = sum(-(-b // CHUNK) for b in batch)
    if n_chunks == 0:
        return
    dev, n, d = scal.device, len(tables), tables[0].w.shape[1]
    keys, offset = [], 0
    for t, r in zip(tables, rows):
        ids = t.ids.to(torch.int32)
        keys.append(ids + offset if offset else ids)
        offset += r
    keys_s, order = torch.sort(keys[0] if n == 1 else torch.cat(keys), stable=True)
    keep = None
    if any(t.keep is not None for t in tables):
        keep = torch.cat([t.keep if t.keep is not None
                          else torch.ones(b, dtype=torch.bool, device=dev)
                          for t, b in zip(tables, batch)])
    partial = torch.empty(2 * n_chunks, d, dtype=torch.float32, device=dev)
    flags = torch.zeros(3 * n_chunks, dtype=torch.int32, device=dev)
    ptrs = lambda ts: (ctypes.c_void_p * n)(*(x.data_ptr() for x in ts))
    ints = lambda xs: (ctypes.c_int * n)(*xs)
    _kernels.check(_kernels.library("lazy_adam").lazy_adam(
        ptrs(t.w for t in tables), ptrs(t.mu for t in tables), ptrs(t.nu for t in tables),
        ptrs(t.g_rows for t in tables), ints(rows), ints(batch), n, d,
        keys_s.data_ptr(), order.data_ptr(), None if keep is None else keep.data_ptr(),
        partial.data_ptr(), flags.data_ptr(), n_chunks, scal.data_ptr(),
        b1, 1.0 - b1, b2, 1.0 - b2, eps, 2.0 * l2,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)), "lazy_adam")
    _kernels.count_launch("lazy_adam")
