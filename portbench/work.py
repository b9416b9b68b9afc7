"""Operations and bytes of each kind of work, from its shapes.

One function per kind of work, so that a share of a roofline reads the same
work whatever kernels implement it. Each input byte is counted read once and
each output byte written once; where the work depends on the data, the
caller passes what these inputs need.
"""

from __future__ import annotations

from typing import NamedTuple

from portbench import peaks

F32 = 4
DENSE_OPTIMIZERS = ("adam", "fused_adam", "fused_adam_bf16m")


class Work(NamedTuple):
    flops: float
    nbytes: float
    computed_in: str

    def least_seconds(self) -> float:
        return peaks.least_seconds(self.flops, self.nbytes, self.computed_in)


def train_step(optimizer: str, n_users: int, n_anime: int, d: int, batch: int,
               touched_rows: int | None = None) -> Work:
    """One training step of the two-tower model.

    Dense Adam (``adam`` and the fused optimizers, which keep its
    semantics) decays the moments of every row of both tables and adds the
    full-table L2 gradient, so it reads and writes the parameter and both
    moments of every row: 8 bytes of parameter and 4 of each f32 moment (2
    of a bf16 one) per element, each read and written once. ``lazy_adam``
    updates only the rows the batch touches (``touched_rows``, unique users
    plus unique anime). Beside the tables: the batch's two ids and its
    rating, the gathered rows of both tables and their scattered gradients.

    Operations: per example the two rows' L2 normalization and cosine
    (about 8 d) and the head (about 20), forward and twice that backward,
    and about 12 per parameter element for Adam; all in float32 outside
    the tensor cores."""
    if optimizer in DENSE_OPTIMIZERS:
        rows = n_users + n_anime
    elif optimizer == "lazy_adam":
        if touched_rows is None:
            raise ValueError("lazy_adam's work depends on the rows the batch touches")
        rows = touched_rows
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    moment = 2 if optimizer == "fused_adam_bf16m" else F32
    table_bytes = rows * d * (2 * F32 + 4 * moment)
    batch_bytes = batch * 3 * F32 + 2 * (2 * batch * d * F32)
    flops = 3 * batch * (8 * d + 20) + 12 * rows * d
    return Work(flops, table_bytes + batch_bytes, "float32")


def scan(n_rows: int, d: int, queries: int, k: int, itemsize: int = F32,
         mask: bool = False, head: bool = False) -> Work:
    """One top-k scan of ``queries`` query rows against an [n_rows, d]
    table of ``itemsize``-byte elements: the table read once, the queries
    read, a row mask read if given, and k (f32 score, int64 row) pairs per
    query written. Operations: 2 d per query and row for the dot products,
    plus 4 per score for a folded sigmoid head. From two queries on, the
    products run on the tensor cores in TF32 (the exact rescore of a small
    candidate pool is left out of the count); one query runs in float32."""
    nbytes = n_rows * d * itemsize + queries * d * F32 + queries * k * (F32 + 8)
    if mask:
        nbytes += n_rows
    flops = 2.0 * queries * n_rows * d + (4.0 * queries * n_rows if head else 0.0)
    return Work(flops, nbytes, "tf32" if queries >= 2 else "float32")
