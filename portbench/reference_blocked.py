"""The plain reference of a scan over a table too large to score whole, in
plain PyTorch, block of rows by block of rows.

[Q, 54.5M] f32 scores are 55.8 GB, so the reference never forms them: it
draws each block of the table's rows from the run's inputs (a
datagen_stream.SeededTable, or any [N, D] object read by row ranges),
normalizes them (reference.normalize), scores every query against them in
f32 with TF32 off (reference.scores), and keeps per query what
compare.answer_gap reads: the running ``want`` best scores among the rows
the answer may hold, and the score of each row the answer served. It
imports nothing of the port. ``answer_gap`` then gives compare.answer_gap's
number from these alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import reference

BLOCK_ROWS = 1 << 19


class Live:
    """The rows a query's answer may hold: ``shared`` ([N] bool on the
    device, None: every row) less the query's own ``excluded`` rows, one
    int64 array of rows per query (its own row, or its watched set)."""

    def __init__(self, n: int, shared: torch.Tensor | None, excluded: list):
        self.n, self.shared, self.excluded = n, shared, excluded
        self.n_shared = n if shared is None else int(shared.sum())

    def count(self, q: int) -> int:
        rows = np.unique(self.excluded[q])
        if self.shared is not None and len(rows):
            rows = rows[self.shared[torch.as_tensor(rows, device=self.shared.device)].cpu().numpy()]
        return self.n_shared - len(rows)

    def holds(self, q: int, rows: np.ndarray) -> bool:
        if (rows < 0).any() or (rows >= self.n).any() or np.isin(rows, self.excluded[q]).any():
            return False
        if self.shared is None:
            return True
        return bool(self.shared[torch.as_tensor(rows, device=self.shared.device)].all())


@torch.no_grad()
def scan(table, queries: torch.Tensor, served: np.ndarray, live: Live, want: int,
         head=None, block_rows: int | None = None):
    """(best [Q, want] f64, got [Q, k] f64): each query's ``want`` best
    reference scores among its live rows (-inf past them), and the
    reference score of each of its ``served`` rows ([Q, k] int64 logical
    rows, -1 for none: nan), over ``table``'s rows in blocks of
    ``block_rows`` (default BLOCK_ROWS)."""
    n = table.shape[0]
    block_rows = block_rows or BLOCK_ROWS
    qn, dev = queries.shape[0], queries.device
    best = torch.full((qn, want), -math.inf, dtype=torch.float64, device=dev)
    got = torch.full(served.shape, math.nan, dtype=torch.float64, device=dev)
    served_t = torch.as_tensor(served, dtype=torch.long, device=dev)
    excluded = [torch.as_tensor(np.asarray(e, np.int64), device=dev) for e in live.excluded]
    owner = torch.cat([torch.full((len(e),), q, dtype=torch.long, device=dev)
                       for q, e in enumerate(excluded)]) if excluded else None
    excluded_rows = torch.cat(excluded) if excluded else None
    for lo in range(0, n, block_rows):
        hi = min(lo + block_rows, n)
        rows = reference.normalize(table[lo:hi].to(device=dev, dtype=torch.float32))
        s = reference.scores(rows, queries, head)                          # [Q, B]
        inside = (served_t >= lo) & (served_t < hi)
        if inside.any():
            cols = (served_t - lo).clamp(0, hi - lo - 1)
            got = torch.where(inside, s.gather(1, cols).double(), got)
        if live.shared is not None:
            s.masked_fill_(~live.shared[lo:hi][None, :], -math.inf)
        if owner is not None:
            hit = (excluded_rows >= lo) & (excluded_rows < hi)
            s[owner[hit], excluded_rows[hit] - lo] = -math.inf
        top = torch.topk(s, min(want, hi - lo), dim=1).values.double()
        best = torch.topk(torch.cat([best, top], 1), want, dim=1).values
        del rows, s
    return best, got


def answer_gap(rows: np.ndarray, served: np.ndarray, got: torch.Tensor, best: torch.Tensor,
               live: Live, q: int, k: int) -> float:
    """compare.answer_gap of query ``q``'s answer from scan's readings: the
    larger of the widest gap between a served score and the reference's
    score of the served row, and the widest by which the r-th served row's
    reference score lies below the reference's r-th best. An answer with a
    row it may not hold, a row twice, or fewer than min(k, live rows) rows
    is wrong: infinite."""
    want = min(k, live.count(q))
    if len(rows) != want or len(served) != want or len(set(rows.tolist())) != want:
        return math.inf
    if want == 0:
        return 0.0
    if not live.holds(q, rows):
        return math.inf
    g = got[q, :want]
    served_t = torch.as_tensor(served, dtype=torch.float64, device=g.device)
    return float(torch.maximum((served_t - g).abs().max(), (best[q, :want] - g).max()))
