"""Two-stage int8 retrieval: a quantized scan, then an exact f32 rescore.

Counterpart of anime_recommendations_tpu/ops/quantized.py. Stored in int8,
a table is a quarter of its f32 bytes. int8 dot products carry ~1/127 of
noise per element, so stage 1 over-selects a pool of m = max(4k, k+8) rows
from the int8 rows (ops/topk.packed_candidates: csrc/packed_topk_int8.cu on
the card, K2q) and stage 2 rescores just those rows against the f32
originals and returns the true top-k of the pool.

Quantization is symmetric per row: scale_r = max|w_r| / 127 and q_r =
round(w_r / scale_r), half to even (torch.round, like jnp.round), so that
cos(q, r) ~ (iq . ir) * scale_q * scale_r. The queries are quantized the
same way with their own scales.

The TPU artefacts are not carried over: no 32-row query pad (the int8
(32, 128) tile), no ``qp_ex`` extraction width, no block-size clamps; and
small tables take the same kernel as large ones (the JAX package sends
n <= 4096 to its dense f32 path when compiled).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from anime_recommendations_tpu_torch.ops.topk import (
    _rescore_pool,
    _stage1_pool,
    packed_candidates,
    top_r_policy,
)


CHUNK_ROWS = 1 << 19    # rows quantize_rows quantizes at a time


class QuantizedTable(NamedTuple):
    """int8 rows, their per-row de-scale factors, and the f32 rows for the rescore."""

    q: torch.Tensor        # [N, D] int8
    scale: torch.Tensor    # [N] f32 (q * scale ~= the original row)
    f32: torch.Tensor      # [N, D] f32 (or bf16) exact rows


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 rows, f32 scales) of symmetric per-row quantization: the
    scale is an f32 division of the clamped absmax by 127, as in JAX."""
    absmax = torch.clamp_min(x.abs().amax(dim=1), 1e-12)
    scale = (absmax / 127.0).float()
    return torch.round(x / scale[:, None]).to(torch.int8), scale


@torch.no_grad()
def quantize_rows(table: torch.Tensor) -> QuantizedTable:
    """Symmetric per-row int8 quantization, keeping the original for the
    rescore. It runs CHUNK_ROWS rows at a time, so that its temporaries are
    a chunk's and not a whole table's; each row is quantized alone, so the
    bits do not depend on the chunk."""
    n, d = table.shape
    q = torch.empty((n, d), dtype=torch.int8, device=table.device)
    scale = torch.empty(n, dtype=torch.float32, device=table.device)
    for lo in range(0, n, CHUNK_ROWS):
        q[lo:lo + CHUNK_ROWS], scale[lo:lo + CHUNK_ROWS] = _quantize(table[lo:lo + CHUNK_ROWS])
    return QuantizedTable(q=q, scale=scale, f32=table)


@torch.no_grad()
def quantized_topk(
    qt: QuantizedTable,
    queries: torch.Tensor,                # [Qn, D] float
    k: int,
    m: int | None = None,                 # candidate pool (default max(4k, k+8))
    mask: torch.Tensor | None = None,     # [N] bool, True keeps the row
    exclude: torch.Tensor | None = None,  # [Qn] int, row to drop (-1: none)
    head: torch.Tensor | None = None,     # [2] (alpha, beta)
    top_r: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-rescored top-k through an int8 scan, with masked_topk's contract:
    (values [Qn, k] exact f32 scores, indices [Qn, k] int64), descending,
    -1e30 / -1 past the valid rows."""
    return quantized_two_stage(packed_candidates, qt, queries, k, m, mask, exclude, head, top_r)


def quantized_pool(k: int, n: int, m: int | None = None) -> int:
    """The candidate pool stage 2 rescores: ``m`` (default max(4k, k + 8)
    rows, at most n), at least k."""
    return max(min(max(4 * k, k + 8), n) if m is None else m, k)


def quantized_two_stage(stage1, qt, queries, k, m=None, mask=None, exclude=None, head=None,
                        top_r=None):
    """quantized_topk with the given stage 1 (packed_candidates, or
    topk._packed_candidates_plain to run the plain version on any device)."""
    if queries.dim() == 1:
        queries = queries[None, :]
    n = qt.q.shape[0]
    m = quantized_pool(k, n, m)
    top_r = top_r_policy(k, n, top_r)
    q_int, q_scale = _quantize(queries.float())
    keys = stage1(qt.q, q_int.contiguous(), top_r, mask=mask, exclude=exclude, head=head,
                  qscale=q_scale, wscale=qt.scale)
    cand, alive = _stage1_pool(keys, m, top_r)
    return _rescore_pool(qt.f32, queries, cand, alive, k, head)
