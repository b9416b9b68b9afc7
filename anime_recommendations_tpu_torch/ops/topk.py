"""Two-stage masked top-k over a row table: the retrieval hot loop.

Counterpart of anime_recommendations_tpu/ops/topk.py, with the same contract
and the same two stages:

  stage 1 (packed_candidates) scores every row for every query in one pass
          over the table. The score, optionally through the folded
          sigmoid head, is biased by +2 so every in-contract score is
          positive; masked, excluded and out-of-range rows get -1. Its f32
          bits, with the low 9 bits replaced by the row's lane in its
          512-row group, form an int32 key whose order is score order, so a
          max is also an argmax. Each group keeps its top_r keys. On a CUDA
          tensor this is the hand-written kernel csrc/packed_topk.cu; on a
          CPU tensor it is _packed_candidates_plain, the same function in
          torch ops.
  stage 2 (_rescore_pool) takes the top-m keys, rebuilds their rows from
          (position, key low bits), gathers those rows and rescores them in
          exact f32, and returns the pool's top-k.

The TPU kernel's layout choices are not carried over: there is no [Qp, B]
lane layout, no VMEM block sizing and no dense tail for a ragged last block
(the CUDA kernel masks rows >= N itself), and small tables take the same
kernel as large ones.

Contracts, as in the JAX package: values are sorted descending and are exact
f32 scores; slots past the valid rows hold -1e30 with index -1; stage-1
ranking assumes scores > -2 (cosine over normalized rows, or the sigmoid
head); and a mask that funnels the surviving rows into a few physical
groups can cut them to top_r per group, which ShuffledTable defuses.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from anime_recommendations_tpu_torch.ops import _kernels

GROUP = 512            # rows per extraction group (low key bits carry the lane)
_NEG = -1e30           # dead-slot score sentinel
_BIAS = 2.0            # makes every in-contract score positive
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OVERFLOW_BUDGET = 1e-6  # expected overflowing groups per query (top_r_policy)


@functools.lru_cache(maxsize=4096)
def top_r_policy(k: int, n: int, top_r: int | None = None) -> int:
    """Per-group extraction depth, at most one group.

    As in the JAX package, the depth covers a max(4k, 64)-candidate budget
    across the groups. The JAX package then takes 3 (2 above 64 queries),
    because on the TPU each round is two more vector passes over the whole
    score surface. Here a round is a few warp reductions per 512 rows (256
    queries over 91,641 rows, two runs on an H100 at 700 W: 0.571 and 0.507
    ms at depth 2, 0.565 and 0.549 ms at depth 4: the deeper extraction
    costs between -1 % and 8 % of stage 1 there), while a fixed depth
    loses a true top-k row whenever more than top_r of them share a group:
    on that H100 it showed as overlap 0.99961 with the dense oracle at 256
    queries over 91,641 rows (depth 2) and 0.99844 at 64 queries over
    17,560 rows (depth 3). So without a pinned ``top_r`` the depth is
    raised until the expected number of groups holding more than top_r of
    the k winners, placed at random (ShuffledTable), is at most 1e-6 per
    query: 4 for k = 10 over the user table, 6 over the anime table."""
    n_groups = -(-n // GROUP)
    cover = min(max(4 * k, 64), n)
    depth = max(3 if top_r is None else top_r, -(-cover // n_groups) + 1)
    if top_r is None:
        while depth < GROUP and _overflowing_groups(min(k, n), n_groups, depth) > _OVERFLOW_BUDGET:
            depth += 1
    return min(depth, GROUP)


def _overflowing_groups(k: int, groups: int, depth: int) -> float:
    """Expected number of groups that receive more than ``depth`` of ``k``
    rows placed uniformly at random over ``groups`` groups."""
    if depth >= k:
        return 0.0
    if groups == 1:
        return 1.0
    logp, logq = -math.log(groups), math.log1p(-1.0 / groups)
    tail = sum(
        math.exp(math.lgamma(k + 1) - math.lgamma(j + 1) - math.lgamma(k - j + 1)
                 + j * logp + (k - j) * logq)
        for j in range(depth + 1, k + 1)
    )
    return groups * tail


def packed_candidates(
    table: torch.Tensor,                  # [N, D] f32 or bf16
    queries: torch.Tensor,                # [Q, D] table dtype
    top_r: int,
    mask: torch.Tensor | None = None,     # [N] bool, True keeps the row
    exclude: torch.Tensor | None = None,  # [Q] int, row to drop (-1: none)
    head: torch.Tensor | None = None,     # [2] f32 (alpha, beta)
) -> torch.Tensor:
    """Stage 1: int32 keys [Q, ceil(N/512) * top_r], each group's top_r keys
    largest first (module docstring). A CUDA table launches the kernel; a
    CPU table runs the plain version."""
    if table.device.type == "cpu":
        return _packed_candidates_plain(table, queries, top_r, mask, exclude, head)
    if table.device.type != "cuda":
        raise ValueError(f"packed_candidates: unsupported device {table.device}")
    return _packed_candidates_cuda(table, queries, top_r, mask, exclude, head)


def _packed_candidates_plain(table, queries, top_r, mask, exclude, head):
    """Stage 1 in plain torch ops: fp32 scores, the same keys, topk per group."""
    n = table.shape[0]
    qn = queries.shape[0]
    n_groups = -(-n // GROUP)
    scores = queries.float() @ table.float().T                      # [Q, N]
    if head is not None:
        scores = torch.sigmoid(head[0] * scores + head[1])
    valid = torch.ones_like(scores, dtype=torch.bool)
    if mask is not None:
        valid &= mask[None, :]
    if exclude is not None:
        rows = torch.arange(n, device=table.device)
        valid &= rows[None, :] != exclude[:, None]
    s2 = torch.where(valid, scores + _BIAS, -1.0)
    s2 = torch.nn.functional.pad(s2, (0, n_groups * GROUP - n), value=-1.0)
    lane = torch.arange(n_groups * GROUP, device=table.device, dtype=torch.int32)
    keys = (s2.view(torch.int32) & ~(GROUP - 1)) | (lane & (GROUP - 1))
    top = keys.view(qn, n_groups, GROUP).topk(top_r, dim=2).values
    return top.reshape(qn, n_groups * top_r)


def _packed_candidates_cuda(table, queries, top_r, mask, exclude, head):
    """Launch csrc/packed_topk.cu on PyTorch's current stream."""
    n, d = table.shape
    qn = queries.shape[0]
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(f"packed_topk takes f32 or bf16 tables, got {table.dtype}")
    if queries.dtype != table.dtype or queries.device != table.device:
        raise TypeError("packed_topk: queries must match the table's dtype and device")
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"packed_topk: queries {tuple(queries.shape)} vs table {tuple(table.shape)}")
    if d % 16 or not 1 <= top_r <= GROUP or not 1 <= qn <= 8 * 65535:
        raise ValueError(f"packed_topk: needs D % 16 == 0, 1 <= top_r <= {GROUP}, "
                         f"1 <= Q <= {8 * 65535}; got D={d}, top_r={top_r}, Q={qn}")
    for name, t in (("table", table), ("queries", queries)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"packed_topk: {name} must be contiguous and 16-byte aligned")
    if mask is not None:
        if mask.shape != (n,) or mask.dtype != torch.bool or mask.device != table.device:
            raise ValueError("packed_topk: mask must be a bool [N] tensor on the table's device")
        mask = mask.contiguous()
    if exclude is not None:
        if exclude.shape != (qn,) or exclude.device != table.device:
            raise ValueError("packed_topk: exclude must be an int [Q] tensor on the table's device")
        exclude = exclude.to(torch.int32).contiguous()
    if head is not None:
        head = head.to(device=table.device, dtype=torch.float32).contiguous()
        if head.shape != (2,):
            raise ValueError("packed_topk: head must be [2] (alpha, beta)")
    n_groups = -(-n // GROUP)
    out = torch.empty((qn, n_groups * top_r), dtype=torch.int32, device=table.device)
    args = [table.data_ptr(), _DTYPE_CODES[table.dtype], queries.data_ptr()]
    args += [None if t is None else t.data_ptr() for t in (mask, exclude, head)]
    args += [out.data_ptr(), n, d, qn, top_r,
             ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream)]
    err = _kernels.library("packed_topk").packed_topk(*args)
    _kernels.check(err, "packed_topk")
    _kernels.count_launch("packed_topk")
    return out


def _stage1_pool(keys: torch.Tensor, m: int, top_r: int):
    """Top-m keys of each query -> (candidate rows [Q, m'], alive [Q, m'])."""
    m_eff = min(m, keys.shape[1])
    top, pos = keys.topk(m_eff, dim=1)
    cand = torch.div(pos, top_r, rounding_mode="floor") * GROUP + (top & (GROUP - 1)).long()
    return cand, top > 0   # a non-positive key is a masked or padding slot


def _rescore_pool(table, queries, cand, alive, k: int, head):
    """Stage 2: exact f32 rescore of the candidate pool, true top-k of it."""
    if table.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        # The rescore is the exact stage: TF32 would round its products.
        raise RuntimeError("exact rescore needs torch.backends.cuda.matmul.allow_tf32 = False")
    n = table.shape[0]
    m = cand.shape[1]
    rows = table[cand.clamp(0, n - 1)].float()                      # [Q, m, D]
    scores = torch.bmm(rows, queries.float()[:, :, None])[:, :, 0]  # [Q, m]
    if head is not None:
        scores = torch.sigmoid(head[0] * scores + head[1])
    scores = scores.masked_fill(~alive, _NEG)
    cand = cand.masked_fill(~alive, -1)
    kk = min(k, m)
    top_s, pos = scores.topk(kk, dim=1)
    top_i = cand.gather(1, pos)
    if k > kk:
        top_s = torch.nn.functional.pad(top_s, (0, k - kk), value=_NEG)
        top_i = torch.nn.functional.pad(top_i, (0, k - kk), value=-1)
    return top_s, top_i


def masked_topk(
    table: torch.Tensor,                  # [N, D] f32 or bf16
    queries: torch.Tensor,                # [Qn, D]
    k: int,
    mask: torch.Tensor | None = None,     # [N] bool, True keeps the row
    exclude: torch.Tensor | None = None,  # [Qn] int, row to drop (-1: none)
    head: torch.Tensor | None = None,     # [2] (alpha, beta): sigmoid(alpha*s+beta)
    top_r: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (optionally head-transformed) ``queries @ table.T`` scores.

    Returns (values [Qn, k] f32, indices [Qn, k] int64) sorted descending;
    values are exact f32 scores. Rows masked out, excluded or beyond N
    appear only when fewer than k valid rows exist, with value -1e30 and
    index -1. The candidate pool is m = max(2k + 4, 24) rows; ``top_r``
    pins the per-group depth (default: top_r_policy). Scores must be > -2
    (module docstring).
    """
    return two_stage_topk(packed_candidates, table, queries, k, mask=mask,
                          exclude=exclude, head=head, top_r=top_r)


def two_stage_topk(stage1, table, queries, k, mask=None, exclude=None,
                   head=None, top_r=None):
    """masked_topk with the given stage 1 (packed_candidates, or
    _packed_candidates_plain to run the plain version on any device)."""
    n = table.shape[0]
    top_r = top_r_policy(k, n, top_r)
    m = min(max(2 * k + 4, 24), n)
    keys = stage1(
        table, queries.to(table.dtype).contiguous(), top_r,
        mask=mask, exclude=exclude, head=head,
    )
    cand, alive = _stage1_pool(keys, m, top_r)
    return _rescore_pool(table, queries, cand, alive, k, head)


class ShuffledTable(NamedTuple):
    """A retrieval table stored in a fixed random physical row order.

    Stage 1 keeps the top_r rows of each physical 512-row group. Trained
    tables put popular, mutually similar rows at adjacent low vocab ids, so
    a hot query's whole top-k can land in one group and be cut to top_r.
    One build-time shuffle restores random placement; _dispatch_topk
    translates masks, exclusions and returned indices across it.

    ``table``: [N, D] rows in physical order. ``perm``: [N] physical ->
    logical row id. ``inv``: [N] logical -> physical position.
    """

    table: torch.Tensor
    perm: torch.Tensor
    inv: torch.Tensor


def shuffle_rows(table: torch.Tensor, seed: int = 0) -> ShuffledTable:
    """Build a ShuffledTable; the permutation is numpy.random.default_rng(seed)'s
    (it cannot match jax.random: results agree up to ties)."""
    n = table.shape[0]
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n)).to(table.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=table.device)
    return ShuffledTable(table=table[perm].contiguous(), perm=perm, inv=inv)


def _dispatch_topk(
    table,                       # tensor | ShuffledTable
    queries: torch.Tensor,       # [Qn, D]
    mask,                        # [N] bool (array or tensor) or None
    exclude,                     # [Qn] int (array or tensor) or None
    head,                        # [2] tensor or None
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One entry for every retrieval flavour: a plain table, or a
    ShuffledTable whose masks, exclusions and results are translated across
    its permutation. Masks and exclusions may be numpy arrays."""
    if isinstance(table, ShuffledTable):
        inner = table.table
    elif isinstance(table, torch.Tensor):
        inner = table
    else:
        raise NotImplementedError(
            f"{type(table).__name__} retrieval tables are not ported yet: int8 "
            "(QuantizedTable) is ROADMAP.md Queue 2 K2q, IVF is Queue 1 ops/ivf.py"
        )
    dev = inner.device
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
        mask = mask if mask.dtype == torch.bool else mask > 0
    if exclude is not None:
        exclude = torch.as_tensor(exclude, device=dev).long()
    if not isinstance(table, ShuffledTable):
        return masked_topk(inner, queries, k, mask=mask, exclude=exclude, head=head)
    n = table.perm.shape[0]
    mask_p = None if mask is None else mask[table.perm]
    excl_p = None
    if exclude is not None:
        excl_p = torch.where(exclude >= 0, table.inv[exclude.clamp(0, n - 1)], -1)
    vals, idx_p = masked_topk(inner, queries, k, mask=mask_p, exclude=excl_p, head=head)
    idx = torch.where(idx_p >= 0, table.perm[idx_p.clamp(0, n - 1)], idx_p)
    return vals, idx


def cosine_topk(
    table_normalized,
    query_rows: torch.Tensor,
    k: int,
    mask=None,
    exclude=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine similarity of query rows against a row-normalized table
    (a tensor or a ShuffledTable); the query rows are assumed normalized."""
    if query_rows.dim() == 1:
        query_rows = query_rows[None, :]
    return _dispatch_topk(table_normalized, query_rows, mask, exclude, None, k=k)
