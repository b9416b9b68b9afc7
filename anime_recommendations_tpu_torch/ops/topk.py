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
          torch ops. The kernel has two branches: one query streams the
          table through the CUDA cores (counted as ``packed_topk``), more
          take the tensor cores on 64-query tiles (``packed_topk_mma``).
          Precision: for one query the scores are f32 products with f32
          sums. From TF32_MIN_Q = 2 queries, the tensor-core branch, and
          for f32 tables both operands are first rounded to
          TF32 (round_tf32: nearest, ties away from zero, as the card's
          cvt.rna.tf32.f32); bf16 tables are exact in TF32 and multiply as
          bf16. The plain version applies the same rule at the same query
          count on every device, so kernel and plain keys agree within a
          key step. This is within the JAX contract: the JAX stage 1 runs
          at DEFAULT precision, one bf16 MXU pass even for f32 tables, and
          its pool m = max(2k + 4, 24) was sized for that noise; the key
          already drops 9 mantissa bits (~1.2e-4), and stage 2 rescores
          every candidate in exact f32, so the returned values are exact.
  stage 2 (_rescore_pool) takes the top-m keys, rebuilds their rows from
          (position, key low bits), gathers those rows and rescores them in
          exact f32, and returns the pool's top-k.

An int8 table (ops/quantized.py) takes the same two stages: stage 1 reads
the int8 rows (csrc/packed_topk_int8.cu on the card: one query on the CUDA
cores, counted as ``packed_topk_int8``, from INT8_MMA_MIN_Q queries on the
int8 tensor cores, ``packed_topk_int8_mma``; both sum the same exact
integers, so the keys do not depend on the branch) and stage 2 rescores
the pool against the f32 rows. ``exact_scan=True`` takes one exact stage
instead (_exact_scan_topk: csrc/exact_topk.cu on the card): full-f32 scores,
each 512-row chunk's exact top-k, and a stable merge, so ties go to the
lower row as the JAX kernel's argmax gives them.

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
from anime_recommendations_tpu_torch.utils.profiling import span

GROUP = 512            # rows per extraction group (low key bits carry the lane)
# Query count from which stage 1 runs on the tensor cores, with TF32
# operands for f32 tables (module docstring): csrc/packed_topk.cu takes that
# branch for more than one query. PERF.md gives the measurement
# (tools/scan_kernels.py --time sweep) that set it.
TF32_MIN_Q = 2
# Query count from which int8 stage 1 runs on the int8 tensor cores
# (csrc/packed_topk_int8.cu's kMmaMinQ). Both branches compute the same
# exact int32 products, so the plain version has no such rule. PERF.md gives
# the measurement (tools/scan_kernels.py --time sweep) that set it.
INT8_MMA_MIN_Q = 2
_NEG = -1e30           # dead-slot score sentinel
_BIAS = 2.0            # makes every in-contract score positive
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OVERFLOW_BUDGET = 1e-6  # expected overflowing groups per query (top_r_policy)
# The scan kernels' grids (csrc/scan_common.cuh) are one dimension of
# (512-row group, query tile) blocks: at most MAX_BLOCKS of them, and rows
# are int32, the last group's end included.
MAX_BLOCKS = 2**31 - 1
MAX_ROWS = 2**31 - 1 - GROUP


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
    table: torch.Tensor,                  # [N, D] f32, bf16 or int8
    queries: torch.Tensor,                # [Q, D] table dtype
    top_r: int,
    mask: torch.Tensor | None = None,     # [N] bool, True keeps the row
    exclude: torch.Tensor | None = None,  # [Q] int, row to drop (-1: none)
    head: torch.Tensor | None = None,     # [2] f32 (alpha, beta)
    qscale: torch.Tensor | None = None,   # [Q] f32 query scales (int8 only)
    wscale: torch.Tensor | None = None,   # [N] f32 row scales (int8 only)
) -> torch.Tensor:
    """Stage 1: int32 keys [Q, ceil(N/512) * top_r], each group's top_r keys
    largest first (module docstring; the int8 keys are _int8_biased_scores').
    A CUDA table launches the kernel; a CPU table runs the plain version."""
    if (table.dtype == torch.int8) != (qscale is not None and wscale is not None):
        raise ValueError("packed_candidates: qscale and wscale come with an int8 table, "
                         "and only with one")
    if table.device.type == "cpu":
        return _packed_candidates_plain(table, queries, top_r, mask, exclude, head,
                                        qscale, wscale)
    if table.device.type != "cuda":
        raise ValueError(f"packed_candidates: unsupported device {table.device}")
    if table.dtype == torch.int8:
        return _packed_candidates_int8_cuda(table, queries, top_r, mask, exclude, head,
                                            qscale, wscale)
    return _packed_candidates_cuda(table, queries, top_r, mask, exclude, head)


def _int8_biased_scores(table, queries, qscale, wscale, head):
    """s2 [Q, N] of int8 rows and queries, as the JAX kernel forms it
    (topk.py:219-241,258-260): without a head qscale folds into the bias,
    s2 = acc * wscale + 2 / qscale = (cos + 2) / qscale, which orders each
    query's rows as the cosine does; with one, s2 = sigmoid(alpha * (acc *
    qscale * wscale) + beta) + 2. Each step is one rounded f32 operation,
    in csrc/packed_topk_int8.cu's order.

    acc is exact: every product of two int8 values and every partial sum is
    an integer of magnitude at most 128 * 127^2 = 2,064,512 < 2^24, so an f32
    matmul gets it in any summation order, provided TF32 does not round it."""
    if table.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("int8 stage 1 needs torch.backends.cuda.matmul.allow_tf32 = False")
    acc = queries.float() @ table.float().T                          # [Q, N]
    if head is None:
        return acc * wscale[None, :] + (_BIAS / qscale)[:, None]
    s = acc * qscale[:, None] * wscale[None, :]
    return torch.sigmoid(head[0] * s + head[1]) + _BIAS


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as cvt.rna.tf32.f32 rounds them: add half of the 13 dropped
    bits to the magnitude, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _packed_candidates_plain(table, queries, top_r, mask, exclude, head,
                             qscale=None, wscale=None):
    """Stage 1 in plain torch ops: f32 scores (of TF32-rounded f32 operands
    from TF32_MIN_Q queries, as the kernel), the same keys, topk per group."""
    n = table.shape[0]
    qn = queries.shape[0]
    n_groups = -(-n // GROUP)
    if table.dtype == torch.int8:
        s2 = _int8_biased_scores(table, queries, qscale, wscale, head)
    else:
        if table.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("plain stage 1 needs torch.backends.cuda.matmul.allow_tf32 = False")
        if table.dtype == torch.float32 and qn >= TF32_MIN_Q:
            table, queries = round_tf32(table), round_tf32(queries)
        scores = queries.float() @ table.float().T                  # [Q, N]
        if head is not None:
            scores = torch.sigmoid(head[0] * scores + head[1])
        s2 = scores + _BIAS
    s2 = torch.where(_live(s2, mask, exclude), s2, -1.0)
    s2 = torch.nn.functional.pad(s2, (0, n_groups * GROUP - n), value=-1.0)
    lane = torch.arange(n_groups * GROUP, device=table.device, dtype=torch.int32)
    keys = (s2.view(torch.int32) & ~(GROUP - 1)) | (lane & (GROUP - 1))
    top = keys.view(qn, n_groups, GROUP).topk(top_r, dim=2).values
    return top.reshape(qn, n_groups * top_r)


def _live(scores, mask, exclude):
    """[Q, N] bool: the row is kept by ``mask`` and is not the query's ``exclude``."""
    live = torch.ones_like(scores, dtype=torch.bool)
    if mask is not None:
        live &= mask[None, :]
    if exclude is not None:
        rows = torch.arange(scores.shape[1], device=scores.device)
        live &= rows[None, :] != exclude[:, None]
    return live


def _side_inputs(name, table, qn, mask, exclude, head):
    """Check and convert a kernel's optional mask [N] bool, exclude [Q] int
    and head [2] to what its C entry point takes (None stays None). The
    caller holds the returned tensors until the launch is enqueued: another
    thread could otherwise be handed their memory first."""
    n, dev = table.shape[0], table.device
    if mask is not None:
        if mask.shape != (n,) or mask.dtype != torch.bool or mask.device != dev:
            raise ValueError(f"{name}: mask must be a bool [N] tensor on the table's device")
        mask = mask.contiguous()
    if exclude is not None:
        if exclude.shape != (qn,) or exclude.device != dev:
            raise ValueError(f"{name}: exclude must be an int [Q] tensor on the table's device")
        exclude = exclude.to(torch.int32).contiguous()
    if head is not None:
        head = head.to(device=dev, dtype=torch.float32).contiguous()
        if head.shape != (2,):
            raise ValueError(f"{name}: head must be [2] (alpha, beta)")
    return mask, exclude, head


def _ptrs(*tensors) -> list:
    return [None if t is None else t.data_ptr() for t in tensors]


def _check_scan_inputs(name, table, queries, dtypes, depth, max_depth):
    """The checks every scan kernel's wrapper makes of its table and queries."""
    n, d = table.shape
    qn = queries.shape[0]
    if table.dtype not in dtypes:
        raise TypeError(f"{name} takes {' or '.join(map(str, dtypes))} tables, got {table.dtype}")
    if queries.dtype != table.dtype or queries.device != table.device:
        raise TypeError(f"{name}: queries must match the table's dtype and device")
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"{name}: queries {tuple(queries.shape)} vs table {tuple(table.shape)}")
    blocks = -(-n // GROUP) * qn    # at least the grid's blocks, whatever the query tile
    if (d % 16 or not 1 <= depth <= max_depth or not 1 <= qn <= 8 * 65535
            or n > MAX_ROWS or blocks > MAX_BLOCKS):
        raise ValueError(f"{name}: needs D % 16 == 0, 1 <= depth <= {max_depth}, "
                         f"1 <= Q <= {8 * 65535}, N <= {MAX_ROWS} and ceil(N / {GROUP}) * Q "
                         f"<= {MAX_BLOCKS}; got D={d}, depth={depth}, Q={qn}, N={n}")
    for what, t in (("table", table), ("queries", queries)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be contiguous and 16-byte aligned")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _packed_candidates_cuda(table, queries, top_r, mask, exclude, head, lib=None):
    """Launch csrc/packed_topk.cu (or ``lib``, a library of another version
    of it) on PyTorch's current stream."""
    _check_scan_inputs("packed_topk", table, queries, tuple(_DTYPE_CODES), top_r, GROUP)
    (n, d), qn = table.shape, queries.shape[0]
    n_groups = -(-n // GROUP)
    out = torch.empty((qn, n_groups * top_r), dtype=torch.int32, device=table.device)
    args = [table.data_ptr(), _DTYPE_CODES[table.dtype], queries.data_ptr()]
    side = _side_inputs("packed_topk", table, qn, mask, exclude, head)
    args += _ptrs(*side)
    args += [out.data_ptr(), n, d, qn, top_r, _stream(table)]
    err = (lib or _kernels.library("packed_topk")).packed_topk(*args)
    _kernels.check(err, "packed_topk")
    _kernels.count_launch("packed_topk_mma" if qn >= TF32_MIN_Q else "packed_topk")
    return out


def _packed_candidates_int8_cuda(table, queries, top_r, mask, exclude, head, qscale, wscale,
                                 lib=None):
    """Launch csrc/packed_topk_int8.cu (or ``lib``, a library of another
    version of it) on PyTorch's current stream."""
    _check_scan_inputs("packed_topk_int8", table, queries, (torch.int8,), top_r, GROUP)
    (n, d), qn = table.shape, queries.shape[0]
    scales = []
    for what, s, size in (("wscale", wscale, n), ("qscale", qscale, qn)):
        if s.shape != (size,) or s.dtype != torch.float32 or s.device != table.device:
            raise ValueError(f"packed_topk_int8: {what} must be an f32 [{size}] tensor "
                             "on the table's device")
        scales.append(s.contiguous())
    n_groups = -(-n // GROUP)
    out = torch.empty((qn, n_groups * top_r), dtype=torch.int32, device=table.device)
    args = [table.data_ptr(), scales[0].data_ptr(), queries.data_ptr(), scales[1].data_ptr()]
    side = _side_inputs("packed_topk_int8", table, qn, mask, exclude, head)
    args += _ptrs(*side)
    args += [out.data_ptr(), n, d, qn, top_r, _stream(table)]
    err = (lib or _kernels.library("packed_topk_int8")).packed_topk_int8(*args)
    _kernels.check(err, "packed_topk_int8")
    _kernels.count_launch("packed_topk_int8_mma" if qn >= INT8_MMA_MIN_Q else "packed_topk_int8")
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
    exact_scan: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (optionally head-transformed) ``queries @ table.T`` scores.

    Returns (values [Qn, k] f32, indices [Qn, k] int64) sorted descending;
    values are exact f32 scores. Rows masked out, excluded or beyond N
    appear only when fewer than k valid rows exist, with value -1e30 and
    index -1. The candidate pool is m = max(2k + 4, 24) rows; ``top_r``
    pins the per-group depth (default: top_r_policy). Scores must be > -2
    (module docstring). ``exact_scan=True`` takes the single exact stage
    instead (_exact_scan_topk), which lifts that bound and breaks ties
    toward the lower row; ``top_r`` is then unused.
    """
    if exact_scan:
        return _exact_scan_topk(table, queries.to(table.dtype).contiguous(), k,
                                mask=mask, exclude=exclude, head=head)
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


def _exact_scan_topk(table, queries, k, mask=None, exclude=None, head=None):
    """The worst-case-exact single stage (queries in the table's dtype). A
    CUDA table launches csrc/exact_topk.cu; a CPU table runs the plain
    version."""
    if table.device.type == "cpu":
        return _exact_scan_plain(table, queries, k, mask, exclude, head)
    if table.device.type != "cuda":
        raise ValueError(f"exact_scan: unsupported device {table.device}")
    return _exact_scan_cuda(table, queries, k, mask, exclude, head)


def _exact_scan_plain(table, queries, k, mask=None, exclude=None, head=None):
    """Dense f32 scores, head, mask and exclude, then the top-k by a stable
    descending sort: ties go to the lower row, as the JAX kernel's argmax and
    merge give them."""
    if table.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact_scan needs torch.backends.cuda.matmul.allow_tf32 = False")
    scores = queries.float() @ table.float().T                      # [Q, N]
    if head is not None:
        scores = torch.sigmoid(head[0] * scores + head[1])
    live = _live(scores, mask, exclude)
    rows = torch.arange(table.shape[0], device=table.device).expand_as(scores)
    return _merge_candidates(torch.where(live, scores, _NEG), torch.where(live, rows, -1), k)


def _merge_candidates(cand_s, cand_i, k: int):
    """Top-k of candidates laid out in row order ([Q, C] scores and rows,
    -1e30 / -1 for dead ones): a stable descending sort keeps the lower row
    first among equal scores (torch.topk does not say which comes first)."""
    kk = min(k, cand_s.shape[1])
    top_s, pos = torch.sort(cand_s, dim=1, descending=True, stable=True)
    top_s, pos = top_s[:, :kk], pos[:, :kk]
    top_i = cand_i.gather(1, pos).long()
    if k > kk:
        top_s = torch.nn.functional.pad(top_s, (0, k - kk), value=_NEG)
        top_i = torch.nn.functional.pad(top_i, (0, k - kk), value=-1)
    return top_s, top_i


def _exact_scan_cuda(table, queries, k, mask=None, exclude=None, head=None):
    """Launch csrc/exact_topk.cu: each 512-row chunk's exact top
    min(k, 512), then the stable merge of the chunks' candidates."""
    if k < 1:
        raise ValueError(f"exact_topk: k must be >= 1, got {k}")
    return _merge_candidates(*_exact_candidates_cuda(table, queries, min(k, GROUP), mask,
                                                     exclude, head), k)


def _exact_candidates_cuda(table, queries, kc, mask, exclude, head, lib=None):
    """csrc/exact_topk.cu (or ``lib``, a library of another version of it)
    on PyTorch's current stream: each chunk's top kc, [Q, n_chunks * kc]
    scores and rows."""
    _check_scan_inputs("exact_topk", table, queries, tuple(_DTYPE_CODES), kc, GROUP)
    (n, d), qn = table.shape, queries.shape[0]
    n_chunks = -(-n // GROUP)
    out_s = torch.empty((qn, n_chunks * kc), dtype=torch.float32, device=table.device)
    out_i = torch.empty((qn, n_chunks * kc), dtype=torch.int32, device=table.device)
    args = [table.data_ptr(), _DTYPE_CODES[table.dtype], queries.data_ptr()]
    side = _side_inputs("exact_topk", table, qn, mask, exclude, head)
    args += _ptrs(*side)
    args += [out_s.data_ptr(), out_i.data_ptr(), n, d, qn, kc, _stream(table)]
    err = (lib or _kernels.library("exact_topk")).exact_topk(*args)
    _kernels.check(err, "exact_topk")
    _kernels.count_launch("exact_topk")
    return out_s, out_i


class ShuffledTable(NamedTuple):
    """A retrieval table stored in a fixed random physical row order.

    Stage 1 keeps the top_r rows of each physical 512-row group. Trained
    tables put popular, mutually similar rows at adjacent low vocab ids, so
    a hot query's whole top-k can land in one group and be cut to top_r.
    One build-time shuffle restores random placement; _dispatch_topk
    translates masks, exclusions and returned indices across it.

    ``table``: [N, D] rows in physical order, or a QuantizedTable
    (ops/quantized.py) built from them. ``perm``: [N] physical -> logical
    row id. ``inv``: [N] logical -> physical position.
    """

    table: object
    perm: torch.Tensor
    inv: torch.Tensor


def shuffle_order(n: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, inv) of a ShuffledTable of ``n`` rows: numpy.random.default_rng(seed)'s
    permutation (it cannot match jax.random: results agree up to ties) and
    its inverse."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n)).to(device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=device)
    return perm, inv


def shuffle_rows(table: torch.Tensor, seed: int = 0) -> ShuffledTable:
    """Build a ShuffledTable of ``table``'s rows in shuffle_order(seed)."""
    perm, inv = shuffle_order(table.shape[0], seed, table.device)
    return ShuffledTable(table=table[perm].contiguous(), perm=perm, inv=inv)


class ScanRequest(NamedTuple):
    """The static half of one retrieval request, what JAX's jit of
    _dispatch_topk keys on: the table (its flavour and its tensors) and the
    depths and pools the policy chose on the host (stage_request). With
    the request's shapes it fixes every shape scan_body makes."""

    table: object             # tensor | QuantizedTable | ShuffledTable of either | IVFIndex
    k: int
    exact_scan: bool
    top_r: int | None         # stage-1 depth (two-stage scans)
    m: int | None             # the int8 candidate pool (QuantizedTable)
    probes: int | None        # clusters probed (IVFIndex)
    query_chunk: int | None   # IVF queries per chunk

    @property
    def device(self) -> torch.device:
        return _table_tensors(self.table)[0].device

    def key(self, inputs: dict) -> tuple:
        """The scan-graph key of this request with ``inputs``
        (ops/scan_graph.py): the table's flavour and its tensors by address,
        shape, strides and dtype, the static numbers, and each input's
        shape and dtype (None where absent)."""
        from anime_recommendations_tpu_torch.utils.graphs import layout

        return (_flavour(self.table), layout(_table_tensors(self.table)),
                self[1:], tuple((name, None if v is None else (tuple(v.shape), v.dtype))
                                for name, v in inputs.items()))


def _flavour(table) -> tuple:
    inner = table.table if isinstance(table, ShuffledTable) else table
    return type(table).__name__, type(inner).__name__


def _table_tensors(table) -> list[torch.Tensor]:
    """Every tensor a scan of ``table`` reads in place."""
    from anime_recommendations_tpu_torch.ops.ivf import IVFIndex
    from anime_recommendations_tpu_torch.ops.quantized import QuantizedTable

    if isinstance(table, ShuffledTable):
        return _table_tensors(table.table) + [table.perm, table.inv]
    if isinstance(table, QuantizedTable):
        return [table.q, table.scale, table.f32]
    if isinstance(table, IVFIndex):
        return [t for t in table if t is not None]
    if isinstance(table, torch.Tensor):
        return [table]
    raise TypeError(f"unsupported retrieval table {type(table).__name__}")


def stage_request(
    table,                       # tensor | QuantizedTable | ShuffledTable of either | IVFIndex
    queries: torch.Tensor,       # [Qn, D] float, on the table's device
    mask,                        # [N] bool (nonzero keeps; array or tensor) or None
    exclude,                     # [Qn] int (array or tensor) or None
    head,                        # [2] (alpha, beta) or None
    *,
    k: int,
    exact_scan: bool = False,
    top_r: int | None = None,
    m: int | None = None,
    probes: int | None = None,
) -> tuple[ScanRequest, dict]:
    """The host half of _dispatch_topk: check the inputs, choose the
    depths and pools, and convert mask, exclude and head to tensors (host
    arrays become host tensors; tensors keep their device). Returns the
    request and its inputs {"queries", "mask", "exclude", "head"} for
    scan_body, None where absent."""
    from anime_recommendations_tpu_torch.ops.ivf import IVFIndex, ivf_plan
    from anime_recommendations_tpu_torch.ops.quantized import QuantizedTable, quantized_pool

    inner = table.table if isinstance(table, ShuffledTable) else table
    rows = table.table if isinstance(table, IVFIndex) else _table_tensors(table)[0]
    n, dev = rows.shape[0], rows.device
    if queries.dim() != 2 or queries.device != dev:
        raise ValueError(f"queries must be [Q, D] on the table's device {dev}, "
                         f"got {tuple(queries.shape)} on {queries.device}")
    qn = queries.shape[0]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if isinstance(inner, QuantizedTable) and exact_scan:
        raise ValueError("exact_scan is a float-table mode; quantized retrieval "
                         "always exact-rescores its candidate pool instead")
    mask, exclude, head = request_inputs(n, qn, mask, exclude, head,
                                         shared_exclude=isinstance(table, IVFIndex))
    if isinstance(table, IVFIndex):
        if exact_scan:
            request = ScanRequest(table, k, True, None, None, None, None)
        else:
            probes, chunk = ivf_plan(table, qn, queries.shape[1],
                                     table.n_clusters if probes is None else probes)
            request = ScanRequest(table, k, False, None, None, probes, chunk)
    elif isinstance(inner, QuantizedTable):
        request = ScanRequest(table, k, False, top_r_policy(k, n, top_r),
                              quantized_pool(k, n, m), None, None)
    else:
        request = ScanRequest(table, k, exact_scan,
                              None if exact_scan else top_r_policy(k, n, top_r),
                              None, None, None)
    return request, {"queries": queries, "mask": mask, "exclude": exclude, "head": head}


def request_inputs(n: int, qn: int, mask, exclude, head, *,
                   shared_exclude: bool = False) -> tuple:
    """A request's mask ([N] bool; nonzero keeps), exclude ([Q] int64) and
    head ([2] f32, alpha and beta) as tensors, None where absent: host
    arrays become host tensors, tensors keep their device.
    ``shared_exclude``: one id may stand for every query's (ivf_topk's
    contract)."""
    if mask is not None:
        mask = torch.as_tensor(mask)
        mask = mask if mask.dtype == torch.bool else mask > 0
        if mask.shape != (n,):
            raise ValueError(f"mask must be [N] = [{n}], got {tuple(mask.shape)}")
    if exclude is not None:
        exclude = torch.as_tensor(exclude).long()
        if shared_exclude:
            exclude = exclude.reshape(-1).expand(qn).contiguous()
        if exclude.shape != (qn,):
            raise ValueError(f"exclude must be [Q] = [{qn}], got {tuple(exclude.shape)}")
    if head is not None:
        head = torch.as_tensor(head, dtype=torch.float32)
        if head.numel() != 2:
            raise ValueError("head must hold 2 values (alpha, beta)")
        head = head.reshape(2)
    return mask, exclude, head


def scan_body(request: ScanRequest, queries: torch.Tensor, mask: torch.Tensor | None,
              exclude: torch.Tensor | None, head: torch.Tensor | None,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The device half of _dispatch_topk: the ShuffledTable translation,
    the scan (stage 1 and the pool's rescore, the exact scan, or IVF's
    probes and rescore) and the unpermute, on inputs on the table's
    device. It reads nothing on the host and makes no shape that depends
    on the data, so a CUDA graph can hold it (ops/scan_graph.py)."""
    from anime_recommendations_tpu_torch.ops.ivf import IVFIndex, ivf_body
    from anime_recommendations_tpu_torch.ops.quantized import QuantizedTable, quantized_two_stage

    table, k = request.table, request.k
    if isinstance(table, IVFIndex):
        if request.exact_scan:
            return _exact_scan_topk(table.table, queries.to(table.table.dtype).contiguous(), k,
                                    mask=mask, exclude=exclude, head=head)
        return ivf_body(table, queries, k, request.probes, request.query_chunk, mask, exclude,
                        head)

    def scan(t, mask, exclude):
        if isinstance(t, QuantizedTable):
            return quantized_two_stage(packed_candidates, t, queries, k, request.m, mask,
                                       exclude, head, request.top_r)
        return masked_topk(t, queries, k, mask=mask, exclude=exclude, head=head,
                           top_r=request.top_r, exact_scan=request.exact_scan)

    if not isinstance(table, ShuffledTable):
        return scan(table, mask, exclude)
    n = table.perm.shape[0]
    mask_p = None if mask is None else mask[table.perm]
    excl_p = None
    if exclude is not None:
        excl_p = torch.where(exclude >= 0, table.inv[exclude.clamp(0, n - 1)], -1)
    vals, idx_p = scan(table.table, mask_p, excl_p)
    idx = torch.where(idx_p >= 0, table.perm[idx_p.clamp(0, n - 1)], idx_p)
    return vals, idx


def _dispatch_topk(
    table,                       # tensor | QuantizedTable | ShuffledTable of either | IVFIndex
    queries: torch.Tensor,       # [Qn, D] float
    mask,                        # [N] bool (array or tensor) or None
    exclude,                     # [Qn] int (array or tensor) or None
    head,                        # [2] tensor or None
    *,
    k: int,
    exact_scan: bool = False,
    top_r: int | None = None,
    m: int | None = None,
    probes: int | None = None,
    graphs=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One entry for every retrieval flavour: a float table, an int8
    QuantizedTable (ops/quantized.quantized_topk; ``m`` is its pool), a
    ShuffledTable of either, whose masks, exclusions and results are
    translated across its permutation, or an IVFIndex (ops/ivf.ivf_topk
    over its top ``probes`` clusters, None: every cluster; with
    ``exact_scan`` the exact scan of its table). Masks and exclusions may be
    numpy arrays. ``exact_scan`` is a float-table mode.

    stage_request does the host half; scan_body the device half. On a CUDA
    table the body runs through ``graphs`` (an ops/scan_graph.ScanGraphs;
    None: scan_graph.DEFAULT, scan_graph.EAGER: the eager body), one graph
    replay per request once its signature is captured; elsewhere it runs
    eagerly."""
    from anime_recommendations_tpu_torch.ops import scan_graph

    with span("scan.stage"):
        request, inputs = stage_request(table, queries, mask, exclude, head, k=k,
                                        exact_scan=exact_scan, top_r=top_r, m=m,
                                        probes=probes)
    dev = request.device
    if dev.type != "cuda":
        return scan_body(request, **{name: None if v is None else v.to(dev)
                                     for name, v in inputs.items()})
    graphs = scan_graph.DEFAULT if graphs is None else graphs
    return graphs.run(request.key(inputs), functools.partial(scan_body, request), inputs, dev,
                      work=scan_work(request, inputs))


def scan_work(request: ScanRequest, inputs: dict) -> dict[str, int] | None:
    """One request's work as ScanGraphs.scan_report() counts it: its
    queries, the table rows each query scores (stage 1 or the exact scan),
    the bytes read (those rows, in the dtype they are scanned in, their
    int8 scales, the queries and the row mask) and the operations (2 D per
    query and row scored, 4 more with the head; the pool's rescore is left
    out). None for an IVF probe, which scores no whole table."""
    from anime_recommendations_tpu_torch.ops.ivf import IVFIndex

    queries = inputs["queries"]
    if isinstance(request.table, IVFIndex):
        if not request.exact_scan:
            return None
        table = request.table.table
    else:
        table = _table_tensors(request.table)[0]    # the rows stage 1 reads
    qn, d = queries.shape
    n = table.shape[0]
    nbytes = table.numel() * table.element_size() + queries.numel() * queries.element_size()
    if table.dtype == torch.int8:
        nbytes += n * 4                              # the rows' scales
    if inputs["mask"] is not None:
        nbytes += inputs["mask"].numel()
    flops = 2 * n * qn * d + (4 * n * qn if inputs["head"] is not None else 0)
    return {"queries": qn, "rows": n, "bytes": nbytes, "flops": flops}


def cosine_topk(
    table_normalized,
    query_rows: torch.Tensor,
    k: int,
    mask=None,
    exclude=None,
    *,
    exact_scan: bool = False,
    top_r: int | None = None,
    m: int | None = None,
    probes: int | None = None,
    graphs=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine similarity of query rows against a row-normalized table
    (a tensor, a QuantizedTable, a ShuffledTable of either, or an IVFIndex);
    the query rows are assumed normalized. The keywords are _dispatch_topk's."""
    if query_rows.dim() == 1:
        query_rows = query_rows[None, :]
    return _dispatch_topk(table_normalized, query_rows, mask, exclude, None, k=k,
                          exact_scan=exact_scan, top_r=top_r, m=m, probes=probes,
                          graphs=graphs)


def host_topk(scan, *args, **kwargs) -> tuple[np.ndarray, np.ndarray]:
    """``scan(*args, **kwargs)`` (cosine_topk or score_topk) with its values
    and indices read back to the host as numpy arrays: the span
    ``scan.call``, the read-back its last child ``scan.readback``."""
    with span("scan.call"):
        vals, idx = scan(*args, **kwargs)
        with span("scan.readback"):
            return vals.cpu().numpy(), idx.cpu().numpy()
