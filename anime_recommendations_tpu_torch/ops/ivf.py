"""IVF (inverted-file) clustered retrieval for tables beyond the exact scan's
latency budget.

Counterpart of anime_recommendations_tpu/ops/ivf.py, with its contract and
its index layout. The build runs spherical k-means (Lloyd's) over the
L2-normalized rows and stores each cluster's member row ids in a
fixed-capacity bucket grid; a query scores the C centroids, probes its top
``probes`` buckets, gathers those rows and the shared spill list, and
rescores them exactly. It reads C*D + (probes*cap + spill)*D values per
query instead of N*D, at a recall set by ``probes``.

Layout, as in the JAX package: buckets are a dense [C, cap] grid padded with
-1, cap = ceil(cap_factor * N / C / 8) * 8; members of a cluster past cap go
to one spill list (-1 padded to a multiple of 8) that every query scans, so
an overflow costs time, never a row. Centroids are f32 whatever the table's
dtype.

What differs from the JAX package, with the same results:
  * the k-means assignment runs over [chunk, D] blocks (the [N, C] score
    matrix is never made) without padding the last block, and the centroid
    update sums rows with index_add_ (the JAX package's one-hot matmul
    avoids the TPU's slow scatter);
  * ivf_topk picks its query chunk from a budget of gathered bytes
    (GATHER_BUDGET) instead of a fixed 16: the gathered [chunk, M, D]
    candidates of a probe-all query over 2M rows in 2,048 clusters are
    ~3 GB a query;
  * add_rows places the new rows with a stable sort by cluster instead of a
    Python loop over them; buckets and spill list come out identical.

Exactness. Probing every cluster is exact for f32 (and bf16) storage: every
row is in a bucket or the spill list, and each is rescored. With int8
storage it is not: stage 1 keeps the best max(4k, k+8) candidates by their
int8 score before the exact rescore, and quantization noise can push a
true top-k row out of that pool.

Every matmul here is in f32 (the int8 products too: their integer sums stay
below 2^24 for D <= 1040, so f32 holds them exactly); TF32 would round them,
so a CUDA table with torch.backends.cuda.matmul.allow_tf32 set raises.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from anime_recommendations_tpu_torch.ops.quantized import quantize_rows
from anime_recommendations_tpu_torch.ops.topk import request_inputs

# Bytes of gathered candidate rows (and their f32 copy) per query chunk of
# ivf_topk; a single query above it runs alone.
GATHER_BUDGET = 1 << 30


class IVFIndex(NamedTuple):
    """Clustered index over an L2-row-normalized table.

    centroids : [C, D] f32, L2-normalized cluster directions
    buckets   : [C, cap] int64 member row ids, -1 padded
    spill     : [S] int64 overflow row ids, -1 padded to a multiple of 8
    table     : [N, D] the rows, for the exact rescore
    q8, scale : int8 rows and their per-row scales (storage="int8"): the
                candidate gather reads a quarter of the bytes, and a pool
                of max(4k, k+8) candidates per query is rescored from
                ``table``
    """

    centroids: torch.Tensor
    buckets: torch.Tensor
    spill: torch.Tensor
    table: torch.Tensor
    q8: torch.Tensor | None = None
    scale: torch.Tensor | None = None

    @property
    def n_clusters(self) -> int:
        return self.buckets.shape[0]

    @property
    def bucket_cap(self) -> int:
        return self.buckets.shape[1]


def ivf_from_numpy(arrays: Mapping[str, np.ndarray], device) -> IVFIndex:
    """The index of the JAX package's IVFIndex arrays (its field names;
    q8 and scale may be absent or None) on ``device``. bf16 tables arrive
    as numpy arrays of the ml_dtypes bfloat16 type."""

    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
        return torch.from_numpy(a.copy()).to(device)

    optional = {k: tensor(arrays[k]) for k in ("q8", "scale") if arrays.get(k) is not None}
    return IVFIndex(
        centroids=tensor(arrays["centroids"]).float(),
        buckets=tensor(arrays["buckets"]).long(),
        spill=tensor(arrays["spill"]).long(),
        table=tensor(arrays["table"]),
        **optional,
    )


def _check_no_tf32(t: torch.Tensor, what: str) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{what} needs torch.backends.cuda.matmul.allow_tf32 = False")


def default_n_clusters(n: int) -> int:
    """~sqrt(N) clusters, a power of two within [64, 8192], at most N."""
    c = min(8192, max(64, 1 << int(round(math.log2(max(64, math.isqrt(n)))))))
    return min(c, n)


@torch.no_grad()
def _kmeans(table: torch.Tensor, init_ids: torch.Tensor, n_clusters: int, iters: int,
            chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Spherical Lloyd's: (centroids [C, D] f32, assignment [N] int64).

    Rows are assigned by the argmax of their [chunk, D] @ [D, C] block (the
    first cluster on a tie, as jnp.argmax); a centroid becomes the direction
    of its members' sum, and keeps its place when it has no members or they
    sum to zero."""
    _check_no_tf32(table, "the k-means assignment")
    n, d = table.shape
    cent = table[init_ids].float()

    def blocks():
        for s in range(0, n, chunk):
            block = table[s:s + chunk].float()
            yield block, torch.argmax(block @ cent.T, dim=1)

    for _ in range(iters):
        sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=table.device)
        counts = torch.zeros(n_clusters, dtype=torch.int64, device=table.device)
        for block, assign in blocks():
            sums.index_add_(0, assign, block)
            counts += torch.bincount(assign, minlength=n_clusters)
        norm = torch.linalg.norm(sums, dim=1, keepdim=True)
        keep = (counts[:, None] > 0) & (norm > 1e-12)
        cent = torch.where(keep, sums / norm.clamp_min(1e-12), cent)
    return cent, torch.cat([assign for _, assign in blocks()])


def _padded_spill(ids: np.ndarray) -> np.ndarray:
    """The spill list: ``ids`` padded with -1 to a multiple of 8 (at least 8)."""
    out = np.full(-(-max(len(ids), 1) // 8) * 8, -1, np.int64)
    out[:len(ids)] = ids
    return out


@torch.no_grad()
def build_ivf(
    table: torch.Tensor,
    n_clusters: int | None = None,
    iters: int = 8,
    seed: int = 0,
    cap_factor: float = 3.0,
    chunk: int = 16_384,
    storage: str = "f32",
) -> IVFIndex:
    """Build an IVF index on the table's device (one host copy of the
    assignment lays out the buckets).

    The initial centroids are the rows numpy.random.default_rng(seed)
    chooses without replacement, as in the JAX package. A cluster's members
    fill its bucket in row order up to cap = ceil(cap_factor * N / C / 8) *
    8; the rest go to the spill list, cluster by cluster. storage="int8"
    also keeps a symmetric per-row int8 copy for the candidate gather
    (ops/quantized.quantize_rows)."""
    if storage not in ("f32", "int8"):
        raise ValueError(f"storage must be 'f32' or 'int8', got {storage!r}")
    n, _ = table.shape
    n_clusters = default_n_clusters(n) if n_clusters is None else min(n_clusters, n)
    init_ids = np.random.default_rng(seed).choice(n, size=n_clusters, replace=False)
    cent, assign = _kmeans(table, torch.from_numpy(init_ids).to(table.device), n_clusters,
                           iters, min(chunk, n))
    assign = assign.cpu().numpy()

    cap = int(np.ceil(cap_factor * n / n_clusters / 8) * 8)
    order = np.argsort(assign, kind="stable")
    cluster = assign[order]
    rank = np.arange(n) - np.searchsorted(cluster, cluster)   # place within its cluster
    fits = rank < cap
    buckets = np.full((n_clusters, cap), -1, np.int64)
    buckets[cluster[fits], rank[fits]] = order[fits]
    q8 = scale = None
    if storage == "int8":
        qt = quantize_rows(table)
        q8, scale = qt.q, qt.scale
    return IVFIndex(
        centroids=cent,
        buckets=torch.from_numpy(buckets).to(table.device),
        spill=torch.from_numpy(_padded_spill(order[~fits])).to(table.device),
        table=table,
        q8=q8,
        scale=scale,
    )


@torch.no_grad()
def add_rows(index: IVFIndex, new_rows) -> IVFIndex:
    """Append rows without re-clustering; their ids follow the table's.

    Each new row joins its nearest centroid's bucket, after the bucket's
    members, or the spill list when the bucket is full: the rows of one
    cluster take its free slots in id order, and the overflow joins the
    spill list in id order (the JAX package's loop over the rows gives the
    same layout). Centroids do not change; rebuild when the rows drift."""
    table = index.table
    new_rows = torch.as_tensor(new_rows, dtype=table.dtype, device=table.device)
    if new_rows.dim() == 1:
        new_rows = new_rows[None, :]
    _check_no_tf32(table, "add_rows' assignment")
    n_old = table.shape[0]
    assign = torch.argmax(new_rows.float() @ index.centroids.T, dim=1).cpu().numpy()
    buckets = index.buckets.cpu().numpy().copy()
    fill = (buckets >= 0).sum(axis=1)
    order = np.argsort(assign, kind="stable")
    cluster = assign[order]
    slot = fill[cluster] + np.arange(len(order)) - np.searchsorted(cluster, cluster)
    fits = slot < index.bucket_cap
    buckets[cluster[fits], slot[fits]] = n_old + order[fits]
    old_spill = index.spill.cpu().numpy()
    spill = np.concatenate([old_spill[old_spill >= 0], n_old + np.sort(order[~fits])])
    q8 = scale = None
    if index.q8 is not None:
        qt = quantize_rows(new_rows)
        q8, scale = torch.cat([index.q8, qt.q]), torch.cat([index.scale, qt.scale])
    return IVFIndex(
        centroids=index.centroids,
        buckets=torch.from_numpy(buckets).to(table.device),
        spill=torch.from_numpy(_padded_spill(spill)).to(table.device),
        table=torch.cat([table, new_rows]),
        q8=q8,
        scale=scale,
    )


def query_chunk_for(n_candidates: int, d: int, budget: int = GATHER_BUDGET) -> int:
    """Queries per chunk whose gathered candidates fit ``budget`` bytes: each
    query gathers n_candidates rows of d values, and each gathered value takes
    at most 8 bytes (the table's dtype plus its f32 copy)."""
    return max(1, budget // (n_candidates * d * 8))


@torch.no_grad()
def ivf_topk(
    index: IVFIndex,
    queries: torch.Tensor,
    k: int,
    probes: int = 8,
    mask: torch.Tensor | None = None,
    exclude: torch.Tensor | None = None,
    head: torch.Tensor | None = None,
    query_chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate cosine top-k: probe the top ``probes`` clusters, rescore exactly.

    Returns (values [Q, k] f32, row ids [Q, k] int64), descending; a 1-D
    query gives [k] each. ``mask`` ([N] bool, True keeps) applies to the
    gathered candidates and ``exclude`` ([Q] int, or one id for every
    query) drops one row per query. With ``head`` (alpha, beta) the values
    are sigmoid(alpha * cos + beta); probes and the int8 pool order by
    sign(alpha) * cos, so a negative slope probes the other end of the
    cosine axis. Slots past the live candidates hold -inf with id -1.
    ``query_chunk`` (default: query_chunk_for's budget) changes memory, not
    results. Recall is a function of ``probes``; probing every cluster is
    exact for float storage, not for int8 storage (module docstring).

    The host half (ivf_plan, ops/topk.request_inputs) and the device half
    (ivf_body) are what ops/topk._dispatch_topk stages and captures for an
    IVFIndex."""
    squeeze = queries.dim() == 1
    if squeeze:
        queries = queries[None, :]
    dev = index.table.device
    qn, d = queries.shape
    probes, qc = ivf_plan(index, qn, d, probes, query_chunk)
    mask, exclude, head = (None if t is None else t.to(dev) for t in request_inputs(
        index.table.shape[0], qn, mask, exclude, head, shared_exclude=True))
    vals, ids = ivf_body(index, queries, k, probes, qc, mask, exclude, head)
    return (vals[0], ids[0]) if squeeze else (vals, ids)


def ivf_plan(index: IVFIndex, qn: int, d: int, probes: int,
             query_chunk: int | None = None) -> tuple[int, int]:
    """(clusters probed, queries per chunk) of a request of ``qn`` queries:
    the static choices of ivf_body."""
    probes = min(probes, index.n_clusters)
    n_candidates = probes * index.bucket_cap + index.spill.shape[0]
    return probes, max(1, min(query_chunk or query_chunk_for(n_candidates, d), qn))


def ivf_body(index: IVFIndex, queries: torch.Tensor, k: int, probes: int, query_chunk: int,
             mask: torch.Tensor | None, exclude: torch.Tensor | None,
             head: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """ivf_topk's device half, on [Q, D] queries and its inputs on the
    index's device: no host read, and shapes set by Q, k, probes and the
    chunk alone (ops/scan_graph.py captures it)."""
    _check_no_tf32(index.table, "ivf_topk")
    dev = index.table.device
    qn = queries.shape[0]
    excl = torch.full((qn,), -1, dtype=torch.int64, device=dev) if exclude is None else exclude
    sgn = torch.ones((), device=dev)
    if head is not None:
        sgn = torch.where(head[0] >= 0, 1.0, -1.0)
    qc = query_chunk
    parts = [_probe_and_rescore(index, queries[s:s + qc].float(), excl[s:s + qc], k, probes,
                                mask, head, sgn)
             for s in range(0, qn, qc)]
    return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])


def _probe_and_rescore(index, q, excl, k, probes, mask, head, sgn):
    """ivf_topk for one chunk of f32 queries [qc, D]."""
    qc = q.shape[0]
    pid = ((q @ index.centroids.T) * sgn).topk(probes, dim=1).indices         # [qc, p]
    cand = torch.cat([index.buckets[pid].reshape(qc, -1),
                      index.spill.expand(qc, -1)], dim=1)                      # [qc, M]
    alive = (cand >= 0) & (cand != excl[:, None])
    safe = cand.clamp_min(0)
    if mask is not None:
        alive &= mask[safe]
    if index.q8 is not None:
        # int8 stage 1: the quantized query against the gathered int8 rows,
        # de-scaled as the JAX package does it, then a pool for the rescore.
        q_sc = q.abs().amax(dim=1).clamp_min(1e-12) / 127.0
        q_i8 = torch.round(q / q_sc[:, None])
        s1 = torch.bmm(index.q8[safe].float(), q_i8[:, :, None])[:, :, 0]
        s1 = s1 * q_sc[:, None] * index.scale[safe] * sgn
        s1 = s1.masked_fill(~alive, -math.inf)
        pool = s1.topk(min(max(4 * k, k + 8), s1.shape[1]), dim=1).indices
        cand, alive = cand.gather(1, pool), alive.gather(1, pool)
        safe = cand.clamp_min(0)
    scores = torch.bmm(index.table[safe].float(), q[:, :, None])[:, :, 0]    # [qc, M]
    if head is not None:
        scores = torch.sigmoid(head[0] * scores + head[1])
    scores = scores.masked_fill(~alive, -math.inf)
    if scores.shape[1] < k:   # fewer candidates than k: dead slots
        short = k - scores.shape[1]
        scores = torch.nn.functional.pad(scores, (0, short), value=-math.inf)
        cand = torch.nn.functional.pad(cand, (0, short), value=-1)
    vals, loc = scores.topk(k, dim=1)
    ids = cand.gather(1, loc)
    return vals, torch.where(torch.isfinite(vals), ids, -1)
