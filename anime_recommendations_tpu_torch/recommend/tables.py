"""Device half of the retrieval context: what every scan reads.

One copy of each normalized table, the copy the scans read: in a fixed
random row order (ShuffledTable, ops/topk.py), for an int8 context with the
int8 quantization of those rows beside them (ops/quantized.py), or IVF
indexes over the tables in logical order (ops/ivf.py). Query rows are read
from the same copy through the inverse permutation (``logical_rows``), so
no table is held twice. The build streams each table in chunks of rows
(normalize, then place each row at its shuffled position), so that its peak
is the tables' own bytes and a chunk's. Imports no pandas:
recommend/context.py adds the host frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import torch

from anime_recommendations_tpu_torch.models.two_tower import (
    BUFFER_KEYS,
    HEAD_KEYS,
    TF_L2_NORM_EPS,
    TwoTower,
)
from anime_recommendations_tpu_torch.ops.ivf import IVFIndex, build_ivf
from anime_recommendations_tpu_torch.ops.normalize import l2_normalize_rows
from anime_recommendations_tpu_torch.ops.quantized import QuantizedTable, quantize_rows
from anime_recommendations_tpu_torch.ops.scoring import head_affine
from anime_recommendations_tpu_torch.ops.topk import ShuffledTable, shuffle_order
from anime_recommendations_tpu_torch.utils.profiling import span

_DTYPES = {
    None: torch.float32, "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "i8": torch.int8,
}
ANIME_SHUFFLE_SEED, USER_SHUFFLE_SEED = 11, 13
CHUNK_ROWS = 1 << 19    # rows a build step normalizes (256 MB of f32 at D = 128)


@dataclass(frozen=True)
class RetrievalTables:
    head: torch.Tensor               # [2] f32 (alpha, beta) folded eval-mode head
    anime_scan: ShuffledTable | IVFIndex   # .table: rows, or a QuantizedTable for int8
    user_scan: ShuffledTable | IVFIndex
    anime_qt: QuantizedTable | None = None   # the int8 scan tables (None: float)
    user_qt: QuantizedTable | None = None


def retrieval_dtype_of(retrieval_dtype) -> torch.dtype:
    """f32 (exact scans), bf16 (half the scan traffic) or int8 (a quarter,
    candidates rescored in f32)."""
    try:
        return _DTYPES[retrieval_dtype]
    except KeyError:
        raise ValueError(
            f"unknown retrieval_dtype {retrieval_dtype!r}: choose 'f32', 'bf16' or 'int8'"
        ) from None


def logical_rows(scan, rows=None) -> torch.Tensor:
    """Normalized rows of a scan table by logical (vocab) row: ``rows`` (an
    int array, tensor or slice; None: every row, a copy of the table) read
    through a ShuffledTable's inverse permutation, from the f32 rows of an
    int8 table, or from an IVF index's table. The dtype is the rows' own
    (bf16 in a bf16 context, f32 otherwise)."""
    if isinstance(scan, IVFIndex):
        table = scan.table
    else:
        table = scan.table.f32 if isinstance(scan.table, QuantizedTable) else scan.table
    if rows is None:
        rows = slice(None)
    if isinstance(scan, ShuffledTable):
        if not isinstance(rows, slice):
            rows = torch.as_tensor(rows, dtype=torch.long).to(scan.inv.device)
        return table[scan.inv[rows]]
    if not isinstance(rows, slice):
        rows = torch.as_tensor(rows, dtype=torch.long).to(table.device)
    return table[rows]


@torch.no_grad()
def normalized_table(emb, *, device, out_dtype: torch.dtype,
                     inv: torch.Tensor | None = None) -> torch.Tensor:
    """The L2-normalized rows of ``emb`` (any [N, D] object whose row slices
    ``emb[lo:hi]`` give f32 tensors: a table on the card or the host, or
    rows drawn on demand) as one [N, D] ``out_dtype`` tensor on ``device``,
    row r at ``inv[r]`` (in logical order without ``inv``). It runs
    CHUNK_ROWS rows at a time through ops/normalize.l2_normalize_rows
    (two_tower's eps), so it holds the output and one chunk; each row is
    normalized alone, so the bits do not depend on the chunk."""
    n, d = emb.shape
    chunk_rows = CHUNK_ROWS
    out = torch.empty((n, d), dtype=out_dtype, device=device)
    chunks = 0
    with span("context.table") as s:
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            raw = emb[lo:hi].detach().to(device=device, dtype=torch.float32).contiguous()
            rows = l2_normalize_rows(raw, eps=TF_L2_NORM_EPS, out_dtype=out_dtype)
            if inv is None:
                out[lo:hi] = rows
            else:
                out.index_copy_(0, inv[lo:hi], rows)
            del raw, rows
            chunks += 1
        s.annotate(rows=n, bytes=out.numel() * out.element_size(), chunks=chunks)
    return out


@torch.no_grad()
def build_tables(model: TwoTower, *, device, retrieval_dtype=None,
                 ann: str = "off") -> RetrievalTables:
    """Normalize both tables in the retrieval dtype (ops/normalize's
    l2_normalize_rows with two_tower's eps), fold the head, and store one
    scan copy of each on ``device``, in a fixed random row order. The
    shuffle keeps trained tables, which put hot, mutually similar rows at
    adjacent vocab ids, from crowding one 512-row group. An int8 context
    quantizes the shuffled f32 rows and keeps them for the rescore and the
    query rows, as the JAX RecContext does.

    The model's tables are read CHUNK_ROWS rows at a time
    (``normalized_table``): they may live anywhere (on the host, as
    pipeline/runner.context_from_store loads them), so a table the card
    cannot hold twice is built beside nothing but a chunk.

    ``ann="ivf"`` builds IVF indexes over the normalized tables in logical
    order instead (anime with seed 11, users with seed 13; int8 storage for
    an int8 context): IVF gathers rows by id, so it takes no shuffle."""
    if ann not in ("off", "ivf"):
        raise ValueError(f"ann must be 'off' or 'ivf', got {ann!r}")
    dtype = retrieval_dtype_of(retrieval_dtype)
    norm_dtype = torch.float32 if dtype == torch.int8 else dtype
    # The head is folded on ``device`` wherever the model's tables are.
    scalars = {k: getattr(model, k).detach().to(device) for k in HEAD_KEYS + BUFFER_KEYS}
    head = head_affine(SimpleNamespace(**scalars)).float()
    scans, qts = [], []
    for emb, seed in ((model.anime_emb, ANIME_SHUFFLE_SEED), (model.user_emb, USER_SHUFFLE_SEED)):
        if ann == "ivf":
            rows = normalized_table(emb, device=device, out_dtype=norm_dtype)
            scans.append(build_ivf(rows, seed=seed,
                                   storage="int8" if dtype == torch.int8 else "f32"))
            qts.append(None)
            continue
        perm, inv = shuffle_order(emb.shape[0], seed, device)
        rows = normalized_table(emb, device=device, out_dtype=norm_dtype, inv=inv)
        qt = quantize_rows(rows) if dtype == torch.int8 else None
        scans.append(ShuffledTable(table=rows if qt is None else qt, perm=perm, inv=inv))
        qts.append(qt)
    return RetrievalTables(head=head, anime_scan=scans[0], user_scan=scans[1],
                           anime_qt=qts[0], user_qt=qts[1])


def tables_report(scan) -> dict:
    """What one retrieval table holds on its device: the bytes of its
    normalized rows (``table_bytes``), of its int8 rows and scales
    (``int8_bytes``) and of its permutation or IVF layout
    (``index_bytes``)."""
    if isinstance(scan, IVFIndex):
        rows = scan.table
        int8 = [t for t in (scan.q8, scan.scale) if t is not None]
        index = [scan.centroids, scan.buckets, scan.spill]
    else:
        inner = scan.table
        quantized = isinstance(inner, QuantizedTable)
        rows = inner.f32 if quantized else inner
        int8 = [inner.q, inner.scale] if quantized else []
        index = [scan.perm, scan.inv]

    def nbytes(ts):
        return int(sum(t.numel() * t.element_size() for t in ts))

    return {"rows": int(rows.shape[0]), "dtype": str(rows.dtype).removeprefix("torch."),
            "table_bytes": nbytes([rows]), "int8_bytes": nbytes(int8),
            "index_bytes": nbytes(index)}
