"""Fused sparse-gradient scatter + L2 decay + Adam update of one table.

Counterpart of anime_recommendations_tpu/ops/fused_adam.py::sparse_adam_update
(K1, ``_fused_adam_kernel`` with its stochastic rounding ``_sr_store`` and its
``has_dense`` branch; with ``next_ids``, K5, ``_fused_adam_gather_kernel``).
One call does, in one pass over the table:

    dscat  = zeros_like(w).index_add(ids, g_rows)      # rows outside [0, n) dropped
    dscat  = dscat + dense_grad                         # only with dense_grad
    g      = dscat + 2*l2*w
    mu'    = b1*mu + (1-b1)*g ;  nu' = b2*nu + (1-b2)*g^2
    w'     = w - lr * (mu'/bc1) / (sqrt(nu'/bc2) + eps)
    sumsq  = sum(w^2)                                   # before the update

with bc1 = 1 - b1^step and bc2 = 1 - b2^step, and with ``next_ids`` also

    rows   = w'[next_ids]                               # zero rows outside [0, n)

the rows the next training step consumes, in next_ids' order, each a copy
(never a view of the table, which the next step updates in place); the table
outputs are those of the call without ``next_ids``, bit for bit.

W, mu and nu are updated IN PLACE (the port's tables are mutable; nothing
else holds the old values) and returned. The moments are f32, or bf16 for
``fused_adam_bf16m``, whose stores round stochastically (module-level
``sr_random_bits``). The gathered rows add 5.1 MB of writes at 10,000 next
ids of 128, and no table read for most of them: the thread that updated a
row stores its copies from registers; the copies of rows with more than a
tile's worth of them are stored by a second pass (below).

``dense_grad`` ([N, D] f32) is a gradient already summed per row: the routed
trainer's overflow rounds (parallel/routing.route_grad_rows). It costs one
more read of an [N, D] table. With ``next_ids`` it is an error, as in JAX.

On a CUDA tensor this launches csrc/fused_adam.cu: ``fused_adam_tiles`` (a
first pass over tiles of TILE sorted positions, counted as such), then
``fused_adam`` (counted as ``fused_adam_dense`` when it takes a dense
gradient, or ``fused_adam_gather`` with ``next_ids``, which is followed by
``fused_adam_copies`` for a non-empty next batch); on a CPU tensor it runs
``_sparse_adam_update_plain`` (then ``_gather_rows_plain``), the same
function in torch ops. There is no fallback between them.

Skewed ids: a row's run of equal sorted ids is summed in a fixed order that
no thread stretches past a tile. A run inside one tile of TILE sorted
positions is summed from 0 in position order; a run crossing tile edges is
summed per tile (the first pass writes each crossing segment's sum) and the
segment sums are added in tile order (in chunks for a run of more than
LONG_PARTS tiles). ``run_sums_in_tile_order`` is that order in torch ops;
``_tile_sums_plain``, ``_block_starts_plain`` and ``_copies_plain`` are the
plain versions of the two passes.

Host-side preparation, on the tensors' device: a stable argsort of the batch
ids (or the caller's ``order``, computed earlier: any permutation that sorts
the ids ascending; the routed trainer's ``routing.receipt_sort_order`` is the
stable one, so the result is the same bit for bit) and the gradient rows
gathered into that order; with ``next_ids``, their stable argsort and the
sorted next ids. Nothing else: the first pass finds each CUDA block's slice
of the sorted ids (and next ids) itself, the block starts
``_block_starts_plain`` computes with searchsorted, and each tile's runs.
Unlike the TPU kernel, nothing is padded: each block searches its own slice
of the sorted ids, so it needs no chunk-aligned tail. The kernels write
each gathered row to its id's original position, so the JAX package's
un-sort of the gathered rows is not needed.

Precision: both ``precision`` values give an exact f32 scatter (a plain sum
of the run of equal ids, in the order above). The TPU's ``"fast"`` mode split
gradients into hi/lo bf16 halves for its one-hot MXU matmul; the card has no
reason to do that, so the argument is accepted for parity and changes nothing.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from anime_recommendations_tpu_torch.ops import _kernels

BLOCK_ROWS = 32  # table rows per CUDA block (kRows in csrc/fused_adam.cu)
TILE = 32        # sorted positions per tile (kTile in csrc/fused_adam.cu)
LONG_PARTS = 32  # a crossing run of more tile sums is chunked (kLongParts)
CHAIN = 8        # into at most this many chunks (kChain)
PRECISIONS = ("fast", "highest")
_MOMENT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_U32 = 0xFFFFFFFF


class AdamScalars(NamedTuple):
    """The update's scalars, each an exact f32 value held as a Python float:
    what the kernel receives by value and the plain version multiplies by."""

    lr: float
    bc1: float
    bc2: float
    eps: float
    l2: float
    b1: float
    b2: float


def adam_scalars(step: int, lr: float, l2: float, b1: float, b2: float,
                 eps: float) -> AdamScalars:
    """f32 scalars of Adam step ``step`` (the count after this update)."""
    f = np.float32
    t = f(step)
    return AdamScalars(
        lr=float(f(lr)), bc1=float(f(1) - f(b1) ** t), bc2=float(f(1) - f(b2) ** t),
        eps=float(f(eps)), l2=float(f(l2)), b1=float(f(b1)), b2=float(f(b2)),
    )


def _mix32(x):
    """Stateless 32-bit mixer of csrc/fused_adam.cu on Python ints or int64
    tensors holding uint32 values. Both multipliers are below 2^31, so the
    int64 products are exact."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _U32
    return x ^ (x >> 16)


def sr_random_bits(step: int, moment: int, n: int, d: int, device) -> torch.Tensor:
    """Random bits [n, d] (int64 holding uint32) for the stochastic rounding
    of moment ``moment`` (0 = mu, 1 = nu) at Adam step ``step``:
    mix32(mix32(mix32(2*step + moment) + row) + column), as in the kernel."""
    seed = _mix32((2 * step + moment) & _U32)
    rows = torch.arange(n, dtype=torch.int64, device=device)
    row_key = _mix32((rows + seed) & _U32)
    cols = torch.arange(d, dtype=torch.int64, device=device)
    return _mix32((row_key[:, None] + cols[None, :]) & _U32)


def stochastic_round_bf16(x: torch.Tensor, random_bits: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 by _sr_store's rule: add the low 16 random bits to the f32
    bits and truncate. The result is one of the two bf16 neighbours of x."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & _U32
    bits = (bits + (random_bits & 0xFFFF)) & 0xFFFF0000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return bits.view(torch.float32).to(torch.bfloat16)  # exact: low bits are 0


@torch.no_grad()
def sparse_adam_update(
    w: torch.Tensor,            # [N, D] f32 table, updated in place
    mu: torch.Tensor,           # [N, D] f32 or bf16 first moment, in place
    nu: torch.Tensor,           # [N, D] second moment, mu's dtype, in place
    ids: torch.Tensor,          # [B] int row id per batch example (unsorted)
    g_rows: torch.Tensor,       # [B, D] f32 gradient w.r.t. the gathered rows
    step: int,                  # Adam step count AFTER this update (t >= 1)
    lr: float,
    l2: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-7,
    precision: str = "fast",
    stochastic_rounding: bool | None = None,
    next_ids: torch.Tensor | None = None,
    dense_grad: torch.Tensor | None = None,
    order: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """One fused sparse-Adam step (module docstring). Returns (w, mu, nu,
    sumsq of w before the update), the first three being the inputs, updated;
    with ``next_ids`` ([B2] int) also rows = w'[next_ids], [B2, D] f32.

    ``stochastic_rounding``: None rounds bf16 moments stochastically, False
    to nearest; f32 moments are stored as they are. ``step`` and ``lr`` are
    host numbers: the scalars go to the kernel by value, with no device sync.
    ``dense_grad`` ([N, D] f32) is added to the scattered sums; ``order`` ([B]
    int) replaces the argsort of ``ids`` (module docstring).
    """
    if dense_grad is not None and next_ids is not None:
        raise NotImplementedError("dense_grad with next_ids: an unused combination, "
                                  "unsupported as in the JAX package")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if w.dim() != 2 or w.dtype != torch.float32:
        raise TypeError(f"sparse_adam_update: w must be [N, D] f32, got {w.dtype} {tuple(w.shape)}")
    if mu.shape != w.shape or nu.shape != w.shape:
        raise ValueError("sparse_adam_update: mu and nu must have w's shape")
    if mu.dtype != nu.dtype or mu.dtype not in _MOMENT_CODES:
        raise TypeError(f"sparse_adam_update: mu and nu must both be f32 or bf16, "
                        f"got {mu.dtype} and {nu.dtype}")
    if ids.dim() != 1 or g_rows.shape != (ids.shape[0], w.shape[1]):
        raise ValueError(f"sparse_adam_update: ids [B] and g_rows [B, D] expected, got "
                         f"{tuple(ids.shape)} and {tuple(g_rows.shape)}")
    if ids.is_floating_point() or ids.is_complex():
        raise TypeError(f"sparse_adam_update: ids must be integers, got {ids.dtype}")
    if step < 1:
        raise ValueError(f"sparse_adam_update: step must be >= 1, got {step}")
    if next_ids is not None and (next_ids.dim() != 1 or next_ids.is_floating_point()
                                 or next_ids.is_complex()):
        raise TypeError(f"sparse_adam_update: next_ids must be [B2] integers, got "
                        f"{next_ids.dtype} {tuple(next_ids.shape)}")
    if dense_grad is not None and (dense_grad.shape != w.shape
                                   or dense_grad.dtype != torch.float32):
        raise ValueError(f"sparse_adam_update: dense_grad must be [N, D] f32 like w, got "
                         f"{dense_grad.dtype} {tuple(dense_grad.shape)}")
    if order is not None and (order.shape != ids.shape or order.is_floating_point()
                              or order.is_complex()):
        raise ValueError(f"sparse_adam_update: order must be [B] integers, got "
                         f"{order.dtype} {tuple(order.shape)}")
    operands = (("mu", mu), ("nu", nu), ("ids", ids), ("g_rows", g_rows), ("next_ids", next_ids),
                ("dense_grad", dense_grad), ("order", order))
    for name, t in operands:
        if t is not None and t.device != w.device:
            raise ValueError(f"sparse_adam_update: {name} is on {t.device}, w on {w.device}")
    sr = mu.dtype == torch.bfloat16 and stochastic_rounding is not False
    if order is None:
        order = torch.argsort(ids, stable=True)
    ids_s = ids[order].to(torch.int32)
    g_s = g_rows[order].float()
    scal = adam_scalars(int(step), float(lr), float(l2), b1, b2, eps)
    if w.device.type == "cpu":
        out = _sparse_adam_update_plain(w, mu, nu, ids_s, g_s, scal, int(step), sr, dense_grad)
        return out if next_ids is None else out + (_gather_rows_plain(w, next_ids),)
    if w.device.type != "cuda":
        raise ValueError(f"sparse_adam_update: unsupported device {w.device}")
    gather = None
    if next_ids is not None:
        norder = torch.argsort(next_ids, stable=True)
        gather = (next_ids[norder].to(torch.int32), norder.to(torch.int32))
    return _sparse_adam_update_cuda(w, mu, nu, ids_s, g_s, scal, int(step), sr, gather,
                                    dense=dense_grad)


def _sparse_adam_update_plain(w, mu, nu, ids_s, g_s, scal: AdamScalars, step: int,
                              sr: bool, dense=None):
    """The update in plain torch ops, in place, from the sorted ids and
    gradients (and ``dense``, an [N, D] gradient added to the scattered
    sums): the reference for the kernel (same operations, same order, same
    stochastic-rounding bits)."""
    n, d = w.shape
    dev = w.device
    keep = (ids_s >= 0) & (ids_s < n)
    dscat = torch.zeros_like(w).index_add_(0, ids_s[keep].long(), g_s[keep])
    if dense is not None:
        dscat = dscat + dense
    sumsq = torch.sum(torch.square(w))
    f = np.float32
    two_l2 = float(f(2) * f(scal.l2))
    omb1, omb2 = float(f(1) - f(scal.b1)), float(f(1) - f(scal.b2))
    # Division by 0-dim tensors on the device, not Python floats: CUDA torch
    # turns a scalar divisor into a reciprocal multiply, the kernel divides.
    bc1 = torch.tensor(scal.bc1, dtype=torch.float32, device=dev)
    bc2 = torch.tensor(scal.bc2, dtype=torch.float32, device=dev)
    g = dscat + w * two_l2
    mu_new = mu.float() * scal.b1 + g * omb1
    nu_new = nu.float() * scal.b2 + (g * g) * omb2
    upd = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + scal.eps)
    w.copy_(w - upd * scal.lr)
    for moment, (dst, new) in enumerate(((mu, mu_new), (nu, nu_new))):
        if sr:
            new = stochastic_round_bf16(new, sr_random_bits(step, moment, n, d, dev))
        dst.copy_(new)  # f32 as is; bf16 without SR rounds to nearest even
    return w, mu, nu, sumsq


def _gather_rows_plain(w: torch.Tensor, next_ids: torch.Tensor) -> torch.Tensor:
    """K5's gather in plain torch ops: w[next_ids] as a new [B2, D] tensor,
    with zero rows for ids outside [0, n)."""
    keep = (next_ids >= 0) & (next_ids < w.shape[0])
    rows = torch.zeros(next_ids.shape[0], w.shape[1], dtype=w.dtype, device=w.device)
    rows[keep] = w[next_ids[keep].long()]
    return rows


def _tile_runs(ids_s: torch.Tensor):
    """Per tile of TILE positions of the sorted ids [B > 0]: its first and
    last id, whether its first run began in an earlier tile (left) and
    whether its last run goes on into a later one (right)."""
    b = ids_s.shape[0]
    p0 = torch.arange(0, b, TILE, device=ids_s.device)
    p1 = torch.clamp_max(p0 + TILE, b)
    first, last = ids_s[p0], ids_s[p1 - 1]
    left = (p0 > 0) & (ids_s[torch.clamp_min(p0 - 1, 0)] == first)
    right = (p1 < b) & (ids_s[torch.clamp_max(p1, b - 1)] == last)
    return first, last, left, right


def _tile_sums_plain(ids_s: torch.Tensor, g_s: torch.Tensor, n: int):
    """The first pass (fused_adam_tiles) in torch ops: (sums [2 * tiles, D],
    written [2 * tiles] bool). Slot 2t holds the sum of tile t's first run's
    segment when that run (of an id in [0, n)) began in an earlier tile, slot
    2t + 1 its last run's when that one goes on into a later tile and is not
    the first run; each summed from 0 in position order. Slots not written
    hold 0 here and anything in the kernel's output."""
    b, d = g_s.shape
    if b == 0:
        return g_s.new_zeros(0, d), torch.zeros(0, dtype=torch.bool, device=g_s.device)
    first, last, left, right = _tile_runs(ids_s)
    left = left & (first >= 0) & (first < n)
    tail = right & (last >= 0) & (last < n) & ~(left & (first == last))
    tiles = first.shape[0]
    pad = tiles * TILE - b
    ids_t = torch.nn.functional.pad(ids_s, (0, pad)).view(tiles, TILE)
    valid = (torch.arange(tiles * TILE, device=g_s.device) < b).view(tiles, TILE)
    g_t = torch.nn.functional.pad(g_s.float(), (0, 0, 0, pad)).view(tiles, TILE, d)
    in_first = valid & (ids_t == first[:, None]) & left[:, None]
    in_last = valid & (ids_t == last[:, None]) & tail[:, None]
    acc_first = g_s.new_zeros(tiles, d, dtype=torch.float32)
    acc_last = torch.zeros_like(acc_first)
    for k in range(TILE):
        acc_first = torch.where(in_first[:, k, None], acc_first + g_t[:, k], acc_first)
        acc_last = torch.where(in_last[:, k, None], acc_last + g_t[:, k], acc_last)
    return (torch.stack([acc_first, acc_last], 1).reshape(2 * tiles, d),
            torch.stack([left, tail], 1).reshape(2 * tiles))


def run_sums_in_tile_order(ids_s: torch.Tensor, g_s: torch.Tensor, n: int) -> torch.Tensor:
    """dscat [n, D] in the kernel's order (module docstring): a run inside
    one tile summed from 0 in position order; a run crossing tile edges from
    its parts, the sums of its segments in tile order (part 0 its first
    tile's last-run sum, the others the next tiles' first-run sums), added
    from 0 in order, or, past LONG_PARTS parts, cut into at most CHAIN
    chunks of ceil(parts / CHAIN) parts, each summed from 0 in order, and
    the chunk sums added from 0 in order. Fed to
    _sparse_adam_update_plain as one gradient row per table row, it gives
    the kernel's tables bit for bit."""
    b, d = g_s.shape
    out = g_s.new_zeros(n, d, dtype=torch.float32)
    keep = (ids_s >= 0) & (ids_s < n)
    if not bool(keep.any()):
        return out
    dev = g_s.device
    rows, counts = torch.unique_consecutive(ids_s[keep], return_counts=True)
    lo = int(torch.nonzero(keep)[0]) + torch.cumsum(counts, 0) - counts
    hi = lo + counts
    t0, t1 = lo // TILE, (hi - 1) // TILE
    one = t0 == t1
    g = g_s.float()
    acc = torch.zeros(int(one.sum()), d, dtype=torch.float32, device=dev)
    lo1, len1 = lo[one], counts[one]
    for k in range(TILE):
        take = (k < len1)[:, None]
        acc = torch.where(take, acc + g[torch.clamp_max(lo1 + k, b - 1)], acc)
    out[rows[one].long()] = acc
    if bool((~one).any()):
        sums, _ = _tile_sums_plain(ids_s, g_s, n)
        s0 = t0[~one]
        parts = t1[~one] - s0 + 1
        q = torch.where(parts > LONG_PARTS, -(-parts // CHAIN), 1)
        slot = lambda i: torch.where(i == 0, 2 * s0 + 1, 2 * (s0 + i)).clamp_max(
            sums.shape[0] - 1)
        acc = torch.zeros(s0.shape[0], d, dtype=torch.float32, device=dev)
        chunks = -(-parts // q)
        for c in range(int(chunks.max())):
            chunk = torch.zeros_like(acc)
            for k in range(int(q.max())):
                i = c * q + k
                take = ((k < q) & (i < parts))[:, None]
                chunk = torch.where(take, chunk + sums[slot(i)], chunk)
            acc = torch.where((c * q < parts)[:, None], acc + chunk, acc)
        out[rows[~one].long()] = acc
    return out


def _copies_plain(w: torch.Tensor, nids_s: torch.Tensor, norder: torch.Tensor,
                  rows_out: torch.Tensor) -> torch.Tensor:
    """The gather's second pass (fused_adam_copies) in torch ops, into
    rows_out: rows_out[norder[j]] = w[nids_s[j]] for the positions j of runs
    of equal sorted next ids that cross a tile edge, 0 for ids outside
    [0, n); no other row is written."""
    n = w.shape[0]
    if nids_s.shape[0] == 0:
        return rows_out
    first, last, left, right = _tile_runs(nids_s)
    tile = torch.arange(nids_s.shape[0], device=w.device) // TILE
    outside = (nids_s < 0) | (nids_s >= n)
    crossing = (left[tile] & (nids_s == first[tile])) | (right[tile] & (nids_s == last[tile]))
    sel = outside | crossing
    ids = nids_s[sel].long()
    inside = ~outside[sel]
    rows = torch.zeros(ids.shape[0], w.shape[1], dtype=w.dtype, device=w.device)
    rows[inside] = w[ids[inside]]
    rows_out[norder[sel].long()] = rows
    return rows_out


def _check_cuda_operand(name: str, t: torch.Tensor, align: int) -> None:
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"fused_adam: {name} must be contiguous and {align}-byte aligned")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _block_starts_plain(ids_s: torch.Tensor, n: int) -> torch.Tensor:
    """Where each CUDA block's rows [k * BLOCK_ROWS, min((k + 1) * BLOCK_ROWS,
    n)) begin in the sorted ids, k = 0 .. ceil(n / BLOCK_ROWS): the first
    pass's ``starts`` in torch ops (int32 [nb + 1])."""
    nb = -(-n // BLOCK_ROWS)
    bounds = torch.clamp_max(
        torch.arange(nb + 1, dtype=ids_s.dtype, device=ids_s.device) * BLOCK_ROWS, n)
    return torch.searchsorted(ids_s, bounds, out_int32=True)


def _first_pass_cuda(ids_s, g_s, n: int, nids_s=None, lib=None):
    """Launch csrc/fused_adam.cu's first pass (``fused_adam_tiles``) over the
    sorted int32 ids and their f32 gradient rows (and the sorted int32 next
    ids): (tile_sums [2 * tiles, D], whose slots _tile_sums_plain marks
    written, the others holding anything, or None for an empty batch;
    starts and, with next ids, gstarts, each _block_starts_plain's)."""
    b, d = g_s.shape
    for name, t in (("ids", ids_s), ("next ids", nids_s)):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous()):
            raise ValueError(f"fused_adam_tiles: {name} must be contiguous int32")
    _check_cuda_operand("g_rows", g_s, 16)
    dev = g_s.device
    tile_sums = torch.empty(2 * -(-b // TILE), d, dtype=torch.float32, device=dev) if b else None
    starts = torch.empty(-(-n // BLOCK_ROWS) + 1, dtype=torch.int32, device=dev)
    gstarts = None if nids_s is None else torch.empty_like(starts)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = lib or _kernels.library("fused_adam")
    _kernels.check(lib.fused_adam_tiles(
        ptr(ids_s) if b else None, ptr(g_s) if b else None, b, ptr(nids_s),
        0 if nids_s is None else nids_s.shape[0], ptr(tile_sums), ptr(starts), ptr(gstarts),
        n, d, BLOCK_ROWS, TILE, _stream(g_s)), "fused_adam_tiles")
    _kernels.count_launch("fused_adam_tiles")
    return tile_sums, starts, gstarts


def _copies_cuda(w, nids_s, norder, rows_out, lib=None) -> None:
    """Launch csrc/fused_adam.cu's ``fused_adam_copies`` into rows_out
    (_copies_plain's rows); a next batch of none launches nothing."""
    n_next = nids_s.shape[0]
    if n_next == 0:
        return
    for name, t in (("next ids", nids_s), ("next order", norder)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"fused_adam_copies: {name} must be contiguous int32")
    _check_cuda_operand("rows", rows_out, 16)
    lib = lib or _kernels.library("fused_adam")
    _kernels.check(lib.fused_adam_copies(w.data_ptr(), nids_s.data_ptr(), norder.data_ptr(),
                                         rows_out.data_ptr(), n_next, w.shape[0], w.shape[1],
                                         TILE, _stream(w)), "fused_adam_copies")
    _kernels.count_launch("fused_adam_copies")


def _sparse_adam_update_cuda(w, mu, nu, ids_s, g_s, scal: AdamScalars, step: int,
                             sr: bool, gather=None, dense=None, lib=None):
    """Launch csrc/fused_adam.cu (or ``lib``, a library of another version of
    it) on PyTorch's current stream: the first pass (which also finds each
    block's slice of the sorted ids, and of the next ids), then ``fused_adam``
    (with ``dense``, an [N, D] f32 gradient, its dense kernel), or with
    ``gather`` = (sorted next ids, their original positions), both int32,
    ``fused_adam_gather`` and its second pass, whose gathered rows come last
    in the result."""
    n, d = w.shape
    if d % 4:
        raise ValueError(f"fused_adam: needs D % 4 == 0, got D={d}")
    if n >= 2**31 - BLOCK_ROWS or ids_s.shape[0] >= 2**31 - TILE:
        raise ValueError("fused_adam: table rows and batch must fit int32")
    g_s = g_s.contiguous()
    _check_cuda_operand("w", w, 16)
    _check_cuda_operand("mu", mu, 16 if mu.dtype == torch.float32 else 8)
    _check_cuda_operand("nu", nu, 16 if nu.dtype == torch.float32 else 8)
    _check_cuda_operand("g_rows", g_s, 16)
    if dense is not None:
        if gather is not None:
            raise ValueError("fused_adam_gather takes no dense gradient")
        _check_cuda_operand("dense_grad", dense, 16)
    if gather is not None and gather[0].shape[0] >= 2**31 - TILE:
        raise ValueError("fused_adam_gather: the next batch must fit int32")
    partials = torch.empty(-(-n // BLOCK_ROWS), dtype=torch.float32, device=w.device)
    lib = lib or _kernels.library("fused_adam")
    tile_sums, starts, gstarts = _first_pass_cuda(
        ids_s, g_s, n, None if gather is None else gather[0], lib)
    head = (w.data_ptr(), mu.data_ptr(), nu.data_ptr(), _MOMENT_CODES[mu.dtype],
            ids_s.data_ptr(), g_s.data_ptr())
    mid = (starts.data_ptr(), None if tile_sums is None else tile_sums.data_ptr(),
           partials.data_ptr())
    tail = (n, d, BLOCK_ROWS, TILE, *scal, int(sr), step & 0xFFFFFFFF, _stream(w))
    if gather is None:
        name, rows = ("fused_adam", ()) if dense is None else ("fused_adam_dense", ())
        err = lib.fused_adam(*head, None if dense is None else dense.data_ptr(), *mid, *tail)
        _kernels.check(err, name)
        _kernels.count_launch(name)
    else:
        nids_s, norder = gather
        out = torch.empty(nids_s.shape[0], d, dtype=torch.float32, device=w.device)
        rows = (out,)
        err = lib.fused_adam_gather(*head, *mid, nids_s.data_ptr(), norder.data_ptr(),
                                    gstarts.data_ptr(), out.data_ptr(), nids_s.shape[0], *tail)
        _kernels.check(err, "fused_adam_gather")
        _kernels.count_launch("fused_adam_gather")
        _copies_cuda(w, nids_s, norder, out, lib)
    return (w, mu, nu, torch.sum(partials)) + rows
