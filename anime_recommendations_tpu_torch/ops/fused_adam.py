"""Fused sparse-gradient scatter + L2 decay + Adam update of one table.

Counterpart of anime_recommendations_tpu/ops/fused_adam.py::sparse_adam_update
(K1, ``_fused_adam_kernel`` with its stochastic rounding ``_sr_store``; with
``next_ids``, K5, ``_fused_adam_gather_kernel``). One call does, in one pass
over the table:

    dscat  = zeros_like(w).index_add(ids, g_rows)      # rows outside [0, n) dropped
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
ids of 128, and no table read: they are copied out of the block just updated.

On a CUDA tensor this launches csrc/fused_adam.cu (``fused_adam``, or
``fused_adam_gather`` with ``next_ids``); on a CPU tensor it runs
``_sparse_adam_update_plain`` (then ``_gather_rows_plain``), the same
function in torch ops. There is no fallback between them.

Host-side preparation, on the tensors' device: a stable argsort of the batch
ids, the gradient rows gathered into that order, and (for the kernel) the
block starts from ``searchsorted`` over bounds clamped to n. Unlike the TPU
kernel, nothing is padded: the kernel searches each block's own slice of the
sorted ids, so it needs no chunk-aligned tail. With ``next_ids``: their
stable argsort, the sorted next ids and, for the kernel, their block starts
over the same bounds; the kernel writes each row to its id's original
position, so the JAX package's un-sort of the gathered rows is not needed.

Precision: both ``precision`` values give an exact f32 scatter (a plain sum
of the run of equal ids, in sorted order). The TPU's ``"fast"`` mode split
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
    """
    if dense_grad is not None or order is not None:
        raise NotImplementedError(
            "dense_grad and order (the routed multi-chip path; dense_grad alone or "
            "with next_ids) are not ported yet: ROADMAP.md Queue 1 parallel/")
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
    operands = (("mu", mu), ("nu", nu), ("ids", ids), ("g_rows", g_rows), ("next_ids", next_ids))
    for name, t in operands:
        if t is not None and t.device != w.device:
            raise ValueError(f"sparse_adam_update: {name} is on {t.device}, w on {w.device}")
    sr = mu.dtype == torch.bfloat16 and stochastic_rounding is not False
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order].to(torch.int32)
    g_s = g_rows[order].float()
    scal = adam_scalars(int(step), float(lr), float(l2), b1, b2, eps)
    if w.device.type == "cpu":
        out = _sparse_adam_update_plain(w, mu, nu, ids_s, g_s, scal, int(step), sr)
        return out if next_ids is None else out + (_gather_rows_plain(w, next_ids),)
    if w.device.type != "cuda":
        raise ValueError(f"sparse_adam_update: unsupported device {w.device}")
    gather = None
    if next_ids is not None:
        norder = torch.argsort(next_ids, stable=True)
        gather = (next_ids[norder].to(torch.int32), norder.to(torch.int32))
    return _sparse_adam_update_cuda(w, mu, nu, ids_s, g_s, scal, int(step), sr, gather)


def _sparse_adam_update_plain(w, mu, nu, ids_s, g_s, scal: AdamScalars, step: int,
                              sr: bool):
    """The update in plain torch ops, in place, from the sorted ids and
    gradients: the reference for the kernel (same operations, same order,
    same stochastic-rounding bits)."""
    n, d = w.shape
    dev = w.device
    keep = (ids_s >= 0) & (ids_s < n)
    dscat = torch.zeros_like(w).index_add_(0, ids_s[keep].long(), g_s[keep])
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


def _check_cuda_operand(name: str, t: torch.Tensor, align: int) -> None:
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"fused_adam: {name} must be contiguous and {align}-byte aligned")


def _sparse_adam_update_cuda(w, mu, nu, ids_s, g_s, scal: AdamScalars, step: int,
                             sr: bool, gather=None):
    """Launch csrc/fused_adam.cu on PyTorch's current stream: ``fused_adam``,
    or with ``gather`` = (sorted next ids, their original positions), both
    int32, ``fused_adam_gather``, whose gathered rows come last in the
    result."""
    n, d = w.shape
    if d % 4:
        raise ValueError(f"fused_adam: needs D % 4 == 0, got D={d}")
    if n >= 2**31 - BLOCK_ROWS or ids_s.shape[0] >= 2**31:
        raise ValueError("fused_adam: table rows and batch must fit int32")
    g_s = g_s.contiguous()
    _check_cuda_operand("w", w, 16)
    _check_cuda_operand("mu", mu, 16 if mu.dtype == torch.float32 else 8)
    _check_cuda_operand("nu", nu, 16 if nu.dtype == torch.float32 else 8)
    _check_cuda_operand("g_rows", g_s, 16)
    nb = -(-n // BLOCK_ROWS)
    bounds = torch.clamp_max(
        torch.arange(nb + 1, dtype=torch.int32, device=w.device) * BLOCK_ROWS, n)
    starts = torch.searchsorted(ids_s, bounds, out_int32=True)
    partials = torch.empty(nb, dtype=torch.float32, device=w.device)
    lib = _kernels.library("fused_adam")
    head = (w.data_ptr(), mu.data_ptr(), nu.data_ptr(), _MOMENT_CODES[mu.dtype],
            ids_s.data_ptr(), g_s.data_ptr(), starts.data_ptr(), partials.data_ptr())
    tail = (n, d, BLOCK_ROWS, *scal, int(sr), step & 0xFFFFFFFF,
            ctypes.c_void_p(torch.cuda.current_stream(w.device).cuda_stream))
    if gather is None:
        name, rows = "fused_adam", ()
        err = lib.fused_adam(*head, *tail)
    else:
        nids_s, norder = gather
        if nids_s.shape[0] >= 2**31:
            raise ValueError("fused_adam_gather: the next batch must fit int32")
        gstarts = torch.searchsorted(nids_s, bounds, out_int32=True)
        out = torch.empty(nids_s.shape[0], d, dtype=torch.float32, device=w.device)
        name, rows = "fused_adam_gather", (out,)
        err = lib.fused_adam_gather(*head, nids_s.data_ptr(), norder.data_ptr(),
                                    gstarts.data_ptr(), out.data_ptr(), nids_s.shape[0], *tail)
    _kernels.check(err, name)
    _kernels.count_launch(name)
    return (w, mu, nu, torch.sum(partials)) + rows
