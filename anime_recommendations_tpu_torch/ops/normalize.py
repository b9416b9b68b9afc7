"""L2 row normalization of an embedding table.

Counterpart of anime_recommendations_tpu/ops/normalize.py (K4,
``_normalize_kernel``): every row becomes x * rsqrt(max(sum(x^2), eps)),
computed in f32. ``out_dtype`` fuses the cast the table build does anyway
(f32 rows stored as bf16 for a bf16 context); with ``out_dtype`` equal to the
input's dtype this is the JAX kernel's function.

On a CUDA tensor this launches csrc/l2_normalize.cu; on a CPU tensor it runs
``_l2_normalize_rows_plain``, the same function in torch ops.
"""

from __future__ import annotations

import ctypes

import torch

from anime_recommendations_tpu_torch.ops import _kernels

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


@torch.no_grad()
def l2_normalize_rows(table: torch.Tensor, eps: float = 1e-24,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Rowwise x / ||x||_2 of an [N, D] table, with the norm clamped below
    by sqrt(eps) so a zero row stays zero. Returns a new [N, D] tensor of
    ``out_dtype`` (default: the input's dtype)."""
    out_dtype = table.dtype if out_dtype is None else out_dtype
    if table.device.type == "cpu":
        return _l2_normalize_rows_plain(table, eps, out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"l2_normalize_rows: unsupported device {table.device}")
    return _l2_normalize_rows_cuda(table, eps, out_dtype)


def _l2_normalize_rows_plain(table, eps, out_dtype):
    """The normalization in torch ops, all in f32."""
    x = table.float()
    sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(torch.clamp_min(sq, eps))).to(out_dtype)


def _l2_normalize_rows_cuda(table, eps, out_dtype):
    """Launch csrc/l2_normalize.cu on PyTorch's current stream."""
    if table.dtype != torch.float32:
        raise TypeError(f"l2_normalize takes an f32 table, got {table.dtype}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"l2_normalize writes f32 or bf16, not {out_dtype}")
    if table.dim() != 2:
        raise ValueError(f"l2_normalize: table must be [N, D], got {tuple(table.shape)}")
    n, d = table.shape
    if d % 4 or d == 0 or not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError(f"l2_normalize: needs a contiguous, 16-byte aligned table "
                         f"with D % 4 == 0; got D={d}")
    out = torch.empty((n, d), dtype=out_dtype, device=table.device)
    if n == 0:
        return out
    err = _kernels.library("l2_normalize").l2_normalize(
        table.data_ptr(), out.data_ptr(), _OUT_CODES[out_dtype], n, d, eps,
        ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream),
    )
    _kernels.check(err, "l2_normalize")
    _kernels.count_launch("l2_normalize")
    return out
