"""Dense Adam update of a list of f32 tensors, in place: one kernel launch.

No counterpart kernel in the JAX package, which leaves this update to
optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-7) with -lr applied outside,
and to XLA. For each parameter p with gradient g and moments mu, nu:

    mu' = mu*b1 + g*(1-b1)
    nu' = nu*b2 + g^2*(1-b2)
    p'  = p - (mu'/bc1) / (sqrt(nu'/bc2) + eps) * lr

with lr, bc1 = 1 - b1^step and bc2 = 1 - b2^step from the step's row
``scal`` (ops/fused_adam.scalar_rows: [4] f32 on the tensors' device, read
as 0-dim device tensors, never on the host), so nothing changes on the host
from step to step and a CUDA graph can capture the update.

On CUDA tensors ``dense_adam_`` launches csrc/dense_adam.cu once for the
whole list (at most MAX_TENSORS tensors; 0-dim ones included), counted as
``dense_adam`` in ops/_kernels.launches; on other tensors (the CPU's, or
the meta device's, on which the tests show that a step reads nothing on the
host) it runs ``_dense_adam_plain``, the same chain in torch ops, which the
kernel follows bit for bit. There is no fallback between them.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from anime_recommendations_tpu_torch.ops import _kernels

KERAS_ADAM_EPS = 1e-7
B1, B2 = 0.9, 0.999
MAX_TENSORS = 8  # kMaxTensors in csrc/dense_adam.cu


@torch.no_grad()
def dense_adam_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                scal: torch.Tensor, eps: float = KERAS_ADAM_EPS) -> None:
    """One dense Adam step (b1 = B1, b2 = B2) of each ``params[i]`` with
    ``grads[i]`` and its moments ``mus[i]``, ``nus[i]``, in place: p, mu and
    nu keep their storage. Every tensor f32, each quadruple of one shape, all
    on scal's device; ``scal`` the step's [4] f32 row."""
    n = len(params)
    if not 1 <= n <= MAX_TENSORS or not len(grads) == len(mus) == len(nus) == n:
        raise ValueError(f"dense_adam_: 1 to {MAX_TENSORS} tensors, each with a gradient and "
                         f"two moments, got {n}, {len(grads)}, {len(mus)}, {len(nus)}")
    if scal.shape != (4,) or scal.dtype != torch.float32:
        raise ValueError(f"dense_adam_: scal must be a [4] f32 row, got {scal.dtype} "
                         f"{tuple(scal.shape)}")
    for i, quad in enumerate(zip(params, grads, mus, nus)):
        for name, t in zip(("param", "grad", "mu", "nu"), quad):
            if t.dtype != torch.float32:
                raise TypeError(f"dense_adam_: {name} {i} must be f32, got {t.dtype}")
            if t.shape != quad[0].shape:
                raise ValueError(f"dense_adam_: {name} {i} has shape {tuple(t.shape)}, its "
                                 f"param {tuple(quad[0].shape)}")
            if t.device != scal.device:
                raise ValueError(f"dense_adam_: {name} {i} is on {t.device}, scal on "
                                 f"{scal.device}")
    if scal.device.type == "cuda":
        _dense_adam_cuda(params, grads, mus, nus, scal, eps)
    else:
        _dense_adam_plain(params, grads, mus, nus, scal, eps)


def _dense_adam_plain(params, grads, mus, nus, scal: torch.Tensor, eps: float) -> None:
    """The update in plain torch ops, in place: the reference for the kernel
    (same operations, same order). lr, bc1 and bc2 are 0-dim tensors read
    from the row (also as divisors: CUDA torch turns a Python-number divisor
    into a reciprocal multiply, the kernel divides)."""
    lr, bc1, bc2 = scal[0], scal[1], scal[2]
    for p, g, mu, nu in zip(params, grads, mus, nus):
        mu.mul_(B1).add_(g * (1 - B1))          # (1-b1)*g + b1*mu
        nu.mul_(B2).add_(torch.square(g) * (1 - B2))
        p.sub_((mu / bc1) / (torch.sqrt(nu / bc2) + eps) * lr)


def _dense_adam_cuda(params, grads, mus, nus, scal: torch.Tensor, eps: float) -> None:
    """Launch csrc/dense_adam.cu once for the whole list on PyTorch's current
    stream. The kernel takes 16-byte aligned tensors with float4 loads and
    any other one element by element."""
    named = [(f"{name} {i}", t) for i, quad in enumerate(zip(params, grads, mus, nus))
             for name, t in zip(("param", "grad", "mu", "nu"), quad)]
    for name, t in named + [("scal", scal)]:
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"dense_adam_: {name} must be contiguous and 4-byte aligned")
    n = len(params)
    ptrs = lambda ts: (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
    numel = (ctypes.c_longlong * n)(*(p.numel() for p in params))
    _kernels.check(_kernels.library("dense_adam").dense_adam(
        ptrs(params), ptrs(grads), ptrs(mus), ptrs(nus), numel, n, scal.data_ptr(),
        B1, 1 - B1, B2, 1 - B2, eps,
        ctypes.c_void_p(torch.cuda.current_stream(scal.device).cuda_stream)), "dense_adam")
    _kernels.count_launch("dense_adam")
