"""Builds and loads the port's hand-written CUDA kernels.

Each kernel is a ``csrc/<name>.cu`` file with a plain C interface. At first
use it is compiled with nvcc for Hopper (``sm_90a``) into a shared library
under ``build/kernels/`` at the repository root, named with a hash of its
source, the ``csrc/*.cuh`` headers and the flags so an edited source is
rebuilt, and loaded with ctypes.
Nothing is built or loaded at import time: the CPU tests import every
module on machines that have no nvcc.

``launches`` counts kernel launches by name. Each wrapper adds one where it
launches its kernel, so a run can show that its main path went through the
kernels (chip_smoke.py resets and reads it). A CUDA graph runs the wrappers
once, while it is captured, and launches their kernels at every replay:
``recording`` takes the counts of a capture (or of a warm-up before one)
aside, and ``count_replay`` adds a graph's counts to ``launches`` each time
it is replayed (train/device_loop.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: name -> argtypes (every function returns a cudaError_t int).
SIGNATURES = {
    # table, dtype, queries, mask, exclude, head, out, n, d, nq, top_r, stream
    "packed_topk": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # table, wscale, queries, qscale, mask, exclude, head, out, n, d, nq,
    # top_r, stream
    "packed_topk_int8": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # n, nq -> the query tile packed_topk_int8 takes (1, 16 or 64)
    "packed_topk_int8_query_tile": (_I, _I),
    # table, dtype, queries, mask, exclude, head, out_s, out_i, n, d, nq, kc,
    # stream
    "exact_topk": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # n, nq -> the query tile exact_topk takes (1, 8 or 32)
    "exact_topk_query_tile": (_I, _I),
    # table, out, out_dtype, n, d, eps, stream
    "l2_normalize": (_P, _P, _I, _I, _I, _F, _P),
    # ids, grads, b, nids, n_next, tile_sums, starts, gstarts, n, d,
    # block_rows, tile, stream
    "fused_adam_tiles": (_P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    # w, mu, nu, moment_dtype, ids, grads, dense, starts, tile_sums, partials,
    # n, d, block_rows, tile, row (device: lr, bc1, bc2, step), eps, l2, b1,
    # b2, sr, stream
    "fused_adam": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                   _P, _F, _F, _F, _F, _I, _P),
    # w, mu, nu, moment_dtype, ids, grads, starts, tile_sums, partials, nids,
    # norder, gstarts, rows_out, n_next, n, d, block_rows, tile, row, eps, l2,
    # b1, b2, sr, stream
    "fused_adam_gather": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _P, _F, _F, _F, _F, _I, _P),
    # w, nids, norder, rows_out, n_next, n, d, tile, stream
    "fused_adam_copies": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # p, g, mu, nu (host arrays of device pointers), numel (host int64
    # array), count, row (device: lr, bc1, bc2, step), b1, 1 - b1, b2,
    # 1 - b2, eps, stream
    "dense_adam": (_P, _P, _P, _P, _P, _I, _P, _F, _F, _F, _F, _F, _P),
    # w, mu, nu, g (host arrays of device pointers), rows, batch (host int32
    # arrays), count, d, sorted keys, order, keep (or null), partial, flags,
    # n_chunks, row (device: lr, bc1, bc2, step), b1, 1 - b1, b2, 1 - b2, eps,
    # 2 * l2, stream
    "lazy_adam": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _F, _F, _F, _F,
                  _F, _F, _P),
}
# Entry points defined in another source than csrc/<name>.cu.
ENTRY_SOURCE = {"fused_adam_tiles": "fused_adam", "fused_adam_gather": "fused_adam",
                "fused_adam_copies": "fused_adam", "exact_topk_query_tile": "exact_topk",
                "packed_topk_int8_query_tile": "packed_topk_int8"}
# The sources to build: csrc/<source>.cu for each.
SOURCES = tuple(dict.fromkeys(ENTRY_SOURCE.get(name, name) for name in SIGNATURES))

launches: Counter = Counter()
# Launches of the warm-up steps that run, on a copy of the state, before a
# graph is captured: real launches, but of no path's steps.
warmup_launches: Counter = Counter()
_launches_lock = threading.Lock()  # the HTTP server launches from many threads
_recorder: Counter | None = None


def count_launch(name: str) -> None:
    with _launches_lock:
        (launches if _recorder is None else _recorder)[name] += 1


@contextlib.contextmanager
def recording():
    """Count the launches made inside the context into a new Counter (the
    one yielded) instead of ``launches``. Process-wide: a capture runs while
    no other thread launches kernels."""
    global _recorder
    counts = Counter()
    with _launches_lock:
        outer, _recorder = _recorder, counts
    try:
        yield counts
    finally:
        with _launches_lock:
            _recorder = outer


def count_replay(counts: Counter) -> None:
    """Add a captured graph's launches to ``launches``: one replay."""
    with _launches_lock:
        launches.update(counts)


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, else the one on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            f"{CSRC} at first use"
        )
    return found


def build(name: str, csrc: Path = CSRC) -> Path:
    """Compile ``<csrc>/<name>.cu`` unless this exact source is already built
    (``csrc``: another version of the sources, for tools that compare)."""
    src = csrc / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


@functools.cache
def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu``, built on first call, with
    the C signatures of its entry points set."""
    return load(build(source), source)


def load(path: Path, source: str) -> ctypes.CDLL:
    """Load a library built from ``<source>.cu`` and set the C signatures of
    its entry points."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if ENTRY_SOURCE.get(name, name) == source and hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")
