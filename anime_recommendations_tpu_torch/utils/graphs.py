"""CUDA graphs: one captured body, replayed as one launch.

The counterpart of a jitted JAX program on the card. Three paths capture
through it: the device-resident epochs (train/device_loop.py,
parallel/sharded_train.py), one graph per epoch, the retrieval scans
(ops/scan_graph.py), one graph per request signature, and the training and
evaluation steps (train/step_graph.py), one graph per step signature. Each
keeps its own cache of graphs, least recently used first out (``lru_get``),
keyed by everything the graph reads outside its own buffers and memory pool
(``layout``): a hit replays on the same memory.
"""

from __future__ import annotations

import functools
import time
from collections import OrderedDict

import numpy as np
import torch

from anime_recommendations_tpu_torch.ops import _kernels
from anime_recommendations_tpu_torch.ops.fused_adam import upload


class CapturedGraph:
    """One captured body: the CUDA graph, the static buffers it reads
    (written before each replay), the outputs it writes, and the kernel
    launches of the port's wrappers it makes per replay.

    Before the capture, ``warm_up`` runs the body (or a short part of it)
    eagerly on a side stream, on what it may write a copy of (lazy
    initializations: the kernels' libraries, cuBLAS's workspace, the
    autograd threads, the allocator); its launches go to
    _kernels.warmup_launches, not to _kernels.launches. Then ``fn`` is
    captured on the same stream in thread-local mode (other threads' CUDA
    calls do not break it), with the wrappers' launch counts recorded
    (_kernels.recording) and added to _kernels.launches at every replay. A
    capture that fails raises; nothing falls back to the eager body.
    ``seconds`` holds the host time of the warm-up (to its end on the card),
    of the capture (the body traced into the graph) and of the
    instantiation, ``replays`` the replays so far, ``pool_bytes`` the memory
    the capture reserved (the graph's pool: segments of its own, held until
    the graph is freed; ``pool``, a torch.cuda.graph_pool_handle(), shares
    one pool between the graphs captured into it, and pool_bytes is then
    what this capture added to it)."""

    def __init__(self, fn, warm_up, buffers: dict[str, torch.Tensor], device: torch.device,
                 pool=None):
        stream = side_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream), _kernels.recording() as warm:
            warm_up()
        torch.cuda.synchronize(device)
        _kernels.warmup_launches.update(warm)
        self.graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(device)
        t1 = time.perf_counter()
        # torch.cuda.graph's steps without its empty_cache, which would make
        # every later allocation of the process (a serving request's too)
        # call cudaMalloc again: the capture's memory is a pool of its own.
        with _kernels.recording() as launched, torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.outputs = fn()
                t2 = time.perf_counter()
            finally:
                self.graph.capture_end()
        self.seconds = {"warm_up": t1 - t0, "capture": t2 - t1,
                        "instantiate": time.perf_counter() - t2}
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = launched
        self.buffers = buffers
        self.replays = 0

    def replay(self, host: dict, clone: bool = True):
        """Copy each array of ``host`` into its buffer (asynchronously: a
        host array through pinned memory, a device tensor on the device),
        replay the graph on the current stream and return copies of its
        outputs (with ``clone=False`` the outputs themselves, which the next
        replay overwrites: for a graph whose outputs another graph reads)."""
        for name, value in host.items():
            src = torch.from_numpy(value) if isinstance(value, np.ndarray) else value
            buf = self.buffers[name]
            if buf.is_cuda and src.device.type == "cpu":
                src = src.pin_memory()
            buf.copy_(src, non_blocking=buf.is_cuda)
        self.graph.replay()
        self.replays += 1
        _kernels.count_replay(self.launches)
        return tuple(t.clone() for t in self.outputs) if clone else self.outputs


def lru_get(cache: OrderedDict, key, build, capacity: int):
    """The entry of ``key`` in ``cache``, made by ``build()`` on a miss and
    moved to the most recent end; past ``capacity`` entries the least
    recently used go (and a graph's memory pool with it)."""
    entry = cache.pop(key, None) or build()
    cache[key] = entry
    while len(cache) > capacity:
        cache.popitem(last=False)
    return entry


@functools.cache
def side_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


def layout(tensors) -> tuple:
    """What a graph key holds of the tensors a graph reads in place: their
    address, shape, strides, dtype and whether they require grad."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.requires_grad)
                 for t in tensors)


def device_tensor(x, device: torch.device) -> torch.Tensor:
    """``x``, a tensor or a numpy array, on ``device``: a host array goes to
    a card through pinned memory, without waiting for the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return upload(np.ascontiguousarray(x), device)
