"""One retrieval request as one CUDA graph replay.

Counterpart of the JAX package's jitted ``_dispatch_topk`` (and of its
jitted ``quantized_topk`` and ``ivf_topk``): there a request's shuffle
translation, scan, rescore and unpermute compile into one program, traced
once per signature. Here a request on a CUDA table is split
(ops/topk.stage_request) into a host half (checks, the policy's depths and
pools, masks and exclusions from numpy) and a body that reads only device
tensors (ops/topk.scan_body). A ScanGraphs cache captures the body once per
signature (ScanRequest.key: the table's tensors by address, its flavour, Q,
k, which of mask, exclude and head are given, exact_scan, top_r, m,
probes) and then serves the signature as one replay: the request's inputs
are copied into the graph's static buffers, the graph replays, and the
caller gets its own copies of the outputs.

Policy, per cache: a signature's first call runs the body eagerly (the same
kernels), its second captures it (utils/graphs.CapturedGraph: a warm-up on
a side stream, then the capture), every later call replays it. So a
signature seen once pays no capture (model_recs_batch asks for k = n_recs +
the most any of its users watched, rounded up to one of four sizes an
octave, so a few signatures serve every batch). At most ``capacity`` graphs
are kept, least recently used first out; ``capacity=0`` keeps none and runs
every call eagerly (the plain version the card compares against: EAGER). A
RecContext owns one cache for its tables (RecContext.scan_graphs, freed
with it or by release_graphs()); callers that pass no cache share DEFAULT.

Memory: the graphs of one cache capture into one shared memory pool, so
that a capture reuses what the captures before it freed (their
intermediates: a scan's stage-1 keys are Q x 4 bytes x 3-6 keys a 512-row
group, 0.3-0.4 GB at Q = 256 over 50M rows) and the cache holds about one
scan's intermediates, not one per graph. That is safe because every call
copies its inputs in, replays and clones the outputs under the lock below:
no graph's buffers are read across another's replay (the step graphs,
train/step_graph.py, read and write their state in place, outside the
pool, and clone their outputs too).

Work: each replay adds its scan's work (ops/topk.scan_work: queries, table
rows, bytes read, operations) to the cache's counters (``scan_report()``),
the work of the kernels its replays ran.

Threads (the HTTP server answers on many): every scan on a card runs under
one process-wide lock, from the first copy into a graph's buffers to the
copies of its outputs, so two requests never interleave on one graph's
buffers; the eager body and the capture run under it too, so a capture's
recorded launch counts (ops/_kernels.recording, process-wide) hold its own
launches only, and two captures never share the side stream. Requests are
served on the caller's current stream (PyTorch's default stream, the same
for every thread), so a replay's copies are ordered after the previous
request's. The host staging before the lock and the caller's reads after it
run concurrently. A capture or replay that fails raises: no path drops to
the eager body on the card to hide it. The training and evaluation steps'
cache (train/step_graph.StepGraphs) is a ScanGraphs with its own capacity,
under the same lock.

Spans (utils/profiling.span, recorded while the recorder is on):
``scan.lock_wait``, the wait for the lock, then one of ``scan.replay``,
``scan.capture`` (the capture and its first replay) or ``scan.eager``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from anime_recommendations_tpu_torch.utils.graphs import CapturedGraph, device_tensor, lru_get
from anime_recommendations_tpu_torch.utils.profiling import span

SCAN_GRAPH_CACHE = 32   # graphs a cache keeps, most recently used
WORK_KEYS = ("calls", "queries", "rows", "bytes", "flops")   # scan_report()'s counters
_SEEN_PER_GRAPH = 4     # signatures seen once that a cache remembers, per graph it keeps

_LOCK = threading.RLock()


class ScanGraphs:
    """The captured scans of one owner, by signature (module docstring).

    ``hits`` counts the calls served by a replay, ``misses`` the others
    (first calls, run eagerly, and captures), ``captures`` the graphs
    captured, ``seconds`` their warm-up, capture and instantiation seconds
    summed."""

    def __init__(self, capacity: int = SCAN_GRAPH_CACHE):
        self.capacity = capacity
        self._pool = None       # the graphs' shared memory pool, made at the first capture
        self._graphs: OrderedDict[tuple, CapturedGraph] = OrderedDict()
        self._seen: OrderedDict[tuple, None] = OrderedDict()
        self.hits = self.misses = self.captures = 0
        self.seconds = {"warm_up": 0.0, "capture": 0.0, "instantiate": 0.0}
        self.work = dict.fromkeys(WORK_KEYS, 0)

    def run(self, key: tuple, body, inputs: dict, device: torch.device,
            warm_up=None, work: dict | None = None) -> tuple:
        """``body(**tensors)`` for the request ``inputs`` (name -> tensor,
        numpy array or None; host arrays are copied to ``device``): a
        replay of the graph of ``key``, a capture of it, or the eager body
        (module docstring). ``warm_up`` (default ``body``) takes the same
        tensors and runs before a capture: a body that writes what it reads
        warms up on a copy. ``work`` (ops/topk.scan_work's keys) is counted
        when a replay serves the call. Returns tensors the caller owns."""
        host = {name: v for name, v in inputs.items() if v is not None}
        with span("scan.lock_wait"):
            _LOCK.acquire()
        try:
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
                self.hits += 1
                if work is not None:
                    self.work["calls"] += 1
                    for name in WORK_KEYS[1:]:
                        self.work[name] += work[name]
                with span("scan.replay"):
                    return graph.replay(host)
            self.misses += 1
            if key in self._seen:   # the second call: capture
                del self._seen[key]
                with span("scan.capture"):
                    graph = lru_get(self._graphs, key,
                                    lambda: self._capture(body, inputs, device, warm_up or body),
                                    self.capacity)
                    return graph.replay(host)
            if self.capacity:
                self._seen[key] = None
                while len(self._seen) > _SEEN_PER_GRAPH * self.capacity:
                    self._seen.popitem(last=False)
            with span("scan.eager"):
                return body(**{name: None if v is None else device_tensor(v, device)
                               for name, v in inputs.items()})
        finally:
            _LOCK.release()

    def _capture(self, body, inputs: dict, device: torch.device, warm_up) -> CapturedGraph:
        """A graph of ``body`` on static buffers shaped as ``inputs``
        (filled with them, so the warm-up reads valid rows)."""
        buffers = {name: device_tensor(v, device).clone(memory_format=torch.contiguous_format)
                   for name, v in inputs.items() if v is not None}
        args = {name: buffers.get(name) for name in inputs}
        if self._pool is None and device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        graph = CapturedGraph(lambda: body(**args), lambda: warm_up(**args), buffers, device,
                              pool=self._pool)
        self.captures += 1
        for name, s in graph.seconds.items():
            self.seconds[name] += s
        return graph

    def __len__(self) -> int:
        return len(self._graphs)

    def scan_report(self) -> dict[str, int]:
        """The work of the scans served by replays so far: calls, queries,
        table rows scanned, bytes read and operations (ops/topk.scan_work),
        each summed over the calls."""
        with _LOCK:
            return dict(self.work)

    def report(self) -> dict:
        """Graphs held, hits, misses, captures, their seconds, and the MB
        each held graph's capture added to the memory pools (with a shared
        pool, what a capture could not take from the captures before it)."""
        return {"graphs": len(self._graphs), "hits": self.hits, "misses": self.misses,
                "captures": self.captures, **{f"{k}_s": v for k, v in self.seconds.items()},
                "pool_mb": [g.pool_bytes / 2**20 for g in self._graphs.values()]}

    def release(self) -> None:
        """Drop every graph (and its memory pool) and every signature seen."""
        with _LOCK:
            self._graphs.clear()
            self._seen.clear()
            self._pool = None


# Callers that pass no cache (ops/topk.cosine_topk, ops/scoring.score_topk)
# share DEFAULT; EAGER keeps no graph (the eager body on every call).
DEFAULT = ScanGraphs()
EAGER = ScanGraphs(0)


def release_graphs() -> None:
    """Drop DEFAULT's graphs and their memory pools."""
    DEFAULT.release()
