"""Tracing and timing hooks.

Counterpart of anime_recommendations_tpu/utils/profiling.py:

  * trace(log_dir): a torch.profiler session (host and, where CUDA is
    available, device activity) that writes a Chrome trace into log_dir,
    the program's spans in it on the trace's clock;
  * span(name): the program's span recorder (off unless spans_start() or
    trace() turned it on): named intervals on time.perf_counter_ns(), from
    any thread, each with its parent and its root;
  * StepTimer: wall-clock section timing with summary statistics;
  * device_memory_stats(): per-card memory use, from torch.cuda;
  * profiled(fn): the device time of each kernel fn launches, under
    torch.profiler, robust to the launch records a session loses, and
    start_profiler(), the session a process opens first (the port's own:
    chip_smoke.py and the bench time kernels with them).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import torch


# ---- spans ---------------------------------------------------------------------


class Span(NamedTuple):
    """One recorded span. ``parent`` and ``root`` are indices into the list
    spans_stop() returns: the enclosing span on the same thread (-1 at a
    root) and the outermost one (itself at a root), which serves as the
    request's id."""

    name: str
    start_ns: int           # time.perf_counter_ns()
    end_ns: int | None      # None: still open when the recorder stopped
    thread: int             # threading.get_native_id()
    parent: int
    root: int
    attrs: dict | None


class _NullSpan:
    """What span() returns with the recorder off: one shared instance."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()
_spans_on = False
_spans_lock = threading.Lock()
_span_records: list = []     # [name, start, end, thread, parent, root, attrs] each
_span_stacks = threading.local()


class _OpenSpan:
    __slots__ = ("name", "index", "record", "records")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_span_stacks, "stack", None)
        if stack is None:
            stack = _span_stacks.stack = []
        with _spans_lock:
            records = _span_records
            self.index = len(records)
            # A span opened before this session started is no parent here.
            parent = stack[-1] if stack and stack[-1].records is records else None
            self.record = [self.name, time.perf_counter_ns(), None, threading.get_native_id(),
                           -1 if parent is None else parent.index,
                           self.index if parent is None else parent.record[5], None]
            records.append(self.record)
        self.records = records
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.record[2] = time.perf_counter_ns()
        _span_stacks.stack.pop()
        return False

    def annotate(self, **attrs) -> None:
        """Attributes of the span (route, status, Q, k, ...)."""
        if self.record[6] is None:
            self.record[6] = {}
        self.record[6].update(attrs)


def span(name: str):
    """``with span(name) as s:`` records the block as a span while the
    recorder is on (``s.annotate(key=value)`` adds attributes); with it off,
    the one shared null context, which records nothing and reads no clock."""
    if not _spans_on:
        return _NULL_SPAN
    return _OpenSpan(name)


def spans_start() -> None:
    """Turn the recorder on with no spans held."""
    global _spans_on, _span_records
    with _spans_lock:
        _span_records = []
        _spans_on = True


def spans_stop() -> list[Span]:
    """Turn the recorder off and hand back its spans, in the order they
    were opened."""
    global _spans_on, _span_records
    with _spans_lock:
        _spans_on = False
        records, _span_records = _span_records, []
    return [Span(*r) for r in records]


CLOCK_MARK = "profiling.clock"
CLOCK_MARKS = 3
SPAN_PID = 2**31 - 1     # the Chrome trace's process row of the program's spans


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile everything inside the context; the Chrome trace goes to
    ``<log_dir>/trace_<pid>_<ns>.json`` (open it in Perfetto or
    chrome://tracing). The span recorder is on for the block, and its spans,
    from every thread, go into the same file on the trace's clock: a process
    row of their own ("program spans"), one track per thread, each with its
    attributes, parent and root under ``args``."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    spans_start()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            reads = _clock_marks()
            yield prof
    finally:
        spans = spans_stop()
    path = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    doc["traceEvents"] += _span_events(spans, _clock_offset_us(doc["traceEvents"], reads))
    path.write_text(json.dumps(doc))


def _clock_marks() -> list[int]:
    """CLOCK_MARK annotations on this thread, each followed by a read of
    perf_counter_ns(): the profiler stamps an annotation's end just before
    its exit returns, so each pair ties the two clocks (clock_offset_us)."""
    reads = []
    for _ in range(CLOCK_MARKS):
        with torch.profiler.record_function(CLOCK_MARK):
            pass
        reads.append(time.perf_counter_ns())
    return reads


def _clock_offset_us(events: list, reads: list[int]) -> float:
    """The trace's clock (its ``ts``, in microseconds) less perf_counter_ns()
    in microseconds: the largest over the clock marks, since a delay between
    an annotation's end and the read after it only lowers the difference."""
    ends = sorted(e["ts"] + e["dur"] for e in events
                  if e.get("name") == CLOCK_MARK and e.get("cat") == "user_annotation")
    if len(ends) != len(reads):
        raise RuntimeError(f"the trace holds {len(ends)} of {len(reads)} clock marks")
    return max(end - read / 1e3 for end, read in zip(ends, reads))


def _span_events(spans: list[Span], offset_us: float) -> list[dict]:
    """Chrome trace events of closed spans, shifted by ``offset_us``: one
    complete event each on process SPAN_PID, thread the span's, and the
    process's name."""
    out = [{"ph": "M", "name": "process_name", "pid": SPAN_PID,
            "args": {"name": "program spans"}}]
    for i, s in enumerate(spans):
        if s.end_ns is None:
            continue
        out.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": SPAN_PID,
                    "tid": s.thread, "ts": s.start_ns / 1e3 + offset_us,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {**(s.attrs or {}), "span": i, "parent": s.parent,
                             "root": s.root}})
    return out


class StepTimer:
    """Accumulates wall-clock timings per named section."""

    def __init__(self):
        self._times: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self._times.items():
            xs_sorted = sorted(xs)
            out[name] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_s": sum(xs) / len(xs),
                "p50_s": xs_sorted[len(xs) // 2],
                "max_s": xs_sorted[-1],
            }
        return out

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))


def device_memory_stats() -> list[dict]:
    """Memory of each CUDA card in bytes: in use and the peak by torch's
    allocator, and the card's total. On a host without CUDA, one entry for
    the CPU with None values."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None,
                 "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out.append({
            "device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": total,
        })
    return out


# A busy-wait kernel of this many clock cycles (about 10 ms on an H100)
# opens and closes every profiler session: see profiled.
FRAME_CYCLES = 20_000_000
PROFILER_SESSIONS = 5
# The CUDA API calls (cuda* and cu*) that put work on a stream: profiled
# counts them per call (host_launches; a graph replay is one).
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times kernels on a CUDA card: "
                           "torch.cuda.is_available() is False")


def start_profiler() -> None:
    """One short torch.profiler session, first thing in the process (set up
    first after an HTTP server's threads had launched work, the profiler
    recorded no kernels on an H100 host), and a check of the name of the
    busy-wait kernel that frames profiled's sessions."""
    _require_cuda("start_profiler")
    if not profiled(lambda: torch.ones(1 << 20, device="cuda").sum(), reps=1)["device_ms"] > 0:
        raise AssertionError("torch.profiler records no device time on this machine")
    # A session loses its records now and then (profiled): try again.
    for _ in range(PROFILER_SESSIONS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(FRAME_CYCLES // 100)
            torch.cuda.synchronize()
        keys = [e.key for e in prof.key_averages()]
        if any("spin_kernel" in k for k in keys):
            return
        print(f"[profiler] the framing session recorded {keys}", flush=True)
    raise AssertionError("the busy-wait kernel framing profiler sessions is not spin_kernel")


def profiled(fn, reps: int = 20, match=None) -> dict:
    """torch.profiler over ``reps`` calls of fn after 3 warm-up calls: wall ms
    per call (host clock to a synchronize), device-busy ms per call, the idle
    share, device ms per call by kernel, the sessions it took and the launch
    records they lost, the host's calls per call that put work on a stream
    (host_launches: LAUNCH_CALLS) and the kernels and copies the device ran
    per call (device_ops), and (``match``, a name or a tuple of names) the device
    ms per call of the kernels whose names hold one of them (fn launches each
    once a call), their sum and their records. Needs a CUDA card.

    Every kernel is counted by one rule: its mean recorded duration times
    its launches per call (its records over ``reps``, rounded). On an H100
    host a session lost every record now and then, and in some processes
    one record of a small kernel (an arange, a dtype copy) in every session.
    So a busy-wait kernel (FRAME_CYCLES, excluded from every number) opens
    and closes each session; the records lost (launches per call times
    ``reps``, less the records) are counted; and a session with no records,
    a matched name with no kernel, or a matched kernel with fewer than
    ``reps`` - 1 records, is profiled again, at most PROFILER_SESSIONS times
    in all, and then the run fails."""
    _require_cuda("profiled")
    names = (match,) if isinstance(match, str) else tuple(match or ())
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for session in range(1, PROFILER_SESSIONS + 1):
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(FRAME_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
            torch.cuda._sleep(FRAME_CYCLES)
            torch.cuda.synchronize()
        averages = prof.key_averages()
        events = [e for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0 and "spin_kernel" not in e.key]
        hits = [e for e in events if any(m in e.key for m in names)]
        # Some processes lose one record of one kernel in every session (an
        # arange; K1's dense kernel): the mean of the matched kernel's other
        # reps - 1 records stands for it.
        if (events and all(any(m in e.key for e in hits) for m in names)
                and all(reps - 1 <= e.count <= reps for e in hits)):
            break
        print(f"[profiler] session {session} of {reps} calls recorded "
              f"{ {e.key[:60]: e.count for e in hits} } of {names}, {len(events)} kernels",
              flush=True)
    else:
        raise AssertionError(f"torch.profiler lost records in {PROFILER_SESSIONS} sessions")
    per_call = {e.key: e.self_device_time_total / e.count * round(e.count / reps) / 1e3
                for e in events}
    lost = sum(abs(round(e.count / reps) * reps - e.count) for e in events)
    if lost:
        print(f"[profiler] {lost} launch records lost: "
              f"{ {e.key[:60]: e.count for e in events} }", flush=True)
    busy = sum(per_call.values())
    top = sorted(per_call.items(), key=lambda kv: kv[1], reverse=True)
    # The two framing busy-waits are two of the launches.
    calls = sum(e.count for e in averages if e.key in LAUNCH_CALLS) - 2
    out = {"wall_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
           "by_kernel": {k[:70]: v for k, v in top[:8]}, "sessions": session,
           "records_lost": lost, "host_launches": calls / reps,
           "device_ops": sum(round(e.count / reps) for e in events)}
    if names:
        out["match_ms"] = sum(per_call[e.key] for e in hits)
        out["match_launches"] = sum(e.count for e in hits)
        out["match_by_kernel"] = {kernel_name(e.key): per_call[e.key] for e in hits}
    return out


def kernel_name(key: str) -> str:
    """A profiler key's kernel name without its namespace, template arguments
    and parameters, e.g. fused_adam_kernel."""
    head = key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return head.split()[-1].split("::")[-1]
