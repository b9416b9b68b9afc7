"""The profiler's trace, reduced to what the metrics read.

``Tracer`` opens a torch.profiler session (host and device activity) around
part of a run's window, marked by a ``portbench.window`` annotation, and
reduces it when it closes: the traced window's seconds, the seconds in which
an operation ran on the device (the union of the device operations'
intervals), the device operations' summed time, the ten operations that took
most time and the ten longest idle gaps, each named by the innermost host
activity under its midpoint.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

WINDOW_MARK = "portbench.window"
SPIN = "spin_kernel"        # torch.cuda._sleep's busy-wait, never counted
TOP = 10


@dataclass
class Trace:
    window_s: float = 0.0           # the traced window, host clock to a synchronize
    busy_s: float = 0.0             # union of the device operations' intervals
    op_s: float = 0.0               # the device operations' durations summed
    n_ops: int = 0
    device_ops: list = field(default_factory=list)   # [[name, seconds]], most first
    idle_gaps: list = field(default_factory=list)    # [[host activity, seconds]]


def first_session() -> None:
    """A short session first thing in the process: on the card a profiler
    first started after other threads had launched work recorded no kernels.
    Raises if the session records no device time."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.ones(1 << 20, device="cuda").sum()
        torch.cuda.synchronize()
    if not any(e.device_type() == torch.autograd.DeviceType.CUDA
               for e in prof.profiler.kineto_results.events()):
        raise RuntimeError("torch.profiler records no device activity on this machine")


class Tracer:
    """``with Tracer(device) as t: ...`` traces the block; ``t.trace`` then
    holds its reduction. Device activity is traced on a card only; on the
    CPU (tests) the reduction has no device operations."""

    def __init__(self, device: torch.device):
        self.device = device
        self.trace: Trace | None = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(WINDOW_MARK)
        self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = reduce_events(self._prof.profiler.kineto_results.events(), window_s)
        return False


def reduce_events(events, window_s: float) -> Trace:
    """The Trace of a session's kineto events."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, host, mark = [], [], None
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if SPIN not in name and not _annotation(e):
                ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name == WINDOW_MARK:
            mark = (e.start_ns(), e.start_ns() + e.duration_ns())
        else:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    out = Trace(window_s=window_s, n_ops=len(ops))
    if not ops:
        return out
    lo, hi = mark if mark else (min(o[0] for o in ops), max(o[1] for o in ops))
    by_name: dict[str, float] = {}
    for s, e, name in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    out.op_s = sum(by_name.values())
    out.device_ops = [[n[:80], v] for n, v in
                      sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]]
    busy, gaps, cursor = 0, [], lo
    for s, e, _ in sorted(ops):
        s, e = max(s, lo), min(e, hi)
        if e <= cursor:
            continue
        if s > cursor:
            gaps.append((s - cursor, cursor, s))
            busy += e - s
        else:
            busy += e - cursor
        cursor = e
    if hi > cursor:
        gaps.append((hi - cursor, cursor, hi))
    out.busy_s = busy / 1e9
    gaps.sort(reverse=True)
    out.idle_gaps = [[_host_activity(host, (a + b) // 2), length / 1e9]
                     for length, a, b in gaps[:TOP]]
    return out


def _annotation(e) -> bool:
    """A device-side copy of a host annotation, which is no operation (the
    event's API differs between torch versions)."""
    if e.name().startswith("portbench."):
        return True
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return "annotation" in kind()
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def _host_activity(host: list, t: int) -> str:
    """The innermost (shortest) host event under time ``t``."""
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or e - s < best[0]):
            best = (e - s, name)
    return "idle host" if best is None else best[1][:80]
