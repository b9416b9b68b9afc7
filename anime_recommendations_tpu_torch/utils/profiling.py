"""Tracing and timing hooks.

Counterpart of anime_recommendations_tpu/utils/profiling.py:

  * trace(log_dir): a torch.profiler session (host and, where CUDA is
    available, device activity) that writes a Chrome trace into log_dir;
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
import time
from collections import defaultdict
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile everything inside the context; the Chrome trace goes to
    ``<log_dir>/trace_<pid>_<ns>.json`` (open it in Perfetto or
    chrome://tracing)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
