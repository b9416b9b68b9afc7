"""Tracing and timing hooks.

Counterpart of anime_recommendations_tpu/utils/profiling.py:

  * trace(log_dir): a torch.profiler session (host and, where CUDA is
    available, device activity) that writes a Chrome trace into log_dir;
  * StepTimer: wall-clock section timing with summary statistics;
  * device_memory_stats(): per-card memory use, from torch.cuda.
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
