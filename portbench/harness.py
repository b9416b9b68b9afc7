"""What every run shares: the cell's files found by name, the set-up clock,
the import guard, the card check and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "anime_recommendations_tpu")
PORT = "anime_recommendations_tpu_torch"


class NoCard(RuntimeError):
    """The run needs more CUDA cards than this machine shows."""


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is the JAX package or JAX's, compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.partition(".")[0] for n in names} & set(FORBIDDEN))


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards, torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class Cell:
    """One run of one cell: BENCHMARK.json's entry and the files it names."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False

    @classmethod
    def load(cls, name: str, bench: dict | None = None, **run) -> "Cell":
        bench = bench or load_json(ROOT / "BENCHMARK.json")
        works = [w for w in bench["workloads"] if w["name"] == name]
        if not works:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        work = works[0]
        conf = next(c for c in bench["configs"] if c["name"] == work["config"])
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        layer = [m for m in bench["per_layer"] if name in m["workloads"]]
        return cls(name=name, config=load_json(ROOT / conf["file"]),
                   traffic=load_json(BENCH / "traffic" / f"{work['traffic']}.json"),
                   limits=load_json(BENCH / "limits" / f"{name}.json"),
                   chips=work["chips"], end_to_end=e2e, per_layer=layer, **run)


@dataclass
class Clock:
    """Set-up's parts, host clock: each ``mark`` closes the part since the
    last one. The process part starts where run.py starts."""

    start: float = field(default_factory=time.perf_counter)
    parts: dict = field(default_factory=dict)

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.start - sum(self.parts.values())

    @property
    def setup_s(self) -> float:
        return sum(self.parts.values())


@dataclass
class Outcome:
    """What a traffic kind's run hands back to run.py."""

    end_to_end: dict           # metric name -> value, measured with tracing off
    readings: dict             # raw quantities the per-layer readers read
    checks: dict               # number compared -> (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: object = None       # trace.Trace of the traced part, or None


def checks_of(numbers: dict, limits: dict) -> dict:
    return {k: (numbers.get(k, math.inf), limits[k]) for k in limits}


def read_metric(name: str, readings: dict):
    """Run metrics/<name>.py's ``read`` on a run's readings; None where it
    finds nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(readings)


def device_info(device, count: int, peak: int, trace=None) -> dict:
    import torch

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": count, "memory_peak_bytes": int(peak)}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def kind_module(kind: str):
    spec = importlib.util.spec_from_file_location(f"portbench_kind_{kind}",
                                                  BENCH / "kinds" / f"{kind}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
