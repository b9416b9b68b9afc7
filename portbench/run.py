"""One run of one benchmark cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown`` of the traced window, and last ``checks``,
each number the correctness check compared with its limit. The line before
it gives set-up's parts. The checks are also the last lines on standard
error. Exits 3 without a result where the machine lacks the cards the cell
needs, and 4 where a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CACHE = ROOT / "build" / "portbench_cache"


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own nvcc builds go to build/kernels/ there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def result_line(cell, out, device, clock) -> dict:
    from portbench import harness

    correct = out.failed == 0 and all(v <= lim for v, lim in out.checks.values())
    if cell.trace:
        metrics = {}
        for m in cell.per_layer:
            value = harness.read_metric(m["name"], out.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out.end_to_end, setup_s=clock.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics,
            "device": harness.device_info(device, cell.chips, out.memory_peak_bytes,
                                          out.trace if cell.trace else None)}
    if cell.trace and out.trace is not None:
        line["breakdown"] = {"device_ops": out.trace.device_ops,
                             "idle_gaps": out.trace.idle_gaps}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def run_cell(cell, device, clock):
    """Set up, measure and check one cell on ``device``; returns the kind's
    Outcome. The card check is the caller's."""
    from portbench import harness

    return harness.kind_module(cell.traffic["kind"]).run(cell, device, clock)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    from portbench import harness

    found = harness.forbidden_modules()
    if found:
        print(f"[portbench] loaded before the run: {found}", file=sys.stderr)
        return 4
    cell = harness.Cell.load(args.workload, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace))
    try:
        harness.require_cards(cell.chips)
    except harness.NoCard as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return 3
    import torch

    from portbench import trace

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    if cell.trace:
        trace.first_session()
    clock = harness.Clock(start=START)
    clock.mark("process")
    out = run_cell(cell, device, clock)
    found = harness.forbidden_modules()
    if found:
        print(f"[portbench] loaded by the run: {found}", file=sys.stderr)
        return 4
    line = result_line(cell, out, device, clock)
    print(json.dumps({"setup_parts_s": clock.parts}), flush=True)
    for k, c in line["checks"].items():
        print(f"[portbench] check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
