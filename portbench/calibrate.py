"""The readings that a cell's correctness limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

For each seed, in one process and without a measured window, the numbers
the cell's check compares: the sound program's on every seed, and on the
control seeds also the control's (the reference in the nearest precision
below the configuration's, in the program's place) and each planted
fault's. Prints one JSON line per seed and, last, for each number the
largest sound reading (the lower reading) and the smallest control and
fault readings. PERF.md gives these beside each limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    from portbench import harness
    from portbench.run import pin_caches

    pin_caches()
    import torch

    cell = harness.Cell.load(args.workload)
    harness.require_cards(cell.chips)
    device = torch.device("cuda", 0)
    kind = harness.kind_module(cell.traffic["kind"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    summary: dict = {}
    for seed in sorted(set(seeds) | controls):
        cell.seed = seed
        out = kind.calibrate(cell, device, seed, control=seed in controls)
        print(json.dumps({"seed": seed, **out}), flush=True)
        for side, numbers in out.items():
            for name, value in numbers.items():
                pick = max if side == "sound" else min
                key = (side, name)
                summary[key] = value if key not in summary else pick(summary[key], value)
    print(json.dumps({"workload": args.workload,
                      "readings": {f"{side}.{name}": v for (side, name), v in summary.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
