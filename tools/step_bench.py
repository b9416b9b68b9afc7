#!/usr/bin/env python3
"""`cli bench`'s per-step training keys for one version of the port, on one CUDA card.

    python3 tools/step_bench.py [--root DIR] [--out FILE]

Runs two sections of the port's benchmark suite (anime_recommendations_tpu_torch/bench.py)
at its full sizes: section 1 (`_train_per_step`: dense-Adam `train_step` one call at a
time over 8 distinct device batches, 91,641 x 17,560 x 128, batches of 10,000;
`train_step_ms`, `train_per_step_examples_per_sec`) and sections 4-5 (`_train_routed`:
the routed fused `ShardedTrainStep.train_step` one call at a time on a 1 x 1 NCCL world
at 350,000 users, then the planned routed epochs; `train350k_sharded_fused_step_ms` and
section 5's keys). Section 1 draws its data from numpy's default_rng(0) as `cli bench`
does; sections 4-5 from a fresh default_rng(0) (in `cli bench` they follow sections 2-3's
draws), so two versions time the same data. The package is this checkout's, or another
checkout's (DIR, e.g. the parent unpacked with `git archive <commit> | tar -x -C
build/parent`). One version per process: compare two by running parent, new, new, parent
in one call.

Prints one JSON line: the keys, each section's seconds, the card's name and power limit
(nvidia-smi) and the package's path; --out appends it to FILE.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", default=str(REPO),
                        help="the checkout whose anime_recommendations_tpu_torch is timed")
    parser.add_argument("--out", default=None, help="append the JSON line to this file")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    from anime_recommendations_tpu_torch import bench
    from anime_recommendations_tpu_torch.utils.profiling import start_profiler

    dev = bench._device("cuda")
    torch.cuda.set_device(dev)
    start_profiler()
    details = {"device": bench.card(dev),   # the card's name and power limit (nvidia-smi)
               "package": str(Path(bench.__file__).resolve().parent)}
    t0 = time.perf_counter()
    bench._train_per_step(np.random.default_rng(0), bench.FULL, dev, details)
    t1 = time.perf_counter()
    with bench.one_rank_group(dev):
        bench._train_routed(np.random.default_rng(0), bench.FULL, dev, details)
    details["seconds"] = {"1 per-step training": t1 - t0,
                          "4-5 routed": time.perf_counter() - t1}
    line = json.dumps(details)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return details


if __name__ == "__main__":
    main()
