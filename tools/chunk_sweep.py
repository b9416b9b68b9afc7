#!/usr/bin/env python3
"""The chunk length of long epochs: capture seconds against replay overhead, on one CUDA card.

    python3 tools/chunk_sweep.py [--sizes 699,1024,2048,4096] [--steps 8291] [--out FILE]

Trains the two-tower model at the KDD-Cup'11 Track 1 widths (1,000,990 users x
624,961 items, D 128, batches of 10,000) with lazy_adam through the device loop
(train/device_loop.py), on ``--steps`` batches of seeded ids (users uniform,
items skewed to low ids, ~4 hot items a batch repeated), once for each chunk
length S of ``--sizes`` (device_loop.CHUNK_STEPS set to S): the first epoch
captures the chunk and tail graphs (graph_report's captures and seconds, the
pools they reserved), then two epochs are timed on the host clock to a
synchronize, the second with the span recorder on for the gaps between the
``epoch.chunk`` spans. Prints one JSON line per S, with the card's name and
power limit; --out appends them to FILE.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
N_USERS, N_ITEMS, D, BATCH = 1_000_990, 624_961, 128, 10_000


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--sizes", default="699,1024,2048,4096")
    parser.add_argument("--steps", type=int, default=8291)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import torch

    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train import trainer as tr
    from anime_recommendations_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    n = args.steps * BATCH
    users = torch.randint(0, N_USERS, (n,), generator=g, device=dev, dtype=torch.int32)
    items = (N_ITEMS * torch.rand(n, generator=g, device=dev) ** 4).to(torch.int32)
    data = dl.DeviceData(users, items, torch.rand(n, generator=g, device=dev),
                         torch.ones(n, device=dev))
    state = tr.init_train_state(N_USERS, N_ITEMS, D, generator=torch.Generator().manual_seed(0),
                                device=dev)
    for size in (int(s) for s in args.sizes.split(",")):
        dl.release_graphs()
        torch.cuda.empty_cache()
        dl.CHUNK_STEPS = size
        before = dl.graph_report()
        reserved = torch.cuda.memory_reserved(dev)
        seconds = []
        for epoch in range(3):
            if epoch == 2:
                profiling.spans_start()
            t0 = time.perf_counter()
            state, losses, _, _ = dl.train_epoch(state, data, torch.Generator().manual_seed(epoch),
                                                 1e-5, BATCH, 1e-4, optimizer="lazy_adam")
            torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
            if epoch == 0:
                after = dl.graph_report()
                pools = torch.cuda.memory_reserved(dev) - reserved
        spans = profiling.spans_stop()
        chunk_spans = [s for s in spans if s.name == "epoch.chunk"]
        gaps = [(b.start_ns - a.end_ns) / 1e6 for a, b in zip(chunk_spans, chunk_spans[1:])]
        line = {"chunk_steps": size, "steps": args.steps, "chunks": dl.chunks(args.steps)[-1:],
                "captured": after["captured"] - before["captured"],
                "capture_s": after["capture_s"] - before["capture_s"],
                "pools_bytes": pools, "first_epoch_s": seconds[0], "epoch_s": seconds[1:],
                "ms_per_step": [1e3 * s / args.steps for s in seconds[1:]],
                "replays_per_epoch": len(chunk_spans),
                "chunk_span_ms": [round((s.end_ns - s.start_ns) / 1e6, 3) for s in chunk_spans],
                "gap_ms_mean": sum(gaps) / max(len(gaps), 1), "gap_ms_max": max(gaps, default=0),
                "finite": bool(torch.isfinite(losses).all()), "device": card()}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
