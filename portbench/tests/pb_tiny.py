"""Tiny sizes of the benchmark's configurations, for runs on the CPU."""

from __future__ import annotations

import torch

from portbench import harness

TINY = {
    "anime-7m": dict(n_users=400, n_anime=150, n_ratings=12000, batch_size=1000,
                     test_size=500, embedding_size=16),
    "anime-full": dict(n_users=3000, n_anime=300, n_ratings=60000, embedding_size=16),
}
CPU = torch.device("cpu")


def tiny_cell(name: str, seed: int = 2**31 + 11, seconds: float = 1.0,
              trace: bool = False) -> harness.Cell:
    cell = harness.Cell.load(name, seed=seed, seconds=seconds, trace=trace)
    cell.config = dict(cell.config, **TINY[cell.config["name"]])
    return cell


def run_tiny(cell: harness.Cell):
    """A whole run of ``cell`` on the CPU, past the card check: (Outcome,
    result line)."""
    from portbench.run import result_line, run_cell

    clock = harness.Clock()
    clock.mark("process")
    out = run_cell(cell, CPU, clock)
    return out, result_line(cell, out, CPU, clock)
