"""On the card: a short run of a cell is correct, and the training control
fails at the cell's own size. Skips where there is no CUDA card.

    python3 -m pytest portbench/tests -m cuda -q
"""

import json
import subprocess
import sys

import pytest
import torch

from portbench import compare, harness


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["anime7m-train-fused"])
def test_short_run_on_the_card_is_correct(name):
    _card()
    proc = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", name,
                           "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
                          capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


@pytest.mark.cuda
def test_training_control_fails_at_the_cells_size():
    _card()
    cell = harness.Cell.load("anime7m-train-fused")
    kind = harness.kind_module(cell.traffic["kind"])
    out = kind.calibrate(cell, torch.device("cuda", 0), 2**31 + 98, control=True)
    assert compare.verdict(out["sound"], cell.limits)
    assert not compare.verdict(out["control"], cell.limits)
    assert not compare.verdict(out["half_batch"], cell.limits)
