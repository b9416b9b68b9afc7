"""The comparison that decides ``correct``: each number a run compares, from
the program's readings and the reference's, and its limit
(limits/<cell>.json, set from the sound runs' and the control's readings;
PERF.md gives both for every limit)."""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

GRAD_FLOOR = 1e-3     # leaves whose reference gradient is under this share of the median's


def _rel(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


def training(prog: dict, ref: dict) -> dict[str, float]:
    """The training check's numbers, from the first epoch's readings on both
    sides (reference.train_epoch's):

    * ``loss``: the largest gap of a step's loss, over the reference's;
    * ``moment``: Adam's first moment after the epoch (the gradients as the
      optimizer got them), the gap of the two norms by worst leaf, over the
      larger of the reference leaf's norm and the median leaf's;
    * ``change``: the same of the parameters' change over the epoch;
    * ``val_loss``: the gap of the holdout loss then, over the reference's;
    * ``lr``: the largest gap of an epoch's learning rate, as the run used
      it, from the configuration's schedule (both in float32), over the
      latter.

    Leaves whose reference gradient at the first step is under GRAD_FLOOR
    of the median leaf's (dense_b, whose gradient BatchNorm's mean cancels,
    moves by round-off alone) are left out of ``moment`` and ``change``."""
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    leaves = [k for k, v in g_ref.items() if v >= GRAD_FLOOR * g_med]
    out = {"loss": max(_rel(a, b, abs(b)) for a, b in zip(prog["losses"], ref["losses"]))}
    for key, name in (("moment_norms", "moment"), ("change_norms", "change")):
        med = statistics.median(ref[key][k] for k in leaves)
        out[name] = max(_rel(prog[key][k], ref[key][k], max(ref[key][k], med)) for k in leaves)
    out["val_loss"] = _rel(prog["val_loss"], ref["val_loss"], abs(ref["val_loss"]))
    out["lr"] = max(_rel(a, b, b) for a, b in zip(prog["lrs"], ref["lrs"]))
    if (len(prog["losses"]) != len(ref["losses"]) or len(prog["lrs"]) != len(ref["lrs"])
            or not all(map(math.isfinite, out.values()))):
        out = {k: math.inf for k in out}
    return out


def answer_gap(rows: np.ndarray, served: np.ndarray, ref_scores: torch.Tensor,
               live: torch.Tensor, k: int) -> float:
    """How far one served answer falls short of the reference: the larger
    of the widest gap between a served score and the reference's score of
    the served row, and the widest by which the r-th served row's
    reference score lies below the reference's r-th best. ``rows`` and
    ``served`` are the answer's rows and scores in order, ``ref_scores`` the
    reference's score of every row and ``live`` the rows the answer may
    hold. An answer with a row it may not hold, a row twice, or fewer than
    min(k, live rows) rows is wrong: infinite."""
    n_live = int(live.sum())
    want = min(k, n_live)
    if len(rows) != want or len(served) != want or len(set(rows.tolist())) != want:
        return math.inf
    if want == 0:
        return 0.0
    idx = torch.as_tensor(rows, dtype=torch.long, device=ref_scores.device)
    if (idx < 0).any() or (idx >= len(live)).any() or not bool(live[idx].all()):
        return math.inf
    got = ref_scores[idx].double()
    best = torch.topk(torch.where(live, ref_scores, -math.inf), want).values.double()
    served_t = torch.as_tensor(served, dtype=torch.float64, device=ref_scores.device)
    return float(torch.maximum((served_t - got).abs().max(), (best - got).max()))


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Correct when every number is at or under its limit."""
    return all(numbers[k] <= limits[k] for k in limits)
