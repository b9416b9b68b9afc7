"""Best-only training checkpoints with torch.save.

Counterpart of anime_recommendations_tpu/train/checkpoint.py (Orbax there).
The Trainer saves only when the validation loss improves, and only the
newest ``max_to_keep`` checkpoints stay, as the reference's
ModelCheckpoint(save_best_only=True) does. Each is one file,
``<dir>/step_<N>.pt``, written to a temporary name and renamed, so a crash
never leaves a half-written checkpoint under a valid name. Saves are
synchronous: a full-width state is ~170 MB, written once per improving
epoch.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from anime_recommendations_tpu_torch.models.two_tower import BUFFER_KEYS, PARAM_KEYS
from anime_recommendations_tpu_torch.train.trainer import TrainState

_NAME = re.compile(r"step_(\d+)\.pt")


class Checkpointer:
    def __init__(self, directory: str | Path, max_to_keep: int = 1):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self._dir / f"step_{step}.pt"

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self._dir.iterdir()
                      if (m := _NAME.fullmatch(p.name)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        model, adam = state.model, state.adam
        blob = {
            "tensors": {k: getattr(model, k).detach().cpu()
                        for k in PARAM_KEYS + BUFFER_KEYS},
            "mu": {k: v.detach().cpu() for k, v in adam.mu.items()},
            "nu": {k: v.detach().cpu() for k, v in adam.nu.items()},
            "count": adam.count,
        }
        tmp = self._dir / f".step_{step}.pt.{os.getpid()}.tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self._max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Load checkpoint ``step`` (default: the latest) into ``state``, in
        place: parameters and buffers keep their device, the moments take
        the saved dtype onto the state's device."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint under {self._dir}")
        blob = torch.load(self._path(step), map_location="cpu", weights_only=True)
        model, adam = state.model, state.adam
        dev = model.user_emb.device
        with torch.no_grad():
            for k, v in blob["tensors"].items():
                getattr(model, k).copy_(v)
        adam.mu = {k: v.to(dev) for k, v in blob["mu"].items()}
        adam.nu = {k: v.to(dev) for k, v in blob["nu"].items()}
        adam.count = int(blob["count"])
        return state
