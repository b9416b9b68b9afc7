"""Best-only training checkpoints with torch.save, written off the training thread.

Counterpart of anime_recommendations_tpu/train/checkpoint.py (Orbax there).
The Trainer saves only when the validation loss improves, and only the
newest ``max_to_keep`` checkpoints stay, as the reference's
ModelCheckpoint(save_best_only=True) does. Each is one file,
``<dir>/step_<N>.pt``, written to a temporary name and renamed, so a crash
never leaves a half-written checkpoint under a valid name.

``Checkpointer`` writes synchronously. ``AsyncCheckpointer`` (the Trainer's,
JAX's surface: save, restore, latest_step, wait, close) takes a copy of the
state at ``save`` and returns; one background thread moves the copy to the
host and writes it through a Checkpointer. The training step updates the
parameters and moments in place, so the copy is a completed clone made at
``save`` on the state's device (on the card: on the training stream, so it
reads the values before any later step's update; the thread copies it to
the host on a stream of its own). A full-width state is ~170 MB.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import torch

from anime_recommendations_tpu_torch.models.two_tower import BUFFER_KEYS, PARAM_KEYS
from anime_recommendations_tpu_torch.train.trainer import TrainState

_NAME = re.compile(r"step_(\d+)\.pt")


def _blob(state: TrainState, copy) -> dict:
    """The saved layout of ``state``, each tensor through ``copy``."""
    model, adam = state.model, state.adam
    return {
        "tensors": {k: copy(getattr(model, k).detach()) for k in PARAM_KEYS + BUFFER_KEYS},
        "mu": {k: copy(v.detach()) for k, v in adam.mu.items()},
        "nu": {k: copy(v.detach()) for k, v in adam.nu.items()},
        "count": adam.count,
    }


def _map_tensors(blob: dict, fn) -> dict:
    return {k: ({n: fn(t) for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in blob.items()}


class Checkpointer:
    """``layout`` names how the saved tensors are split over ranks (None: not
    split). It is written into every checkpoint, and ``restore`` refuses a
    checkpoint of another layout: two layouts can give tensors of the same
    shapes whose rows differ."""

    def __init__(self, directory: str | Path, max_to_keep: int = 1, layout: str | None = None):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._layout = layout

    def _path(self, step: int) -> Path:
        return self._dir / f"step_{step}.pt"

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self._dir.iterdir()
                      if (m := _NAME.fullmatch(p.name)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        self.write(step, _blob(state, lambda t: t.cpu()))

    def write(self, step: int, blob: dict) -> None:
        """Write a host blob (the layout of _blob) as checkpoint ``step`` and
        drop all but the newest max_to_keep."""
        tmp = self._dir / f".step_{step}.pt.{os.getpid()}.tmp"
        torch.save(dict(blob, layout=self._layout), tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self._max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Load checkpoint ``step`` (default: the latest) into ``state``, in
        place: every tensor keeps its storage (a captured epoch graph of
        the state stays valid, train/device_loop.py) and its device; a
        moment saved in another dtype than the state's replaces it in the
        saved dtype."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint under {self._dir}")
        path = self._path(step)
        blob = torch.load(path, map_location="cpu", weights_only=True)
        if blob.get("layout") != self._layout:
            raise ValueError(f"{path} was written in the layout {blob.get('layout')!r}, not "
                             f"{self._layout!r}: resume it with the routing and mesh it was "
                             f"written with")
        model, adam = state.model, state.adam
        dev = model.user_emb.device
        with torch.no_grad():
            for k, v in blob["tensors"].items():
                getattr(model, k).copy_(v)
            for moments, saved in ((adam.mu, blob["mu"]), (adam.nu, blob["nu"])):
                for k, v in saved.items():
                    cur = moments.get(k)
                    if cur is not None and cur.shape == v.shape and cur.dtype == v.dtype:
                        cur.copy_(v)
                    else:
                        moments[k] = v.to(dev)
        adam.count = int(blob["count"])
        return state


class AsyncCheckpointer:
    """A Checkpointer whose ``save`` returns once the state is copied; one
    background thread writes the copies in order. ``wait`` returns when
    every save so far is on disk and raises the first write's error."""

    def __init__(self, directory: str | Path, max_to_keep: int = 1, layout: str | None = None):
        self._writer = Checkpointer(directory, max_to_keep, layout)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        self._pending: list[Future] = []

    def save(self, step: int, state: TrainState) -> None:
        blob = _blob(state, torch.clone)
        device, ready = state.model.user_emb.device, None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        self._pending.append(self._pool.submit(self._write, step, blob, device, ready))

    def _write(self, step: int, blob: dict, device: torch.device, ready) -> None:
        if ready is not None:
            # The clones are complete once ``ready`` is; copy them to the host
            # on a stream of this thread's own, which the training stream
            # does not wait for.
            with torch.cuda.device(device):
                stream = torch.cuda.Stream()
                stream.wait_event(ready)
                with torch.cuda.stream(stream):
                    blob = _map_tensors(blob, lambda t: t.to("cpu"))
        self._writer.write(step, blob)

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def latest_step(self) -> int | None:
        self.wait()
        return self._writer.latest_step()

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        self.wait()
        return self._writer.restore(state, step)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()
