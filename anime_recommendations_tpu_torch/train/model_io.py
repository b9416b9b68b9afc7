"""Model parameter serialization: the JAX package's .npz format.

One .npz holding the six parameters and the two BatchNorm statistics under
the keys of anime_recommendations_tpu/train/model_io.py, so a file written
by either package loads in the other unchanged. numpy only.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from anime_recommendations_tpu_torch.models.two_tower import (
    BUFFER_KEYS,
    PARAM_KEYS,
    TwoTower,
    params_from_numpy,
)


def save_model(path: str | Path, model: TwoTower) -> str:
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, **{k: getattr(model, k).detach().cpu().numpy()
                      for k in PARAM_KEYS + BUFFER_KEYS})
    return path


def load_model(path: str | Path, device) -> TwoTower:
    with np.load(path) as z:
        return params_from_numpy({k: z[k] for k in z.files}, device)
