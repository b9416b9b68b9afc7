"""The world of a sharded run: process ranks in place of a device mesh.

Counterpart of anime_recommendations_tpu/parallel/mesh.py. JAX runs one
controller over a ('data', 'model') mesh of devices; the port runs one
process per device in a torch.distributed process group (NCCL on the card,
gloo on the CPU). Routing "alltoall" splits both tables and the batch over
the whole world, so the two axis sizes only have to multiply to the world
size: rank r holds stripe r of both mod-striped tables and shard r of each
batch, which is what JAX's flat ('data', 'model') index r holds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


def mesh_shape_for(
    n_devices: int, data_axis: int = -1, model_axis: int = 1
) -> tuple[int, int]:
    """Resolve (data, model) axis sizes; -1 infers from the device count."""
    if data_axis == -1 and model_axis == -1:
        raise ValueError("At most one axis size may be -1")
    if data_axis == -1:
        if n_devices % model_axis:
            raise ValueError(f"{n_devices} devices not divisible by model={model_axis}")
        data_axis = n_devices // model_axis
    elif model_axis == -1:
        if n_devices % data_axis:
            raise ValueError(f"{n_devices} devices not divisible by data={data_axis}")
        model_axis = n_devices // data_axis
    if data_axis * model_axis != n_devices:
        raise ValueError(
            f"mesh {data_axis}x{model_axis} != {n_devices} devices"
        )
    return data_axis, model_axis


@dataclass(frozen=True)
class World:
    """The initialized process group as the sharded step sees it."""

    size: int           # ranks = data_axis * model_axis = table and batch shards
    rank: int
    data_axis: int
    model_axis: int
    device: torch.device


def make_world(data_axis: int = -1, model_axis: int = 1, device=None) -> World:
    """The world of the initialized default process group (see
    parallel.distributed.initialize). ``device``: this rank's device; by
    default ``cuda`` with the NCCL backend, else ``cpu``."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: start the ranks with torchrun "
            "(parallel.distributed.initialize) or call dist.init_process_group first")
    size = dist.get_world_size()
    d, m = mesh_shape_for(size, data_axis, model_axis)
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return World(size=size, rank=dist.get_rank(), data_axis=d, model_axis=m, device=device)


def pad_rows_for_shards(n_rows: int, n_shards: int) -> int:
    """Rows after padding so each model shard holds an equal row block."""
    return -(-n_rows // n_shards) * n_shards


def pad_table(table: np.ndarray, n_shards: int) -> np.ndarray:
    """Zero-pad table rows to a shard multiple (zero rows stay zero under
    the L2 term: grad 2*lambda*0 = 0, so padding never drifts)."""
    target = pad_rows_for_shards(table.shape[0], n_shards)
    if target == table.shape[0]:
        return table
    pad = np.zeros((target - table.shape[0], table.shape[1]), table.dtype)
    return np.concatenate([table, pad], axis=0)
