"""The world of a sharded run: process ranks in place of a device mesh.

Counterpart of anime_recommendations_tpu/parallel/mesh.py. JAX runs one
controller over a ('data', 'model') mesh of devices; the port runs one
process per device in a torch.distributed process group (NCCL on the card,
gloo on the CPU). Rank r = data_index * model_axis + model_index, the
row-major layout of JAX's make_mesh, so rank r holds what JAX's flat device
r holds.

Routing "alltoall" splits both tables and the batch over the whole world:
rank r holds stripe r of both mod-striped tables and shard r of each batch.
Routing "psum" splits the batch over the data axis and the tables over the
model axis, and reduces over the two axes' process groups: ``data_group``
(the ranks that share this rank's model index) and ``model_group`` (the
ranks that share its data index).
"""

from __future__ import annotations

import weakref
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

    size: int           # ranks = data_axis * model_axis
    rank: int           # = data_index * model_axis + model_index
    data_axis: int
    model_axis: int
    device: torch.device
    data_index: int = 0
    model_index: int = 0
    data_group: object = None    # the ranks of this model index, one per data index
    model_group: object = None   # the ranks of this data index, one per model index

    def batch_shard(self, routing: str) -> tuple[int, int]:
        """(shards a global batch is split into, this rank's shard): the
        whole world under "alltoall"; the data axis under "psum", where every
        model rank of a data row takes the same shard."""
        if routing == "psum":
            return self.data_axis, self.data_index
        return self.size, self.rank


# (data_axis, model_axis) -> weak references to (default group, data groups,
# model groups): the groups of a mesh shape are made once per default process
# group. torch holds every group until dist.destroy_process_group, so an
# entry lives exactly as long as its default group, on every rank alike. The
# references are weak so that the destroy frees the groups: a gloo group kept alive past it keeps its worker threads running
# into interpreter finalisation, where a thread that still lets go of a
# collective's tensors asks for the GIL, is ended, and aborts the process
# ("terminate called without an active exception").
_AXIS_GROUPS: dict = {}


def _weak(group):
    """A weak reference to ``group``; dist.new_group's non-member sentinel
    is held as it is."""
    if isinstance(group, dist.ProcessGroup):
        return weakref.ref(group)
    return lambda: group


def _axis_groups(d: int, m: int) -> tuple[list, list]:
    """The data groups (one per model index) and model groups (one per data
    index) of a d x m mesh. dist.new_group is collective: every rank makes
    every group, in this order."""
    default = dist.group.WORLD
    hit = _AXIS_GROUPS.get((d, m))
    if hit is not None:
        data, model = [r() for r in hit[1]], [r() for r in hit[2]]
        if hit[0]() is default and None not in data + model:
            return data, model
    data = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
    model = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    _AXIS_GROUPS[(d, m)] = (_weak(default), [_weak(g) for g in data],
                            [_weak(g) for g in model])
    return data, model


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
    rank = dist.get_rank()
    data_groups, model_groups = _axis_groups(d, m)
    return World(size=size, rank=rank, data_axis=d, model_axis=m, device=device,
                 data_index=rank // m, model_index=rank % m,
                 data_group=data_groups[rank % m], model_group=model_groups[rank // m])


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
