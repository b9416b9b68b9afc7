"""Device-resident epoch loop.

Counterpart of anime_recommendations_tpu/train/device_loop.py. The training
data is uploaded to the device once (``stage``), padded to a batch multiple
with weight-0 rows, which are exact no-ops in the loss, the metrics and the
BatchNorm statistics. Each epoch permutes SHUFFLE_BLOCK-row granules of it
and runs its batches, keeping the per-batch loss, mse and weight on the
device: there is no host sync until the epoch ends.

On the TPU an epoch is one launched program (lax.scan). On a card an epoch
runs in chunks (``chunks``): nb // CHUNK_STEPS replays of one graph of
CHUNK_STEPS steps, then one replay of a graph of the nb % CHUNK_STEPS left,
so an epoch of at most CHUNK_STEPS steps is one replay of one graph (297
steps of ~100 kernels at full width: the host launches ~30,000 kernels as
one). A graph per chunk length bounds the capture: 26,281 steps at batch
10,000 over 263M ratings would make one graph of 3.4M kernels, minutes of
capture. ``train_epoch`` and ``eval_epoch`` capture the epoch's graphs at
their first call for a state, its staged data and the run's settings
(utils/graphs.CapturedGraph) and replay them after that, each training
replay under the span ``epoch.chunk`` (annotated with its ``steps``), each
evaluation replay under ``epoch.eval`` (utils/profiling.span). No step is
padded (a weight-0 step would still advance Adam).

What changes between epochs goes into a graph's static buffers before each
replay (``chunk_inputs``): the chunk's scalar rows, one row (lr, bc1, bc2,
step) per step (scalar_table, from the host's Adam count and the epoch's
lr), and its slice of the epoch's granule order, drawn on the host from the
caller's generator (whether the epoch is shuffled is only in that order).
The graph gathers the chunk's rows from the staged data (``chunk_rows``), so
step i of the epoch sees the rows of the epoch's granule permutation
(permute_granules) and its own scalar row whatever the chunk length. The
steps read their scalars from the rows as 0-dim device tensors and update
every state tensor in place, so the graph's pointers stay valid; the host's
Adam count advances by the epoch's steps after the replays. A holdout is
evaluated in chunks the same way, unshuffled, its sums carried from one
replay to the next. ``graph_report`` counts the epoch graphs captured,
their seconds and their replays.

On the CPU, and on a card through ``eager_train_epoch`` and
``eager_eval_epoch``, the same chunk bodies run as Python loops of steps
(the plain version the graphs are held against, bit for bit where the ops
are deterministic). The fused optimizers run the JAX scan's software
pipeline (``_fused_body``): each step consumes rows gathered at the end of
the one before and gathers the next batch's rows from the tables it just
updated.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
from anime_recommendations_tpu_torch.models.two_tower import BNState, TwoTower
from anime_recommendations_tpu_torch.ops.fused_adam import scalar_rows, upload
from anime_recommendations_tpu_torch.train.fused import pipelined_step
from anime_recommendations_tpu_torch.train.lazy import lazy_step
from anime_recommendations_tpu_torch.train.step_graph import copy_state, model_tensors, state_tensors
from anime_recommendations_tpu_torch.train.trainer import (
    B1,
    B2,
    FUSED_OPTIMIZERS,
    OPTIMIZERS,
    TrainState,
    dense_step,
    eval_body,
)
from anime_recommendations_tpu_torch.utils.graphs import (
    CapturedGraph,
    device_tensor,
    layout,
    lru_get,
)
from anime_recommendations_tpu_torch.utils.profiling import span

SHUFFLE_BLOCK = 512  # granule of the per-epoch shuffle (see stage())
GRAPH_CACHE = 4      # epoch graphs kept, most recently used; each holds a memory pool
CHUNK_STEPS = 1024   # steps of one epoch graph at most (chunks)


class DeviceData(NamedTuple):
    users: torch.Tensor    # [n_pad] int32
    anime: torch.Tensor    # [n_pad] int32
    ratings: torch.Tensor  # [n_pad] f32
    weights: torch.Tensor  # [n_pad] f32; 0 marks padding

    @property
    def n(self) -> int:
        return self.users.shape[0]


def stage(ds: RatingsDataset, batch_size: int, seed: int | None = None, *,
          device) -> DeviceData:
    """Upload a dataset once, padded to a batch multiple with weight-0 rows.

    With ``seed`` set, rows are shuffled once here on the host with
    numpy.random.default_rng(seed), as in the JAX package; each epoch then
    permutes SHUFFLE_BLOCK-row granules (train_epoch), so granules are
    random example sets and batches random unions of granules. ``seed=None``
    keeps dataset order (shuffle-off runs that must match the per-step path
    batch for batch)."""
    n = len(ds)
    n_pad = -(-max(n, 1) // batch_size) * batch_size
    pad = n_pad - n
    order = (
        np.random.default_rng(seed).permutation(n)
        if (n and seed is not None) else np.arange(n)
    )
    cols = (
        (ds.users[order], np.int32),
        (ds.anime[order], np.int32),
        (ds.ratings[order], np.float32),
        (np.ones(n, np.float32), np.float32),
    )
    return DeviceData(*(torch.from_numpy(np.pad(x.astype(dt), (0, pad))).to(device)
                        for x, dt in cols))


def _granule(n: int) -> int:
    return int(max(1, min(SHUFFLE_BLOCK, n // 64)))


def granule_permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """An epoch's permutation of the n // g whole granules of n rows (g as
    in granule_shuffle), drawn on the CPU from ``generator``."""
    return torch.randperm(n // _granule(n), generator=generator)


def permute_granules(data: DeviceData, perm: torch.Tensor) -> DeviceData:
    """The data with its granules in the order ``perm`` (on its device)
    gives; the tail of fewer than g rows keeps its place."""
    n, g = data.n, _granule(data.n)
    n_head = (n // g) * g

    def shuf(x):
        head = x[:n_head].view(n_head // g, g)[perm].reshape(n_head)
        return head if n_head == n else torch.cat([head, x[n_head:]])

    return DeviceData(*(shuf(x) for x in data))


def granule_shuffle(data: DeviceData, generator: torch.Generator) -> DeviceData:
    """Permute the data's granules of g rows on its device, g =
    min(SHUFFLE_BLOCK, n // 64) (at least 1), so small datasets still have
    ~64 granules; the tail of fewer than g rows keeps its place. The
    permutation is drawn from ``generator`` (a CPU generator)."""
    perm = granule_permutation(data.n, generator).to(data.users.device)
    return permute_granules(data, perm)


def scalar_table(count: int, steps: int, lr: float) -> np.ndarray:
    """The scalars of Adam steps count + 1 .. count + steps at learning rate
    ``lr``: [steps, 4] f32 rows (lr, bc1, bc2, step) of
    ops/fused_adam.scalar_rows, the values the one-step entry points use."""
    return scalar_rows(range(count + 1, count + steps + 1), lr, B1, B2)


def chunks(nb: int) -> list[tuple[int, int]]:
    """(first step, steps) of each replay of an epoch of ``nb`` >= 1 steps:
    nb // CHUNK_STEPS chunks of CHUNK_STEPS, then one of the nb % CHUNK_STEPS
    left (the whole epoch when nb <= CHUNK_STEPS)."""
    return [(start, min(CHUNK_STEPS, nb - start)) for start in range(0, nb, CHUNK_STEPS)]


def epoch_slots(n: int, perm: torch.Tensor | None) -> np.ndarray:
    """Every granule of n rows (g as in granule_shuffle) in an epoch's order:
    ``perm``'s order of the whole granules (theirs when None), then the tail
    of fewer than g rows in its place."""
    g = _granule(n)
    head = np.arange(n // g) if perm is None else perm.numpy()
    return np.concatenate([head, np.arange(n // g, -(-n // g))]).astype(np.int64)


def _slot_span(steps: int, batch_size: int, g: int) -> int:
    """Granules that steps * batch_size rows starting anywhere in a granule
    can lie in."""
    return (steps * batch_size + g - 2) // g + 1


def chunk_inputs(slots: np.ndarray, start: int, steps: int, batch_size: int,
                 g: int) -> dict[str, np.ndarray]:
    """Where a chunk's rows lie: the epoch's rows start * batch_size ..
    (start + steps) * batch_size - 1 of the order ``slots`` gives (epoch_slots)
    as the slots of the granules they lie in (zeros past the epoch's end,
    never read) and the first row's offset in the first of them."""
    first, offset = divmod(start * batch_size, g)
    span = np.zeros(_slot_span(steps, batch_size, g), np.int64)
    part = slots[first:first + len(span)]
    span[:len(part)] = part
    return {"slots": span, "offset": np.array(offset, np.int64)}


def chunk_rows(data: DeviceData, slots: torch.Tensor, offset: torch.Tensor, steps: int,
               batch_size: int) -> DeviceData:
    """The chunk's steps * batch_size rows, gathered on the device from the
    staged data: row j is row offset + j of the granules ``slots`` lists,
    in order (chunk_inputs' buffers)."""
    g = _granule(data.n)
    pos = offset + torch.arange(steps * batch_size, device=slots.device)
    src = slots[pos // g] * g + pos % g
    return DeviceData(*(x[src] for x in data))


def _check_optimizer(optimizer: str) -> None:
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}")


def train_epoch(
    state: TrainState,
    data: DeviceData,
    generator: torch.Generator,
    lr: float,
    batch_size: int,
    l2_reg_factor: float,
    shuffle: bool = True,
    sorted_scatter: bool | str = False,
    optimizer: str = "adam",
) -> tuple[TrainState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One epoch on the device. Returns (state, losses[nb], mses[nb],
    wsums[nb]), all on the device. ``optimizer="lazy_adam"`` takes the
    row-sparse step of train/lazy.py, whose losses exclude the L2 term.
    ``sorted_scatter``: the adam step's gathers (two_tower.forward). On a
    card a replay of its CUDA graph per chunk (module docstring; a capture
    that fails raises); elsewhere eager_train_epoch."""
    _check_optimizer(optimizer)
    if data.users.device.type != "cuda":
        return eager_train_epoch(state, data, generator, lr, batch_size, l2_reg_factor,
                                 shuffle, sorted_scatter, optimizer)
    graphs = epoch_graphs(state, data, batch_size, l2_reg_factor, shuffle, sorted_scatter,
                          optimizer)
    return _chunked_epoch(state, data, generator, lr, batch_size, shuffle,
                          lambda steps, host: _replay_chunk(graphs[steps], steps, host))


def _replay_chunk(graph: CapturedGraph, steps: int, host: dict) -> tuple:
    with span("epoch.chunk") as s:
        s.annotate(steps=steps)
        out = graph.replay(host)
    _report["replays"] += 1
    return out


def _chunked_epoch(state: TrainState, data: DeviceData, generator: torch.Generator, lr: float,
                   batch_size: int, shuffle: bool, run_chunk) -> tuple:
    """An epoch in chunks: ``run_chunk(steps, inputs)`` runs each chunk from
    its host inputs (chunk_inputs' and its scalar rows, ``table``), and
    returns its (losses, mses, wsums). The permutation of the granules is
    drawn once for the epoch; each chunk's scalar rows are made just before
    it runs. Returns train_epoch's result."""
    nb = data.n // batch_size
    perm = granule_permutation(data.n, generator) if shuffle else None
    slots = epoch_slots(data.n, perm)
    outs = [run_chunk(steps, dict(chunk_inputs(slots, start, steps, batch_size, _granule(data.n)),
                                  table=scalar_table(state.adam.count + start, steps, lr)))
            for start, steps in chunks(nb)]
    state.adam.count += nb
    return (state, *(torch.cat(parts) for parts in zip(*outs)))


def eager_train_epoch(
    state: TrainState,
    data: DeviceData,
    generator: torch.Generator,
    lr: float,
    batch_size: int,
    l2_reg_factor: float,
    shuffle: bool = True,
    sorted_scatter: bool | str = False,
    optimizer: str = "adam",
) -> tuple[TrainState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """train_epoch as a Python loop of steps, on any device: the plain
    version of the captured epoch (same arguments, same result), in the
    same chunks."""
    _check_optimizer(optimizer)

    def run_chunk(steps, host):
        buffers = {k: upload(v, data.users.device) for k, v in host.items()}
        return _train_chunk(state, data, buffers, steps, batch_size, l2_reg_factor,
                            optimizer, sorted_scatter)

    return _chunked_epoch(state, data, generator, lr, batch_size, shuffle, run_chunk)


def _batch(x: torch.Tensor, i: int, batch_size: int) -> torch.Tensor:
    return x[i * batch_size:(i + 1) * batch_size]


def _epoch_body(state: TrainState, data: DeviceData, table: torch.Tensor, batch_size: int,
                l2_reg_factor: float, optimizer: str, sorted_scatter: bool | str = False,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The steps over ``data`` as it is (no shuffle), step i reading its
    scalars from ``table[i]``: no host number, no host sync, the Adam count
    untouched. Returns (losses[nb], mses[nb], wsums[nb])."""
    nb = data.n // batch_size
    wsums = data.weights[:nb * batch_size].view(nb, batch_size).sum(dim=1)
    if optimizer in FUSED_OPTIMIZERS:
        # The bf16m variant is the same code: the state's moment dtype
        # selects the storage.
        losses, mses = _fused_body(state, data, table, batch_size, l2_reg_factor)
        return losses, mses, wsums
    losses, mses = [], []
    for i in range(nb):
        batch = [_batch(x, i, batch_size) for x in data]
        if optimizer == "lazy_adam":
            loss, mse = lazy_step(state, *batch, table[i], l2_reg_factor)
        else:
            loss, mse = dense_step(state, *batch, table[i], l2_reg_factor,
                                   sorted_scatter=sorted_scatter)
        losses.append(loss)
        mses.append(mse)
    return torch.stack(losses), torch.stack(mses), wsums


def _train_chunk(state: TrainState, data: DeviceData, buffers: dict, steps: int,
                 batch_size: int, l2_reg_factor: float, optimizer: str,
                 sorted_scatter: bool | str = False) -> tuple:
    """One chunk of an epoch: ``steps`` steps over the rows that the
    buffers ``slots`` and ``offset`` locate (chunk_rows), step i reading
    ``table[i]``. Returns _epoch_body's (losses, mses, wsums) of the chunk.
    The fused optimizers' pipeline starts afresh: the chunk's first rows are
    gathered from the tables the previous chunk left, as that chunk's last
    step would have gathered them."""
    rows = chunk_rows(data, buffers["slots"], buffers["offset"], steps, batch_size)
    return _epoch_body(state, rows, buffers["table"], batch_size, l2_reg_factor, optimizer,
                       sorted_scatter)


def _fused_body(state: TrainState, data: DeviceData, table: torch.Tensor, batch_size: int,
                l2_reg_factor: float, kernel_gather: bool = False,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused optimizers' steps over ``data`` as it is, the JAX scan's
    software pipeline: a prologue gathers batch 0's rows, then step i
    consumes the rows step i-1 gathered and gathers batch (i+1) % nb's (the
    last step's wrap to batch 0 is discarded). ``kernel_gather``: the gather
    runs inside the update kernel (K5) instead of after it; the epochs pass
    False, as the JAX device loop does. Returns (losses[nb], mses[nb])."""
    nb = data.n // batch_size
    users = [_batch(data.users, i, batch_size) for i in range(nb)]
    anime = [_batch(data.anime, i, batch_size) for i in range(nb)]
    u_rows = state.model.user_emb.detach()[users[0]]
    a_rows = state.model.anime_emb.detach()[anime[0]]
    losses, mses = [], []
    for i in range(nb):
        nxt = (i + 1) % nb
        loss, mse, u_rows, a_rows = pipelined_step(
            state, u_rows, a_rows, users[i], anime[i], _batch(data.ratings, i, batch_size),
            _batch(data.weights, i, batch_size), users[nxt], anime[nxt], table[i],
            l2_reg_factor, kernel_gather)
        losses.append(loss)
        mses.append(mse)
    return torch.stack(losses), torch.stack(mses)


def _fused_epoch(state: TrainState, data: DeviceData, lr: float, batch_size: int,
                 l2_reg_factor: float, kernel_gather: bool = False,
                 ) -> tuple[TrainState, torch.Tensor, torch.Tensor]:
    """The fused optimizers' eager epoch over ``data`` as it is (no
    shuffle): _fused_body with the epoch's scalar table, the Adam count
    advanced. Returns (state, losses[nb], mses[nb])."""
    nb = data.n // batch_size
    table = upload(scalar_table(state.adam.count, nb, lr), data.users.device)
    losses, mses = _fused_body(state, data, table, batch_size, l2_reg_factor, kernel_gather)
    state.adam.count += nb
    return state, losses, mses


@torch.no_grad()
def eval_epoch(
    model: TwoTower,
    bn_state: BNState,
    data: DeviceData,
    batch_size: int,
    l2_reg_factor: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted-mean (loss, mse) over the staged holdout, on the device. On
    a card a replay of its CUDA graph per chunk, elsewhere eager_eval_epoch."""
    if data.users.device.type != "cuda":
        return eager_eval_epoch(model, bn_state, data, batch_size, l2_reg_factor)
    graphs = _eval_chunk_graphs(model, bn_state, data, batch_size, l2_reg_factor)

    def run_chunk(steps, host):
        with span("epoch.eval") as s:
            s.annotate(steps=steps)
            (sums,) = graphs[steps].replay(host, clone=False)
        _report["replays"] += 1
        return sums

    return _chunked_eval(data, batch_size, run_chunk)


@torch.no_grad()
def eager_eval_epoch(
    model: TwoTower,
    bn_state: BNState,
    data: DeviceData,
    batch_size: int,
    l2_reg_factor: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """eval_epoch as a Python loop of batches, on any device, in
    eval_epoch's chunks."""

    def run_chunk(steps, host):
        buffers = {k: device_tensor(v, data.users.device) for k, v in host.items()}
        return _eval_chunk(model, bn_state, data, buffers, steps, batch_size, l2_reg_factor)[0]

    return _chunked_eval(data, batch_size, run_chunk)


def _eval_sums(model, bn_state, data: DeviceData, batch_size: int, l2_reg_factor: float,
               l_sum, m_sum, w_sum) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The holdout's weighted sums (loss, mse, weight) over ``data``'s
    batches, added in order to the sums given."""
    for i in range(data.n // batch_size):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        ls, ms, w = eval_body(model, bn_state, data.users[sl], data.anime[sl],
                              data.ratings[sl], data.weights[sl], l2_reg_factor)
        l_sum, m_sum, w_sum = l_sum + ls, m_sum + ms, w_sum + w
    return l_sum, m_sum, w_sum


def _means(l_sum, m_sum, w_sum) -> tuple[torch.Tensor, torch.Tensor]:
    w = torch.clamp_min(w_sum, 1.0)
    return l_sum / w, m_sum / w


def _eval_chunk(model, bn_state, data: DeviceData, buffers: dict, steps: int, batch_size: int,
                l2_reg_factor: float) -> tuple[torch.Tensor]:
    """One chunk of a holdout: the sums of its ``steps`` batches (the
    rows chunk_rows locates) added to the sums ``carry`` holds. Returns
    ([3] sums,)."""
    rows = chunk_rows(data, buffers["slots"], buffers["offset"], steps, batch_size)
    sums = _eval_sums(model, bn_state, rows, batch_size, l2_reg_factor,
                      *buffers["carry"].unbind())
    return (torch.stack(sums),)


def _chunked_eval(data: DeviceData, batch_size: int, run_chunk):
    """A holdout in chunks, in order: ``run_chunk(steps, inputs)`` adds a
    chunk's sums to ``inputs["carry"]`` (the sums so far, a [3] tensor, zeros
    at the first) and returns them. Returns eval_epoch's result."""
    slots = epoch_slots(data.n, None)
    sums = torch.zeros(3, device=data.users.device)
    for start, steps in chunks(data.n // batch_size):
        host = dict(chunk_inputs(slots, start, steps, batch_size, _granule(data.n)), carry=sums)
        sums = run_chunk(steps, host)
    return _means(*sums.unbind())


# ---- the captured epochs -----------------------------------------------------------

_GRAPHS: OrderedDict[tuple, CapturedGraph] = OrderedDict()


def cached_graph(key: tuple, build) -> CapturedGraph:
    """The graph of ``key``, built by ``build()`` on a miss; the GRAPH_CACHE
    most recently used are kept. A key holds every pointer the graph
    captured outside its own buffers and pool (the state's and the data's
    tensors, by address, shape, strides and dtype: utils/graphs.layout), so
    a hit replays on the same memory: a state restored in place keeps its
    graph, a state whose tensors moved gets a new one."""
    return lru_get(_GRAPHS, key, build, GRAPH_CACHE)


def release_graphs() -> None:
    """Drop every cached epoch graph and the memory pools they hold."""
    _GRAPHS.clear()


_report = {"captured": 0, "capture_s": 0.0, "replays": 0}


def graph_report() -> dict:
    """The epoch graphs of this module in this process: ``captured``, the
    host seconds their warm-ups, captures and instantiations took
    (``capture_s``), their ``replays`` and ``chunk_steps`` (CHUNK_STEPS).
    Counted as they happen; reading them costs nothing else."""
    return dict(_report, chunk_steps=CHUNK_STEPS)


def _capture(fn, warm_up, buffers: dict, device) -> CapturedGraph:
    graph = CapturedGraph(fn, warm_up, buffers, device)
    _report["captured"] += 1
    _report["capture_s"] += sum(graph.seconds.values())
    return graph


def _graphs_by_length(nb: int, make_buffers, body, warm_up, device) -> dict[int, CapturedGraph]:
    """One graph per length of chunks(nb), each on buffers of its own:
    ``body(buffers, steps)`` captured after ``warm_up(buffers, steps)``."""
    out = {}
    for steps in sorted({steps for _, steps in chunks(nb)}, reverse=True):
        buffers = make_buffers(steps)
        out[steps] = _capture(lambda b=buffers, n=steps: body(b, n),
                              lambda b=buffers, n=steps: warm_up(b, n), buffers, device)
    return out


def epoch_graphs(state: TrainState, data: DeviceData, batch_size: int, l2_reg_factor: float,
                 shuffle: bool = True, sorted_scatter: bool | str = False,
                 optimizer: str = "adam") -> dict[int, CapturedGraph]:
    """The graphs train_epoch replays for these arguments, by the steps of a
    replay, from the cache or captured now: one per chunk length
    (_train_chunk), each reading its scalar rows, granule slots and offset
    from buffers of its own. ``shuffle`` is only in the slots the host
    writes: shuffled and unshuffled epochs replay the same graphs."""
    key = ("train_chunks", optimizer, batch_size, float(l2_reg_factor), sorted_scatter,
           CHUNK_STEPS, layout(state_tensors(state) + list(data)))
    dev = data.users.device
    g = _granule(data.n)

    def make_buffers(steps):
        # Valid scalars and slots for the warm-up; every replay writes its own.
        return {"table": upload(scalar_table(0, steps, 0.0), dev),
                "slots": torch.zeros(_slot_span(steps, batch_size, g), dtype=torch.int64,
                                     device=dev),
                "offset": torch.zeros((), dtype=torch.int64, device=dev)}

    def run(st, buffers, steps):
        return _train_chunk(st, data, buffers, steps, batch_size, l2_reg_factor, optimizer,
                            sorted_scatter)

    return cached_graph(key, lambda: _graphs_by_length(
        data.n // batch_size, make_buffers, lambda b, n: run(state, b, n),
        lambda b, n: run(copy_state(state), b, min(n, 2)), dev))


def train_graph(state: TrainState, data: DeviceData, batch_size: int, l2_reg_factor: float,
                shuffle: bool = True, sorted_scatter: bool | str = False,
                optimizer: str = "adam") -> CapturedGraph:
    """The one graph train_epoch replays for an epoch of at most CHUNK_STEPS
    steps: epoch_graphs' only entry, from the same cache entry. A longer
    epoch has a chunk and a tail graph (epoch_graphs) and raises here."""
    replays = chunks(data.n // batch_size)
    if len(replays) > 1:
        raise ValueError(f"an epoch of {data.n // batch_size} steps runs in {len(replays)} "
                         f"chunks of at most {CHUNK_STEPS}: epoch_graphs")
    graphs = epoch_graphs(state, data, batch_size, l2_reg_factor, shuffle, sorted_scatter,
                          optimizer)
    return graphs[replays[0][1]]


def _eval_chunk_graphs(model, bn_state, data, batch_size, l2_reg_factor) -> dict:
    """The graphs eval_epoch replays for a holdout, by the steps of a replay
    (_eval_chunk), each on buffers of its own: slots, offset and the sums
    carried in."""
    key = ("eval_chunks", batch_size, float(l2_reg_factor), CHUNK_STEPS,
           layout(model_tensors(model) + list(bn_state) + list(data)))
    dev = data.users.device
    g = _granule(data.n)

    def make_buffers(steps):
        return {"slots": torch.zeros(_slot_span(steps, batch_size, g), dtype=torch.int64,
                                     device=dev),
                "offset": torch.zeros((), dtype=torch.int64, device=dev),
                "carry": torch.zeros(3, device=dev)}

    def run(buffers, steps):
        return _eval_chunk(model, bn_state, data, buffers, steps, batch_size, l2_reg_factor)

    # Evaluation writes nothing: the warm-up runs one batch on the model.
    return cached_graph(key, lambda: _graphs_by_length(
        data.n // batch_size, make_buffers, run, lambda b, n: run(b, 1), dev))
