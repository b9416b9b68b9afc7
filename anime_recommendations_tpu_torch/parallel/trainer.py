"""Sharded trainer: the one-device epoch loop over the routed steps.

Counterpart of anime_recommendations_tpu/parallel/trainer.py, a drop-in
for train/trainer.Trainer on every rank of a process group
(parallel.distributed.initialize). It handles:
  * table rows zero-padded to a multiple of their shards (inert under the
    L2 term): routing "alltoall" stripes both tables over the whole world
    (parallel/routing.py); "psum" splits the user table (and the anime
    table with shard_anime) into row blocks over the model axis; the fitted
    state is gathered back to logical row order on every rank;
  * the global batch split over the batch shards (the world, or the data
    axis for psum; batch_size must divide by their count);
  * optimizer="lazy_adam": owner-side row-sparse Adam on the routed path;
    "fused_adam": owner-side fused dense Adam through K1, exact under any
    overflow (its dense branch takes the overflow rounds);
    "fused_adam_bf16m": the same with bf16 table moments;
  * capacity=-1: the slot count measured per fit from sampled batches;
  * the holdout evaluated on the whole world, and best-only checkpoints per
    rank in the physical layout (``<checkpoint_dir>/rank<r>-of-<m>``),
    written by each rank's AsyncCheckpointer, so a resume needs the same
    world size, mesh and routing: each checkpoint names them, and a
    restore under others raises.

The device loop (``device_loop=True``) stages the data on every rank's
device and shuffles it as the one-device loop does (train/device_loop.py:
the same host shuffle and per-epoch granule shuffle, so at any world size
the steps see the one-device trainer's batches); each rank takes its shard
of every batch. Each epoch first makes its batches (``_prepare``: the
granule permutation, the shards and, under alltoall, every batch's exchange
plans with one all_reduce, sharded_train.build_plans), reads each table's
largest round count on the host once, then runs its steps and the holdout's
eval sums (sharded_train.run_epoch, JAX's build_epoch_fn), and reads the
epoch's losses and validation metrics once. On a card both passes are CUDA
graph replays, the NCCL collectives captured in them: two replays and two
host reads an epoch, no per-batch dispatch. Every exchange of an epoch runs
the rounds of the fit's largest count so far (the rounds past a batch's own
are exact no-ops), so one epoch graph serves every epoch unless a larger
count comes. Recomputing the plans each epoch departs from the JAX package,
which fixes batch composition per fit and permutes batch order per epoch.
Without the device loop each step and each evaluation batch is, on a card,
the replay of its step graph (ShardedTrainStep.train_step and eval_sums,
train/step_graph.py), the batch's numpy shard copied in.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
from anime_recommendations_tpu_torch.models.two_tower import BNState, TwoTower
from anime_recommendations_tpu_torch.parallel import routing as rt
from anime_recommendations_tpu_torch.parallel import sharded_train as st
from anime_recommendations_tpu_torch.parallel.mesh import make_world, pad_table
from anime_recommendations_tpu_torch.parallel.sharded_train import (
    Batches,
    ShardedTrainStep,
    build_plans,
    place_state,
    table_shards,
    unstripe_state,
)
from anime_recommendations_tpu_torch.train import device_loop as dl
from anime_recommendations_tpu_torch.train.trainer import (
    TABLE_KEYS,
    Trainer,
    TrainResult,
    TrainState,
    batch_columns,
    init_train_state,
    train_state_from_numpy,
    train_state_to_numpy,
)
from anime_recommendations_tpu_torch.utils import graphs

def init_placed_state(world, n_users: int, n_anime: int, embedding_size: int,
                      generator: torch.Generator, bf16_moments: bool = False,
                      routing: str = "alltoall", shard_anime: bool = False) -> TrainState:
    """This rank's part of the one-device trainer's initial state (the same
    draws from the same generator), each split table zero-padded to a
    multiple of its shards (table_shards); bf16 table moments with
    ``bf16_moments``."""
    arrays = train_state_to_numpy(init_train_state(
        n_users, n_anime, embedding_size, generator=generator, device="cpu"))
    for k, shards in zip(TABLE_KEYS, table_shards(world, routing, shard_anime)):
        for prefix in ("", "mu.", "nu."):
            arrays[prefix + k] = pad_table(arrays[prefix + k], shards)
    moments = torch.bfloat16 if bf16_moments else torch.float32
    return place_state(train_state_from_numpy(arrays, "cpu", moments), world, routing,
                       shard_anime)


@dataclass
class ShardedTrainer(Trainer):
    data_axis: int = -1
    model_axis: int = 1
    shard_anime: bool = False
    # "alltoall" (default): tables striped over the whole world, lookups
    # routed so each row crosses the wire once. "psum": the legacy dense
    # [B, D] all-reduce over the model axis (comparison baseline; adam only).
    routing: str = "alltoall"
    # Per-(sender, owner) all-to-all slot count; None = auto (2x the uniform
    # expectation, routing.default_capacity); -1 = measured per fit from
    # sampled batches (the largest per-owner bucket + 25 % + 8). A lower
    # count moves fewer rows per round and takes more rounds under skew;
    # the result does not depend on it.
    capacity: int | None = None

    def __post_init__(self):
        super().__post_init__()  # optimizer validation
        # bf16 moments ride the fused machinery: the moments' dtype in the
        # placed state selects the kernel's storage.
        self._bf16_moments = self.optimizer == "fused_adam_bf16m"
        if self._bf16_moments:
            self.optimizer = "fused_adam"
        self._auto_capacity = self.capacity == -1
        if self._auto_capacity:
            self.capacity = None  # until fit measures it
        self.world = make_world(self.data_axis, self.model_axis, self.device)
        self.device = self.world.device
        # Shards the batch splits over, this rank's one, and the tables' shards.
        self._n_batch_shards, self._batch_index = self.world.batch_shard(self.routing)
        self._n_table_shards = table_shards(self.world, self.routing)[0]
        if self.batch_size % self._n_batch_shards:
            raise ValueError(f"batch_size {self.batch_size} must divide by batch shards "
                             f"{self._n_batch_shards}")
        if self.world.rank != 0:
            self.verbose = False
        if self.checkpoint_dir is not None:
            self.checkpoint_dir = str(
                Path(self.checkpoint_dir) / f"rank{self.world.rank}-of-{self.world.size}")
        self._step = self._make_step()
        # The rounds every exchange of a device-loop epoch runs: the largest
        # count of each table so far.
        self._rounds = (0, 0)
        if self.verbose:
            self._log_comm_budget()

    def _checkpoint_layout(self) -> str:
        """The routing and mesh, and for psum whether the anime table is
        split: what decides which rows each rank's tables hold."""
        layout = f"{self.routing} {self.world.data_axis}x{self.world.model_axis}"
        return layout + (" shard_anime" if self.routing == "psum" and self.shard_anime else "")

    def _make_step(self) -> ShardedTrainStep:
        return ShardedTrainStep(self.world, l2_reg_factor=self.l2_reg_factor,
                                shard_anime=self.shard_anime, routing=self.routing,
                                optimizer=self.optimizer, capacity=self.capacity)

    def _shard(self, b: int) -> slice:
        """This rank's part of a global batch of ``b`` rows."""
        per = b // self._n_batch_shards
        return slice(self._batch_index * per, (self._batch_index + 1) * per)

    def _effective_capacity(self) -> int:
        """The all-to-all slot count of a batch shard; 0 under "psum"."""
        b_dev = max(self.batch_size // self._n_batch_shards, 1)
        return self._step.batch_capacity(b_dev) if self.routing == "alltoall" else 0

    def _log_comm_budget(self):
        m = self._n_table_shards
        b_dev = max(self.batch_size // self._n_batch_shards, 1)
        cap = self._effective_capacity() or rt.default_capacity(b_dev, m)
        a2a = rt.exchange_comm_bytes(b_dev, self.embedding_size, m, cap)
        ps = rt.psum_comm_bytes(max(self.batch_size // max(self.world.data_axis, 1), 1),
                                self.embedding_size, max(self.world.model_axis, 2))
        self.log_fn(
            f"routing={self.routing}: per-rank per-table lookup comm ~{a2a / 1e6:.2f} MB/step "
            f"(all-to-all, capacity {cap}) vs ~{ps / 1e6:.2f} MB/step (psum block all-reduce)")

    def _sample_shards(self, train: RatingsDataset, samples: int):
        """(table name, ids of one rank's shard) of sampled batches."""
        m = self.world.size
        bs = min(self.batch_size, max(len(train), 1))
        b_dev = max(bs // m, 1)
        rng = np.random.default_rng(self.seed)
        n = len(train)
        for name, ids in (("user", train.users), ("anime", train.anime)):
            for _ in range(min(samples, max(n // bs, 1))):
                sel = rng.choice(n, size=min(bs, n), replace=False)
                yield name, ids[sel][:b_dev]

    def _log_plan_stats(self, train: RatingsDataset):
        """Measured routing stats of sampled batches: unique ids, the largest
        per-owner bucket and the rounds at the configured capacity (alltoall
        only)."""
        if self.routing != "alltoall":
            return
        m = self.world.size
        rounds_seen = {}
        for name, shard in self._sample_shards(train, 4):
            cap = self._step.batch_capacity(len(shard))
            uniq, mx, rounds = rt.plan_stats(shard, m, cap)
            rounds_seen[name] = max(rounds_seen.get(name, 0), rounds)
            self.log_fn(f"plan[{name}]: B/rank={len(shard)} unique={uniq} max_bucket={mx} "
                        f"capacity={cap} rounds={rounds}")
        for name, rounds in rounds_seen.items():
            if rounds > 1:
                self.log_fn(f"plan[{name}]: skew overflow, {rounds} rounds: raise "
                            "parallel.capacity to keep one-round exchanges")

    def _measure_capacity(self, train: RatingsDataset) -> int:
        """Slot count from measured per-owner buckets of sampled batches
        (capacity=-1): the largest bucket of both tables + 25 % + 8, rounded
        up to 8. An underestimate only costs rounds."""
        m = self.world.size
        b_dev = max(min(self.batch_size, max(len(train), 1)) // m, 1)
        worst = 1
        for _, shard in self._sample_shards(train, 8):
            worst = max(worst, rt.plan_stats(shard, m, rt.default_capacity(b_dev, m))[1])
        cap = -(-(worst + worst // 4 + 8) // 8) * 8
        return max(8, min(b_dev, cap))

    # ---- backend hooks ------------------------------------------------------------

    def _init_state(self, generator: torch.Generator, n_users: int, n_anime: int) -> TrainState:
        return init_placed_state(self.world, n_users, n_anime, self.embedding_size, generator,
                                 self._bf16_moments, self.routing, self.shard_anime)

    def fit(self, train: RatingsDataset, holdout: RatingsDataset, n_users: int, n_anime: int,
            initial_state: TrainState | None = None, resume: bool = False) -> TrainResult:
        """Trainer.fit on every rank; ``initial_state``, if given, is a
        LOGICAL-order state padded to the table shards. The returned state
        is logical (padded), on every rank."""
        if self._auto_capacity and self.routing == "alltoall":
            self.capacity = self._measure_capacity(train)
            if self.verbose:
                self.log_fn(f"measured capacity: {self.capacity} slots/(sender, owner)")
            self._step = self._make_step()
        if self.verbose:
            self._log_plan_stats(train)
        if initial_state is not None:
            initial_state = place_state(initial_state, self.world, self.routing,
                                        self.shard_anime)
        result = super().fit(train, holdout, n_users, n_anime, initial_state, resume)
        result.state = unstripe_state(result.state, self.world, self.routing, self.shard_anime)
        return result

    def _train_step(self, state, batch, lr):
        sl = self._shard(batch[0].shape[0])
        return self._step.train_step(state, *(x[sl] for x in batch), lr)

    def evaluate(self, model: TwoTower, bn_state: BNState,
                 ds: RatingsDataset) -> tuple[float, float]:
        loss_sum = mse_sum = w_sum = 0.0
        for batch in ds.iter_batches(self._eval_batch_size(len(ds)), shuffle=False):
            cols = batch_columns(batch)
            sl = self._shard(cols[0].shape[0])
            ls, ms, w = self._step.eval_sums(model, bn_state, *(x[sl] for x in cols))
            loss_sum, mse_sum, w_sum = loss_sum + ls, mse_sum + ms, w_sum + w
        w = max(float(w_sum), 1.0)
        return float(loss_sum) / w, float(mse_sum) / w

    def _eval_batch_size(self, n_rows: int) -> int:
        k = self._n_batch_shards
        size = min(self.batch_size, max(n_rows, k))
        return max(size - size % k, k)

    # ---- device-resident epochs ---------------------------------------------------

    def _stage_device(self, train: RatingsDataset, holdout: RatingsDataset):
        """The whole data staged on this rank's device, as the one-device
        loop stages it (batch size rounded down to a multiple of the batch
        shards), and the holdout's batches with their plans (eval_batches)."""
        m = self._n_batch_shards
        bs = min(self.batch_size, max(len(train), 1))
        bs = max(bs - bs % m, m)
        eval_bs = self._eval_batch_size(len(holdout))
        stage_seed = self.seed if self.shuffle_each_epoch else None
        holdout_data = dl.stage(holdout, eval_bs, device=self.device)
        return (dl.stage(train, bs, seed=stage_seed, device=self.device), bs,
                self.eval_batches(holdout_data, eval_bs))

    def _device_epoch(self, staged, state, epoch: int, lr: float):
        train_data, bs, evals = staged
        perm = None
        if self.shuffle_each_epoch:
            perm = dl.granule_permutation(
                train_data.n, torch.Generator().manual_seed(self.seed * 1000 + epoch))
        train, wsums = self._prepare(state, train_data, bs, perm)
        losses, mses, vl, vm = st.run_epoch(self._step, state, lr, train, evals)
        nb = train.n
        # The epoch's one read of its results.
        host = torch.cat([losses, mses, wsums, torch.stack([vl, vm])]).cpu().numpy()
        bw = host[2 * nb:3 * nb].astype(np.float64)
        return (state, float(host[:nb] @ bw), float(host[nb:2 * nb] @ bw), float(bw.sum()),
                float(host[-2]), float(host[-1]))

    def _local(self, x: torch.Tensor, nb: int, bs: int) -> torch.Tensor:
        """This rank's shard of every batch of staged column x: [nb, bs / m]."""
        return x[:nb * bs].view(nb, bs)[:, self._shard(bs)]

    def _prep_body(self, data: dl.DeviceData, batch_size: int, table_rows: tuple,
                   perm: torch.Tensor | None):
        """(this rank's columns [nb, b], wsums [nb], plans or None) of the
        data with its granules permuted by ``perm``: no host read."""
        d = data if perm is None else dl.permute_granules(data, perm)
        nb = d.n // batch_size
        wsums = d.weights[:nb * batch_size].view(nb, batch_size).sum(dim=1)
        cols = tuple(self._local(x, nb, batch_size) for x in d)
        plans = None
        if self.routing == "alltoall":
            plans = build_plans(self._step, cols[0], cols[1], table_rows)
        return cols, wsums, plans

    def _prep_graph(self, data: dl.DeviceData, batch_size: int, table_rows: tuple,
                    shuffle: bool) -> graphs.CapturedGraph:
        """The CUDA graph of _prep_body on ``data``, its "perm" buffer the
        granule permutation (with ``shuffle``)."""
        step = self._step
        key = ("sharded_prep", st._group_key(step), step.routing, step.optimizer,
               step.capacity, batch_size, table_rows, shuffle, graphs.layout(list(data)))

        def build():
            buffers = {}
            if shuffle:
                buffers["perm"] = torch.arange(data.n // dl._granule(data.n), device=self.device)

            def prep():
                return self._prep_body(data, batch_size, table_rows, buffers.get("perm"))

            return graphs.CapturedGraph(prep, prep, buffers, self.device)

        return dl.cached_graph(key, build)

    def _prepare(self, state: TrainState, data: dl.DeviceData, batch_size: int,
                 perm: torch.Tensor | None = None, eager: bool = False):
        """An epoch's batches as this rank feeds them (_prep_body; on a card
        the replay of its graph, whose outputs the epoch's graph reads) and
        the global batches' weights. Under alltoall, the one host read of
        each table's largest round count, which raises the fit's rounds."""
        table_rows = tuple(getattr(state.model, k).shape[0] * self.world.size
                           for k in TABLE_KEYS)
        if self.device.type == "cuda" and not eager:
            graph = self._prep_graph(data, batch_size, table_rows, perm is not None)
            cols, wsums, plans = graph.replay({} if perm is None else {"perm": perm},
                                              clone=False)
        else:
            cols, wsums, plans = self._prep_body(
                data, batch_size, table_rows, None if perm is None else perm.to(self.device))
        if plans is None:
            return Batches(cols), wsums
        self._rounds = tuple(max(a, b) for a, b in zip(self._rounds, plans.maxima()))
        return Batches(cols, plans, self._rounds), wsums

    def train_epoch(self, state: TrainState, data: dl.DeviceData, batch_size: int, lr: float,
                    perm: torch.Tensor | None = None):
        """The batches of ``data`` (its granules in the order ``perm`` gives,
        when given), each rank on its shard. Returns (state, losses[nb],
        mses[nb], wsums[nb]) on the device, the last the global batches'
        weights. On a card the replays of two CUDA graphs, the batches' and
        the steps' (a capture that fails raises), with the host read of the
        round maxima between them; elsewhere eager_train_epoch."""
        if self.device.type != "cuda":
            return self.eager_train_epoch(state, data, batch_size, lr, perm)
        train, wsums = self._prepare(state, data, batch_size, perm)
        losses, mses = st.run_epoch(self._step, state, lr, train)
        return state, losses, mses, wsums.clone()

    def eager_train_epoch(self, state: TrainState, data: dl.DeviceData, batch_size: int,
                          lr: float, perm: torch.Tensor | None = None):
        """train_epoch as Python loops, on any device: the plain version of
        the captured epoch (same arguments, same result)."""
        train, wsums = self._prepare(state, data, batch_size, perm, eager=True)
        losses, mses = st.eager_run_epoch(self._step, state, lr, train)
        return state, losses, mses, wsums

    def eval_batches(self, data: dl.DeviceData, batch_size: int) -> Batches:
        """The staged holdout as this rank feeds it: its shard of every batch
        and, under alltoall, their plans (one host read of the round
        maxima)."""
        nb = data.n // batch_size
        return st.plan_batches(self._step, (self._local(x, nb, batch_size) for x in data),
                               orders=False)

    @torch.no_grad()
    def eval_epoch(self, model: TwoTower, data: dl.DeviceData, batch_size: int):
        """Weighted-mean (loss, mse) over the staged holdout, on the world:
        0-dim device tensors. On a card the replay of its CUDA graph."""
        return st.run_epoch(self._step, TrainState(model, None), 0.0, None,
                            self.eval_batches(data, batch_size))

    @torch.no_grad()
    def eager_eval_epoch(self, model: TwoTower, data: dl.DeviceData, batch_size: int):
        """eval_epoch as a Python loop, on any device."""
        return st.eager_run_epoch(self._step, TrainState(model, None), 0.0, None,
                                  self.eval_batches(data, batch_size))
