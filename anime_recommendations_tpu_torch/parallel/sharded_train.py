"""Sharded training step: row-sharded tables over the ranks of a process group.

Counterpart of anime_recommendations_tpu/parallel/sharded_train.py. Every
rank runs this code on its own batch shard. Two routings, as in JAX:

``routing="alltoall"`` (the production path):
  * batch       : split over the whole world (rank r takes shard r)
  * user table  : striped over the whole world (parallel/routing.py)
  * anime table : likewise
  * head + BN   : replicated, and kept equal by summing their gradients
  Lookups go through routing's all-to-all exchange; the gradients of the
  exchanged rows travel back to the owning rank, so no dense table gradient
  crosses the wire.

``routing="psum"`` (the legacy comparison path; dense ``adam`` only):
  * batch       : split over the data axis; every model rank of a data row
                  takes the same shard (World.batch_shard)
  * user table  : contiguous row blocks over the model axis (block j on the
                  ranks of model index j), replicated over the data axis
  * anime table : replicated, or blocked like the user table (shard_anime)
  * head + BN   : replicated
  A lookup is a masked local gather summed over ``model_group``
  (``_sharded_lookup``); the loss, BatchNorm moments and eval sums reduce
  over ``data_group``.

Gradients through collectives. JAX differentiates the psum'd loss under
shard_map; here each rank differentiates its copy of the replicated loss.
``all_reduce_sum`` is an all-reduce over a group whose backward all-reduces
the cotangent over it, which makes the rank-local gradients those of the
SUM of the group's n copies of the loss. The backward pass therefore starts
from loss / n, n the batch shards (the world size, or data_axis for psum):
every local term gets its exact gradient. The psum lookup's sum over
``model_group`` is ``model_sum``, whose backward passes the cotangent
through unchanged (JAX's transpose of a psum): every model rank of a data
row holds the same loss, so its cotangent is already the exact one, and
each scatters it into its own rows. The gradients of the leaves replicated
over the batch shards (the head; for psum also the user block and the anime
table) are then summed over the batch group once. BatchNorm uses GLOBAL
batch statistics (weighted moments over the whole batch), so the step is
the one-device step's math at any world size.

The Keras L2 term is added analytically, 2*l2*W on the local rows. The
reported loss of ``adam`` and ``fused_adam`` includes its value over both
full tables (``_reg_sum``).

Collectives per step (every rank, in the same order). alltoall: the
exchange's all-to-alls (2 per round per table forward; 2 per round backward
for ``adam``, 2 per round in the gradient routing otherwise), 3 all-reduces
of the forward and their 3 in the backward, 1 for the head's gradients and 1
for the L2 value (``adam``, ``fused_adam``). psum: 1 model-group all-reduce
per sharded table lookup, the 3 data-group all-reduces of the forward and
their 3 in the backward, 3 data-group all-reduces of the gradients (head,
user, anime) and 1 model-group all-reduce for the L2 value. Host syncs: 1 per
step for both tables' round counts of an unplanned routed step, read before
it runs (ShardedTrainStep.make_plans; none at one rank with a capacity of
the whole batch, which takes one round); none in a planned step. On a card
``train_step``, ``eval_sums`` and ``grads`` (JAX's jitted _build_train,
_build_eval and _build_grads) are each one CUDA graph replay per call from a
signature's third call on (train/step_graph.py), the plans in the graph's
buffers and the rounds they run in its key: each table's largest count so
far, the rounds past a batch's own exact no-ops, so a new graph comes only
with a larger count.

The sharded epoch (JAX's ``build_plans_fn`` and ``build_epoch_fn``).
``build_plans`` plans every batch of an epoch on the device (and, for
``fused_adam``, the receipt orders), one all_reduce for every round count;
``routing.round_maxima`` reads each table's largest count once, and every
exchange of the epoch runs that many rounds (the rounds past a batch's own
count are exact no-ops). ``epoch_body`` then runs the steps over the batches
in a given order, step i reading its scalars (lr, bc1, bc2, step) from row i
of the epoch's table (train/device_loop.scalar_table), then the holdout's
eval sums: no host number changes from step to step and nothing reads a
value on the host, so ``run_epoch`` on a card replays it as one CUDA graph
with its NCCL collectives captured (``epoch_graph``), its scalar table and
batch order copied into static buffers before each replay. Elsewhere, and
on a card through ``eager_run_epoch``, the same body runs as Python loops
(the plain version the graph is held against).
"""

from __future__ import annotations

import itertools
import weakref
from typing import NamedTuple

import torch
import torch.distributed as dist

from anime_recommendations_tpu_torch.models.two_tower import (
    HEAD_KEYS,
    KERAS_BN_EPS,
    KERAS_BN_MOMENTUM,
    PARAM_KEYS,
    BNState,
    TwoTower,
    bce,
    cosine_merge,
)
from anime_recommendations_tpu_torch.ops import fused_adam
from anime_recommendations_tpu_torch.ops.dense_adam import dense_adam_
from anime_recommendations_tpu_torch.parallel import routing as rt
from anime_recommendations_tpu_torch.parallel.mesh import World
from anime_recommendations_tpu_torch.train import device_loop as dl
from anime_recommendations_tpu_torch.train import step_graph
from anime_recommendations_tpu_torch.train.lazy import _head_adam
from anime_recommendations_tpu_torch.train.trainer import (
    B1,
    B2,
    KERAS_ADAM_EPS,
    TABLE_KEYS,
    AdamState,
    TrainState,
    _keep_bn,
    step_row,
)
from anime_recommendations_tpu_torch.utils import graphs

OPTIMIZERS = ("adam", "lazy_adam", "fused_adam")
_PLAN_TENSORS = rt._Plan._fields[:4]   # a plan's tensors; its rounds go in a graph's key


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks; the backward pass sums the cotangents too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of x over ``group``'s ranks (default: the world;
    module docstring)."""
    return _AllReduceSum.apply(x, group)


class _ModelSum(torch.autograd.Function):
    """Sum over a group's ranks whose backward passes the cotangent through."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def model_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the psum lookup's masked gathers over ``group`` (the model
    axis); its backward is the identity (module docstring)."""
    return _ModelSum.apply(x, group)


def _all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def _sharded_lookup(table_local: torch.Tensor, ids: torch.Tensor, world: World) -> torch.Tensor:
    """psum routing: masked gather of this rank's contiguous row block,
    summed over the model group (each id has one owner there)."""
    rows_local = table_local.shape[0]
    local = ids - world.model_index * rows_local
    owned = (local >= 0) & (local < rows_local)
    safe = torch.clamp(local, 0, rows_local - 1)
    gathered = table_local[safe] * owned[:, None].to(table_local.dtype)
    return model_sum(gathered, world.model_group)


# ---- state placement ------------------------------------------------------------


def _table_layout(world: World, key: str, routing: str, shard_anime: bool):
    """How table ``key`` is split, as (parts, part index, striped, group),
    or None when every rank holds it whole: striped over the world
    (alltoall), or in contiguous blocks over the model group (psum)."""
    if routing == "alltoall":
        return world.size, world.rank, True, None
    if key == "user_emb" or shard_anime:
        return world.model_axis, world.model_index, False, world.model_group
    return None


def table_shards(world: World, routing: str = "alltoall",
                 shard_anime: bool = False) -> tuple[int, int]:
    """The parts the (user, anime) tables are split into: the world size
    for both under "alltoall"; the model axis for the user table under
    "psum", and for the anime table with ``shard_anime`` (else 1, whole)."""
    return tuple(1 if lay is None else lay[0]
                 for lay in (_table_layout(world, k, routing, shard_anime) for k in TABLE_KEYS))


def place_state(state: TrainState, world: World, routing: str = "alltoall",
                shard_anime: bool = False) -> TrainState:
    """This rank's part of a LOGICAL-order TrainState (any device), on
    world.device: alltoall, stripe ``rank`` of every table and table moment
    (rows rank, rank + m, ...); psum, the user table's row block
    ``model_index`` (and the anime table's with ``shard_anime``, else the
    whole table). The head, BatchNorm statistics and head moments whole.
    Split tables' rows must already be padded to a multiple of their parts
    (parallel.mesh.pad_rows_for_shards)."""
    dev = world.device
    model = state.model
    layouts = {k: _table_layout(world, k, routing, shard_anime) for k in TABLE_KEYS}
    shapes = []
    for k in TABLE_KEYS:
        n, lay = getattr(model, k).shape[0], layouts[k]
        if lay is not None and n % lay[0]:
            raise ValueError(f"{k} rows {n} not a multiple of its {lay[0]} shards")
        shapes.append(n if lay is None else n // lay[0])
    local = TwoTower(*shapes, model.user_emb.shape[1], device=dev)

    def part(k, t):
        t, lay = t.detach(), layouts.get(k)
        if lay is not None:
            parts, i, striped, _ = lay
            rows = t.shape[0] // parts
            t = t[i::parts] if striped else t[i * rows:(i + 1) * rows]
        return t.to(dev).contiguous()

    with torch.no_grad():
        for k in PARAM_KEYS:
            getattr(local, k).copy_(part(k, getattr(model, k)))
        local.moving_mean.copy_(model.moving_mean)
        local.moving_var.copy_(model.moving_var)
    adam = state.adam
    return TrainState(model=local.train(), adam=AdamState(
        count=adam.count,
        mu={k: part(k, v) for k, v in adam.mu.items()},
        nu={k: part(k, v) for k, v in adam.nu.items()}))


def gather_table(t: torch.Tensor, world: World, key: str, routing: str = "alltoall",
                 shard_anime: bool = False) -> torch.Tensor:
    """The LOGICAL table ``key`` (or its moment or gradient) from every
    rank's part ``t``, on every rank (collective over the parts' group)."""
    lay = _table_layout(world, key, routing, shard_anime)
    if lay is None or lay[0] == 1:
        return t.detach().clone()
    parts_n, _, striped, group = lay
    parts = [torch.empty_like(t, dtype=torch.float32) for _ in range(parts_n)]
    dist.all_gather(parts, t.detach().float().contiguous(), group=group)
    full = torch.stack(parts, dim=1) if striped else torch.stack(parts)
    return full.reshape(-1, t.shape[1]).to(t.dtype)


def unstripe_state(state: TrainState, world: World, routing: str = "alltoall",
                   shard_anime: bool = False) -> TrainState:
    """Every rank's parts gathered into a LOGICAL-order TrainState, on
    every rank (collective), on world.device."""
    model = state.model

    def whole(k, t):
        return gather_table(t, world, k, routing, shard_anime) if k in TABLE_KEYS else (
            t.detach().clone())

    user, anime = (whole(k, getattr(model, k)) for k in TABLE_KEYS)
    full = TwoTower(user.shape[0], anime.shape[0], user.shape[1], device=world.device)
    with torch.no_grad():
        full.user_emb.copy_(user)
        full.anime_emb.copy_(anime)
        for k in HEAD_KEYS:
            getattr(full, k).copy_(getattr(model, k))
        full.moving_mean.copy_(model.moving_mean)
        full.moving_var.copy_(model.moving_var)
    adam = state.adam
    return TrainState(model=full.train(), adam=AdamState(
        count=adam.count, mu={k: whole(k, v) for k, v in adam.mu.items()},
        nu={k: whole(k, v) for k, v in adam.nu.items()}))


# ---- the step -------------------------------------------------------------------


class ShardedTrainStep:
    """Train, eval and gradient steps of one rank over its batch shard."""

    def __init__(
        self,
        world: World,
        l2_reg_factor: float = 1e-4,
        shard_anime: bool = False,
        routing: str = "alltoall",
        optimizer: str = "adam",
        capacity: int | None = None,
    ):
        if routing not in ("alltoall", "psum"):
            raise ValueError(f"unknown routing {routing!r}")
        if optimizer not in OPTIMIZERS:
            raise ValueError(
                f"unknown sharded optimizer {optimizer!r}: choose 'adam', "
                "'lazy_adam', or 'fused_adam'")
        if optimizer in ("lazy_adam", "fused_adam") and routing != "alltoall":
            raise ValueError(
                f"{optimizer} requires routing='alltoall' (owner-side "
                "updates need the exchange plan; the psum path has no row "
                "ownership for the gathered block)")
        self.world = world
        self.l2 = float(l2_reg_factor)
        self.shard_anime = shard_anime
        self.routing = routing
        self.optimizer = optimizer
        # Per-(sender, owner) all-to-all slot count; None = default_capacity.
        self.capacity = capacity
        self._n_shards = world.size
        # The group the batch is split over, and its size: the loss, the
        # BatchNorm moments, the eval sums and the gradients of the leaves
        # replicated over the batch shards reduce over it.
        self._batch_group = world.data_group if routing == "psum" else None
        self._n_batch = world.batch_shard(routing)[0]
        # The rounds (users, anime) the plans of make_plans run: the largest
        # count of each table so far.
        self.rounds = (0, 0)

    # ---- public API -------------------------------------------------------------
    #
    # train_step, eval_sums and grads (JAX's _build_train, _build_eval and
    # _build_grads) run their bodies (step, eval_body, grads_body) through
    # _run: on a card one replay of the step's graph per call from a
    # signature's third call on (train/step_graph.py).

    def train_step(self, state: TrainState, users, anime, ratings, weights, lr: float,
                   plans=None, orders=None):
        """One step on this rank's batch shard (tensors or numpy arrays), in
        place, at learning rate ``lr`` (a host number, the step's row copied
        in). Returns (state, loss, mse), the last two 0-dim device tensors of
        the global batch. ``plans`` = (plan_u, plan_a) (routing.plan_at;
        alltoall; made before the step where not given, _run), ``orders`` =
        (order_u, order_a) their receipt orders (fused_adam)."""

        def body(st, cols, plans, orders, scal):
            return self.step(st, *cols, scal, plans, orders)

        loss, mse = self._run("train", body, state, step_graph.state_tensors(state),
                              (users, anime, ratings, weights), plans, orders,
                              scal=step_row(state, lr))
        state.adam.count += 1
        return state, loss, mse

    def step(self, state: TrainState, users, anime, ratings, weights, scal: torch.Tensor,
             plans=None, orders=None) -> tuple[torch.Tensor, torch.Tensor]:
        """train_step's work with the step's scalars read from ``scal``, a [4]
        row (lr, bc1, bc2, step) on the device: the Adam count is the
        caller's to advance. With ``plans`` (alltoall), under psum, or at one
        rank with a capacity of the whole batch it reads nothing on the
        host, so a CUDA graph can capture it. Returns (loss, mse)."""
        if self.optimizer == "lazy_adam":
            return self._lazy_step(state, users, anime, ratings, weights, scal, plans)
        if self.optimizer == "fused_adam":
            return self._fused_step(state, users, anime, ratings, weights, scal, plans, orders)
        return self._dense_step(state, users, anime, ratings, weights, scal, plans)

    def eval_sums(self, model: TwoTower, bn_state: BNState, users, anime, ratings, weights,
                  plans=None):
        """(loss_sum, mse_sum, weight_sum) over the global batch (eval_body;
        the columns tensors or numpy arrays); ``plans`` as for train_step."""

        def body(target, cols, plans, orders):
            return self.eval_body(*target, *cols, plans)

        return self._run("eval", body, (model, bn_state),
                         step_graph.model_tensors(model) + list(bn_state),
                         (users, anime, ratings, weights), plans, writes=False)

    @torch.no_grad()
    def eval_body(self, model: TwoTower, bn_state: BNState, users, anime, ratings, weights,
                  plans=None):
        """eval_sums' work: (loss_sum, mse_sum, weight_sum) over the global
        batch, with the moving BatchNorm statistics; loss_sum includes the L2
        value. ``plans`` as for step."""
        plan_u, plan_a = plans or (None, None)
        u_rows = self._lookup_user(model.user_emb, users, plan_u)
        a_rows = self._lookup_anime(model.anime_emb, anime, plan_a)
        pred, _ = self._head(model.head_params(), cosine_merge(u_rows, a_rows), weights,
                             (bn_state.moving_mean, bn_state.moving_var))
        local = [torch.sum(weights), torch.sum(bce(pred, ratings) * weights),
                 torch.sum(torch.square(pred - ratings) * weights)]
        if self.routing == "alltoall":
            # The tables' sum of squares rides the one all-reduce of the sums.
            local.append(self._local_sumsq(model))
        sums = _all_reduce(torch.stack(local), self._batch_group).unbind()
        w_sum, loss_sum, mse_sum = sums[:3]
        reg = self.l2 * sums[3] if self.routing == "alltoall" else self._reg_sum(model)
        return loss_sum + reg * w_sum, mse_sum, w_sum

    def grads(self, state: TrainState, users, anime, ratings, weights,
              plans=None) -> dict[str, torch.Tensor]:
        """The exact global gradient of every parameter (grads_body; the
        columns tensors or numpy arrays); ``plans`` as for train_step."""

        def body(st, cols, plans, orders):
            grads = self.grads_body(st, *cols, plans)
            return tuple(grads[k] for k in PARAM_KEYS)

        out = self._run("grads", body, state, step_graph.model_tensors(state.model),
                        (users, anime, ratings, weights), plans, writes=False)
        return dict(zip(PARAM_KEYS, out))

    def grads_body(self, state: TrainState, users, anime, ratings, weights,
                   plans=None) -> dict[str, torch.Tensor]:
        """grads' work: the exact global gradient of every parameter
        (replicated leaves summed over the batch shards, analytic L2 added),
        before any optimizer transform. The table gradients are this rank's
        parts. ``plans`` as for step."""
        model = state.model
        params = [getattr(model, k) for k in PARAM_KEYS]
        loss, _, _ = self._data_loss(model, users, anime, ratings, weights, plans)
        grads = dict(zip(PARAM_KEYS, torch.autograd.grad(loss / self._n_batch, params)))
        return self._finish_grads(grads, model)

    def make_plans(self, users: torch.Tensor, anime: torch.Tensor) -> tuple[rt._Plan, rt._Plan]:
        """Both tables' exchange plans of a batch shard (ids on the device),
        made before a step runs (JAX's build_plans_fn for one batch):
        routing.stack_plans on [1, B] with one all_reduce for both round
        counts (on a card one replay of its own step graph), then ONE host
        read of them. Each table's plan runs the largest count this step
        has made so far (``rounds``): the rounds past a batch's own are
        exact no-ops (routing.py), so a step's graph changes only when a
        larger count comes, as a ShardedTrainer's epochs run the fit's
        largest. Collective."""
        caps = tuple(self.batch_capacity(x.shape[0]) for x in (users, anime))

        def body(_, users, anime):
            stacked = rt.stack_plans((users[None], anime[None]), self._n_shards, caps)
            return (*(t[0] for p in stacked for t in p[:4]),
                    torch.cat([p.rounds for p in stacked]))

        *parts, own = step_graph.run(("sharded_plans", _group_key(self), caps), body, None,
                                     {"users": users, "anime": anime}, [], self.world.device,
                                     writes=False)
        self.rounds = tuple(max(a, b) for a, b in zip(own.tolist(), self.rounds))
        return tuple(rt._Plan(*parts[4 * i:4 * i + 4], r) for i, r in enumerate(self.rounds))

    def _reads_round_counts(self, b: int) -> bool:
        """Whether the plans of a [b] batch shard need a host read of their
        round counts: under alltoall, but at one rank with a capacity of the
        whole batch (one round, routing.make_plan)."""
        return self.routing == "alltoall" and not (
            self._n_shards == 1 and self.batch_capacity(b) >= b)

    def _run(self, kind: str, body, target, reads, cols, plans=None, orders=None,
             writes: bool = True, **more) -> tuple:
        """``body(target, cols, plans, orders, **more)`` through the step
        graphs (step_graph.run). Where the step needs plans and has none,
        they are made first (make_plans: the one host read of the round
        counts), and go into the graph's static buffers with the columns
        and ``more``; the rounds are in the key, with the process groups
        (by serial number), the routing, the optimizer, shard_anime, l2 and
        the capacity. Returns tensors the caller owns."""
        device = self.world.device
        users, anime = cols[:2]
        if plans is None and self._reads_round_counts(users.shape[0]):
            users, anime = (graphs.device_tensor(x, device) for x in (users, anime))
            plans = self.make_plans(users, anime)
        inputs = dict(users=users, anime=anime, ratings=cols[2], weights=cols[3], **more)
        rounds = None if plans is None else tuple(p.rounds for p in plans)
        for tag, plan in zip("ua", plans or ()):
            inputs.update({f"plan_{tag}_{f}": getattr(plan, f) for f in _PLAN_TENSORS})
        if orders is not None:
            inputs.update(order_u=orders[0], order_a=orders[1])

        def run_body(target, users, anime, ratings, weights, **t):
            given = None if rounds is None else tuple(
                rt._Plan(*(t.pop(f"plan_{tag}_{f}") for f in _PLAN_TENSORS), r)
                for tag, r in zip("ua", rounds))
            order = None if orders is None else (t.pop("order_u"), t.pop("order_a"))
            return body(target, (users, anime, ratings, weights), given, order, **t)

        tag = (f"sharded_{kind}", _group_key(self), self.routing, self.optimizer,
               self.shard_anime, self.l2, self.capacity, rounds)
        return step_graph.run(tag, run_body, target, inputs, reads, device, writes)

    def batch_capacity(self, batch_per_device: int) -> int:
        """The slot count of a batch shard of this size."""
        if self.capacity is not None:
            return max(1, min(batch_per_device, self.capacity))
        return rt.default_capacity(batch_per_device, self._n_shards)

    # ---- forward / loss -----------------------------------------------------------

    def _exchange(self, table_local, ids, plan=None):
        return rt.exchange_rows(table_local, ids, n_shards=self._n_shards,
                                capacity=self.batch_capacity(ids.shape[0]), plan=plan)

    def _lookup_user(self, table_local, ids, plan=None):
        if self.routing == "alltoall":
            return self._exchange(table_local, ids, plan)
        return _sharded_lookup(table_local, ids, self.world)

    def _lookup_anime(self, table_local, ids, plan=None):
        if self.routing == "alltoall":
            return self._exchange(table_local, ids, plan)
        if self.shard_anime:
            return _sharded_lookup(table_local, ids, self.world)
        return table_local[ids]

    def _global_weighted_moments(self, z, w):
        """Weighted batch mean and variance over the global batch, and the
        global weight (at least 1)."""
        g = self._batch_group
        s = all_reduce_sum(torch.stack([torch.sum(w), torch.sum(z * w)]), g)
        denom = torch.clamp_min(s[0], 1.0)
        mean = s[1] / denom
        var = all_reduce_sum(torch.sum(torch.square(z - mean) * w), g) / denom
        return mean, var, denom

    def _head(self, head_params, cos, weights, bn_stats):
        """Dense -> BatchNorm -> sigmoid. Returns (pred, (mean, var, denom));
        with ``bn_stats`` = (mean, var) given, denom is None."""
        dense_w, dense_b, bn_gamma, bn_beta = head_params
        z = dense_w * cos + dense_b
        if bn_stats is None:
            mean, var, denom = self._global_weighted_moments(z, weights)
        else:
            (mean, var), denom = bn_stats, None
        z_hat = (z - mean) * torch.rsqrt(var + KERAS_BN_EPS)
        return torch.sigmoid(bn_gamma * z_hat + bn_beta), (mean, var, denom)

    def _loss_from_rows(self, u_rows, a_rows, head_params, ratings, weights):
        """Weighted-mean BCE over the global batch (no L2 term). Returns
        (loss, mse, (mean, var))."""
        pred, (mean, var, denom) = self._head(head_params, cosine_merge(u_rows, a_rows),
                                              weights, None)
        s = all_reduce_sum(torch.stack([
            torch.sum(bce(pred, ratings) * weights),
            torch.sum(torch.square(pred - ratings) * weights)]), self._batch_group)
        return s[0] / denom, s[1] / denom, (mean.detach(), var.detach())

    def _data_loss(self, model, users, anime, ratings, weights, plans=None):
        plan_u, plan_a = plans or (None, None)
        u_rows = self._lookup_user(model.user_emb, users, plan_u)
        a_rows = self._lookup_anime(model.anime_emb, anime, plan_a)
        return self._loss_from_rows(u_rows, a_rows, model.head_params(), ratings, weights)

    @staticmethod
    def _local_sumsq(model) -> torch.Tensor:
        return torch.sum(torch.square(model.user_emb.detach())) + torch.sum(
            torch.square(model.anime_emb.detach()))

    def _reg_sum(self, model) -> torch.Tensor:
        """l2 * sum(W^2) over both full tables, on every rank."""
        if self.routing == "alltoall":
            return self.l2 * _all_reduce(self._local_sumsq(model))
        user, anime = (torch.sum(torch.square(getattr(model, k).detach())) for k in TABLE_KEYS)
        if self.shard_anime:
            user, anime = _all_reduce(torch.stack([user, anime]), self.world.model_group)
        else:
            user = _all_reduce(user, self.world.model_group)
        return self.l2 * (user + anime)

    def _finish_grads(self, grads: dict, model) -> dict:
        """Sum the gradients of the leaves replicated over the batch shards
        over them (the head; for psum the tables too) and add 2*l2*W to the
        tables'."""
        g = self._batch_group
        head = _all_reduce(torch.stack([grads[k] for k in HEAD_KEYS]), g)
        grads.update(zip(HEAD_KEYS, head.unbind()))
        for k in TABLE_KEYS:
            if self.routing == "psum":
                grads[k] = _all_reduce(grads[k], g)
            grads[k] = grads[k] + 2.0 * self.l2 * getattr(model, k).detach()
        return grads

    @staticmethod
    def _new_bn(model, mean, var):
        _keep_bn(model, BNState(
            moving_mean=model.moving_mean * KERAS_BN_MOMENTUM + mean * (1.0 - KERAS_BN_MOMENTUM),
            moving_var=model.moving_var * KERAS_BN_MOMENTUM + var * (1.0 - KERAS_BN_MOMENTUM)))

    # ---- steps --------------------------------------------------------------------

    def _dense_step(self, state: TrainState, users, anime, ratings, weights, scal, plans=None):
        """Dense Adam (the one-device dense_step) on the local parts."""
        model, adam = state.model, state.adam
        params = [getattr(model, k) for k in PARAM_KEYS]
        loss, mse, (mean, var) = self._data_loss(model, users, anime, ratings, weights, plans)
        grads = dict(zip(PARAM_KEYS, torch.autograd.grad(loss / self._n_batch, params)))
        reg = self._reg_sum(model)
        grads = self._finish_grads(grads, model)
        with torch.no_grad():
            dense_adam_(params, [grads[k] for k in PARAM_KEYS], [adam.mu[k] for k in PARAM_KEYS],
                        [adam.nu[k] for k in PARAM_KEYS], scal)
            self._new_bn(model, mean, var)
        return loss.detach() + reg, mse.detach()

    def _routed_forward_grads(self, model, users, anime, ratings, weights, plans=None):
        """Forward and backward of the owner-side steps: exchange both
        tables' rows and differentiate the data loss with respect to the
        EXCHANGED rows and the head. Returns (loss, mse, (mean, var), d_u,
        d_a, d_head, (cap_u, plan_u), (cap_a, plan_a))."""
        m = self._n_shards
        cap_u = self.batch_capacity(users.shape[0])
        cap_a = self.batch_capacity(anime.shape[0])
        if plans is not None:
            plan_u, plan_a = plans
        else:
            plan_u = rt.make_plan(users, m, cap_u)
            plan_a = rt.make_plan(anime, m, cap_a)
        u_rows = rt.exchange_rows_planned(model.user_emb.detach(), users, plan_u,
                                          n_shards=m, capacity=cap_u).requires_grad_()
        a_rows = rt.exchange_rows_planned(model.anime_emb.detach(), anime, plan_a,
                                          n_shards=m, capacity=cap_a).requires_grad_()
        head = tuple(p.detach().requires_grad_() for p in model.head_params())
        loss, mse, stats = self._loss_from_rows(u_rows, a_rows, head, ratings, weights)
        d_u, d_a, *d_head = torch.autograd.grad(loss / m, (u_rows, a_rows, *head))
        d_head = _all_reduce(torch.stack(d_head)).unbind()
        return (loss.detach(), mse.detach(), stats, d_u, d_a, d_head,
                (cap_u, plan_u), (cap_a, plan_a))

    def _lazy_step(self, state: TrainState, users, anime, ratings, weights, scal, plans=None):
        """Row-sparse Adam on the routed path (train/lazy.py semantics): the
        owners update the rows each round delivers. The loss excludes L2."""
        model, adam = state.model, state.adam
        m = self._n_shards
        loss, mse, (mean, var), d_u, d_a, d_head, (cap_u, plan_u), (cap_a, plan_a) = (
            self._routed_forward_grads(model, users, anime, ratings, weights, plans))
        with torch.no_grad():
            for k, ids, grad, cap, plan in (("user_emb", users, d_u, cap_u, plan_u),
                                            ("anime_emb", anime, d_a, cap_a, plan_a)):
                rt.route_grads_lazy_adam(
                    getattr(model, k).detach(), adam.mu[k], adam.nu[k], ids, grad, scal,
                    self.l2, n_shards=m, capacity=cap, plan=plan)
            _head_adam(state, d_head, scal)
            self._new_bn(model, mean, var)
        return loss, mse

    def _fused_step(self, state: TrainState, users, anime, ratings, weights, scal,
                    plans=None, orders=None):
        """Owner-side fused dense Adam: the gradient sums are routed home
        (route_grad_rows) and land in one K1 call per local stripe, the
        overflow rounds as its dense gradient: exact dense-Adam semantics at
        any overflow. The loss includes the full tables' L2 value."""
        from anime_recommendations_tpu_torch.ops.fused_adam import sparse_adam_update

        model, adam = state.model, state.adam
        m = self._n_shards
        loss, mse, (mean, var), d_u, d_a, d_head, (cap_u, plan_u), (cap_a, plan_a) = (
            self._routed_forward_grads(model, users, anime, ratings, weights, plans))
        orders = orders if orders is not None else (None, None)
        with torch.no_grad():
            sumsq = []
            for k, ids, grad, cap, plan, order in (
                    ("user_emb", users, d_u, cap_u, plan_u, orders[0]),
                    ("anime_emb", anime, d_a, cap_a, plan_a, orders[1])):
                w = getattr(model, k).detach()
                oid, og, dense = rt.route_grad_rows(
                    ids, grad, n_shards=m, capacity=cap, r_local=w.shape[0], plan=plan)
                *_, s = sparse_adam_update(
                    w, adam.mu[k], adam.nu[k], oid, og, l2=self.l2, b1=B1, b2=B2,
                    eps=KERAS_ADAM_EPS, dense_grad=dense, order=order, scalars=scal)
                sumsq.append(s)
            loss = loss + self.l2 * _all_reduce(sumsq[0] + sumsq[1])
            _head_adam(state, d_head, scal)
            self._new_bn(model, mean, var)
        return loss, mse


# ---- the sharded epoch ------------------------------------------------------------


class EpochPlans(NamedTuple):
    """build_plans' result: each table's plans, stacked over the batches,
    and for fused_adam each table's receipt orders [nb, T]."""

    users: rt.Plans
    anime: rt.Plans
    orders: tuple[torch.Tensor, torch.Tensor] | None = None

    def select(self, idx) -> "EpochPlans":
        """The plans of batches ``idx`` (a slice, or a device index tensor)."""
        orders = None if self.orders is None else tuple(o[idx] for o in self.orders)
        return EpochPlans(self.users.select(idx), self.anime.select(idx), orders)

    def maxima(self) -> tuple[int, int]:
        """Each table's largest round count: ONE host read."""
        return rt.round_maxima((self.users, self.anime))


def build_plans(step: ShardedTrainStep, users_batches, anime_batches, table_rows=None, *,
                orders: bool = True) -> EpochPlans:
    """Every batch's exchange plans, on the device, before an epoch's steps
    (JAX's build_plans_fn): one all_reduce for every round count and no host
    read. ``*_batches``: this rank's shard of each batch, [nb, B/m]. For
    ``fused_adam`` (with ``orders``; pass ``table_rows`` = the PADDED
    (n_users, n_anime)) also each batch's receipt orders, computed over the
    staged rounds (receipt_sort_order). Collective."""
    if step.routing != "alltoall":
        raise ValueError("planned epoch requires routing='alltoall' (the psum routing "
                         "has no exchange to plan)")
    m = step._n_shards
    fused = orders and step.optimizer == "fused_adam"
    if fused and table_rows is None:
        raise ValueError("build_plans needs table_rows=(n_users_padded, n_anime_padded) "
                         "for fused_adam (receipt-order precompute)")
    caps = [step.batch_capacity(b.shape[1]) for b in (users_batches, anime_batches)]
    plans = rt.stack_plans((users_batches, anime_batches), m, caps)
    if not fused:
        return EpochPlans(*plans)
    for label, rows in zip(("n_users", "n_anime"), table_rows):
        if rows % m:
            raise ValueError(f"table_rows {label}={rows} not divisible by the world size {m}: "
                             "pass the PADDED row counts")
    out = []
    for batches, plan, cap, rows in zip((users_batches, anime_batches), plans, caps,
                                        table_rows):
        # The staged rounds, static: those past a batch's own count are no-ops.
        staged = rt.staged_round_count(batches.shape[1], cap)
        out.append(torch.stack([
            rt.receipt_sort_order(ids, n_shards=m, capacity=cap, r_local=rows // m,
                                  plan=rt.plan_at(plan, i, staged))
            for i, ids in enumerate(batches)]))
    return EpochPlans(*plans, tuple(out))


class Batches(NamedTuple):
    """An epoch's batches as this rank feeds them to the sharded steps: the
    columns (users, anime, ratings, weights), each [nb, B/m]; under alltoall
    their plans and the rounds every exchange runs, (users, anime), at least
    each table's largest count (EpochPlans.maxima)."""

    cols: tuple[torch.Tensor, ...]
    plans: EpochPlans | None = None
    rounds: tuple[int, int] | None = None

    @property
    def n(self) -> int:
        return self.cols[0].shape[0]

    def select(self, idx) -> "Batches":
        """Batches ``idx`` (a slice, or a device index tensor)."""
        return Batches(tuple(c[idx] for c in self.cols),
                       None if self.plans is None else self.plans.select(idx), self.rounds)

    def plans_at(self, i: int):
        """(plan_u, plan_a) of batch i for ShardedTrainStep, or None."""
        if self.plans is None:
            return None
        return (rt.plan_at(self.plans.users, i, self.rounds[0]),
                rt.plan_at(self.plans.anime, i, self.rounds[1]))

    def orders_at(self, i: int):
        """(order_u, order_a), batch i's receipt orders, or None."""
        orders = None if self.plans is None else self.plans.orders
        return None if orders is None else (orders[0][i], orders[1][i])


def plan_batches(step: ShardedTrainStep, cols, table_rows=None, *,
                 orders: bool = True) -> Batches:
    """Batches of these columns ([nb, B/m] each): under alltoall with their
    plans (build_plans) and each table's largest round count as the rounds
    (one host read). Collective."""
    cols = tuple(cols)
    if step.routing != "alltoall":
        return Batches(cols)
    plans = build_plans(step, cols[0], cols[1], table_rows, orders=orders)
    return Batches(cols, plans, plans.maxima())


def train_body(step: ShardedTrainStep, state: TrainState, batches: Batches,
               table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The steps over ``batches`` in order, step i reading its scalars from
    ``table[i]``: no host number, no host read, the Adam count untouched.
    Returns (losses[nb], mses[nb])."""
    losses, mses = [], []
    for i in range(batches.n):
        loss, mse = step.step(state, *(c[i] for c in batches.cols), table[i],
                              batches.plans_at(i), batches.orders_at(i))
        losses.append(loss)
        mses.append(mse)
    return torch.stack(losses), torch.stack(mses)


@torch.no_grad()
def eval_body(step: ShardedTrainStep, model: TwoTower,
              batches: Batches) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted-mean (loss, mse) of the eval sums over ``batches``, 0-dim
    device tensors, with no host read."""
    bn_state = model.bn_state()
    l_sum = m_sum = w_sum = torch.zeros((), device=batches.cols[0].device)
    for i in range(batches.n):
        ls, ms, w = step.eval_body(model, bn_state, *(c[i] for c in batches.cols),
                                   batches.plans_at(i))
        l_sum, m_sum, w_sum = l_sum + ls, m_sum + ms, w_sum + w
    w = torch.clamp_min(w_sum, 1.0)
    return l_sum / w, m_sum / w


def epoch_body(step: ShardedTrainStep, state: TrainState, train: Batches | None,
               table: torch.Tensor | None, evals: Batches | None = None,
               order: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """JAX's build_epoch_fn body: the steps over the train batches
    ``order[0]``, ``order[1]``, ... (all of them in turn without ``order``),
    step i reading ``table[i]``, then the eval sums over ``evals`` with the
    state they leave. Returns (losses[nb], mses[nb]) with a train part, then
    (val_loss, val_mse) with an eval part. No host read: a CUDA graph
    captures it whole."""
    out = ()
    if train is not None:
        out = train_body(step, state, train if order is None else train.select(order), table)
    if evals is not None:
        out += eval_body(step, state.model, evals)
    return out


def run_epoch(step: ShardedTrainStep, state: TrainState, lr: float, train: Batches | None,
              evals: Batches | None = None,
              order: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """epoch_body at learning rate ``lr`` (every step's scalars from the
    state's Adam count on), the count advanced by the train steps; ``order``
    a [nb] permutation of the train batches (on the CPU). On a card the
    replay of the epoch's CUDA graph (epoch_graph; a capture that fails
    raises), elsewhere eager_run_epoch."""
    device = (train or evals).cols[0].device
    if device.type != "cuda":
        return eager_run_epoch(step, state, lr, train, evals, order)
    graph = epoch_graph(step, state, train, evals, shuffle=order is not None)
    host = {}
    if train is not None:
        host["table"] = dl.scalar_table(state.adam.count, train.n, lr)
        state.adam.count += train.n
    if order is not None:
        host["order"] = order
    return graph.replay(host)


def eager_run_epoch(step: ShardedTrainStep, state: TrainState, lr: float,
                    train: Batches | None, evals: Batches | None = None,
                    order: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """run_epoch as Python loops, on any device: the plain version of the
    captured epoch (same arguments, same result)."""
    table = None
    if train is not None:
        device = train.cols[0].device
        table = fused_adam.upload(dl.scalar_table(state.adam.count, train.n, lr), device)
        order = None if order is None else order.to(device)
    out = epoch_body(step, state, train, table, evals, order)
    if train is not None:
        state.adam.count += train.n
    return out


# Serial numbers of the live process groups: a graph keeps the
# communicators it captured, so its cache key names the groups, by a number
# no later group reuses (a key holding the group itself would keep it alive
# past dist.destroy_process_group).
_GROUP_SERIALS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_SERIAL = itertools.count()


def _group_key(step: ShardedTrainStep) -> tuple:
    out = []
    for group in (dist.group.WORLD, step.world.data_group, step.world.model_group):
        if group is None or not isinstance(group, dist.ProcessGroup):
            out.append(None)
            continue
        if group not in _GROUP_SERIALS:
            _GROUP_SERIALS[group] = next(_SERIAL)
        out.append(_GROUP_SERIALS[group])
    return tuple(out)


def _read_state(state: TrainState, train: Batches | None) -> list[torch.Tensor]:
    """The state's tensors an epoch reads: the model's, and with steps the
    Adam moments too (an evaluation's state may have no Adam state)."""
    return (step_graph.state_tensors(state) if train is not None
            else step_graph.model_tensors(state.model))


def _batches_tensors(b: Batches | None) -> list[torch.Tensor]:
    if b is None:
        return []
    out = list(b.cols)
    if b.plans is not None:
        out += [*b.plans.users, *b.plans.anime, *(b.plans.orders or ())]
    return out


def epoch_graph(step: ShardedTrainStep, state: TrainState, train: Batches | None,
                evals: Batches | None = None, shuffle: bool = False) -> graphs.CapturedGraph:
    """The CUDA graph of epoch_body on these tensors, from the cache
    (train/device_loop.cached_graph) or captured now. Its static buffers:
    "table" [nb, 4], the steps' scalars, and with ``shuffle`` "order" [nb],
    the batch order. The warm-up runs 2 steps and 1 eval batch on a copy of
    the state (it makes every NCCL communicator before the capture). The
    key holds the process groups, the step's settings, the padded rounds
    and every tensor the graph reads, by address."""
    key = ("sharded_epoch" if train is not None else "sharded_eval", _group_key(step),
           step.routing, step.optimizer, step.shard_anime,
           step.l2, step.capacity, shuffle,
           None if train is None else train.rounds, None if evals is None else evals.rounds,
           graphs.layout(_read_state(state, train) + _batches_tensors(train)
                      + _batches_tensors(evals)))

    def build():
        dev = (train or evals).cols[0].device
        buffers = {}
        if train is not None:
            # Valid scalars for the warm-up; every replay writes its own.
            buffers["table"] = fused_adam.upload(dl.scalar_table(0, train.n, 0.0), dev)
        if shuffle:
            buffers["order"] = torch.arange(train.n, device=dev)

        def body(st, n_train, n_eval):
            tr = ev = order = None
            if train is not None:
                tr = train if shuffle else train.select(slice(0, n_train))
                order = buffers["order"][:n_train] if shuffle else None
            if evals is not None:
                ev = evals.select(slice(0, n_eval))
            table = buffers["table"][:n_train] if train is not None else None
            return epoch_body(step, st, tr, table, ev, order)

        n_train = 0 if train is None else train.n
        n_eval = 0 if evals is None else evals.n
        # Evaluation writes nothing: without steps it warms up on the model.
        warm = state if train is None else step_graph.copy_state(state)
        return graphs.CapturedGraph(lambda: body(state, n_train, n_eval),
                             lambda: body(warm, min(n_train, 2), min(n_eval, 1)),
                             buffers, dev)

    return dl.cached_graph(key, build)
