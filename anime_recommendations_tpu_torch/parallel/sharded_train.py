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
table per step for the plans of an unplanned step (none at one rank with the
default capacity), 1 per epoch for a planned epoch (``build_plans``), and 1
per round per table for ``lazy_adam``'s receipts.
"""

from __future__ import annotations

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
from anime_recommendations_tpu_torch.parallel import routing as rt
from anime_recommendations_tpu_torch.parallel.mesh import World
from anime_recommendations_tpu_torch.train.lazy import _head_adam
from anime_recommendations_tpu_torch.train.trainer import (
    B1,
    B2,
    KERAS_ADAM_EPS,
    TABLE_KEYS,
    AdamState,
    TrainState,
    _keep_bn,
    bias_corrections,
    step_row,
)

OPTIMIZERS = ("adam", "lazy_adam", "fused_adam")


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

    # ---- public API -------------------------------------------------------------

    def train_step(self, state: TrainState, users, anime, ratings, weights, lr: float,
                   plans=None, orders=None):
        """One step on this rank's batch shard, in place. Returns (state,
        loss, mse), the last two 0-dim device tensors of the global batch.
        ``plans`` = (plan_u, plan_a) from build_plans (lazy_adam, fused_adam),
        ``orders`` = (order_u, order_a) its receipt orders (fused_adam)."""
        if self.optimizer == "lazy_adam":
            return self._lazy_step(state, users, anime, ratings, weights, lr, plans)
        if self.optimizer == "fused_adam":
            return self._fused_step(state, users, anime, ratings, weights, lr, plans, orders)
        return self._dense_step(state, users, anime, ratings, weights, lr)

    @torch.no_grad()
    def eval_sums(self, model: TwoTower, bn_state: BNState, users, anime, ratings, weights):
        """(loss_sum, mse_sum, weight_sum) over the global batch, with the
        moving BatchNorm statistics; loss_sum includes the L2 value."""
        u_rows = self._lookup_user(model.user_emb, users)
        a_rows = self._lookup_anime(model.anime_emb, anime)
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

    def grads(self, state: TrainState, users, anime, ratings, weights) -> dict[str, torch.Tensor]:
        """The exact global gradient of every parameter (replicated leaves
        summed over the batch shards, analytic L2 added), before any
        optimizer transform. The table gradients are this rank's parts."""
        model = state.model
        params = [getattr(model, k) for k in PARAM_KEYS]
        loss, _, _ = self._data_loss(model, users, anime, ratings, weights)
        grads = dict(zip(PARAM_KEYS, torch.autograd.grad(loss / self._n_batch, params)))
        return self._finish_grads(grads, model)

    def batch_capacity(self, batch_per_device: int) -> int:
        """The slot count of a batch shard of this size."""
        if self.capacity is not None:
            return max(1, min(batch_per_device, self.capacity))
        return rt.default_capacity(batch_per_device, self._n_shards)

    # ---- forward / loss -----------------------------------------------------------

    def _exchange(self, table_local, ids):
        return rt.exchange_rows(table_local, ids, n_shards=self._n_shards,
                                capacity=self.batch_capacity(ids.shape[0]))

    def _lookup_user(self, table_local, ids):
        if self.routing == "alltoall":
            return self._exchange(table_local, ids)
        return _sharded_lookup(table_local, ids, self.world)

    def _lookup_anime(self, table_local, ids):
        if self.routing == "alltoall":
            return self._exchange(table_local, ids)
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

    def _data_loss(self, model, users, anime, ratings, weights):
        u_rows = self._lookup_user(model.user_emb, users)
        a_rows = self._lookup_anime(model.anime_emb, anime)
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

    def _dense_step(self, state: TrainState, users, anime, ratings, weights, lr):
        """Dense Adam (the one-device train_step) on the local parts."""
        model, adam = state.model, state.adam
        params = [getattr(model, k) for k in PARAM_KEYS]
        loss, mse, (mean, var) = self._data_loss(model, users, anime, ratings, weights)
        grads = dict(zip(PARAM_KEYS, torch.autograd.grad(loss / self._n_batch, params)))
        reg = self._reg_sum(model)
        grads = self._finish_grads(grads, model)
        t = adam.count + 1
        bc1, bc2 = bias_corrections(t)
        with torch.no_grad():
            for k, p in zip(PARAM_KEYS, params):
                g = grads[k]
                mu, nu = adam.mu[k], adam.nu[k]
                mu.mul_(B1).add_(g * (1 - B1))
                nu.mul_(B2).add_(torch.square(g) * (1 - B2))
                p.sub_((mu / bc1) / (torch.sqrt(nu / bc2) + KERAS_ADAM_EPS) * lr)
            self._new_bn(model, mean, var)
        adam.count = t
        return state, loss.detach() + reg, mse.detach()

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

    def _lazy_step(self, state: TrainState, users, anime, ratings, weights, lr, plans=None):
        """Row-sparse Adam on the routed path (train/lazy.py semantics): the
        owners update the rows each round delivers. The loss excludes L2."""
        model, adam = state.model, state.adam
        m = self._n_shards
        loss, mse, (mean, var), d_u, d_a, d_head, (cap_u, plan_u), (cap_a, plan_a) = (
            self._routed_forward_grads(model, users, anime, ratings, weights, plans))
        scal = step_row(state, lr)
        with torch.no_grad():
            for k, ids, grad, cap, plan in (("user_emb", users, d_u, cap_u, plan_u),
                                            ("anime_emb", anime, d_a, cap_a, plan_a)):
                rt.route_grads_lazy_adam(
                    getattr(model, k).detach(), adam.mu[k], adam.nu[k], ids, grad, scal,
                    self.l2, n_shards=m, capacity=cap, plan=plan)
            _head_adam(state, d_head, scal)
            self._new_bn(model, mean, var)
        adam.count += 1
        return state, loss, mse

    def _fused_step(self, state: TrainState, users, anime, ratings, weights, lr,
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
        scal = step_row(state, lr)
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
        adam.count += 1
        return state, loss, mse


def build_plans(step: ShardedTrainStep, users_batches, anime_batches, table_rows=None):
    """Every batch's exchange plans, computed before an epoch's steps: one
    all_reduce and one host sync for all their round counts. ``*_batches``:
    this rank's shard of each batch, [nb, B/m]. Returns (plans_u, plans_a),
    lists of plans; for ``fused_adam`` (pass ``table_rows`` = the PADDED
    (n_users, n_anime)) each entry is (plan, receipt order)."""
    if step.routing != "alltoall" or step.optimizer not in ("lazy_adam", "fused_adam"):
        raise ValueError("planned epoch requires routing='alltoall' with a routed "
                         "owner-side optimizer (lazy_adam / fused_adam)")
    m = step._n_shards
    fused = step.optimizer == "fused_adam"
    if fused and table_rows is None:
        raise ValueError("build_plans needs table_rows=(n_users_padded, n_anime_padded) "
                         "for fused_adam (receipt-order precompute)")
    caps = [step.batch_capacity(b.shape[1]) for b in (users_batches, anime_batches)]
    tables = rt.make_plans((users_batches, anime_batches), m, caps)
    if not fused:
        return tuple(tables)
    for label, rows in zip(("n_users", "n_anime"), table_rows):
        if rows % m:
            raise ValueError(f"table_rows {label}={rows} not divisible by the world size {m}: "
                             "pass the PADDED row counts")
    out = []
    for batches, plans, cap, rows in zip((users_batches, anime_batches), tables, caps,
                                         table_rows):
        out.append([(plan, rt.receipt_sort_order(ids, n_shards=m, capacity=cap,
                                                 r_local=rows // m, plan=plan))
                    for ids, plan in zip(batches, plans)])
    return tuple(out)
