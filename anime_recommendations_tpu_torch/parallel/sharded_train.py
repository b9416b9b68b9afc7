"""Sharded training step: row-striped tables over the ranks of a process group.

Counterpart of anime_recommendations_tpu/parallel/sharded_train.py, routing
``"alltoall"`` (the production path). Every rank runs this code on its own
batch shard:

  * batch       : split over the whole world (rank r takes shard r)
  * user table  : striped over the whole world (parallel/routing.py)
  * anime table : likewise
  * head + BN   : replicated, and kept equal by summing their gradients

Lookups go through routing's all-to-all exchange; the gradients of the
exchanged rows travel back to the owning rank, so no dense table gradient
crosses the wire. ``routing="psum"`` and ``shard_anime`` (the JAX package's
legacy comparison path) are not ported: ROADMAP.md Queue 1.

Gradients through collectives. JAX differentiates the psum'd loss under
shard_map; here each rank differentiates its copy of the replicated loss.
``all_reduce_sum`` is an all-reduce whose backward all-reduces the
cotangent, which makes the rank-local gradients those of the SUM of the m
copies of the loss. The backward pass therefore starts from loss / m, which
gives every exchanged row its exact gradient, and the head's gradients (the
local partials of a replicated leaf) are summed over the ranks once. BatchNorm
uses GLOBAL batch statistics (weighted moments over the whole batch), so the
step is the one-device step's math at any world size.

The Keras L2 term is added analytically, 2*l2*W on the local stripe: each
row has one copy, on its owner. The reported loss of ``adam`` and
``fused_adam`` includes its value over both full tables.

Collectives per step (every rank, in the same order): the exchange's
all-to-alls (2 per round per table forward; 2 per round backward for
``adam``, 2 per round in the gradient routing otherwise), 3 all-reduces of
the forward and their 3 in the backward, 1 for the head's gradients and 1
for the L2 value (``adam``, ``fused_adam``). Host syncs: 1 per table per step
for the plans of an unplanned step (none at one rank with the default
capacity), 1 per epoch for a planned epoch (``build_plans``), and 1 per
round per table for ``lazy_adam``'s receipts.
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
from anime_recommendations_tpu_torch.train.trainer import (
    B1,
    B2,
    KERAS_ADAM_EPS,
    TABLE_KEYS,
    AdamState,
    TrainState,
    _keep_bn,
    bias_corrections,
)

OPTIMIZERS = ("adam", "lazy_adam", "fused_adam")


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward pass sums the cotangents too."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of x over the ranks (module docstring)."""
    return _AllReduceSum.apply(x)


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


# ---- state placement ------------------------------------------------------------


def place_state(state: TrainState, world: World) -> TrainState:
    """This rank's part of a LOGICAL-order TrainState (any device): stripe
    ``rank`` of every table and table moment (rows rank, rank + m, ...), and
    the head, BatchNorm statistics and head moments whole, on world.device.
    Table rows must already be padded to a multiple of the world size
    (parallel.mesh.pad_rows_for_shards)."""
    m, r, dev = world.size, world.rank, world.device
    model = state.model
    n_users, d = model.user_emb.shape
    n_anime = model.anime_emb.shape[0]
    for n in (n_users, n_anime):
        if n % m:
            raise ValueError(f"table rows {n} not a multiple of the world size {m}")
    local = TwoTower(n_users // m, n_anime // m, d, device=dev)

    def part(k, t):
        t = t.detach()
        return (t[r::m] if k in TABLE_KEYS else t).to(dev).contiguous()

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


def _gather_rows(t: torch.Tensor, m: int) -> torch.Tensor:
    """The logical [m * R, D] table of every rank's stripe [R, D]."""
    if m == 1:
        return t.detach().clone()
    parts = [torch.empty_like(t, dtype=torch.float32) for _ in range(m)]
    dist.all_gather(parts, t.detach().float().contiguous())
    return torch.stack(parts, dim=1).reshape(-1, t.shape[1]).to(t.dtype)


def unstripe_state(state: TrainState, world: World) -> TrainState:
    """Every rank's stripes gathered into a LOGICAL-order TrainState, on
    every rank (collective), on world.device."""
    m = world.size
    model = state.model
    user, anime = (_gather_rows(getattr(model, k), m) for k in TABLE_KEYS)
    full = TwoTower(user.shape[0], anime.shape[0], user.shape[1], device=world.device)
    with torch.no_grad():
        full.user_emb.copy_(user)
        full.anime_emb.copy_(anime)
        for k in HEAD_KEYS:
            getattr(full, k).copy_(getattr(model, k))
        full.moving_mean.copy_(model.moving_mean)
        full.moving_var.copy_(model.moving_var)

    def whole(moments):
        return {k: _gather_rows(v, m) if k in TABLE_KEYS else v.detach().clone()
                for k, v in moments.items()}

    adam = state.adam
    return TrainState(model=full.train(), adam=AdamState(
        count=adam.count, mu=whole(adam.mu), nu=whole(adam.nu)))


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
        if routing != "alltoall" or shard_anime:
            raise NotImplementedError(
                "routing='psum' and shard_anime (the legacy comparison path) are not "
                "ported yet: ROADMAP.md Queue 1 parallel/")
        self.world = world
        self.l2 = float(l2_reg_factor)
        self.routing = routing
        self.optimizer = optimizer
        # Per-(sender, owner) all-to-all slot count; None = default_capacity.
        self.capacity = capacity
        self._n_shards = world.size

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
        u_rows = self._lookup(model.user_emb, users)
        a_rows = self._lookup(model.anime_emb, anime)
        pred, _ = self._head(model.head_params(), cosine_merge(u_rows, a_rows), weights,
                             (bn_state.moving_mean, bn_state.moving_var))
        sums = _all_reduce(torch.stack([
            torch.sum(weights), torch.sum(bce(pred, ratings) * weights),
            torch.sum(torch.square(pred - ratings) * weights), self._local_sumsq(model)]))
        w_sum, loss_sum, mse_sum, sumsq = sums.unbind()
        return loss_sum + self.l2 * sumsq * w_sum, mse_sum, w_sum

    def grads(self, state: TrainState, users, anime, ratings, weights) -> dict[str, torch.Tensor]:
        """The exact global gradient of every parameter (head summed over
        the ranks, analytic L2 added), before any optimizer transform. The
        table gradients are this rank's stripes."""
        model = state.model
        params = [getattr(model, k) for k in PARAM_KEYS]
        loss, _, _ = self._data_loss(model, users, anime, ratings, weights)
        grads = dict(zip(PARAM_KEYS, torch.autograd.grad(loss / self._n_shards, params)))
        return self._finish_grads(grads, model)

    def batch_capacity(self, batch_per_device: int) -> int:
        """The slot count of a batch shard of this size."""
        if self.capacity is not None:
            return max(1, min(batch_per_device, self.capacity))
        return rt.default_capacity(batch_per_device, self._n_shards)

    # ---- forward / loss -----------------------------------------------------------

    def _lookup(self, table_local, ids):
        return rt.exchange_rows(table_local, ids, n_shards=self._n_shards,
                                capacity=self.batch_capacity(ids.shape[0]))

    def _global_weighted_moments(self, z, w):
        """Weighted batch mean and variance over the global batch, and the
        global weight (at least 1)."""
        s = all_reduce_sum(torch.stack([torch.sum(w), torch.sum(z * w)]))
        denom = torch.clamp_min(s[0], 1.0)
        mean = s[1] / denom
        var = all_reduce_sum(torch.sum(torch.square(z - mean) * w)) / denom
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
            torch.sum(torch.square(pred - ratings) * weights)]))
        return s[0] / denom, s[1] / denom, (mean.detach(), var.detach())

    def _data_loss(self, model, users, anime, ratings, weights):
        u_rows = self._lookup(model.user_emb, users)
        a_rows = self._lookup(model.anime_emb, anime)
        return self._loss_from_rows(u_rows, a_rows, model.head_params(), ratings, weights)

    def _local_sumsq(self, model) -> torch.Tensor:
        return torch.sum(torch.square(model.user_emb.detach())) + torch.sum(
            torch.square(model.anime_emb.detach()))

    def _finish_grads(self, grads: dict, model) -> dict:
        """Sum the head's gradients over the ranks and add 2*l2*W to the
        tables'."""
        head = _all_reduce(torch.stack([grads[k] for k in HEAD_KEYS]))
        grads.update(zip(HEAD_KEYS, head.unbind()))
        for k in TABLE_KEYS:
            grads[k] = grads[k] + 2.0 * self.l2 * getattr(model, k).detach()
        return grads

    @staticmethod
    def _new_bn(model, mean, var):
        _keep_bn(model, BNState(
            moving_mean=model.moving_mean * KERAS_BN_MOMENTUM + mean * (1.0 - KERAS_BN_MOMENTUM),
            moving_var=model.moving_var * KERAS_BN_MOMENTUM + var * (1.0 - KERAS_BN_MOMENTUM)))

    # ---- steps --------------------------------------------------------------------

    def _dense_step(self, state: TrainState, users, anime, ratings, weights, lr):
        """Dense Adam (the one-device train_step) on the local stripes."""
        model, adam = state.model, state.adam
        params = [getattr(model, k) for k in PARAM_KEYS]
        loss, mse, (mean, var) = self._data_loss(model, users, anime, ratings, weights)
        grads = dict(zip(PARAM_KEYS, torch.autograd.grad(loss / self._n_shards, params)))
        reg = self.l2 * _all_reduce(self._local_sumsq(model))
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

    def _head_adam(self, state: TrainState, d_head, t: int, lr: float) -> None:
        """Ordinary Adam on the four head scalars, in place."""
        from anime_recommendations_tpu_torch.train.lazy import _scalar_adam

        model, adam = state.model, state.adam
        bc1, bc2 = bias_corrections(t)
        for k, g in zip(HEAD_KEYS, d_head):
            p, adam.mu[k], adam.nu[k] = _scalar_adam(
                getattr(model, k), adam.mu[k], adam.nu[k], g, bc1, bc2, lr)
            getattr(model, k).copy_(p)

    def _lazy_step(self, state: TrainState, users, anime, ratings, weights, lr, plans=None):
        """Row-sparse Adam on the routed path (train/lazy.py semantics): the
        owners update the rows each round delivers. The loss excludes L2."""
        model, adam = state.model, state.adam
        m = self._n_shards
        loss, mse, (mean, var), d_u, d_a, d_head, (cap_u, plan_u), (cap_a, plan_a) = (
            self._routed_forward_grads(model, users, anime, ratings, weights, plans))
        t = adam.count + 1
        with torch.no_grad():
            for k, ids, grad, cap, plan in (("user_emb", users, d_u, cap_u, plan_u),
                                            ("anime_emb", anime, d_a, cap_a, plan_a)):
                rt.route_grads_lazy_adam(
                    getattr(model, k).detach(), adam.mu[k], adam.nu[k], ids, grad, t, lr,
                    self.l2, n_shards=m, capacity=cap, plan=plan)
            self._head_adam(state, d_head, t, lr)
            self._new_bn(model, mean, var)
        adam.count = t
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
        t = adam.count + 1
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
                    w, adam.mu[k], adam.nu[k], oid, og, t, lr, l2=self.l2, b1=B1, b2=B2,
                    eps=KERAS_ADAM_EPS, dense_grad=dense, order=order)
                sumsq.append(s)
            loss = loss + self.l2 * _all_reduce(sumsq[0] + sumsq[1])
            self._head_adam(state, d_head, t, lr)
            self._new_bn(model, mean, var)
        adam.count = t
        return state, loss, mse


def build_plans(step: ShardedTrainStep, users_batches, anime_batches, table_rows=None):
    """Every batch's exchange plans, computed before an epoch's steps: one
    all_reduce and one host sync for all their round counts. ``*_batches``:
    this rank's shard of each batch, [nb, B/m]. Returns (plans_u, plans_a),
    lists of plans; for ``fused_adam`` (pass ``table_rows`` = the PADDED
    (n_users, n_anime)) each entry is (plan, receipt order)."""
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
