"""All-to-all embedding-row routing for tables sharded over the ranks.

Counterpart of anime_recommendations_tpu/parallel/routing.py, on
torch.distributed: each rank of the default process group holds one stripe
of a table and its own shard of the batch; ``jax.lax.all_to_all`` becomes
``dist.all_to_all_single`` on contiguous [m*C] / [m*C, D] buffers with equal
splits, and ``pmax`` an ``all_reduce`` with MAX.

Layout: MOD-STRIPED. Global row g lives on rank ``g % m`` at local row
``g // m``, so popular low ids spread over the ranks. ``to_physical``
permutes a table so that a contiguous split into m blocks realizes the
striping; rank r's block is ``table[r::m]``.

Exchange protocol (exact for any multiset of ids >= 0; ids past the table
give zero rows and no gradient):
  1. sort the local ids by (owner, id); duplicate ids are requested once;
  2. bucket the unique ids by owner; per round, each (sender, owner) bucket
     sends up to ``capacity`` ids with one all-to-all, owners gather their
     rows and send them straight back with another;
  3. rounds = max over the ranks of ceil(largest bucket / capacity); every
     rank must run the same collectives in the same order, or NCCL hangs.
     The loops run on the host, so a loop's trip count is a host number:
     ``make_plan`` reads the batch's count with one all_reduce and one host
     sync (none at one rank with a capacity of the whole batch, where it is
     1). ``stack_plans`` plans many batches on the device with one
     all_reduce and no host read, and ``round_maxima`` reads the largest
     count of each table once: a planned epoch runs every exchange for that
     static count, and the rounds past a batch's own count are exact no-ops
     (request ids -1, drop-marker receipts with zero gradients, no lazy
     update, the same receipt order), which is what lets a CUDA graph
     capture the epoch;
  4. responses land in a per-unique-id buffer, and one gather by the plan's
     head ranks (seg_orig) fills duplicates and restores batch order.

The backward pass (``exchange_rows``, an autograd Function: JAX's custom
VJP) routes per-unique-id gradient sums back to the owner over the same
plan, which adds them into its local table gradient. ``route_grad_rows``
does the same for the fused optimizer without a dense table gradient: the
first ``staged_rounds`` rounds come back as receipts (local id, gradient
row) and later rounds as a dense [R, D] overflow gradient, which K1 adds in
(ops/fused_adam.sparse_adam_update ``dense_grad``).

Gradient sums over duplicate ids (``_unique_grad_sums``, the backward's and
the overflow's scatter) add each row's terms in a fixed order on either
device (``_scatter_sum``), so a routed step gives the same bits at every
run.

Departures from the JAX package: the plan's sort and ``receipt_sort_order``
are stable argsorts, so K1 with a precomputed receipt order equals K1
without it bit for bit; the round loops run a count fixed on the host, not
a device loop's (above).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


# ---- mod-striped layout ---------------------------------------------------------


def owner_of(ids: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Rank owning each global row id."""
    return torch.fmod(ids, n_shards)


def local_of(ids: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Local row index of each global id on its owning rank."""
    return torch.div(ids, n_shards, rounding_mode="trunc")


def to_physical(table, n_shards: int):
    """Permute [N, D] rows (numpy or torch) so a contiguous split into
    n_shards blocks is the mod striping: block s holds global rows
    {s, s+m, s+2m, ...} as local rows {0, 1, 2, ...}. N must be a multiple
    of n_shards (parallel.mesh.pad_rows_for_shards)."""
    n, d = table.shape
    assert n % n_shards == 0, (n, n_shards)
    return _swap01(table.reshape(n // n_shards, n_shards, d)).reshape(n, d)


def from_physical(table, n_shards: int):
    """Inverse of to_physical (physical row order -> global id order)."""
    n, d = table.shape
    assert n % n_shards == 0, (n, n_shards)
    return _swap01(table.reshape(n_shards, n // n_shards, d)).reshape(n, d)


def _swap01(x):
    return x.transpose(0, 1) if isinstance(x, torch.Tensor) else x.swapaxes(0, 1)


def pad_sentinel(n_rows_padded: int, n_shards: int, shard: int) -> int:
    """A global id that rank ``shard`` treats as locally out of bounds:
    owner_of(sentinel) == shard and local_of(sentinel) == R (one past the
    local table), so padding rows gather zeros and update nothing."""
    assert n_rows_padded % n_shards == 0
    return n_rows_padded + shard


def default_capacity(batch_per_device: int, n_shards: int) -> int:
    """Per-(sender, owner) slot count: 2x the uniform expectation with a
    floor of 8, capped at the batch itself (a sender never has more unique
    ids in a bucket than its whole batch). One round is then the steady
    state."""
    want = max(8, 2 * (-(-batch_per_device // n_shards)))
    return max(1, min(batch_per_device, want))


# ---- collectives ----------------------------------------------------------------


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Equal-split all-to-all over dim 0 of x [m, ...]: out[s] is what rank s
    sent this rank (its x[rank]), as jax.lax.all_to_all(x, axis, 0, 0)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous())
    return out


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


# ---- exchange plan (shared by forward and backward) -----------------------------


class _Plan(NamedTuple):
    seg_orig: torch.Tensor  # [B] int64 head rank of each ORIGINAL batch position
    uids: torch.Tensor      # [B] int64 unique id per head rank (tail: 0)
    hoff: torch.Tensor      # [m] int64 first head rank per owner
    hcnt: torch.Tensor      # [m] int64 unique ids per owner
    rounds: int             # rounds the loops run, the same on every rank: the
                            # batch's own count or more (the extra ones no-ops)


class Plans(NamedTuple):
    """Every batch's plan of one table, stacked over the batches."""

    seg_orig: torch.Tensor  # [nb, B]
    uids: torch.Tensor      # [nb, B]
    hoff: torch.Tensor      # [nb, m]
    hcnt: torch.Tensor      # [nb, m]
    rounds: torch.Tensor    # [nb] int64 on the device: each batch's own count

    def select(self, idx) -> "Plans":
        """The plans of batches ``idx`` (a slice, or a device index tensor)."""
        return Plans(*(x[idx] for x in self))


def _sort_key(ids: torch.Tensor, n_shards: int) -> torch.Tensor:
    """int64 key ordering by (owner, id)."""
    if n_shards == 1:
        return ids
    return owner_of(ids, n_shards) * (2 ** 32) + local_of(ids, n_shards)


def _plan_parts(ids: torch.Tensor, n_shards: int) -> tuple[torch.Tensor, ...]:
    """(seg_orig, uids, hoff, hcnt) of each batch of ids [..., B] (over the
    last dimension): local work, no collective, no host read."""
    m = n_shards
    ids = ids.long()
    order = torch.argsort(_sort_key(ids, m), dim=-1, stable=True)
    ids_s = ids.gather(-1, order)
    is_start = torch.ones_like(ids_s, dtype=torch.bool)
    is_start[..., 1:] = ids_s[..., 1:] != ids_s[..., :-1]
    seg = torch.cumsum(is_start, -1) - 1                  # [..., B] head rank per element
    seg_orig = torch.empty_like(seg).scatter_(-1, order, seg)
    uids = torch.zeros_like(ids).scatter_(-1, seg, ids_s)   # equal ids: equal values
    owner_s = torch.where(is_start, owner_of(ids_s, m), m)
    hcnt = torch.zeros(*ids.shape[:-1], m + 1, dtype=torch.long, device=ids.device)
    hcnt = hcnt.scatter_add_(-1, owner_s, torch.ones_like(owner_s))[..., :m]
    hoff = torch.cumsum(hcnt, -1) - hcnt
    return seg_orig, uids, hoff, hcnt


def _need(hcnt: torch.Tensor, capacity: int) -> torch.Tensor:
    """Rounds each batch's own buckets need (hcnt [..., m])."""
    return torch.div(hcnt.amax(-1) + capacity - 1, capacity, rounding_mode="floor")


def make_plan(ids: torch.Tensor, n_shards: int, capacity: int) -> _Plan:
    """The exchange plan of one batch shard, for sharing between
    exchange_rows, route_grad_rows and route_grads_lazy_adam. Collective:
    every rank calls it with the same n_shards and capacity. Reads the round
    count on the host."""
    parts = _plan_parts(ids, n_shards)
    b = ids.shape[0]
    if n_shards == 1 and capacity >= b:
        rounds = int(b > 0)            # every unique id fits one round
    else:
        rounds = int(all_reduce_max(_need(parts[3], capacity)))
    return _Plan(*parts, rounds)


def stack_plans(ids_tables, n_shards: int, capacities) -> list[Plans]:
    """The plans of many batch shards of several tables at once, on the
    device: ``ids_tables`` holds one [nb, B] tensor of batch shards per table
    (the same nb), ``capacities`` one slot count per table. One all_reduce
    MAX for every round count; no host read. Collective."""
    parts = [_plan_parts(ids, n_shards) for ids in ids_tables]
    needs = torch.stack([_need(p[3], cap) for p, cap in zip(parts, capacities)])
    return [Plans(*p, r) for p, r in zip(parts, all_reduce_max(needs).unbind())]


def round_maxima(plans) -> tuple[int, ...]:
    """The largest round count of each table's Plans: ONE host read."""
    return tuple(int(r) for r in torch.stack([p.rounds.amax() for p in plans]).tolist())


def plan_at(plans: Plans, i, rounds: int) -> _Plan:
    """Batch i's plan, its loops run for ``rounds`` (>= its own count)."""
    return _Plan(plans.seg_orig[i], plans.uids[i], plans.hoff[i], plans.hcnt[i], rounds)


def _scatter_sum(out: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] += rows[i], each row's terms summed in index order on
    either device (module docstring): on the CPU index_add_ (a serial loop
    over the ids), on the card the accumulating index_put_ (it sorts the
    ids, where index_add_ adds in atomics' order). The ids are in range by
    construction, so the card takes index_put_'s unchecked form (autograd's
    index backward), which reads no bound on the host."""
    if out.is_cuda:
        return torch.ops.aten._index_put_impl_(out, (idx,), rows, True, True)
    return out.index_add_(0, idx, rows)


def _unique_grad_sums(g_rows: torch.Tensor, plan: _Plan, b: int) -> torch.Tensor:
    """[B, D] per-unique-id gradient sums indexed by head rank."""
    return _scatter_sum(torch.zeros(b, g_rows.shape[1], dtype=g_rows.dtype,
                                    device=g_rows.device), plan.seg_orig, g_rows)


def _send_slot_ids(plan: _Plan, r: int, capacity: int, m: int):
    """(send_ids [m, C], slot_pos [m, C]): round-r request ids per owner and
    the head rank each response row belongs to; invalid slots have id -1 and
    the distinct positions B + lane (past the batch)."""
    b = plan.uids.shape[0]
    dev = plan.uids.device
    k = r * capacity + torch.arange(capacity, device=dev)[None, :]   # [1, C]
    pos = plan.hoff[:, None] + k                                      # [m, C]
    valid = k < plan.hcnt[:, None]
    send_ids = torch.where(valid, plan.uids[pos.clamp(0, b - 1)], -1)
    lane = torch.arange(m * capacity, device=dev).view(m, capacity)
    return send_ids, torch.where(valid, pos, b + lane)


def _receive(recv_ids: torch.Tensor, m: int, r_local: int):
    """(local ids, ok) of received request ids; ok marks ids this rank owns
    inside its table."""
    lid = local_of(recv_ids.clamp_min(0), m)
    return lid, (recv_ids >= 0) & (lid < r_local)


def _send_grads(ugrad: torch.Tensor, slot_pos: torch.Tensor) -> torch.Tensor:
    b = ugrad.shape[0]
    rows = ugrad[slot_pos.clamp(max=b - 1)]
    return torch.where((slot_pos < b)[..., None], rows, 0.0)           # [m, C, D]


# ---- the exchange -----------------------------------------------------------------


def _planned_gather(table_local: torch.Tensor, ids: torch.Tensor, plan: _Plan | None,
                    m: int, cap: int) -> torch.Tensor:
    """The exchange forward pass for a given plan: round-looped all-to-all
    requests and responses, then one gather back to batch order. At m == 1
    every id is local and the exchange is ``table_local[ids]`` (zeros
    outside the table), with no plan."""
    b = ids.shape[0]
    r_local, d = table_local.shape
    if m == 1:
        ok = (ids >= 0) & (ids < r_local)
        rows = table_local[ids.long().clamp(0, r_local - 1)]
        return torch.where(ok[:, None], rows, 0.0)
    uresp = torch.zeros(b + m * cap, d, dtype=table_local.dtype, device=table_local.device)
    for r in range(plan.rounds):
        send_ids, slot_pos = _send_slot_ids(plan, r, cap, m)
        lid, ok = _receive(all_to_all(send_ids), m, r_local)
        rows = torch.where(ok[..., None], table_local[lid.clamp(max=r_local - 1)], 0.0)
        resp = all_to_all(rows)                                            # [m, C, D]
        uresp.index_copy_(0, slot_pos.reshape(-1), resp.reshape(-1, d))
    return uresp[plan.seg_orig]


class _Exchange(torch.autograd.Function):
    """exchange_rows with its reverse routing as the backward pass."""

    @staticmethod
    def forward(ctx, table_local, ids, m, cap, plan):
        if m == 1:
            plan = None
        elif plan is None:
            plan = make_plan(ids, m, cap)
        ctx.save_for_backward(ids)
        ctx.plan, ctx.m, ctx.cap, ctx.r_local = plan, m, cap, table_local.shape[0]
        return _planned_gather(table_local.detach(), ids, plan, m, cap)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        m, cap, r_local, plan = ctx.m, ctx.cap, ctx.r_local, ctx.plan
        b, d = g.shape
        # One spare row past the table takes every dropped contribution.
        d_table = torch.zeros(r_local + 1, d, dtype=g.dtype, device=g.device)
        if m == 1:
            ok = (ids >= 0) & (ids < r_local)
            _scatter_sum(d_table, torch.where(ok, ids.long(), r_local), g)
            return d_table[:r_local], None, None, None, None
        ugrad = _unique_grad_sums(g, plan, b)
        for r in range(plan.rounds):
            send_ids, slot_pos = _send_slot_ids(plan, r, cap, m)
            lid, ok = _receive(all_to_all(send_ids), m, r_local)
            recv_g = all_to_all(_send_grads(ugrad, slot_pos))
            _scatter_sum(d_table, torch.where(ok, lid, r_local).reshape(-1),
                         recv_g.reshape(-1, d))
        return d_table[:r_local], None, None, None, None


def exchange_rows(table_local: torch.Tensor, ids: torch.Tensor, *, n_shards: int,
                  capacity: int, plan: _Plan | None = None) -> torch.Tensor:
    """Rows [B, D] of a table striped over the ranks for any ids of this
    rank's batch shard (ids past the table give zero rows). Differentiable
    with respect to table_local: the backward pass routes the gradient sums
    home. Collective: every rank calls it. Without ``plan`` it makes one
    (make_plan: a host read of the round count)."""
    return _Exchange.apply(table_local, ids, n_shards, capacity, plan)


def exchange_rows_planned(table_local: torch.Tensor, ids: torch.Tensor, plan: _Plan, *,
                          n_shards: int, capacity: int) -> torch.Tensor:
    """exchange_rows' forward pass with a given plan, not
    differentiable: for the steps that take gradients with respect to the
    returned rows and route them home themselves (route_grad_rows,
    route_grads_lazy_adam with the same plan)."""
    with torch.no_grad():
        return _planned_gather(table_local, ids, plan, n_shards, capacity)


def received_rows(table_local: torch.Tensor, ids: torch.Tensor, *, n_shards: int,
                  capacity: int, owner_capacity: int) -> torch.Tensor:
    """Owner-side view of one exchange: [owner_capacity] local ids of the
    rows this rank would serve for the global batch (deduplicated per
    requester), the rest r_local. Rounds past owner_capacity / (n_shards *
    capacity) are dropped: size owner_capacity generously."""
    m, cap = n_shards, capacity
    plan = make_plan(ids, m, cap)
    r_local = table_local.shape[0]
    n_rounds_fit = owner_capacity // (m * cap)
    buf = torch.full((owner_capacity + m * cap,), r_local, dtype=torch.long,
                     device=table_local.device)
    for r in range(plan.rounds):
        send_ids, _ = _send_slot_ids(plan, r, cap, m)
        lid, ok = _receive(all_to_all(send_ids), m, r_local)
        # As in JAX: a round past the fit writes markers over round r % fit.
        base = (r % max(n_rounds_fit, 1)) * m * cap
        keep = ok & (r < n_rounds_fit)
        buf[base:base + m * cap] = torch.where(keep, lid, r_local).reshape(-1)
    return buf[:owner_capacity]


def route_grads_lazy_adam(
    w: torch.Tensor,        # [R, D] local stripe, updated in place
    mu: torch.Tensor,       # [R, D]
    nu: torch.Tensor,       # [R, D]
    ids: torch.Tensor,      # [B] global ids this rank looked up
    g_rows: torch.Tensor,   # [B, D] gradients w.r.t. the exchanged rows
    scal: torch.Tensor,     # [4] the step's row (train/trainer.step_row)
    l2: float,
    *,
    n_shards: int,
    capacity: int,
    plan: _Plan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reverse of exchange_rows for row-sparse Adam: per-unique-id gradient
    sums travel to the owner, which applies lazy Adam (train/lazy.py) to
    exactly the rows each round delivers. Exact lazy Adam in the one-round
    steady state; a row served in two rounds gets two smaller updates (as in
    JAX). Every shape is fixed by the batch and the capacity: a round's
    undelivered slots take row 0 with a zero gradient and are dropped in
    lazy_row_adam (``keep``), which writes back the rows no delivered slot
    touches, so no round reads a count on the host."""
    from anime_recommendations_tpu_torch.train.lazy import lazy_row_adam

    m, cap = n_shards, capacity
    if plan is None:
        plan = make_plan(ids, m, cap)
    b = ids.shape[0]
    r_local, d = w.shape
    ugrad = _unique_grad_sums(g_rows, plan, b)
    for r in range(plan.rounds):
        send_ids, slot_pos = _send_slot_ids(plan, r, cap, m)
        lid, ok = _receive(all_to_all(send_ids), m, r_local)
        recv_g = all_to_all(_send_grads(ugrad, slot_pos))
        lazy_row_adam(w, mu, nu, torch.where(ok, lid, 0).reshape(-1), recv_g.reshape(-1, d),
                      scal, l2, keep=ok.reshape(-1))
    return w, mu, nu


def staged_round_count(b: int, capacity: int, max_rounds: int | None = None,
                       staged_rounds: int = 4) -> int:
    """Rounds of route_grad_rows that land in its staged receipts for a [b]
    batch (max_rounds defaults to ceil(b / capacity))."""
    if max_rounds is None:
        max_rounds = -(-b // capacity)
    return min(max_rounds, staged_rounds)


def receipt_slots(b: int, n_shards: int, capacity: int, max_rounds: int | None = None,
                  staged_rounds: int = 4) -> int:
    """Staged receipt-buffer size T of route_grad_rows for a [b] batch."""
    return staged_round_count(b, capacity, max_rounds, staged_rounds) * n_shards * capacity


def receipt_sort_order(
    ids: torch.Tensor,
    *,
    n_shards: int,
    capacity: int,
    r_local: int,
    max_rounds: int | None = None,
    staged_rounds: int = 4,
    plan: _Plan | None = None,
) -> torch.Tensor:
    """The STABLE argsort [T] of route_grad_rows' owner-side receipt ids: a
    function of every rank's plan, so a planned epoch computes it before its
    steps and K1 skips its per-step argsort. Runs the id-only half of the
    exchange (drop markers r_local sort last). Must be called with the
    capacity, max_rounds and staged_rounds the step will use."""
    m, cap = n_shards, capacity
    staged = staged_round_count(ids.shape[0], cap, max_rounds, staged_rounds)
    if plan is None:
        plan = make_plan(ids, m, cap)
    oid = torch.full((staged * m * cap,), r_local, dtype=torch.long, device=ids.device)
    # Rounds past the staged ones write no receipt: every rank skips them.
    for r in range(min(plan.rounds, staged)):
        send_ids, _ = _send_slot_ids(plan, r, cap, m)
        lid, ok = _receive(all_to_all(send_ids), m, r_local)
        oid[r * m * cap:(r + 1) * m * cap] = torch.where(ok, lid, r_local).reshape(-1)
    return torch.argsort(oid, stable=True)


def route_grad_rows(
    ids: torch.Tensor,      # [B] global ids this rank looked up
    g_rows: torch.Tensor,   # [B, D] gradients w.r.t. the exchanged rows
    *,
    n_shards: int,
    capacity: int,
    r_local: int,           # rows of the receiving rank's local table
    max_rounds: int | None = None,
    staged_rounds: int = 4,
    plan: _Plan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Reverse of exchange_rows with no optimizer in it: routes per-unique-id
    gradient sums to the owners and returns ``(local_ids [T] int64, grads
    [T, D], dense_overflow [R, D] | None)`` with T = min(max_rounds,
    staged_rounds) * n_shards * capacity.

    Undelivered slots carry the drop marker r_local and zero gradients, so
    a scatter-add consumer (K1) ignores them. Receipts of every round are
    there before one optimizer application, so the result is exact dense
    Adam under any overflow. Rounds at or past ``staged_rounds`` add into
    the dense overflow gradient instead of the receipts; it is None whenever
    every possible round fits the staged buffer. ``max_rounds`` defaults to
    ceil(B / capacity), so no round is dropped; a smaller one drops the
    rounds past it. At one rank with T >= B the receipts are built with no
    exchange: the same slot layout (head-rank order) the loop gives."""
    m, cap = n_shards, capacity
    b, d = g_rows.shape
    if max_rounds is None:
        max_rounds = -(-b // cap)
    staged = min(max_rounds, staged_rounds)
    has_overflow = max_rounds > staged
    if plan is None:
        plan = make_plan(ids, m, cap)
    ugrad = _unique_grad_sums(g_rows, plan, b)
    t_slots = staged * m * cap
    dev = g_rows.device
    oid = torch.full((t_slots,), r_local, dtype=torch.long, device=dev)
    og = torch.zeros(t_slots, d, dtype=g_rows.dtype, device=dev)
    if m == 1 and t_slots >= b:
        k = torch.arange(b, device=dev)
        lid = plan.uids
        valid = (k < plan.hcnt[0]) & (lid >= 0) & (lid < r_local)
        oid[:b] = torch.where(valid, lid, r_local)
        og[:b] = torch.where(valid[:, None], ugrad, 0.0)
        return oid, og, None
    dense = (torch.zeros(r_local + 1, d, dtype=g_rows.dtype, device=dev)
             if has_overflow else None)
    for r in range(min(plan.rounds, max_rounds)):
        send_ids, slot_pos = _send_slot_ids(plan, r, cap, m)
        lid, ok = _receive(all_to_all(send_ids), m, r_local)
        recv_g = all_to_all(_send_grads(ugrad, slot_pos)).reshape(-1, d)
        ok = ok.reshape(-1)
        if r < staged:
            sl = slice(r * m * cap, (r + 1) * m * cap)
            oid[sl] = torch.where(ok, lid.reshape(-1), r_local)
            og[sl] = torch.where(ok[:, None], recv_g, 0.0)
        else:
            _scatter_sum(dense, torch.where(ok, lid.reshape(-1), r_local), recv_g)
    return oid, og, (dense[:r_local] if has_overflow else None)


# ---- comm accounting --------------------------------------------------------------


def exchange_comm_bytes(batch_per_device: int, emb_dim: int, n_shards: int, capacity: int,
                        rounds: int = 1, itemsize: int = 4) -> int:
    """Wire bytes per rank per step of the all-to-all exchange: row data out
    and back per round ((m-1)/m of the slots leave the rank), plus the id
    requests."""
    m, c = n_shards, capacity
    cross = (m - 1) * c
    ids_bytes = cross * 4 * rounds
    row_bytes = 2 * cross * emb_dim * itemsize * rounds
    return ids_bytes + row_bytes


def psum_comm_bytes(batch_per_device: int, emb_dim: int, n_shards: int,
                    itemsize: int = 4) -> int:
    """Wire bytes per rank per step of the psum routing: a ring all-reduce of
    the dense [B_local, D] gathered block (send + receive)."""
    return 2 * 2 * (n_shards - 1) * batch_per_device * emb_dim * itemsize // n_shards


def plan_stats(ids, n_shards: int, capacity: int) -> tuple[int, int, int]:
    """(unique_ids, max_bucket, rounds) of one batch shard, on the host, with
    no collective: diagnostics for the trainer's log."""
    ids = np.asarray(ids, np.int64)
    uniq = np.unique(ids)
    if uniq.size == 0:
        return 0, 0, 0
    mx = int(np.bincount(uniq % n_shards, minlength=n_shards).max())
    return int(uniq.size), mx, -(-mx // capacity)
