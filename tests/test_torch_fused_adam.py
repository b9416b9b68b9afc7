"""The port's fused sparse-Adam update (K1) against the JAX package's, on the CPU.

On a CPU tensor ``sparse_adam_update`` runs its plain torch version; the JAX
side runs the Pallas kernel in interpret mode, which it selects by itself off
the TPU (and which turns stochastic rounding off). Inputs come from numpy
seeds. Tolerances: the cases of tests/test_fused_adam.py, with the port's
exact f32 scatter held to 5e-6 against JAX ``precision="highest"`` and to
2e-4 against ``"fast"`` (the TPU's two-pass bf16 scatter); bf16 moments
without stochastic rounding within one bf16 ulp (2^-8 relative: the two
scatters may differ in the last f32 bit, which flips a rounding). With
``next_ids`` (K5) the table outputs equal the call without it bit for bit,
the gathered rows equal the port's own w'[next_ids] exactly (zero rows for
ids outside the table), and they are held to JAX's with the table
tolerances above. With ``dense_grad`` (K1's has_dense branch) the tables are
held to JAX's at the same tolerances; ``order`` (a precomputed stable
argsort) gives the call without it bit for bit.

The stochastic rounding has its own statistical tests: every output is a
bf16 neighbour of its f32 value, the rounding is unbiased, and an EMA of
sub-ulp increments moves under it where rounding to nearest freezes it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_recommendations_tpu.ops.fused_adam import sparse_adam_update as jax_update
from anime_recommendations_tpu_torch.ops import fused_adam

B1, B2, EPS = 0.9, 0.999, 1e-7

torch.set_num_threads(2)


def make_case(n, d, b, seed, dup_heavy=False):
    """Tables and a batch; ``dup_heavy`` True draws ids from the first n/20
    rows, "long_runs" puts runs longer than a kernel tile (TILE sorted
    positions) on rows 0, 3 and n - 1 (the ragged block's last row)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, d)).astype(np.float32) * 0.05
    mu = rng.standard_normal((n, d)).astype(np.float32) * 0.01
    nu = (rng.standard_normal((n, d)).astype(np.float32) * 0.01) ** 2
    hi = max(n // 20, 2) if dup_heavy is True else n
    ids = rng.integers(0, hi, b).astype(np.int32)
    if dup_heavy == "long_runs":
        t = fused_adam.TILE
        hot = np.repeat(np.array([3, 0, n - 1], np.int32), [t + 18, t + 8, t // 2 + 4])
        ids[:hot.shape[0]] = hot
        ids = rng.permutation(ids)
    g = rng.standard_normal((b, d)).astype(np.float32) * 0.1
    return w, mu, nu, ids, g


def port_update(w, mu, nu, ids, g, t, lr, l2, dtype=torch.float32, **kw):
    """The port's update on copies of the numpy inputs; numpy results."""
    tw, tmu, tnu = (torch.from_numpy(x.copy()) for x in (w, mu, nu))
    out = fused_adam.sparse_adam_update(
        tw, tmu.to(dtype), tnu.to(dtype), torch.from_numpy(ids), torch.from_numpy(g),
        t, lr, l2=l2, b1=B1, b2=B2, eps=EPS, **kw)
    assert out[0] is tw  # in place
    return [x.float().numpy() for x in out]


def jax_result(w, mu, nu, ids, g, t, lr, l2, dtype=jnp.float32, **kw):
    out = jax_update(jnp.asarray(w), jnp.asarray(mu).astype(dtype),
                     jnp.asarray(nu).astype(dtype), jnp.asarray(ids), jnp.asarray(g),
                     jnp.asarray(t), jnp.float32(lr), l2=l2, b1=B1, b2=B2, eps=EPS, **kw)
    return [np.asarray(jnp.asarray(x).astype(jnp.float32)) for x in out]


@pytest.mark.parametrize("precision,tol", [("highest", 5e-6), ("fast", 2e-4)])
@pytest.mark.parametrize("dup_heavy", [False, True, "long_runs"])
def test_plain_update_matches_jax(precision, tol, dup_heavy):
    case = make_case(300, 32, 128, seed=0, dup_heavy=dup_heavy)
    args = (3, 1e-3, 1e-4)
    got = port_update(*case, *args, precision=precision)
    want = jax_result(*case, *args, block_rows=64, chunk=32, precision=precision)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    np.testing.assert_allclose(got[3], np.sum(np.square(case[0])), rtol=1e-5)


def test_ragged_table_all_ids_on_one_row_at_step_one():
    """N not a block multiple, the first Adam step (strongest bias
    correction), every id on one row (maximal skew)."""
    w, mu, nu, _, g = make_case(100, 16, 64, seed=1)
    mu, nu = np.zeros_like(mu), np.zeros_like(nu)
    ids = np.full(64, 7, np.int32)
    got = port_update(w, mu, nu, ids, g, 1, 1e-2, 0.0)
    want = jax_result(w, mu, nu, ids, g, 1, 1e-2, 0.0, block_rows=32, chunk=16,
                      precision="highest")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)
    # 64 duplicate-row squares: the one-hot matmul and the sequential sum
    # differ in the last f32 bits.
    np.testing.assert_allclose(got[2], want[2], rtol=5e-5, atol=1e-9)
    untouched = np.arange(100) != 7
    np.testing.assert_array_equal(got[0][untouched], w[untouched])  # l2 = 0, g = 0


def test_chained_steps_match_jax():
    w, mu, nu, ids, g = make_case(200, 8, 96, seed=2, dup_heavy=True)
    tw, tmu, tnu = (torch.from_numpy(x.copy()) for x in (w, mu, nu))
    jw, jmu, jnu = map(jnp.asarray, (w, mu, nu))
    for t in range(1, 6):
        fused_adam.sparse_adam_update(tw, tmu, tnu, torch.from_numpy(ids),
                                      torch.from_numpy(g), t, 1e-3, l2=1e-4)
        jw, jmu, jnu, _ = jax_update(jw, jmu, jnu, jnp.asarray(ids), jnp.asarray(g),
                                     jnp.asarray(t), jnp.float32(1e-3), l2=1e-4,
                                     block_rows=64, chunk=32, precision="highest")
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=5e-6, atol=5e-6)
    np.testing.assert_allclose(tnu.numpy(), np.asarray(jnu), rtol=5e-5, atol=1e-9)


@pytest.mark.parametrize("dup_heavy", [False, "long_runs"])
def test_bf16_moments_match_jax_without_stochastic_rounding(dup_heavy):
    case = make_case(300, 32, 128, seed=4, dup_heavy=dup_heavy)
    got = port_update(*case, 3, 1e-3, 1e-4, dtype=torch.bfloat16, stochastic_rounding=False)
    want = jax_result(*case, 3, 1e-3, 1e-4, dtype=jnp.bfloat16, block_rows=64, chunk=32,
                      precision="highest")
    np.testing.assert_allclose(got[1], want[1], rtol=1 / 128, atol=1e-9)
    np.testing.assert_allclose(got[2], want[2], rtol=1 / 128, atol=1e-12)
    np.testing.assert_allclose(got[0], want[0], rtol=5e-6, atol=5e-6)


def test_ids_outside_the_table_contribute_nothing():
    w, mu, nu, ids, g = make_case(64, 8, 32, seed=5)
    bad = np.array([-(2 ** 20), -1, 64, 1000], np.int32)
    got = port_update(w, mu, nu, np.concatenate([ids, bad]),
                      np.concatenate([g, np.ones((4, 8), np.float32)]), 2, 1e-3, 1e-4)
    want = port_update(w, mu, nu, ids, g, 2, 1e-3, 1e-4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_rejects_what_it_does_not_take():
    w, mu, nu, ids, g = (torch.from_numpy(x) for x in make_case(16, 8, 4, seed=6))
    with pytest.raises(NotImplementedError, match="unused combination"):   # as JAX
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 1, 1e-3, next_ids=ids, dense_grad=w)
    with pytest.raises(TypeError):
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 1, 1e-3, next_ids=ids.float())
    with pytest.raises(ValueError):
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 1, 1e-3, dense_grad=w[:8])
    with pytest.raises(ValueError):
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 1, 1e-3, order=torch.argsort(ids)[:2])
    with pytest.raises(ValueError):
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 1, 1e-3, precision="default")
    with pytest.raises(TypeError):
        fused_adam.sparse_adam_update(w, mu, nu.bfloat16(), ids, g, 1, 1e-3)
    with pytest.raises(ValueError):
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 0, 1e-3)


# ---- K1's dense-gradient branch and a precomputed order ----------------------------

def dense_case(seed, dup_heavy=True):
    """make_case's N = 300 (a ragged block of 64), D = 32, 128 ids with
    duplicates, some outside the table (the routed receipts' drop marker n
    and past it), and a dense [N, D] gradient."""
    w, mu, nu, ids, g = make_case(300, 32, 128, seed=seed, dup_heavy=dup_heavy)
    ids[::9] = 300
    ids[5] = 1000
    dense = np.random.default_rng(seed + 50).standard_normal((300, 32)).astype(np.float32) * 0.1
    return (w, mu, nu, ids, g), dense


@pytest.mark.parametrize("precision,tol", [("highest", 5e-6), ("fast", 2e-4)])
@pytest.mark.parametrize("t,l2", [(1, 0.0), (3, 1e-4), (3, "long_runs")])
def test_dense_grad_update_matches_jax(precision, tol, t, l2):
    """(3, "long_runs"): l2 1e-4 with runs longer than a tile."""
    case, dense = dense_case(seed=11, dup_heavy="long_runs" if l2 == "long_runs" else True)
    l2 = 1e-4 if l2 == "long_runs" else l2
    got = port_update(*case, t, 1e-3, l2, precision=precision,
                      dense_grad=torch.from_numpy(dense))
    want = jax_result(*case, t, 1e-3, l2, block_rows=64, chunk=32, precision=precision,
                      dense_grad=jnp.asarray(dense), interpret=True)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    # The dense gradient is the same thing as those rows' scattered grads.
    w, mu, nu, ids, g = case
    all_ids = np.concatenate([ids, np.arange(300, dtype=np.int32)])
    as_rows = port_update(w, mu, nu, all_ids, np.concatenate([g, dense]), t, 1e-3, l2)
    for a, b in zip(got, as_rows):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_dense_grad_bf16_moments_match_jax_without_stochastic_rounding():
    case, dense = dense_case(seed=12)
    kw = dict(dtype=torch.bfloat16, stochastic_rounding=False, dense_grad=torch.from_numpy(dense))
    got = port_update(*case, 3, 1e-3, 1e-4, **kw)
    want = jax_result(*case, 3, 1e-3, 1e-4, dtype=jnp.bfloat16, block_rows=64, chunk=32,
                      precision="highest", dense_grad=jnp.asarray(dense), interpret=True)
    np.testing.assert_allclose(got[1], want[1], rtol=1 / 128, atol=1e-9)
    np.testing.assert_allclose(got[2], want[2], rtol=1 / 128, atol=1e-12)
    np.testing.assert_allclose(got[0], want[0], rtol=5e-6, atol=5e-6)


@pytest.mark.parametrize("with_dense", [False, True])
def test_precomputed_order_gives_the_same_update(with_dense):
    """A stable argsort passed as ``order`` equals the in-call sort bit for
    bit; JAX's update with the same order agrees at its tolerance."""
    case, dense = dense_case(seed=13)
    kw = dict(dense_grad=torch.from_numpy(dense)) if with_dense else {}
    order = np.argsort(case[3], kind="stable")
    got = port_update(*case, 2, 1e-3, 1e-4, order=torch.from_numpy(order), **kw)
    alone = port_update(*case, 2, 1e-3, 1e-4, **kw)
    for a, b in zip(got, alone):
        np.testing.assert_array_equal(a, b)
    jkw = dict(dense_grad=jnp.asarray(dense)) if with_dense else {}
    want = jax_result(*case, 2, 1e-3, 1e-4, block_rows=64, chunk=32, precision="highest",
                      order=jnp.asarray(order.astype(np.int32)), interpret=True, **jkw)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, rtol=5e-6, atol=5e-6)


# ---- K5: the update with the next batch's rows gathered --------------------------

def gather_case(kind):
    """test_pipelined_gather_matches_direct's case (N = 300, a ragged block of
    64, D = 32, 128 ids, 200 next ids); ``dups_outside`` makes most next ids
    repeat and adds ids below 0, in the ragged block's padding and past it."""
    case = make_case(300, 32, 128, seed=4)
    rng = np.random.default_rng(7)
    nids = rng.integers(0, 300, 200)
    if kind == "dups_outside":
        nids = np.concatenate([rng.integers(0, 12, 190), [-1, 300, 310, 1000, -(2 ** 20)],
                               nids[:5]])
        nids = rng.permutation(nids)
    if kind == "long_runs":   # runs of ids and of next ids longer than a tile
        case = make_case(300, 32, 128, seed=4, dup_heavy="long_runs")
        nids = rng.permutation(np.concatenate([np.full(70, 3), np.full(40, 299), [-1] * 35,
                                               nids[:55]]))
    return case, nids.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "dups_outside", "long_runs"])
@pytest.mark.parametrize("precision,tol", [("highest", 5e-6), ("fast", 2e-4)])
def test_gather_update_matches_jax(precision, tol, kind):
    case, nids = gather_case(kind)
    args = (3, 1e-3, 1e-4)
    got = port_update(*case, *args, precision=precision, next_ids=torch.from_numpy(nids))
    alone = port_update(*case, *args, precision=precision)
    for a, b in zip(got[:4], alone):
        np.testing.assert_array_equal(a, b)              # tables as without next_ids
    inside = (nids >= 0) & (nids < 300)
    want_rows = np.zeros((len(nids), 32), np.float32)
    want_rows[inside] = got[0][nids[inside]]
    np.testing.assert_array_equal(got[4], want_rows)     # w'[next_ids], zero outside
    want = jax_result(*case, *args, block_rows=64, chunk=32, precision=precision,
                      next_ids=jnp.asarray(nids))
    for g, w in zip(got[:3] + got[4:], want[:3] + want[4:]):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    assert not np.any(want[4][~inside])


def test_gather_update_bf16_moments_match_jax_without_stochastic_rounding():
    case, nids = gather_case("dups_outside")
    kw = dict(dtype=torch.bfloat16, stochastic_rounding=False)
    got = port_update(*case, 3, 1e-3, 1e-4, next_ids=torch.from_numpy(nids), **kw)
    alone = port_update(*case, 3, 1e-3, 1e-4, **kw)
    for a, b in zip(got[:4], alone):
        np.testing.assert_array_equal(a, b)
    want = jax_result(*case, 3, 1e-3, 1e-4, dtype=jnp.bfloat16, block_rows=64, chunk=32,
                      precision="highest", next_ids=jnp.asarray(nids))
    np.testing.assert_allclose(got[1], want[1], rtol=1 / 128, atol=1e-9)
    np.testing.assert_allclose(got[2], want[2], rtol=1 / 128, atol=1e-12)
    for g, w in ((got[0], want[0]), (got[4], want[4])):
        np.testing.assert_allclose(g, w, rtol=5e-6, atol=5e-6)


def test_gathered_rows_are_copies_in_next_ids_order():
    w, mu, nu, ids, g = (torch.from_numpy(x) for x in make_case(40, 8, 16, seed=9))
    nids = torch.tensor([39, 0, 7, 7, -3, 40, 0], dtype=torch.int32)
    *_, rows = fused_adam.sparse_adam_update(w, mu, nu, ids, g, 2, 1e-3, next_ids=nids)
    assert rows.shape == (7, 8) and rows.untyped_storage().data_ptr() != w.untyped_storage().data_ptr()
    np.testing.assert_array_equal(rows[[0, 1, 2, 3, 6]].numpy(), w[[39, 0, 7, 7, 0]].numpy())
    assert not rows[[4, 5]].any()
    before = w.clone()
    rows += 1.0                                          # writing them leaves the table alone
    assert torch.equal(w, before)
    empty = fused_adam.sparse_adam_update(w, mu, nu, ids, g, 3, 1e-3,
                                          next_ids=torch.zeros(0, dtype=torch.int64))
    assert empty[4].shape == (0, 8)


# ---- the kernel's tiles of sorted positions (csrc/fused_adam.cu) ----------------

def numpy_runs(ids_s, n):
    """(row, lo, hi) of each run of an id in [0, n) in the sorted ids."""
    runs, p = [], 0
    while p < len(ids_s):
        q = p
        while q < len(ids_s) and ids_s[q] == ids_s[p]:
            q += 1
        if 0 <= ids_s[p] < n:
            runs.append((int(ids_s[p]), p, q))
        p = q
    return runs


def numpy_tile_order(ids_s, g_s, n, t, long_parts=32, chain=8):
    """The kernel's dscat [n, D], one run at a time in f32: a run in one tile
    of t positions summed from 0 in position order; a crossing run's segment
    in each tile summed from 0, the segment sums added from 0 in order, or,
    past ``long_parts`` segments, cut into at most ``chain`` chunks of
    ceil(segments / chain), each summed from 0, and the chunk sums added from
    0 in order. Also each run's segments (lo, hi) and the first pass's slot
    of each."""
    out = np.zeros((n, g_s.shape[1]), np.float32)
    segments = {}
    for row, lo, hi in numpy_runs(ids_s, n):
        if lo // t == (hi - 1) // t:
            acc = np.zeros(g_s.shape[1], np.float32)
            for p in range(lo, hi):
                acc = acc + g_s[p]
            out[row] = acc
            continue
        segs, parts = [], []
        for tile in range(lo // t, (hi - 1) // t + 1):
            a, b = max(lo, tile * t), min(hi, (tile + 1) * t)
            part = np.zeros(g_s.shape[1], np.float32)
            for p in range(a, b):
                part = part + g_s[p]
            parts.append(part)
            segs.append((a, b, 2 * tile + (1 if tile == lo // t else 0)))
        q = -(-len(parts) // chain) if len(parts) > long_parts else 1
        acc = np.zeros(g_s.shape[1], np.float32)
        for c in range(0, len(parts), q):
            chunk = np.zeros(g_s.shape[1], np.float32)
            for part in parts[c:c + q]:
                chunk = chunk + part
            acc = acc + chunk
        out[row] = acc
        segments[row] = segs
    return out, segments


def skewed_sorted(seed, b, n):
    """Sorted skewed ids: runs of every length up to several tiles, ids
    outside [0, n) below and above, n itself (the drop marker) among them."""
    rng = np.random.default_rng(seed)
    ids = np.minimum((rng.pareto(0.8, b) * 3).astype(np.int64) - 3, n + 4)
    return np.sort(ids).astype(np.int32)


@pytest.mark.parametrize("seed,b,n", [(0, 300, 40), (1, 513, 9), (2, 64, 500), (3, 1000, 3),
                                      (4, 1, 5), (5, 0, 5), (6, 5000, 2)])
def test_run_sums_in_tile_order_match_the_numpy_reference(seed, b, n):
    """Bit for bit, and with integer gradients (exact sums) every gradient
    row of an id in [0, n) counted once: each run covered once, in order."""
    ids = skewed_sorted(seed, b, n)
    g = np.random.default_rng(seed + 9).standard_normal((b, 8)).astype(np.float32)
    want, _ = numpy_tile_order(ids, g, n, fused_adam.TILE, fused_adam.LONG_PARTS,
                               fused_adam.CHAIN)
    got = fused_adam.run_sums_in_tile_order(torch.from_numpy(ids), torch.from_numpy(g), n)
    np.testing.assert_array_equal(got.numpy(), want)
    counts = np.random.default_rng(seed).integers(-3, 4, (b, 8)).astype(np.float32)
    exact = np.zeros((n, 8), np.float32)
    keep = (ids >= 0) & (ids < n)
    np.add.at(exact, ids[keep], counts[keep])
    got = fused_adam.run_sums_in_tile_order(torch.from_numpy(ids), torch.from_numpy(counts), n)
    np.testing.assert_array_equal(got.numpy(), exact)


@pytest.mark.parametrize("lengths", [(1100, 1500, 7), (33 * 32 + 1, 32 * 32, 40 * 32 + 5)])
def test_run_sums_past_long_parts_are_added_in_chunks(lengths):
    """Runs of more than LONG_PARTS tiles (row 0 of the first case: 35
    tiles, 5 chunks of 8), beside ids outside the table: bit for bit the
    numpy reference, and with integer gradients every row counted once."""
    rng = np.random.default_rng(len(lengths))
    ids = np.concatenate([[-1] * 50] + [[r] * k for r, k in enumerate(lengths)]
                         + [[len(lengths) + 2] * 9]).astype(np.int32)
    n = len(lengths) + 1
    runs = numpy_runs(ids, n)
    assert max((hi - 1) // fused_adam.TILE - lo // fused_adam.TILE + 1
               for _, lo, hi in runs) > fused_adam.LONG_PARTS
    g = rng.standard_normal((ids.shape[0], 8)).astype(np.float32)
    want, _ = numpy_tile_order(ids, g, n, fused_adam.TILE, fused_adam.LONG_PARTS,
                               fused_adam.CHAIN)
    got = fused_adam.run_sums_in_tile_order(torch.from_numpy(ids), torch.from_numpy(g), n)
    np.testing.assert_array_equal(got.numpy(), want)
    counts = rng.integers(-3, 4, g.shape).astype(np.float32)
    exact = np.zeros((n, 8), np.float32)
    keep = ids < n
    np.add.at(exact, ids[keep & (ids >= 0)], counts[keep & (ids >= 0)])
    got = fused_adam.run_sums_in_tile_order(torch.from_numpy(ids), torch.from_numpy(counts), n)
    np.testing.assert_array_equal(got.numpy(), exact)


@pytest.mark.parametrize("seed,b,n", [(0, 300, 40), (1, 513, 9), (3, 1000, 3), (4, 33, 5)])
def test_tile_sums_plain_writes_each_crossing_segment_once(seed, b, n):
    """The first pass's plain version: exactly the slots the update reads
    (slot 2t + 1 of a crossing run's first tile, slot 2t of its others),
    each its segment's sum from 0; the segments of a run tile it in order."""
    ids = skewed_sorted(seed, b, n)
    g = np.random.default_rng(seed + 9).standard_normal((b, 8)).astype(np.float32)
    _, segments = numpy_tile_order(ids, g, n, fused_adam.TILE, fused_adam.LONG_PARTS,
                               fused_adam.CHAIN)
    sums, written = fused_adam._tile_sums_plain(torch.from_numpy(ids), torch.from_numpy(g), n)
    tiles = -(-b // fused_adam.TILE)
    assert sums.shape == (2 * tiles, 8) and written.shape == (2 * tiles,)
    want_written = np.zeros(2 * tiles, bool)
    for row, segs in segments.items():
        assert segs[0][0] == min(p for p in range(b) if ids[p] == row)
        assert [a for a, _, _ in segs[1:]] == [b_ for _, b_, _ in segs[:-1]]   # contiguous
        for a, b_, slot in segs:
            assert not want_written[slot]
            want_written[slot] = True
            part = np.zeros(8, np.float32)
            for p in range(a, b_):
                part = part + g[p]
            np.testing.assert_array_equal(sums[slot].numpy(), part)
    np.testing.assert_array_equal(written.numpy(), want_written)


@pytest.mark.parametrize("seed,m,n", [(0, 300, 40), (1, 513, 9), (2, 64, 500), (4, 1, 5)])
def test_copies_plain_and_the_update_split_the_next_ids(seed, m, n):
    """The gather's second pass writes the rows of the next ids' runs that
    cross a tile edge (w[id]) and of ids outside the table (0); the update
    kernel stores the others, the runs inside one tile. Together: every
    position once."""
    nids = skewed_sorted(seed, m, n)
    norder = np.random.default_rng(seed).permutation(m).astype(np.int32)
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal((n, 8)).astype(np.float32))
    rows = torch.full((m, 8), 7.5)
    fused_adam._copies_plain(w, torch.from_numpy(nids), torch.from_numpy(norder), rows)
    t = fused_adam.TILE
    by_update = np.zeros(m, bool)
    for row, lo, hi in numpy_runs(nids, n):
        if lo // t == (hi - 1) // t:
            by_update[lo:hi] = True
    written = ~(rows == 7.5).all(dim=1).numpy()[norder]
    np.testing.assert_array_equal(written, ~by_update)
    inside = (nids >= 0) & (nids < n)
    pass_inside = written & inside
    np.testing.assert_array_equal(rows.numpy()[norder[pass_inside]], w.numpy()[nids[pass_inside]])
    assert not rows.numpy()[norder[~inside]].any()


@pytest.mark.parametrize("seed,b,n", [(0, 300, 40), (1, 513, 9), (2, 64, 500), (3, 1000, 3),
                                      (4, 1, 5), (5, 0, 5), (6, 200, 1000)])
def test_block_starts_are_the_first_pass_rule(seed, b, n):
    """_block_starts_plain (searchsorted over each block's first row) equals
    the first pass's rule: each position fills the blocks after its
    predecessor's up to its own, the last position's successors get b."""
    ids = skewed_sorted(seed, b, n)
    rb = lambda i: -1 if i < 0 else (-(-n // fused_adam.BLOCK_ROWS) if i >= n
                                     else i // fused_adam.BLOCK_ROWS)
    nb = -(-n // fused_adam.BLOCK_ROWS)
    want = np.full(nb + 1, -7, np.int64)
    for p in range(b):
        prev = -1 if p == 0 else rb(ids[p - 1])
        want[prev + 1:rb(ids[p]) + 1] = p
    want[(rb(ids[-1]) if b else -1) + 1:] = b
    got = fused_adam._block_starts_plain(torch.from_numpy(ids), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---- stochastic rounding --------------------------------------------------------

def bf16_neighbours(x: np.ndarray):
    """The bf16 values just below and above |x| (toward and away from 0)."""
    bits = x.view(np.uint32).astype(np.uint64)
    down = (bits & 0xFFFF0000).astype(np.uint32).view(np.float32)
    up = (((bits & 0xFFFF0000) + 0x10000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    return down, up


def test_stochastic_rounding_gives_a_bf16_neighbour():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((257, 64)) * 10.0 ** rng.integers(-8, 3, (257, 64))).astype(np.float32)
    bits = fused_adam.sr_random_bits(step=5, moment=1, n=257, d=64, device="cpu")
    got = fused_adam.stochastic_round_bf16(torch.from_numpy(x), bits).float().numpy()
    down, up = bf16_neighbours(x)
    assert np.all((got == down) | (got == up))
    exact = x == down
    np.testing.assert_array_equal(got[exact], x[exact])
    # Both neighbours occur: the bits are not stuck.
    assert 0.3 < np.mean(got[~exact] == up[~exact]) < 0.7


def test_stochastic_rounding_is_unbiased():
    """Mean over 64k elements of one value: the rounding error of one
    element is 0 or one ulp minus the fraction, so its mean's standard error
    is <= ulp / 512; the bound is 0.02 ulp (> 10 standard errors)."""
    n, d = 512, 128
    for value in (1.0 + 0.3 * 2.0 ** -7, -3.7e-4, 0.0210):
        x = torch.full((n, d), value, dtype=torch.float32)
        ulp = 2.0 ** (np.floor(np.log2(abs(value))) - 7)
        for step, moment in ((1, 0), (2, 1), (1000, 0)):
            bits = fused_adam.sr_random_bits(step, moment, n, d, "cpu")
            got = fused_adam.stochastic_round_bf16(x, bits).double()
            assert abs(float(got.mean()) - float(x[0, 0])) < 0.02 * ulp, (value, step)


def test_ema_of_sub_ulp_increments_moves_only_with_stochastic_rounding():
    """nu' = b2 nu + (1 - b2) g^2 from nu = 1 toward g^2 = 1.5: each step
    adds 5e-4, below half of bf16's 2^-7 ulp at 1. Rounded to nearest, nu
    never leaves 1 (the failure _sr_store describes); stochastically
    rounded, its mean tracks the f32 EMA, 1.5 - 0.5 * 0.999^t."""
    n, d, steps = 128, 32, 600
    g = np.full((n, d), np.sqrt(1.5), np.float32)
    ids = torch.arange(n)
    tables = {}
    for sr in (False, True):
        w = torch.zeros(n, d)
        mu = torch.zeros(n, d, dtype=torch.bfloat16)
        nu = torch.ones(n, d, dtype=torch.bfloat16)
        for t in range(1, steps + 1):
            fused_adam.sparse_adam_update(w, mu, nu, ids, torch.from_numpy(g), t, 0.0,
                                          stochastic_rounding=sr)
        tables[sr] = nu.float()
    assert bool((tables[False] == 1.0).all())
    f32_ema = 1.5 - 0.5 * B2 ** steps
    assert abs(float(tables[True].mean()) - f32_ema) < 0.01
    assert float((tables[True] > 1.0).float().mean()) > 0.95
