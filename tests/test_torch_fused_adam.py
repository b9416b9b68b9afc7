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
tolerances above.

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
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, d)).astype(np.float32) * 0.05
    mu = rng.standard_normal((n, d)).astype(np.float32) * 0.01
    nu = (rng.standard_normal((n, d)).astype(np.float32) * 0.01) ** 2
    hi = max(n // 20, 2) if dup_heavy else n
    ids = rng.integers(0, hi, b).astype(np.int32)
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
@pytest.mark.parametrize("dup_heavy", [False, True])
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


def test_bf16_moments_match_jax_without_stochastic_rounding():
    case = make_case(300, 32, 128, seed=4)
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):   # as JAX: dense_grad + next_ids
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 1, 1e-3, next_ids=ids, dense_grad=w)
    with pytest.raises(TypeError):
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 1, 1e-3, next_ids=ids.float())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 1, 1e-3, dense_grad=w)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 1, 1e-3, order=torch.argsort(ids))
    with pytest.raises(ValueError):
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 1, 1e-3, precision="default")
    with pytest.raises(TypeError):
        fused_adam.sparse_adam_update(w, mu, nu.bfloat16(), ids, g, 1, 1e-3)
    with pytest.raises(ValueError):
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 0, 1e-3)


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
    return case, nids.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "dups_outside"])
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
