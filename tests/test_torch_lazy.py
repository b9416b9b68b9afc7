"""The port's LazyAdam (train/lazy.py) against the JAX package's, on the CPU.

The cases of tests/test_lazy_adam.py, on the port, and the port held to JAX:
both packages start from one JAX-initialized state (numpy, as in
tests/test_torch_train.py) and see the same batches. Tolerances: the first
step from a fresh state with l2 = 0 equals the dense step's to 2e-5
relative, as in tests/test_lazy_adam.py; against JAX, loss and mse to 2e-6
and states to tests/test_torch_train.py's ``assert_states_match``, and one
``lazy_row_adam`` to 1e-5 of each table's scale: JAX sorts unstably and
segment-sums, the port sorts stably and index-adds, so a duplicated row's
gradient sum may differ in its last f32 bits.
"""

import jax.numpy as jnp
import numpy as np
import torch

from anime_recommendations_tpu.train.lazy import lazy_row_adam as jlazy_row_adam
from anime_recommendations_tpu.train.lazy import lazy_train_step as jlazy_step
from anime_recommendations_tpu_torch.ops.fused_adam import scalar_row
from anime_recommendations_tpu_torch.train import trainer as tr
from anime_recommendations_tpu_torch.train.lazy import lazy_row_adam, lazy_train_step
from tests.test_torch_train import (
    assert_states_match,
    batch,
    close_to_scale,
    initial_arrays,
    numpy_to_jax,
)

torch.set_num_threads(2)


def fresh_state(n_users, n_anime, d, seed):
    return tr.init_train_state(n_users, n_anime, d, generator=torch.Generator().manual_seed(seed),
                               device="cpu")


def test_first_step_matches_dense_on_touched_rows():
    """Fresh state, l2 = 0: dense Adam's update is zero on untouched rows
    (mu = nu = 0), so the first lazy step equals the dense step everywhere."""
    n_users, n_anime, d, b = 60, 40, 8, 32
    cols = [torch.from_numpy(x) for x in batch(n_users, n_anime, b, seed=0)]
    dense, lazy = fresh_state(n_users, n_anime, d, 1), fresh_state(n_users, n_anime, d, 1)
    dense, loss_d, mse_d = tr.train_step(dense, *cols, 1e-3, 0.0)
    lazy, loss_l, mse_l = lazy_train_step(lazy, *cols, 1e-3, 0.0)
    np.testing.assert_allclose(float(loss_l), float(loss_d), rtol=1e-6)
    np.testing.assert_allclose(float(mse_l), float(mse_d), rtol=1e-6)
    for k in tr.TABLE_KEYS + ("dense_w", "bn_gamma", "bn_beta"):
        np.testing.assert_allclose(getattr(lazy.model, k).detach().numpy(),
                                   getattr(dense.model, k).detach().numpy(),
                                   rtol=2e-5, atol=1e-7, err_msg=k)
    assert lazy.adam.count == 1


def test_untouched_rows_frozen():
    n_users, n_anime, d, b = 50, 30, 8, 16
    rng = np.random.default_rng(1)
    users = torch.from_numpy(rng.integers(0, 20, b).astype(np.int32))   # rows 20+ untouched
    anime = torch.from_numpy(rng.integers(0, 10, b).astype(np.int32))
    ratings = torch.from_numpy(rng.uniform(0, 1, b).astype(np.float32))
    state = fresh_state(n_users, n_anime, d, 2)
    before = state.model.user_emb.detach().clone()
    mu_before = state.adam.mu["user_emb"].clone()
    for _ in range(3):
        state, _, _ = lazy_train_step(state, users, anime, ratings, torch.ones(b), 1e-2, 1e-4)
    after = state.model.user_emb.detach()
    assert torch.equal(after[20:], before[20:])
    assert torch.equal(state.adam.mu["user_emb"][20:], mu_before[20:])
    assert float((after[:20] - before[:20]).abs().max()) > 0


def test_duplicate_ids_single_update_per_row():
    """Every batch entry on one row: one Adam update with the summed gradient,
    not B updates."""
    rng = np.random.default_rng(2)
    n, d, b = 16, 4, 8
    w = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    mu, nu = torch.zeros(n, d), torch.zeros(n, d)
    g = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    w0 = w.clone()
    out = lazy_row_adam(w, mu, nu, torch.zeros(b, dtype=torch.int32), g,
                        scalar_row(1, 1e-2, "cpu"), 0.0)
    assert out.w is w and out.mu is mu                    # in place
    np.testing.assert_allclose(mu[0].numpy(), 0.1 * g.numpy().sum(axis=0), rtol=1e-5)
    assert not mu[1:].any() and torch.equal(w[1:], w0[1:])
    # Adam's first step moves each coordinate by lr (times the gradient's sign).
    np.testing.assert_allclose((w0[0] - w[0]).numpy(), 1e-2 * np.sign(g.numpy().sum(axis=0)),
                               rtol=1e-4)


def test_lazy_row_adam_matches_jax():
    rng = np.random.default_rng(3)
    n, d, b, t, l2 = 200, 16, 96, 3, 1e-4
    w = rng.standard_normal((n, d)).astype(np.float32) * 0.05
    mu = rng.standard_normal((n, d)).astype(np.float32) * 0.01
    nu = (rng.standard_normal((n, d)).astype(np.float32) * 0.01) ** 2
    ids = rng.integers(0, 20, b).astype(np.int32)          # many duplicates
    g = rng.standard_normal((b, d)).astype(np.float32) * 0.1
    got = lazy_row_adam(*(torch.from_numpy(x.copy()) for x in (w, mu, nu, ids, g)),
                        scalar_row(t, 1e-3, "cpu"), l2)
    want = jlazy_row_adam(*map(jnp.asarray, (w, mu, nu, ids, g)), jnp.asarray(t),
                          jnp.float32(1e-3), l2)
    for name, a, c in zip(("w", "mu", "nu"), got, want):
        close_to_scale(a.numpy(), np.asarray(c), 1e-5)
    untouched = ~np.isin(np.arange(n), ids)
    np.testing.assert_array_equal(got.w.numpy()[untouched], w[untouched])


def test_chained_lazy_steps_match_jax():
    """4 chained steps from one carried-across state, a padded batch among them."""
    n_users, n_anime, d, b, l2 = 150, 40, 16, 64, 1e-4
    arrays = initial_arrays(n_users, n_anime, d, seed=5)
    js, ts = numpy_to_jax(arrays), tr.train_state_from_numpy(arrays, "cpu")
    for step in range(4):
        u, a, r, w = batch(n_users, n_anime, b, seed=20 + step, padded=step == 2)
        js, jloss, jmse = jlazy_step(js, *map(jnp.asarray, (u, a, r, w)), jnp.float32(1e-3), l2)
        ts, loss, mse = lazy_train_step(ts, *map(torch.from_numpy, (u, a, r, w)), 1e-3, l2)
        assert abs(float(loss) - float(jloss)) < 2e-6
        assert abs(float(mse) - float(jmse)) < 2e-6
    assert_states_match(ts, js)
