"""The port's training path against the JAX package's, on the CPU.

Both packages start from one JAX-initialized state, carried across as numpy
(train_state_to_numpy / train_state_from_numpy), and see the same batches
made from numpy seeds. The JAX fused step runs its Pallas kernel in
interpret mode. Tolerances, with their reasons:

  * loss, mse: 2e-6 absolute (f32 sums in another order);
  * tables and moments: 1e-5 relative to the largest entry (4 chained
    steps; the fused path adds the scatter-order difference of
    test_torch_fused_adam.py);
  * dense_w: 1e-6; moving_mean: 6e-5 absolute. dense_b's gradient is zero
    in exact arithmetic (BatchNorm removes the bias), so both packages feed
    Adam rounding noise there and it moves dense_b by up to lr per step in
    either direction; moving_mean follows dense_b at 1 % per step, so it can
    differ by 0.01 * lr * (0 + 1 + 2 + 3) = 6e-5 after 4 steps at lr 1e-3.
    dense_b itself is not compared, for the same reason;
  * head scalars' gradients and moments: 1e-4 relative (a sum over the
    batch with cancellation);
  * Trainer histories: the training columns 1e-5 relative, the validation
    columns 2e-3. Validation runs BatchNorm on its moving mean, which does
    not cancel dense_b as the batch mean does, so the dense_b random walk
    above shows there (measured 5e-4 at these learning rates, 1e-2 at 10x).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from anime_recommendations_tpu.data.dataset import RatingsDataset as JDataset
from anime_recommendations_tpu.models import two_tower as jtt
from anime_recommendations_tpu.pipeline.artifacts import ArtifactStore as JStore
from anime_recommendations_tpu.train import device_loop as jdl
from anime_recommendations_tpu.train import trainer as jtr
from anime_recommendations_tpu.train.fused import fused_train_step as jfused_step
from anime_recommendations_tpu.train.fused import (
    fused_train_step_pipelined as jfused_pipelined,
)
from anime_recommendations_tpu.train.model_io import load_model as jload_model
from anime_recommendations_tpu_torch import cli
from anime_recommendations_tpu_torch.config import Config
from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
from anime_recommendations_tpu_torch.models import two_tower as tt
from anime_recommendations_tpu_torch.pipeline.artifacts import ArtifactStore
from anime_recommendations_tpu_torch.pipeline.runner import PipelineRunner, latest_file
from anime_recommendations_tpu_torch.train import device_loop as dl
from anime_recommendations_tpu_torch.train import trainer as tr
from anime_recommendations_tpu_torch.train.checkpoint import Checkpointer
from anime_recommendations_tpu_torch.train.fused import (
    fused_train_step,
    fused_train_step_pipelined,
)

torch.set_num_threads(2)
KEYS = tt.PARAM_KEYS


def jax_to_numpy(js) -> dict:
    out = {k: np.asarray(getattr(js.params, k), np.float32) for k in KEYS}
    out["moving_mean"] = np.asarray(js.bn_state.moving_mean, np.float32)
    out["moving_var"] = np.asarray(js.bn_state.moving_var, np.float32)
    for prefix, moments in (("mu", js.opt_state.mu), ("nu", js.opt_state.nu)):
        for k in KEYS:
            out[f"{prefix}.{k}"] = np.asarray(getattr(moments, k).astype(jnp.float32))
    out["count"] = np.asarray(js.opt_state.count)
    return out


def numpy_to_jax(arrays, moment_dtype=jnp.float32):
    params = jtt.TwoTowerParams(**{k: jnp.asarray(arrays[k]) for k in KEYS})
    bn = jtt.BNState(jnp.asarray(arrays["moving_mean"]), jnp.asarray(arrays["moving_var"]))

    def moments(prefix):
        return jtt.TwoTowerParams(**{
            k: jnp.asarray(arrays[f"{prefix}.{k}"]).astype(
                moment_dtype if k in tr.TABLE_KEYS else jnp.float32) for k in KEYS})

    opt = jtr.optax.ScaleByAdamState(count=jnp.asarray(arrays["count"], jnp.int32),
                                     mu=moments("mu"), nu=moments("nu"))
    return jtr.TrainState(params, bn, opt)


def initial_arrays(n_users, n_anime, d, seed=0):
    return jax_to_numpy(jtr.init_train_state(jax.random.PRNGKey(seed), n_users, n_anime, d))


def batch(n_users, n_anime, b, seed, padded=False):
    rng = np.random.default_rng(seed)
    w = np.ones(b, np.float32)
    if padded:
        w[-b // 4:] = 0.0
    return (rng.integers(0, n_users, b).astype(np.int32),
            rng.integers(0, n_anime, b).astype(np.int32),
            rng.uniform(0, 1, b).astype(np.float32), w)


def close_to_scale(got, want, rel):
    """|got - want| <= rel * max|want| (elementwise), with a clear message."""
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def assert_states_match(port_state, jax_state, rel=1e-5):
    got, want = tr.train_state_to_numpy(port_state), jax_to_numpy(jax_state)
    for k in ("user_emb", "anime_emb", "mu.user_emb", "mu.anime_emb", "nu.user_emb",
              "nu.anime_emb"):
        close_to_scale(got[k], want[k], rel)
    for k in ("mu.dense_w", "nu.dense_w", "mu.bn_gamma", "nu.bn_gamma"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["dense_w"], want["dense_w"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["moving_mean"], want["moving_mean"], rtol=0, atol=6e-5)
    np.testing.assert_allclose(got["moving_var"], want["moving_var"], rtol=1e-5)
    assert int(got["count"]) == int(want["count"])


# ---- model: loss, gradients, BatchNorm -------------------------------------------

@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_loss_and_grads_match_jax(padded):
    arrays = initial_arrays(60, 25, 16)
    arrays["moving_mean"], arrays["moving_var"] = np.float32(0.2), np.float32(0.7)
    u, a, r, w = batch(60, 25, 96, seed=1, padded=padded)
    params, bn = numpy_to_jax(arrays).params, numpy_to_jax(arrays).bn_state
    (jloss, (jmse, jbn)), jgrads = jax.value_and_grad(jtt.loss_and_metrics, has_aux=True)(
        params, bn, jnp.asarray(u), jnp.asarray(a), jnp.asarray(r), jnp.asarray(w),
        1e-3, True)
    model = tt.params_from_numpy(arrays, "cpu").train()
    loss, (mse, new_bn) = tt.loss_and_metrics(
        model, model.bn_state(), *(torch.from_numpy(x) for x in (u, a, r, w)), 1e-3, True)
    grads = torch.autograd.grad(loss, [getattr(model, k) for k in KEYS])
    assert abs(loss.item() - float(jloss)) < 2e-6
    assert abs(mse.item() - float(jmse)) < 2e-6
    for k, g in zip(KEYS, grads):
        # A head scalar's gradient sums the batch with cancellation: 1e-4 of
        # it. dense_b's is rounding noise around 0 (module docstring).
        rel = 1e-5 if k in tr.TABLE_KEYS else 1e-4
        tol = 1e-6 if k == "dense_b" else rel * float(np.abs(getattr(jgrads, k)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(jgrads, k)), rtol=0,
                                   atol=tol, err_msg=k)
    np.testing.assert_allclose(float(new_bn.moving_mean), float(jbn.moving_mean), atol=1e-7)
    np.testing.assert_allclose(float(new_bn.moving_var), float(jbn.moving_var), rtol=1e-6)
    # The module's train-mode forward returns the same new state and leaves
    # the buffers alone; eval mode predicts from the moving statistics.
    pred, bn2 = model(*(torch.from_numpy(x) for x in (u, a)), torch.from_numpy(w))
    assert float(bn2.moving_var) == float(new_bn.moving_var)
    assert float(model.moving_var) == pytest.approx(0.7)
    jpred = jtt.predict(params, bn, jnp.asarray(u), jnp.asarray(a))
    np.testing.assert_allclose(model.eval()(*(torch.from_numpy(x) for x in (u, a)))
                               .detach().numpy(), np.asarray(jpred), atol=1e-6)


def test_init_params_ranges_and_moments():
    g = torch.Generator().manual_seed(3)
    model = tt.init_params(400, 300, 32, generator=g, device="cpu")
    for table in (model.user_emb, model.anime_emb):
        t = table.detach()
        assert float(t.min()) >= -0.05 and float(t.max()) < 0.05
        assert abs(float(t.mean())) < 1e-3                 # uniform(-0.05, 0.05)
        assert abs(float(t.std()) - 0.1 / 12 ** 0.5) < 1e-3
    assert (float(model.dense_b), float(model.bn_gamma), float(model.bn_beta)) == (0.0, 1.0, 0.0)
    again = tt.init_params(400, 300, 32, generator=torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again.user_emb, model.user_emb)
    # he_normal on fan_in 1: a normal truncated to [-2, 2], times sqrt(2);
    # its standard deviation is 0.8796 * sqrt(2) = 1.2440.
    w = np.array([float(tt.init_params(1, 1, 4, generator=torch.Generator().manual_seed(s),
                                       device="cpu").dense_w) for s in range(2000)])
    assert np.abs(w).max() <= 2 * 2 ** 0.5
    assert abs(w.mean()) < 0.1 and abs(w.std() - 1.2440) < 0.06


# ---- steps -----------------------------------------------------------------------

STEPS = {"dense": (tr.train_step, jtr.train_step), "fused": (fused_train_step, jfused_step)}


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_chained_steps_match_jax(kind):
    """4 chained steps from one carried-across state, a padded batch among them."""
    port_step, jax_step = STEPS[kind]
    n_users, n_anime, d, b, l2 = 150, 40, 16, 64, 1e-4
    arrays = initial_arrays(n_users, n_anime, d)
    js, ts = numpy_to_jax(arrays), tr.train_state_from_numpy(arrays, "cpu")
    for step in range(4):
        u, a, r, w = batch(n_users, n_anime, b, seed=step, padded=step == 2)
        js, jloss, jmse = jax_step(js, *map(jnp.asarray, (u, a, r, w)), jnp.float32(1e-3), l2)
        ts, loss, mse = port_step(ts, *map(torch.from_numpy, (u, a, r, w)), 1e-3, l2)
        assert abs(float(loss) - float(jloss)) < 2e-6
        assert abs(float(mse) - float(jmse)) < 2e-6
    assert_states_match(ts, js)


def test_fused_step_tracks_dense_step_and_pipelined_equals_fused():
    n_users, n_anime, d, b, l2 = 150, 40, 16, 64, 1e-4
    arrays = initial_arrays(n_users, n_anime, d, seed=1)
    dense, fused, piped, gathered = (tr.train_state_from_numpy(arrays, "cpu")
                                     for _ in range(4))
    batches = [tuple(map(torch.from_numpy, batch(n_users, n_anime, b, seed=s)))
               for s in range(5)]
    u_rows = piped.model.user_emb.detach()[batches[0][0]]
    a_rows = piped.model.anime_emb.detach()[batches[0][1]]
    g_rows = (u_rows.clone(), a_rows.clone())
    for i, (u, a, r, w) in enumerate(batches[:4]):
        dense, loss_d, _ = tr.train_step(dense, u, a, r, w, 1e-3, l2)
        fused, loss_f, mse_f = fused_train_step(fused, u, a, r, w, 1e-3, l2)
        nu_, na_ = batches[i + 1][:2]
        piped, loss_p, mse_p, u_rows, a_rows = fused_train_step_pipelined(
            piped, u_rows, a_rows, u, a, r, w, nu_, na_, 1e-3, l2)
        # kernel_gather=True (K5's gather inside the update) is the same step.
        gathered, loss_g, mse_g, *g_rows = fused_train_step_pipelined(
            gathered, *g_rows, u, a, r, w, nu_, na_, 1e-3, l2, kernel_gather=True)
        assert abs(float(loss_f) - float(loss_d)) < 2e-6
        assert float(loss_p) == float(loss_f) and float(mse_p) == float(mse_f)
        assert float(loss_g) == float(loss_p) and float(mse_g) == float(mse_p)
        assert torch.equal(g_rows[0], u_rows) and torch.equal(g_rows[1], a_rows)
    for k, v in tr.train_state_to_numpy(piped).items():
        np.testing.assert_array_equal(v, tr.train_state_to_numpy(fused)[k], err_msg=k)
        np.testing.assert_array_equal(v, tr.train_state_to_numpy(gathered)[k], err_msg=k)
    close_to_scale(fused.model.user_emb.detach().numpy(),
                   dense.model.user_emb.detach().numpy(), 1e-5)


def test_pipelined_kernel_gather_step_matches_jax():
    """4 chained fused_train_step_pipelined(kernel_gather=True) steps, the
    rows each returns carried to the next, in both packages."""
    n_users, n_anime, d, b, l2 = 150, 40, 16, 64, 1e-4
    arrays = initial_arrays(n_users, n_anime, d, seed=4)
    js, ts = numpy_to_jax(arrays), tr.train_state_from_numpy(arrays, "cpu")
    batches = [batch(n_users, n_anime, b, seed=10 + s, padded=s == 2) for s in range(5)]
    t_rows = (ts.model.user_emb.detach()[torch.from_numpy(batches[0][0])],
              ts.model.anime_emb.detach()[torch.from_numpy(batches[0][1])])
    j_rows = (js.params.user_emb[batches[0][0]], js.params.anime_emb[batches[0][1]])
    for i in range(4):
        nxt = batches[i + 1][:2]
        js, jloss, jmse, *j_rows = jfused_pipelined(
            js, *j_rows, *map(jnp.asarray, batches[i]), *map(jnp.asarray, nxt),
            jnp.float32(1e-3), l2, kernel_gather=True)
        ts, loss, mse, *t_rows = fused_train_step_pipelined(
            ts, *t_rows, *map(torch.from_numpy, batches[i]), *map(torch.from_numpy, nxt),
            1e-3, l2, kernel_gather=True)
        assert abs(float(loss) - float(jloss)) < 2e-6
        assert abs(float(mse) - float(jmse)) < 2e-6
        for t, j in zip(t_rows, j_rows):
            close_to_scale(t.numpy(), np.asarray(j), 1e-5)
    assert_states_match(ts, js)


def test_train_state_numpy_round_trip_keeps_bf16_moments():
    arrays = initial_arrays(30, 20, 8)
    arrays["mu.user_emb"] = np.random.default_rng(0).standard_normal((30, 8)).astype(np.float32)
    state = tr.train_state_from_numpy(arrays, "cpu", moment_dtype=torch.bfloat16)
    assert state.adam.mu["user_emb"].dtype == torch.bfloat16
    assert state.adam.mu["dense_w"].dtype == torch.float32
    back = tr.train_state_to_numpy(state)
    assert set(back) == set(arrays)
    bf16 = jnp.asarray(arrays["mu.user_emb"]).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(back["mu.user_emb"], np.asarray(bf16))
    np.testing.assert_array_equal(back["user_emb"], arrays["user_emb"])


# ---- device loop -----------------------------------------------------------------

def ratings(n_users, n_anime, rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, rows).astype(np.int32),
            rng.integers(0, n_anime, rows).astype(np.int32),
            rng.uniform(0, 1, rows).astype(np.float32))


@pytest.mark.parametrize("optimizer", ["adam", "fused_adam", "lazy_adam"])
def test_train_epoch_and_eval_epoch_match_jax(optimizer):
    n_users, n_anime, d, bs, l2 = 120, 30, 8, 50, 1e-4
    cols = ratings(n_users, n_anime, 420, seed=3)    # 9 batches, the last padded
    arrays = initial_arrays(n_users, n_anime, d, seed=1)
    jdata = jdl.stage(JDataset(*cols), bs, seed=None)
    js, jl, jm, jw = jdl.train_epoch(numpy_to_jax(arrays), jdata, jax.random.PRNGKey(0),
                                     jnp.float32(1e-3), bs, l2, shuffle=False,
                                     optimizer=optimizer)
    data = dl.stage(RatingsDataset(*cols), bs, seed=None, device="cpu")
    ts, loss, mse, wsum = dl.train_epoch(tr.train_state_from_numpy(arrays, "cpu"), data,
                                         torch.Generator(), 1e-3, bs, l2, shuffle=False,
                                         optimizer=optimizer)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=0, atol=2e-6)
    np.testing.assert_allclose(mse.numpy(), np.asarray(jm), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(wsum.numpy(), np.asarray(jw))
    close_to_scale(ts.model.user_emb.detach().numpy(), np.asarray(js.params.user_emb), 1e-5)
    # eval_epoch from one state (the trained tables' dense_b differs by the
    # noise of the module docstring, which eval-mode BatchNorm shows).
    vl, vm = dl.eval_epoch(ts.model, ts.model.bn_state(), data, bs, l2)
    same = numpy_to_jax(tr.train_state_to_numpy(ts))
    jvl, jvm = jdl.eval_epoch(same.params, same.bn_state, jdata, bs, l2)
    assert abs(float(vl) - float(jvl)) < 2e-6 and abs(float(vm) - float(jvm)) < 2e-6


def test_granule_shuffle_visits_each_row_once():
    n, bs, g = 50_300, 1000, 512        # padded to 51,000; 99 granules and a tail
    ds = RatingsDataset(np.arange(n, dtype=np.int32), np.zeros(n, np.int32),
                        np.zeros(n, np.float32))
    for stage_seed in (None, 4):
        data = dl.stage(ds, bs, seed=stage_seed, device="cpu")
        for epoch in range(2):
            shuffled = dl.granule_shuffle(data, torch.Generator().manual_seed(epoch))
            real = shuffled.users[shuffled.weights > 0].numpy()
            assert np.array_equal(np.sort(real), np.arange(n))   # each row exactly once
            assert int((shuffled.weights == 0).sum()) == data.n - n
            # Granules move as units; the tail past the last whole granule stays.
            n_head = (data.n // g) * g
            assert torch.equal(shuffled.users[n_head:], data.users[n_head:])
            if stage_seed is None:
                heads = shuffled.users[:n_head].view(-1, g)
                assert bool((heads[:, 0] % g == 0).all())
                assert bool((heads - heads[:, :1] == torch.arange(g)).logical_or(
                    shuffled.weights[:n_head].view(-1, g) == 0).all())
    a = dl.granule_shuffle(data, torch.Generator().manual_seed(0)).users
    b = dl.granule_shuffle(data, torch.Generator().manual_seed(1)).users
    assert not torch.equal(a, b)
    # A small dataset shrinks the granule to keep ~64 of them (640 // 64 = 10).
    small = dl.stage(RatingsDataset(*ratings(10, 10, 640, seed=1)), 64, device="cpu")
    rows = dl.granule_shuffle(small, torch.Generator().manual_seed(0)).ratings.view(64, 10)
    assert sorted(map(tuple, rows.tolist())) == sorted(map(tuple, small.ratings.view(64, 10).tolist()))
    assert not torch.equal(rows, small.ratings.view(64, 10))


# ---- Trainer ---------------------------------------------------------------------

def datasets(seed=0, n_users=80, n_anime=40, n=3000):
    """Ratings of a planted rank-4 model; the holdout's are inverted (1 - y),
    so the validation loss rises from the first epoch on and early stopping
    comes at a known epoch with a wide margin."""
    rng = np.random.default_rng(seed)
    U, V = rng.normal(size=(n_users, 4)), rng.normal(size=(n_anime, 4))
    users, anime = rng.integers(0, n_users, n), rng.integers(0, n_anime, n)
    y = (1 / (1 + np.exp(-np.einsum("ij,ij->i", U[users], V[anime])))).astype(np.float32)
    cut = int(n * 0.8)
    y[cut:] = 1 - y[cut:]
    cols = (users.astype(np.int32), anime.astype(np.int32), y)
    return [c[:cut] for c in cols], [c[cut:] for c in cols], n_users, n_anime


FIT = dict(embedding_size=8, batch_size=256, epochs=8, patience=2, start_lr=0.003,
           max_lr=0.01, min_lr=0.003, rampup_epochs=1, l2_reg_factor=1e-3, verbose=False,
           seed=5)


def assert_histories_match(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == ["loss", "mse", "val_loss", "val_mse", "lr"]
    np.testing.assert_allclose(got[["loss", "mse"]], want[["loss", "mse"]], rtol=1e-5)
    np.testing.assert_allclose(got[["val_loss", "val_mse"]], want[["val_loss", "val_mse"]],
                               rtol=2e-3)
    np.testing.assert_array_equal(got["lr"], want["lr"])


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam"])
def test_trainer_fit_matches_jax_with_early_stop_and_best_restore(optimizer):
    train, holdout, n_users, n_anime = datasets()
    arrays = initial_arrays(n_users, n_anime, 8, seed=2)
    jres = jtr.Trainer(optimizer=optimizer, **FIT).fit(
        JDataset(*train), JDataset(*holdout), n_users, n_anime,
        initial_state=numpy_to_jax(arrays))
    res = tr.Trainer(device="cpu", optimizer=optimizer, **FIT).fit(
        RatingsDataset(*train), RatingsDataset(*holdout), n_users, n_anime,
        initial_state=tr.train_state_from_numpy(arrays, "cpu"))
    assert_histories_match(res.history, jres.history)
    assert res.epochs_run == jres.epochs_run == FIT["patience"] + 1   # stopped early
    assert res.best_epoch == jres.best_epoch == 0                     # and restored
    assert res.best_val_loss == pytest.approx(jres.best_val_loss, rel=2e-3)
    close_to_scale(res.state.model.user_emb.detach().numpy(),
                   np.asarray(jres.state.params.user_emb), 1e-5)
    assert res.examples_per_sec > 0


def test_trainer_resume_from_checkpoint_matches_jax(tmp_path):
    train, holdout, n_users, n_anime = datasets(seed=1)
    arrays = initial_arrays(n_users, n_anime, 8, seed=3)
    kw = dict(FIT, epochs=3, patience=5)
    jtrainer = jtr.Trainer(**kw, checkpoint_dir=str(tmp_path / "jax"))
    first_j = jtrainer.fit(JDataset(*train), JDataset(*holdout), n_users, n_anime,
                           initial_state=numpy_to_jax(arrays))
    trainer = tr.Trainer(device="cpu", checkpoint_dir=str(tmp_path / "port"), **kw)
    first = trainer.fit(RatingsDataset(*train), RatingsDataset(*holdout), n_users, n_anime,
                        initial_state=tr.train_state_from_numpy(arrays, "cpu"))
    assert Checkpointer(tmp_path / "port").latest_step() == first.best_epoch == first_j.best_epoch
    # Resume: both restore their own checkpoint and continue from the epoch after it.
    kw2 = dict(kw, epochs=5)
    second_j = jtr.Trainer(**kw2, checkpoint_dir=str(tmp_path / "jax")).fit(
        JDataset(*train), JDataset(*holdout), n_users, n_anime, resume=True)
    second = tr.Trainer(device="cpu", checkpoint_dir=str(tmp_path / "port"), **kw2).fit(
        RatingsDataset(*train), RatingsDataset(*holdout), n_users, n_anime, resume=True)
    assert second.epochs_run == second_j.epochs_run == 5 - (first.best_epoch + 1)
    assert_histories_match(second.history, second_j.history)


def test_checkpointer_keeps_the_best_only_and_restores_in_place(tmp_path):
    arrays = initial_arrays(20, 10, 8)
    state = tr.cast_table_moments(tr.train_state_from_numpy(arrays, "cpu"), torch.bfloat16)
    ck = Checkpointer(tmp_path / "ck")
    assert ck.latest_step() is None
    ck.save(0, state)
    state.adam.count = 7
    ck.save(5, state)
    assert ck.steps() == [5]
    other = tr.train_state_from_numpy(initial_arrays(20, 10, 8, seed=9), "cpu")
    ck.restore(other)
    assert other.adam.count == 7 and other.adam.mu["anime_emb"].dtype == torch.bfloat16
    for k, v in tr.train_state_to_numpy(state).items():
        np.testing.assert_array_equal(tr.train_state_to_numpy(other)[k], v, err_msg=k)


def test_trainer_rejects_unported_and_unknown_options():
    # lazy_adam is built and trains, on the per-step path and the device loop.
    train, holdout, n_users, n_anime = datasets(seed=3)
    for device_loop in (False, True):
        res = tr.Trainer(optimizer="lazy_adam", device="cpu", device_loop=device_loop,
                         **dict(FIT, epochs=2, patience=5)).fit(
            RatingsDataset(*train), RatingsDataset(*holdout), n_users, n_anime)
        assert res.epochs_run == 2 and np.isfinite(res.history.to_numpy()).all()
        assert res.history["loss"].iloc[1] < res.history["loss"].iloc[0]
    with pytest.raises(ValueError):
        tr.Trainer(optimizer="sgd", device="cpu")
    with pytest.raises(ValueError):
        tr.Trainer(merge="dot", device_loop=True, device="cpu")


# ---- pipeline, artifacts, CLI ----------------------------------------------------

def test_artifact_store_reads_and_writes_the_jax_layout(tmp_path):
    frame = pd.DataFrame({"a": [1, 2], "b": [0.5, 1.5]})
    port = ArtifactStore(tmp_path)
    port.log_frame("x y.csv", frame, filename="x y.csv", type="csv", metadata={"k": 1})
    port.log_frame("x y.csv", frame.iloc[:1], filename="x y.csv")
    jax_store = JStore(tmp_path)
    handle = jax_store.get("x y.csv:latest")
    assert handle.version == 1 and jax_store.get("x y.csv:v0").metadata == {"k": 1}
    pd.testing.assert_frame_equal(pd.read_csv(handle.file()), frame.iloc[:1])
    jax_store.log("m.npz", files={"m.npz": handle.file()}, metadata={"n": 3}, type="model")
    got = port.get("m.npz")
    assert (got.version, got.type, got.metadata) == (0, "model", {"n": 3})
    assert latest_file(tmp_path, "m.npz") == jax_store.get("m.npz").file()
    with pytest.raises(FileNotFoundError):
        port.get("missing")
    with pytest.raises(ValueError):
        port.get("m.npz:7")


SMALL = ["data.synthetic_users=300", "data.synthetic_anime=120",
         "data.synthetic_interactions=30000", "data.num_reviews=40",
         "model.embedding_size=8", "model.epochs=2", "model.batch_size=1024",
         "model.test_size=1000"]


def test_pipeline_trains_a_run_the_jax_package_loads(tmp_path, capsys):
    cfg = Config().with_overrides(SMALL + ["model.optimizer=fused_adam_bf16m"])
    runner = PipelineRunner(cfg, tmp_path, device="cpu")
    runner.step_ingest()
    runner.step_preprocess()
    result = runner.step_train()
    assert result.state.adam.nu["user_emb"].dtype == torch.bfloat16
    assert np.isfinite(result.history.to_numpy()).all()
    art = runner.store.get("anime_nn_model.npz:latest")
    params, bn = jload_model(art.file("anime_nn_model.npz"))
    np.testing.assert_array_equal(np.asarray(params.user_emb),
                                  result.state.model.user_emb.detach().numpy())
    assert art.metadata["Optimizer"] == "Adam" and art.metadata["epochs_run"] == 2
    header = runner.store.get("anime_nn_history.csv").file().read_text().splitlines()[0]
    assert header == ",loss,mse,val_loss,val_mse,lr"
    weights = pd.read_csv(runner.store.get("user_weights.csv").file())
    np.testing.assert_allclose(np.linalg.norm(weights.to_numpy(), axis=1), 1.0, rtol=1e-5)
    ctx = runner.context()
    assert ctx.vocab.n_users == params.user_emb.shape[0]
    # The CLI's train step on the same store adds a model version.
    assert cli.main(["train", "--run-dir", str(tmp_path), "--device", "cpu",
                     *(a for s in SMALL for a in ("--set", s))]) == 0
    assert "best epoch" in capsys.readouterr().out
    assert runner.store.get("anime_nn_model.npz:latest").version == 1
