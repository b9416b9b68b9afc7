"""The port's two-tower model against the JAX package's, from the same
numpy parameters. Tolerance 1e-5 (float32 throughout)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_recommendations_tpu.models import two_tower as jtt
from anime_recommendations_tpu.train import model_io as jio
from anime_recommendations_tpu_torch.models import two_tower as tt
from anime_recommendations_tpu_torch.train import model_io

torch.set_num_threads(2)


def numpy_params(n_users=40, n_anime=70, d=32, seed=3):
    """The eight .npz arrays, with a non-trivial head and a ~zero row."""
    rng = np.random.default_rng(seed)
    arrays = {
        "user_emb": rng.uniform(-0.05, 0.05, (n_users, d)).astype(np.float32),
        "anime_emb": rng.uniform(-0.05, 0.05, (n_anime, d)).astype(np.float32),
        "dense_w": np.float32(1.7), "dense_b": np.float32(-0.3),
        "bn_gamma": np.float32(0.9), "bn_beta": np.float32(0.2),
        "moving_mean": np.float32(0.1), "moving_var": np.float32(1.4),
    }
    arrays["anime_emb"][5] = 1e-30  # the clamp keeps this row finite
    return arrays


def jax_params(arrays):
    params = jtt.TwoTowerParams(**{k: jnp.asarray(arrays[k]) for k in tt.PARAM_KEYS})
    bn = jtt.BNState(moving_mean=jnp.asarray(arrays["moving_mean"]),
                     moving_var=jnp.asarray(arrays["moving_var"]))
    return params, bn


def test_params_from_numpy_layout():
    arrays = numpy_params()
    model = tt.params_from_numpy(arrays, device="cpu")
    assert not model.training
    assert {n for n, _ in model.named_parameters()} == set(tt.PARAM_KEYS)
    assert {n for n, _ in model.named_buffers()} == set(tt.BUFFER_KEYS)
    for key in tt.PARAM_KEYS + tt.BUFFER_KEYS:
        np.testing.assert_array_equal(getattr(model, key).detach().numpy(), arrays[key])
    with pytest.raises(KeyError):
        tt.params_from_numpy({k: v for k, v in arrays.items() if k != "bn_beta"}, "cpu")
    # Train mode returns the batch-statistics BatchNorm state beside the
    # prediction and leaves the buffers as they are.
    pred, bn = model.train()(torch.tensor([0, 3]), torch.tensor([0, 9]))
    assert pred.shape == (2,) and isinstance(bn, tt.BNState)
    assert float(bn.moving_var) != float(model.moving_var)
    np.testing.assert_array_equal(model.moving_var.numpy(), arrays["moving_var"])


def test_normalized_tables_match_jax():
    arrays = numpy_params()
    model = tt.params_from_numpy(arrays, device="cpu")
    a, u = tt.normalized_tables(model)
    ja, ju = jtt.normalized_tables(jax_params(arrays)[0])
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-5, rtol=0)
    assert torch.isfinite(a).all() and float(a[5].abs().max()) < 1e-5


def test_cosine_merge_and_predict_match_jax():
    arrays = numpy_params()
    model = tt.params_from_numpy(arrays, device="cpu")
    params, bn = jax_params(arrays)
    rng = np.random.default_rng(4)
    users = rng.integers(0, 40, 200)
    anime = rng.integers(0, 70, 200)
    cos = tt.cosine_merge(model.user_emb[torch.from_numpy(users)],
                          model.anime_emb[torch.from_numpy(anime)])
    jcos = jtt.cosine_merge(params.user_emb[users], params.anime_emb[anime])
    np.testing.assert_allclose(cos.detach().numpy(), np.asarray(jcos), atol=1e-5, rtol=0)
    pred = tt.predict(model, torch.from_numpy(users), torch.from_numpy(anime))
    jpred = jtt.predict(params, bn, jnp.asarray(users), jnp.asarray(anime))
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred), atol=1e-5, rtol=0)
    np.testing.assert_allclose(model(torch.from_numpy(users), torch.from_numpy(anime))
                               .detach().numpy(), np.asarray(jpred), atol=1e-5, rtol=0)


def test_npz_from_jax_save_model_loads_unchanged(tmp_path):
    params = jtt.init_params(jax.random.PRNGKey(7), 30, 50, 16)
    bn = jtt.BNState(moving_mean=jnp.float32(0.3), moving_var=jnp.float32(0.7))
    path = jio.save_model(tmp_path / "anime_nn_model", params, bn)
    model = model_io.load_model(path, device="cpu")
    for key in tt.PARAM_KEYS:
        np.testing.assert_array_equal(getattr(model, key).detach().numpy(),
                                      np.asarray(getattr(params, key)))
    assert float(model.moving_mean) == pytest.approx(0.3)
    assert float(model.moving_var) == pytest.approx(0.7)
    # And back: the port's file loads in the JAX package unchanged.
    back = model_io.save_model(tmp_path / "port_model", model)
    jparams, jbn = jio.load_model(back)
    np.testing.assert_array_equal(np.asarray(jparams.user_emb), np.asarray(params.user_emb))
    assert float(jbn.moving_var) == pytest.approx(0.7)
