"""The port's rating scoring against the JAX package's and the model's own
predict, from the same numpy parameters. Tolerance 1e-5."""

import jax.numpy as jnp
import numpy as np
import torch

from anime_recommendations_tpu.models import two_tower as jtt
from anime_recommendations_tpu.ops import scoring as jscoring
from anime_recommendations_tpu_torch.models import two_tower as tt
from anime_recommendations_tpu_torch.ops import scoring

from test_torch_model import jax_params, numpy_params

torch.set_num_threads(2)


def test_head_affine_matches_jax():
    arrays = numpy_params()
    model = tt.params_from_numpy(arrays, device="cpu")
    np.testing.assert_allclose(scoring.head_affine(model).numpy(),
                               np.asarray(jscoring.head_affine(*jax_params(arrays))),
                               atol=1e-5, rtol=0)


def test_score_all_items_matches_jax_and_predict():
    arrays = numpy_params(n_anime=300)
    arrays["anime_emb"][5] = 0.01  # a zero row would be NaN in the unclamped dense path
    model = tt.params_from_numpy(arrays, device="cpu")
    params, bn = jax_params(arrays)
    full = scoring.score_all_items(model, 17).numpy()
    np.testing.assert_allclose(full, np.asarray(jscoring.score_all_items(params, bn, 17)),
                               atol=1e-5, rtol=0)
    preds = tt.predict(model, torch.full((300,), 17), torch.arange(300)).detach().numpy()
    np.testing.assert_allclose(full, preds, atol=1e-5, rtol=0)


def test_score_topk_matches_jax_and_predict():
    arrays = numpy_params(n_anime=1300)
    model = tt.params_from_numpy(arrays, device="cpu")
    params, bn = jax_params(arrays)
    anime_n, user_n = tt.normalized_tables(model)
    janime_n, juser_n = jtt.normalized_tables(params)
    watched = np.zeros(1300, bool)
    watched[[5, 6, 7, 900]] = True
    users = [17, 3, 39]
    vals, idx = scoring.score_topk(anime_n, user_n[users], scoring.head_affine(model), 6,
                                   mask=~watched)
    jvals, jidx = jscoring.score_topk(janime_n, juser_n[np.asarray(users)],
                                      jscoring.head_affine(params, bn), 6,
                                      mask=jnp.asarray(~watched), block_rows=256)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for row, u in enumerate(users):
        preds = tt.predict(model, torch.full((1300,), u), torch.arange(1300)).detach().numpy()
        preds[watched] = -np.inf
        order = np.argsort(-preds)[:6]
        np.testing.assert_allclose(vals[row].numpy(), preds[order], atol=1e-5, rtol=0)
        assert not set(idx[row].tolist()) & {5, 6, 7, 900}
    # One user as a 1-D row, as model_recs passes it.
    v1, i1 = scoring.score_topk(anime_n, user_n[17], scoring.head_affine(model), 6,
                                mask=~watched)
    np.testing.assert_array_equal(i1.numpy()[0], idx[0].numpy())
