"""The port's convergence harness (train/convergence.py) against the JAX
package's, on the CPU.

The noise floor, the teacher-row map and the rating draws are numpy in both
packages: equal on the same inputs. ``topk_recovery`` scores through each
package's own scoring path from one carried-across state; its overlaps are
shares of top-k sets, equal unless two scores tie within the packages' f32
rounding (random tables: none here). A tiny spec trains with every
optimizer on the CPU, and ``main`` writes the JAX harness's files and keys.
"""

import dataclasses
import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from anime_recommendations_tpu.train import convergence as jconv
from anime_recommendations_tpu.train import trainer as jtr
from anime_recommendations_tpu_torch.data import synthetic
from anime_recommendations_tpu_torch.data.dataset import train_holdout_split
from anime_recommendations_tpu_torch.data.preprocess import drop_useless, scale_ratings
from anime_recommendations_tpu_torch.data.vocab import build_vocab, encode_frame
from anime_recommendations_tpu_torch.train import convergence as conv
from anime_recommendations_tpu_torch.train import trainer as tr
from anime_recommendations_tpu_torch.train.trainer import OPTIMIZERS
from tests.test_torch_train import jax_to_numpy

torch.set_num_threads(2)

TINY = conv.ConvergenceSpec(
    n_users=80, n_anime=40, n_interactions=6_000, embedding_size=8, batch_size=500,
    epochs=2, test_size=500, n_probe_users=8, recall_K=10, mc_draws=16,
    start_lr=2e-3, max_lr=5e-3, min_lr=2e-3,
)


def tiny_data(spec=TINY):
    df = synthetic.synth_ratings(n_users=spec.n_users, n_anime=spec.n_anime,
                                 n_interactions=spec.n_interactions, seed=spec.data_seed)
    U, V, _ = synthetic.planted_factors(spec.n_users, spec.n_anime, spec.latent_dim,
                                        spec.data_seed)
    df = drop_useless(df, num_reviews=0)
    lo, hi = float(df["rating"].min()), float(df["rating"].max())
    df = scale_ratings(df)
    vocab = build_vocab(df)
    encoded = encode_frame(df, vocab)
    _, holdout = train_holdout_split(encoded, test_size=spec.test_size)
    return vocab, encoded, holdout, U, V, lo, hi


def test_noise_floor_teacher_rows_and_draws_match_jax():
    vocab, _, holdout, U, V, lo, hi = tiny_data()
    for got, want in zip(conv._teacher_rows(vocab), jconv._teacher_rows(vocab)):
        np.testing.assert_array_equal(got, want)
    aff = np.random.default_rng(0).normal(size=50)
    np.testing.assert_array_equal(
        conv._scaled_rating_draws(aff, lo, hi, 0.35, 32, np.random.default_rng(1)),
        jconv._scaled_rating_draws(aff, lo, hi, 0.35, 32, np.random.default_rng(1)))
    floor = conv.noise_floor_mse(holdout, vocab, U, V, lo, hi, 0.35, n_draws=64)
    assert floor == jconv.noise_floor_mse(holdout, vocab, U, V, lo, hi, 0.35, n_draws=64)
    assert 0.0 < floor < 0.1


def test_topk_recovery_matches_jax():
    vocab, encoded, _, U, V, _, _ = tiny_data()
    js = jtr.init_train_state(jax.random.PRNGKey(3), vocab.n_users, vocab.n_anime, 8)
    model = tr.train_state_from_numpy(jax_to_numpy(js), "cpu").model.eval()
    got = conv.topk_recovery(model, vocab, encoded, U, V, 20, 5, 15)
    want = jconv.topk_recovery(js.params, js.bn_state, vocab, encoded, U, V, 20, 5, 15)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert 0.0 <= got.topk_overlap <= 1.0 and got.recall_ceiling > 0.0


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_run_convergence_tiny_spec_finishes(optimizer):
    report = conv.run_convergence(dataclasses.replace(TINY, optimizer=optimizer),
                                  verbose=False, device="cpu")
    assert list(report.history.columns) == ["loss", "mse", "val_loss", "val_mse", "lr"]
    assert len(report.history) == TINY.epochs
    assert (report.n_users_trained, report.n_anime_trained) == (TINY.n_users, TINY.n_anime)
    summary = report.summary()
    numbers = [v for k, v in summary.items() if k != "spec"]
    assert np.isfinite(np.asarray(numbers, np.float64)).all(), summary
    assert report.floor_ratio == pytest.approx(report.best_val_mse / report.noise_floor_mse)
    assert summary["spec"]["optimizer"] == optimizer


def test_main_writes_the_jax_harness_files_and_keys(tmp_path, capsys):
    conv.main(["--scale", "ci", "--optimizer", "fused_adam", "--epochs", "1",
               "--out", str(tmp_path), "--device", "cpu"])
    history = pd.read_csv(tmp_path / "history_ci_fused_adam.csv")
    assert list(history.columns) == ["Unnamed: 0", "loss", "mse", "val_loss", "val_mse", "lr"]
    result = json.loads((tmp_path / "result_ci_fused_adam.json").read_text())
    jax_keys = [f.name for f in dataclasses.fields(jconv.ConvergenceReport) if f.name != "history"]
    assert list(result) == jax_keys
    assert list(result["spec"]) == [f.name for f in dataclasses.fields(jconv.ConvergenceSpec)]
    assert result["spec"]["epochs"] == 1 and result["spec"]["optimizer"] == "fused_adam"
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    assert conv._strict_json({"a": float("nan"), "b": np.float32(2)}) == {"a": None, "b": 2.0}


def test_default_out_is_not_the_jax_records():
    assert conv.DEFAULT_OUT.parts[-2:] == ("build", "convergence_torch")
    assert "artifacts" not in conv.DEFAULT_OUT.parts
    for spec, jspec in ((conv.REFERENCE_SCALE, jconv.REFERENCE_SCALE),
                        (conv.CI_SCALE, jconv.CI_SCALE)):
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
