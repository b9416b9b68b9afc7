"""The port's pipeline runner against the JAX package's, on the CPU.

The JAX runner runs ingest, preprocess and train on tests/test_pipeline.py's
small config; the run directory is copied twice and each package's runner
runs the five recommend steps on its own copy, once with the configured
queries and the flow user, once with random picks (the same seed draws the
same picks in both). Every artifact must match: names, versions, metadata
and file names equal, CSVs equal with floats within 1e-5 (ids exactly).

Then the port's run() over all eight steps on a fresh run passes
tests/test_pipeline.py's checks (artifacts, the golden history header, the
flow user across steps, the golden schemas, assert_flow catching a
mismatch and FlowError under main.raise_flow_error) and
tests/test_pipeline_values.py's numpy oracles; without matplotlib it skips
the PNG artifacts with one warning per step and writes every other one; and
``cli pipeline --device cpu`` runs in a subprocess and prints the timings.
"""

import json
import logging
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from anime_recommendations_tpu.config import Config as JConfig
from anime_recommendations_tpu.pipeline.runner import PipelineRunner as JPipelineRunner
from anime_recommendations_tpu_torch.config import Config
from anime_recommendations_tpu_torch.pipeline.runner import STEPS, FlowError, PipelineRunner

from tests.test_pipeline import small_config
from tests.test_pipeline_values import _norm_rows, _oracle_predict

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RECOMMEND_STEPS = ["similar_anime", "similar_users", "user_prefs", "user_recs", "model_recs"]
PNGS = ["neural_network_loss.png", "favorite_genres.png", "favorite_source_material.png",
        "recs_favorite_genres.png", "recs_favorite_sources.png"]
# Overrides of the runs that pick at random: a title, the similar-users
# query, user_recs' user (outside the flow) and model_recs' user.
PICKS = {
    "configured": [],
    "random": ["similarity.random_anime=true", "similarity.spec_types=true",
               "users.sim_random_user=true", "users.ID_recs_from_flow=false",
               "users.recs_ID_from_conf=false", "users.ID_spec_genres=true",
               "model_recs.model_ID_flow=false", "model_recs.specify_types=true"],
}


def port_config(jcfg: JConfig) -> Config:
    return Config.from_dict(jcfg.to_dict())


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """small_config and a run directory after the JAX runner's ingest,
    preprocess and train, with a trained user as the configured query."""
    cfg = small_config(tmp_path_factory.mktemp("jax_trained"))
    runner = JPipelineRunner(cfg)
    runner.run(["ingest", "preprocess", "train"])
    cfg.users.sim_user_query = int(runner.context().vocab.user_ids[0])
    return cfg


@pytest.fixture(scope="module", params=sorted(PICKS))
def both_stores(request, jax_trained, tmp_path_factory):
    """(JAX store, port store, port runner) after each package's recommend
    steps on its own copy of the JAX run."""
    stores = []
    for package in ("jax", "port"):
        cfg = JConfig.from_dict(jax_trained.to_dict()).with_overrides(PICKS[request.param])
        cfg.main.run_dir = str(tmp_path_factory.mktemp(package) / "runs")
        shutil.copytree(jax_trained.main.run_dir, cfg.main.run_dir)
        if package == "jax":
            runner = JPipelineRunner(cfg)
        else:
            runner = PipelineRunner(port_config(cfg), device="cpu")
        runner.run(RECOMMEND_STEPS)
        stores.append(runner.store)
    return stores[0], stores[1], runner


def test_recommend_steps_match_jax(both_stores):
    jstore, pstore, _ = both_stores
    assert pstore.names() == jstore.names()
    assert set(PNGS[1:]) <= set(jstore.names())
    for name in jstore.names():
        want, got = jstore.get(f"{name}:latest"), pstore.get(f"{name}:latest")
        assert (got.version, got.type, got.metadata) == (want.version, want.type, want.metadata)
        assert [f.name for f in got.files()] == [f.name for f in want.files()], name
        for g, w in zip(got.files(), want.files()):
            if w.suffix == ".csv":
                pd.testing.assert_frame_equal(pd.read_csv(g), pd.read_csv(w),
                                              check_exact=False, atol=1e-5, rtol=0)


def test_recommend_steps_write_the_timings(both_stores):
    _, _, runner = both_stores
    timings = json.loads((runner.run_dir / "timings.json").read_text())
    assert list(timings) == RECOMMEND_STEPS + ["step_timer"]
    assert all(timings[s] > 0 for s in RECOMMEND_STEPS)
    sections = timings["step_timer"]
    assert set(sections) == set(RECOMMEND_STEPS) | {"context"}
    assert sections["context"]["count"] == 1
    assert sections["similar_anime"]["total_s"] >= sections["context"]["total_s"]


# ---- the port's run() over all eight steps -------------------------------------

@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's run() over every step on small_config. The configured
    similar-users query (0) is not in the synthetic vocab, so a random user
    becomes the flow user."""
    cfg = port_config(small_config(tmp_path_factory.mktemp("port_run")))
    runner = PipelineRunner(cfg, device="cpu")
    timings = runner.run()
    assert list(timings) == list(STEPS)
    return runner


def test_pipeline_artifacts_exist(port_run):
    for name in [
        "full_data_set.parquet", "all_anime.csv", "synopses.csv",
        "preprocessed_stats.parquet", "anime_nn_model.npz",
        "anime_nn_history.csv", "neural_network_loss.png",
        "similar_users.csv", "ID_used.csv", "user_prefs.csv",
        "user_recs.csv", "model_recs.csv",
        "favorite_genres.png", "favorite_source_material.png",
        "user_recs_preferences.csv", "recs_favorite_genres.png", "recs_favorite_sources.png",
    ]:
        assert port_run.store.exists(f"{name}:latest"), name
    timings = json.loads((port_run.run_dir / "timings.json").read_text())
    assert list(timings) == [*STEPS, "step_timer"]
    assert set(timings["step_timer"]) == {*STEPS, "context", "train.fit", "train.weight_csvs"}
    assert timings["step_timer"]["train.fit"]["total_s"] < timings["train"]


def test_history_has_golden_header(port_run):
    path = port_run.store.get("anime_nn_history.csv:latest").file()
    assert path.read_text().splitlines()[0] == ",loss,mse,val_loss,val_mse,lr"


def test_flow_id_consistent_across_steps(port_run):
    store = port_run.store
    uid = port_run._flow_user()
    assert int(store.get("similar_users.csv:latest").metadata["Queried user"]) == uid
    assert int(store.get("user_prefs.csv:latest").metadata["ID"]) == uid
    assert int(store.get("user_recs.csv:latest").metadata["Queried user"]) == uid
    assert int(store.get("model_recs.csv:latest").metadata["Queried user"]) == uid
    assert port_run.assert_flow(uid)


def test_output_schemas_match_goldens(port_run):
    store = port_run.store
    sim_users = pd.read_csv(store.get("similar_users.csv:latest").file())
    assert list(sim_users.columns) == ["similar_users", "similarity", "favorite_animes"]
    user_recs = pd.read_csv(store.get("user_recs.csv:latest").file())
    assert list(user_recs.columns) == [
        "anime_id", "Name", "n_user_prefs", "Source", "Genres", "Sypnopsis",
        "Episodes", "Japanese name", "Studios", "Premiered", "Score", "Type",
    ]
    model_recs = pd.read_csv(store.get("model_recs.csv:latest").file())
    assert list(model_recs.columns) == [
        "Name", "Prediction", "Genres", "Source", "anime_id", "Sypnopsis",
        "Episodes", "Japanese name", "Studios", "Premiered", "Score", "Type",
    ]
    prefs = pd.read_csv(store.get("user_prefs.csv:latest").file(), index_col=0)
    assert list(prefs.columns) == ["eng_version", "Source", "Genres"]


def _weights(store):
    art = store.get("anime_nn_model.npz:latest")
    with np.load(art.file("anime_nn_model.npz")) as z:
        w = {k: np.asarray(z[k], np.float64) for k in z.files}
    vocab = json.loads(art.file("vocab.json").read_text())
    return w, np.asarray(vocab["user_ids"]), np.asarray(vocab["anime_ids"])


def test_csv_values_match_numpy_oracles(port_run):
    """tests/test_pipeline_values.py's oracles, from the stored weights alone."""
    store = port_run.store
    w, user_ids, anime_ids = _weights(store)
    catalog = pd.read_csv(store.get("all_anime.csv:latest").file())

    art = next(store.get(f"{n}:latest") for n in store.names()
               if store.get(f"{n}:latest").metadata.get("Queried anime"))
    got = pd.read_csv(art.file())
    q_id = int(catalog.loc[catalog["Name"] == art.metadata["Queried anime"], "MAL_ID"].iloc[0])
    q_idx = int(np.flatnonzero(anime_ids == q_id)[0])
    nt = _norm_rows(w["anime_emb"])
    scores = nt @ nt[q_idx]
    scores[q_idx] = -np.inf
    top = np.argsort(-scores)[:len(got)]
    np.testing.assert_array_equal(got["Name"].map(catalog.set_index("Name")["MAL_ID"]),
                                  anime_ids[top])
    np.testing.assert_allclose(got["Similarity"], scores[top], rtol=1e-5, atol=1e-6)

    got = pd.read_csv(store.get("similar_users.csv:latest").file())
    q_idx = int(np.flatnonzero(user_ids == port_run._flow_user())[0])
    nt = _norm_rows(w["user_emb"])
    scores = nt @ nt[q_idx]
    scores[q_idx] = -np.inf
    top = np.argsort(-scores)[:len(got)]
    np.testing.assert_array_equal(got["similar_users"], user_ids[top])
    np.testing.assert_allclose(got["similarity"], scores[top], rtol=1e-5, atol=1e-6)

    got = pd.read_csv(store.get("model_recs.csv:latest").file())
    uid = int(store.get("model_recs.csv:latest").metadata["Queried user"])
    stats = pd.read_parquet(store.get("preprocessed_stats.parquet:latest").file())
    watched = stats.loc[stats["user_id"] == uid, "anime_id"].to_numpy()
    unwatched = np.flatnonzero(~np.isin(anime_ids, watched))
    u_idx = int(np.flatnonzero(user_ids == uid)[0])
    rows = np.asarray([int(np.flatnonzero(anime_ids == i)[0]) for i in got["anime_id"]])
    np.testing.assert_allclose(got["Prediction"], _oracle_predict(w, u_idx, rows),
                               rtol=1e-5, atol=1e-6)
    want = unwatched[np.argsort(-_oracle_predict(w, u_idx, unwatched))[:len(got)]]
    assert set(rows) == set(want.tolist())


def test_assert_flow_detects_mismatch(port_run):
    store = port_run.store
    store.log_frame("ID_used.csv", pd.DataFrame([999999], columns=["User_ID"]),
                    filename="999999.csv", metadata={"Queried user": 999999})
    uid = int(store.get("similar_users.csv:latest").metadata["Queried user"])
    try:
        assert not port_run.assert_flow(uid)
        assert port_run.cfg.main.raise_flow_error and port_run.cfg.users.ID_recs_from_flow
        with pytest.raises(FlowError):
            port_run.step_user_recs()
    finally:   # a consistent ID artifact again for the tests after this one
        store.log_frame("ID_used.csv", pd.DataFrame([uid], columns=["User_ID"]),
                        filename=f"{uid}.csv", metadata={"Queried user": uid})
    assert port_run.assert_flow(uid)
    # similar_users must have found users.recs_n_sim_ID users.
    port_run.cfg.users.recs_n_sim_ID += 1
    try:
        assert not port_run.assert_flow(uid)
    finally:
        port_run.cfg.users.recs_n_sim_ID -= 1


def test_without_matplotlib_pngs_are_skipped(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    runner = PipelineRunner(port_config(small_config(tmp_path)), device="cpu")
    with caplog.at_level(logging.WARNING, logger="anime_recommendations_tpu_torch"):
        runner.run()
    names = runner.store.names()
    assert not set(PNGS) & set(names)
    assert {"anime_nn_model.npz", "anime_nn_history.csv", "similar_users.csv", "ID_used.csv",
            "user_prefs.csv", "user_recs.csv", "user_recs_preferences.csv",
            "model_recs.csv"} <= set(names)
    warnings = [r.getMessage() for r in caplog.records if "matplotlib" in r.getMessage()]
    assert len(warnings) == 3   # train, user_prefs, user_recs: one each
    named = [n for w in warnings for n in w.rsplit("artifacts ", 1)[1].split(", ")]
    assert sorted(named) == sorted(PNGS)


CLI_SETS = ["data.synthetic_users=300", "data.synthetic_anime=120",
            "data.synthetic_interactions=30000", "data.num_reviews=50",
            "model.embedding_size=8", "model.epochs=1", "model.batch_size=1024",
            "model.test_size=1000"]


def run_checked(cmd: list[str]) -> str:
    """stdout of ``cmd`` run from the repo. A failure reports the exit code
    and the whole stderr (every rank's, under torchrun)."""
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"exit code {proc.returncode}; whole stderr:\n{proc.stderr}"
    return proc.stdout


def cli_pipeline(run_dir, *launcher, sets=()):
    """stdout of ``cli pipeline`` on the CPU, started by ``launcher``."""
    return run_checked(
        [*launcher, "-m", "anime_recommendations_tpu_torch.cli", "pipeline",
         "--run-dir", str(run_dir), "--device", "cpu",
         *[a for s in [*CLI_SETS, *sets] for a in ("--set", s)]])


def test_cli_pipeline_prints_the_timings(tmp_path):
    timings = json.loads(cli_pipeline(tmp_path, sys.executable))
    assert list(timings) == [*STEPS, "step_timer"]
    assert all(timings[s] > 0 for s in STEPS)
    assert json.loads((tmp_path / Config().main.project_name / "timings.json").read_text()) \
        == timings


def test_cli_pipeline_under_torchrun(tmp_path):
    """Two gloo ranks: both train (the routed trainer), rank 0 alone runs the
    other steps, logs each artifact once and prints the timings."""
    out = cli_pipeline(tmp_path, sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc_per_node=2",
                       sets=["model.optimizer=fused_adam", "model.device_loop=true"])
    timings = json.loads(out)   # one JSON document: rank 0's
    assert list(timings) == [*STEPS, "step_timer"]
    store = PipelineRunner(Config(), tmp_path, device="cpu").store
    for name in ("full_data_set.parquet", "anime_nn_model.npz", "similar_users.csv",
                 "ID_used.csv", "user_recs.csv", "model_recs.csv"):
        assert store.versions(name) == [0], name


TRAIN_STEPS = ["--steps", "ingest", "preprocess", "train"]


def _history(run_dir) -> pd.DataFrame:
    store = PipelineRunner(Config(), run_dir, device="cpu").store
    return pd.read_csv(store.get("anime_nn_history.csv:latest").file(), index_col=0)


@pytest.fixture(scope="module")
def one_process_history(tmp_path_factory):
    """The history of ``cli pipeline`` over ingest, preprocess and train in
    one process (the one-device Trainer), 2 epochs."""
    run_dir = tmp_path_factory.mktemp("one")
    run_checked([sys.executable, "-m", "anime_recommendations_tpu_torch.cli", "pipeline",
                 "--run-dir", str(run_dir), "--device", "cpu", *TRAIN_STEPS,
                 *[a for s in [*CLI_SETS, "model.epochs=2"] for a in ("--set", s)]])
    return _history(run_dir)


@pytest.mark.parametrize("sets", [["parallel.model_axis=1"],
                                  ["parallel.model_axis=2", "parallel.shard_anime_table=true"]],
                         ids=["psum_2x1", "psum_anime_1x2"])
def test_cli_train_psum_under_torchrun(tmp_path, sets, one_process_history):
    """parallel.routing=psum on two gloo ranks (a 2 x 1 and a 1 x 2 mesh,
    the second with the anime table sharded too) trains through the
    ShardedTrainer: the one-device history, within tests/test_torch_train.py's
    history tolerances (the ranks reorder f32 sums)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "anime_recommendations_tpu_torch.cli", "pipeline", "--run-dir", str(tmp_path),
           "--device", "cpu", *TRAIN_STEPS,
           *[a for s in [*CLI_SETS, "model.epochs=2", "parallel.routing=psum", *sets]
             for a in ("--set", s)]]
    run_checked(cmd)
    got, want = _history(tmp_path), one_process_history
    assert len(got) == 2 and np.isfinite(got.to_numpy()).all()
    np.testing.assert_allclose(got[["loss", "mse"]], want[["loss", "mse"]], rtol=1e-5)
    np.testing.assert_allclose(got[["val_loss", "val_mse"]], want[["val_loss", "val_mse"]],
                               rtol=2e-3)
