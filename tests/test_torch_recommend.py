"""The port's serving slice against the JAX package's, end to end on the CPU.

Both RecContexts are built from the same numpy parameters and the conftest
frames. Every recommender's frame and every Engine method's JSON must be
equal, floats within 1e-5 (1e-2 for bf16 retrieval tables); one request
goes through the port's HTTP server, and the CLI serves a run from an
artifact store written by the JAX package's ArtifactStore. The int8 context
(similarity.retrieval_dtype=int8) and the exact-scan context (topk_kwargs
{"exact_scan": True}) are held to the JAX contexts built the same way, with
the same tolerance: both rescore or score in exact f32.
"""

import json
import math
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from anime_recommendations_tpu.config import Config as JConfig
from anime_recommendations_tpu.data import synthetic as jsynthetic
from anime_recommendations_tpu.data import dataset as jdataset
from anime_recommendations_tpu.data.catalog import Catalog as JCatalog
from anime_recommendations_tpu.data.preprocess import preprocess_ratings as jpreprocess
from anime_recommendations_tpu.data.vocab import build_vocab as jbuild_vocab
from anime_recommendations_tpu.data.vocab import encode_frame as jencode_frame
from anime_recommendations_tpu.pipeline.artifacts import ArtifactStore
from anime_recommendations_tpu.recommend import RecContext as JRecContext
from anime_recommendations_tpu.recommend import batch as jbatch
from anime_recommendations_tpu.recommend import model_recs as j_model_recs
from anime_recommendations_tpu.recommend import similar_anime as j_similar_anime
from anime_recommendations_tpu.recommend import similar_users as j_similar_users
from anime_recommendations_tpu.recommend import user_prefs as j_user_prefs
from anime_recommendations_tpu.recommend import user_recs as j_user_recs
from anime_recommendations_tpu.serve.api import Engine as JEngine
from anime_recommendations_tpu.train.schedule import lr_for_epoch as jlr_for_epoch
from anime_recommendations_tpu.train.model_io import save_model as jsave_model
from anime_recommendations_tpu_torch import cli
from anime_recommendations_tpu_torch.config import Config
from anime_recommendations_tpu_torch.data import dataset, synthetic
from anime_recommendations_tpu_torch.data.catalog import Catalog
from anime_recommendations_tpu_torch.data.preprocess import preprocess_ratings
from anime_recommendations_tpu_torch.data.vocab import build_vocab, encode_frame
from anime_recommendations_tpu_torch.models.two_tower import params_from_numpy
from anime_recommendations_tpu_torch.ops.quantized import quantize_rows
from anime_recommendations_tpu_torch.recommend import batch
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.recommend.model_recs import model_recs
from anime_recommendations_tpu_torch.recommend.similar_anime import similar_anime
from anime_recommendations_tpu_torch.recommend.similar_users import similar_users
from anime_recommendations_tpu_torch.recommend.user_prefs import user_prefs
from anime_recommendations_tpu_torch.recommend.user_recs import user_recs
from anime_recommendations_tpu_torch.serve.api import Engine, make_server
from anime_recommendations_tpu_torch.train.schedule import lr_for_epoch

from test_torch_model import jax_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data(ratings_frame, anime_catalog_frame, synopses_frame):
    """The same frames through the port's data modules and the JAX package's."""
    clean, _ = preprocess_ratings(ratings_frame, num_reviews=50)
    vocab = build_vocab(clean)
    catalog = Catalog.from_frames(anime_catalog_frame, synopses_frame)
    jclean, _ = jpreprocess(ratings_frame, num_reviews=50)
    jvocab = jbuild_vocab(jclean)
    jcatalog = JCatalog.from_frames(anime_catalog_frame, synopses_frame)
    rng = np.random.default_rng(11)
    arrays = {
        "user_emb": rng.uniform(-0.05, 0.05, (vocab.n_users, 32)).astype(np.float32),
        "anime_emb": rng.uniform(-0.05, 0.05, (vocab.n_anime, 32)).astype(np.float32),
        "dense_w": np.float32(2.0), "dense_b": np.float32(0.1),
        "bn_gamma": np.float32(1.1), "bn_beta": np.float32(-0.1),
        "moving_mean": np.float32(0.05), "moving_var": np.float32(0.8),
    }
    return dict(arrays=arrays, clean=clean, port=(vocab, catalog, encode_frame(clean, vocab)),
                jax=(jvocab, jcatalog, jencode_frame(jclean, jvocab)))


def build_both(data, dtype=None, topk_kwargs=None):
    params, bn = jax_params(data["arrays"])
    jctx = JRecContext.build(params, bn, *data["jax"],
                             retrieval_dtype={"bf16": jnp.bfloat16}.get(dtype, dtype),
                             topk_kwargs=topk_kwargs)
    pctx = RecContext.build(params_from_numpy(data["arrays"], "cpu"), *data["port"],
                            device="cpu", retrieval_dtype=dtype, topk_kwargs=topk_kwargs)
    return pctx, jctx


@pytest.fixture(scope="module")
def ctxs(data):
    return build_both(data)


def assert_json_close(a, b, atol=1e-5):
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, abs_tol=atol) or (a != a and b != b), (a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            assert_json_close(a[key], b[key], atol)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_json_close(x, y, atol)
    else:
        assert a == b


def frames_equal(a, b, atol=1e-5):
    pd.testing.assert_frame_equal(a, b, check_exact=False, atol=atol, rtol=0)


def users_of(ctx, *positions):
    return [int(ctx.vocab.user_ids[p]) for p in positions]


SIMILAR_ANIME_CALLS = {
    "plain": dict(count=8),
    "types": dict(count=10, types=["TV"]),
    "genres": dict(count=10, genres=["Action", "None", None]),
}


@pytest.mark.parametrize("call", sorted(SIMILAR_ANIME_CALLS))
def test_similar_anime_matches_jax(ctxs, call):
    pctx, jctx = ctxs
    name = pctx.catalog.anime["Name"].iloc[5]
    got = similar_anime(pctx, name, **SIMILAR_ANIME_CALLS[call])
    want = j_similar_anime(jctx, name, **SIMILAR_ANIME_CALLS[call])
    frames_equal(got[0], want[0])
    assert got[1:] == want[1:] and len(got[0]) > 0


def test_similar_users_and_user_recs_match_jax(ctxs):
    pctx, jctx = ctxs
    for uid in users_of(pctx, 0, 7, 30):
        got = similar_users(pctx, uid, n_users=6, num_faves=2, TV_only=True)
        want = j_similar_users(jctx, uid, n_users=6, num_faves=2, TV_only=True)
        frames_equal(got[0], want[0])
        assert got[1:] == want[1:]
        sim = got[0]["similar_users"].to_numpy()
        frames_equal(user_recs(pctx, uid, sim, n=10)[0], j_user_recs(jctx, uid, sim, n=10)[0])
        frames_equal(user_recs(pctx, uid, sim, n=10, genres=["Action", None, None])[0],
                     j_user_recs(jctx, uid, sim, n=10, genres=["Action", None, None])[0])


def test_user_prefs_matches_jax(ctxs):
    pctx, jctx = ctxs
    for uid in users_of(pctx, 3, 12):
        got, want = user_prefs(pctx, uid, 80.0), j_user_prefs(jctx, uid, 80.0)
        for f in ("genres", "sources", "merged"):
            frames_equal(getattr(got, f), getattr(want, f))
        assert got.genre_frequencies == want.genre_frequencies
        assert got.source_frequencies == want.source_frequencies


def test_user_rows_matches_jax(ctxs):
    """Every rating row of a user, with its index, equal to JAX's frame; an
    empty frame with the same columns for an unknown user."""
    pctx, jctx = ctxs
    for uid in users_of(pctx, 0, 3, 12):
        got = pctx.user_rows(uid)
        assert len(got) > 0
        pd.testing.assert_frame_equal(got, jctx.user_rows(uid))
    unknown = int(pctx.ratings["user_id"].max()) + 1
    pd.testing.assert_frame_equal(pctx.user_rows(unknown), jctx.user_rows(unknown))
    assert pctx.user_rows(unknown).empty


MODEL_RECS_CALLS = {
    "plain": dict(n_recs=7),
    "score_bounds": dict(n_recs=20, min_score=6.0, max_score=9.0),
    "types": dict(n_recs=10, types=["TV", "Movie"]),
}


@pytest.mark.parametrize("call", sorted(MODEL_RECS_CALLS))
def test_model_recs_matches_jax(ctxs, call):
    pctx, jctx = ctxs
    uid = users_of(pctx, 4)[0]
    got = model_recs(pctx, uid, **MODEL_RECS_CALLS[call])
    want = j_model_recs(jctx, uid, **MODEL_RECS_CALLS[call])
    frames_equal(got[0], want[0])
    assert got[1] == want[1] and len(got[0]) > 0


def test_batch_entry_points_match_jax(ctxs):
    pctx, jctx = ctxs
    names = list(pctx.catalog.anime["Name"].iloc[[1, 2, 40]])
    uids = users_of(pctx, 1, 2, 9, 50)
    assert_json_close(batch.similar_anime_batch(pctx, names, count=6),
                      jbatch.similar_anime_batch(jctx, names, count=6))
    assert_json_close(batch.model_recs_batch(pctx, uids, n_recs=5, types=["TV"]),
                      jbatch.model_recs_batch(jctx, uids, n_recs=5, types=["TV"]))
    assert_json_close(batch.similar_users_batch(pctx, uids, n_users=4),
                      jbatch.similar_users_batch(jctx, uids, n_users=4))


def engine_calls(ctx):
    uid, uid2 = users_of(ctx, 1, 20)
    name = ctx.catalog.anime["Name"].iloc[2]
    return {
        "similar_anime": ((name,), dict(k=4)),
        "similar_anime_types": ((name,), dict(k=4, types=["TV"])),
        "similar_users": ((uid,), dict(k=3)),
        "user_prefs": ((uid,), {}),
        "user_recs": ((uid2,), dict(k=5)),
        "model_recs": ((uid,), dict(k=5)),
        "similar_anime_batch": (([name, ctx.catalog.anime["Name"].iloc[7]],), dict(k=3)),
        "model_recs_batch": (([uid, uid2],), dict(k=4)),
        "similar_users_batch": (([uid, uid2],), dict(k=3)),
    }


def test_engine_methods_match_jax(ctxs):
    pctx, jctx = ctxs
    port, ref = Engine(pctx, Config()), JEngine(jctx, JConfig())
    for method, (args, kw) in engine_calls(pctx).items():
        name = method.removesuffix("_types")
        assert_json_close(getattr(port, name)(*args, **kw), getattr(ref, name)(*args, **kw))
    assert port.cache_info()["misses"] == ref.cache_info()["misses"]
    assert port.cache_info()["hits"] == ref.cache_info()["hits"]


def test_bf16_context_matches_jax(data):
    pctx, jctx = build_both(data, "bf16")
    assert pctx.anime_vectors([0]).dtype == torch.bfloat16
    name = pctx.catalog.anime["Name"].iloc[5]
    uid = users_of(pctx, 4)[0]
    frames_equal(similar_anime(pctx, name, count=8)[0],
                 j_similar_anime(jctx, name, count=8)[0], atol=1e-2)
    frames_equal(model_recs(pctx, uid, n_recs=8)[0], j_model_recs(jctx, uid, n_recs=8)[0],
                 atol=1e-2)


def test_unported_retrieval_modes_raise(data):
    vocab, catalog, encoded = data["port"]
    model = params_from_numpy(data["arrays"], "cpu")
    # int8 is ported: f32 rows in logical order for the queries, and scan
    # handles holding the int8 quantization of the shuffled f32 rows.
    ctx = RecContext.build(model, vocab, catalog, encoded, device="cpu", retrieval_dtype="int8")
    assert ctx.anime_vectors().dtype == ctx.user_vectors().dtype == torch.float32
    for norm, scan, qt in ((ctx.anime_vectors(), ctx.anime_scan, ctx.anime_qt),
                           (ctx.user_vectors(), ctx.user_scan, ctx.user_qt)):
        assert scan.table is qt and qt.q.dtype == torch.int8
        assert torch.equal(qt.f32, norm[scan.perm])
        assert torch.equal(qt.q, quantize_rows(norm[scan.perm]).q)
    exact_int8 = RecContext.build(model, vocab, catalog, encoded, device="cpu",
                                  retrieval_dtype="i8", topk_kwargs={"exact_scan": True})
    with pytest.raises(ValueError, match="float-table mode"):
        similar_anime(exact_int8, catalog.anime["Name"].iloc[5], count=3)
    with pytest.raises(ValueError, match="ann must be"):
        RecContext.build(model, vocab, catalog, encoded, device="cpu", ann="hnsw")
    with pytest.raises(ValueError):
        RecContext.build(model, vocab, catalog, encoded, device="cpu", retrieval_dtype="f16")


def test_http_server_answers_like_jax_engine(ctxs):
    pctx, jctx = ctxs
    server = make_server(pctx, Config(), host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        uid = users_of(pctx, 4)[0]
        url = f"http://127.0.0.1:{server.server_address[1]}/model_recs?user_id={uid}&k=5"
        with urllib.request.urlopen(url, timeout=60) as resp:
            body = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert_json_close(body, JEngine(jctx, JConfig()).model_recs(uid, k=5))


def write_jax_store(data, anime_catalog_frame, synopses_frame, tmp_path):
    """What the JAX pipeline's ingest, preprocess and train steps log."""
    arrays, clean, (vocab, _, _) = data["arrays"], data["clean"], data["port"]
    store = ArtifactStore(tmp_path / Config().main.project_name / "artifacts")
    params, bn = jax_params(arrays)
    model_path = jsave_model(tmp_path / "anime_nn_model", params, bn)
    vocab.save(tmp_path / "vocab.json")
    store.log("anime_nn_model.npz", files={"anime_nn_model.npz": model_path,
                                           "vocab.json": tmp_path / "vocab.json"})
    store.log_frame("preprocessed_stats.parquet", clean, filename="preprocessed_stats.parquet")
    store.log_frame("all_anime.csv", anime_catalog_frame, filename="all_anime.csv")
    store.log_frame("synopses.csv", synopses_frame, filename="synopses.csv")


def test_cli_serves_a_run_from_the_jax_artifact_store(
        data, ctxs, anime_catalog_frame, synopses_frame, tmp_path, capsys):
    from anime_recommendations_tpu_torch.pipeline.runner import context_from_store

    cfg = Config()
    write_jax_store(data, anime_catalog_frame, synopses_frame, tmp_path)
    ctx = context_from_store(cfg, tmp_path, device="cpu")
    uid = users_of(ctx, 4)[0]
    want, _ = model_recs(ctx, uid, n_recs=5)
    # The same answer as the context built from the frames (the CSV round
    # trip changes only column dtypes).
    assert want.to_string() == model_recs(ctxs[0], uid, n_recs=5)[0].to_string()
    assert cli.main(["model-recs", str(uid), "-k", "5", "--run-dir", str(tmp_path),
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == want.to_string().strip()

    bf16 = context_from_store(Config().with_overrides(["similarity.retrieval_dtype=bf16"]),
                              tmp_path, device="cpu")
    assert bf16.anime_vectors([0]).dtype == torch.bfloat16
    name = ctx.catalog.anime["Name"].iloc[2]
    want, _, _ = similar_anime(bf16, name, count=3)
    assert cli.main(["similar-anime", name, "-k", "3", "--run-dir", str(tmp_path),
                     "--device", "cpu", "--set", "similarity.retrieval_dtype=bf16"]) == 0
    assert capsys.readouterr().out.strip() == want.to_string().strip()


def test_context_from_store_leaves_no_table_of_the_model_on_the_device(
        data, anime_catalog_frame, synopses_frame, tmp_path, monkeypatch):
    """context_from_store loads the model on the host and hands it so to
    RecContext.build, whatever the device: the device gets the context's
    one copy of each table, streamed in chunks, and none of the model's."""
    from anime_recommendations_tpu_torch.pipeline import runner

    write_jax_store(data, anime_catalog_frame, synopses_frame, tmp_path)
    seen = {}

    def build(model, vocab, catalog, ratings, *, device, **kw):
        seen.update(device=device, model={t.device.type for t in model.state_dict().values()})
        return "context"

    monkeypatch.setattr(runner.RecContext, "build", build)
    assert runner.context_from_store(Config(), tmp_path, device="cuda") == "context"
    assert seen == {"device": "cuda", "model": {"cpu"}}


def test_port_data_modules_match_jax(data):
    """The port's copies of config, data, vocab, dataset and schedule give
    what the JAX package's do."""
    (vocab, catalog, encoded), (jvocab, jcatalog, jencoded) = data["port"], data["jax"]
    np.testing.assert_array_equal(vocab.user_ids, jvocab.user_ids)
    np.testing.assert_array_equal(vocab.anime_ids, jvocab.anime_ids)
    pd.testing.assert_frame_equal(encoded, jencoded)
    pd.testing.assert_frame_equal(catalog.anime, jcatalog.anime)
    name = catalog.anime["Name"].iloc[9]
    assert catalog.resolve_query(name) == jcatalog.resolve_query(name)
    assert Config().to_dict() == JConfig().to_dict()
    raw = synthetic.synth_ratings(n_users=60, n_anime=40, n_interactions=900, seed=3)
    pd.testing.assert_frame_equal(
        raw, jsynthetic.synth_ratings(n_users=60, n_anime=40, n_interactions=900, seed=3))
    cat = synthetic.synth_anime_catalog(n_anime=40, seed=3)
    pd.testing.assert_frame_equal(cat, jsynthetic.synth_anime_catalog(n_anime=40, seed=3))
    pd.testing.assert_frame_equal(synthetic.synth_synopses(cat, seed=3),
                                  jsynthetic.synth_synopses(cat, seed=3))
    train, holdout = dataset.train_holdout_split(encoded, test_size=500)
    jtrain, jholdout = jdataset.train_holdout_split(jencoded, test_size=500)
    for got, want in ((train, jtrain), (holdout, jholdout)):
        for col in ("users", "anime", "ratings"):
            np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    for kw in (dict(shuffle=True, seed=4), dict(shuffle=False)):
        got = list(train.iter_batches(1000, **kw))
        want = list(jtrain.iter_batches(1000, **kw))
        assert len(got) == len(want) == train.num_batches(1000)
        for a, b in zip(got, want):
            for col in ("users", "anime", "ratings", "weights"):
                np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
    assert got[-1].weights.sum() == len(train) % 1000  # weight-0 padded last batch
    for epoch in range(12):
        kw = dict(start_lr=1e-5, max_lr=5e-5, min_lr=1e-5, rampup_epochs=5,
                  sustain_epochs=2, exp_decay=0.8)
        assert lr_for_epoch(epoch, **kw) == jlr_for_epoch(epoch, **kw)


# ---- the int8 context and the exact-scan context --------------------------------

RETRIEVAL_MODES = {"int8": dict(dtype="int8"), "exact_scan": dict(topk_kwargs={"exact_scan": True})}


@pytest.fixture(scope="module", params=sorted(RETRIEVAL_MODES))
def mode_ctxs(request, data):
    """(port, JAX) contexts built the same way: an int8 context (its scans
    through ops/quantized.py) or an f32 one whose scans are exact."""
    return build_both(data, **RETRIEVAL_MODES[request.param])


def test_retrieval_mode_similar_anime_matches_jax(mode_ctxs):
    pctx, jctx = mode_ctxs
    for pos in (5, 17):
        name = pctx.catalog.anime["Name"].iloc[pos]
        for call in SIMILAR_ANIME_CALLS.values():
            got, want = similar_anime(pctx, name, **call), j_similar_anime(jctx, name, **call)
            frames_equal(got[0], want[0])
            assert got[1:] == want[1:] and len(got[0]) > 0


def test_retrieval_mode_similar_users_and_user_recs_match_jax(mode_ctxs):
    pctx, jctx = mode_ctxs
    for uid in users_of(pctx, 0, 7, 30):
        got = similar_users(pctx, uid, n_users=6, num_faves=2, TV_only=True)
        want = j_similar_users(jctx, uid, n_users=6, num_faves=2, TV_only=True)
        frames_equal(got[0], want[0])
        assert got[1:] == want[1:]
        sim = got[0]["similar_users"].to_numpy()
        frames_equal(user_recs(pctx, uid, sim, n=10)[0], j_user_recs(jctx, uid, sim, n=10)[0])


def test_retrieval_mode_model_recs_matches_jax(mode_ctxs):
    pctx, jctx = mode_ctxs
    for uid in users_of(pctx, 4, 40):
        for call in MODEL_RECS_CALLS.values():
            got, want = model_recs(pctx, uid, **call), j_model_recs(jctx, uid, **call)
            frames_equal(got[0], want[0])
            assert got[1] == want[1]


def test_retrieval_mode_batch_entry_points_match_jax(mode_ctxs):
    pctx, jctx = mode_ctxs
    names = list(pctx.catalog.anime["Name"].iloc[[1, 2, 40]])
    uids = users_of(pctx, 1, 2, 9, 50)
    assert_json_close(batch.similar_anime_batch(pctx, names, count=6),
                      jbatch.similar_anime_batch(jctx, names, count=6))
    assert_json_close(batch.model_recs_batch(pctx, uids, n_recs=5, types=["TV"]),
                      jbatch.model_recs_batch(jctx, uids, n_recs=5, types=["TV"]))
    assert_json_close(batch.similar_users_batch(pctx, uids, n_users=4),
                      jbatch.similar_users_batch(jctx, uids, n_users=4))


def test_retrieval_mode_engine_methods_match_jax(mode_ctxs):
    pctx, jctx = mode_ctxs
    port, ref = Engine(pctx, Config()), JEngine(jctx, JConfig())
    for method, (args, kw) in engine_calls(pctx).items():
        name = method.removesuffix("_types")
        assert_json_close(getattr(port, name)(*args, **kw), getattr(ref, name)(*args, **kw))


@pytest.mark.parametrize("mode", sorted(RETRIEVAL_MODES))
def test_retrieval_mode_context_from_store(mode, data, ctxs, anime_catalog_frame,
                                           synopses_frame, tmp_path, capsys):
    """The int8 context through the config key, as the CLI builds it; the
    exact-scan context through context_from_store's topk_kwargs."""
    from anime_recommendations_tpu_torch.pipeline.runner import context_from_store

    write_jax_store(data, anime_catalog_frame, synopses_frame, tmp_path)
    sets = ["similarity.retrieval_dtype=int8"] if mode == "int8" else []
    kw = RETRIEVAL_MODES[mode].get("topk_kwargs")
    ctx = context_from_store(Config().with_overrides(sets), tmp_path, device="cpu",
                             topk_kwargs=kw)
    assert ctx.topk_kwargs == (kw or {}) and (ctx.anime_qt is not None) == (mode == "int8")
    uid = users_of(ctx, 4)[0]
    want, _ = model_recs(ctx, uid, n_recs=5)
    # The same rows and (exact f32) values as the f32 context's two-stage
    # scan (the CSV round trip changes only column dtypes).
    ref = model_recs(ctxs[0], uid, n_recs=5)[0]
    assert want["Name"].tolist() == ref["Name"].tolist()
    np.testing.assert_allclose(want["Prediction"], ref["Prediction"], atol=1e-5, rtol=0)
    if mode == "int8":
        flags = [a for s in sets for a in ("--set", s)]
        assert cli.main(["model-recs", str(uid), "-k", "5", "--run-dir", str(tmp_path),
                         "--device", "cpu", *flags]) == 0
        assert capsys.readouterr().out.strip() == want.to_string().strip()
