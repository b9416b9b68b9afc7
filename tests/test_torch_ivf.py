"""The port's IVF retrieval (ops/ivf.py) against the JAX package's, on the CPU.

First every case of tests/test_ivf.py on the port; then the port held to the
JAX package on the same numpy inputs: the build (the same initial rows,
centroids within 1e-5, identical buckets and spill list), ivf_topk on one
JAX-built index carried across with ivf_from_numpy (ids equal, values within
1e-6), add_rows (identical layout, overflow included), the query chunk the
gather budget picks, and ann="ivf" retrieval contexts through every
recommender (the tolerances of tests/test_torch_recommend.py). The tables
are tie-free: torch.topk and jax.lax.top_k may order equal scores apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_recommendations_tpu.ops import ivf as jivf
from anime_recommendations_tpu.recommend import RecContext as JRecContext
from anime_recommendations_tpu.recommend import batch as jbatch
from anime_recommendations_tpu.recommend import model_recs as j_model_recs
from anime_recommendations_tpu.recommend import similar_anime as j_similar_anime
from anime_recommendations_tpu.recommend import similar_users as j_similar_users
from anime_recommendations_tpu.recommend import user_recs as j_user_recs
from anime_recommendations_tpu.serve.api import Engine as JEngine
from anime_recommendations_tpu.config import Config as JConfig
from anime_recommendations_tpu_torch.config import Config
from anime_recommendations_tpu_torch.models.two_tower import params_from_numpy
from anime_recommendations_tpu_torch.ops.ivf import (
    GATHER_BUDGET,
    IVFIndex,
    add_rows,
    build_ivf,
    ivf_from_numpy,
    ivf_topk,
    query_chunk_for,
)
from anime_recommendations_tpu_torch.ops.topk import cosine_topk
from anime_recommendations_tpu_torch.recommend import batch
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.recommend.model_recs import model_recs
from anime_recommendations_tpu_torch.recommend.similar_anime import similar_anime
from anime_recommendations_tpu_torch.recommend.similar_users import similar_users
from anime_recommendations_tpu_torch.recommend.user_recs import user_recs
from anime_recommendations_tpu_torch.serve.api import Engine

from test_torch_model import jax_params
from test_torch_recommend import (  # noqa: F401  (data is a module fixture)
    MODEL_RECS_CALLS,
    SIMILAR_ANIME_CALLS,
    assert_json_close,
    data,
    engine_calls,
    frames_equal,
    users_of,
)

torch.set_num_threads(2)


def _blob_table(rng, n=4096, d=32, n_centers=64, noise=0.15):
    centers = rng.normal(size=(n_centers, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows = centers[rng.integers(0, n_centers, n)] + noise * rng.normal(size=(n, d))
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows.astype(np.float32)


def _recall(ids, oracle):
    return np.mean([len(set(ids[i]) & set(oracle[i])) / oracle.shape[1] for i in range(len(ids))])


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _layout(index):
    """(buckets, spill) of either package's index, as numpy int64."""
    return np.asarray(index.buckets, np.int64), np.asarray(index.spill, np.int64)


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(11)
    W = _blob_table(rng)
    index = build_ivf(_t(W), n_clusters=64, iters=8, seed=3)
    q = W[rng.integers(0, len(W), 50)]
    oracle = np.argsort(-(q @ W.T), axis=1)[:, :10]
    return W, index, q, oracle


# ---- tests/test_ivf.py's cases on the port ---------------------------------------

def test_recall_on_clustered_data(blobs):
    _, index, q, oracle = blobs
    _, ids = ivf_topk(index, _t(q), k=10, probes=8)
    assert _recall(ids.numpy(), oracle) >= 0.95


def test_probe_all_is_exact(blobs):
    W, index, q, _ = blobs
    vals, _ = ivf_topk(index, _t(q), k=10, probes=index.n_clusters)
    np.testing.assert_allclose(vals.numpy(), -np.sort(-(q @ W.T), axis=1)[:, :10], atol=1e-5)


def test_every_row_is_bucketed_or_spilled(blobs):
    _, index, _, _ = blobs
    ids = np.concatenate([index.buckets.numpy().ravel(), index.spill.numpy()])
    ids = ids[ids >= 0]
    assert len(ids) == len(index.table) == len(np.unique(ids))


def test_spill_preserves_exactness_under_tiny_caps():
    rng = np.random.default_rng(5)
    W = _blob_table(rng, n=1024, d=16, n_centers=8)
    # cap_factor 0.5 sends most rows of each cluster to the spill list.
    index = build_ivf(_t(W), n_clusters=16, iters=4, seed=1, cap_factor=0.5)
    assert int((index.spill >= 0).sum()) > 0
    q = W[:20]
    vals, _ = ivf_topk(index, _t(q), k=5, probes=16)
    np.testing.assert_allclose(vals.numpy(), -np.sort(-(q @ W.T), axis=1)[:, :5], atol=1e-5)


def test_int8_storage_matches_f32_path(blobs):
    W, _, q, oracle = blobs
    index8 = build_ivf(_t(W), n_clusters=64, iters=8, seed=3, storage="int8")
    assert index8.q8 is not None and index8.q8.dtype == torch.int8
    # Probing every cluster, this well-separated data keeps the true top-k
    # inside the int8 pool (not so in general: ops/ivf.py's docstring).
    vals, _ = ivf_topk(index8, _t(q), k=10, probes=index8.n_clusters)
    np.testing.assert_allclose(vals.numpy(), -np.sort(-(q @ W.T), axis=1)[:, :10], atol=1e-5)
    _, ids_p = ivf_topk(index8, _t(q), k=10, probes=8)
    assert _recall(ids_p.numpy(), oracle) >= 0.95


def test_exclude_drops_self(blobs):
    W, index, _, _ = blobs
    qi = np.arange(8)
    _, ids = ivf_topk(index, _t(W[qi]), k=10, probes=index.n_clusters, exclude=_t(qi))
    for r, i in enumerate(qi):
        assert i not in ids[r].tolist()


def test_single_query_squeezes(blobs):
    _, index, q, _ = blobs
    vals, ids = ivf_topk(index, _t(q[0]), k=10, probes=8)
    assert vals.shape == (10,) and ids.shape == (10,)


def test_query_chunk_padding_is_inert(blobs):
    _, index, q, _ = blobs
    # 33 queries in chunks of 16 leave a short last chunk.
    v1, i1 = ivf_topk(index, _t(q[:33]), k=10, probes=8, query_chunk=16)
    v2, i2 = ivf_topk(index, _t(q[:33]), k=10, probes=8, query_chunk=33)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), atol=1e-6)
    assert torch.equal(i1, i2)


def test_headed_scoring_matches_oracle_for_both_slopes(blobs):
    W, index, q, _ = blobs
    for alpha in (1.7, -1.7):
        head = torch.tensor([alpha, 0.3])
        vals, _ = ivf_topk(index, _t(q[:16]), k=5, probes=index.n_clusters, head=head)
        sc = 1.0 / (1.0 + np.exp(-(alpha * (q[:16] @ W.T) + 0.3)))
        np.testing.assert_allclose(vals.numpy(), -np.sort(-sc, axis=1)[:, :5], atol=1e-5,
                                   err_msg=f"alpha={alpha}")


def test_ivf_context_matches_exact_recommendations(data):  # noqa: F811
    vocab, catalog, encoded = data["port"]
    model = params_from_numpy(data["arrays"], "cpu")
    ctx = RecContext.build(model, vocab, catalog, encoded, device="cpu")
    # Probing every cluster makes the f32 IVF context exact.
    ctx_ivf = RecContext.build(model, vocab, catalog, encoded, device="cpu", ann="ivf",
                               ann_probes=10_000)
    assert isinstance(ctx_ivf.anime_table(), IVFIndex)
    name = catalog.anime["Name"].iloc[3]
    f_a, i_a = similar_anime(ctx, name, count=8)[0], similar_anime(ctx_ivf, name, count=8)[0]
    assert list(f_a["Name"]) == list(i_a["Name"])
    np.testing.assert_allclose(f_a["Similarity"], i_a["Similarity"], rtol=1e-5)
    uid = int(ctx.ratings["user_id"].iloc[0])
    assert (list(similar_users(ctx, uid, n_users=6)[0]["similar_users"])
            == list(similar_users(ctx_ivf, uid, n_users=6)[0]["similar_users"]))
    f_m, i_m = model_recs(ctx, uid, n_recs=6)[0], model_recs(ctx_ivf, uid, n_recs=6)[0]
    assert list(f_m["Name"]) == list(i_m["Name"])
    np.testing.assert_allclose(f_m["Prediction"], i_m["Prediction"], rtol=1e-5)


def test_add_rows_probe_all_stays_exact(blobs):
    W, index, _, _ = blobs
    new = _blob_table(np.random.default_rng(21), n=64, d=W.shape[1], n_centers=8)
    grown = add_rows(index, _t(new))
    W2 = np.concatenate([W, new])
    assert grown.table.shape[0] == len(W2)
    ids = np.concatenate([grown.buckets.numpy().ravel(), grown.spill.numpy()])
    ids = ids[ids >= 0]
    assert len(np.unique(ids)) == len(ids) == len(W2)
    q = np.concatenate([W[:10], new[:10]])
    vals, _ = ivf_topk(grown, _t(q), k=10, probes=grown.n_clusters)
    np.testing.assert_allclose(vals.numpy(), -np.sort(-(q @ W2.T), axis=1)[:, :10], atol=1e-5)


def test_add_rows_new_rows_findable_at_small_probes(blobs):
    W, index, _, _ = blobs
    new = _blob_table(np.random.default_rng(22), n=32, d=W.shape[1], n_centers=4)
    grown = add_rows(index, _t(new))
    # A new row's nearest centroid is its own cluster's: one probe finds it.
    _, ids = ivf_topk(grown, _t(new[:8]), k=1, probes=1)
    np.testing.assert_array_equal(ids.numpy().ravel(), np.arange(len(W), len(W) + 8))


def test_add_rows_overflow_goes_to_spill():
    rng = np.random.default_rng(23)
    W = _blob_table(rng, n=256, d=16, n_centers=4)
    index = build_ivf(_t(W), n_clusters=4, iters=4, seed=1, cap_factor=1.0)
    new = _blob_table(rng, n=200, d=16, n_centers=4)
    grown = add_rows(index, _t(new))
    assert int((grown.spill >= 0).sum()) > int((index.spill >= 0).sum())
    W2 = np.concatenate([W, new])
    vals, _ = ivf_topk(grown, _t(new[:5]), k=5, probes=4)
    np.testing.assert_allclose(vals.numpy(), -np.sort(-(new[:5] @ W2.T), axis=1)[:, :5],
                               atol=1e-5)


def test_add_rows_int8_index_grows_quantized(blobs):
    W, _, _, _ = blobs
    index8 = build_ivf(_t(W), n_clusters=64, iters=4, seed=3, storage="int8")
    new = _blob_table(np.random.default_rng(24), n=16, d=W.shape[1], n_centers=4)
    grown = add_rows(index8, _t(new))
    assert grown.q8.shape[0] == grown.table.shape[0] == len(W) + 16
    assert grown.q8.dtype == torch.int8 and grown.scale.shape[0] == len(W) + 16


def test_bf16_table_builds_and_probe_all_matches_bf16_scores(blobs):
    W, _, q, _ = blobs
    Wb = _t(W).to(torch.bfloat16)
    index = build_ivf(Wb, n_clusters=64, iters=4, seed=3)
    assert index.centroids.dtype == torch.float32
    qb = _t(q[:8]).to(torch.bfloat16)
    vals, _ = ivf_topk(index, qb, k=5, probes=index.n_clusters)
    oracle = (qb.float() @ Wb.float().T).numpy()
    np.testing.assert_allclose(vals.numpy(), -np.sort(-oracle, axis=1)[:, :5], atol=2e-2)


def test_fewer_live_candidates_than_k_pads_with_dead_slots():
    W = _blob_table(np.random.default_rng(9), n=256, d=16, n_centers=4)
    index = build_ivf(_t(W), n_clusters=64, iters=4, seed=2, cap_factor=1.0)
    # One probe of a small bucket holds fewer than k live candidates.
    vals, ids = ivf_topk(index, _t(W[0]), k=200, probes=1)
    dead = ~torch.isfinite(vals)
    assert bool(dead.any()) and bool((ids[dead] == -1).all())


# ---- the port against the JAX package ---------------------------------------------

def _jax_arrays(index) -> dict:
    return {f: None if getattr(index, f) is None else np.asarray(getattr(index, f))
            for f in index._fields}


@pytest.fixture(scope="module")
def jax_blobs(blobs):
    W, _, q, _ = blobs
    return {storage: jivf.build_ivf(W, n_clusters=64, iters=8, seed=3, storage=storage)
            for storage in ("f32", "int8")}


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_build_matches_jax(blobs, jax_blobs, storage):
    W = blobs[0]
    # No iteration: the centroids are the initial rows, so both drew the
    # same init_ids from numpy.random.default_rng(seed).
    start = build_ivf(_t(W), n_clusters=64, iters=0, seed=3)
    np.testing.assert_array_equal(start.centroids.numpy(),
                                  np.asarray(jivf.build_ivf(W, 64, iters=0, seed=3).centroids))
    port = build_ivf(_t(W), n_clusters=64, iters=8, seed=3, storage=storage)
    ref = jax_blobs[storage]
    np.testing.assert_allclose(port.centroids.numpy(), np.asarray(ref.centroids), atol=1e-5)
    for got, want in zip(_layout(port), _layout(ref)):
        np.testing.assert_array_equal(got, want)
    if storage == "int8":
        np.testing.assert_array_equal(port.q8.numpy(), np.asarray(ref.q8))
        np.testing.assert_array_equal(port.scale.numpy(), np.asarray(ref.scale))


def test_default_cluster_count_matches_jax():
    from anime_recommendations_tpu_torch.ops.ivf import default_n_clusters

    W = _blob_table(np.random.default_rng(4), n=300, d=8, n_centers=4)
    assert build_ivf(_t(W), iters=1).n_clusters == jivf.build_ivf(W, iters=1).n_clusters == 64
    for n in (10, 64, 5_000, 17_560, 91_641, 2_000_000, 10**9):
        c = min(8192, max(64, 1 << int(round(np.log2(max(64, int(np.sqrt(n))))))))
        assert default_n_clusters(n) == min(c, n)


TOPK_CASES = {
    "plain": dict(k=10, probes=8),
    "probe_all": dict(k=10, probes=64),
    "one_probe": dict(k=10, probes=1),
    "head_up": dict(k=5, probes=8, head=(1.7, 0.3)),
    "head_down": dict(k=5, probes=64, head=(-1.7, 0.3)),
    "head_down_probed": dict(k=5, probes=8, head=(-1.7, 0.3)),
    "mask": dict(k=10, probes=8, mask=True),
    "exclude": dict(k=10, probes=8, exclude=True),
    "mask_exclude_head": dict(k=7, probes=16, mask=True, exclude=True, head=(2.0, -0.1)),
    "dead_slots": dict(k=300, probes=1),
}


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_ivf_topk_matches_jax_on_one_index(blobs, jax_blobs, storage, case):
    W, _, q, _ = blobs
    ref = jax_blobs[storage]
    index = ivf_from_numpy(_jax_arrays(ref), "cpu")
    kw = dict(TOPK_CASES[case])
    jkw, pkw = {}, {}
    if kw.pop("mask", False):
        keep = np.random.default_rng(1).uniform(size=len(W)) > 0.3
        jkw["mask"], pkw["mask"] = jnp.asarray(keep), _t(keep)
    if kw.pop("exclude", False):
        qi = np.arange(len(q)) * 7
        q = W[qi]
        jkw["exclude"], pkw["exclude"] = jnp.asarray(qi, jnp.int32), _t(qi)
    if "head" in kw:
        head = np.asarray(kw.pop("head"), np.float32)
        jkw.update(head=jnp.asarray(head), use_head=True)
        pkw["head"] = _t(head)
    want_v, want_i = jivf.ivf_topk(ref, q, **kw, **jkw)
    got_v, got_i = ivf_topk(index, _t(q), **kw, **pkw)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6, rtol=0)
    # One query at a time, squeezed, as the JAX package gives it.
    for r in (0, 3):
        one_kw = {key: (v[r] if key == "exclude" else v) for key, v in pkw.items()}
        v1, i1 = ivf_topk(index, _t(q[r]), **kw, **one_kw)
        assert v1.shape == (kw["k"],) and torch.equal(i1, got_i[r])


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_add_rows_matches_jax(case):
    rng = np.random.default_rng(23)
    if case == "fits":
        W = _blob_table(rng, n=2048, d=16, n_centers=16)
        new = _blob_table(rng, n=40, d=16, n_centers=16)
        ref = jivf.build_ivf(W, n_clusters=32, iters=4, seed=1)
    else:
        W = _blob_table(rng, n=256, d=16, n_centers=4)
        new = _blob_table(rng, n=200, d=16, n_centers=4)
        ref = jivf.build_ivf(W, n_clusters=4, iters=4, seed=1, cap_factor=1.0)
    grown_ref = jivf.add_rows(ref, new)
    for start in (ivf_from_numpy(_jax_arrays(ref), "cpu"),
                  build_ivf(_t(W), n_clusters=ref.n_clusters, iters=4, seed=1,
                            cap_factor=1.0 if case == "overflow" else 3.0)):
        grown = add_rows(start, _t(new))
        for got, want in zip(_layout(grown), _layout(grown_ref)):
            np.testing.assert_array_equal(got, want)
    spills = [int((np.asarray(index.spill) >= 0).sum()) for index in (ref, grown_ref)]
    assert (spills[1] > spills[0]) == (case == "overflow")


def test_gather_budget_picks_a_chunk_with_the_same_results(blobs):
    _, index, q, _ = blobs
    m = 8 * index.bucket_cap + index.spill.shape[0]
    assert query_chunk_for(m, q.shape[1]) >= len(q)       # all 50 in one chunk
    v1, i1 = ivf_topk(index, _t(q), k=10, probes=8)        # the budget's chunk
    v2, i2 = ivf_topk(index, _t(q), k=10, probes=8, query_chunk=16)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), atol=1e-6, rtol=0)
    assert torch.equal(i1, i2)
    # bench.py's IVF protocol: 2M rows, 2,048 clusters of cap 2,936.
    cap = int(np.ceil(3.0 * 2_000_000 / 2048 / 8) * 8)
    assert query_chunk_for(32 * cap, 128) == GATHER_BUDGET // (32 * cap * 128 * 8) == 11
    assert query_chunk_for(2048 * cap, 128) == 1           # probe-all: one query a chunk
    assert query_chunk_for(8 * index.bucket_cap, 32, budget=1) == 1


# ---- ann="ivf" contexts against the JAX package's ----------------------------------

@pytest.fixture(scope="module", params=[16, 10_000], ids=["probes16", "probe_all"])
def ivf_ctxs(request, data):  # noqa: F811
    params, bn = jax_params(data["arrays"])
    jctx = JRecContext.build(params, bn, *data["jax"], ann="ivf", ann_probes=request.param)
    pctx = RecContext.build(params_from_numpy(data["arrays"], "cpu"), *data["port"],
                            device="cpu", ann="ivf", ann_probes=request.param)
    for table, jtable in ((pctx.anime_table(), jctx.anime_table()),
                          (pctx.user_table(), jctx.user_table())):
        for got, want in zip(_layout(table), _layout(jtable)):
            np.testing.assert_array_equal(got, want)
    assert pctx.topk_kwargs == {"probes": request.param}
    return pctx, jctx


def test_ivf_context_similar_anime_matches_jax(ivf_ctxs):
    pctx, jctx = ivf_ctxs
    for pos in (3, 5, 17):
        name = pctx.catalog.anime["Name"].iloc[pos]
        for call in SIMILAR_ANIME_CALLS.values():
            got, want = similar_anime(pctx, name, **call), j_similar_anime(jctx, name, **call)
            frames_equal(got[0], want[0])
            assert got[1:] == want[1:] and len(got[0]) > 0


def test_ivf_context_similar_users_and_user_recs_match_jax(ivf_ctxs):
    pctx, jctx = ivf_ctxs
    for uid in users_of(pctx, 0, 7, 30):
        got = similar_users(pctx, uid, n_users=6, num_faves=2, TV_only=True)
        want = j_similar_users(jctx, uid, n_users=6, num_faves=2, TV_only=True)
        frames_equal(got[0], want[0])
        sim = got[0]["similar_users"].to_numpy()
        frames_equal(user_recs(pctx, uid, sim, n=10)[0], j_user_recs(jctx, uid, sim, n=10)[0])


def test_ivf_context_model_recs_matches_jax(ivf_ctxs):
    pctx, jctx = ivf_ctxs
    for uid in users_of(pctx, 4, 40):
        for call in MODEL_RECS_CALLS.values():
            got, want = model_recs(pctx, uid, **call), j_model_recs(jctx, uid, **call)
            frames_equal(got[0], want[0])
            assert got[1] == want[1]


def test_ivf_context_batch_and_engine_match_jax(ivf_ctxs):
    pctx, jctx = ivf_ctxs
    names = list(pctx.catalog.anime["Name"].iloc[[1, 2, 40]])
    uids = users_of(pctx, 1, 2, 9, 50)
    assert_json_close(batch.similar_anime_batch(pctx, names, count=6),
                      jbatch.similar_anime_batch(jctx, names, count=6))
    assert_json_close(batch.model_recs_batch(pctx, uids, n_recs=5, types=["TV"]),
                      jbatch.model_recs_batch(jctx, uids, n_recs=5, types=["TV"]))
    assert_json_close(batch.similar_users_batch(pctx, uids, n_users=4),
                      jbatch.similar_users_batch(jctx, uids, n_users=4))
    port, ref = Engine(pctx, Config()), JEngine(jctx, JConfig())
    for method, (args, kw) in engine_calls(pctx).items():
        name = method.removesuffix("_types")
        assert_json_close(getattr(port, name)(*args, **kw), getattr(ref, name)(*args, **kw))


def test_ivf_exact_scan_reads_the_index_table(ivf_ctxs):
    """exact_scan=True on an IVFIndex scans its table exactly (K3 on the card)."""
    pctx, _ = ivf_ctxs
    index = pctx.anime_table()
    q = pctx.anime_vectors(slice(0, 4))
    got = cosine_topk(index, q, 10, exact_scan=True)
    want = cosine_topk(index.table, q, 10, exact_scan=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
