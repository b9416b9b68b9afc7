"""Serving a catalog past one card's two copies of its tables and past the
scan grid's old 33,553,920 rows, at small sizes on the CPU and (marked
``cuda``) at the real sizes on the card:

* the one-copy context (recommend/tables.py: the scan copy only, query rows
  read through its inverse permutation) answers every batch and single
  route as the two-copy context did, for f32, bf16, int8 and IVF contexts;
* its streamed build gives the tables bit for bit at any chunk size;
* model_recs_batch's watched sets from the users' rating slices give the
  records the dense masks gave, and its k buckets the same answers;
* the scan wrappers' new limit, and the two-stage scan past the old
  GROUP * 65535 rows (GROUP stubbed small on the CPU; 34,000,000 rows on
  the card), against a blocked plain f32 top-k;
* the scan graphs' work counter and the catalog's scaled string cleaning.

The card tests skip where torch sees no CUDA device. They run in a pytest
process of their own: the context at the amazon shapes needs one free 26 GB
range of the card, and after tests/test_torch_cuda.py in the same process
the allocator keeps ~36 GB of segments that live blocks pin:

    ANIMEREC_TEST_TPU=1 python -m pytest tests/test_torch_large_tables.py -m cuda
"""

import gc
import math
import types

import numpy as np
import pandas as pd
import pytest
import torch

from anime_recommendations_tpu_torch.data import synthetic
from anime_recommendations_tpu_torch.data.catalog import Catalog, load_anime_frame
from anime_recommendations_tpu_torch.data.preprocess import preprocess_ratings
from anime_recommendations_tpu_torch.data.vocab import Vocab, build_vocab, encode_frame
from anime_recommendations_tpu_torch.models.two_tower import (
    BUFFER_KEYS,
    HEAD_KEYS,
    TF_L2_NORM_EPS,
    init_params,
)
from anime_recommendations_tpu_torch.ops import scan_graph, topk
from anime_recommendations_tpu_torch.ops.normalize import l2_normalize_rows
from anime_recommendations_tpu_torch.ops.scoring import score_topk
from anime_recommendations_tpu_torch.recommend import batch, tables
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.recommend.model_recs import model_recs
from anime_recommendations_tpu_torch.recommend.similar_anime import similar_anime
from anime_recommendations_tpu_torch.recommend.similar_users import similar_users
from anime_recommendations_tpu_torch.serve.api import Engine
from anime_recommendations_tpu_torch.utils.text import clean_name, clean_names

MODES = {"f32": dict(), "bf16": dict(retrieval_dtype="bf16"),
         "int8": dict(retrieval_dtype="int8"), "ivf": dict(ann="ivf", ann_probes=4)}


@pytest.fixture(scope="module")
def data():
    ratings = synthetic.synth_ratings(n_users=300, n_anime=120, n_interactions=30_000, seed=7)
    anime = synthetic.synth_anime_catalog(n_anime=120, seed=7)
    clean, _ = preprocess_ratings(ratings, num_reviews=50)
    vocab = build_vocab(clean)
    catalog = Catalog.from_frames(anime, synthetic.synth_synopses(anime, seed=7))
    model = init_params(vocab.n_users, vocab.n_anime, 32,
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.dense_w.fill_(2.0)
        model.moving_var.fill_(0.8)
    return model, vocab, catalog, encode_frame(clean, vocab)


class TwoCopyContext(RecContext):
    """The context as it was before one copy: query rows from a second,
    logical-order copy of the normalized tables (what build_tables kept as
    anime_norm and user_norm)."""

    def attach(self, model):
        dtype = tables.retrieval_dtype_of(getattr(self, "_dtype", None))
        out = torch.float32 if dtype == torch.int8 else dtype
        self._norms = {name: l2_normalize_rows(getattr(model, name).detach().float(),
                                               eps=TF_L2_NORM_EPS, out_dtype=out)
                       for name in ("anime_emb", "user_emb")}
        return self

    def anime_vectors(self, rows=None):
        return self._norms["anime_emb"][torch.as_tensor(rows)]

    def user_vectors(self, rows=None):
        return self._norms["user_emb"][torch.as_tensor(rows)]


def calls(ctx):
    uids = [int(u) for u in ctx.vocab.user_ids[[1, 2, 9, 50]]]
    names = list(ctx.catalog.anime["Name"].iloc[[1, 2, 40]])
    return {
        "similar_anime_batch": lambda: batch.similar_anime_batch(ctx, names, count=6),
        "model_recs_batch": lambda: batch.model_recs_batch(ctx, uids, n_recs=5, types=["TV"]),
        "similar_users_batch": lambda: batch.similar_users_batch(ctx, uids, n_users=4),
        "similar_anime": lambda: similar_anime(ctx, names[0], count=5)[0].to_dict("list"),
        "model_recs": lambda: model_recs(ctx, uids[0], n_recs=5)[0].to_dict("list"),
        "similar_users": lambda: similar_users(ctx, uids[1], n_users=4)[0].to_dict("list"),
        "engine": lambda: Engine(ctx).model_recs_batch(uids[:2], k=4),
    }


@pytest.mark.parametrize("mode", sorted(MODES))
def test_one_copy_context_answers_as_the_two_copy_context(data, mode):
    model, vocab, catalog, frame = data
    ctx = RecContext.build(model, vocab, catalog, frame, device="cpu", **MODES[mode])
    old = TwoCopyContext(**{f: getattr(ctx, f) for f in (
        "vocab", "catalog", "ratings", "head", "anime_scan", "user_scan", "anime_qt",
        "user_qt", "topk_kwargs")})
    old._dtype = MODES[mode].get("retrieval_dtype")
    old.attach(model)
    for name, call in calls(ctx).items():
        assert call() == calls(old)[name](), name
    report = ctx.tables_report()
    assert report["built"] == {"device_bytes": None, "copies": None}    # off the card
    for side, n in (("anime", vocab.n_anime), ("user", vocab.n_users)):
        assert report[side]["rows"] == n
        width = 2 if mode == "bf16" else 4
        assert report[side]["table_bytes"] == n * 32 * width
        assert (report[side]["int8_bytes"] > 0) == (mode == "int8")


def whole_table_build(model, dtype, ann):
    """build_tables as it was: each table normalized whole, then shuffled
    (or indexed) whole."""
    from anime_recommendations_tpu_torch.ops.ivf import build_ivf
    from anime_recommendations_tpu_torch.ops.quantized import QuantizedTable, _quantize

    dt = tables.retrieval_dtype_of(dtype)
    out = torch.float32 if dt == torch.int8 else dt
    scans = []
    for emb, seed in ((model.anime_emb, tables.ANIME_SHUFFLE_SEED),
                      (model.user_emb, tables.USER_SHUFFLE_SEED)):
        norm = l2_normalize_rows(emb.detach().float().contiguous(), eps=TF_L2_NORM_EPS,
                                 out_dtype=out)
        if ann == "ivf":
            scans.append(build_ivf(norm, seed=seed,
                                   storage="int8" if dt == torch.int8 else "f32"))
            continue
        st = topk.shuffle_rows(norm, seed=seed)
        if dt == torch.int8:
            q, scale = _quantize(st.table)
            st = st._replace(table=QuantizedTable(q=q, scale=scale, f32=st.table))
        scans.append(st)
    return scans


def flat(scan) -> list:
    out = []
    for t in scan:
        out += flat(t) if isinstance(t, tuple) else ([] if t is None else [t])
    return out


@pytest.mark.parametrize("chunk_rows", [1, 7, 64, 299, 10_000])
@pytest.mark.parametrize("dtype,ann", [("f32", "off"), ("bf16", "off"), ("int8", "off"),
                                       ("f32", "ivf")])
def test_streamed_build_gives_the_tables_bit_for_bit(data, chunk_rows, dtype, ann,
                                                    monkeypatch):
    """Any chunk size, one that divides no table's rows (7, 64, 299) too,
    for the normalization and for the int8 quantization."""
    from anime_recommendations_tpu_torch.ops import quantized

    model = data[0]
    monkeypatch.setattr(tables, "CHUNK_ROWS", chunk_rows)
    monkeypatch.setattr(quantized, "CHUNK_ROWS", chunk_rows)
    got = tables.build_tables(model, device="cpu", retrieval_dtype=dtype, ann=ann)
    for new, old in zip((got.anime_scan, got.user_scan), whole_table_build(model, dtype, ann)):
        a, b = flat(new), flat(old)
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_logical_rows_read_the_scan_copy(data):
    model = data[0]
    t = tables.build_tables(model, device="cpu")
    want = l2_normalize_rows(model.user_emb.detach(), eps=TF_L2_NORM_EPS)
    assert torch.equal(tables.logical_rows(t.user_scan), want)
    assert torch.equal(tables.logical_rows(t.user_scan, [5, 1, 5]), want[[5, 1, 5]])
    assert torch.equal(tables.logical_rows(t.user_scan, slice(3, 9)), want[3:9])


def dense_model_recs_batch(ctx, user_ids, n_recs):
    """model_recs_batch as it was: one dense watched mask per user, the scan
    at k = n_recs + the most any user watched, kept rows tested per row."""
    masks = [ctx.watched_mask(int(u)) for u in user_ids]
    k = min(n_recs + max(int(m.sum()) for m in masks), ctx.vocab.n_anime)
    vals, idx = topk.host_topk(score_topk, ctx.anime_table(),
                               ctx.user_vectors(ctx.user_indices(user_ids)), ctx.head, k=k,
                               mask=ctx.in_catalog_mask(), graphs=ctx.scan_graphs)
    out = []
    for row, uid in enumerate(user_ids):
        keep = (vals[row] > -1e29) & ~masks[row][np.clip(idx[row], 0, None)]
        ids = ctx.vocab.anime_ids[idx[row][keep][:n_recs]]
        pos, _ = ctx.catalog_positions(ctx.anime_indices(ids))
        out.append({"user_id": int(uid), "anime_ids": ctx.catalog.anime["anime_id"]
                    .to_numpy()[pos].tolist(),
                    "predictions": vals[row][keep][:len(pos)].tolist()})
    return out


@pytest.mark.parametrize("n_recs", [1, 5, 17])
def test_csr_watched_sets_give_the_dense_masks_records(data, n_recs):
    model, vocab, catalog, frame = data
    ctx = RecContext.build(model, vocab, catalog, frame, device="cpu")
    uids = [int(u) for u in vocab.user_ids[[0, 3, 7, 8, 20, 51, 52, 99]]]
    got = batch.model_recs_batch(ctx, uids, n_recs=n_recs)
    want = dense_model_recs_batch(ctx, uids, n_recs)
    assert [{k: r[k] for k in ("user_id", "anime_ids", "predictions")} for r in got] == want
    offsets, rows = ctx.watched_rows(uids + [-5])
    assert offsets[-1] == offsets[-2]                     # an unknown user watched nothing
    for j, u in enumerate(uids):
        assert set(rows[offsets[j]:offsets[j + 1]]) == set(np.flatnonzero(ctx.watched_mask(u)))


def test_kept_rows_match_the_dense_masks():
    rng = np.random.default_rng(5)
    n_rows, q, width = 300, 6, 80
    idx = rng.integers(-1, n_rows, (q, width))
    vals = np.where(idx >= 0, rng.random((q, width)), -1e30)
    masks = rng.random((q, n_rows)) < 0.3
    owner, rows = np.nonzero(masks)
    watched = batch._watched_keys((np.searchsorted(owner, np.arange(q + 1)), rows), n_rows)
    dense = (vals > -1e29) & ~np.take_along_axis(masks, np.clip(idx, 0, None), 1)
    for n in (1, 4, 40):
        got = batch._kept(vals, idx, watched, n_rows, n)
        width = got.shape[1]
        first = lambda keep: keep & (np.cumsum(keep, axis=1) <= n)   # noqa: E731
        assert np.array_equal(first(got), first(dense[:, :width]))   # each row's first n
        short = got.sum(1) < n                     # rows without n kept: every column tested
        assert width == idx.shape[1] or not short.any()
        assert np.array_equal(got[short], dense[short, :width])
    assert not batch._kept(vals, idx, np.empty(0, np.int64), n_rows, 3)[idx[:, :6] < 0].any()


def test_scan_k_buckets():
    ks = range(1, 5000)
    got = [batch.scan_k(k) for k in ks]
    assert all(k <= b <= max(k, math.ceil(1.25 * k)) for k, b in zip(ks, got))
    assert all(bin(b)[2:].rstrip("0").__len__() <= batch.K_BITS for b in got)
    assert len(set(got)) < 50 and [batch.scan_k(k) for k in (10, 11, 17, 100, 3000)] == \
        [10, 12, 20, 112, 3072]


def test_scan_wrappers_take_tables_past_the_old_group_limit(monkeypatch):
    """The check reads only shapes: a table of 34,000,000 rows passes it,
    and the grid's block limit (stubbed small) is what rejects."""
    table = torch.empty(34_000_000, 128, device="meta")
    queries = torch.empty(256, 128, device="meta")
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    topk._check_scan_inputs("packed_topk", table, queries, (torch.float32,), 4, topk.GROUP)
    assert -(-34_000_000 // topk.GROUP) > 65535
    monkeypatch.setattr(topk, "MAX_BLOCKS", -(-34_000_000 // topk.GROUP) * 256 - 1)
    with pytest.raises(ValueError, match="ceil"):
        topk._check_scan_inputs("packed_topk", table, queries, (torch.float32,), 4, topk.GROUP)
    with pytest.raises(ValueError, match="N <="):
        topk._check_scan_inputs("packed_topk", torch.empty(2**31, 16, device="meta"),
                                torch.empty(1, 16, device="meta"), (torch.float32,), 4,
                                topk.GROUP)


def blocked_topk(table, queries, k, block=50_000, mask=None, exclude=None, head=None):
    """Plain f32 top-k values, block of rows by block of rows."""
    best = torch.full((queries.shape[0], k), -math.inf, dtype=torch.float64)
    for lo in range(0, table.shape[0], block):
        s = queries.double() @ table[lo:lo + block].double().T
        if head is not None:
            s = torch.sigmoid(head[0] * s + head[1])
        rows = torch.arange(lo, lo + s.shape[1])
        if mask is not None:
            s[:, ~mask[lo:lo + block]] = -math.inf
        if exclude is not None:
            s[rows[None, :] == exclude[:, None]] = -math.inf
        best = torch.topk(torch.cat([best, s], 1), k, dim=1).values
    return best


@pytest.mark.parametrize("q", [1, 3])
def test_plain_scan_past_the_old_group_limit(monkeypatch, q):
    """With GROUP stubbed to 8, 530,000 rows are 66,250 groups, past the
    65,535 the old grid took: the plain two-stage scan keeps its contract
    (exact values, masked and excluded rows out) against a blocked top-k."""
    monkeypatch.setattr(topk, "GROUP", 8)
    topk.top_r_policy.cache_clear()
    try:
        n, d, k = 530_000, 16, 10
        assert -(-n // topk.GROUP) > 65535
        g = torch.Generator().manual_seed(q)
        table = torch.nn.functional.normalize(torch.randn(n, d, generator=g), dim=1)
        rows = torch.tensor([n - 1, n - 9, 524_288][:q])
        queries = table[rows].clone()
        mask = torch.rand(n, generator=g) > 0.1
        mask[rows] = True
        head = torch.tensor([2.0, -0.3])
        vals, idx = topk.masked_topk(table, queries, k, mask=mask)
        assert torch.equal(idx[:, 0], rows)                 # each query finds itself
        want = blocked_topk(table, queries, k, mask=mask)
        assert torch.allclose(vals.double(), want, atol=1e-6, rtol=0)
        vals, idx = topk.masked_topk(table, queries, k, mask=mask, exclude=rows, head=head)
        assert not (idx == rows[:, None]).any()
        want = blocked_topk(table, queries, k, mask=mask, exclude=rows, head=head)
        assert torch.allclose(vals.double(), want, atol=1e-6, rtol=0)
    finally:
        topk.top_r_policy.cache_clear()


def test_replays_count_their_scans_work(monkeypatch):
    class FakeGraph:
        def __init__(self, fn, warm_up, buffers, device, pool=None):
            self.fn, self.buffers, self.replays = fn, buffers, 0
            self.seconds = {"warm_up": 0.0, "capture": 0.0, "instantiate": 0.0}
            self.pool_bytes = 0

        def replay(self, host, clone=True):
            for name, value in host.items():
                self.buffers[name].copy_(value)
            return tuple(t.clone() for t in self.fn())

    monkeypatch.setattr(scan_graph, "CapturedGraph", FakeGraph)
    table = torch.nn.functional.normalize(torch.randn(1000, 32), dim=1)
    st = topk.shuffle_rows(table, seed=1)
    graphs = scan_graph.ScanGraphs(capacity=2)
    mask = np.arange(1000) % 3 > 0
    request, inputs = topk.stage_request(st, table[:4], mask, None, torch.tensor([1.0, 0.0]),
                                         k=10)
    work = topk.scan_work(request, inputs)
    assert work == {"queries": 4, "rows": 1000, "bytes": 1000 * 32 * 4 + 4 * 32 * 4 + 1000,
                    "flops": 2 * 4 * 1000 * 32 + 4 * 4 * 1000}
    for _ in range(4):
        graphs.run(request.key(inputs), lambda **t: topk.scan_body(request, **t), inputs,
                   torch.device("cpu"), work=work)
    # the first call runs eagerly, the second captures: two replays counted
    assert graphs.scan_report() == {"calls": 2, **{k: 2 * v for k, v in work.items()}}


def test_clean_names_at_scale_is_clean_name():
    rng = np.random.default_rng(0)
    alphabet = np.array(list("Ab z_-!.:'&09\t\n") + ["é", "★", "ß", "Å", "\x00"])
    for pool in (alphabet[:15], alphabet):
        items = ["".join(rng.choice(pool, rng.integers(0, 12))) for _ in range(3000)]
        assert clean_names(items) == [clean_name(x) for x in items]
    for items in ([], [""], ["A b", float("nan")], [None, "A"]):
        assert clean_names(items) == [clean_name(x) for x in items]
    raw = synthetic.synth_anime_catalog(n_anime=300, seed=4)
    frame = load_anime_frame(raw)
    first = raw.drop_duplicates(subset="MAL_ID").set_index("MAL_ID")["Name"]
    assert frame["eng_version"].tolist() == [clean_name(first[a]) for a in frame["anime_id"]]


def test_in_catalog_mask_is_the_catalog_join(data):
    _, vocab, catalog, _ = data
    ctx = RecContext(vocab=vocab, catalog=catalog, ratings=pd.DataFrame(),
                     head=torch.zeros(2), anime_scan=None, user_scan=None)
    want = ctx.vocab_meta()["anime_id"].notna().to_numpy()
    assert np.array_equal(ctx.in_catalog_mask(), want)


# ---- on the card ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    # The process's cached graphs keep their memory pools (a scan-graph
    # cache's one pool holds its largest capture's intermediates): a test
    # starts with them dropped, and with the card's free memory returned.
    from anime_recommendations_tpu_torch.train import device_loop, step_graph

    for graphs in (scan_graph, device_loop, step_graph):
        graphs.release_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    return torch.device("cuda")


def card_blocked_topk(table, queries, k, mask=None, exclude=None, head=None, block=1 << 20):
    """Plain f32 top-k (values and rows), TF32 off, block of rows by block."""
    best_s = torch.full((queries.shape[0], k), -math.inf, device=queries.device)
    best_i = torch.full((queries.shape[0], k), -1, dtype=torch.long, device=queries.device)
    for lo in range(0, table.shape[0], block):
        s = queries @ table[lo:lo + block].T
        if head is not None:
            s = torch.sigmoid(head[0] * s + head[1])
        rows = torch.arange(lo, lo + s.shape[1], device=s.device)
        if mask is not None:
            s.masked_fill_(~mask[lo:lo + block][None, :], -math.inf)
        if exclude is not None:
            s.masked_fill_(rows[None, :] == exclude[:, None], -math.inf)
        top = torch.topk(s, k, dim=1)
        cat_s = torch.cat([best_s, top.values], 1)
        cat_i = torch.cat([best_i, top.indices + lo], 1)
        best_s, pos = torch.topk(cat_s, k, dim=1)
        best_i = cat_i.gather(1, pos)
    return best_s, best_i


@pytest.mark.cuda
@pytest.mark.parametrize("flavour", ["f32", "exact", "int8"])
@pytest.mark.parametrize("q", [1, 256])
def test_scans_past_33553920_rows_on_the_card(cuda, q, flavour):
    """34,000,000 x 128 f32 rows (66,407 groups, past gridDim.y's 65,535):
    the scan, with a mask, an exclusion and the head, against a blocked
    plain f32 top-k; queries are rows past the old limit, so each finds
    itself when not excluded."""
    from anime_recommendations_tpu_torch.ops.quantized import quantized_topk, quantize_rows

    n, d, k = 34_000_000, 128, 10
    g = torch.Generator(device=cuda).manual_seed(q)
    table = torch.randn(n, d, generator=g, device=cuda)
    table = l2_normalize_rows(table, eps=TF_L2_NORM_EPS)
    rows = torch.arange(n - q * 997, n, 997, device=cuda)[:q]
    queries = table[rows].clone()
    mask = torch.rand(n, generator=g, device=cuda) > 0.05
    mask[rows] = True
    head = torch.tensor([3.0, -0.5], device=cuda)

    def scan(**kw):
        if flavour == "int8":
            return quantized_topk(qt, queries, k, **kw)
        return topk.masked_topk(table, queries, k, exact_scan=flavour == "exact", **kw)

    qt = quantize_rows(table) if flavour == "int8" else None
    vals, idx = scan(mask=mask)
    assert torch.equal(idx[:, 0], rows)
    for kw in (dict(mask=mask), dict(mask=mask, exclude=rows),
               dict(mask=mask, exclude=rows, head=head)):
        vals, idx = scan(**kw)
        want_s, want_i = card_blocked_topk(table, queries, k, **kw)
        assert mask[idx].all()
        if "exclude" in kw:
            assert not (idx == rows[:, None]).any()
        exact = torch.einsum("qd,qkd->qk", queries, table[idx])
        if "head" in kw:
            exact = torch.sigmoid(head[0] * exact + head[1])
        assert (vals - exact).abs().max() <= 1e-5         # served scores are exact
        if flavour == "int8":   # a pool from int8 scores: most of the true top-k
            hits = (idx[:, :, None] == want_i[:, None, :]).any(2).float().mean()
            assert hits >= 0.9, float(hits)
            continue
        assert (vals - want_s).abs().max() <= 1e-5
        differ = idx != want_i            # rows swapped only where scores tie
        assert not differ.any() or (want_s[differ] - vals[differ]).abs().max() <= 1e-6


class ChunkedTable:
    """An [n, d] table whose row ranges are drawn on demand, as a table
    the card cannot hold twice reaches RecContext.build."""

    def __init__(self, n, d, device, seed):
        self.shape, self.device, self.seed = (n, d), device, seed

    def __getitem__(self, rows):
        lo, hi, _ = rows.indices(self.shape[0])
        g = torch.Generator(device=self.device).manual_seed(self.seed * 1_000_003 + lo)
        return torch.rand(hi - lo, self.shape[1], generator=g, device=self.device) - 0.5


@pytest.mark.cuda
def test_context_at_amazon_shapes_holds_one_copy(cuda):
    """RecContext.build over 54,510,000 x 128 users and 48,190,000 x 128
    items: one f32 copy of each table (tables_report: the card memory the
    build left allocated is the tables' own bytes), and a similar-users
    and a headed, masked model-recs scan of 256 queries each, eager,
    captured and replayed, with the device's peak under 64 GB. The card
    tests of this file run in a process of their own (module docstring)."""
    n_users, n_items, d = 54_510_000, 48_190_000, 128
    head = init_params(1, 1, d, generator=torch.Generator().manual_seed(1), device=cuda)
    model = types.SimpleNamespace(**{k: getattr(head, k) for k in HEAD_KEYS + BUFFER_KEYS},
                                  user_emb=ChunkedTable(n_users, d, cuda, 1),
                                  anime_emb=ChunkedTable(n_items, d, cuda, 2))
    vocab = Vocab(user_ids=np.arange(n_users), anime_ids=np.arange(n_items))
    catalog = Catalog(anime=pd.DataFrame({"anime_id": [0], "Name": ["a"], "Genres": ["x"]}))
    torch.cuda.reset_peak_memory_stats(cuda)
    ctx = RecContext.build(model, vocab, catalog, pd.DataFrame(), device=cuda)
    report = ctx.tables_report()
    for side, n in (("user", n_users), ("anime", n_items)):
        assert report[side]["table_bytes"] == n * d * 4
    assert 1.0 <= report["built"]["copies"] < 1.001
    users = np.arange(0, n_users, n_users // 256)[:256]
    mask = np.ones(n_items, bool)
    mask[::7] = False
    for _ in range(3):
        vals, idx = topk.host_topk(topk.cosine_topk, ctx.user_table(), ctx.user_vectors(users),
                                   k=10, exclude=users, graphs=ctx.scan_graphs)
        assert not (idx == users[:, None]).any() and (vals[:, 0] > 0).all()
        vals, idx = topk.host_topk(score_topk, ctx.anime_table(), ctx.user_vectors(users),
                                   ctx.head, k=64, mask=mask, graphs=ctx.scan_graphs)
        assert mask[idx].all()
    assert ctx.scan_graphs.hits == 2 and ctx.scan_graphs.captures == 2
    peak = torch.cuda.max_memory_allocated(cuda)
    print(f"tables {report}, peak {peak / 1e9:.2f} GB, graphs {ctx.scan_graphs.report()}")
    assert peak < 64e9

