"""One retrieval request as one graph replay (ops/scan_graph.py), on the CPU.

The request's device half (ops/topk.scan_body), run eagerly on the static
buffers a capture would give it, against the JAX package's jitted
``cosine_topk`` / ``score_topk`` (``_dispatch_topk``, its Pallas kernels in
interpret mode on the CPU, as tests/test_ops.py runs them) and ``ivf_topk``
on the same numpy inputs, for every table flavour: a plain table, a
ShuffledTable, a shuffled int8 QuantizedTable, IVF indexes with f32 and int8
storage, and the exact scan of a ShuffledTable; with and without mask,
exclude and head; 1, 3 and 17 queries. Both packages get the same shuffle
(the port's ShuffledTable is built from JAX's permutation) and the same IVF
index (JAX's arrays through ivf_from_numpy). Tolerances, those of
tests/test_torch_topk.py and tests/test_torch_ivf.py: values within 1e-6
relative (both rescore in exact f32), indices equal except where the two
rows' true scores tie within 1e-6.

Then the body's contract (no host read: .item, .cpu, .tolist, .numpy,
Tensor.__bool__ and the rest of tests/test_torch_parallel.py's guard) and
the cache's policy through ScanGraphs.run with a stand-in for the CUDA
graph that replays the body on its buffers: the key, the capture at the
second call, the replays, least-recently-used eviction, capacity 0, and the
release with a RecContext. The capture itself runs on the card
(tests/test_torch_cuda.py -k scan_graph).
"""

import functools
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_recommendations_tpu.ops import ivf as jivf
from anime_recommendations_tpu.ops import quantized as jquantized
from anime_recommendations_tpu.ops import scoring as jscoring
from anime_recommendations_tpu.ops import topk as jtopk
from anime_recommendations_tpu_torch.ops import scan_graph, topk
from anime_recommendations_tpu_torch.ops.ivf import ivf_from_numpy
from anime_recommendations_tpu_torch.ops.quantized import quantize_rows

from test_torch_topk import assert_same_topk, normed, true_scores

torch.set_num_threads(2)

N, D = 3000, 32
HEAD = np.asarray([1.7, 0.3], np.float32)
FLAVOURS = ("plain", "shuffled", "quantized", "ivf_f32", "ivf_int8", "exact")
SIDES = {"none": (), "mask_exclude": ("mask", "exclude"),
         "mask_exclude_head": ("mask", "exclude", "head")}
QUERIES = (1, 3, 17)


@pytest.fixture(scope="module")
def tables():
    """Each flavour's (port table, JAX table, keywords of both calls) over
    one [N, D] table of unit rows."""
    w = normed(np.random.default_rng(21).standard_normal((N, D)).astype(np.float32))
    jw = jnp.asarray(w)
    jst = jtopk.shuffle_rows(jw, seed=5)
    perm = torch.from_numpy(np.array(jst.perm)).long()
    inv = torch.from_numpy(np.array(jst.inv)).long()
    st = topk.ShuffledTable(table=torch.from_numpy(np.array(jst.table)), perm=perm, inv=inv)
    jqst = jst._replace(table=jquantized.quantize_rows(jst.table))
    qst = st._replace(table=quantize_rows(st.table))
    out = {"w": w,
           "plain": (torch.from_numpy(w), jw, {}, {"block_rows": 512}),
           "shuffled": (st, jst, {}, {"block_rows": 512}),
           "quantized": (qst, jqst, {}, {"block_rows": 512}),
           "exact": (st, jst, {"exact_scan": True},
                     {"exact_scan": True, "block_rows": 512})}
    for storage in ("f32", "int8"):
        ref = jivf.build_ivf(w, n_clusters=64, iters=4, seed=3, storage=storage)
        arrays = {f: None if getattr(ref, f) is None else np.asarray(getattr(ref, f))
                  for f in ref._fields}
        out[f"ivf_{storage}"] = (ivf_from_numpy(arrays, "cpu"), ref, {"probes": 8},
                                 {"probes": 8})
    return out


def _request(tables, flavour, q, side, k=10):
    """(the staged request and inputs, the numpy inputs, the JAX result)."""
    w = tables["w"]
    port_table, jax_table, kw, jkw = tables[flavour]
    rows = (np.arange(q) * 97 + 13) % N
    queries = w[rows]
    mask = (np.random.default_rng(q).uniform(size=N) > 0.3) if "mask" in SIDES[side] else None
    exclude = rows.astype(np.int64) if "exclude" in SIDES[side] else None
    head = HEAD if "head" in SIDES[side] else None
    staged = topk.stage_request(port_table, torch.from_numpy(queries), mask, exclude,
                                None if head is None else torch.from_numpy(head), k=k, **kw)
    jargs = dict(mask=None if mask is None else jnp.asarray(mask),
                 exclude=None if exclude is None else jnp.asarray(exclude, jnp.int32))
    if head is None:
        ref = jtopk.cosine_topk(jax_table, jnp.asarray(queries), k, **jargs, **jkw)
    else:
        ref = jscoring.score_topk(jax_table, jnp.asarray(queries), jnp.asarray(head), k,
                                  **jargs, **jkw)
    return staged, (queries, mask, exclude, head), ref


def _on_buffers(request, inputs):
    """scan_body on copies of the inputs, as a capture's static buffers hold them."""
    buffers = {name: None if v is None else torch.empty_like(v).copy_(v)
               for name, v in inputs.items()}
    return topk.scan_body(request, **buffers)


def _scores(w, queries, mask, exclude, head):
    s = true_scores(w, queries, head)
    if mask is not None:
        s[:, ~mask] = -np.inf
    if exclude is not None:
        s[np.arange(len(exclude)), exclude] = -np.inf
    return s


@pytest.mark.parametrize("q", QUERIES)
@pytest.mark.parametrize("side", sorted(SIDES))
@pytest.mark.parametrize("flavour", FLAVOURS)
def test_staged_body_matches_jax_dispatch(tables, flavour, side, q):
    (request, inputs), (queries, mask, exclude, head), ref = _request(tables, flavour, q, side)
    vals, idx = _on_buffers(request, inputs)
    rv, ri = (np.asarray(a) for a in ref)
    assert vals.shape == idx.shape == rv.shape == (q, 10) and idx.dtype == torch.int64
    np.testing.assert_allclose(vals.numpy(), rv, rtol=1e-6, atol=0)
    assert_same_topk((vals.numpy(), idx.numpy()), (rv, ri),
                     _scores(tables["w"], queries, mask, exclude, head), atol=np.inf)
    # The public entry on the CPU runs the same body.
    port_table, _, kw, _ = tables[flavour]
    if head is None:
        got = topk.cosine_topk(port_table, torch.from_numpy(queries), 10, mask, exclude, **kw)
    else:
        from anime_recommendations_tpu_torch.ops.scoring import score_topk

        got = score_topk(port_table, torch.from_numpy(queries), torch.from_numpy(head), 10,
                         mask, exclude, **kw)
    assert torch.equal(got[0], vals) and torch.equal(got[1], idx)


def test_staging_checks_and_resolves_the_policy(tables):
    st = tables["shuffled"][0]
    q = torch.from_numpy(tables["w"][:3])
    request, inputs = topk.stage_request(st, q, np.ones(N, np.int8), [1, 2, 3], None, k=10)
    assert request.top_r == topk.top_r_policy(10, N) and request.m is None
    assert inputs["mask"].dtype == torch.bool and inputs["exclude"].dtype == torch.int64
    qst = tables["quantized"][0]
    assert topk.stage_request(qst, q, None, None, None, k=10)[0].m == 40
    assert topk.stage_request(qst, q, None, None, None, k=10, m=7)[0].m == 10
    ivf = tables["ivf_f32"][0]
    request = topk.stage_request(ivf, q, None, 5, None, k=10)[0]
    assert request.probes == ivf.n_clusters and request.query_chunk == 3
    assert topk.stage_request(ivf, q, None, 5, None, k=10)[1]["exclude"].tolist() == [5] * 3
    for bad in (dict(mask=np.ones(N - 1, bool)), dict(exclude=[1, 2]),
                dict(head=torch.ones(3))):
        args = dict(mask=None, exclude=None, head=None) | bad
        with pytest.raises(ValueError):
            topk.stage_request(st, q, args["mask"], args["exclude"], args["head"], k=10)
    with pytest.raises(ValueError, match="exact_scan"):
        topk.stage_request(qst, q, None, None, None, k=10, exact_scan=True)
    with pytest.raises(ValueError, match="queries"):
        topk.stage_request(st, q[0], None, None, None, k=10)


# ---- the body reads nothing on the host ----------------------------------------------

HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__",
              "__index__")


@pytest.fixture
def host_reads(monkeypatch):
    """A list that collects the host reads made while ``watching[0]`` is
    True: the Tensor methods above, torch.nonzero/unique/masked_select and
    indexing with a bool tensor."""
    seen, watching = [], [False]

    def watch(owner, name):
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if watching[0]:
                seen.append(name)
            return fn(*args, **kwargs)

        monkeypatch.setattr(owner, name, wrapped)

    for name in HOST_READS:
        watch(torch.Tensor, name)
    for name in ("nonzero", "unique", "masked_select"):
        watch(torch, name)
    getitem = torch.Tensor.__getitem__

    def bool_index(self, idx):
        if watching[0] and any(isinstance(x, torch.Tensor) and x.dtype == torch.bool
                               for x in (idx if isinstance(idx, tuple) else (idx,))):
            seen.append("bool index")
        return getitem(self, idx)

    monkeypatch.setattr(torch.Tensor, "__getitem__", bool_index)
    return seen, watching


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_scan_body_reads_nothing_on_the_host(tables, host_reads, flavour):
    seen, watching = host_reads
    watching[0] = True          # the probe: a bool index and a host read
    x = torch.arange(3.0)
    x[x > 0].sum().item()
    watching[0] = False
    assert seen == ["bool index", "item"]
    seen.clear()
    for q, side in ((1, "mask_exclude_head"), (17, "mask_exclude"), (3, "none")):
        request, inputs = _request(tables, flavour, q, side)[0]
        watching[0] = True
        try:
            _on_buffers(request, inputs)
        finally:
            watching[0] = False
        assert seen == [], (flavour, q, side, seen)


# ---- the cache's policy ----------------------------------------------------------------

class FakeGraph:
    """CapturedGraph's interface on the CPU: the warm-up runs, and each
    replay copies the inputs into the buffers and runs the body on them."""

    def __init__(self, fn, warm_up, buffers, device, pool=None):
        warm_up()
        self.fn, self.buffers, self.replays = fn, buffers, 0
        self.seconds = {"warm_up": 0.0, "capture": 0.0, "instantiate": 0.0}
        self.pool_bytes = 0

    def replay(self, host, clone=True):
        for name, value in host.items():
            self.buffers[name].copy_(value)
        self.replays += 1
        return tuple(t.clone() for t in self.fn())


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(scan_graph, "CapturedGraph", FakeGraph)


def _run(graphs, request, inputs):
    return graphs.run(request.key(inputs), functools.partial(topk.scan_body, request), inputs,
                      torch.device("cpu"))


def test_key_names_the_signature_not_the_values(tables):
    st = tables["shuffled"][0]
    w = tables["w"]

    def key(table=st, rows=(1, 2), k=10, **kw):
        request, inputs = topk.stage_request(table, torch.from_numpy(w[list(rows)]),
                                             kw.pop("mask", None), kw.pop("exclude", None),
                                             kw.pop("head", None), k=k, **kw)
        return request.key(inputs)

    base = key()
    assert key(rows=(5, 9)) == base                                   # other queries
    assert key(mask=np.ones(N, bool)) == key(mask=np.zeros(N, bool))  # other mask values
    others = [key(rows=(1, 2, 3)), key(k=11), key(mask=np.ones(N, bool)),
              key(exclude=[1, 2]), key(head=torch.from_numpy(HEAD)), key(exact_scan=True),
              key(top_r=30), key(table=tables["plain"][0]), key(table=tables["quantized"][0]),
              key(table=tables["quantized"][0], m=50),
              key(table=st._replace(table=st.table.clone()))]       # the same rows elsewhere
    assert len({base, *others}) == len(others) + 1
    ivf = tables["ivf_f32"][0]
    assert key(table=ivf, probes=8) != key(table=ivf, probes=9)
    assert key(table=ivf, probes=8) != key(table=tables["ivf_int8"][0], probes=8)


def test_a_signature_is_captured_at_its_second_call_and_replayed(tables, fake_graphs):
    graphs = scan_graph.ScanGraphs(capacity=2)
    w = tables["w"]
    outs = []
    for i, rows in enumerate(((1, 2), (3, 4), (5, 6), (7, 8))):
        request, inputs = topk.stage_request(tables["shuffled"][0], torch.from_numpy(w[list(rows)]),
                                             np.arange(N) % 3 > 0, np.asarray(rows), None, k=10)
        got = _run(graphs, request, inputs)
        want = topk.scan_body(request, **inputs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        outs.append(got)
        assert (graphs.misses, graphs.captures, graphs.hits, len(graphs)) == \
            ((1, 0, 0, 0), (2, 1, 0, 1), (2, 1, 1, 1), (2, 1, 2, 1))[i]
    (graph,) = graphs._graphs.values()
    assert graph.replays == 3                              # the capture's call and two more
    assert not torch.equal(outs[2][1], outs[3][1])         # each caller owns its outputs
    report = graphs.report()
    assert report["graphs"] == 1 and report["pool_mb"] == [0.0]


def test_least_recently_used_graphs_go_first(tables, fake_graphs):
    graphs = scan_graph.ScanGraphs(capacity=2)
    w = tables["w"]

    def call(q):
        request, inputs = topk.stage_request(tables["plain"][0], torch.from_numpy(w[:q]), None,
                                             None, None, k=5)
        _run(graphs, request, inputs)
        return request.key(inputs)

    keys = {q: call(q) for q in (1, 2, 3)}                  # seen once each: no graph
    assert len(graphs) == 0 and len(graphs._seen) == 3
    for q in (1, 2, 1, 3):                                  # 3 pushes out 2, not 1
        call(q)
    assert list(graphs._graphs) == [keys[1], keys[3]] and graphs.captures == 3
    call(2)                        # an evicted signature is new again: eager
    assert list(graphs._graphs) == [keys[1], keys[3]] and graphs.captures == 3
    assert keys[2] in graphs._seen
    call(2)                        # its second call captures it, pushing out 1
    assert list(graphs._graphs) == [keys[3], keys[2]] and graphs.captures == 4
    assert keys[2] not in graphs._seen
    call(1)
    call(1)
    assert graphs.captures == 5 and list(graphs._graphs) == [keys[2], keys[1]]
    graphs.release()
    assert len(graphs) == 0 and not graphs._seen


def test_signatures_seen_once_are_bounded(tables, fake_graphs):
    graphs = scan_graph.ScanGraphs(capacity=1)
    w = tables["w"]
    for k in range(1, 3 * scan_graph._SEEN_PER_GRAPH):
        request, inputs = topk.stage_request(tables["plain"][0], torch.from_numpy(w[:2]), None,
                                             None, None, k=k)
        _run(graphs, request, inputs)
    assert len(graphs._seen) == scan_graph._SEEN_PER_GRAPH and len(graphs) == 0


def test_capacity_zero_runs_every_call_eagerly(tables, fake_graphs):
    request, inputs = topk.stage_request(tables["plain"][0], torch.from_numpy(tables["w"][:2]),
                                         None, None, None, k=5)
    for _ in range(3):
        _run(scan_graph.EAGER, request, inputs)
    assert len(scan_graph.EAGER) == 0 and not scan_graph.EAGER._seen
    assert scan_graph.EAGER.captures == 0


def test_a_context_owns_and_releases_its_graphs(tables, fake_graphs):
    from anime_recommendations_tpu_torch.data.catalog import Catalog
    from anime_recommendations_tpu_torch.data.vocab import Vocab
    from anime_recommendations_tpu_torch.recommend.context import RecContext

    import pandas as pd

    catalog = Catalog(anime=pd.DataFrame({"anime_id": [1, 2], "Name": ["a", "b"],
                                          "Genres": ["x", "y"]}))
    st = tables["shuffled"][0]
    ctx = RecContext(vocab=Vocab(user_ids=np.arange(3), anime_ids=np.asarray([1, 2])),
                     catalog=catalog, ratings=pd.DataFrame(),
                     head=torch.from_numpy(HEAD), anime_scan=st,
                     user_scan=st)
    other = RecContext(vocab=ctx.vocab, catalog=catalog, ratings=ctx.ratings,
                       head=ctx.head,
                       anime_scan=st, user_scan=st)
    assert ctx.scan_graphs is not other.scan_graphs
    request, inputs = topk.stage_request(st, torch.from_numpy(tables["w"][:2]), None, None,
                                         None, k=5)
    for _ in range(2):
        _run(ctx.scan_graphs, request, inputs)
    assert len(ctx.scan_graphs) == 1 and len(other.scan_graphs) == 0
    ctx.release_graphs()
    assert len(ctx.scan_graphs) == 0
    for _ in range(2):
        _run(ctx.scan_graphs, request, inputs)
    graph = weakref.ref(next(iter(ctx.scan_graphs._graphs.values())))
    del ctx
    gc.collect()
    assert graph() is None                                   # gone with its context
