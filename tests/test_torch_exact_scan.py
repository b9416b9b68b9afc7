"""The port's single-stage exact scan (masked_topk(exact_scan=True)) against
the JAX package's, on the same inputs.

The JAX side runs as tests/test_ops.py runs it: the Pallas _topk_kernel in
interpret mode on the CPU over several blocks. The port runs its plain
version (CPU tensors): dense f32 scores and a stable sort, so ties go to
the lower row, as the JAX kernel's argmax and merge give them. Tolerances:
values within rtol 1e-6 / atol 1e-7; indices equal, except where the two
rows' true scores tie within 1e-6. On tables whose scores are exact in f32
(small integers), ties are exact and the indices must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_recommendations_tpu.ops import scoring as jscoring
from anime_recommendations_tpu.ops import topk as jtopk
from anime_recommendations_tpu_torch.ops import scoring, topk

from test_torch_topk import true_scores

torch.set_num_threads(2)


def assert_exact_topk(port, ref, scores, exact_ties=False):
    """Values within rtol 1e-6 / atol 1e-7 over the slots both call live;
    indices equal there, or (unless ``exact_ties``) tied within 1e-6."""
    (pv, pi), (rv, ri) = (np.asarray(a) for a in port), (np.asarray(a) for a in ref)
    assert pv.shape == rv.shape and pi.shape == ri.shape
    live = rv > -1e29
    assert np.array_equal(pv > -1e29, live)
    assert (pi[~live] == -1).all() and (pv[~live] == -1e30).all()
    np.testing.assert_allclose(pv[live], rv[live], rtol=1e-6, atol=1e-7)
    if exact_ties:
        np.testing.assert_array_equal(pi[live], ri[live])
        return
    for row, slot in zip(*np.nonzero((pi != ri) & live)):
        a, b = pi[row, slot], ri[row, slot]
        assert abs(scores[row, a] - scores[row, b]) <= 1e-6, (row, slot, a, b)


def both(w, q, k, *, block_rows, mask=None, exclude=None, head=None, bf16=False):
    """(port, JAX) masked_topk(exact_scan=True) on the same numpy inputs."""
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    port = topk.masked_topk(
        torch.from_numpy(w).to(tdt), torch.from_numpy(q).to(tdt), k,
        mask=None if mask is None else torch.from_numpy(mask),
        exclude=None if exclude is None else torch.from_numpy(exclude),
        head=None if head is None else torch.from_numpy(head), exact_scan=True)
    ref = jtopk.masked_topk(
        jnp.asarray(w, jdt), jnp.asarray(q, jdt), k,
        mask=None if mask is None else jnp.asarray(mask),
        exclude=None if exclude is None else jnp.asarray(exclude),
        head=None if head is None else jnp.asarray(head), use_head=head is not None,
        block_rows=block_rows, exact_scan=True)
    return port, ref


def ascending_table():
    """test_ops.py's adversarial order for the threshold skip: scores rise
    with the row index, so the top-k lives in the last, ragged block."""
    n, d = 4096 + 513, 16
    rng = np.random.default_rng(0)
    q = rng.standard_normal((3, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    base = rng.standard_normal((n, d)).astype(np.float32)
    t = np.linspace(0, 1, n, dtype=np.float32)[:, None] ** 2
    w = (1 - t) * base + t * 40.0 * q[0]
    return w / np.linalg.norm(w, axis=1, keepdims=True), q


def tied_descending_table():
    """test_ops.py's tied table: hundreds of rows within a float tie of each
    other in the first block, the top-k all there."""
    n, d = 3072, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, d)).astype(np.float32)
    base = rng.standard_normal((n, d)).astype(np.float32)
    t = np.linspace(1, 0, n, dtype=np.float32)[:, None] ** 2
    w = (1 - t) * base + t * 40.0 * q[1]
    return w / np.linalg.norm(w, axis=1, keepdims=True), q


TABLES = {"ascending": (ascending_table, 7, 1024), "tied_descending": (tied_descending_table, 5, 512)}
FEATURES = ["plain", "mask_exclude", "head"]


@pytest.mark.parametrize("feature", FEATURES)
@pytest.mark.parametrize("name", sorted(TABLES))
def test_exact_scan_matches_jax(name, feature):
    make, k, block_rows = TABLES[name]
    w, q = make()
    n = w.shape[0]
    kw = {}
    if feature == "mask_exclude":
        kw["mask"] = np.random.default_rng(5).uniform(size=n) > 0.3
        top = np.argsort(-(q @ w.T), axis=1)[:, 0]
        kw["exclude"] = top.astype(np.int32)        # each query's best row
    elif feature == "head":
        kw["head"] = np.asarray([-3.1, 0.4], np.float32)   # alpha < 0 flips the order
    port, ref = both(w, q, k, block_rows=block_rows, **kw)
    scores = true_scores(w, q, kw.get("head"))
    assert_exact_topk(port, ref, scores)
    # Value-exact against the dense oracle; each index scores what it claims.
    dense = scores.copy()
    if "mask" in kw:
        dense[:, ~kw["mask"]] = -np.inf
    if "exclude" in kw:
        dense[np.arange(len(q)), kw["exclude"]] = -np.inf
    vals, idx = (a.numpy() for a in port)
    np.testing.assert_allclose(vals, -np.sort(-dense, axis=1)[:, :k], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.take_along_axis(scores, idx, 1), vals, rtol=1e-6, atol=1e-7)


def integer_table(n, d, seed, distinct):
    """Rows drawn from ``distinct`` small-integer rows (many exact
    duplicates, in every chunk) and integer queries: every score is exact
    in f32 whatever the summation order, so ties are exact."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-3, 4, (distinct, d)).astype(np.float32)
    w = base[rng.integers(distinct, size=n)]
    q = rng.integers(-3, 4, (4, d)).astype(np.float32)
    return w, q


@pytest.mark.parametrize("feature", FEATURES)
def test_duplicated_rows_go_to_the_lower_index_as_in_jax(feature):
    w, q = integer_table(1500, 16, seed=7, distinct=40)
    kw = {}
    if feature == "mask_exclude":
        kw["mask"] = np.random.default_rng(8).uniform(size=1500) > 0.2
        kw["exclude"] = np.asarray([3, -1, 700, 1499], np.int32)
    elif feature == "head":
        kw["head"] = np.asarray([0.05, -0.2], np.float32)
    port, ref = both(w, q, 20, block_rows=512, **kw)
    assert_exact_topk(port, ref, true_scores(w, q, kw.get("head")), exact_ties=True)
    # Against numpy's stable argsort of the same exact scores.
    s = q @ w.T
    if "head" in kw:
        s = torch.sigmoid(kw["head"][0] * torch.from_numpy(s) + kw["head"][1]).numpy()
    if "mask" in kw:
        s[:, ~kw["mask"]] = -np.inf
    if "exclude" in kw:
        for r, e in enumerate(kw["exclude"]):
            if e >= 0:
                s[r, e] = -np.inf
    np.testing.assert_array_equal(port[1].numpy(), np.argsort(-s, axis=1, kind="stable")[:, :20])


def test_fewer_valid_rows_than_k_and_k_past_a_chunk():
    """k above the live rows: sentinels (-1e30, -1) after them. k = 600,
    deeper than one 512-row chunk: the stable merge of whole chunks."""
    w, q = integer_table(2000, 16, seed=9, distinct=300)
    keep = np.zeros(2000, bool)
    keep[[5, 900, 1999]] = True
    port, ref = both(w, q[:2], 8, block_rows=512, mask=keep)
    assert_exact_topk(port, ref, true_scores(w, q[:2]), exact_ties=True)
    assert (port[1].numpy()[:, 3:] == -1).all() and (port[0].numpy()[:, 3:] == -1e30).all()
    vals, idx = topk.masked_topk(torch.from_numpy(w), torch.from_numpy(q), 600, exact_scan=True)
    s = q @ w.T
    want = np.argsort(-s, axis=1, kind="stable")[:, :600]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(s, want, 1))


def test_bf16_table_matches_jax():
    w, q = tied_descending_table()
    port, ref = both(w, q, 5, block_rows=512, bf16=True)
    wb = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    qb = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    assert port[0].dtype == torch.float32
    assert_exact_topk(port, ref, true_scores(wb, qb))


def test_exact_scan_through_a_shuffled_table_and_score_topk_match_jax():
    w, q = integer_table(1400, 16, seed=12, distinct=60)
    rows = np.asarray([4, 800, 1399])
    keep = np.random.default_rng(12).uniform(size=1400) > 0.25
    st = topk.shuffle_rows(torch.from_numpy(w), seed=5)
    jst = jtopk.shuffle_rows(jnp.asarray(w), seed=5)
    port = topk.cosine_topk(st, torch.from_numpy(w[rows]), 9, mask=keep, exclude=rows,
                            exact_scan=True)
    ref = jtopk.cosine_topk(jst, jnp.asarray(w[rows]), 9, mask=jnp.asarray(keep),
                            exclude=jnp.asarray(rows, jnp.int32), exact_scan=True)
    # The two shuffles differ (numpy's and jax.random's permutations), so
    # among exactly tied rows each returns the lowest physical position:
    # indices agree up to ties.
    assert_exact_topk(port, ref, true_scores(w, w[rows]))
    head = np.asarray([0.07, 0.3], np.float32)
    port = scoring.score_topk(torch.from_numpy(w), torch.from_numpy(q), torch.from_numpy(head),
                              11, mask=keep, exact_scan=True)
    ref = jscoring.score_topk(jnp.asarray(w), jnp.asarray(q), jnp.asarray(head), 11,
                              mask=jnp.asarray(keep), exact_scan=True)
    assert_exact_topk(port, ref, true_scores(w, q, head), exact_ties=True)


@pytest.mark.parametrize("q", [9, 64])
def test_exact_scan_at_the_kernels_query_tiles_matches_jax(q):
    """Query counts that take the card kernel's 32-query tiles (9: one
    partial tile; 64: two full ones), on a table of exact duplicates, with
    mask and exclude: indices equal to JAX's."""
    w, _ = integer_table(1100, 16, seed=23, distinct=50)
    q_rows = np.arange(q) * 17 % 1100
    keep = np.random.default_rng(23).uniform(size=1100) > 0.2
    excl = np.where(np.arange(q) % 3 == 0, -1, q_rows).astype(np.int32)
    port, ref = both(w, w[q_rows], 12, block_rows=512, mask=keep, exclude=excl)
    assert_exact_topk(port, ref, true_scores(w, w[q_rows]), exact_ties=True)
