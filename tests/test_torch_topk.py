"""The port's two-stage top-k against the JAX package's, on the same inputs.

The JAX side runs as tests/test_ops.py runs it: Pallas in interpret mode on
the CPU with a small ``block_rows``, so its stage-1 kernel really executes
over several blocks. The port runs its plain stage 1 (CPU tensors).
Tolerance: values 1e-5 absolute for f32 tables and 1e-2 for bf16; indices
equal except where the two rows' true scores tie within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_recommendations_tpu.ops import topk as jtopk
from anime_recommendations_tpu_torch.ops import topk

torch.set_num_threads(2)


def normed(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def table(n, d=32, seed=1):
    return normed(np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))


def true_scores(w, q, head=None):
    """[Q, N] f64 scores of every row, through the head when given."""
    s = q.astype(np.float64) @ w.astype(np.float64).T
    return s if head is None else 1 / (1 + np.exp(-(head[0] * s + head[1])))


def assert_same_topk(port, ref, scores, atol=1e-5):
    """Values within ``atol``; an index may differ only where the true
    scores (``scores`` [Q, N]) of the two rows tie within 1e-6."""
    (pv, pi), (rv, ri) = (np.asarray(a) for a in port), (np.asarray(a) for a in ref)
    assert pv.shape == rv.shape and pi.shape == ri.shape
    np.testing.assert_allclose(pv, rv, atol=atol, rtol=0)
    for row, slot in zip(*np.nonzero(pi != ri)):
        a, b = pi[row, slot], ri[row, slot]
        assert a >= 0 and b >= 0, (row, slot, a, b)
        assert abs(scores[row, a] - scores[row, b]) <= 1e-6, (row, slot, a, b)


def oracle(w, q, k, mask=None, exclude=None):
    s = q @ w.T
    if mask is not None:
        s[:, ~mask] = -np.inf
    if exclude is not None:
        for r, e in enumerate(exclude):
            if e >= 0:
                s[r, e] = -np.inf
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx


def both(w, q, k, *, block_rows, mask=None, exclude=None, head=None, top_r=None,
         bf16=False):
    """(port result, JAX result) of masked_topk on the same numpy inputs."""
    tw = torch.from_numpy(w).to(torch.bfloat16 if bf16 else torch.float32)
    tq = torch.from_numpy(q).to(tw.dtype)
    port = topk.masked_topk(
        tw, tq, k,
        mask=None if mask is None else torch.from_numpy(mask),
        exclude=None if exclude is None else torch.from_numpy(exclude),
        head=None if head is None else torch.tensor(head),
        top_r=top_r,
    )
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    ref = jtopk.masked_topk(
        jnp.asarray(w, jdt), jnp.asarray(q, jdt), k,
        mask=None if mask is None else jnp.asarray(mask),
        exclude=None if exclude is None else jnp.asarray(exclude),
        head=None if head is None else jnp.asarray(head),
        use_head=head is not None, block_rows=block_rows, top_r=top_r,
    )
    return port, ref


def _case_oracle():
    w = table(1500)
    q = w[[3, 77, 1400]]
    port, ref = both(w, q, 7, block_rows=128)
    assert_same_topk(port, oracle(w, q, 7), true_scores(w, q))
    return port, ref, true_scores(w, q)


def _case_exclude():
    w = table(1500, seed=2)
    excl = np.asarray([10, 700, -1], np.int32)
    q = w[[10, 700, 5]]
    port, ref = both(w, q, 5, block_rows=256, exclude=excl)
    assert 10 not in np.asarray(port[1][0]) and 700 not in np.asarray(port[1][1])
    assert_same_topk(port, oracle(w, q, 5, exclude=excl), true_scores(w, q))
    return port, ref, true_scores(w, q)


def _case_mask():
    w = table(1200, seed=3)
    keep = np.random.default_rng(3).uniform(size=1200) > 0.6
    q = w[[5, 6]]
    port, ref = both(w, q, 6, block_rows=512, mask=keep)
    assert keep[np.asarray(port[1])].all()
    assert_same_topk(port, oracle(w, q, 6, mask=keep), true_scores(w, q))
    return port, ref, true_scores(w, q)


def _case_fewer_valid_than_k():
    w = table(700, seed=4)
    keep = np.zeros(700, bool)
    keep[[1, 400, 650]] = True
    port, ref = both(w, w[[0]], 8, block_rows=128, mask=keep)
    pv, pi = (np.asarray(a)[0] for a in port)
    assert (pv[:3] > -1e29).all() and (pv[3:] <= -1e29).all() and (pi[3:] == -1).all()
    return port, ref, true_scores(w, w[[0]])


def _case_unaligned_n():
    w = table(333, seed=5)
    q = w[[7, 300]]
    port, ref = both(w, q, 5, block_rows=128)
    assert_same_topk(port, oracle(w, q, 5), true_scores(w, q))
    return port, ref, true_scores(w, q)


def _case_k_across_groups():
    w = table(1300, seed=6)
    q = w[[0, 1000]]
    port, ref = both(w, q, 50, block_rows=256)
    assert_same_topk(port, oracle(w, q, 50), true_scores(w, q))
    return port, ref, true_scores(w, q)


def _case_batched_queries():
    w = table(1100, seed=7)
    q = w[np.arange(1, 70, 3)]
    port, ref = both(w, q, 3, block_rows=256)
    assert_same_topk(port, oracle(w, q, 3), true_scores(w, q))
    return port, ref, true_scores(w, q)


def _case_head():
    w = table(1536, seed=8)
    q = table(4, seed=9)
    keep = np.random.default_rng(8).uniform(size=1536) > 0.3
    head = np.asarray([1.9, -0.4], np.float32)
    port, ref = both(w, q, 6, block_rows=512, mask=keep, head=head)
    s = true_scores(w, q, head)
    masked = np.where(keep, s, -np.inf)
    idx = np.argsort(-masked, axis=1)[:, :6]
    assert_same_topk(port, (np.take_along_axis(masked, idx, 1), idx), s)
    return port, ref, s


def _case_top_r_forced_high():
    w = table(1024, seed=10)
    q = w[[2, 900]]
    port, ref = both(w, q, 10, block_rows=512, top_r=40)
    assert topk.top_r_policy(10, 1024, 40) == 40
    return port, ref, true_scores(w, q)


CASES = {
    "oracle": _case_oracle,
    "exclude": _case_exclude,
    "mask": _case_mask,
    "fewer_valid_than_k": _case_fewer_valid_than_k,
    "unaligned_n": _case_unaligned_n,
    "k_across_groups": _case_k_across_groups,
    "batched_queries": _case_batched_queries,
    "head": _case_head,
    "top_r_forced_high": _case_top_r_forced_high,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_topk_matches_jax(case):
    port, ref, scores = CASES[case]()
    assert_same_topk(port, ref, scores)


def test_bf16_table_matches_jax():
    w = table(1280, seed=11)
    q = w[[9, 1111]]
    port, ref = both(w, q, 5, block_rows=256, bf16=True)
    assert port[0].dtype == torch.float32  # the rescore is exact f32
    wb = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    assert_same_topk(port, ref, true_scores(wb, wb[[9, 1111]]), atol=1e-2)
    # Against f32 scans of the same rows: close, mostly the same rows.
    v32, i32 = topk.masked_topk(torch.from_numpy(w), torch.from_numpy(q), 5)
    np.testing.assert_allclose(port[0].numpy(), v32.numpy(), atol=1e-2)


def test_shuffled_table_translation_matches_jax():
    w = table(1400, seed=12)
    rows = np.asarray([4, 800, 1399])
    keep = np.random.default_rng(12).uniform(size=1400) > 0.25
    keep[rows] = True
    port = topk.cosine_topk(topk.shuffle_rows(torch.from_numpy(w), seed=5),
                            torch.from_numpy(w[rows]), 8, mask=keep, exclude=rows)
    ref = jtopk.cosine_topk(jtopk.shuffle_rows(jnp.asarray(w), seed=5),
                            jnp.asarray(w[rows]), 8, mask=jnp.asarray(keep),
                            exclude=jnp.asarray(rows, jnp.int32), block_rows=256)
    scores = true_scores(w, w[rows])
    assert_same_topk(port, ref, scores)
    assert_same_topk(port, oracle(w, w[rows], 8, mask=keep, exclude=rows), scores)
    # The permutation is numpy's, and it round-trips.
    st = topk.shuffle_rows(torch.from_numpy(w), seed=5)
    np.testing.assert_array_equal(st.perm.numpy(), np.random.default_rng(5).permutation(1400))
    np.testing.assert_array_equal(st.inv[st.perm].numpy(), np.arange(1400))
    np.testing.assert_array_equal(st.table.numpy(), w[st.perm.numpy()])


def test_index_check_catches_right_values_on_wrong_rows():
    """Results mapped back through ``inv`` where ``perm`` belongs carry the
    right values on the wrong rows; the index check must fail on them."""
    w = table(1400, seed=12)
    q = torch.from_numpy(w[[4, 800, 1399]])
    st = topk.shuffle_rows(torch.from_numpy(w), seed=5)
    good = topk.cosine_topk(st, q, 8)
    bad = topk.cosine_topk(topk.ShuffledTable(st.table, perm=st.inv, inv=st.perm), q, 8)
    scores = true_scores(w, q.numpy())
    ref = oracle(w, q.numpy(), 8)
    assert_same_topk(good, ref, scores)
    np.testing.assert_array_equal(bad[0].numpy(), good[0].numpy())
    with pytest.raises(AssertionError):
        assert_same_topk(bad, ref, scores)


def test_stage1_pool_matches_jax_kernel():
    """Stage 1 alone: the rows the port's keys put in the rescore pool are
    the rows the JAX Pallas kernel's keys put there (N a multiple of 512, so
    both use the same 512-row groups), with head, mask and exclude."""
    n, k, r = 1536, 5, 24
    w = table(n, seed=13)
    q = table(3, seed=14)
    keep = np.random.default_rng(13).uniform(size=n) > 0.3
    excl = np.asarray([3, -1, 1500], np.int32)
    head = np.asarray([2.5, 0.3], np.float32)
    m = max(2 * k + 4, 24)
    keys = topk.packed_candidates(
        torch.from_numpy(w), torch.from_numpy(q), r, mask=torch.from_numpy(keep),
        exclude=torch.from_numpy(excl), head=torch.from_numpy(head))
    assert keys.shape == (3, (n // 512) * r) and keys.dtype == torch.int32
    cand, alive = topk._stage1_pool(keys, m, r)
    qp = 8
    jc, ja = jtopk._packed_candidates(
        jnp.asarray(w), jnp.pad(jnp.asarray(q), ((0, qp - 3), (0, 0))),
        m=m, n=n, qn=3, qp=qp, block_rows=512, mask=jnp.asarray(keep),
        exclude_row=jnp.pad(jnp.asarray(excl).reshape(1, 3), ((0, 0), (0, qp - 3)),
                            constant_values=-1),
        head_arr=jnp.asarray(head).reshape(1, 2), use_head=True, interpret=True,
        queries_f32=jnp.asarray(q), tail_table=jnp.asarray(w), tail_k=k, top_r=r,
    )
    jc, ja = np.asarray(jc), np.asarray(ja)
    for row in range(3):
        mine = set(cand[row][alive[row]].tolist())
        theirs = set(jc[row][ja[row]].tolist())
        assert mine == theirs
        assert keep[list(mine)].all() and excl[row] not in mine


def test_plain_stage1_keys():
    """Key layout of the plain stage 1: per group, top_r keys largest first;
    the low 9 bits are the lane; dead slots (mask, exclude, rows >= N) are
    non-positive."""
    n = 700
    w = torch.from_numpy(table(n, seed=15))
    keep = torch.ones(n, dtype=torch.bool)
    keep[600:] = False
    keys = topk.packed_candidates(w, w[[0]], 200, mask=keep, exclude=torch.tensor([0]))
    g = keys.view(1, 2, 200)
    assert (g[..., :-1] >= g[..., 1:]).all()
    rows = torch.arange(2)[:, None] * 512 + (g[0] & 511)
    live = g[0] > 0
    assert int(live.sum()) == 200 + (599 - 512 + 1)  # group 0 full; group 1: rows 512..599
    assert (rows[live] < 600).all() and not (rows[live] == 0).any()
    s = (w[[0]] @ w.T)[0]
    decoded = (g[0] & ~511).view(torch.float32) - 2.0
    np.testing.assert_allclose(decoded[live].numpy(), s[rows[live]].numpy(), atol=2.5e-4)


def test_top_r_policy_and_unported_tables():
    assert topk.top_r_policy(10, 91_641) == 4
    assert topk.top_r_policy(10, 17_560) == 6
    assert topk.top_r_policy(600, 17_560) == 70   # the cover rule
    assert topk.top_r_policy(10, 120) == 65        # one group: cover + 1
    assert topk.top_r_policy(5, 1536, 30) == 30
    with pytest.raises(NotImplementedError, match="IVF"):
        topk.cosine_topk(object(), torch.zeros(4), 3)
    # int8 tables are ported: a QuantizedTable, bare or shuffled, scans.
    from anime_recommendations_tpu_torch.ops.quantized import quantize_rows

    w = table(700, seed=16)
    want = oracle(w, w[[3]], 5)
    for t in (quantize_rows(torch.from_numpy(w)),
              topk.shuffle_rows(torch.from_numpy(w), seed=2)._replace(
                  table=quantize_rows(torch.from_numpy(w[np.random.default_rng(2).permutation(700)])))):
        assert_same_topk(topk.cosine_topk(t, torch.from_numpy(w[3]), 5), want, true_scores(w, w[[3]]))
