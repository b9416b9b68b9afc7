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
    with pytest.raises(TypeError, match="unsupported retrieval table"):
        topk.cosine_topk(object(), torch.zeros(4), 3)
    # int8 tables are ported: a QuantizedTable, bare or shuffled, scans.
    from anime_recommendations_tpu_torch.ops.quantized import quantize_rows

    w = table(700, seed=16)
    want = oracle(w, w[[3]], 5)
    for t in (quantize_rows(torch.from_numpy(w)),
              topk.shuffle_rows(torch.from_numpy(w), seed=2)._replace(
                  table=quantize_rows(torch.from_numpy(w[np.random.default_rng(2).permutation(700)])))):
        assert_same_topk(topk.cosine_topk(t, torch.from_numpy(w[3]), 5), want, true_scores(w, w[[3]]))


def tf32_reference(x: np.ndarray) -> np.ndarray:
    """TF32 rounding from first principles, in f64: |x| = m 2^e with m in
    [0.5, 1) has a TF32 step of 2^(e - 11); round |x| / step to nearest,
    halves away from zero, and put the sign back (normal values only)."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(np.abs(x64))
    step = np.ldexp(1.0, e - 11)
    return (np.sign(x64) * np.floor(np.abs(x64) / step + 0.5) * step).astype(np.float32)


def test_round_tf32_matches_a_bit_level_reference():
    rng = np.random.default_rng(21)
    bits = rng.integers(0x00800000, 0x7F000000, 4000, dtype=np.int64)
    edges = []
    for hi in (0x3F800000, 0x3FFFE000, 0x40000000, 0x3F7FE000, 0x00800000, 0x7E800000):
        # ties (0x1000), just below and above them, and values 1 step under
        # the next binade (0x3FFFF000 rounds up to 2.0).
        edges += [hi | low for low in (0x0000, 0x0FFF, 0x1000, 0x1001, 0x1FFF)]
    bits = np.concatenate([bits, edges, [0x3FFFF000, 0x3F7FF000]]).astype(np.uint32)
    x = np.concatenate([bits, bits | np.uint32(0x80000000)]).view(np.float32)   # and negatives
    x = np.concatenate([x, (rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000))
                        .astype(np.float32)])
    got = topk.round_tf32(torch.from_numpy(x)).numpy()
    want = tf32_reference(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    # The cases themselves: a tie rounds away from zero, on both signs, and
    # a tie below a binade edge carries into the next binade.
    one = np.float32(1.0).view(np.uint32)
    tie = np.asarray([one | 0x1000, (one | 0x1000) | 0x80000000, 0x3FFFF000], np.uint32)
    r = topk.round_tf32(torch.from_numpy(tie.view(np.float32))).numpy()
    np.testing.assert_array_equal(r, np.asarray([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 2.0], np.float32))


def test_tf32_threshold_is_the_kernels(monkeypatch):
    """The kernel takes its tensor-core branch for more than one query, so
    the plain version rounds an f32 table and its queries to TF32 from two
    queries on, never for one query and never for a bf16 table."""
    assert topk.TF32_MIN_Q == 2
    rounded = []
    real = topk.round_tf32
    monkeypatch.setattr(topk, "round_tf32", lambda x: rounded.append(tuple(x.shape)) or real(x))
    w = torch.from_numpy(table(700, seed=5))
    topk._packed_candidates_plain(w, w[:1], 4, None, None, None)
    assert rounded == []
    topk._packed_candidates_plain(w, w[:2], 4, None, None, None)
    assert rounded == [(700, 32), (2, 32)]
    wb = w.to(torch.bfloat16)
    topk._packed_candidates_plain(wb, wb[:5], 4, None, None, None)
    assert rounded == [(700, 32), (2, 32)]


# One key step (9 dropped bits of s2 < 4: 2^-13) plus the TF32 error of a
# dot product of unit rows: two operands rounded to 2^-11 relative each,
# so at most 2^-10 * sum |w_i q_i| <= 2^-10.
KEY_STEP, TF32_NOISE = 2.0 ** -13, 2.0 ** -10


@pytest.mark.parametrize("q", [topk.TF32_MIN_Q - 1, topk.TF32_MIN_Q])
def test_plain_stage1_keys_across_the_tf32_threshold_match_jax(q):
    """Below the threshold the plain stage 1 is f32; from it, TF32 (as the
    kernel's tensor-core branch). Either way its keys against the JAX
    Pallas stage 1 (interpret mode, N a multiple of 512 so both use the
    same groups; every group's top_r in the pool): the same live rows per
    (query, group) except where true scores tie within the noise at the
    group's top_r boundary, and every live key within one key step, plus
    the TF32 bound from the threshold, of its row's true score."""
    n, r = 1536, 24
    w = table(n, seed=13)
    qs = table(q, seed=14)
    keep = np.random.default_rng(13).uniform(size=n) > 0.3
    excl = np.where(np.arange(q) % 3 == 0, -1, np.arange(q) * 37 % n).astype(np.int32)
    head = np.asarray([2.5, 0.3], np.float32)
    keys = topk._packed_candidates_plain(
        torch.from_numpy(w), torch.from_numpy(qs), r, torch.from_numpy(keep),
        torch.from_numpy(excl), torch.from_numpy(head))
    cand, alive = topk._stage1_pool(keys, keys.shape[1], r)
    qp = -(-q // 8) * 8
    jc, ja = jtopk._packed_candidates(
        jnp.asarray(w), jnp.pad(jnp.asarray(qs), ((0, qp - q), (0, 0))),
        m=3 * r, n=n, qn=q, qp=qp, block_rows=512, mask=jnp.asarray(keep),
        exclude_row=jnp.pad(jnp.asarray(excl).reshape(1, q), ((0, 0), (0, qp - q)),
                            constant_values=-1),
        head_arr=jnp.asarray(head).reshape(1, 2), use_head=True, interpret=True,
        queries_f32=jnp.asarray(qs), tail_table=jnp.asarray(w), tail_k=5, top_r=r,
    )
    jc, ja = np.asarray(jc), np.asarray(ja)
    s = true_scores(w, qs, head)
    live_rows = keep[None, :] & (np.arange(n)[None, :] != excl[:, None])
    # sigmoid' <= alpha / 4 carries the dot product's noise through the head.
    tol = KEY_STEP + (head[0] / 4 * TF32_NOISE if q >= topk.TF32_MIN_Q else 1e-6)
    decoded = ((keys & ~511).view(torch.float32) - 2.0).numpy()
    top = keys.topk(keys.shape[1], dim=1).values.numpy()   # the pool's order
    assert (decoded.max(axis=1) == ((top[:, 0] & ~511).view(np.float32) - 2.0)).all()
    for row in range(q):
        mine, theirs = cand[row][alive[row]].numpy(), jc[row][ja[row]]
        assert live_rows[row, mine].all() and len(set(mine)) == len(mine)
        got = (top[row][alive[row].numpy()] & ~511).view(np.float32) - 2.0
        assert (np.abs(got - s[row, mine]) <= tol).all()
        for g in range(n // 512):
            a = set(x for x in mine if x // 512 == g)
            b = set(int(x) for x in theirs if x // 512 == g)
            assert len(a) == len(b)
            group = np.sort(s[row, g * 512:(g + 1) * 512][live_rows[row, g * 512:(g + 1) * 512]])
            boundary = group[-min(r, len(group))]
            for x in a ^ b:
                assert abs(s[row, x] - boundary) <= 2 * tol, (row, g, x)


def test_masked_topk_from_the_tf32_threshold_matches_jax():
    """masked_topk at and above TF32_MIN_Q (the TF32 stage 1) against the
    JAX package and the dense oracle: values within 1e-5 (stage 2 is exact
    f32), indices equal except true ties within 1e-6."""
    w = table(1500, seed=22)
    keep = np.random.default_rng(22).uniform(size=1500) > 0.25
    for q in (topk.TF32_MIN_Q, 3 * topk.TF32_MIN_Q + 5):
        rows = np.arange(q) * 41 % 1500
        excl = np.where(np.arange(q) % 4 == 0, -1, rows).astype(np.int32)
        port, ref = both(w, w[rows], 9, block_rows=256, mask=keep, exclude=excl)
        scores = true_scores(w, w[rows])
        assert_same_topk(port, ref, scores)
        assert_same_topk(port, oracle(w, w[rows], 9, mask=keep, exclude=excl), scores)
