"""The port's int8 retrieval (ops/quantized.py, and stage 1 on int8 rows in
ops/topk.py) against the JAX package's, on the same inputs.

The JAX side runs as tests/test_ops.py runs it: the Pallas stage-1 kernel
with quantized=True in interpret mode on the CPU. The port runs its plain
stage 1 (CPU tensors). Tolerances: quantize_rows bit-equal; top-k values
within 1e-5 absolute (both rescore in exact f32) and indices equal except
where the two rows' true scores tie within 1e-6; stage-1 keys bit-equal to
a numpy evaluation of the key formula without a head, within one key step
(the 9 lane bits) with the sigmoid head, whose exp may differ by an ulp.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_recommendations_tpu.ops import quantized as jquantized
from anime_recommendations_tpu.ops import topk as jtopk
from anime_recommendations_tpu_torch.ops import quantized, topk

from test_torch_topk import assert_same_topk, normed, oracle, true_scores

torch.set_num_threads(2)


def table(n, d, seed):
    return normed(np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))


@pytest.mark.parametrize("kind", ["normalized", "wide_range"])
def test_quantize_rows_bit_equal_to_jax(kind):
    rng = np.random.default_rng(3)
    w = table(777, 48, seed=3)
    if kind == "wide_range":
        w = w * rng.uniform(1e-6, 1e3, (777, 1)).astype(np.float32)
        w[[0, 400]] = 0.0       # the absmax clamp: zero rows quantize to zeros
        w[5, :] = 1e-20
    qt = quantized.quantize_rows(torch.from_numpy(w))
    jqt = jquantized.quantize_rows(jnp.asarray(w))
    assert qt.q.dtype == torch.int8 and qt.scale.dtype == torch.float32
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(jqt.q))
    np.testing.assert_array_equal(qt.scale.numpy().view(np.int32),
                                  np.asarray(jqt.scale).view(np.int32))
    np.testing.assert_array_equal(qt.f32.numpy(), w)
    assert int(qt.q.abs().max()) == 127


def both(w, q, k, *, mask=None, exclude=None, head=None, block_rows=None):
    """(port result, JAX result) of quantized_topk on the same numpy inputs."""
    port = quantized.quantized_topk(
        quantized.quantize_rows(torch.from_numpy(w)), torch.from_numpy(q), k,
        mask=None if mask is None else torch.from_numpy(mask),
        exclude=None if exclude is None else torch.from_numpy(exclude),
        head=None if head is None else torch.from_numpy(head))
    kw = {} if block_rows is None else dict(block_rows=block_rows)
    ref = jquantized.quantized_topk(
        jquantized.quantize_rows(jnp.asarray(w)), jnp.asarray(q), k,
        mask=None if mask is None else jnp.asarray(mask),
        exclude=None if exclude is None else jnp.asarray(exclude),
        head=None if head is None else jnp.asarray(head), use_head=head is not None, **kw)
    return port, ref


def _case_mask_exclude():
    rng = np.random.default_rng(21)
    w = table(3000, 64, seed=21)
    q = w[:6]
    mask = rng.uniform(size=3000) > 0.25
    excl = np.arange(6, dtype=np.int32)
    port, ref = both(w, q, 10, mask=mask, exclude=excl, block_rows=1024)
    want = oracle(w, q, 10, mask=mask, exclude=excl)
    return port, ref, want, true_scores(w, q)


def _case_tail_rows():
    w = table(3000, 64, seed=33)
    rows = np.arange(2560, 3000, 40)
    port, ref = both(w, w[rows], 10)
    for r, row in enumerate(rows):
        assert row in port[1][r].tolist()          # the self-match comes back
    return port, ref, oracle(w, w[rows], 10), true_scores(w, w[rows])


def _case_single_block_k_above_valid():
    w = table(100, 32, seed=22)
    mask = np.zeros(100, bool)
    mask[:5] = True
    port, ref = both(w, w[:2], 8, mask=mask)
    vals, idx = (a.numpy() for a in port)
    assert (idx[:, :5] < 5).all() and (idx[:, :5] >= 0).all()
    assert (vals[:, 5:] <= -1e29).all() and (idx[:, 5:] == -1).all()
    return ((vals[:, :5], idx[:, :5]), tuple(np.asarray(a)[:, :5] for a in ref),
            oracle(w, w[:2], 5, mask=mask), true_scores(w, w[:2]))


def _case_head():
    rng = np.random.default_rng(8)
    w = table(2048, 64, seed=8)
    q = table(4, 64, seed=9)
    mask = rng.uniform(size=2048) > 0.3
    head = np.asarray([1.9, -0.4], np.float32)
    port, ref = both(w, q, 6, mask=mask, head=head, block_rows=1024)
    s = true_scores(w, q, head)
    masked = np.where(mask, s, -np.inf)
    idx = np.argsort(-masked, axis=1, kind="stable")[:, :6]
    return port, ref, (np.take_along_axis(masked, idx, 1), idx), s


CASES = {
    "mask_exclude": _case_mask_exclude,
    "tail_rows": _case_tail_rows,
    "single_block_k_above_valid": _case_single_block_k_above_valid,
    "head": _case_head,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantized_topk_matches_jax_and_oracle(case):
    port, ref, want, scores = CASES[case]()
    assert_same_topk(port, ref, scores)
    assert_same_topk(port, want, scores)


def _numpy_keys(q_int, qscale, w_int, wscale, top_r, mask, exclude, head):
    """Stage-1 keys from the formula, in numpy f32, one rounded operation
    at a time: acc exact; s2 = acc * wscale + 2 / qscale without a head,
    sigmoid(alpha * (acc * qscale * wscale) + beta) + 2 with one."""
    f32 = np.float32
    acc = (q_int.astype(np.int64) @ w_int.astype(np.int64).T).astype(f32)
    if head is None:
        s2 = acc * wscale[None, :] + (f32(2.0) / qscale)[:, None]
    else:
        s = (acc * qscale[:, None]) * wscale[None, :]
        s2 = f32(1.0) / (f32(1.0) + np.exp(-(head[0] * s + head[1]))) + f32(2.0)
    assert s2.dtype == np.float32
    n = w_int.shape[0]
    valid = np.ones_like(s2, bool)
    if mask is not None:
        valid &= mask[None, :]
    if exclude is not None:
        valid &= np.arange(n)[None, :] != exclude[:, None]
    s2 = np.where(valid, s2, f32(-1.0))
    groups = -(-n // 512)
    s2 = np.pad(s2, ((0, 0), (0, groups * 512 - n)), constant_values=-1.0)
    keys = (s2.view(np.int32) & ~511) | (np.arange(groups * 512, dtype=np.int32) & 511)
    keys = -np.sort(-keys.reshape(len(q_int), groups, 512).astype(np.int64), axis=2)
    return keys[:, :, :top_r].reshape(len(q_int), groups * top_r).astype(np.int32)


@pytest.mark.parametrize("with_head", [False, True], ids=["no_head", "head"])
def test_int8_plain_stage1_keys_match_the_formula(with_head):
    """N = 1300: a ragged last group; mask, exclude and top_r of 1, 4, 512."""
    rng = np.random.default_rng(15)
    w = table(1300, 32, seed=15)
    qt = quantized.quantize_rows(torch.from_numpy(w))
    q_int, q_scale = quantized._quantize(torch.from_numpy(w[[0, 7, 1299]]))
    mask = rng.uniform(size=1300) > 0.2
    excl = np.asarray([0, -1, 1299], np.int32)
    head = np.asarray([3.0, -0.5], np.float32) if with_head else None
    for top_r in (1, 4, 512):
        got = topk.packed_candidates(
            qt.q, q_int, top_r, mask=torch.from_numpy(mask), exclude=torch.from_numpy(excl),
            head=None if head is None else torch.from_numpy(head), qscale=q_scale,
            wscale=qt.scale).numpy()
        want = _numpy_keys(q_int.numpy(), q_scale.numpy(), qt.q.numpy(), qt.scale.numpy(),
                           top_r, mask, excl, head)
        assert got.shape == want.shape == (3, 3 * top_r)
        if not with_head:
            np.testing.assert_array_equal(got, want)
        else:
            live = want > 0
            assert np.array_equal(got > 0, live)
            step = np.abs((got & ~511).view(np.float32) - (want & ~511).view(np.float32))
            assert step[live].max() <= 1.3e-4
    # The keys order each query's rows as the cosine does (no head: the
    # query's scale is folded into the bias): live keys decode to
    # (cos + 2) / qscale.
    if not with_head:
        decoded = (got & ~511).view(np.float32) * q_scale.numpy()[:, None] - 2.0
        rows = (np.arange(got.shape[1]) // 512 * 512)[None, :] + (got & 511)   # top_r = 512
        live = got > 0
        cos = np.take_along_axis(w[[0, 7, 1299]] @ w.T, np.clip(rows, 0, 1299), 1)
        assert np.abs(decoded - cos)[live].max() < 0.03    # int8 noise, ~1/127 per element


def test_int8_mma_threshold_is_the_kernels():
    """ops/topk.INT8_MMA_MIN_Q (the launch counters' rule) is the query count
    from which csrc/packed_topk_int8.cu takes its tensor-core branch."""
    src = (Path(topk.__file__).resolve().parents[1] / "csrc" / "packed_topk_int8.cu").read_text()
    found = re.findall(r"constexpr int kMmaMinQ = (\d+);", src)
    assert found == [str(topk.INT8_MMA_MIN_Q)]


@pytest.mark.parametrize("with_head", [False, True], ids=["no_head", "head"])
@pytest.mark.parametrize("d", [16, 48, 128])
def test_int8_plain_stage1_keys_do_not_depend_on_the_query_count(d, with_head):
    """Both kernel branches sum the same exact integers, so the plain version
    has no query-count rule: each query's keys in a batch of 65 (across the
    64-query tile) equal its keys alone, bit for bit, and the batch's keys
    equal the key formula's without a head."""
    rng = np.random.default_rng(d)
    w = table(1300, d, seed=d)
    qt = quantized.quantize_rows(torch.from_numpy(w))
    q_int, q_scale = quantized._quantize(torch.from_numpy(w[:65]))
    mask = torch.from_numpy(rng.uniform(size=1300) > 0.2)
    excl = torch.arange(65, dtype=torch.int32)
    head = torch.tensor([3.0, -0.5]) if with_head else None
    batch = topk.packed_candidates(qt.q, q_int, 4, mask=mask, exclude=excl, head=head,
                                   qscale=q_scale, wscale=qt.scale)
    for i in (0, 15, 16, 63, 64):
        alone = topk.packed_candidates(qt.q, q_int[i:i + 1], 4, mask=mask, exclude=excl[i:i + 1],
                                       head=head, qscale=q_scale[i:i + 1], wscale=qt.scale)
        assert torch.equal(alone, batch[i:i + 1])
    if not with_head:
        want = _numpy_keys(q_int.numpy(), q_scale.numpy(), qt.q.numpy(), qt.scale.numpy(), 4,
                           mask.numpy(), excl.numpy(), None)
        np.testing.assert_array_equal(batch.numpy(), want)


def test_packed_candidates_int8_contract():
    w = torch.from_numpy(table(600, 32, seed=2))
    qt = quantized.quantize_rows(w)
    q_int, q_scale = quantized._quantize(w[:2])
    with pytest.raises(ValueError, match="qscale and wscale"):
        topk.packed_candidates(qt.q, q_int, 3)
    with pytest.raises(ValueError, match="qscale and wscale"):
        topk.packed_candidates(w, w[:2], 3, qscale=q_scale, wscale=qt.scale)
    with pytest.raises(ValueError, match="unsupported device"):
        topk.packed_candidates(qt.q.to("meta"), q_int.to("meta"), 3, qscale=q_scale.to("meta"),
                               wscale=qt.scale.to("meta"))


def test_quantized_tables_through_dispatch_match_jax():
    """A ShuffledTable over a QuantizedTable (what an int8 context scans),
    through cosine_topk with mask and exclude, and through score_topk with
    the head; exact_scan on it raises, as in JAX."""
    from anime_recommendations_tpu.ops import scoring as jscoring
    from anime_recommendations_tpu_torch.ops import scoring

    w = table(1400, 32, seed=12)
    rows = np.asarray([4, 800, 1399])
    keep = np.random.default_rng(12).uniform(size=1400) > 0.25
    keep[rows] = True
    st = topk.shuffle_rows(torch.from_numpy(w), seed=5)
    st = st._replace(table=quantized.quantize_rows(st.table))
    jst = jtopk.shuffle_rows(jnp.asarray(w), seed=5)
    jst = jst._replace(table=jquantized.quantize_rows(jst.table))
    port = topk.cosine_topk(st, torch.from_numpy(w[rows]), 8, mask=keep, exclude=rows)
    ref = jtopk.cosine_topk(jst, jnp.asarray(w[rows]), 8, mask=jnp.asarray(keep),
                            exclude=jnp.asarray(rows, jnp.int32))
    scores = true_scores(w, w[rows])
    assert_same_topk(port, ref, scores)
    assert_same_topk(port, oracle(w, w[rows], 8, mask=keep, exclude=rows), scores)
    head = np.asarray([2.2, 0.1], np.float32)
    port = scoring.score_topk(st, torch.from_numpy(w[rows]), torch.from_numpy(head), 6, mask=keep)
    ref = jscoring.score_topk(jst, jnp.asarray(w[rows]), jnp.asarray(head), 6,
                              mask=jnp.asarray(keep))
    assert_same_topk(port, ref, true_scores(w, w[rows], head))
    with pytest.raises(ValueError, match="float-table mode"):
        topk.cosine_topk(st, torch.from_numpy(w[rows]), 8, exact_scan=True)
    with pytest.raises(ValueError, match="float-table mode"):
        topk.cosine_topk(st.table, torch.from_numpy(w[rows]), 8, exact_scan=True)


def test_pool_size_follows_jax():
    """m = min(max(4k, k + 8), n) by default and never below k: a pinned
    m < k still returns k rows."""
    w = table(900, 32, seed=4)
    qt = quantized.quantize_rows(torch.from_numpy(w))
    v, i = quantized.quantized_topk(qt, torch.from_numpy(w[[3]]), 12, m=2)
    assert v.shape == i.shape == (1, 12) and bool((i >= 0).all())
    assert_same_topk((v, i), oracle(w, w[[3]], 12), true_scores(w, w[[3]]))
