"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device. This file
imports no jax, so it also runs on a machine without it:

    ANIMEREC_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda

(ANIMEREC_TEST_TPU=1 keeps tests/conftest.py from importing jax.)

Tolerances. Top-k: values 1e-5 absolute for f32 tables, 1e-2 for bf16;
indices equal except where the two rows' true scores tie within 1e-6;
stage-1 keys within one key step (the 9 lane bits cut the score to ~1.2e-4
absolute), on both sides of the tensor-core threshold (from TF32_MIN_Q
queries the plain version rounds f32 operands to TF32 as the kernel does,
so only the summation order differs). int8 stage-1 keys: bit-equal without a head (an exact integer
product, then one rounded f32 operation per step, in the plain version's
order), one key step with the head (expf). Exact scan: values 1e-6
relative (fmaf in row order against cuBLAS's order), indices equal except
where true scores tie within 1e-6, and equal on tables whose scores are
exact. Row normalization: 1e-6 relative for f32 outputs (rsqrtf is not
correctly rounded), one bf16 ulp for bf16 outputs, zero rows zero. Fused
Adam: the kernel applies the plain version's operations in its order, so
where a row's duplicate gradients are summed in the same order the results
are equal (rows hit once: bit for bit); the plain version on the card sums
duplicates with index_add_'s atomics, in another order, so W', mu' and nu'
are held to 1e-5 relative to each tensor's largest entry, bf16 moments to
that plus one bf16 ulp, and sumsq to 1e-5 relative. Fused Adam with the gather (K5): the update is
K1's device code, so its tables and sumsq equal K1's bit for bit on the same
inputs, and its rows equal w'[next_ids] exactly (zero rows for ids outside
the table); against the plain version as K1. K1 with a dense gradient: its
dense kernel against the plain version as K1 (rows hit at most once bit
for bit), and a precomputed stable ``order`` bit for bit the call without.
On runs laid out against the kernels' tiles of sorted positions, K1, its
dense branch and K5 equal, every row bit for bit, the plain version fed the
kernels' own summation order (fused_adam.run_sums_in_tile_order), and each
pass alone equals its plain version.
"""

import numpy as np
import pytest
import torch

from anime_recommendations_tpu_torch.ops import _kernels, fused_adam, normalize, quantized, topk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(dev, n=5000, d=128, seed=16):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, d)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w = torch.from_numpy(w).to(dev)
    keep = torch.from_numpy(rng.uniform(size=n) > 0.2).to(dev)
    return w, keep


def row_scores(table, queries, idx, head=None):
    """f64 score of row ``idx[q, j]`` for query ``q`` ([Q, k]), through the head."""
    s = torch.einsum("qd,qkd->qk", queries.double(), table.double()[idx])
    return s if head is None else torch.sigmoid(head[0].double() * s + head[1].double())


def k2_counter(q):
    """The launch counter of the K2 branch that serves q queries."""
    return "packed_topk_mma" if q >= topk.TF32_MIN_Q else "packed_topk"


FEATURES = {
    "plain": lambda dev, keep: {},
    "mask_exclude": lambda dev, keep: dict(
        mask=keep, exclude=torch.tensor([1, 2, -1, 4000, 7], device=dev)),
    "mask_head": lambda dev, keep: dict(
        mask=keep, head=torch.tensor([3.0, -0.5], device=dev)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_masked_topk_kernel_matches_plain(cuda, dtype, feature):
    w, keep = inputs(cuda)
    tw = w.to(dtype)
    tq = tw[[1, 2, 3, 4000, 4999]]
    kw = FEATURES[feature](cuda, keep)
    before = _kernels.launches[k2_counter(5)]
    v, i = topk.masked_topk(tw, tq, 10, **kw)
    assert _kernels.launches[k2_counter(5)] == before + 1
    pv, pi = topk.two_stage_topk(topk._packed_candidates_plain, tw, tq, 10, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(),
                               atol=1e-5 if dtype == torch.float32 else 1e-2, rtol=0)
    assert bool((i >= 0).all()) and bool((pi >= 0).all())
    gap = (row_scores(tw, tq, i, kw.get("head")) - row_scores(tw, tq, pi, kw.get("head"))).abs()
    assert not bool(((i != pi) & (gap > 1e-6)).any())


# Both sides of the tensor-core threshold, partial tiles of both branches.
STAGE1_QS = sorted({1, 3, 8, 21, topk.TF32_MIN_Q - 1, topk.TF32_MIN_Q, topk.TF32_MIN_Q + 1, 130})


@pytest.mark.cuda
@pytest.mark.parametrize("head", [False, True], ids=["mask_exclude", "mask_exclude_head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("q", STAGE1_QS)
def test_stage1_keys_match_plain(cuda, q, dtype, head):
    """Ragged last group (N = 1300), both branches (below and from
    TF32_MIN_Q, the tensor-core branch's TF32 rounding in the plain version
    too), partial query tiles, top_r up to the whole group."""
    w, keep = inputs(cuda, n=1300, d=32)
    w = w.to(dtype)
    queries = torch.cat([w, w])[:q].contiguous()
    excl = torch.arange(q, device=cuda) % 1300
    excl[::5] = -1
    h = torch.tensor([3.0, -0.5], device=cuda) if head else None
    for top_r in (1, 4, 512):
        args = (w, queries, top_r, keep, excl, h)
        before = _kernels.launches[k2_counter(q)]
        got = topk.packed_candidates(*args)
        assert _kernels.launches[k2_counter(q)] == before + 1
        want = topk._packed_candidates_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (q, 3 * top_r)
        assert torch.equal(got > 0, want > 0)
        live = got > 0
        step = ((got & ~511).view(torch.float32) - (want & ~511).view(torch.float32)).abs()
        assert float(step[live].max()) <= 1.3e-4
        assert torch.equal(got[~live], want[~live])  # dead keys do not depend on scores


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_masked_topk_kernel_matches_plain_from_the_tf32_threshold(cuda, dtype, feature):
    """130 queries (the tensor-core branch, three query tiles, the last
    partial) against the plain two stages and the dense oracle."""
    w, keep = inputs(cuda)
    tw = w.to(dtype)
    rows = torch.arange(0, 5000, 38, device=cuda)[:130]
    tq = tw[rows]
    kw = FEATURES[feature](cuda, keep)
    if "exclude" in kw:
        kw["exclude"] = torch.where(rows % 3 == 0, -1, rows)
    v, i = topk.masked_topk(tw, tq, 10, **kw)
    pv, pi = topk.two_stage_topk(topk._packed_candidates_plain, tw, tq, 10, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(),
                               atol=1e-5 if dtype == torch.float32 else 1e-2, rtol=0)
    gap = (row_scores(tw, tq, i, kw.get("head")) - row_scores(tw, tq, pi, kw.get("head"))).abs()
    assert bool((i >= 0).all()) and not bool(((i != pi) & (gap > 1e-6)).any())
    s = tq.double() @ tw.double().T
    if "head" in kw:
        s = torch.sigmoid(kw["head"][0].double() * s + kw["head"][1].double())
    if "mask" in kw:
        s = s.masked_fill(~kw["mask"][None, :], -torch.inf)
    if "exclude" in kw:
        has = torch.nonzero(kw["exclude"] >= 0).squeeze(1)
        s[has, kw["exclude"][has]] = -torch.inf
    oracle = s.topk(10, dim=1).indices
    assert bool((i.sort(dim=1).values == oracle.sort(dim=1).values).all())


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    w, _ = inputs(cuda, n=600, d=32)
    with pytest.raises(ValueError):
        topk._packed_candidates_cuda(w[:, :24].contiguous(), w[:2, :24].contiguous(), 3,
                                     None, None, None)    # D % 16
    with pytest.raises(ValueError):
        topk._packed_candidates_cuda(w, w[:2], 513, None, None, None)
    with pytest.raises(TypeError):
        topk._packed_candidates_cuda(w.double(), w[:2].double(), 3, None, None, None)
    with pytest.raises(ValueError):
        topk._packed_candidates_cuda(w[:, ::2], w[:2, ::2], 3, None, None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1300, 91_641])
def test_l2_normalize_kernel_matches_plain(cuda, n, out_dtype):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 128)).astype(np.float32) * rng.uniform(1e-3, 10, (n, 1)).astype(np.float32)
    x[[0, n // 2, n - 1]] = 0.0
    x = torch.from_numpy(x).to(cuda)
    for eps in (1e-12, 1e-24):
        before = _kernels.launches["l2_normalize"]
        got = normalize.l2_normalize_rows(x, eps=eps, out_dtype=out_dtype)
        assert _kernels.launches["l2_normalize"] == before + 1
        want = normalize._l2_normalize_rows_plain(x, eps, out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == x.shape
        assert not bool(got[[0, n // 2, n - 1]].any())
        g, w = got.float(), want.float()
        if out_dtype == torch.float32:
            tol = 1e-6 * w.abs()
        else:   # one bf16 ulp: the two f32 values may round to either neighbour
            tol = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
        assert bool(((g - w).abs() <= tol).all())


def int8_inputs(dev, n, d, q, seed):
    w, keep = inputs(dev, n=n, d=d, seed=seed)
    qt = quantized.quantize_rows(w)
    q_int, q_scale = quantized._quantize(w[:q])
    return w, keep, qt, q_int.contiguous(), q_scale


@pytest.mark.cuda
@pytest.mark.parametrize("head", [False, True], ids=["no_head", "head"])
@pytest.mark.parametrize("q", [1, 3, 8, 21])
def test_int8_stage1_keys_match_plain(cuda, q, head):
    """Ragged last group (N = 1300), query tiles of 1 and 8 with a partial
    tile, top_r up to the whole group, mask and exclude."""
    w, keep, qt, q_int, q_scale = int8_inputs(cuda, 1300, 32, q, seed=17)
    excl = torch.arange(q, device=cuda)
    h = torch.tensor([3.0, -0.5], device=cuda) if head else None
    for top_r in (1, 4, 512):
        args = (qt.q, q_int, top_r, keep, excl, h)
        before = _kernels.launches["packed_topk_int8"]
        got = topk.packed_candidates(*args, qscale=q_scale, wscale=qt.scale)
        assert _kernels.launches["packed_topk_int8"] == before + 1
        want = topk._packed_candidates_plain(*args, q_scale, qt.scale)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (q, 3 * top_r)
        if not head:
            assert torch.equal(got, want)
            continue
        assert torch.equal(got > 0, want > 0)
        live = got > 0
        step = ((got & ~511).view(torch.float32) - (want & ~511).view(torch.float32)).abs()
        assert float(step[live].max()) <= 1.3e-4
        assert torch.equal(got[~live], want[~live])


@pytest.mark.cuda
@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_quantized_topk_on_the_card_matches_the_cpu(cuda, feature):
    w, keep = inputs(cuda)
    kw = FEATURES[feature](cuda, keep)
    qt = quantized.quantize_rows(w)
    tq = w[[1, 2, 3, 4000, 4999]]
    before = _kernels.launches["packed_topk_int8"]
    v, i = quantized.quantized_topk(qt, tq, 10, **kw)
    assert _kernels.launches["packed_topk_int8"] == before + 1
    cpu = {key: t.cpu() for key, t in kw.items()}
    pv, pi = quantized.quantized_topk(quantized.QuantizedTable(*(t.cpu() for t in qt)), tq.cpu(),
                                      10, **cpu)
    np.testing.assert_allclose(v.cpu().numpy(), pv.numpy(), atol=1e-5, rtol=0)
    gap = (row_scores(w, tq, i, kw.get("head")).cpu()
           - row_scores(w.cpu(), tq.cpu(), pi, cpu.get("head"))).abs()
    assert not bool(((i.cpu() != pi) & (gap > 1e-6)).any())


def integer_rows(dev, n, d, seed):
    """Rows drawn from 50 small-integer rows: exact scores, exact ties."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-3, 4, (50, d)).astype(np.float32)
    return torch.from_numpy(base[rng.integers(50, size=n)]).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 600])
@pytest.mark.parametrize("feature", sorted(FEATURES) + ["duplicated_rows"])
def test_exact_topk_kernel_matches_plain(cuda, feature, k):
    w, keep = inputs(cuda)
    kw = FEATURES.get(feature, FEATURES["mask_exclude"])(cuda, keep)
    if feature == "duplicated_rows":
        w = integer_rows(cuda, 5000, 128, seed=3)
    for dtype in (torch.float32, torch.bfloat16):
        tw = w.to(dtype)
        tq = tw[[1, 2, 3, 4000, 4999]]
        before = _kernels.launches["exact_topk"]
        v, i = topk.masked_topk(tw, tq, k, exact_scan=True, **kw)
        assert _kernels.launches["exact_topk"] == before + 1
        pv, pi = topk._exact_scan_plain(tw, tq, k, **kw)
        torch.cuda.synchronize()
        assert v.shape == i.shape == (5, k)
        assert bool((i >= 0).all()) and torch.equal(v > -1e29, pv > -1e29)
        np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(), rtol=1e-6, atol=1e-7)
        if feature == "duplicated_rows":
            assert torch.equal(i, pi)      # exact ties: the lower row, in both
        else:
            gap = (row_scores(tw, tq, i, kw.get("head")) - row_scores(tw, tq, pi, kw.get("head"))).abs()
            assert not bool(((i != pi) & (gap > 1e-6)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 600])
@pytest.mark.parametrize("feature", ["mask_exclude", "mask_head", "duplicated_rows"])
@pytest.mark.parametrize("q", [1, 9, 64, 100])
def test_exact_topk_query_tiles_match_plain(cuda, q, feature, k):
    """Every query tile of the kernel (1, 8 and 32 queries, partial last
    tiles), with the adversarial ties (exact duplicate rows: the lower row,
    in both) at every query count."""
    w, keep = inputs(cuda)
    if feature == "duplicated_rows":
        w = integer_rows(cuda, 5000, 128, seed=4)
    rows = torch.arange(7, 5000, 47, device=cuda)[:q]
    kw = {"mask": keep}
    if feature == "mask_head":
        kw["head"] = torch.tensor([3.0, -0.5], device=cuda)
    else:
        kw["exclude"] = torch.where(rows % 4 == 0, -1, rows)
    for dtype in (torch.float32, torch.bfloat16):
        tw = w.to(dtype)
        tq = tw[rows].contiguous()
        before = _kernels.launches["exact_topk"]
        v, i = topk.masked_topk(tw, tq, k, exact_scan=True, **kw)
        assert _kernels.launches["exact_topk"] == before + 1
        pv, pi = topk._exact_scan_plain(tw, tq, k, **kw)
        torch.cuda.synchronize()
        assert v.shape == i.shape == (q, k)
        assert torch.equal(v > -1e29, pv > -1e29) and torch.equal(i >= 0, v > -1e29)
        np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(), rtol=1e-6, atol=1e-7)
        if feature == "duplicated_rows":
            assert torch.equal(i, pi)
        else:
            live = i >= 0
            gap = (row_scores(tw, tq, i.clamp(0), kw.get("head"))
                   - row_scores(tw, tq, pi.clamp(0), kw.get("head"))).abs()
            assert not bool(((i != pi) & live & (gap > 1e-6)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_kernels_take_wide_rows(cuda, dtype, d):
    """D past the 256 query dimensions a block stages at once, over 17,000
    rows, with mask, exclude and head: K2's stage-1 keys and K3 at 1, 2, 9,
    130 and 256 queries (K2's both branches and a partial 64-query tile;
    K3's query tiles of 1, 8 and 32), held to their plain versions as at
    D = 128."""
    n = 17_000
    w, keep = inputs(cuda, n=n, d=d, seed=d)
    w = w.to(dtype)
    head = torch.tensor([3.0, -0.5], device=cuda)
    tiles = set()
    for q in (1, 2, 9, 130, 256):
        rows = torch.arange(3, n, 61, device=cuda)[:q]
        queries = w[rows].contiguous()
        excl = torch.where(rows % 3 == 0, -1, rows)
        args = (w, queries, 4, keep, excl, head)
        got, want = topk.packed_candidates(*args), topk._packed_candidates_plain(*args)
        live = want > 0
        assert torch.equal(got > 0, live)
        step = ((got & ~511).view(torch.float32) - (want & ~511).view(torch.float32)).abs()
        assert float(step[live].max()) <= 1.3e-4
        before = _kernels.launches["exact_topk"]
        v, i = topk.masked_topk(w, queries, 10, mask=keep, exclude=excl, head=head,
                                exact_scan=True)
        assert _kernels.launches["exact_topk"] == before + 1
        pv, pi = topk._exact_scan_plain(w, queries, 10, keep, excl, head)
        torch.cuda.synchronize()
        np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(), rtol=1e-6, atol=1e-7)
        gap = (row_scores(w, queries, i, head) - row_scores(w, queries, pi, head)).abs()
        assert bool((i >= 0).all()) and not bool(((i != pi) & (gap > 1e-6)).any())
        tiles.add(_kernels.library("exact_topk").exact_topk_query_tile(n, q))
    assert tiles == {1, 8, 32}


@pytest.mark.cuda
def test_exact_topk_fewer_live_rows_than_k(cuda):
    w, _ = inputs(cuda, n=1300, d=32)
    keep = torch.zeros(1300, dtype=torch.bool, device=cuda)
    keep[[5, 700, 1299]] = True
    v, i = topk.masked_topk(w, w[:2], 8, mask=keep, exact_scan=True)
    pv, pi = topk._exact_scan_plain(w, w[:2], 8, mask=keep)
    assert torch.equal(i, pi) and bool((i[:, 3:] == -1).all()) and bool((v[:, 3:] == -1e30).all())


@pytest.mark.cuda
def test_new_wrappers_reject_what_their_kernels_do_not_take(cuda):
    w, _ = inputs(cuda, n=600, d=32)
    with pytest.raises(TypeError):                    # f32 in only
        normalize.l2_normalize_rows(w.to(torch.bfloat16))
    with pytest.raises(TypeError):                    # f32 or bf16 out
        normalize.l2_normalize_rows(w, out_dtype=torch.float16)
    with pytest.raises(ValueError):                   # D % 4
        normalize.l2_normalize_rows(w[:, :30].contiguous())
    with pytest.raises(ValueError):                   # not contiguous
        normalize.l2_normalize_rows(w[:, ::2])
    qt = quantized.quantize_rows(w)
    q_int, q_scale = quantized._quantize(w[:2])
    with pytest.raises(ValueError):                   # qscale [Q]
        topk.packed_candidates(qt.q, q_int, 3, qscale=q_scale[:1], wscale=qt.scale)
    with pytest.raises(ValueError):                   # top_r <= 512
        topk.packed_candidates(qt.q, q_int, 513, qscale=q_scale, wscale=qt.scale)
    with pytest.raises(TypeError):                    # int8 queries
        topk.packed_candidates(qt.q, w[:2], 3, qscale=q_scale, wscale=qt.scale)
    with pytest.raises(ValueError):                   # D % 16
        topk.masked_topk(w[:, :24].contiguous(), w[:2, :24].contiguous(), 3, exact_scan=True)
    with pytest.raises(ValueError):                   # k >= 1
        topk.masked_topk(w, w[:2], 0, exact_scan=True)
    with pytest.raises(TypeError):                    # f32 or bf16 tables
        topk.masked_topk(w.double(), w[:2].double(), 3, exact_scan=True)


def adam_case(dev, n, d, b, seed, one_row=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, d)).astype(np.float32) * 0.05
    mu = rng.standard_normal((n, d)).astype(np.float32) * 0.01
    nu = (rng.standard_normal((n, d)).astype(np.float32) * 0.01) ** 2
    ids = np.full(b, 7) if one_row else rng.zipf(1.3, b) % n
    g = rng.standard_normal((b, d)).astype(np.float32) * 0.1
    return [torch.from_numpy(x).to(dev) for x in (w, mu, nu, ids.astype(np.int32), g)]


def assert_update_close(got, want, dtype):
    """Hot-row bound (rows hit once are held bit-equal by the callers): 1e-5
    of the tensor's largest entry, the f32 sum-order error; a bf16 moment one
    bf16 ulp on top, since two different f32 values may round to
    neighbouring bf16 values, and where mu' = b1 mu + (1 - b1) g nearly
    cancels, the f32 error alone can exceed an ulp of the tiny result (as
    chip_smoke.py's _hot_row_tol)."""
    for name, a, b in zip(("w", "mu", "nu"), got[:3], want[:3]):
        a, b = a.float(), b.float()
        tol = 1e-5 * float(b.abs().max())
        if dtype == torch.bfloat16 and name != "w":
            tol = tol + torch.ldexp(torch.ones_like(b), torch.frexp(b).exponent - 8)
        assert bool(((a - b).abs() <= tol).all()), name
    assert abs(float(got[3]) - float(want[3])) <= 1e-5 * float(want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(5000, 128, 2000, False), (1000, 32, 777, False),
                                   (1001, 16, 500, True)],
                         ids=["skewed", "ragged", "one_row"])
def test_fused_adam_kernel_matches_plain(cuda, dtype, shape):
    n, d, b, one_row = shape
    w, mu, nu, ids, g = adam_case(cuda, n, d, b, seed=n, one_row=one_row)
    mu, nu = mu.to(dtype), nu.to(dtype)
    plain = [x.clone() for x in (w, mu, nu)]
    before = _kernels.launches["fused_adam"]
    got = fused_adam.sparse_adam_update(w, mu, nu, ids, g, 3, 1e-3, l2=1e-4)
    assert _kernels.launches["fused_adam"] == before + 1
    order = torch.argsort(ids, stable=True)
    scal = fused_adam.adam_scalars(3, 1e-3, 1e-4, 0.9, 0.999, 1e-7)
    want = fused_adam._sparse_adam_update_plain(*plain, ids[order], g[order], scal, 3,
                                                dtype == torch.bfloat16)
    torch.cuda.synchronize()
    assert got[0] is w and got[1] is mu  # in place
    assert_update_close(got, want, dtype)
    if not one_row:
        # Rows hit once have no order to differ in: equal bit for bit.
        once = torch.bincount(ids.long(), minlength=n) <= 1
        for a, c in zip(got[:3], want[:3]):
            assert torch.equal(a[once], c[once])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(5000, 128, 2000), (1001, 32, 777)], ids=["skewed", "ragged"])
def test_fused_adam_dense_kernel_matches_plain_and_order_changes_nothing(cuda, dtype, shape):
    """K1's dense branch at a table of a row count not a multiple of 32, ids
    past the table (the routed receipts' drop marker n) among the batch."""
    n, d, b = shape
    w, mu, nu, ids, g = adam_case(cuda, n, d, b, seed=n + 1)
    ids[::7] = n
    mu, nu = mu.to(dtype), nu.to(dtype)
    dense = torch.randn(n, d, generator=torch.Generator().manual_seed(n)).mul_(0.1).to(cuda)
    plain = [x.clone() for x in (w, mu, nu)]
    no_order = [x.clone() for x in (w, mu, nu)]
    order = torch.argsort(ids, stable=True)
    before = dict(_kernels.launches)
    got = fused_adam.sparse_adam_update(w, mu, nu, ids, g, 3, 1e-3, l2=1e-4, dense_grad=dense,
                                        order=order)
    alone = fused_adam.sparse_adam_update(*no_order, ids, g, 3, 1e-3, l2=1e-4, dense_grad=dense)
    assert _kernels.launches["fused_adam_dense"] == before.get("fused_adam_dense", 0) + 2
    assert _kernels.launches["fused_adam"] == before.get("fused_adam", 0)
    scal = fused_adam.adam_scalars(3, 1e-3, 1e-4, 0.9, 0.999, 1e-7)
    want = fused_adam._sparse_adam_update_plain(*plain, ids[order], g[order], scal, 3,
                                                dtype == torch.bfloat16, dense)
    torch.cuda.synchronize()
    for a, c in zip(got, alone):
        assert torch.equal(a, c)
    assert_update_close(got, want, dtype)
    once = torch.bincount(ids.long(), minlength=n + 1)[:n] <= 1
    for a, c in zip(got[:3], want[:3]):
        assert torch.equal(a[once], c[once])


@pytest.mark.cuda
def test_fused_adam_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    w, mu, nu, ids, g = adam_case(cuda, 64, 6, 8, seed=1)
    with pytest.raises(ValueError):   # D % 4
        fused_adam.sparse_adam_update(w, mu, nu, ids, g, 1, 1e-3)
    w, mu, nu, ids, g = adam_case(cuda, 64, 8, 8, seed=1)
    with pytest.raises(ValueError):   # not contiguous
        fused_adam.sparse_adam_update(w.t().contiguous().t(), mu, nu, ids, g, 1, 1e-3)
    with pytest.raises(ValueError):   # another device
        fused_adam.sparse_adam_update(w, mu.cpu(), nu, ids, g, 1, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_fused_train_step_on_the_card_matches_the_cpu(cuda, moments):
    from anime_recommendations_tpu_torch.train import trainer as tr
    from anime_recommendations_tpu_torch.train.fused import fused_train_step

    states = []
    for dev in ("cpu", cuda):
        state = tr.init_train_state(3000, 500, 128, generator=torch.Generator().manual_seed(0),
                                    device=dev)
        if moments == "bf16":
            state = tr.cast_table_moments(state, torch.bfloat16)
        states.append(state)
    rng = np.random.default_rng(2)
    for step in range(3):
        cols = (rng.zipf(1.3, 1024) % 3000, rng.zipf(1.3, 1024) % 500,
                rng.uniform(0, 1, 1024))
        batch = [torch.from_numpy(np.asarray(c, dt)) for c, dt in
                 zip(cols, (np.int32, np.int32, np.float32))] + [torch.ones(1024)]
        before = _kernels.launches["fused_adam"]
        out = [fused_train_step(s, *(x.to(s.model.user_emb.device) for x in batch), 1e-3, 1e-4)
               for s in states]
        assert _kernels.launches["fused_adam"] == before + 2
        assert abs(float(out[0][1]) - float(out[1][1])) < 1e-5
    # The two devices' autograd round differently, so a stochastic rounding
    # can flip: a bf16 moment then differs by one ulp (2^-7 relative at
    # most) and a table entry by that share of an lr step, over 3 steps.
    cpu, card = (tr.train_state_to_numpy(s) for s in states)
    for k in ("user_emb", "anime_emb", "mu.user_emb", "nu.anime_emb", "dense_w"):
        scale = float(np.abs(cpu[k]).max())
        rel = 2.0 ** -7 if (moments == "bf16" and "." in k) else 1e-4
        atol = 3 * 1e-3 * 2.0 ** -6 if (moments == "bf16" and k in ("user_emb", "anime_emb")) else 0.0
        np.testing.assert_allclose(card[k], cpu[k], rtol=rel, atol=max(atol, 1e-4 * scale),
                                   err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16_sr"])
@pytest.mark.parametrize("shape", [(5000, 128, 2000, False), (1000, 32, 777, False),
                                   (1001, 16, 500, True), (20, 8, 30, False)],
                         ids=["skewed", "ragged", "one_row", "one_block"])
def test_fused_adam_gather_kernel_matches_k1_and_plain(cuda, dtype, shape):
    """Next ids with duplicates and ids below 0, past n and in the ragged
    block's padding; the table outputs against K1's on the same inputs."""
    n, d, b, one_row = shape
    w, mu, nu, ids, g = adam_case(cuda, n, d, b, seed=n + 1, one_row=one_row)
    mu, nu = mu.to(dtype), nu.to(dtype)
    rng = np.random.default_rng(n)
    nids = np.concatenate([rng.integers(0, n, 3 * b // 4), np.full(b // 8, 7),
                           [-1, n, n + 5, -(2 ** 20), 2 ** 30]]).astype(np.int32)
    nids = torch.from_numpy(rng.permutation(nids)).to(cuda)
    k1 = [x.clone() for x in (w, mu, nu)]
    plain = [x.clone() for x in (w, mu, nu)]
    before = dict(_kernels.launches)
    got = fused_adam.sparse_adam_update(w, mu, nu, ids, g, 3, 1e-3, l2=1e-4, next_ids=nids)
    assert _kernels.launches["fused_adam_gather"] == before.get("fused_adam_gather", 0) + 1
    assert _kernels.launches["fused_adam"] == before.get("fused_adam", 0)
    ref = fused_adam.sparse_adam_update(*k1, ids, g, 3, 1e-3, l2=1e-4)
    torch.cuda.synchronize()
    assert got[0] is w and len(got) == 5
    for a, c in zip(got[:4], ref):
        assert torch.equal(a, c)                        # K1's tables, bit for bit
    inside = (nids >= 0) & (nids < n)
    assert torch.equal(got[4][inside], w[nids[inside].long()])
    assert not bool(got[4][~inside].any())
    order = torch.argsort(ids, stable=True)
    scal = fused_adam.adam_scalars(3, 1e-3, 1e-4, 0.9, 0.999, 1e-7)
    want = fused_adam._sparse_adam_update_plain(*plain, ids[order], g[order], scal, 3,
                                                dtype == torch.bfloat16)
    want_rows = fused_adam._gather_rows_plain(want[0], nids)
    assert_update_close(got[:4], want, dtype)
    assert bool(((got[4] - want_rows).abs() <= 1e-5 * float(want[0].abs().max())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_kernel_gather_step_pair_on_the_card(cuda, moments):
    """fused_train_step_pipelined with kernel_gather True and False from one
    state over 3 chained steps: equal bit for bit, K5 launched twice a step."""
    from anime_recommendations_tpu_torch.train import trainer as tr
    from anime_recommendations_tpu_torch.train.fused import fused_train_step_pipelined

    states = []
    for _ in range(2):
        state = tr.init_train_state(3000, 500, 128, generator=torch.Generator().manual_seed(1),
                                    device=cuda)
        states.append(tr.cast_table_moments(state, torch.bfloat16) if moments == "bf16" else state)
    rng = np.random.default_rng(5)
    batches = [[torch.from_numpy(np.asarray(c, dt)).to(cuda) for c, dt in zip(
        (rng.zipf(1.3, 1024) % 3000, rng.zipf(1.3, 1024) % 500, rng.uniform(0, 1, 1024),
         np.ones(1024)), (np.int32, np.int32, np.float32, np.float32))] for _ in range(4)]
    rows = [(s.model.user_emb.detach()[batches[0][0]], s.model.anime_emb.detach()[batches[0][1]])
            for s in states]
    for i in range(3):
        nxt = batches[i + 1][:2]
        before = _kernels.launches["fused_adam_gather"]
        outs = [fused_train_step_pipelined(s, *r, *batches[i], *nxt, 1e-3, 1e-4,
                                           kernel_gather=kg)
                for s, r, kg in zip(states, rows, (True, False))]
        assert _kernels.launches["fused_adam_gather"] == before + 2
        assert torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][2], outs[1][2])
        rows = [o[3:] for o in outs]
        for a, c in zip(*rows):
            assert torch.equal(a, c)
    gathered, plain = (tr.train_state_to_numpy(s) for s in states)
    for k, v in plain.items():
        np.testing.assert_array_equal(gathered[k], v, err_msg=k)


# ---- K1, its dense branch and K5 on skewed ids: the tiles of sorted positions ----

def tile_layout(kind, n):
    """Batch ids (unsorted) whose sorted runs meet fused_adam.TILE's edges as
    ``kind`` says: a run exactly one tile long on a tile, runs crossing 1, 2
    and many edges (8 and 9 tiles), every id on one row (41 tiles: past
    fused_adam.LONG_PARTS, its tile sums added in chunks), no id, and ids
    outside the table (runs of them crossing edges too), among rows hit once
    or a few times."""
    t = fused_adam.TILE
    rng = np.random.default_rng(len(kind) + n)
    filler = lambda k, lo: (lo + np.arange(k) // 2).tolist()   # rows hit twice, from lo
    if kind == "empty":
        ids = []
    elif kind == "one_row":   # 41 tiles: their sums added in chunks
        ids = [7] * (40 * t + 3)
    elif kind == "one_tile_run":
        ids = filler(t, 0) + [t] * t + filler(t + 5, t + 1)
    elif kind == "crosses_one_edge":
        ids = filler(t - 11, 0) + [t] * 20 + filler(t, t + 1)
    elif kind == "crosses_two_edges":
        ids = filler(t - 3, 0) + [t] * (t + 7) + [t + 1] * (t + 1) + filler(9, t + 2)
    elif kind == "crosses_many_edges":   # 8 tiles, then 9
        ids = [1] * 5 + [3] * (7 * t + 2) + [4] * (8 * t + 20) + filler(t + 3, 5)
    else:   # "outside": runs of ids below 0 and past n crossing edges, n being the drop marker
        ids = [-1] * (t + 2) + filler(t, 0) + [n - 1] * 3 + [n] * (2 * t) + [n + 9, 2 ** 30]
    return rng.permutation(np.asarray(ids, np.int32))


TILE_KINDS = ["one_tile_run", "crosses_one_edge", "crosses_two_edges", "crosses_many_edges",
              "one_row", "empty", "outside"]


def tile_case(dev, kind, d, dtype, n=300, seed=3):
    rng = np.random.default_rng(seed + d)
    ids = tile_layout(kind, n)
    w = rng.standard_normal((n, d)).astype(np.float32) * 0.05
    mu = rng.standard_normal((n, d)).astype(np.float32) * 0.01
    nu = (rng.standard_normal((n, d)).astype(np.float32) * 0.01) ** 2
    g = rng.standard_normal((ids.shape[0], d)).astype(np.float32) * 0.1
    dense = rng.standard_normal((n, d)).astype(np.float32) * 0.1
    nxt = tile_layout(kind if kind != "empty" else "crosses_many_edges", n)[::-1].copy()
    out = [torch.from_numpy(x).to(dev) for x in (w, mu, nu, ids, g, dense, nxt)]
    out[1], out[2] = out[1].to(dtype), out[2].to(dtype)
    return out


def in_tile_order(inputs, ids, g, sr, dense=None):
    """The plain version fed the kernel's own summation order: every row bit
    for bit (fused_adam.run_sums_in_tile_order)."""
    order = torch.argsort(ids, stable=True)
    n = inputs[0].shape[0]
    sums = fused_adam.run_sums_in_tile_order(ids[order], g[order], n)
    scal = fused_adam.adam_scalars(3, 1e-3, 1e-4, 0.9, 0.999, 1e-7)
    return fused_adam._sparse_adam_update_plain(
        *[x.clone() for x in inputs], torch.arange(n, dtype=torch.int32, device=ids.device),
        sums, scal, 3, sr, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16_sr"])
@pytest.mark.parametrize("d", [4, 32, 128, 512])
@pytest.mark.parametrize("mode", ["k1", "dense", "k5"])
@pytest.mark.parametrize("kind", TILE_KINDS)
def test_fused_adam_tiles_on_the_card(cuda, kind, mode, d, dtype):
    """K1, its dense branch and K5 on runs that meet the tiles' edges: every
    row bit for bit the plain version in the kernel's tile order (rows hit
    at most once bit for bit the index_add_ one, hot rows within its
    tolerance), two calls bit-identical, order= bit-equal to none, K5's
    tables K1's and its rows w'[next_ids]; the launches counted."""
    w, mu, nu, ids, g, dense, nxt = tile_case(cuda, kind, d, dtype)
    n, b = w.shape[0], ids.shape[0]
    sr = dtype == torch.bfloat16
    dense = dense if mode == "dense" else None
    kw = dict(l2=1e-4, dense_grad=dense, next_ids=nxt if mode == "k5" else None)
    inputs = [x.clone() for x in (w, mu, nu)]
    copies = [[x.clone() for x in inputs] for _ in range(3)]
    before = dict(_kernels.launches)
    got = fused_adam.sparse_adam_update(w, mu, nu, ids, g, 3, 1e-3, **kw)
    again = fused_adam.sparse_adam_update(*copies[0], ids, g, 3, 1e-3, **kw)
    ordered = fused_adam.sparse_adam_update(*copies[1], ids, g, 3, 1e-3,
                                            order=torch.argsort(ids, stable=True), **kw)
    update = {"k1": "fused_adam", "dense": "fused_adam_dense", "k5": "fused_adam_gather"}[mode]
    want_launches = {update: 3, "fused_adam_tiles": 3, "fused_adam_copies": 3 if mode == "k5" else 0}
    assert {k: _kernels.launches[k] - before.get(k, 0) for k in want_launches} == want_launches
    torch.cuda.synchronize()
    for a, c, e in zip(got, again, ordered):
        assert torch.equal(a, c) and torch.equal(a, e)
    for a, c in zip(got[:3], in_tile_order(inputs, ids, g, sr, dense)[:3]):
        assert torch.equal(a, c)
    order = torch.argsort(ids, stable=True)
    scal = fused_adam.adam_scalars(3, 1e-3, 1e-4, 0.9, 0.999, 1e-7)
    want = fused_adam._sparse_adam_update_plain(*[x.clone() for x in inputs], ids[order],
                                                g[order], scal, 3, sr, dense)
    assert_update_close(got, want, dtype)
    once = torch.bincount(ids.long().clamp(0, n), minlength=n + 1)[:n] <= 1
    for a, c in zip(got[:3], want[:3]):
        assert torch.equal(a[once], c[once])
    if mode == "k5":
        k1 = fused_adam.sparse_adam_update(*copies[2], ids, g, 3, 1e-3, l2=1e-4)
        for a, c in zip(got[:4], k1):
            assert torch.equal(a, c)
        inside = (nxt >= 0) & (nxt < n)
        assert torch.equal(got[4][inside], w[nxt[inside].long()])
        assert not bool(got[4][~inside].any())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 128, 512])
@pytest.mark.parametrize("kind", TILE_KINDS)
def test_fused_adam_passes_match_their_plain_versions(cuda, kind, d):
    """The first pass (its written tile sums and the block starts of the ids
    and the next ids) and the gather's second pass, each alone, bit for bit
    against _tile_sums_plain, _block_starts_plain and _copies_plain."""
    w, _, _, ids, g, _, nxt = tile_case(cuda, kind, d, torch.float32)
    n = w.shape[0]
    order = torch.argsort(ids, stable=True)
    ids_s, g_s = ids[order].int(), g[order].contiguous()
    norder = torch.argsort(nxt, stable=True)
    nids_s = nxt[norder].int()
    got, starts, gstarts = fused_adam._first_pass_cuda(ids_s, g_s, n, nids_s)
    assert fused_adam._first_pass_cuda(ids_s, g_s, n)[2] is None
    want, written = fused_adam._tile_sums_plain(ids_s, g_s, n)
    if ids.shape[0] == 0:
        assert got is None and written.numel() == 0
    else:
        assert torch.equal(got[written], want[written])
    assert torch.equal(starts, fused_adam._block_starts_plain(ids_s, n))
    assert torch.equal(gstarts, fused_adam._block_starts_plain(nids_s, n))
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    assert torch.equal(fused_adam._first_pass_cuda(ids_s, g_s, n, empty)[2],
                       torch.zeros_like(starts))
    rows = torch.full((nxt.shape[0], d), 7.5, device=cuda)
    rows_plain = rows.clone()
    fused_adam._copies_cuda(w, nids_s, norder.int(), rows)
    fused_adam._copies_plain(w, nids_s, norder.int(), rows_plain)
    assert torch.equal(rows, rows_plain)
