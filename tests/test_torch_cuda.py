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
Adam (K1): the kernel applies the plain version's operations in its order, so
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
pass alone equals its plain version. IVF retrieval (torch ops, no kernel of
its own): an index built on the card holds every row once, and ivf_topk on
it equals ivf_topk on its copy on the CPU, values within 1e-5, indices
equal except where true scores tie within 1e-6. The captured epoch
(train/device_loop.py's CUDA graph): bit for bit the eager epoch wherever
two eager runs are bit-equal, else 1e-5 of each tensor's largest entry
(dense_b, its moments and moving_mean, which walk on rounding noise, not
compared then). The chunked epoch (CHUNK_STEPS lowered): bit for bit the
eager chunks and the one-chunk epoch under the same rule, its graphs
captured once; the graph the benchmark's set-up captures (train_graph) is
the one every later epoch replays. The captured sharded epoch
(parallel/trainer.py at world size 1 on NCCL, its collectives in the
graph): bit for bit the eager one
for psum adam and alltoall adam, fused_adam and fused_adam_bf16m (the fused
ones also at a capacity that takes more than 4 rounds), lazy_adam within
1e-5 of each tensor's largest entry (index_add_'s atomics). The step
graphs (train/step_graph.py): each one-device entry point and the sharded
step's train_step, eval_sums and grads at world size 1 on NCCL, 10 calls
through a cache against 10 through StepGraphs(0) from one state, bit for
bit (lazy_adam within 1e-5 of each tensor's largest entry unless two eager
runs are bit-equal), one capture and a replay per call from the second on.
Dense Adam (csrc/dense_adam.cu): bit for bit the plain chain on the card,
every element (the same correctly rounded f32 operations in its order), in
one launch for a list of tensors, eager or replayed from a CUDA graph.
"""

import numpy as np
import pytest
import torch

from anime_recommendations_tpu_torch.ops import _kernels, fused_adam, ivf, normalize, quantized, topk


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


def int8_counter(q):
    """The launch counter of the K2q branch that serves q queries."""
    return "packed_topk_int8_mma" if q >= topk.INT8_MMA_MIN_Q else "packed_topk_int8"


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
@pytest.mark.parametrize("q", [1, 2, 3, 8, 16, 21, 63, 64, 65, 130])
@pytest.mark.parametrize("d", [16, 32, 48, 128, 272])
@pytest.mark.parametrize("n", [1300, 70_000])
def test_int8_stage1_keys_match_plain(cuda, n, d, q, head):
    """Ragged last group (N = 1300: 64-query tiles up to 16 queries, then
    16-query tiles; N = 70,000: 16-query tiles up to 16 queries, then
    64-query tiles, on an H100), both branches (one query on dp4a,
    from INT8_MMA_MIN_Q on the tensor cores), queries across the 16-query
    m-tile and the 64-query block tile with partial tiles, D % 64 != 0 (the
    lanes past d zero-filled; D % 32 == 16 included) and D past the 256
    dimensions staged at once, top_r up to the whole group, mask and
    exclude; each case counted on the branch it should take."""
    w, keep, qt, q_int, q_scale = int8_inputs(cuda, n, d, q, seed=17)
    excl = torch.arange(q, device=cuda)
    h = torch.tensor([3.0, -0.5], device=cuda) if head else None
    counter = int8_counter(q)
    for top_r in (1, 4, 512):
        args = (qt.q, q_int, top_r, keep, excl, h)
        before = dict(_kernels.launches)
        got = topk.packed_candidates(*args, qscale=q_scale, wscale=qt.scale)
        assert _kernels.launches[counter] == before.get(counter, 0) + 1
        assert sum(_kernels.launches.values()) == sum(before.values()) + 1
        want = topk._packed_candidates_plain(*args, q_scale, qt.scale)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (q, -(-n // 512) * top_r)
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
    counter = int8_counter(tq.shape[0])
    before = _kernels.launches[counter]
    v, i = quantized.quantized_topk(qt, tq, 10, **kw)
    assert _kernels.launches[counter] == before + 1
    cpu = {key: t.cpu() for key, t in kw.items()}
    pv, pi = quantized.quantized_topk(quantized.QuantizedTable(*(t.cpu() for t in qt)), tq.cpu(),
                                      10, **cpu)
    np.testing.assert_allclose(v.cpu().numpy(), pv.numpy(), atol=1e-5, rtol=0)
    gap = (row_scores(w, tq, i, kw.get("head")).cpu()
           - row_scores(w.cpu(), tq.cpu(), pi, cpu.get("head"))).abs()
    assert not bool(((i.cpu() != pi) & (gap > 1e-6)).any())


@pytest.mark.cuda
def test_int8_query_tile_follows_the_threshold(cuda):
    """The tiling rule the library exports (chip_smoke.py counts table reads
    by it): one query below ops/topk.INT8_MMA_MIN_Q; then up to 16 queries
    16-query tiles where the table has more groups than the card has SMs,
    and past 16 queries 16-query tiles where 64-query ones would leave SMs
    idle; 64-query tiles otherwise."""
    lib = _kernels.library("packed_topk_int8")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n in (1300, 17_560, 70_000, 91_641):
        groups = -(-n // 512)
        for q in range(1, 300):
            short_grid = groups * -(-q // 64) <= sms
            want = (1 if q < topk.INT8_MMA_MIN_Q else 16 if (q <= 16) != short_grid else 64)
            assert lib.packed_topk_int8_query_tile(n, q) == want, (n, q)


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


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_ivf_topk_on_the_card_matches_the_cpu(cuda, feature, storage):
    w, keep = inputs(cuda)
    index = ivf.build_ivf(w, n_clusters=64, iters=4, seed=3, storage=storage)
    rows = torch.cat([index.buckets.ravel(), index.spill])
    rows = rows[rows >= 0]
    assert rows.numel() == w.shape[0] == torch.unique(rows).numel()
    cpu_index = ivf.IVFIndex(*(None if t is None else t.cpu() for t in index))
    tq = w[[1, 2, 3, 4000, 4999]]
    kw = FEATURES[feature](cuda, keep)
    cpu = {key: t.cpu() for key, t in kw.items()}
    for probes in (8, 64):
        v, i = ivf.ivf_topk(index, tq, 10, probes=probes, **kw)
        pv, pi = ivf.ivf_topk(cpu_index, tq.cpu(), 10, probes=probes, **cpu)
        np.testing.assert_allclose(v.cpu().numpy(), pv.numpy(), atol=1e-5, rtol=0)
        gap = (row_scores(w, tq, i.clamp_min(0), kw.get("head")).cpu()
               - row_scores(w.cpu(), tq.cpu(), pi.clamp_min(0), cpu.get("head"))).abs()
        assert not bool(((i.cpu() != pi) & (gap > 1e-6)).any())


# ---- sharded training (psum) and take_rows: torch ops, no kernel of their own ---

@pytest.fixture
def nccl_world(cuda):
    """An NCCL process group of world size 1 on a free local port."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        yield
    finally:
        from anime_recommendations_tpu_torch.train import step_graph

        step_graph.release_graphs()   # the graphs that captured the group's collectives
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("shard_anime", [False, True], ids=["replicated", "shard_anime"])
def test_psum_step_at_world_size_1_matches_the_one_device_step(cuda, nccl_world, shard_anime):
    """Three ShardedTrainStep steps with routing="psum" against three
    one-device train_steps from one state on the card: loss and mse 1e-5
    relative, tables and moments 1e-5 of their largest entry (the same
    math; the lookup's masked gather and the analytic L2 term reorder f32
    sums)."""
    from anime_recommendations_tpu_torch.parallel.mesh import make_world
    from anime_recommendations_tpu_torch.parallel.sharded_train import (
        ShardedTrainStep,
        place_state,
        unstripe_state,
    )
    from anime_recommendations_tpu_torch.train import trainer as tr

    arrays = tr.train_state_to_numpy(tr.init_train_state(
        3000, 700, 64, generator=torch.Generator().manual_seed(2), device="cpu"))
    world = make_world(1, 1, cuda)
    sharded = place_state(tr.train_state_from_numpy(arrays, "cpu"), world, "psum", shard_anime)
    ref = tr.train_state_from_numpy(arrays, cuda)
    step = ShardedTrainStep(world, l2_reg_factor=1e-4, shard_anime=shard_anime, routing="psum")
    rng = np.random.default_rng(4)
    for _ in range(3):
        cols = [torch.from_numpy(x).to(cuda) for x in (
            rng.integers(0, 3000, 4096).astype(np.int32),
            rng.integers(0, 700, 4096).astype(np.int32),
            rng.uniform(0, 1, 4096).astype(np.float32), np.ones(4096, np.float32))]
        sharded, loss, mse = step.train_step(sharded, *cols, 1e-3)
        ref, loss_r, mse_r = tr.train_step(ref, *cols, 1e-3, 1e-4)
        assert float(loss) == pytest.approx(float(loss_r), rel=1e-5)
        assert float(mse) == pytest.approx(float(mse_r), rel=1e-5)
    got = tr.train_state_to_numpy(unstripe_state(sharded, world, "psum", shard_anime))
    want = tr.train_state_to_numpy(ref)
    for k in ("user_emb", "anime_emb", "mu.user_emb", "mu.anime_emb", "nu.user_emb",
              "nu.anime_emb"):
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * scale, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [91_641, 17_560, 7])
def test_take_rows_gradient_on_the_card(cuda, n):
    """take_rows's backward on the card (autograd's sorted index backward):
    equal to itself on a second call (no atomics), and within 1e-6 of the
    largest entry of the CPU's index_add_ (the same f32 terms, summed in
    batch order)."""
    from anime_recommendations_tpu_torch.models import two_tower as tt

    gen = torch.Generator().manual_seed(n)
    ids = torch.randint(0, n, (10_000,), generator=gen, dtype=torch.int32)
    g = torch.randn((10_000, 128), generator=gen)
    table = torch.zeros((n, 128), device=cuda, requires_grad=True)

    def grad():
        return torch.autograd.grad((tt.take_rows(table, ids.to(cuda)) * g.to(cuda)).sum(),
                                   table)[0]

    got = grad()
    assert torch.equal(grad(), got)
    want = torch.zeros((n, 128)).index_add_(0, ids.long(), g)
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6 * scale)


@pytest.mark.cuda
def test_bench_suite_on_the_card(cuda):
    """The benchmark suite (cli bench's module) at small sizes on the card:
    the exact retrieval overlaps read 1.0, and every kernel on its path
    launched: K1, both K2 branches, both K2q branches, K3 and K4."""
    from anime_recommendations_tpu_torch import bench

    sizes = bench.BenchSizes(
        n_users=3000, n_anime=1500, d=32, batch=1024, steps=2, epoch_rows=8192,
        n_users_full=5000, full_rows=4096, routed_steps=3, routed_batches=3, query_batches=4,
        oracle_rows=4000, ivf_rows=20_000, ivf_clusters=64, trained_users=3000,
        trained_users_full=5000, trained_rows=50_000, trained_epochs=2, serve_users=300,
        serve_anime=120, serve_interactions=30_000, serve_d=32)
    details = bench.main(sizes, "cuda")["details"]
    assert details["backend"] == "cuda" and details["device"] != "cpu"
    for key in ("topk_overlap_vs_oracle", "topk_q256_overlap_vs_oracle",
                "score_topk_overlap_vs_oracle"):
        assert details[key] == 1.0, key
    launched = {name: _kernels.launches[name] for name in (
        "fused_adam", "packed_topk", "packed_topk_mma", "packed_topk_int8",
        "packed_topk_int8_mma", "exact_topk", "l2_normalize")}
    assert min(launched.values()) > 0, launched


def _graph_epoch_runs(cuda, optimizer, epoch_fn):
    """Two epochs (lr 1e-3, then 5e-4) of ``epoch_fn`` from one state and one
    shuffle: (final state, [(losses, mses, wsums)] per epoch)."""
    from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train import trainer as tr

    rng = np.random.default_rng(0)
    rows = 20_000
    ds = RatingsDataset(rng.integers(0, 3000, rows).astype(np.int32),
                        np.minimum(rng.pareto(1.1, rows) * 20, 499).astype(np.int32),
                        rng.uniform(0, 1, rows).astype(np.float32))
    data = dl.stage(ds, 1024, seed=0, device=cuda)
    state = tr.init_train_state(3000, 500, 32, generator=torch.Generator().manual_seed(0),
                                device=cuda)
    if optimizer == "fused_adam_bf16m":
        state = tr.cast_table_moments(state, torch.bfloat16)
    outs = []
    for epoch, lr in enumerate((1e-3, 5e-4)):
        state, *out = epoch_fn(state, data, torch.Generator().manual_seed(epoch), lr, 1024, 1e-4,
                               optimizer=optimizer)
        outs.append(out)
    return state, outs, data


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam", "fused_adam", "fused_adam_bf16m"])
def test_captured_epoch_matches_the_eager_epoch(cuda, optimizer):
    """train_epoch's CUDA graph against eager_train_epoch over two epochs
    from one state: every state tensor, loss and mse bit for bit wherever two
    eager runs are bit-equal to each other (every optimizer but lazy_adam,
    whose index_add_ sums in atomics' order), else within 1e-5 of each
    tensor's largest entry; the launches counted per replay equal the eager
    loop's; the holdout evaluation's graph equals the eager evaluation."""
    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train import trainer as tr

    names = ("fused_adam_tiles", "fused_adam", "fused_adam_gather")
    runs = {}
    for label, fn in (("captured", dl.train_epoch), ("eager", dl.eager_train_epoch),
                      ("again", dl.eager_train_epoch)):
        _kernels.launches.clear()
        state, outs, data = _graph_epoch_runs(cuda, optimizer, fn)
        torch.cuda.synchronize()
        runs[label] = (tr.train_state_to_numpy(state), outs,
                       {k: _kernels.launches[k] for k in names}, state)
    steps = data.n // 1024
    want = 4 * steps if optimizer in ("fused_adam", "fused_adam_bf16m") else 0
    for label in runs:
        assert runs[label][2] == {"fused_adam_tiles": want, "fused_adam": want,
                                  "fused_adam_gather": 0}, label
    # dense_b's gradient is rounding noise (BatchNorm cancels the bias), so
    # Adam walks it by up to lr a step and moving_mean follows: like
    # tests/test_torch_train.py, no bound there unless the runs are bit-equal.
    noise = ("dense_b", "mu.dense_b", "nu.dense_b", "moving_mean")
    tensors = lambda r, skip=(): [*(v for k, v in r[0].items() if k not in skip),
                                  *(t.cpu().numpy() for o in r[1] for t in o)]
    eager_equal = all(np.array_equal(a, b) for a, b in
                      zip(tensors(runs["eager"]), tensors(runs["again"])))
    if optimizer != "lazy_adam":
        assert eager_equal
    if eager_equal:
        for a, b in zip(tensors(runs["captured"]), tensors(runs["eager"])):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tensors(runs["captured"], noise), tensors(runs["eager"], noise)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1e-30))
    model = runs["captured"][3].model
    holdout = dl.DeviceData(*(x[:4096] for x in data))
    got = dl.eval_epoch(model, model.bn_state(), holdout, 1024, 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(
        got, dl.eager_eval_epoch(model, model.bn_state(), holdout, 1024, 1e-4)))


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam", "fused_adam"])
def test_chunked_epoch_replays_match_the_eager_chunks(cuda, optimizer, monkeypatch):
    """With CHUNK_STEPS = 6, _graph_epoch_runs' 20-step epochs run as three
    chunks and a tail of 2: their graphs are captured once, at the first
    epoch (two graphs; none at the second; four replays an epoch), and the
    two epochs equal the eager chunks and the one-chunk epoch (CHUNK_STEPS
    as set), bit for bit wherever two eager runs are bit-equal, else
    (lazy_adam's index_add_) within 1e-5 of each tensor's largest entry. A
    holdout of 5 batches in chunks of 2 (sums carried between replays)
    equals its eager chunks and its one-chunk evaluation bit for bit."""
    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train import trainer as tr

    dl.release_graphs()
    whole = _graph_epoch_runs(cuda, optimizer, dl.train_epoch)
    monkeypatch.setattr(dl, "CHUNK_STEPS", 6)
    before = dl.graph_report()
    runs = {"captured": _graph_epoch_runs(cuda, optimizer, dl.train_epoch)}
    after = dl.graph_report()
    assert dl.chunks(runs["captured"][2].n // 1024) == [(0, 6), (6, 6), (12, 6), (18, 2)]
    assert (after["captured"] - before["captured"], after["replays"] - before["replays"]) == (2, 8)
    runs["eager"] = _graph_epoch_runs(cuda, optimizer, dl.eager_train_epoch)
    runs["again"] = _graph_epoch_runs(cuda, optimizer, dl.eager_train_epoch)
    torch.cuda.synchronize()
    runs["whole"] = whole
    noise = ("dense_b", "mu.dense_b", "nu.dense_b", "moving_mean")
    tensors = lambda r, skip=(): [*(v for k, v in tr.train_state_to_numpy(r[0]).items()
                                    if k not in skip),
                                  *(t.cpu().numpy() for o in r[1] for t in o)]
    eager_equal = all(np.array_equal(a, b) for a, b in
                      zip(tensors(runs["eager"]), tensors(runs["again"])))
    if optimizer != "lazy_adam":
        assert eager_equal
    for label in ("captured", "whole"):
        if eager_equal:
            for a, b in zip(tensors(runs[label]), tensors(runs["eager"])):
                np.testing.assert_array_equal(a, b, err_msg=label)
        for a, b in zip(tensors(runs[label], noise), tensors(runs["eager"], noise)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1e-30),
                                       err_msg=label)
    model, data = runs["captured"][0].model, runs["captured"][2]
    holdout = dl.DeviceData(*(x[:5 * 1024] for x in data))
    evaluate = lambda fn: fn(model, model.bn_state(), holdout, 1024, 1e-4)
    want = evaluate(dl.eager_eval_epoch)
    monkeypatch.setattr(dl, "CHUNK_STEPS", 2)
    for got in (evaluate(dl.eval_epoch), evaluate(dl.eager_eval_epoch)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam", "fused_adam"])
def test_set_ups_train_graph_is_the_graph_every_epoch_replays(cuda, optimizer):
    """train_graph called as the benchmark's set-up calls it (before the
    state's first step) captures the epoch's one graph; the first
    Trainer._device_epoch adds only the holdout's graph, and two more
    capture nothing: each replays train_graph's graph and the holdout's
    once."""
    from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(2)
    n_users, n_anime, n = 500, 200, 12_000
    cols = (rng.integers(0, n_users, n).astype(np.int32),
            rng.integers(0, n_anime, n).astype(np.int32), rng.uniform(size=n).astype(np.float32))
    trainer = Trainer(embedding_size=16, batch_size=1024, device_loop=True, optimizer=optimizer,
                      verbose=False, seed=3, device=cuda)
    state = trainer._init_state(torch.Generator().manual_seed(3), n_users, n_anime)
    staged = trainer._stage_device(RatingsDataset(*(c[:10_000] for c in cols)),
                                   RatingsDataset(*(c[10_000:] for c in cols)))
    dl.release_graphs()
    before = dl.graph_report()
    graph = dl.train_graph(state, staged[0], staged[2], trainer.l2_reg_factor,
                           trainer.shuffle_each_epoch, trainer.sorted_scatter, trainer.optimizer)
    assert dl.graph_report()["captured"] == before["captured"] + 1
    state, *_ = trainer._device_epoch(staged, state, 0, 1e-3)
    captured = dl.graph_report()["captured"]
    assert captured == before["captured"] + 2
    for epoch in (1, 2):
        state, loss_sum, *_ = trainer._device_epoch(staged, state, epoch, 1e-3)
    after = dl.graph_report()
    assert after["captured"] == captured and np.isfinite(loss_sum)
    assert after["replays"] - before["replays"] == 6 and graph.replays == 3
    assert dl.train_graph(state, staged[0], staged[2], trainer.l2_reg_factor,
                          trainer.shuffle_each_epoch, trainer.sorted_scatter,
                          trainer.optimizer) is graph
    dl.release_graphs()


@pytest.mark.cuda
def test_a_capture_that_syncs_raises(cuda):
    """No fallback: a body that reads a value on the host fails the capture."""
    from anime_recommendations_tpu_torch.utils.graphs import CapturedGraph

    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        CapturedGraph(lambda: (x * 2).sum().item(), lambda: None, {}, cuda)


# ---- the captured sharded epoch (parallel/trainer.py) --------------------------------

SHARDED_CASES = [("adam", None, "alltoall"), ("lazy_adam", None, "alltoall"),
                 ("fused_adam", None, "alltoall"), ("fused_adam_bf16m", None, "alltoall"),
                 ("fused_adam", 32, "alltoall"), ("fused_adam_bf16m", 32, "alltoall"),
                 ("adam", None, "psum")]


def _sharded_epoch_runs(cuda, optimizer, capacity, routing, captured):
    """Two epochs (lr 1e-3, then 5e-4, each with its granule permutation)
    and an evaluation of a ShardedTrainer at world size 1, through the
    graphs (``captured``) or the eager loops: (state arrays, [losses, mses,
    wsums per epoch, (val_loss, val_mse)], K1's launches, graph replays)."""
    from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
    from anime_recommendations_tpu_torch.parallel.trainer import ShardedTrainer
    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train import trainer as tr

    rng = np.random.default_rng(0)
    rows = 20_000
    ds = RatingsDataset(rng.integers(0, 3000, rows).astype(np.int32),
                        np.minimum(rng.pareto(1.1, rows) * 20, 499).astype(np.int32),
                        rng.uniform(0, 1, rows).astype(np.float32))
    data = dl.stage(ds, 1024, seed=0, device=cuda)
    holdout = dl.DeviceData(*(x[:4096] for x in data))
    trainer = ShardedTrainer(batch_size=1024, embedding_size=32, optimizer=optimizer,
                             capacity=capacity, routing=routing, verbose=False, device=cuda,
                             device_loop=True)
    state = trainer._init_state(torch.Generator().manual_seed(0), 3000, 500)
    epoch = trainer.train_epoch if captured else trainer.eager_train_epoch
    evaluate = trainer.eval_epoch if captured else trainer.eager_eval_epoch
    _kernels.launches.clear()
    dl.release_graphs()
    outs = []
    for i, lr in enumerate((1e-3, 5e-4)):
        perm = dl.granule_permutation(data.n, torch.Generator().manual_seed(i))
        state, *out = epoch(state, data, 1024, lr, perm)
        outs += out
    outs += evaluate(state.model, holdout, 1024)
    torch.cuda.synchronize()
    replays = {}
    for k, g in dl._GRAPHS.items():
        replays[k[0]] = replays.get(k[0], 0) + g.replays
    dl.release_graphs()
    names = ("fused_adam_tiles", "fused_adam", "fused_adam_dense")
    return (tr.train_state_to_numpy(state), [o.cpu().numpy() for o in outs],
            {k: _kernels.launches[k] for k in names}, replays, data.n // 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer,capacity,routing", SHARDED_CASES)
def test_captured_sharded_epoch_matches_the_eager_epoch(cuda, nccl_world, optimizer, capacity,
                                                        routing):
    """The sharded trainer's epochs and evaluation through their CUDA graphs
    (NCCL collectives captured) against its eager loops: every state tensor,
    loss, mse and the validation pair bit for bit (lazy_adam within 1e-5 of
    each tensor's largest entry, but for dense_b, its moments and
    moving_mean); one replay of the epoch's graph per epoch; K1's launches
    per replay add up to the eager loop's (the batches' graph and the
    evaluation's are replayed once per epoch and per evaluation too)."""
    got, got_out, got_launches, replays, steps = _sharded_epoch_runs(
        cuda, optimizer, capacity, routing, True)
    want, want_out, want_launches, eager_replays, _ = _sharded_epoch_runs(
        cuda, optimizer, capacity, routing, False)
    assert replays == {"sharded_prep": 2, "sharded_epoch": 2, "sharded_eval": 1}, replays
    assert not eager_replays
    assert got_launches == want_launches
    fused = optimizer.startswith("fused")
    k1 = "fused_adam" if capacity is None else "fused_adam_dense"
    assert got_launches[k1] == (4 * steps if fused else 0), got_launches
    noise = ("dense_b", "mu.dense_b", "nu.dense_b", "moving_mean")
    for k in want:
        if optimizer != "lazy_adam":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif k not in noise:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-5 * max(np.abs(want[k]).max(), 1e-30), err_msg=k)
    for a, b in zip(got_out, want_out):
        if optimizer != "lazy_adam":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1e-30))


# ---- one retrieval request as one graph replay (ops/scan_graph.py) -----------------

SCAN_FLAVOURS = ("f32", "bf16", "int8", "exact", "ivf_f32", "ivf_int8")
# The launch counters of a flavour's scan kernel at q queries (IVF's probe
# path is torch ops: none).
SCAN_COUNTERS = {"f32": k2_counter, "bf16": k2_counter, "int8": int8_counter,
                 "exact": lambda q: "exact_topk", "ivf_f32": lambda q: None,
                 "ivf_int8": lambda q: None}


def scan_flavour(dev, flavour):
    """(table, _dispatch_topk keywords, mask) of a flavour over inputs(dev)'s rows."""
    w, keep = inputs(dev)
    if flavour.startswith("ivf"):
        return ivf.build_ivf(w, n_clusters=64, iters=4, seed=3,
                             storage=flavour.split("_")[1]), {"probes": 8}, keep
    st = topk.shuffle_rows(w.to(torch.bfloat16) if flavour == "bf16" else w, seed=5)
    if flavour == "int8":
        return st._replace(table=quantized.quantize_rows(st.table)), {}, keep
    return st, {"exact_scan": True} if flavour == "exact" else {}, keep


def scan_request(dev, flavour, q, side, k=10):
    """A request's arguments for _dispatch_topk: (table, queries, mask,
    exclude, head, keywords); ``side`` "none" or "all" (mask, exclude, head)."""
    table, kw, keep = scan_flavour(dev, flavour)
    w, _ = inputs(dev)
    rows = torch.arange(q, device=dev) * 37 % w.shape[0]
    queries = w[rows].to(torch.bfloat16) if flavour == "bf16" else w[rows]
    if side == "none":
        return table, queries, None, None, None, dict(kw, k=k)
    return (table, queries, keep.cpu().numpy(), rows.cpu().numpy(),
            torch.tensor([3.0, -0.5], device=dev), dict(kw, k=k))


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["none", "all"])
@pytest.mark.parametrize("q", [1, 2, 64])
@pytest.mark.parametrize("flavour", SCAN_FLAVOURS)
def test_scan_graph_replay_is_bit_equal_to_the_eager_body(cuda, flavour, q, side):
    """Per flavour, on both sides of each kernel's query threshold: the
    eager body (EAGER), then a cache's first call (eager), its capture and
    two replays; every result bit for bit the eager one, one replay per
    request after the capture, the scan kernel once per replay."""
    from anime_recommendations_tpu_torch.ops import scan_graph

    table, queries, mask, exclude, head, kw = scan_request(cuda, flavour, q, side)
    want = topk._dispatch_topk(table, queries, mask, exclude, head, graphs=scan_graph.EAGER,
                               **kw)
    graphs = scan_graph.ScanGraphs()
    counter = SCAN_COUNTERS[flavour](q)
    for call in range(4):
        before = _kernels.launches[counter] if counter else 0
        got = topk._dispatch_topk(table, queries, mask, exclude, head, graphs=graphs, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), call
        if counter:
            assert _kernels.launches[counter] == before + 1, (call, counter)
        assert (graphs.misses, graphs.captures, graphs.hits) == \
            ((1, 0, 0), (2, 1, 0), (2, 1, 1), (2, 1, 2))[call]
    (graph,) = graphs._graphs.values()
    assert graph.replays == 3
    assert graph.launches == ({counter: 1} if counter else {})
    graphs.release()


@pytest.mark.cuda
def test_scan_graph_concurrent_requests_during_capture_match_eager(cuda):
    """8 threads send mixed requests (flavours, query counts, sides) to one
    fresh cache, so their first captures happen while other threads scan
    and read results: every answer equals the eager body's."""
    import threading

    from anime_recommendations_tpu_torch.ops import scan_graph

    cases = [(f, q, s) for f in ("f32", "int8", "exact", "ivf_f32") for q in (1, 2, 64)
             for s in ("none", "all")]
    requests = [scan_request(cuda, *case) for case in cases]
    want = [topk._dispatch_topk(*r[:5], graphs=scan_graph.EAGER, **r[5]) for r in requests]
    want = [(v.cpu(), i.cpu()) for v, i in want]
    graphs = scan_graph.ScanGraphs()
    errors = []

    def worker(t):
        try:
            for j in range(3 * len(requests)):
                i = (7 * t + j) % len(requests)
                r = requests[i]
                v, idx = topk._dispatch_topk(*r[:5], graphs=graphs, **r[5])
                if not (torch.equal(v.cpu(), want[i][0]) and torch.equal(idx.cpu(), want[i][1])):
                    errors.append((t, cases[i]))
        except Exception as e:  # reported below, with the thread that raised it
            errors.append((t, repr(e)))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:5]
    assert graphs.captures == len(cases) == len(graphs)
    graphs.release()


# ---- each step as one graph replay (train/step_graph.py) ---------------------------

STEP_ENTRIES = ("train_cosine", "train_dot", "eval", "fused_f32", "fused_bf16", "pipelined",
                "pipelined_kernel_gather", "lazy")
STEP_CALLS = 10
STEP_NAMES = ("fused_adam_tiles", "fused_adam", "fused_adam_gather", "fused_adam_copies",
              "fused_adam_dense")


def _step_batches(rows=1024, calls=STEP_CALLS + 1, seed=0):
    """Numpy batches: uniform users of 3000, skewed anime of 500 (duplicate
    ids), a quarter of the second batch's rows at weight 0."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(calls):
        w = np.ones(rows, np.float32)
        if i == 1:
            w[-rows // 4:] = 0.0
        out.append((rng.integers(0, 3000, rows).astype(np.int32),
                    np.minimum(rng.pareto(1.1, rows) * 20, 499).astype(np.int32),
                    rng.uniform(0, 1, rows).astype(np.float32), w))
    return out


def _entry_runs(cuda, entry, graphs, monkeypatch):
    """STEP_CALLS calls of a one-device entry point from one state through
    ``graphs``, lr changing every call, the batch as numpy (device tensors
    every third call): (outputs, state arrays, launches)."""
    from anime_recommendations_tpu_torch.train import step_graph
    from anime_recommendations_tpu_torch.train import trainer as tr
    from anime_recommendations_tpu_torch.train.fused import (
        fused_train_step,
        fused_train_step_pipelined,
    )
    from anime_recommendations_tpu_torch.train.lazy import lazy_train_step

    monkeypatch.setattr(step_graph, "graphs_for", lambda device: graphs)
    state = tr.init_train_state(3000, 500, 32, generator=torch.Generator().manual_seed(0),
                                device=cuda)
    if entry == "fused_bf16":
        state = tr.cast_table_moments(state, torch.bfloat16)
    data = _step_batches()
    rows = tuple(t.detach()[torch.from_numpy(ids).to(cuda)]
                 for t, ids in ((state.model.user_emb, data[0][0]),
                                (state.model.anime_emb, data[0][1])))
    _kernels.launches.clear()
    outs = []
    for i in range(STEP_CALLS):
        lr = 1e-3 * (1 + i % 3) / 2
        cols = data[i] if i % 3 else tuple(torch.from_numpy(c).to(cuda) for c in data[i])
        if entry == "eval":
            out = tr.eval_step(state.model, state.model.bn_state(), *cols, 1e-4)
        elif entry.startswith("train"):
            state, *out = tr.train_step(state, *cols, lr, 1e-4, merge=entry[6:])
        elif entry.startswith("fused"):
            state, *out = fused_train_step(state, *cols, lr, 1e-4)
        elif entry == "lazy":
            state, *out = lazy_train_step(state, *cols, lr, 1e-4)
        else:
            state, *out = fused_train_step_pipelined(
                state, *rows, *cols, *data[i + 1][:2], lr, 1e-4,
                kernel_gather=entry == "pipelined_kernel_gather")
            rows = tuple(out[2:])
        outs.append([t.cpu().numpy() for t in out])
    torch.cuda.synchronize()
    return outs, tr.train_state_to_numpy(state), {k: _kernels.launches[k] for k in STEP_NAMES}


def _assert_runs_equal(got, want, again, lazy):
    """got bit-equal to want where two eager runs (want, again) are, else
    (lazy_adam's atomics) within 1e-5 of each tensor's largest entry but
    for dense_b's noise walk, the head scalars (one value each: dense_w,
    bn_gamma, bn_beta) within 1e-5 of the largest of them, and so their
    moments: bn_beta's value is a sum of steps of either sign, so its own
    scale is no measure of its error."""
    flat = lambda r: [*(v for o in r[0] for v in o), *r[1].values()]
    eager_equal = all(np.array_equal(a, b) for a, b in zip(flat(want), flat(again)))
    if not lazy:
        assert eager_equal
    if eager_equal:
        for a, b in zip(flat(got), flat(want)):
            np.testing.assert_array_equal(a, b)
        return
    noise = ("dense_b", "mu.dense_b", "nu.dense_b", "moving_mean")
    head = {f"{m}{k}": tuple(f"{m}{h}" for h in ("dense_w", "bn_gamma", "bn_beta"))
            for m in ("", "mu.", "nu.") for k in ("dense_w", "bn_gamma", "bn_beta")}
    for k in want[1]:
        if k not in noise:
            scale = max(np.abs(want[1][j]).max() for j in head.get(k, (k,)))
            np.testing.assert_allclose(got[1][k], want[1][k], rtol=0,
                                       atol=1e-5 * max(scale, 1e-30), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", STEP_ENTRIES)
def test_step_graph_replays_match_the_eager_steps(cuda, entry, monkeypatch):
    """Each one-device entry point through a step-graph cache against
    StepGraphs(0) (the eager body) over STEP_CALLS calls from one state:
    every output and state tensor bit for bit (lazy_adam: _assert_runs_equal),
    K1's and K5's launches counted per replay equal the eager calls', one
    capture at the second call and a replay per call from it on."""
    from anime_recommendations_tpu_torch.train import step_graph

    graphs = step_graph.StepGraphs()
    got = _entry_runs(cuda, entry, graphs, monkeypatch)
    want = _entry_runs(cuda, entry, step_graph.EAGER, monkeypatch)
    again = _entry_runs(cuda, entry, step_graph.EAGER, monkeypatch)
    assert (graphs.captures, graphs.misses, graphs.hits) == (1, 2, STEP_CALLS - 2)
    (graph,) = graphs._graphs.values()
    assert graph.replays == STEP_CALLS - 1
    assert got[2] == want[2], (got[2], want[2])
    fused = entry.startswith(("fused", "pipelined"))
    k5 = entry == "pipelined_kernel_gather"
    assert got[2]["fused_adam_tiles"] == (2 * STEP_CALLS if fused else 0)
    assert got[2]["fused_adam_gather" if k5 else "fused_adam"] == (2 * STEP_CALLS if fused else 0)
    _assert_runs_equal(got, want, again, entry == "lazy")
    graphs.release()


SHARDED_STEP_CASES = [("fused_adam", None, "alltoall"), ("fused_adam", 512, "alltoall"),
                      ("adam", None, "psum")]


def _sharded_step_runs(cuda, optimizer, capacity, routing, graphs, monkeypatch):
    """STEP_CALLS rounds of ShardedTrainStep grads, eval_sums and
    train_step at world size 1 through ``graphs``, on 4096-row batches:
    (outputs, state arrays, launches)."""
    from anime_recommendations_tpu_torch.parallel.mesh import make_world
    from anime_recommendations_tpu_torch.parallel.sharded_train import ShardedTrainStep
    from anime_recommendations_tpu_torch.parallel.trainer import init_placed_state
    from anime_recommendations_tpu_torch.train import step_graph
    from anime_recommendations_tpu_torch.train import trainer as tr

    monkeypatch.setattr(step_graph, "graphs_for", lambda device: graphs)
    world = make_world(1, 1, cuda)
    step = ShardedTrainStep(world, l2_reg_factor=1e-4, routing=routing, optimizer=optimizer,
                            capacity=capacity)
    state = init_placed_state(world, 3000, 500, 32, torch.Generator().manual_seed(0),
                              routing=routing)
    _kernels.launches.clear()
    outs = []
    for i, cols in enumerate(_step_batches(rows=4096, calls=STEP_CALLS)):
        grads = step.grads(state, *cols)
        sums = step.eval_sums(state.model, state.model.bn_state(), *cols)
        state, loss, mse = step.train_step(state, *cols, 1e-3 * (1 + i % 3) / 2)
        outs.append([t.cpu().numpy() for t in (*grads.values(), *sums, loss, mse)])
    torch.cuda.synchronize()
    return outs, tr.train_state_to_numpy(state), {k: _kernels.launches[k] for k in STEP_NAMES}


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer,capacity,routing", SHARDED_STEP_CASES)
def test_sharded_step_graph_replays_match_the_eager_steps(cuda, nccl_world, monkeypatch,
                                                          optimizer, capacity, routing):
    """ShardedTrainStep's grads, eval_sums and train_step at world size 1 on
    NCCL through a step-graph cache against StepGraphs(0): every output and
    state tensor bit for bit; at 512 slots (more than 4 rounds: the plans
    made before each call by a graph of their own, their rounds in the key;
    K1's dense branch) as at the default capacity; a capture per kind of
    call, a replay per call from the second on."""
    from anime_recommendations_tpu_torch.parallel import routing as rt
    from anime_recommendations_tpu_torch.train import step_graph

    if capacity is not None:
        for b in _step_batches(rows=4096, calls=STEP_CALLS):
            assert rt.plan_stats(b[0], 1, capacity)[2] == 5
    graphs = step_graph.StepGraphs()
    got = _sharded_step_runs(cuda, optimizer, capacity, routing, graphs, monkeypatch)
    want = _sharded_step_runs(cuda, optimizer, capacity, routing, step_graph.EAGER, monkeypatch)
    assert got[2] == want[2], (got[2], want[2])
    k1 = "fused_adam" if capacity is None else "fused_adam_dense"
    assert got[2][k1] == (2 * STEP_CALLS if optimizer == "fused_adam" else 0)
    for a, b in zip([*(v for o in got[0] for v in o), *got[1].values()],
                    [*(v for o in want[0] for v in o), *want[1].values()]):
        np.testing.assert_array_equal(a, b)
    # Every batch takes the same rounds (5 and 1 at 512 slots): one graph per
    # kind, and at 512 slots one for the plans made before each call.
    kinds = 3 if capacity is None else 4
    plans = [] if capacity is None else [3 * STEP_CALLS - 1]
    assert (graphs.captures, graphs.hits) == (kinds, 3 * (STEP_CALLS - 2) + sum(plans) - len(plans))
    assert sorted(g.replays for g in graphs._graphs.values()) == [STEP_CALLS - 1] * 3 + plans
    graphs.release()


@pytest.mark.cuda
def test_a_step_capture_that_syncs_raises(cuda, monkeypatch):
    """No fallback: a step body that reads a value on the host runs eagerly
    at its first call and fails its capture at the second."""
    from anime_recommendations_tpu_torch.train import step_graph

    graphs = step_graph.StepGraphs()
    monkeypatch.setattr(step_graph, "graphs_for", lambda device: graphs)
    x = torch.ones(4, device=cuda)

    def body(st, v):
        return ((v * 2).sum() * float((v * 2).sum().item()),)

    def call():
        return step_graph.run(("sync",), body, None, {"v": x}, [x], cuda, writes=False)

    assert float(call()[0]) == 64.0
    with pytest.raises(RuntimeError):
        call()
    assert len(graphs) == 0


# ---- dense Adam (csrc/dense_adam.cu) ------------------------------------------------

DENSE_SHAPES = {
    "adam_cell": [(91_641, 128), (17_560, 128), (), (), (), ()],
    "ragged": [(1001, 3), (7,), (5,), (), (4097,), (0,), (33, 129)],
}


def dense_quads(dev, shapes, seed, offset=0):
    """(p, g, mu, nu) per shape on ``dev`` from a seed, moments as after a
    few steps; each tensor ``offset`` elements into its own storage (1: 4
    bytes past a 16-byte boundary, the kernel's element-by-element path)."""
    rng = np.random.default_rng(seed)

    def t(shape, scale):
        x = np.asarray(rng.standard_normal(int(np.prod(shape)) + offset) * scale, np.float32)
        return torch.from_numpy(x).to(dev)[offset:].view(shape)

    return [(t(sh, 0.05), t(sh, 1e-3), t(sh, 1e-4), t(sh, 1e-4).square()) for sh in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset_1"])
@pytest.mark.parametrize("case", sorted(DENSE_SHAPES))
def test_dense_adam_kernel_matches_plain_bit_for_bit(cuda, case, offset):
    """Three steps of one launch over the list against the plain chain on
    the card: p, mu and nu bit for bit, in their own storage. The kernel
    applies the chain's correctly rounded f32 operations in its order (on
    the card torch divides by the step row's 0-dim tensors and its sqrt is
    correctly rounded), so no tolerance is needed."""
    from anime_recommendations_tpu_torch.ops import dense_adam

    ours = dense_quads(cuda, DENSE_SHAPES[case], seed=len(case), offset=offset)
    plain = [tuple(t.clone() for t in q) for q in ours]
    ptrs = [t.data_ptr() for q in ours for t in q]
    for step in (1, 2, 700):
        scal = fused_adam.scalar_row(step, 3e-4, cuda)
        before = _kernels.launches["dense_adam"]
        dense_adam.dense_adam_(*zip(*ours), scal)
        assert _kernels.launches["dense_adam"] == before + 1
        dense_adam._dense_adam_plain(*zip(*plain), scal, dense_adam.KERAS_ADAM_EPS)
    torch.cuda.synchronize()
    assert [t.data_ptr() for q in ours for t in q] == ptrs
    for q, r in zip(ours, plain):
        for a, b in zip(q, r):
            assert torch.equal(a, b)
    first = dense_quads(cuda, DENSE_SHAPES[case][:1], len(case), offset)[0][0]
    assert not torch.equal(ours[0][0], first)   # the steps moved it


@pytest.mark.cuda
def test_dense_adam_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    import ctypes

    from anime_recommendations_tpu_torch.ops import dense_adam

    p, g, mu, nu = dense_quads(cuda, [(64, 8)], seed=1)[0]
    scal = fused_adam.scalar_row(1, 1e-3, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dense_adam.dense_adam_([p.t()], [g.t()], [mu.t()], [nu.t()], scal)
    with pytest.raises(ValueError, match="is on"):
        dense_adam.dense_adam_([p], [g.cpu()], [mu], [nu], scal)
    with pytest.raises(ValueError, match="scal"):
        dense_adam.dense_adam_([p], [g], [mu], [nu], scal.cpu())
    with pytest.raises(TypeError, match="f32"):
        dense_adam.dense_adam_([p], [g.double()], [mu], [nu], scal)
    with pytest.raises(ValueError, match="1 to 8"):
        dense_adam.dense_adam_(*zip(*dense_quads(cuda, [(4,)] * 9, seed=2)), scal)
    # The C interface refuses a pointer off f32's alignment, a count past 8
    # and a step row off its alignment, and takes the same call aligned.
    lib = _kernels.library("dense_adam")
    ptr = lambda t, off=0: (ctypes.c_void_p * 1)(t.data_ptr() + off)
    numel = (ctypes.c_longlong * 1)(p.numel())

    def call(p_off=0, count=1, row_off=0):
        return lib.dense_adam(ptr(p, p_off), ptr(g), ptr(mu), ptr(nu), numel, count,
                              scal.data_ptr() + row_off, 0.9, 0.1, 0.999, 0.001, 1e-7,
                              ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    assert (call(p_off=2), call(count=9), call(row_off=1)) == (1, 1, 1)  # cudaErrorInvalidValue
    assert call() == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_dense_adam_replays_update_the_memory_the_eager_calls_do(cuda):
    """A CUDA graph captured around one dense_adam_ call (the adam cell's
    layout at small widths: two tables and four scalars), replayed for three
    steps with new gradients and step rows copied into its buffers, against
    eager calls on copies: bit for bit, in the captured tensors' storage,
    one launch recorded at capture and counted per replay."""
    from anime_recommendations_tpu_torch.ops import dense_adam

    ours = dense_quads(cuda, [(3000, 32), (500, 32), (), (), (), ()], seed=4)
    eager = [tuple(t.clone() for t in q) for q in ours]
    grads = [q[1] for q in ours]
    scal = fused_adam.scalar_row(1, 1e-3, cuda).clone()
    ptrs = [t.data_ptr() for q in ours for t in q]
    _kernels.library("dense_adam")   # built and loaded before the capture
    graph = torch.cuda.CUDAGraph()
    with _kernels.recording() as counts, torch.cuda.graph(graph):
        dense_adam.dense_adam_(*zip(*ours), scal)
    assert counts == {"dense_adam": 1}
    rng = np.random.default_rng(9)
    for step in (1, 2, 3):
        new = [torch.from_numpy(np.asarray(rng.standard_normal(tuple(g.shape)) * 1e-3,
                                           np.float32)).to(cuda) for g in grads]
        row = fused_adam.scalar_row(step, 1e-3 * step, cuda)
        for g, x in zip(grads, new):
            g.copy_(x)
        scal.copy_(row)
        before = _kernels.launches["dense_adam"]
        graph.replay()
        _kernels.count_replay(counts)
        assert _kernels.launches["dense_adam"] == before + 1
        dense_adam.dense_adam_([q[0] for q in eager], new, [q[2] for q in eager],
                               [q[3] for q in eager], row)
    torch.cuda.synchronize()
    assert [t.data_ptr() for q in ours for t in q] == ptrs
    for q, r in zip(ours, eager):
        for i in (0, 2, 3):
            assert torch.equal(q[i], r[i])
    del graph


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adam", "fused_adam", "lazy_adam"])
def test_dense_adam_launches_once_a_step(cuda, optimizer):
    """Two epochs through train_epoch's graph (counted per replay) and two
    through the eager loop: one dense_adam launch a step under each
    optimizer (adam's six parameters; the fused and lazy steps' four head
    scalars)."""
    from anime_recommendations_tpu_torch.train import device_loop as dl

    for fn in (dl.train_epoch, dl.eager_train_epoch):
        _kernels.launches.clear()
        _, _, data = _graph_epoch_runs(cuda, optimizer, fn)
        torch.cuda.synchronize()
        assert _kernels.launches["dense_adam"] == 2 * (data.n // 1024), fn.__name__
    dl.release_graphs()
