"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device. This file
imports no jax, so it also runs on a machine without it:

    ANIMEREC_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda

(ANIMEREC_TEST_TPU=1 keeps tests/conftest.py from importing jax.)

Tolerances. Top-k: values 1e-5 absolute for f32 tables, 1e-2 for bf16;
indices equal except where the two rows' true scores tie within 1e-6;
stage-1 keys within one key step (the 9 lane bits cut the score to ~1.2e-4
absolute). int8 stage-1 keys: bit-equal without a head (an exact integer
product, then one rounded f32 operation per step, in the plain version's
order), one key step with the head (expf). Exact scan: values 1e-6
relative (fmaf in row order against cuBLAS's order), indices equal except
where true scores tie within 1e-6, and equal on tables whose scores are
exact. Row normalization: 1e-6 relative for f32 outputs (rsqrtf is not
correctly rounded), one bf16 ulp for bf16 outputs, zero rows zero. Fused
Adam: the kernel applies the plain version's operations in its order, so
where a row's duplicate gradients are summed in the same order the results
are equal; the plain version on the card sums duplicates
with index_add_'s atomics, in another order, so W', mu' and nu' are held to
1e-5 relative to each tensor's largest entry, bf16 moments to one bf16 ulp,
and sumsq to 1e-5 relative.
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
    before = _kernels.launches["packed_topk"]
    v, i = topk.masked_topk(tw, tq, 10, **kw)
    assert _kernels.launches["packed_topk"] == before + 1
    pv, pi = topk.two_stage_topk(topk._packed_candidates_plain, tw, tq, 10, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(),
                               atol=1e-5 if dtype == torch.float32 else 1e-2, rtol=0)
    assert bool((i >= 0).all()) and bool((pi >= 0).all())
    gap = (row_scores(tw, tq, i, kw.get("head")) - row_scores(tw, tq, pi, kw.get("head"))).abs()
    assert not bool(((i != pi) & (gap > 1e-6)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 3, 8, 21])
def test_stage1_keys_match_plain(cuda, q):
    """Ragged last group (N = 1300), query tiles of 1 and 8 with a partial
    tile, top_r up to the whole group."""
    w, keep = inputs(cuda, n=1300, d=32)
    queries = w[:q].contiguous()
    excl = torch.arange(q, device=cuda)
    for top_r in (1, 4, 512):
        args = (w, queries, top_r, keep, excl, None)
        got = topk._packed_candidates_cuda(*args)
        want = topk._packed_candidates_plain(*args)
        assert got.shape == want.shape == (q, 3 * top_r)
        assert torch.equal(got > 0, want > 0)
        live = got > 0
        step = ((got & ~511).view(torch.float32) - (want & ~511).view(torch.float32)).abs()
        assert float(step[live].max()) <= 1.3e-4
        assert torch.equal(got[~live], want[~live])  # dead keys do not depend on scores


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
    for name, a, b in zip(("w", "mu", "nu"), got[:3], want[:3]):
        a, b = a.float(), b.float()
        if dtype == torch.bfloat16 and name != "w":
            # One bf16 ulp where the f32 values differ in their last bits.
            tol = b.abs() * 2.0 ** -7 + 1e-30
        else:
            tol = 1e-5 * float(b.abs().max())
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
