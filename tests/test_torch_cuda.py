"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device. This file
imports no jax, so it also runs on a machine without it:

    ANIMEREC_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda

(ANIMEREC_TEST_TPU=1 keeps tests/conftest.py from importing jax.) Tolerance:
values 1e-5 absolute for f32 tables, 1e-2 for bf16; indices equal except
where the two rows' true scores tie within 1e-6; stage-1 keys within one key step (the 9
lane bits cut the score to ~1.2e-4 absolute).
"""

import numpy as np
import pytest
import torch

from anime_recommendations_tpu_torch.ops import _kernels, topk


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
