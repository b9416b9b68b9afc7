"""ops/lazy_adam.py: the row-sparse Adam update of train/lazy.py, its plain
path on the CPU and its kernel (csrc/lazy_adam.cu) on the card.

This file imports no jax, so its card tests run on a machine without it:

    ANIMEREC_TEST_TPU=1 python -m pytest tests/test_torch_lazy_adam.py -m cuda

On the CPU:

* the plain path (lazy_row_adam, and lazy_step's one lazy_adam_ call for
  both tables) is the torch chain train/lazy.py ran before the kernel, bit
  for bit, ``keep`` and padded row-0 slots included;
* ``kernel_order``, a numpy model of the kernel's arithmetic (a run summed
  in chunks of CHUNK sorted positions, each from 0, the chunks added in
  order; then the chain's f32 operations), equals the chain bit for bit on
  every row whose run lies inside one chunk (both then sum from 0 in sorted
  order) and within 1e-5 of each table's scale elsewhere (here with torch's
  CPU square root, which is not always correctly rounded; the card's is);
* the wrapper raises on what neither path takes; on the meta device the
  update and the lazy step read nothing on the host.

On the card (marked ``cuda``): the kernel equals ``kernel_order`` bit for
bit in every case (it is the same arithmetic in the same order), and the
plain chain run on the card bit for bit where every id is unique and within
1e-5 of each tensor's largest entry where ids repeat (the chain sums a run
with index_add_'s atomics, in an order that changes from run to run; the
tolerance is tests/test_torch_lazy.py's against JAX for the same reason).
Repeated launches from one state are bit-equal, and a chunked lazy epoch
launches the kernel once a step, counted per replay.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from anime_recommendations_tpu_torch.ops import _kernels
from anime_recommendations_tpu_torch.ops.dense_adam import B1, B2, KERAS_ADAM_EPS
from anime_recommendations_tpu_torch.ops.fused_adam import scalar_row
from anime_recommendations_tpu_torch.ops.lazy_adam import (
    CHUNK,
    MAX_TABLES,
    LazyTable,
    _lazy_row_adam_plain,
    lazy_adam_,
)
from anime_recommendations_tpu_torch.train import trainer as tr
from anime_recommendations_tpu_torch.train.lazy import (
    _data_loss,
    _head_adam,
    lazy_row_adam,
    lazy_step,
)

torch.set_num_threads(2)

L2 = 1e-4
LR = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def old_chain(w, mu, nu, ids, g_rows, scal, l2, b1=B1, b2=B2, eps=KERAS_ADAM_EPS, keep=None):
    """train/lazy.py's lazy_row_adam as it was written before the kernel."""
    with torch.no_grad():
        order = torch.argsort(ids, stable=True)
        ids_s = ids[order].long()
        g_s = g_rows[order]
        if keep is not None:
            keep_s = keep[order]
            g_s = torch.where(keep_s[:, None], g_s, 0.0)
        is_start = torch.ones_like(ids_s, dtype=torch.bool)
        is_start[1:] = ids_s[1:] != ids_s[:-1]
        seg = torch.cumsum(is_start, 0) - 1
        g_run = torch.zeros_like(g_s).index_add_(0, seg, g_s)
        w_rows, mu_rows, nu_rows = w[ids_s], mu[ids_s], nu[ids_s]
        g_tot = g_run[seg] + (2.0 * l2) * w_rows
        lr, bc1, bc2 = scal[0], scal[1], scal[2]
        mu_new = b1 * mu_rows + (1.0 - b1) * g_tot
        nu_new = b2 * nu_rows + (1.0 - b2) * (g_tot * g_tot)
        upd = -lr * (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps)
        w_new = w_rows + upd
        if keep is not None:
            live = torch.zeros_like(ids_s).index_add_(0, seg, keep_s.long())[seg] > 0
            w_new = torch.where(live[:, None], w_new, w_rows)
            mu_new = torch.where(live[:, None], mu_new, mu_rows)
            nu_new = torch.where(live[:, None], nu_new, nu_rows)
        w.index_copy_(0, ids_s, w_new)
        mu.index_copy_(0, ids_s, mu_new)
        nu.index_copy_(0, ids_s, nu_new)


def torch_cpu_sqrt(x):
    """torch's f32 square root on the CPU, which is not always correctly
    rounded (numpy's, CUDA's and the kernel's __fsqrt_rn are)."""
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def kernel_order(w, mu, nu, ids, g_rows, scal, l2, keep=None, sqrt=np.sqrt):
    """csrc/lazy_adam.cu's arithmetic in numpy f32, in place on numpy arrays:
    each run of the stably sorted ids sums its kept gradient rows in pieces
    (its part of each CHUNK-aligned range of sorted positions), each from 0,
    then the pieces from 0 in order; then the chain's operations, each
    rounded to f32 (``sqrt`` correctly rounded unless another is given).
    Returns the rows whose run lies inside one chunk."""
    f = np.float32
    lr, bc1, bc2 = (f(x) for x in np.asarray(scal)[:3])
    b1, omb1, b2, omb2 = f(B1), f(1.0 - B1), f(B2), f(1.0 - B2)
    eps, l2x2 = f(KERAS_ADAM_EPS), f(2.0 * l2)
    order = np.argsort(ids, kind="stable")
    ids_s = ids[order]
    kept = np.ones(len(ids), bool) if keep is None else keep[order]
    starts = np.flatnonzero(np.r_[True, ids_s[1:] != ids_s[:-1]]) if len(ids) else []
    ends = list(starts[1:]) + [len(ids)]
    inside = []
    for lo, hi in zip(starts, ends):
        cuts = [lo, *range((lo // CHUNK + 1) * CHUNK, hi, CHUNK), hi]
        total = np.zeros(w.shape[1], f)
        for a, b in zip(cuts[:-1], cuts[1:]):
            piece = np.zeros(w.shape[1], f)
            for p in range(a, b):
                if kept[p]:
                    piece = piece + g_rows[order[p]]
            total = total + piece
        r = ids_s[lo]
        if len(cuts) == 2:
            inside.append(r)
        if not kept[lo:hi].any():
            continue
        g = total + l2x2 * w[r]
        m = b1 * mu[r] + omb1 * g
        v = b2 * nu[r] + omb2 * (g * g)
        upd = (-lr * (m / bc1)) / (sqrt(v / bc2) + eps)
        w[r], mu[r], nu[r] = w[r] + upd, m, v
    return np.array(inside, np.int64)


def zipf_ids(rng, n, b, s=0.8):
    """b ids over n rows with Zipf-s popularity (row 0 the hottest)."""
    p = np.arange(1, n + 1, dtype=np.float64) ** -s
    return rng.choice(n, size=b, p=p / p.sum()).astype(np.int32)


def ids_of(kind, rng, n, b):
    if kind == "distinct":
        return rng.permutation(n)[:b].astype(np.int32)
    if kind == "mixed":
        return rng.integers(0, max(b // 3, 1), b).astype(np.int32)
    if kind == "one_id":
        return np.full(b, 7 % n, np.int32)
    if kind == "padded_row0":   # the device loop's padding: trailing slots of row 0
        ids = rng.integers(0, n, b).astype(np.int32)
        ids[-b // 4:] = 0
        return ids
    if kind == "zipf_hot":
        return zipf_ids(rng, n, b)
    raise ValueError(kind)


def table(rng, n, d, b, ids, keep=None):
    """numpy (w, mu, nu, ids, g, keep): moments as after a few steps."""
    w = rng.standard_normal((n, d)).astype(np.float32) * 0.05
    mu = rng.standard_normal((n, d)).astype(np.float32) * 1e-3
    nu = (rng.standard_normal((n, d)).astype(np.float32) * 1e-3) ** 2
    g = rng.standard_normal((b, d)).astype(np.float32) * 1e-2
    return w, mu, nu, ids, g, keep


def torch_table(arrays, device="cpu"):
    *tensors, keep = (None if x is None else torch.from_numpy(x.copy()).to(device)
                      for x in arrays)
    return LazyTable(*tensors, keep)


def close_to_scale(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def keep_dropping_runs(rng, ids):
    """About a third of the positions dropped, and every position of the
    ids 1, 2 and 3 (whole runs)."""
    keep = rng.uniform(size=len(ids)) > 0.33
    keep[np.isin(ids, [1, 2, 3])] = False
    return keep


# ---- CPU: the plain path is the old chain ---------------------------------------------------

@pytest.mark.parametrize("with_keep", [False, True], ids=["all_kept", "keep"])
@pytest.mark.parametrize("kind", ["distinct", "mixed", "one_id", "padded_row0"])
def test_plain_path_is_the_old_chain_bit_for_bit(kind, with_keep):
    rng = np.random.default_rng(4)
    n, d, b = 300, 16, 120
    ids = ids_of(kind, rng, n, b)
    arrays = table(rng, n, d, b, ids, keep_dropping_runs(rng, ids) if with_keep else None)
    ours, ref = torch_table(arrays), torch_table(arrays)
    scal = scalar_row(3, LR, "cpu")
    out = lazy_row_adam(*ours[:5], scal, L2, keep=ours.keep)
    old_chain(*ref[:5], scal, L2, keep=ref.keep)
    assert out.w is ours.w and out.mu is ours.mu and out.nu is ours.nu
    for a, c in zip(ours[:3], ref[:3]):
        assert torch.equal(a, c)
    assert not torch.equal(ours.w, torch.from_numpy(arrays[0]))


def test_lazy_step_is_the_old_chain_on_both_tables_bit_for_bit():
    """Three lazy_steps (one lazy_adam_ call for both tables) against the
    same steps with the old chain per table: every state tensor bit for bit."""
    make = lambda: tr.init_train_state(200, 80, 16, generator=torch.Generator().manual_seed(5),
                                       device="cpu")
    ours, ref = make(), make()
    rng = np.random.default_rng(6)
    for step in range(1, 4):
        cols = [torch.from_numpy(rng.integers(0, 200, 128).astype(np.int32)),
                torch.from_numpy(zipf_ids(rng, 80, 128)),
                torch.from_numpy(rng.uniform(0, 1, 128).astype(np.float32)), torch.ones(128)]
        scal = scalar_row(step, LR, "cpu")
        loss, _ = lazy_step(ours, *cols, scal, L2)
        model, adam = ref.model, ref.adam
        u_rows = model.user_emb.detach()[cols[0]].requires_grad_()
        a_rows = model.anime_emb.detach()[cols[1]].requires_grad_()
        head = tuple(p.detach().requires_grad_() for p in model.head_params())
        ref_loss, (_, new_bn) = _data_loss(u_rows, a_rows, head, model.bn_state(), *cols[2:])
        d_u, d_a, *d_head = torch.autograd.grad(ref_loss, (u_rows, a_rows, *head))
        for k, ids, g in (("user_emb", cols[0], d_u), ("anime_emb", cols[1], d_a)):
            old_chain(getattr(model, k).detach(), adam.mu[k], adam.nu[k], ids, g, scal, L2)
        with torch.no_grad():
            _head_adam(ref, d_head, scal)
            tr._keep_bn(model, new_bn)
        assert torch.equal(loss, ref_loss.detach())
    got, want = tr.train_state_to_numpy(ours), tr.train_state_to_numpy(ref)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_one_call_for_two_tables_is_two_calls():
    rng = np.random.default_rng(7)
    arrays = [table(rng, 90, 8, 40, ids_of("mixed", rng, 90, 40)),
              table(rng, 50, 8, 64, zipf_ids(rng, 50, 64))]
    ours = [torch_table(a) for a in arrays]
    ref = [torch_table(a) for a in arrays]
    scal = scalar_row(2, LR, "cpu")
    lazy_adam_(ours, scal, L2)
    for t in ref:
        lazy_adam_([t], scal, L2)
    for o, r in zip(ours, ref):
        for a, c in zip(o[:3], r[:3]):
            assert torch.equal(a, c)


# ---- CPU: the numpy model of the kernel's arithmetic ----------------------------------------

@pytest.mark.parametrize("kind", ["distinct", "mixed", "zipf_hot", "padded_row0"])
def test_kernel_order_is_the_chain_where_a_run_fits_one_chunk(kind):
    rng = np.random.default_rng(8)
    n, d, b = 400, 12, 300
    arrays = table(rng, n, d, b, ids_of(kind, rng, n, b))
    ref = torch_table(arrays)
    scal = scalar_row(5, LR, "cpu")
    _lazy_row_adam_plain(*ref[:5], scal, L2)
    model = [x.copy() for x in arrays[:3]]
    inside = kernel_order(*model, arrays[3], arrays[4], scal.numpy(), L2, sqrt=torch_cpu_sqrt)
    assert len(inside) > 0
    for got, want in zip(model, ref[:3]):
        want = want.numpy()
        np.testing.assert_array_equal(got[inside], want[inside])
        close_to_scale(got, want, 1e-5)
    if kind == "distinct":
        for got, want in zip(model, ref[:3]):
            np.testing.assert_array_equal(got, want.numpy())


# ---- CPU: the wrapper's checks, the meta device ---------------------------------------------

def _bad(case):
    """A list of tables and a scal row that the wrapper refuses."""
    rng = np.random.default_rng(9)
    t = torch_table(table(rng, 20, 4, 10, ids_of("mixed", rng, 20, 10)))
    scal = scalar_row(1, LR, "cpu")
    return {
        "no_tables": ([], scal),
        "nine_tables": ([t] * (MAX_TABLES + 1), scal),
        "f64_w": ([t._replace(w=t.w.double())], scal),
        "bf16_nu": ([t._replace(nu=t.nu.bfloat16())], scal),
        "f64_grad": ([t._replace(g_rows=t.g_rows.double())], scal),
        "float_ids": ([t._replace(ids=t.ids.float())], scal),
        "int_keep": ([t._replace(keep=torch.ones(10, dtype=torch.int32))], scal),
        "short_grad": ([t._replace(g_rows=t.g_rows[:9])], scal),
        "wide_grad": ([t._replace(g_rows=torch.zeros(10, 5))], scal),
        "mu_shape": ([t._replace(mu=t.mu[:19])], scal),
        "keep_shape": ([t._replace(keep=torch.ones(9, dtype=torch.bool))], scal),
        "ids_2d": ([t._replace(ids=t.ids.view(2, 5))], scal),
        "two_widths": ([t, torch_table(table(rng, 20, 6, 10, ids_of("mixed", rng, 20, 10)))],
                       scal),
        "meta_grad": ([t._replace(g_rows=t.g_rows.to("meta"))], scal),
        "strided_w": ([t._replace(w=torch.zeros(4, 20).t())], scal),
        "strided_grad": ([t._replace(g_rows=torch.zeros(4, 10).t())], scal),
        "short_scal": ([t], scal[:3]),
        "f64_scal": ([t], scal.double()),
    }[case]


@pytest.mark.parametrize("case", ["no_tables", "nine_tables", "f64_w", "bf16_nu", "f64_grad",
                                  "float_ids", "int_keep", "short_grad", "wide_grad", "mu_shape",
                                  "keep_shape", "ids_2d", "two_widths", "meta_grad", "strided_w",
                                  "strided_grad", "short_scal", "f64_scal"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    tables, scal = _bad(case)
    want = {"no_tables": "1 to 8", "nine_tables": "1 to 8", "f64_w": "f32", "bf16_nu": "f32",
            "f64_grad": "f32", "float_ids": "int32", "int_keep": "bool", "short_grad": "needs",
            "wide_grad": "needs", "mu_shape": "one \\[N, D\\]", "keep_shape": "needs",
            "ids_2d": "needs", "two_widths": "one width", "meta_grad": "meta",
            "strided_w": "contiguous", "strided_grad": "contiguous", "short_scal": "scal",
            "f64_scal": "scal"}[case]
    before = [(x.clone() if x is not None and x.device.type == "cpu" else x)
              for t in tables for x in t]
    with pytest.raises((TypeError, ValueError), match=want):
        lazy_adam_(tables, scal, L2)
    for x, y in zip(before, (x for t in tables for x in t)):
        if x is not None and x.device.type == "cpu":
            assert torch.equal(x, y)   # nothing written before the check


def test_the_update_reads_nothing_on_the_host_on_the_meta_device():
    """On the meta device every value is unknown: an update that read one on
    the host (.item(), bool(t)) or sized a tensor by the data would raise.
    Two tables of one call, one with keep; then a whole lazy_step."""
    meta = lambda *shape, dtype=torch.float32: torch.zeros(*shape, dtype=dtype, device="meta")
    tables = [LazyTable(meta(300, 16), meta(300, 16), meta(300, 16),
                        meta(64, dtype=torch.int32), meta(64, 16)),
              LazyTable(meta(90, 16), meta(90, 16), meta(90, 16), meta(64, dtype=torch.int64),
                        meta(64, 16), meta(64, dtype=torch.bool))]
    lazy_adam_(tables, meta(4), L2)
    state = tr.init_train_state(300, 90, 16, generator=torch.Generator().manual_seed(0),
                                device="meta")
    loss, mse = lazy_step(state, meta(64, dtype=torch.int32), meta(64, dtype=torch.int32),
                          meta(64), meta(64), meta(4), L2)
    assert loss.is_meta and mse.is_meta and loss.shape == ()


def test_the_wrapper_and_the_source_agree_on_their_constants():
    """CHUNK and MAX_TABLES are the source's kChunk and kMaxTables, and
    _kernels.SIGNATURES gives lazy_adam as many arguments as its C entry."""
    src = (Path(_kernels.CSRC) / "lazy_adam.cu").read_text()
    assert int(re.search(r"constexpr int kChunk = (\d+);", src).group(1)) == CHUNK
    assert int(re.search(r"constexpr int kMaxTables = (\d+);", src).group(1)) == MAX_TABLES
    proto = re.search(r'extern "C" int lazy_adam\((.*?)\)\s*\{', src, re.S).group(1)
    assert len(proto.split(",")) == len(_kernels.SIGNATURES["lazy_adam"])
    assert "lazy_adam" in _kernels.SOURCES


# ---- the card: the kernel against its plain version -----------------------------------------

def _run_both(device, arrays_list, scal_step=5):
    """The kernel (one launch) and the plain chain on the card from the same
    tables; returns (kernel tables, chain tables, numpy model tables)."""
    scal = scalar_row(scal_step, LR, device)
    ours = [torch_table(a, device) for a in arrays_list]
    chain = [torch_table(a, device) for a in arrays_list]
    before = _kernels.launches["lazy_adam"]
    lazy_adam_(ours, scal, L2)
    assert _kernels.launches["lazy_adam"] == before + 1
    for t in chain:
        _lazy_row_adam_plain(*t[:5], scal, L2, keep=t.keep)
    torch.cuda.synchronize()
    model = []
    for a in arrays_list:
        m = [x.copy() for x in a[:3]]
        kernel_order(*m, a[3], a[4], scal.cpu().numpy(), L2, keep=a[5])
        model.append(m)
    return ours, chain, model


def _offset(arrays, device):
    """The table's tensors at a 4-byte (not 16-byte) aligned address."""
    t = torch_table(arrays, device)
    shifted = []
    for x in t[:5]:
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        shifted.append(y)
    return LazyTable(*shifted, t.keep)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["aligned", "offset"])
@pytest.mark.parametrize("d", [128, 5])
def test_kernel_is_the_chain_bit_for_bit_on_unique_ids(cuda, d, layout):
    rng = np.random.default_rng(10)
    n, b = 50_000, 10_000
    arrays = table(rng, n, d, b, ids_of("distinct", rng, n, b))
    scal = scalar_row(5, LR, cuda)
    ours = _offset(arrays, cuda) if layout == "offset" else torch_table(arrays, cuda)
    chain = torch_table(arrays, cuda)
    lazy_adam_([ours], scal, L2)
    _lazy_row_adam_plain(*chain[:5], scal, L2)
    torch.cuda.synchronize()
    for a, c in zip(ours[:3], chain[:3]):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 37])
@pytest.mark.parametrize("kind", ["mixed", "one_id", "padded_row0", "zipf_hot"])
def test_kernel_is_its_summation_order_and_near_the_chain(cuda, kind, d):
    """Repeated ids: bit for bit the numpy model of the kernel's order, and
    within 1e-5 of each tensor's largest entry of the chain (index_add_'s
    atomics sum in another order). zipf_hot: Zipf-0.8 over 20,000 rows, its
    hottest run over 300 of 10,000 positions."""
    rng = np.random.default_rng(11)
    n, b = 20_000, 10_000
    ids = ids_of(kind, rng, n, b)
    if kind == "zipf_hot":
        assert np.bincount(ids).max() >= 300
    ours, chain, model = _run_both(cuda, [table(rng, n, d, b, ids)])
    for a, c, m in zip(ours[0][:3], chain[0][:3], model[0]):
        np.testing.assert_array_equal(a.cpu().numpy(), m)
        close_to_scale(a.cpu().numpy(), c.cpu().numpy(), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 5])
def test_keep_drops_positions_and_whole_runs(cuda, d):
    """keep: a third of the positions dropped and every position of three
    hot ids: those rows keep their bits; the rest as in the cases above."""
    rng = np.random.default_rng(12)
    n, b = 5_000, 10_000
    ids = zipf_ids(rng, n, b)
    keep = keep_dropping_runs(rng, ids)
    arrays = table(rng, n, d, b, ids, keep)
    ours, chain, model = _run_both(cuda, [arrays])
    for a, c, m, x in zip(ours[0][:3], chain[0][:3], model[0], arrays[:3]):
        a = a.cpu().numpy()
        np.testing.assert_array_equal(a, m)
        np.testing.assert_array_equal(a[[1, 2, 3]], x[[1, 2, 3]])
        close_to_scale(a, c.cpu().numpy(), 1e-5)


@pytest.mark.cuda
def test_two_tables_in_one_launch_at_the_lazy_cells_widths(cuda):
    """The lazy cell's step shape, smaller tables: 10,000 user ids over
    100,000 rows and 10,000 Zipf-0.8 item ids over 62,500 rows in one
    launch: each table bit for bit its own single-table launch and the
    model of the kernel's order."""
    rng = np.random.default_rng(13)
    arrays = [table(rng, 100_000, 128, 10_000, rng.integers(0, 100_000, 10_000).astype(np.int32)),
              table(rng, 62_500, 128, 10_000, zipf_ids(rng, 62_500, 10_000))]
    ours, _, model = _run_both(cuda, arrays)
    scal = scalar_row(5, LR, cuda)
    for a, o, m in zip(arrays, ours, model):
        alone = torch_table(a, cuda)
        lazy_adam_([alone], scal, L2)
        for x, y, z in zip(o[:3], alone[:3], m):
            assert torch.equal(x, y)
            np.testing.assert_array_equal(x.cpu().numpy(), z)


@pytest.mark.cuda
def test_repeated_launches_are_bit_equal(cuda):
    """The same update from one state three times, Zipf-0.8 ids with hot
    runs across many chunks: the same bits each time (the chain's atomics
    need not agree with themselves)."""
    rng = np.random.default_rng(14)
    arrays = table(rng, 20_000, 128, 10_000, zipf_ids(rng, 20_000, 10_000))
    scal = scalar_row(9, LR, cuda)
    outs = []
    for _ in range(3):
        t = torch_table(arrays, cuda)
        lazy_adam_([t], scal, L2)
        outs.append([x.cpu() for x in t[:3]])
    for other in outs[1:]:
        for a, c in zip(outs[0], other):
            assert torch.equal(a, c)


@pytest.mark.cuda
def test_chunked_lazy_epoch_launches_once_a_step_per_replay(cuda, monkeypatch):
    """With CHUNK_STEPS = 6, two 20-step lazy epochs through the chunk
    graphs (captured at the first, replayed at both) and two through the
    eager chunks: one lazy_adam launch a step each way, and the captured
    epochs bit for bit the eager ones (the kernel's sums are fixed)."""
    from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
    from anime_recommendations_tpu_torch.train import device_loop as dl

    dl.release_graphs()
    monkeypatch.setattr(dl, "CHUNK_STEPS", 6)
    rng = np.random.default_rng(15)
    rows = 20_000
    ds = RatingsDataset(rng.integers(0, 3000, rows).astype(np.int32),
                        zipf_ids(rng, 500, rows), rng.uniform(0, 1, rows).astype(np.float32))
    data = dl.stage(ds, 1024, seed=0, device=cuda)
    states = {}
    for fn in (dl.train_epoch, dl.eager_train_epoch):
        state = tr.init_train_state(3000, 500, 32, generator=torch.Generator().manual_seed(0),
                                    device=cuda)
        _kernels.launches.clear()
        for epoch, lr in enumerate((1e-3, 5e-4)):
            state, *_ = fn(state, data, torch.Generator().manual_seed(epoch), lr, 1024, 1e-4,
                           optimizer="lazy_adam")
        torch.cuda.synchronize()
        assert _kernels.launches["lazy_adam"] == 2 * (data.n // 1024), fn.__name__
        states[fn.__name__] = tr.train_state_to_numpy(state)
    for k, v in states["train_epoch"].items():
        np.testing.assert_array_equal(v, states["eager_train_epoch"][k], err_msg=k)
    dl.release_graphs()
