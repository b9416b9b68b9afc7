"""The device-resident epoch that a card runs as one CUDA graph, on the CPU.

On a card train/device_loop.py captures the epoch's steps once and replays
them, feeding each step its scalars (lr, bc1, bc2, step) from a per-epoch
table in device memory. What makes that possible is checked here, at a
small size, for each optimizer:

  * the table equals the f32 scalars of adam_scalars / bias_corrections
    bit for bit, over two epochs with a change of lr;
  * the epoch body, which reads its scalars as 0-dim tensors, equals bit for
    bit the eager epoch as it was written before (host-number scalars, and
    the lazy step's unique-id write through a boolean mask), kept below as
    ``reference_epoch``; and JAX's device_loop.train_epoch over two epochs
    within tests/test_torch_train.py's tolerances (loss and mse 2e-6
    absolute, tables 1e-5 of the largest entry; fused_adam_bf16m is not
    compared with JAX, whose stochastic rounding draws the TPU's bits);
  * every state tensor keeps its storage over an epoch and over a
    checkpoint restore (the graph holds their addresses);
  * the static-shape lazy_row_adam matches JAX's at tests/test_torch_lazy.py's
    tolerance (1e-5 of each table's scale), duplicate ids included;
  * the body makes no host sync: it runs on the meta device, where .item(),
    bool(t) and shapes that depend on the data raise (adam, lazy_adam and
    the evaluation; the fused kernels' wrappers are CUDA or CPU only, and
    their CUDA branch is checked by the capture on the card);
  * a replay adds the launches counted at capture to _kernels.launches.

The captured epoch against the eager one on the card:
tests/test_torch_cuda.py -k captured_epoch.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anime_recommendations_tpu.data.dataset import RatingsDataset as JDataset
from anime_recommendations_tpu.train import device_loop as jdl
from anime_recommendations_tpu.train.lazy import lazy_row_adam as jlazy_row_adam
from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
from anime_recommendations_tpu_torch.models import two_tower as tt
from anime_recommendations_tpu_torch.ops import _kernels
from anime_recommendations_tpu_torch.ops.fused_adam import (
    adam_scalars,
    scalar_row,
    sr_random_bits,
    stochastic_round_bf16,
)
from anime_recommendations_tpu_torch.train import device_loop as dl
from anime_recommendations_tpu_torch.train import trainer as tr
from anime_recommendations_tpu_torch.train.checkpoint import Checkpointer
from anime_recommendations_tpu_torch.train.lazy import _data_loss, lazy_row_adam
from anime_recommendations_tpu_torch.train.step_graph import state_tensors
from anime_recommendations_tpu_torch.utils.graphs import CapturedGraph
from tests.test_torch_train import close_to_scale, initial_arrays, numpy_to_jax, ratings

torch.set_num_threads(2)
OPTIMIZERS = ("adam", "lazy_adam", "fused_adam", "fused_adam_bf16m")
N_USERS, N_ANIME, D, BS, L2 = 120, 30, 8, 50, 1e-4
LRS = (1e-3, 5e-4)   # two epochs, a change of lr between them
B1, B2, EPS = tr.B1, tr.B2, tr.KERAS_ADAM_EPS


def port_state(optimizer, seed=1):
    state = tr.train_state_from_numpy(initial_arrays(N_USERS, N_ANIME, D, seed=seed), "cpu")
    if optimizer == "fused_adam_bf16m":
        state = tr.cast_table_moments(state, torch.bfloat16)
    return state


def staged(seed=3, rows=420):        # 9 batches of 50, the last padded
    return dl.stage(RatingsDataset(*ratings(N_USERS, N_ANIME, rows, seed=seed)), BS,
                    seed=None, device="cpu")


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


# ---- the scalar table --------------------------------------------------------------

@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_scalar_table_is_the_f32_scalars_of_each_step(optimizer, monkeypatch):
    """Each epoch's steps read rows (lr, bc1, bc2, step) equal bit for bit to
    adam_scalars' lr and bias_corrections' bc1, bc2, the count advancing by
    the epoch's steps."""
    tables = []
    body = dl._epoch_body
    monkeypatch.setattr(dl, "_epoch_body", lambda s, d, table, *a, **k: (
        tables.append(table.clone()), body(s, d, table, *a, **k))[1])
    state, data = port_state(optimizer), staged()
    nb = data.n // BS
    for lr in LRS:
        state, *_ = dl.train_epoch(state, data, torch.Generator().manual_seed(0), lr, BS, L2,
                                   optimizer=optimizer)
    assert state.adam.count == 2 * nb and len(tables) == 2
    for epoch, (lr, table) in enumerate(zip(LRS, tables)):
        steps = np.arange(1, nb + 1) + epoch * nb
        bc = np.array([tr.bias_corrections(int(t)) for t in steps], np.float32)
        lrs = np.array([adam_scalars(int(t), lr, L2, B1, B2, EPS).lr for t in steps], np.float32)
        got = table.numpy()
        np.testing.assert_array_equal(bits(got[:, 0]), bits(lrs))
        np.testing.assert_array_equal(bits(got[:, 1:3]), bits(bc))
        np.testing.assert_array_equal(got.view(np.uint32)[:, 3], steps)
    assert torch.equal(scalar_row(7, LRS[1], "cpu"),
                       torch.from_numpy(dl.scalar_table(6, 1, LRS[1])[0]))


# ---- the body against the eager epoch as it was -----------------------------------

def reference_dense_step(state, u, a, r, w, lr, l2):
    """The dense Adam step with host-number scalars."""
    model, adam = state.model, state.adam
    params = [getattr(model, k) for k in tt.PARAM_KEYS]
    loss, (mse, new_bn) = tt.loss_and_metrics(model, model.bn_state(), u, a, r, w, l2, True)
    grads = torch.autograd.grad(loss, params)
    bc1, bc2 = tr.bias_corrections(adam.count + 1)
    with torch.no_grad():
        for k, p, g in zip(tt.PARAM_KEYS, params, grads):
            mu, nu = adam.mu[k], adam.nu[k]
            mu.mul_(B1).add_(g * (1 - B1))
            nu.mul_(B2).add_(torch.square(g) * (1 - B2))
            p.sub_((mu / bc1) / (torch.sqrt(nu / bc2) + EPS) * lr)
        tr._keep_bn(model, new_bn)
    return loss.detach(), mse.detach()


@torch.no_grad()
def reference_lazy_row_adam(w, mu, nu, ids, g_rows, t, lr, l2):
    """lazy_row_adam with one update per unique id, written through the
    boolean-mask heads (a shape that depends on the data)."""
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order].long()
    g_s = g_rows[order]
    is_start = torch.ones_like(ids_s, dtype=torch.bool)
    is_start[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(is_start, 0) - 1
    heads = ids_s[is_start]
    g_tot = torch.zeros(heads.shape[0], w.shape[1]).index_add_(0, seg, g_s)
    w_rows, mu_rows, nu_rows = w[heads], mu[heads], nu[heads]
    g_tot = g_tot + (2.0 * l2) * w_rows
    s = adam_scalars(t, lr, l2, B1, B2, EPS)
    mu_new = B1 * mu_rows + (1.0 - B1) * g_tot
    nu_new = B2 * nu_rows + (1.0 - B2) * (g_tot * g_tot)
    upd = -lr * (mu_new / s.bc1) / (torch.sqrt(nu_new / s.bc2) + EPS)
    w.index_copy_(0, heads, w_rows + upd)
    mu.index_copy_(0, heads, mu_new)
    nu.index_copy_(0, heads, nu_new)


@torch.no_grad()
def reference_head_adam(state, d_head, lr):
    model, adam = state.model, state.adam
    bc1, bc2 = tr.bias_corrections(adam.count + 1)
    for k, g in zip(tt.HEAD_KEYS, d_head):
        p, mu, nu = getattr(model, k), adam.mu[k], adam.nu[k]
        mu_new = B1 * mu + (1.0 - B1) * g
        nu_new = B2 * nu + (1.0 - B2) * (g * g)
        p.copy_(p - (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + EPS) * lr)
        adam.mu[k], adam.nu[k] = mu_new, nu_new


def reference_row_grads(state, u_rows, a_rows, r, w):
    u_rows = u_rows.detach().requires_grad_()
    a_rows = a_rows.detach().requires_grad_()
    head = tuple(p.detach().requires_grad_() for p in state.model.head_params())
    loss, (mse, new_bn) = _data_loss(u_rows, a_rows, head, state.model.bn_state(), r, w)
    return loss, mse, new_bn, torch.autograd.grad(loss, (u_rows, a_rows, *head))


def reference_lazy_step(state, u, a, r, w, lr, l2):
    model, adam = state.model, state.adam
    loss, mse, new_bn, (d_u, d_a, *d_head) = reference_row_grads(
        state, model.user_emb.detach()[u], model.anime_emb.detach()[a], r, w)
    for k, ids, g in (("user_emb", u, d_u), ("anime_emb", a, d_a)):
        reference_lazy_row_adam(getattr(model, k).detach(), adam.mu[k], adam.nu[k], ids, g,
                                adam.count + 1, lr, l2)
    reference_head_adam(state, d_head, lr)
    with torch.no_grad():
        tr._keep_bn(model, new_bn)
    return loss.detach(), mse.detach()


@torch.no_grad()
def reference_sparse_adam(w, mu, nu, ids, g_rows, t, lr, l2):
    """K1's plain version with host-number scalars. Returns sumsq."""
    order = torch.argsort(ids, stable=True)
    ids_s, g_s = ids[order].long(), g_rows[order].float()
    n, d = w.shape
    s = adam_scalars(t, lr, l2, B1, B2, EPS)
    f = np.float32
    dscat = torch.zeros_like(w).index_add_(0, ids_s, g_s)
    sumsq = torch.sum(torch.square(w))
    g = dscat + w * float(f(2) * f(s.l2))
    mu_new = mu.float() * s.b1 + g * float(f(1) - f(s.b1))
    nu_new = nu.float() * s.b2 + (g * g) * float(f(1) - f(s.b2))
    upd = (mu_new / torch.tensor(s.bc1)) / (torch.sqrt(nu_new / torch.tensor(s.bc2)) + s.eps)
    w.copy_(w - upd * s.lr)
    for moment, (dst, new) in enumerate(((mu, mu_new), (nu, nu_new))):
        if dst.dtype == torch.bfloat16:
            new = stochastic_round_bf16(new, sr_random_bits(t, moment, n, d, "cpu"))
        dst.copy_(new)
    return sumsq


def reference_fused_epoch(state, data, lr, l2):
    """The software-pipelined fused epoch with host-number scalars."""
    model, adam = state.model, state.adam
    nb = data.n // BS
    batches = [[x[i * BS:(i + 1) * BS] for x in data] for i in range(nb)]
    u_rows = model.user_emb.detach()[batches[0][0]]
    a_rows = model.anime_emb.detach()[batches[0][1]]
    losses, mses = [], []
    for i, (u, a, r, w) in enumerate(batches):
        data_loss, mse, new_bn, (d_u, d_a, *d_head) = reference_row_grads(
            state, u_rows, a_rows, r, w)
        sumsq = [reference_sparse_adam(getattr(model, k).detach(), adam.mu[k], adam.nu[k], ids, g,
                                       adam.count + 1, lr, l2)
                 for k, ids, g in (("user_emb", u, d_u), ("anime_emb", a, d_a))]
        reference_head_adam(state, d_head, lr)
        with torch.no_grad():
            tr._keep_bn(model, new_bn)
        adam.count += 1
        losses.append(data_loss.detach() + l2 * (sumsq[0] + sumsq[1]))
        mses.append(mse.detach())
        nxt = batches[(i + 1) % nb]
        u_rows, a_rows = model.user_emb.detach()[nxt[0]], model.anime_emb.detach()[nxt[1]]
    return torch.stack(losses), torch.stack(mses)


def reference_epoch(state, data, generator, lr, l2, optimizer):
    """The eager epoch as it was written with host-number scalars."""
    data = dl.granule_shuffle(data, generator)
    if optimizer in tr.FUSED_OPTIMIZERS:
        return reference_fused_epoch(state, data, lr, l2)
    step = reference_lazy_step if optimizer == "lazy_adam" else reference_dense_step
    out = []
    for i in range(data.n // BS):
        out.append(step(state, *(x[i * BS:(i + 1) * BS] for x in data), lr, l2))
        state.adam.count += 1
    return tuple(torch.stack(c) for c in zip(*out))


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_epoch_body_equals_the_host_scalar_epoch_bit_for_bit(optimizer):
    """Two shuffled epochs with a change of lr: losses, mses and every state
    tensor bit for bit."""
    data = staged()
    ours, ref = port_state(optimizer), port_state(optimizer)
    for epoch, lr in enumerate(LRS):
        ours, loss, mse, _ = dl.train_epoch(ours, data, torch.Generator().manual_seed(epoch),
                                            lr, BS, L2, optimizer=optimizer)
        ref_loss, ref_mse = reference_epoch(ref, data, torch.Generator().manual_seed(epoch),
                                            lr, L2, optimizer)
        assert torch.equal(loss, ref_loss) and torch.equal(mse, ref_mse)
    got, want = tr.train_state_to_numpy(ours), tr.train_state_to_numpy(ref)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam", "fused_adam"])
def test_two_epochs_match_jax(optimizer):
    """dl.train_epoch over two unshuffled epochs with a change of lr against
    JAX's device loop, at tests/test_torch_train.py's tolerances."""
    cols = ratings(N_USERS, N_ANIME, 420, seed=3)
    arrays = initial_arrays(N_USERS, N_ANIME, D, seed=1)
    js, ts = numpy_to_jax(arrays), tr.train_state_from_numpy(arrays, "cpu")
    jdata = jdl.stage(JDataset(*cols), BS, seed=None)
    data = dl.stage(RatingsDataset(*cols), BS, seed=None, device="cpu")
    for lr in LRS:
        js, jl, jm, _ = jdl.train_epoch(js, jdata, jax.random.PRNGKey(0), jnp.float32(lr), BS,
                                        L2, shuffle=False, optimizer=optimizer)
        ts, loss, mse, _ = dl.train_epoch(ts, data, torch.Generator(), lr, BS, L2,
                                          shuffle=False, optimizer=optimizer)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=0, atol=2e-6)
        np.testing.assert_allclose(mse.numpy(), np.asarray(jm), rtol=0, atol=2e-6)
    for k in ("user_emb", "anime_emb"):
        close_to_scale(getattr(ts.model, k).detach().numpy(), np.asarray(getattr(js.params, k)),
                       1e-5)
    assert ts.adam.count == int(js.opt_state.count) == 2 * (data.n // BS)


# ---- chunked epochs ------------------------------------------------------------------

CHUNK = 3   # CHUNK_STEPS in these cases


def whole_epoch(state, data, generator, lr, shuffle, optimizer):
    """The epoch as one plain composition, without chunks: the whole epoch's
    granule permutation (none unshuffled), its scalar table and one epoch
    body over every batch. Returns train_epoch's result."""
    if shuffle:
        data = dl.permute_granules(data, dl.granule_permutation(data.n, generator))
    nb = data.n // BS
    table = torch.from_numpy(dl.scalar_table(state.adam.count, nb, lr))
    out = dl._epoch_body(state, data, table, BS, L2, optimizer)
    state.adam.count += nb
    return (state, *out)


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam", "fused_adam"])
@pytest.mark.parametrize("rows,shuffle", [(420, True), (520, True), (520, False), (140, True)],
                         ids=["multiple", "tail", "tail-unshuffled", "within"])
def test_chunked_epoch_equals_the_one_graph_epoch_bit_for_bit(optimizer, rows, shuffle,
                                                              monkeypatch):
    """With CHUNK_STEPS = 3, epochs of 9 steps (three chunks), 11 (three and a
    tail of 2) and 3 (one chunk) take the same batches in the same order
    with the same scalar rows as one epoch body over the whole permuted
    epoch (whole_epoch): two epochs with a change of lr, losses, mses,
    weights and every state tensor bit for bit."""
    data = staged(rows=rows)
    whole, chunked = port_state(optimizer), port_state(optimizer)
    monkeypatch.setattr(dl, "CHUNK_STEPS", CHUNK)
    for epoch, lr in enumerate(LRS):
        whole, *want = whole_epoch(whole, data, torch.Generator().manual_seed(epoch), lr,
                                   shuffle, optimizer)
        chunked, *got = dl.train_epoch(chunked, data, torch.Generator().manual_seed(epoch),
                                       lr, BS, L2, shuffle=shuffle, optimizer=optimizer)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert chunked.adam.count == whole.adam.count == 2 * (data.n // BS)
    got, want = tr.train_state_to_numpy(chunked), tr.train_state_to_numpy(whole)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("rows", [420, 520, 140], ids=["multiple", "tail", "within"])
def test_chunked_evaluation_equals_the_one_graph_evaluation_bit_for_bit(rows, monkeypatch):
    """The holdout's loss and mse, its sums carried from chunk to chunk,
    against the sums of every batch in one pass."""
    state, data = port_state("adam"), staged(rows=rows)
    zero = torch.zeros(())
    want = dl._means(*dl._eval_sums(state.model, state.model.bn_state(), data, BS, L2,
                                    zero, zero, zero))
    monkeypatch.setattr(dl, "CHUNK_STEPS", CHUNK)
    got = dl.eval_epoch(state.model, state.model.bn_state(), data, BS, L2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("nb,want", [(1, [(0, 1)]), (3, [(0, 3)]), (9, [(0, 3), (3, 3), (6, 3)]),
                                     (11, [(0, 3), (3, 3), (6, 3), (9, 2)])])
def test_chunks_cover_the_epoch_without_padding(nb, want, monkeypatch):
    monkeypatch.setattr(dl, "CHUNK_STEPS", CHUNK)
    assert dl.chunks(nb) == want


@pytest.mark.parametrize("n,batch", [(450, 50), (550, 50), (5000, 250), (262_810, 10_000)])
def test_chunk_rows_are_the_permuted_epochs_rows(n, batch):
    """chunk_inputs and chunk_rows give each chunk the rows of the granule
    permutation of the whole epoch (permute_granules), tail included, for
    chunks that start anywhere inside a granule."""
    idx = torch.arange(n, dtype=torch.int32)
    data = dl.DeviceData(idx, idx, idx.float(), torch.ones(n))
    perm = dl.granule_permutation(n, torch.Generator().manual_seed(5))
    whole = dl.permute_granules(data, perm).users
    slots, g = dl.epoch_slots(n, perm), dl._granule(n)
    nb = n // batch
    for start, steps in [(0, 1), (1, 2), (nb - 3, 3), (nb - 1, 1)]:
        host = dl.chunk_inputs(slots, start, steps, batch, g)
        rows = dl.chunk_rows(data, torch.from_numpy(host["slots"]),
                             torch.from_numpy(host["offset"]), steps, batch)
        assert torch.equal(rows.users, whole[start * batch:(start + steps) * batch])


# ---- storage ------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_state_keeps_its_storage_over_an_epoch_and_a_restore(optimizer, tmp_path):
    state, data = port_state(optimizer), staged()
    ptrs = [t.data_ptr() for t in state_tensors(state)]
    state, *_ = dl.train_epoch(state, data, torch.Generator().manual_seed(0), LRS[0], BS, L2,
                               optimizer=optimizer)
    assert [t.data_ptr() for t in state_tensors(state)] == ptrs
    ckpt = Checkpointer(tmp_path)
    ckpt.save(0, state)
    saved = {k: v.copy() for k, v in tr.train_state_to_numpy(state).items()}
    state, *_ = dl.train_epoch(state, data, torch.Generator().manual_seed(1), LRS[1], BS, L2,
                               optimizer=optimizer)
    assert not np.array_equal(tr.train_state_to_numpy(state)["user_emb"], saved["user_emb"])
    state = ckpt.restore(state, 0)
    assert [t.data_ptr() for t in state_tensors(state)] == ptrs
    for k, v in tr.train_state_to_numpy(state).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)


# ---- the static-shape lazy update ------------------------------------------------------

@pytest.mark.parametrize("ids_kind", ["mixed", "one_id", "distinct"])
def test_static_lazy_row_adam_matches_jax_and_the_mask_version(ids_kind):
    rng = np.random.default_rng(3)
    n, d, b, t, l2 = 200, 16, 96, 3, 1e-4
    w = rng.standard_normal((n, d)).astype(np.float32) * 0.05
    mu = rng.standard_normal((n, d)).astype(np.float32) * 0.01
    nu = (rng.standard_normal((n, d)).astype(np.float32) * 0.01) ** 2
    ids = {"mixed": rng.integers(0, 20, b), "one_id": np.full(b, 7),
           "distinct": rng.permutation(n)[:b]}[ids_kind].astype(np.int32)
    g = rng.standard_normal((b, d)).astype(np.float32) * 0.1
    got = lazy_row_adam(*(torch.from_numpy(x.copy()) for x in (w, mu, nu, ids, g)),
                        scalar_row(t, 1e-3, "cpu"), l2)
    want = jlazy_row_adam(*map(jnp.asarray, (w, mu, nu, ids, g)), jnp.asarray(t),
                          jnp.float32(1e-3), l2)
    for a, c in zip(got, want):
        close_to_scale(a.numpy(), np.asarray(c), 1e-5)
    ref = [torch.from_numpy(x.copy()) for x in (w, mu, nu)]
    reference_lazy_row_adam(*ref, torch.from_numpy(ids), torch.from_numpy(g), t, 1e-3, l2)
    for a, c in zip(got, ref):
        assert torch.equal(a, c)


# ---- no host sync -----------------------------------------------------------------------

def meta_state_and_data():
    state = tr.init_train_state(N_USERS, N_ANIME, D, generator=torch.Generator().manual_seed(0),
                                device="meta")
    return state, dl.stage(RatingsDataset(*ratings(N_USERS, N_ANIME, 420, seed=3)), BS,
                           device="meta")


@pytest.mark.parametrize("optimizer", ["adam", "lazy_adam"])
def test_epoch_body_runs_on_the_meta_device(optimizer):
    """On the meta device every value is unknown: a step that reads one on
    the host (.item(), bool(t)) or sizes a tensor by the data (a boolean
    mask, nonzero, unique) raises. The shuffle, the body and the evaluation
    run through."""
    state, data = meta_state_and_data()
    nb = data.n // BS
    perm = dl.granule_permutation(data.n, torch.Generator().manual_seed(0)).to("meta")
    table = dl.scalar_table(0, nb, 1e-3)
    losses, mses, wsums = dl._epoch_body(state, dl.permute_granules(data, perm),
                                         torch.from_numpy(table).to("meta"), BS, L2, optimizer)
    assert losses.shape == mses.shape == wsums.shape == (nb,) and losses.is_meta
    vl, vm = dl.eager_eval_epoch(state.model, state.model.bn_state(), data, BS, L2)
    assert vl.is_meta and vm.is_meta and vl.shape == ()


def test_the_meta_device_catches_a_data_dependent_shape():
    """The mask version of the lazy update cannot run there: what the test
    above would catch."""
    state, _ = meta_state_and_data()
    w, mu, nu = (t.detach() for t in (state.model.user_emb, state.adam.mu["user_emb"],
                                      state.adam.nu["user_emb"]))
    ids = torch.zeros(BS, dtype=torch.int32, device="meta")
    with pytest.raises((NotImplementedError, RuntimeError)):
        reference_lazy_row_adam(w, mu, nu, ids, torch.zeros(BS, D, device="meta"), 1, 1e-3, L2)


# ---- launch counts under replay -----------------------------------------------------------

class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_replay_adds_the_captured_launches(monkeypatch):
    """Launches counted while a graph is captured (or warmed up) stay out of
    _kernels.launches; each replay adds them once."""
    monkeypatch.setattr(_kernels, "launches", Counter({"fused_adam": 5}))
    with _kernels.recording() as captured:
        for _ in range(3):
            _kernels.count_launch("fused_adam")
            _kernels.count_launch("fused_adam_tiles")
    assert captured == {"fused_adam": 3, "fused_adam_tiles": 3}
    assert _kernels.launches == {"fused_adam": 5}
    graph = object.__new__(CapturedGraph)
    graph.graph, graph.launches, graph.replays = _FakeGraph(), captured, 0
    graph.buffers = {"table": torch.zeros(3, 4)}
    graph.outputs = (graph.buffers["table"].sum(dim=1),)
    table = dl.scalar_table(10, 3, 1e-3)
    for replay in range(1, 3):
        (out,) = graph.replay({"table": table})
        assert graph.graph.replays == graph.replays == replay
        assert _kernels.launches == {"fused_adam": 5 + 3 * replay, "fused_adam_tiles": 3 * replay}
        assert out is not graph.outputs[0]
    np.testing.assert_array_equal(graph.buffers["table"].numpy(), table)
    _kernels.count_launch("fused_adam")
    assert _kernels.launches["fused_adam"] == 12


def test_graph_cache_keeps_the_most_recent(monkeypatch):
    monkeypatch.setattr(dl, "_GRAPHS", type(dl._GRAPHS)())
    built = []
    for key in ("a", "b", "a", *"cdef", "a"):
        dl.cached_graph(key, lambda key=key: built.append(key) or object())
    assert built == ["a", "b", *"cdef", "a"] and list(dl._GRAPHS)[-1] == "a"
    assert len(dl._GRAPHS) == dl.GRAPH_CACHE
    dl.release_graphs()
    assert not dl._GRAPHS
