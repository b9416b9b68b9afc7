"""The port's row-sparse Adam epoch against the benchmark's plain reference
(portbench/reference_lazy.py), on the CPU.

The port trains through Trainer._device_epoch (device_loop=True,
optimizer="lazy_adam", as ``cli train`` runs it), one epoch from seeded
random weights over seeded Zipf-skewed ratings (portbench/datagen.py: hot
items repeat within a batch; the last of 24 batches is padded, and the
shuffle scatters its weight-0 slots), in one chunk (one graph on a card)
and in chunks of 4 steps.
The reference follows the same batches in the device loop's order
(reference.epoch_batches). They are compared by the benchmark's numbers
(portbench/compare.training): the worst step loss, the first moment's and
the parameters' change's norms by leaf, the holdout loss, at the
configuration's first learning rate. Tolerances (TOLERANCE), each ten times
the most that seeds 3, 99 and 2**31 + 7 read here and far under what the
faults read (bfloat16: 3.1e-3 loss, 1.0 change; dense Adam: 9.2e-4 loss,
0.41 change):

* ``loss`` 2e-6 relative: the port sums a batch's terms over the padded
  batch (its weight-0 slots included) and the reference over the batch's
  rows, so the means differ in f32 rounding (1.5e-7 at most);
* ``moment`` 2e-6 of the leaf's norm: a row's gradients are summed in
  another order (the port's sorted runs, the reference's index_add_ over
  torch.unique's inverse), a few f32 ulps (1.2e-7);
* ``change`` 2e-4: the same rounding carried through Adam's normalized
  steps, where a gradient element near zero moves its parameter by up to
  lr either way (7.7e-6);
* ``val_loss`` 2e-6 relative, as ``loss`` (1.7e-7).

The dense-Adam reference (portbench/reference.py: decay of every row, the
L2 term in the loss) and reference_lazy in bfloat16 both fail them. So does
a reference that lets the padded slots touch no row (``moment`` 2.7e-4 to
4.5e-4): the port's lazy update, as the JAX package's, counts them as
touches of row 0.
"""

import numpy as np
import pytest
import torch

from anime_recommendations_tpu_torch.data.dataset import RatingsDataset
from anime_recommendations_tpu_torch.models.two_tower import PARAM_KEYS, TwoTower
from anime_recommendations_tpu_torch.train import device_loop as dl
from anime_recommendations_tpu_torch.train.trainer import AdamState, Trainer, TrainState
from portbench import compare, datagen, reference, reference_lazy

torch.set_num_threads(2)
CFG = dict(n_users=400, n_anime=150, n_ratings=12_100, embedding_size=16, batch_size=500,
           test_size=500, l2_reg_factor=1e-4, assumed={"count_sigma": 1.1})
SEED, LR = 2**31 + 7, 1e-5
TOLERANCE = {"loss": 2e-6, "moment": 2e-6, "change": 2e-4, "val_loss": 2e-6}


def _split():
    r = datagen.ratings(CFG, SEED, "cpu")
    cols = r.users.int().numpy(), r.anime.int().numpy(), r.rating.numpy()
    train, hold = datagen.holdout_split(len(cols[0]), CFG["test_size"], SEED)
    return (RatingsDataset(*(c[train] for c in cols)), RatingsDataset(*(c[hold] for c in cols)))


def _port_epoch(train, holdout, weights, chunk, monkeypatch):
    """One epoch of the port from ``weights``: its readings as the benchmark
    takes them."""
    trainer = Trainer(embedding_size=CFG["embedding_size"], l2_reg_factor=CFG["l2_reg_factor"],
                      batch_size=CFG["batch_size"], seed=5, device_loop=True,
                      optimizer="lazy_adam", device="cpu", verbose=False)
    model = TwoTower(CFG["n_users"], CFG["n_anime"], CFG["embedding_size"])
    with torch.no_grad():
        for k, v in weights.items():
            getattr(model, k).copy_(v)
    zeros = lambda: {k: torch.zeros_like(getattr(model, k).detach()) for k in PARAM_KEYS}
    state = TrainState(model=model, adam=AdamState(count=0, mu=zeros(), nu=zeros()))
    seen, epoch = [], dl.train_epoch
    monkeypatch.setattr(dl, "train_epoch", lambda *a, **k: (lambda out: (
        seen.append(out[1].double().tolist()), out)[1])(epoch(*a, **k)))
    if chunk:
        monkeypatch.setattr(dl, "CHUNK_STEPS", chunk)
    staged = trainer._stage_device(train, holdout)
    state, *_, val_loss, _ = trainer._device_epoch(staged, state, 0, LR)
    norm = lambda x: float(torch.linalg.vector_norm(x.detach().double()))
    return trainer, {
        "losses": seen[0], "lrs": [LR], "val_loss": val_loss,
        "moment_norms": {k: norm(m) for k, m in state.adam.mu.items()},
        "change_norms": {k: norm(getattr(state.model, k) - weights[k]) for k in PARAM_KEYS}}


def _reference(train, holdout, trainer, weights, **kw):
    dev = lambda x, t: torch.as_tensor(np.asarray(x), dtype=t)
    to_dev = lambda d: (dev(d.users, torch.long), dev(d.anime, torch.long),
                        dev(d.ratings, torch.float32))
    batches = reference.epoch_batches(len(train), CFG["batch_size"], trainer.seed,
                                      trainer.seed * 1000)
    dense = kw.pop("dense", False)
    if dense:
        out = reference.train_epoch(weights, to_dev(train), batches, LR, CFG["l2_reg_factor"],
                                    to_dev(holdout), **kw)
    else:
        out = reference_lazy.train_epoch(weights, to_dev(train), batches, LR,
                                         CFG["l2_reg_factor"], to_dev(holdout),
                                         CFG["batch_size"], **kw)
    return dict(out, lrs=[LR])


@pytest.fixture(scope="module")
def inputs():
    train, holdout = _split()
    return train, holdout, datagen.weights(CFG, SEED, "cpu")


def _within(numbers):
    return {k: numbers[k] <= TOLERANCE[k] for k in TOLERANCE}


@pytest.mark.parametrize("chunk", [None, 4], ids=["one-graph", "chunks"])
def test_port_lazy_epoch_agrees_with_the_plain_reference(inputs, chunk, monkeypatch):
    train, holdout, weights = inputs
    trainer, prog = _port_epoch(train, holdout, weights, chunk, monkeypatch)
    assert len(prog["losses"]) == -(-len(train) // CFG["batch_size"]) == 24
    numbers = compare.training(prog, _reference(train, holdout, trainer, weights))
    assert all(_within(numbers).values()), numbers


@pytest.mark.parametrize("fault", [{"dtype": torch.bfloat16}, {"dense": True}],
                         ids=["bf16-reference", "dense-reference"])
def test_the_control_and_dense_semantics_fail_the_tolerances(inputs, fault, monkeypatch):
    train, holdout, weights = inputs
    trainer, _ = _port_epoch(train, holdout, weights, None, monkeypatch)
    sound = _reference(train, holdout, trainer, weights)
    numbers = compare.training(_reference(train, holdout, trainer, weights, **fault), sound)
    assert not all(_within(numbers).values()), numbers
