"""The comparison that decides ``correct``, driven through whole runs on the
CPU at tiny sizes: the sound program passes; the control (the reference in
bfloat16, or the program's bf16 tables) and each planted fault fail."""

import pytest
import torch

from portbench import compare, harness
from pb_tiny import CPU, run_tiny, tiny_cell

TRAIN = ["anime7m-train-adam", "anime7m-train-fused"]


SERVE = ["animefull-serve-batch"]


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_sound_run_is_correct(name):
    out, line = run_tiny(tiny_cell(name))
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in harness.Cell.load(name).end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", TRAIN)
def test_training_control_fails(name):
    cell = tiny_cell(name)
    kind = harness.kind_module(cell.traffic["kind"])
    for seed in (3, 2**31 + 4, 2**33 + 5):
        out = kind.calibrate(cell, CPU, seed, control=True)
        assert compare.verdict(out["sound"], cell.limits)
        assert not compare.verdict(out["control"], cell.limits)
        assert not compare.verdict(out["half_batch"], cell.limits)


@pytest.mark.parametrize("name", SERVE)
def test_serving_control_fails(name):
    cell = tiny_cell(name)
    kind = harness.kind_module(cell.traffic["kind"])
    for seed in (3, 2**31 + 4, 2**33 + 5):
        out = kind.calibrate(cell, CPU, seed, control=True)
        assert not compare.verdict(out["control"], cell.limits), out


def _snapshot(state):
    ts = [getattr(state.model, k) for k in ("user_emb", "anime_emb", "dense_w", "dense_b",
                                              "bn_gamma", "bn_beta", "moving_mean",
                                              "moving_var")]
    ts += list(state.adam.mu.values()) + list(state.adam.nu.values())
    return [(t, t.detach().clone()) for t in ts]


def _restore(saved):
    with torch.no_grad():
        for t, v in saved:
            t.copy_(v)


def _faults(step_name):
    from anime_recommendations_tpu_torch.train import device_loop as dl

    orig = getattr(dl, step_name)
    weights_at = 4 if step_name == "dense_step" else 6

    def unchanged(state, *args, **kwargs):
        saved = _snapshot(state)
        out = orig(state, *args, **kwargs)
        _restore(saved)
        return out

    def half_batch(state, *args, **kwargs):
        args = list(args)
        w = args[weights_at - 1].clone()
        w[len(w) // 2:] = 0
        args[weights_at - 1] = w
        return orig(state, *args, **kwargs)

    return {"unchanged": unchanged, "half_batch": half_batch}


@pytest.mark.parametrize("name,step", [(TRAIN[0], "dense_step"), (TRAIN[1], "pipelined_step")])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_fault_is_caught(monkeypatch, name, step, fault):
    from anime_recommendations_tpu_torch.train import device_loop as dl

    monkeypatch.setattr(dl, step, _faults(step)[fault])
    _, line = run_tiny(tiny_cell(name))
    assert not line["correct"], line["checks"]


def _stale_row(orig):
    """The epoch's scalar rows all its first's: the Adam count stalls."""
    def scalar_table(count, steps, lr):
        rows = orig(count, steps, lr)
        rows[1:] = rows[0]
        return rows
    return scalar_table


def _unshuffled(orig):
    """The epoch's granules left in their staged order."""
    def granule_permutation(n, generator):
        return torch.arange(len(orig(n, generator)))
    return granule_permutation


def _one_lr(orig):
    """The schedule stuck at its first epoch's rate."""
    def lr(self, epoch):
        return orig(self, 0)
    return lr


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["stale_row", "unshuffled", "one_lr"])
def test_epoch_loop_fault_is_caught(monkeypatch, name, fault):
    """Faults in the epoch's own loop, outside the step it runs."""
    from anime_recommendations_tpu_torch.train import device_loop as dl
    from anime_recommendations_tpu_torch.train.trainer import Trainer

    owner, attr, plant = {"stale_row": (dl, "scalar_table", _stale_row),
                          "unshuffled": (dl, "granule_permutation", _unshuffled),
                          "one_lr": (Trainer, "lr", _one_lr)}[fault]
    monkeypatch.setattr(owner, attr, plant(getattr(owner, attr)))
    _, line = run_tiny(tiny_cell(name))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("route", ["cosine_topk", "score_topk"])
def test_altered_answer_is_caught(monkeypatch, route):
    from anime_recommendations_tpu_torch.recommend import batch

    orig = getattr(batch, route)

    def altered(*args, **kwargs):
        vals, idx = orig(*args, **kwargs)
        return vals, idx.roll(1, dims=1)

    monkeypatch.setattr(batch, route, altered)
    _, line = run_tiny(tiny_cell("animefull-serve-batch"))
    assert not line["correct"], line["checks"]

