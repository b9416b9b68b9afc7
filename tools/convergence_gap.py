#!/usr/bin/env python3
"""Where the port's val MSE differs from the JAX package's: a CPU comparison.

    python3 tools/convergence_gap.py --part same_start [--optimizers adam,lazy_adam]
    python3 tools/convergence_gap.py --part seeds|cross [--seeds 0,1,2]
    [--epochs N] [--out FILE]

Both packages run the planted-teacher harness's CI scale
(train/convergence.py's CI_SCALE: 1,500 users x 400 anime x 200,000
ratings, D = 128, batch 2,000, up to 20 epochs, patience 3) on the CPU, on
data made once by numpy (the two packages' synthetic and preprocess modules
are equal on the same seed).

--part same_start: one initial state, drawn by the JAX package
(jax.random.PRNGKey(0)) and carried to the port through numpy
(tests/test_torch_train.py's jax_to_numpy / numpy_to_jax, the parity tests'
conversion), and the same batches (device_loop=False: each epoch's order is
numpy's, seeded seed * 1000 + epoch in both trainers). The histories are
held to tests/test_torch_train.py's tolerances: training columns 1e-5
relative, validation columns 2e-3, the learning rates equal.

--part seeds: each package's own harness (run_convergence, its defaults:
the device loop, its own generator for the initial state and the epoch
shuffle) at train seeds 0, 1 and 2: best val MSE, its epoch and the floor
ratio of each run, and each package's spread.

--part cross: at each train seed, both initial states (the JAX package's
jax.random draw and the port's torch.Generator draw, carried across through
numpy) through both trainers (the device loop, each with its own epoch
shuffle at that seed): whether best val MSE follows the initial state or
the trainer. Each run also reports the state's dense_w, the head's one
scalar weight, drawn from a truncated normal times sqrt(2).

Like the tests, this script imports both packages (JAX on the CPU). Prints
JSON lines; --out also writes them to FILE.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from anime_recommendations_tpu.data.dataset import RatingsDataset as JDataset  # noqa: E402
from anime_recommendations_tpu.train import convergence as jconv  # noqa: E402
from anime_recommendations_tpu.train import trainer as jtr  # noqa: E402
from anime_recommendations_tpu_torch.data import synthetic  # noqa: E402
from anime_recommendations_tpu_torch.data.dataset import (  # noqa: E402
    RatingsDataset,
    train_holdout_split,
)
from anime_recommendations_tpu_torch.data.preprocess import (  # noqa: E402
    drop_useless,
    scale_ratings,
)
from anime_recommendations_tpu_torch.data.vocab import build_vocab, encode_frame  # noqa: E402
from anime_recommendations_tpu_torch.train import convergence as conv  # noqa: E402
from anime_recommendations_tpu_torch.train import trainer as tr  # noqa: E402
from tests.test_torch_train import jax_to_numpy, numpy_to_jax  # noqa: E402

TRAIN_COLUMNS, VAL_COLUMNS = ("loss", "mse"), ("val_loss", "val_mse")
TRAIN_RTOL, VAL_RTOL = 1e-5, 2e-3   # tests/test_torch_train.py's assert_histories_match


def ci_data(spec):
    """(train, holdout, n_users, n_anime) of the harness's data chain."""
    df = synthetic.synth_ratings(n_users=spec.n_users, n_anime=spec.n_anime,
                                 n_interactions=spec.n_interactions,
                                 latent_dim=spec.latent_dim, seed=spec.data_seed,
                                 noise=spec.noise)
    df = scale_ratings(drop_useless(df, num_reviews=0))
    vocab = build_vocab(df)
    train, holdout = train_holdout_split(encode_frame(df, vocab), test_size=spec.test_size)
    return train, holdout, vocab.n_users, vocab.n_anime


def trainer_kwargs(spec, device_loop: bool = False) -> dict:
    return dict(embedding_size=spec.embedding_size, batch_size=spec.batch_size,
                epochs=spec.epochs, start_lr=spec.start_lr, max_lr=spec.max_lr,
                min_lr=spec.min_lr, seed=spec.train_seed, optimizer=spec.optimizer,
                device_loop=device_loop, verbose=False)


def gaps(got, want) -> dict:
    """The largest relative gap per history column."""
    return {c: float(np.max(np.abs(got[c].to_numpy() - want[c].to_numpy())
                            / np.abs(want[c].to_numpy())))
            for c in (*TRAIN_COLUMNS, *VAL_COLUMNS, "lr")}


def same_start(spec, optimizer: str) -> dict:
    spec = dataclasses.replace(spec, optimizer=optimizer)
    train, holdout, n_users, n_anime = ci_data(spec)
    arrays = jax_to_numpy(jtr.init_train_state(jax.random.PRNGKey(0), n_users, n_anime,
                                               spec.embedding_size))
    t0 = time.perf_counter()
    jres = jtr.Trainer(**trainer_kwargs(spec)).fit(
        JDataset(train.users, train.anime, train.ratings),
        JDataset(holdout.users, holdout.anime, holdout.ratings), n_users, n_anime,
        initial_state=numpy_to_jax(arrays))
    t1 = time.perf_counter()
    res = tr.Trainer(device="cpu", **trainer_kwargs(spec)).fit(
        RatingsDataset(train.users, train.anime, train.ratings),
        RatingsDataset(holdout.users, holdout.anime, holdout.ratings), n_users, n_anime,
        initial_state=tr.train_state_from_numpy(arrays, "cpu"))
    t2 = time.perf_counter()
    g = gaps(res.history, jres.history)
    within = (all(g[c] <= TRAIN_RTOL for c in TRAIN_COLUMNS)
              and all(g[c] <= VAL_RTOL for c in VAL_COLUMNS) and g["lr"] == 0.0
              and len(res.history) == len(jres.history))
    best = lambda r: float(r.history["val_mse"].iloc[r.best_epoch])  # noqa: E731
    return {"optimizer": optimizer, "epochs": [len(res.history), len(jres.history)],
            "best_epoch": [res.best_epoch, jres.best_epoch],
            "best_val_mse": {"port": best(res), "jax": best(jres)},
            "largest_relative_gap": g, "within_test_tolerance": within,
            "seconds": {"jax": t1 - t0, "port": t2 - t1}}


def seed_runs(spec, seeds) -> dict:
    out = {"port": [], "jax": []}
    for seed in seeds:
        s = dataclasses.replace(spec, train_seed=seed)
        port = conv.run_convergence(s, verbose=False, device="cpu")
        js = jconv.run_convergence(jconv.ConvergenceSpec(**dataclasses.asdict(s)), verbose=False)
        for name, r in (("port", port), ("jax", js)):
            out[name].append({"seed": seed, "best_val_mse": r.best_val_mse,
                              "best_epoch": r.best_epoch, "floor_ratio": r.floor_ratio,
                              "train_seconds": r.train_seconds})
    for name in ("port", "jax"):
        v = [r["best_val_mse"] for r in out[name]]
        out[f"{name}_spread"] = {"min": min(v), "max": max(v), "mean": float(np.mean(v))}
    lo = max(out["port_spread"]["min"], out["jax_spread"]["min"])
    hi = min(out["port_spread"]["max"], out["jax_spread"]["max"])
    out["ranges_overlap"] = lo <= hi
    out["jax_covers_port"] = (out["jax_spread"]["min"] <= out["port_spread"]["min"]
                              and out["port_spread"]["max"] <= out["jax_spread"]["max"])
    return out


def cross(spec, seeds) -> list[dict]:
    """Both initial states through both trainers at each seed."""
    train, holdout, n_users, n_anime = ci_data(spec)
    out = []
    for seed in seeds:
        s = dataclasses.replace(spec, train_seed=seed)
        inits = {
            "jax": jax_to_numpy(jtr.init_train_state(jax.random.PRNGKey(seed), n_users, n_anime,
                                                     s.embedding_size)),
            "port": tr.train_state_to_numpy(tr.init_train_state(
                n_users, n_anime, s.embedding_size,
                generator=torch.Generator().manual_seed(seed), device="cpu")),
        }
        for init, arrays in inits.items():
            jres = jtr.Trainer(**trainer_kwargs(s, device_loop=True)).fit(
                JDataset(train.users, train.anime, train.ratings),
                JDataset(holdout.users, holdout.anime, holdout.ratings), n_users, n_anime,
                initial_state=numpy_to_jax(arrays))
            res = tr.Trainer(device="cpu", **trainer_kwargs(s, device_loop=True)).fit(
                RatingsDataset(train.users, train.anime, train.ratings),
                RatingsDataset(holdout.users, holdout.anime, holdout.ratings), n_users, n_anime,
                initial_state=tr.train_state_from_numpy(arrays, "cpu"))
            out.append({"seed": seed, "init": init, "dense_w": float(arrays["dense_w"]),
                        "best_val_mse": {
                            "jax_trainer": float(jres.history["val_mse"].iloc[jres.best_epoch]),
                            "port_trainer": float(res.history["val_mse"].iloc[res.best_epoch])}})
            print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--part", choices=("same_start", "seeds", "cross"), required=True)
    parser.add_argument("--optimizers", default="adam")
    parser.add_argument("--seeds", default="0,1,2")
    parser.add_argument("--epochs", type=int, default=None, help="override CI_SCALE's 20")
    parser.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    args = parser.parse_args()
    torch.set_num_threads(4)
    spec = conv.CI_SCALE
    if args.epochs is not None:
        spec = dataclasses.replace(spec, epochs=args.epochs)
    results = []
    if args.part == "same_start":
        for optimizer in args.optimizers.split(","):
            results.append(same_start(spec, optimizer))
            print(json.dumps(results[-1]), flush=True)
    elif args.part == "seeds":
        results.append(seed_runs(spec, [int(s) for s in args.seeds.split(",")]))
        print(json.dumps(results[-1]), flush=True)
    else:
        results += cross(spec, [int(s) for s in args.seeds.split(",")])
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in results) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
