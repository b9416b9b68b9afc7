"""Accuracy harness: planted-teacher convergence at reference scale.

Counterpart of anime_recommendations_tpu/train/convergence.py, on the port's
own data, trainer and scoring modules. Synthetic ratings come from a
PLANTED low-rank teacher (data/synthetic.py) at the reference's trained
scale: a 91,641 x 128 user table, a 17,560 x 128 anime table and 7M
interactions, trained with the reference's hyperparameters (D = 128, batch
10,000, Adam, BCE loss, the trapezoid LR schedule, <= 20 epochs, patience
3, a 10,000-row holdout). Because the teacher is known, two claims are
measured rather than asserted:

  1. CONVERGENCE: the best validation MSE against the Monte-Carlo estimate
     of the generative process's noise floor (the MSE of the Bayes-optimal
     predictor E[rating | user, anime]), as ``floor_ratio``;
  2. RANKING RECOVERY: model_recs' scoring path (ops/scoring) recovers the
     teacher's top-k unwatched anime for the heaviest raters.

The head is a cosine (Dot(normalize=True)): a user's ranking can depend only
on the direction of each item vector, while the teacher ranks by the
unnormalized u . v. Recovery is therefore measured against two oracles:
  * ``topk_overlap``: model top-k vs the raw teacher's top-k, beside
    ``arch_ceiling_overlap``, the same for the teacher's normalized item
    factors (the best any cosine two-tower can do);
  * ``expressible_overlap``: model top-k vs that normalized-factor oracle;
  * ``topk_recall``: the share of the raw teacher's top-k found in the
    model's top-``recall_K``, beside ``recall_ceiling``, the oracle's.

As in the JAX package, the >= 400-ratings user filter is skipped
(num_reviews = 0): the reference's trained table is already the filtered
population. Initialization and the per-epoch shuffle come from torch
generators, not JAX's PRNG, so a run is close to the JAX package's records
(artifacts/convergence/, which this module never writes), not equal to them.

    python -m anime_recommendations_tpu_torch.train.convergence --scale ci --device cpu
    python -m anime_recommendations_tpu_torch.train.convergence --scale reference \\
        --optimizer fused_adam                      # on the card (--device cuda)

Results go to ``build/convergence_torch/`` (history_<tag>.csv and
result_<tag>.json, the JAX harness's names and keys) unless ``--out`` says
otherwise.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from anime_recommendations_tpu_torch.data import synthetic
from anime_recommendations_tpu_torch.data.dataset import RatingsDataset, train_holdout_split
from anime_recommendations_tpu_torch.data.preprocess import drop_useless, scale_ratings
from anime_recommendations_tpu_torch.data.vocab import Vocab, build_vocab, encode_frame
from anime_recommendations_tpu_torch.models.two_tower import TwoTower
from anime_recommendations_tpu_torch.ops.scoring import score_all_items
from anime_recommendations_tpu_torch.train.trainer import OPTIMIZERS, Trainer

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "convergence_torch"


@dataclass(frozen=True)
class ConvergenceSpec:
    # Data scale (reference: 91,641 users x 17,560 anime x 7M rows).
    n_users: int
    n_anime: int
    n_interactions: int
    latent_dim: int = 16
    noise: float = 0.35
    data_seed: int = 0
    # Reference training hyperparameters.
    embedding_size: int = 128
    batch_size: int = 10_000
    epochs: int = 20
    test_size: int = 10_000
    train_seed: int = 0
    optimizer: str = "adam"
    device_loop: bool = True
    # LR schedule: the reference's values; CI_SCALE raises them, because its
    # step count is ~50x smaller and Adam's movement is ~ lr * steps.
    start_lr: float = 1e-5
    max_lr: float = 5e-5
    min_lr: float = 1e-5
    # Evaluation.
    n_probe_users: int = 100    # heaviest raters; tail users are under-observed
    k: int = 10                 # model_recs default top-10
    recall_K: int = 200         # candidate-list size for the recall claim
    mc_draws: int = 256         # noise-floor Monte Carlo draws per holdout pair
    # "cosine" = the reference's head. "dot" = the unnormalized-dot
    # diagnostic; per-step trainer path, no ranking-recovery metrics.
    merge: str = "cosine"


REFERENCE_SCALE = ConvergenceSpec(
    n_users=91_641, n_anime=17_560, n_interactions=7_000_000
)
# Small enough for a CPU, large enough that the floor and overlap claims
# bind: ~130 ratings per user; batch 2,000 -> ~100 steps per epoch.
CI_SCALE = ConvergenceSpec(
    n_users=1_500, n_anime=400, n_interactions=200_000,
    test_size=5_000, n_probe_users=50, epochs=20, batch_size=2_000,
    start_lr=2e-4, max_lr=1e-3, min_lr=2e-4, recall_K=50,
)


@dataclass
class ConvergenceReport:
    spec: ConvergenceSpec
    history: pd.DataFrame
    best_epoch: int
    best_val_loss: float
    best_val_mse: float
    noise_floor_mse: float
    floor_ratio: float          # best_val_mse / noise_floor_mse
    topk_overlap: float         # mean |model top-k & raw-teacher top-k| / k
    arch_ceiling_overlap: float  # normalized-factor oracle vs raw teacher
    expressible_overlap: float   # model vs the expressible (cosine) oracle
    topk_recall: float           # raw-teacher top-k found in model top-K
    recall_ceiling: float        # same, for the expressible oracle
    n_users_trained: int
    n_anime_trained: int
    examples_per_sec: float
    train_seconds: float

    def summary(self) -> dict:
        d = asdict(self)
        d.pop("history")
        d["spec"] = asdict(self.spec)
        return d


def _teacher_rows(vocab: Vocab) -> tuple[np.ndarray, np.ndarray]:
    """Planted-factor rows of the vocab's dense rows, through the raw ids'
    affine layout (synthetic.USER_ID_STRIDE etc.)."""
    u = (vocab.user_ids - synthetic.USER_ID_BASE) // synthetic.USER_ID_STRIDE
    a = (vocab.anime_ids - synthetic.ANIME_ID_BASE) // synthetic.ANIME_ID_STRIDE
    return u.astype(np.int64), a.astype(np.int64)


def _scaled_rating_draws(
    affinity: np.ndarray, lo: float, hi: float, noise: float,
    n_draws: int, rng: np.random.Generator,
) -> np.ndarray:
    """[P, n_draws] samples of the preprocessed (min-max scaled) rating the
    teacher emits for pairs of the given affinities: the generative chain of
    synthetic.synth_ratings and preprocess.scale_ratings."""
    eps = rng.normal(0.0, noise, size=(len(affinity), n_draws))
    score = 1.0 / (1.0 + np.exp(-(affinity[:, None] * synthetic.TEACHER_GAIN + eps)))
    rating = np.clip(np.round(1 + 9 * score), 1, 10)
    return (rating - lo) / max(hi - lo, 1e-12)


def noise_floor_mse(
    holdout: RatingsDataset,
    vocab: Vocab,
    U: np.ndarray,
    V: np.ndarray,
    lo: float,
    hi: float,
    noise: float,
    n_draws: int = 256,
    seed: int = 123,
) -> float:
    """MSE of the Bayes-optimal predictor E[y | u, a] on the holdout pairs,
    estimated by Monte Carlo over the teacher's noise and rounding. No model
    does better in expectation."""
    u_rows, a_rows = _teacher_rows(vocab)
    affinity = np.einsum("ij,ij->i", U[u_rows[holdout.users]], V[a_rows[holdout.anime]])
    rng = np.random.default_rng(seed)
    draws = _scaled_rating_draws(affinity, lo, hi, noise, n_draws, rng)
    y_hat = draws.mean(axis=1)
    return float(np.mean((holdout.ratings.astype(np.float64) - y_hat) ** 2))


@dataclass(frozen=True)
class RecoveryMetrics:
    topk_overlap: float
    arch_ceiling_overlap: float
    expressible_overlap: float
    topk_recall: float
    recall_ceiling: float


def topk_recovery(
    model: TwoTower,
    vocab: Vocab,
    encoded: pd.DataFrame,
    U: np.ndarray,
    V: np.ndarray,
    n_probe_users: int,
    k: int,
    recall_K: int,
) -> RecoveryMetrics:
    """Ranking-recovery metrics over the ``n_probe_users`` heaviest raters.

    The model's scores come through model_recs' scoring path
    (ops/scoring.score_all_items, eval-mode head). Three rankings per probe
    user, the watched anime masked out of each: the raw teacher ``V @ U[u]``,
    the expressible oracle ``(V / ||V||) @ U[u]``, and the model's."""
    u_rows, a_rows = _teacher_rows(vocab)
    V_vocab = V[a_rows]  # teacher rows in vocab order
    V_unit = V_vocab / np.linalg.norm(V_vocab, axis=1, keepdims=True)
    recall_K = min(recall_K, V_vocab.shape[0] - 1)

    counts = encoded["user"].value_counts()
    probes = counts.index.to_numpy()[:n_probe_users]
    by_user = encoded.groupby("user")["anime"]

    o_mt, o_ot, o_mo, r_m, r_o = [], [], [], [], []
    for u_dense in probes:
        watched = by_user.get_group(u_dense).to_numpy()
        t = V_vocab @ U[u_rows[u_dense]]
        o = V_unit @ U[u_rows[u_dense]]
        m = score_all_items(model, int(u_dense)).double().cpu().numpy()
        t[watched] = o[watched] = m[watched] = -np.inf
        top_t = set(np.argpartition(-t, k)[:k].tolist())
        top_o = set(np.argpartition(-o, k)[:k].tolist())
        top_m = set(np.argpartition(-m, k)[:k].tolist())
        big_m = set(np.argpartition(-m, recall_K)[:recall_K].tolist())
        big_o = set(np.argpartition(-o, recall_K)[:recall_K].tolist())
        o_mt.append(len(top_m & top_t) / k)
        o_ot.append(len(top_o & top_t) / k)
        o_mo.append(len(top_m & top_o) / k)
        r_m.append(len(big_m & top_t) / k)
        r_o.append(len(big_o & top_t) / k)
    return RecoveryMetrics(
        topk_overlap=float(np.mean(o_mt)),
        arch_ceiling_overlap=float(np.mean(o_ot)),
        expressible_overlap=float(np.mean(o_mo)),
        topk_recall=float(np.mean(r_m)),
        recall_ceiling=float(np.mean(r_o)),
    )


def run_convergence(
    spec: ConvergenceSpec, verbose: bool = True, log_fn=print,
    device: str | torch.device = "cuda",
) -> ConvergenceReport:
    """Make the data, train with ``spec`` on ``device`` and measure."""
    t0 = time.perf_counter()
    if verbose:
        log_fn(
            f"[convergence] generating {spec.n_interactions:,} interactions "
            f"({spec.n_users:,} users x {spec.n_anime:,} anime, "
            f"latent {spec.latent_dim}, noise {spec.noise})"
        )
    df = synthetic.synth_ratings(
        n_users=spec.n_users, n_anime=spec.n_anime, n_interactions=spec.n_interactions,
        latent_dim=spec.latent_dim, seed=spec.data_seed, noise=spec.noise,
    )
    U, V, _ = synthetic.planted_factors(spec.n_users, spec.n_anime, spec.latent_dim,
                                        spec.data_seed)
    # The preprocess chain without the 400-ratings filter; lo and hi taken
    # from the filtered, unscaled frame as scale_ratings sees them.
    df = drop_useless(df, num_reviews=0)
    raw = df["rating"].to_numpy()
    lo, hi = float(raw.min()), float(raw.max())
    df = scale_ratings(df)

    vocab = build_vocab(df)
    encoded = encode_frame(df, vocab)
    train, holdout = train_holdout_split(encoded, test_size=spec.test_size)
    data_seconds = time.perf_counter() - t0
    if verbose:
        log_fn(f"[convergence] data made and preprocessed on the host in {data_seconds:.1f} s")

    trainer = Trainer(
        embedding_size=spec.embedding_size, batch_size=spec.batch_size, epochs=spec.epochs,
        start_lr=spec.start_lr, max_lr=spec.max_lr, min_lr=spec.min_lr,
        seed=spec.train_seed, optimizer=spec.optimizer,
        device_loop=spec.device_loop and spec.merge == "cosine", merge=spec.merge,
        verbose=verbose, log_fn=log_fn, device=device,
    )
    fit_t0 = time.perf_counter()
    result = trainer.fit(train, holdout, vocab.n_users, vocab.n_anime)
    train_seconds = time.perf_counter() - fit_t0

    floor = noise_floor_mse(holdout, vocab, U, V, lo, hi, spec.noise, n_draws=spec.mc_draws)
    best_val_mse = float(result.history["val_mse"].iloc[result.best_epoch])
    if spec.merge == "cosine":
        rec = topk_recovery(result.state.model, vocab, encoded, U, V, spec.n_probe_users,
                            spec.k, spec.recall_K)
    else:
        nan = float("nan")
        rec = RecoveryMetrics(nan, nan, nan, nan, nan)
    report = ConvergenceReport(
        spec=spec,
        history=result.history,
        best_epoch=result.best_epoch,
        best_val_loss=result.best_val_loss,
        best_val_mse=best_val_mse,
        noise_floor_mse=floor,
        floor_ratio=best_val_mse / floor,
        topk_overlap=rec.topk_overlap,
        arch_ceiling_overlap=rec.arch_ceiling_overlap,
        expressible_overlap=rec.expressible_overlap,
        topk_recall=rec.topk_recall,
        recall_ceiling=rec.recall_ceiling,
        n_users_trained=vocab.n_users,
        n_anime_trained=vocab.n_anime,
        examples_per_sec=result.examples_per_sec,
        train_seconds=train_seconds,
    )
    if verbose:
        log_fn(
            f"[convergence] best val_mse {best_val_mse:.5f} (epoch {report.best_epoch}) vs "
            f"noise floor {floor:.5f} -> ratio {report.floor_ratio:.3f}; top-{spec.k} "
            f"overlap {rec.topk_overlap:.3f} (arch ceiling {rec.arch_ceiling_overlap:.3f}, "
            f"vs expressible oracle {rec.expressible_overlap:.3f}); recall@{spec.recall_K} "
            f"{rec.topk_recall:.3f} (ceiling {rec.recall_ceiling:.3f}); total "
            f"{time.perf_counter() - t0:.0f}s"
        )
    return report


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scale", choices=["reference", "ci"], default="reference")
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--optimizer", default="adam", choices=list(OPTIMIZERS))
    p.add_argument("--merge", default="cosine", choices=["cosine", "dot"])
    p.add_argument("--epochs", type=int, default=None,
                   help="diagnostic override of the epoch budget")
    p.add_argument("--max-lr", type=float, default=None,
                   help="diagnostic override of the peak LR")
    p.add_argument("--tag", default=None,
                   help="artifact tag override (for diagnostic variants)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    spec = REFERENCE_SCALE if args.scale == "reference" else CI_SCALE
    over = {"optimizer": args.optimizer, "merge": args.merge}
    if args.epochs is not None:
        over["epochs"] = args.epochs
    if args.max_lr is not None:
        over["max_lr"] = args.max_lr
    spec = ConvergenceSpec(**{**asdict(spec), **over})
    report = run_convergence(spec, device=args.device)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tag = args.tag or (args.scale if args.optimizer == "adam" else
                       f"{args.scale}_{args.optimizer}")
    # The reference's history header: ",loss,mse,val_loss,val_mse,lr".
    report.history.to_csv(out / f"history_{tag}.csv")
    summary = _strict_json(report.summary())
    (out / f"result_{tag}.json").write_text(json.dumps(summary, indent=2, allow_nan=False))
    print(json.dumps(summary, allow_nan=False))


def _strict_json(obj):
    """RFC 8259-strict JSON values: NaN and Inf (a probe that does not apply
    to the run) become null, numpy scalars plain floats."""
    if isinstance(obj, dict):
        return {k: _strict_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_strict_json(v) for v in obj]
    if isinstance(obj, (int, str, bool)) or obj is None:
        return obj
    v = float(obj)
    return None if not math.isfinite(v) else v


if __name__ == "__main__":
    main()
