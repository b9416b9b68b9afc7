"""Pipeline runner: ingest, preprocess and train steps, and the serving context.

Counterpart of anime_recommendations_tpu/pipeline/runner.py. The steps log
the same artifacts, in the same store layout (pipeline/artifacts.py), as the
JAX pipeline, so a run written by either package serves in both:

  ingest      -> full_data_set.parquet, all_anime.csv, synopses.csv
  preprocess  -> preprocessed_stats.parquet
  train       -> anime_nn_model.npz (+ vocab.json), anime_nn_history.csv,
                 anime_weights.csv / user_weights.csv when
                 model.export_weight_csvs is set

Under torchrun, ``step_train`` trains on every rank through the routed
ShardedTrainer (parallel/), as the JAX runner does on a multi-device mesh;
rank 0 logs the artifacts. Not ported yet (ROADMAP.md Queue 1): the loss
plot, the recommend steps' CSV artifacts with assert_flow, and the
``pipeline`` subcommand. The weight CSVs use the clamped row normalization
(two_tower.normalized_tables): the reference's bare ``emb / norm`` mints
inf/NaN rows for rows decayed to zero (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import logging
from pathlib import Path

import pandas as pd
import torch.distributed as dist

from anime_recommendations_tpu_torch.config import Config
from anime_recommendations_tpu_torch.data.catalog import Catalog
from anime_recommendations_tpu_torch.data.dataset import train_holdout_split
from anime_recommendations_tpu_torch.data.vocab import Vocab, build_vocab, encode_frame
from anime_recommendations_tpu_torch.models.two_tower import (
    BUFFER_KEYS,
    PARAM_KEYS,
    TwoTower,
    params_from_numpy,
)
from anime_recommendations_tpu_torch.pipeline.artifacts import ArtifactStore
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.train.model_io import load_model

logger = logging.getLogger(__name__)


def latest_file(root: str | Path, name: str, filename: str | None = None) -> Path:
    """Path of ``filename`` (default: the artifact's only file) in the
    newest version of artifact ``name``."""
    return ArtifactStore(root).get(f"{name}:latest").file(filename)


def store_root(cfg: Config, run_dir: str | Path | None = None) -> Path:
    """The artifact store of a run, where PipelineRunner puts it."""
    return Path(run_dir or cfg.main.run_dir) / cfg.main.project_name / "artifacts"


def context_from_store(cfg: Config, run_dir: str | Path | None = None, *,
                       device, topk_kwargs: dict | None = None) -> RecContext:
    """The serving context of a run's latest model; ``topk_kwargs`` go to
    RecContext.build (e.g. ``{"exact_scan": True}``)."""
    root = store_root(cfg, run_dir)
    model = load_model(latest_file(root, "anime_nn_model.npz", "anime_nn_model.npz"),
                       device)
    vocab = Vocab.load(latest_file(root, "anime_nn_model.npz", "vocab.json"))
    clean = pd.read_parquet(latest_file(root, "preprocessed_stats.parquet"))
    catalog = Catalog.from_files(latest_file(root, "all_anime.csv"),
                                 latest_file(root, "synopses.csv"))
    return RecContext.build(
        model, vocab, catalog, encode_frame(clean, vocab), device=device,
        retrieval_dtype=cfg.similarity.retrieval_dtype, ann=cfg.similarity.ann,
        topk_kwargs=topk_kwargs,
    )


def _trimmed(model: TwoTower, n_users: int, n_anime: int) -> TwoTower:
    """``model`` with its tables cut to n_users and n_anime rows."""
    if model.user_emb.shape[0] == n_users and model.anime_emb.shape[0] == n_anime:
        return model
    arrays = {k: getattr(model, k).detach().cpu().numpy() for k in PARAM_KEYS + BUFFER_KEYS}
    arrays["user_emb"] = arrays["user_emb"][:n_users]
    arrays["anime_emb"] = arrays["anime_emb"][:n_anime]
    return params_from_numpy(arrays, model.user_emb.device)


class PipelineRunner:
    """The ported steps of a run under ``<run_dir>/<project_name>``, on ``device``."""

    def __init__(self, config: Config, run_dir: str | Path | None = None, *, device):
        self.cfg = config
        self._base = run_dir
        self.run_dir = Path(run_dir or config.main.run_dir) / config.main.project_name
        self.store = ArtifactStore(store_root(config, run_dir))
        self.device = device
        self._ctx: RecContext | None = None

    def step_ingest(self) -> None:
        from anime_recommendations_tpu_torch.data.ingest import load_raw

        raw = load_raw(self.cfg.data)
        self.store.log_frame(
            "full_data_set.parquet", raw.ratings,
            filename="full_data_set.parquet", type="raw_data",
            metadata={"source": raw.source, "rows": len(raw.ratings)},
        )
        self.store.log_frame(
            "all_anime.csv", raw.anime, filename="all_anime.csv",
            type="raw_data", metadata={"rows": len(raw.anime)},
        )
        self.store.log_frame(
            "synopses.csv", raw.synopses, filename="synopses.csv",
            type="raw_data", metadata={"rows": len(raw.synopses)},
        )

    def step_preprocess(self) -> None:
        from anime_recommendations_tpu_torch.data.preprocess import preprocess_ratings

        raw = pd.read_parquet(self.store.get("full_data_set.parquet:latest").file())
        clean, stats = preprocess_ratings(
            raw,
            num_reviews=self.cfg.data.num_reviews,
            drop_unwatched=self.cfg.data.drop_unwatched,
            drop_plan=self.cfg.data.drop_plan,
            half_watched=self.cfg.data.drop_half_watched,
        )
        self.store.log_frame(
            "preprocessed_stats.parquet", clean,
            filename="preprocessed_stats.parquet", type="preprocessed_data",
            metadata={
                "rows_in": stats.rows_in, "rows_out": stats.rows_out,
                "n_users": stats.n_users, "n_anime": stats.n_anime,
                "min_rating": stats.min_rating, "max_rating": stats.max_rating,
            },
        )

    def step_train(self):
        """Train on the latest preprocessed data, log the model, vocab,
        history and (optionally) weight CSVs. Returns the TrainResult.

        The routed ShardedTrainer trains when a process group exists (torchrun
        started the process: parallel.distributed.initialize) and spans more
        than one rank, or ``parallel.capacity`` is set; the one-device Trainer
        otherwise."""
        from anime_recommendations_tpu_torch.models.two_tower import normalized_tables
        from anime_recommendations_tpu_torch.parallel.distributed import initialize
        from anime_recommendations_tpu_torch.train.model_io import save_model
        from anime_recommendations_tpu_torch.train.trainer import Trainer

        initialize(self.device)   # a plain single process: nothing to do
        mc, pc = self.cfg.model, self.cfg.parallel
        sharded = dist.is_initialized() and (dist.get_world_size() > 1 or pc.capacity != 0)
        clean = pd.read_parquet(
            self.store.get("preprocessed_stats.parquet:latest").file())
        vocab = build_vocab(clean)
        encoded = encode_frame(clean, vocab)[["user", "anime", "rating"]]
        train, holdout = train_holdout_split(
            encoded, test_size=min(mc.test_size, max(len(encoded) // 10, 1)),
            shuffle_seed=mc.vocab_shuffle_seed,
        )
        common = dict(
            embedding_size=mc.embedding_size,
            l2_reg_factor=mc.l2_reg_factor,
            batch_size=min(mc.batch_size, max(len(train), 1)),
            epochs=mc.epochs,
            start_lr=mc.start_lr, max_lr=mc.max_lr, min_lr=mc.min_lr,
            rampup_epochs=mc.rampup_epochs, sustain_epochs=mc.sustain_epochs,
            exp_decay=mc.exp_decay, patience=mc.patience,
            seed=self.cfg.main.random_seed,
            checkpoint_dir=str(self.run_dir / "checkpoints"),
            log_fn=logger.info,
            device_loop=mc.device_loop, optimizer=mc.optimizer, device=self.device,
        )
        if sharded:
            from anime_recommendations_tpu_torch.parallel.trainer import ShardedTrainer

            trainer = ShardedTrainer(
                data_axis=pc.data_axis, model_axis=pc.model_axis,
                shard_anime=pc.shard_anime_table, routing=pc.routing,
                capacity=pc.capacity or None, **common)
        else:
            trainer = Trainer(**common)
        result = trainer.fit(train, holdout, vocab.n_users, vocab.n_anime,
                             resume=self.cfg.main.resume_training)
        # The sharded trainer's tables come back on every rank, padded to the
        # world size; rank 0 logs them without the padding.
        model = _trimmed(result.state.model, vocab.n_users, vocab.n_anime)
        if sharded and dist.get_rank() != 0:
            return result

        tmp = self.run_dir / "tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        model_path = save_model(tmp / "anime_nn_model", model)
        vocab_path = tmp / "vocab.json"
        vocab.save(vocab_path)
        self.store.log(
            "anime_nn_model.npz",
            files={"anime_nn_model.npz": model_path, "vocab.json": vocab_path},
            type="model",
            metadata={
                "Loss function": mc.model_loss,
                "Optimizer": mc.optimizer_display,
                "Activation function": mc.activation_function,
                "Start learning rate": mc.start_lr,
                "Min learning rate": mc.min_lr,
                "Max learning rate": mc.max_lr,
                "Batch size": mc.batch_size,
                "L2 regularization factor": mc.l2_reg_factor,
                "best_epoch": result.best_epoch,
                "best_val_loss": result.best_val_loss,
                "epochs_run": result.epochs_run,
                "examples_per_sec": result.examples_per_sec,
                "n_users": vocab.n_users,
                "n_anime": vocab.n_anime,
            },
        )
        # The history CSV keeps the golden header (",loss,mse,val_loss,val_mse,lr").
        self.store.log_frame(
            "anime_nn_history.csv", result.history,
            filename="anime_nn_history.csv", type="history_csv", index=True,
            metadata={"best_epoch": result.best_epoch},
        )
        if mc.export_weight_csvs:
            anime_n, user_n = (t.cpu().numpy() for t in normalized_tables(model))
            self.store.log_frame(
                "anime_weights.csv", pd.DataFrame(anime_n),
                filename="anime_weights.csv", type="weights_csv",
                metadata={"rows": vocab.n_anime},
            )
            self.store.log_frame(
                "user_weights.csv", pd.DataFrame(user_n),
                filename="user_weights.csv", type="weights_csv",
                metadata={"rows": vocab.n_users},
            )
        self._ctx = None  # the next context() serves the new model
        return result

    def context(self) -> RecContext:
        """The serving context of the run's latest trained model."""
        if self._ctx is None:
            self._ctx = context_from_store(self.cfg, self._base, device=self.device)
        return self._ctx
