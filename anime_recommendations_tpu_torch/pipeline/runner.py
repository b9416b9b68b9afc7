"""Pipeline runner: the eight steps of a run, with the artifacts they pass on.

Counterpart of anime_recommendations_tpu/pipeline/runner.py. The steps log
the same artifacts, in the same store layout (pipeline/artifacts.py), as the
JAX pipeline, so a run written by either package goes on and serves in the
other:

  ingest        -> full_data_set.parquet, all_anime.csv, synopses.csv
  preprocess    -> preprocessed_stats.parquet
  train         -> anime_nn_model.npz (+ vocab.json), anime_nn_history.csv,
                   neural_network_loss.png, anime_weights.csv and
                   user_weights.csv when model.export_weight_csvs is set
  similar_anime -> <cleaned query>.csv
  similar_users -> similar_users.csv + ID_used.csv (the flow user)
  user_prefs    -> user_prefs.csv + favorite_genres.png,
                   favorite_source_material.png
  user_recs     -> user_recs.csv + user_recs_preferences.csv +
                   recs_favorite_genres.png, recs_favorite_sources.png
  model_recs    -> model_recs.csv

The steps after similar_users take their user from ID_used.csv when their
``*_from_flow`` key is set; user_recs first checks (assert_flow) that the ID
artifact and the metadata of similar_users.csv and user_prefs.csv name that
user and that similar_users found users.recs_n_sim_ID users, and raises
FlowError when main.raise_flow_error is set. Random picks (a title, a user)
draw from numpy.random.default_rng(main.random_seed) in the JAX runner's
order, so one seed picks the same in both packages.

run() writes timings.json: each step's wall seconds under its name, as the
JAX runner writes them, and ``step_timer``, utils/profiling.StepTimer's
summary of the steps and of sections inside them (``context``: the
context build; ``train.fit``; ``train.weight_csvs``).

Under torchrun, ``step_train`` trains on every rank through the
ShardedTrainer (parallel/), as the JAX runner does on a multi-device mesh,
and rank 0 logs the artifacts; run() runs every other step on rank 0 only,
and the other ranks wait for its ingest and preprocess at a barrier before
training.

Departures: on a host without matplotlib, the PNG artifacts are skipped
(each step logs one warning naming them) and every other artifact is
written. The weight CSVs use the clamped row normalization
(two_tower.normalized_tables): the reference's bare ``emb / norm`` mints
inf/NaN rows for rows decayed to zero (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import json
import logging
import time
from collections.abc import Callable
from pathlib import Path

import numpy as np
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
from anime_recommendations_tpu_torch.recommend.clouds import (
    genre_cloud,
    have_matplotlib,
    source_cloud,
)
from anime_recommendations_tpu_torch.recommend.context import RecContext
from anime_recommendations_tpu_torch.recommend.model_recs import model_recs
from anime_recommendations_tpu_torch.recommend.similar_anime import similar_anime
from anime_recommendations_tpu_torch.recommend.similar_users import similar_users
from anime_recommendations_tpu_torch.recommend.user_prefs import user_prefs
from anime_recommendations_tpu_torch.recommend.user_recs import user_recs
from anime_recommendations_tpu_torch.train.model_io import load_model
from anime_recommendations_tpu_torch.utils.profiling import StepTimer

logger = logging.getLogger(__name__)

STEPS = (
    "ingest",
    "preprocess",
    "train",
    "similar_anime",
    "similar_users",
    "user_prefs",
    "user_recs",
    "model_recs",
)


class FlowError(ValueError):
    """Cross-step user-ID inconsistency (assert_flow failure)."""


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
    RecContext.build (e.g. ``{"exact_scan": True}``). The model is loaded
    on the host: RecContext.build streams its tables to ``device`` in
    chunks of rows, so the device holds one copy of each table and none of
    the model's own."""
    root = store_root(cfg, run_dir)
    model = load_model(latest_file(root, "anime_nn_model.npz", "anime_nn_model.npz"),
                       "cpu")
    vocab = Vocab.load(latest_file(root, "anime_nn_model.npz", "vocab.json"))
    clean = pd.read_parquet(latest_file(root, "preprocessed_stats.parquet"))
    catalog = Catalog.from_files(latest_file(root, "all_anime.csv"),
                                 latest_file(root, "synopses.csv"))
    return RecContext.build(
        model, vocab, catalog, encode_frame(clean, vocab), device=device,
        retrieval_dtype=cfg.similarity.retrieval_dtype, ann=cfg.similarity.ann,
        ann_probes=cfg.similarity.ann_probes, topk_kwargs=topk_kwargs,
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
    """The steps of a run under ``<run_dir>/<project_name>``, on ``device``."""

    def __init__(self, config: Config, run_dir: str | Path | None = None, *, device):
        self.cfg = config
        self._base = run_dir
        self.run_dir = Path(run_dir or config.main.run_dir) / config.main.project_name
        self.store = ArtifactStore(store_root(config, run_dir))
        self.device = device
        self._ctx: RecContext | None = None
        self._rng = np.random.default_rng(config.main.random_seed)
        self.timer = StepTimer()

    # ---- orchestration --------------------------------------------------------

    def run(self, steps: list[str] | None = None) -> dict[str, float]:
        """Run ``steps`` (default main.execute_steps) in order; returns each
        step's wall seconds and writes them to timings.json, with the
        StepTimer summary of this call under ``step_timer``."""
        from anime_recommendations_tpu_torch.parallel.distributed import initialize

        steps = list(steps or self.cfg.main.execute_steps)
        unknown = [s for s in steps if s not in STEPS]
        if unknown:
            raise ValueError(f"Unknown steps {unknown}; choose from {STEPS}")
        initialize(self.device)   # a plain single process: nothing to do
        rank = dist.get_rank() if dist.is_initialized() else 0
        self.timer = StepTimer()
        timings: dict[str, float] = {}
        for step in steps:
            if step == "train" and dist.is_initialized():
                dist.barrier()    # rank 0's ingest and preprocess are done
            elif step != "train" and rank != 0:
                continue
            logger.info("=== step %s ===", step)
            t0 = time.perf_counter()
            with self.timer.section(step):
                getattr(self, f"step_{step}")()
            timings[step] = time.perf_counter() - t0
            logger.info("step %s done in %.2fs", step, timings[step])
        if rank == 0:
            self.run_dir.mkdir(parents=True, exist_ok=True)
            record = dict(timings, step_timer=self.timer.summary())
            (self.run_dir / "timings.json").write_text(json.dumps(record, indent=2))
        return timings

    def _log_pngs(self, step: str, renderers: dict[str, Callable[[], str]],
                  metadata: dict | None = None) -> None:
        """Render and log each PNG artifact (name -> a function that draws it
        and returns its path). Without matplotlib, log one warning naming
        them and skip them all."""
        if not have_matplotlib():
            logger.warning("matplotlib is not installed: step %s skips the PNG artifacts %s",
                           step, ", ".join(renderers))
            return
        for name, render in renderers.items():
            path = Path(render())
            self.store.log(name, files={path.name: path}, type="png", metadata=metadata)

    def _tmp(self) -> Path:
        tmp = self.run_dir / "tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        return tmp

    # ---- steps ----------------------------------------------------------------

    def step_ingest(self) -> None:
        from anime_recommendations_tpu_torch.data.ingest import load_raw

        raw = load_raw(self.cfg.data, cache_dir=self.run_dir / "cache")
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
        history, loss plot and (optionally) weight CSVs. Returns the
        TrainResult.

        The sharded ShardedTrainer trains when a process group exists (torchrun
        started the process: parallel.distributed.initialize) and spans more
        than one rank, or ``parallel.capacity``, ``parallel.routing=psum`` or
        ``parallel.shard_anime_table`` is set; the one-device Trainer
        otherwise."""
        from anime_recommendations_tpu_torch.models.two_tower import normalized_tables
        from anime_recommendations_tpu_torch.parallel.distributed import initialize
        from anime_recommendations_tpu_torch.train.model_io import save_model
        from anime_recommendations_tpu_torch.train.trainer import Trainer

        initialize(self.device)   # a plain single process: nothing to do
        mc, pc = self.cfg.model, self.cfg.parallel
        sharded = dist.is_initialized() and (
            dist.get_world_size() > 1 or pc.capacity != 0 or pc.routing != "alltoall"
            or pc.shard_anime_table)
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
        with self.timer.section("train.fit"):
            result = trainer.fit(train, holdout, vocab.n_users, vocab.n_anime,
                                 resume=self.cfg.main.resume_training)
        # The sharded trainer's tables come back on every rank, padded to the
        # world size; rank 0 logs them without the padding.
        model = _trimmed(result.state.model, vocab.n_users, vocab.n_anime)
        if sharded and dist.get_rank() != 0:
            return result

        tmp = self._tmp()
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
            with self.timer.section("train.weight_csvs"):
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
        self._log_pngs("train", {"neural_network_loss.png":
                                 lambda: _loss_plot(result.history, tmp)})
        self._ctx = None  # the next context() serves the new model
        return result

    # ---- retrieval context ----------------------------------------------------

    def context(self) -> RecContext:
        """The serving context of the run's latest trained model."""
        if self._ctx is None:
            with self.timer.section("context"):
                self._ctx = context_from_store(self.cfg, self._base, device=self.device)
        return self._ctx

    # ---- retrieval steps ------------------------------------------------------

    def _is_synthetic_run(self) -> bool:
        """True when ingest made the synthetic dataset (its artifact records
        source=synthetic): configured titles and user ids name the real
        MyAnimeList data and do not resolve in a synthetic catalog. A local
        or downloaded run ("local", "download") keeps them, as in JAX."""
        try:
            art = self.store.get("full_data_set.parquet:latest")
        except FileNotFoundError:
            return False
        return art.metadata.get("source") == "synthetic"

    def step_similar_anime(self) -> None:
        sc = self.cfg.similarity
        ctx = self.context()
        name = ctx.random_anime_name(self._rng) if sc.random_anime else sc.anime_query
        if not sc.random_anime and self._is_synthetic_run():
            try:
                ctx.catalog.resolve_query(name)
            except KeyError:
                name = ctx.random_anime_name(self._rng)
                logger.warning("configured anime_query %r not in the synthetic catalog; "
                               "querying random anime %r instead", sc.anime_query, name)
        frame, fn, _ = similar_anime(
            ctx, name, count=sc.a_query_number,
            types=list(sc.types) if sc.spec_types else None,
            genres=list(sc.anime_rec_genres) if sc.an_spec_genres else None,
        )
        self.store.log_frame(fn, frame, filename=fn, type="csv",
                             metadata={"Queried anime": name, "Filename": fn})

    def step_similar_users(self) -> None:
        uc = self.cfg.users
        ctx = self.context()
        user_id = ctx.random_user(self._rng) if uc.sim_random_user else int(uc.sim_user_query)
        if (not uc.sim_random_user
                and ctx.vocab.encode_users(np.asarray([user_id]))[0] < 0
                and self._is_synthetic_run()):
            user_id = ctx.random_user(self._rng)
            logger.warning("configured sim_user_query %s not in the synthetic vocab; "
                           "querying random user %s instead", uc.sim_user_query, user_id)
        frame, fn, user_id = similar_users(ctx, user_id, n_users=uc.id_query_number,
                                           num_faves=uc.num_faves, TV_only=uc.TV_only)
        self.store.log_frame(
            "similar_users.csv", frame, filename=fn, type="csv",
            metadata={"Queried user": int(user_id), "Filename": fn,
                      "num_sim_users": uc.id_query_number},
        )
        self.store.log_frame(
            "ID_used.csv", pd.DataFrame([int(user_id)], columns=["User_ID"]),
            filename=f"{user_id}.csv", type="csv", metadata={"Queried user": int(user_id)},
        )

    def _flow_user(self) -> int:
        return int(pd.read_csv(self.store.get("ID_used.csv:latest").file()).values[0][0])

    def _select_user(self, from_flow: bool, from_conf: bool, conf_id: int) -> int:
        """The reference's precedence: the flow artifact, then the config,
        then a random user."""
        if from_flow:
            return self._flow_user()
        if from_conf:
            return int(conf_id)
        return self.context().random_user(self._rng)

    def _log_clouds(self, step, prefs, user, names, metadata, **size) -> None:
        """The genre and source clouds of ``prefs`` as the PNG artifacts
        ``names`` (genre's, source's); ``size``: width and height."""
        tmp = self._tmp()
        genre, source = names
        self._log_pngs(step, {
            genre: lambda: genre_cloud(prefs.genre_frequencies, user, tmp, fn=genre, **size),
            source: lambda: source_cloud(prefs.source_frequencies, user, tmp, fn=source, **size),
        }, metadata)

    def step_user_prefs(self) -> None:
        uc = self.cfg.users
        ctx = self.context()
        user = self._select_user(uc.prefs_from_flow, uc.prefs_local_user, uc.prefs_user_query)
        prefs = user_prefs(ctx, user, percentile=uc.favorite_percentile)
        fn = f"User_ID_{user}_user_prefs.csv"
        self.store.log_frame("user_prefs.csv", prefs.merged, filename=fn, type="csv",
                             index=True, metadata={"ID": int(user), "Filename": fn})
        self._log_clouds("user_prefs", prefs, user,
                         ("favorite_genres.png", "favorite_source_material.png"),
                         {"ID": int(user)}, width=uc.cloud_width, height=uc.cloud_height)

    def assert_flow(self, user: int) -> bool:
        """Cross-step ID consistency: ``user``, the ID artifact and the users
        that similar_users.csv and user_prefs.csv name agree, and
        similar_users found users.recs_n_sim_ID users."""
        id_art = self._flow_user()
        sim_art = self.store.get("similar_users.csv:latest")
        sim_id = int(sim_art.metadata["Queried user"])
        n_sim = int(sim_art.metadata["num_sim_users"])
        prefs_id = int(self.store.get("user_prefs.csv:latest").metadata["ID"])
        ok = user == id_art == sim_id == prefs_id and n_sim == int(self.cfg.users.recs_n_sim_ID)
        if not ok:
            logger.warning("assert_flow failed: input=%s id_artifact=%s sim=%s prefs=%s "
                           "n_sim=%s expected_n_sim=%s", user, id_art, sim_id, prefs_id,
                           n_sim, self.cfg.users.recs_n_sim_ID)
        return ok

    def step_user_recs(self) -> None:
        uc = self.cfg.users
        ctx = self.context()
        user = self._select_user(uc.ID_recs_from_flow, uc.recs_ID_from_conf, uc.user_recs_query)
        if uc.ID_recs_from_flow:
            sim_frame = pd.read_csv(self.store.get("similar_users.csv:latest").file())
            if not self.assert_flow(user):
                if self.cfg.main.raise_flow_error:
                    raise FlowError("MLflow IDs were inconsistent")
                logger.warning("IDs inconsistent; user_recs step skipped")
                return
            prefs_frame = pd.read_csv(self.store.get("user_prefs.csv:latest").file(),
                                      index_col=0)
        else:
            sim_frame, _, _ = similar_users(ctx, user, n_users=uc.recs_n_sim_ID,
                                            num_faves=uc.num_faves, TV_only=uc.TV_only)
            prefs_frame = None
        frame, fn = user_recs(
            ctx, user, sim_frame["similar_users"].to_numpy(), n=uc.user_num_recs,
            percentile=uc.favorite_percentile,
            genres=list(uc.ID_rec_genres) if uc.ID_spec_genres else None,
            user_pref=prefs_frame,
        )
        self.store.log_frame(
            "user_recs.csv", frame, filename=fn, type="csv",
            metadata={"Queried user": int(user), "Flow ID used": bool(uc.ID_recs_from_flow),
                      "Filename": fn},
        )
        prefs = user_prefs(ctx, user, percentile=uc.favorite_percentile)
        self.store.log_frame(
            "user_recs_preferences.csv", prefs.merged,
            filename=f"User_ID_{user}_user_recs_preferences.csv", type="csv",
            metadata={"Queried user": int(user)},
        )
        self._log_clouds("user_recs", prefs, user,
                         ("recs_favorite_genres.png", "recs_favorite_sources.png"),
                         {"Queried user": int(user)})

    def step_model_recs(self) -> None:
        mrc = self.cfg.model_recs
        ctx = self.context()
        user = self._select_user(mrc.model_ID_flow, mrc.model_ID_conf, mrc.model_user_query)
        frame, fn = model_recs(
            ctx, user, n_recs=mrc.model_num_recs,
            types=list(mrc.anime_types) if mrc.specify_types else None,
            genres=list(mrc.model_genres) if mrc.specify_genres else None,
            min_score=mrc.min_score, max_score=mrc.max_score,
        )
        self.store.log_frame("model_recs.csv", frame, filename=fn, type="csv",
                             metadata={"Queried user": int(user), "Filename": fn})


def _loss_plot(history: pd.DataFrame, tmp: Path) -> Path:
    """neural_network_loss.png: training and validation loss by epoch,
    without each series' last two points (as the reference draws it, when
    there are more than two)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cut = slice(None, -2) if len(history) > 2 else slice(None)
    fig, ax = plt.subplots()
    ax.plot(history["loss"].iloc[cut])
    ax.plot(history["val_loss"].iloc[cut])
    ax.set_title("model loss")
    ax.set_ylabel("loss")
    ax.set_xlabel("epoch")
    ax.legend(["train", "test"], loc="upper left")
    path = tmp / "neural_network_loss.png"
    fig.savefig(path)
    plt.close(fig)
    return path
