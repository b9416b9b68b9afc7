"""Command-line interface of the PyTorch port: run the pipeline, train and serve.

    python -m anime_recommendations_tpu_torch.cli pipeline --run-dir runs [--steps ...]
    python -m anime_recommendations_tpu_torch.cli ingest --run-dir runs
    python -m anime_recommendations_tpu_torch.cli preprocess --run-dir runs
    python -m anime_recommendations_tpu_torch.cli train --run-dir runs [--set model.optimizer=fused_adam]
    python -m torch.distributed.run --nproc_per_node=2 -m anime_recommendations_tpu_torch.cli \
        train --run-dir runs --device cpu       # the routed trainer, tables striped over 2 ranks
    python -m anime_recommendations_tpu_torch.cli serve --run-dir runs [--port 8080]
    python -m anime_recommendations_tpu_torch.cli similar-anime "Cowboy Bebop" -k 10 --run-dir runs
    python -m anime_recommendations_tpu_torch.cli similar-users 153695 -k 10 --run-dir runs
    python -m anime_recommendations_tpu_torch.cli user-prefs 153695 --run-dir runs
    python -m anime_recommendations_tpu_torch.cli user-recs 153695 --run-dir runs
    python -m anime_recommendations_tpu_torch.cli model-recs 153695 --run-dir runs
    python -m anime_recommendations_tpu_torch.cli bench [--device cpu]

``pipeline`` runs the eight steps (default main.execute_steps; --steps
names some of them) and prints the timings JSON that run() writes to
timings.json; ingest, preprocess and train run one step each. A run
written by either package goes on and serves in the other (the artifact
store's layout is shared). Every subcommand takes --config <yaml>, repeated
--set section.key=value overrides, and --device (default cuda; cpu runs the
kernels' plain versions). ``bench`` runs the benchmark suite (bench.py in
this package) and takes --device alone; it prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from anime_recommendations_tpu_torch.config import Config


def _base_parser(sub, name, help_):
    p = sub.add_parser(name, help=help_)
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="section.key=value", help="config override (repeatable)",
    )
    p.add_argument("--run-dir", default=None, help="artifact/run directory")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def load_config(args) -> Config:
    if args.config:
        return Config.from_yaml(args.config, overrides=args.overrides)
    return Config().with_overrides(args.overrides)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    parser = argparse.ArgumentParser(prog="anime_recommendations_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = _base_parser(sub, "pipeline", "run the pipeline's steps")
    p.add_argument("--steps", nargs="*", default=None)

    for step, help_ in (("ingest", "load raw data (local files, else synthetic)"),
                        ("preprocess", "clean and scale the ratings"),
                        ("train", "train the two-tower model")):
        _base_parser(sub, step, help_)

    p = _base_parser(sub, "similar-anime", "query similar anime")
    p.add_argument("name")
    p.add_argument("-k", type=int, default=10)

    p = _base_parser(sub, "similar-users", "query similar users")
    p.add_argument("user_id", type=int)
    p.add_argument("-k", type=int, default=10)

    p = _base_parser(sub, "user-prefs", "profile a user's preferences")
    p.add_argument("user_id", type=int)

    p = _base_parser(sub, "user-recs", "recommendations from similar users")
    p.add_argument("user_id", type=int)
    p.add_argument("-k", type=int, default=10)

    p = _base_parser(sub, "model-recs", "model-scored recommendations")
    p.add_argument("user_id", type=int)
    p.add_argument("-k", type=int, default=10)

    p = _base_parser(sub, "serve", "start the HTTP query API")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)

    p = sub.add_parser("bench", help="run the benchmark suite (one JSON line)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")

    args = parser.parse_args(argv)
    if args.cmd == "bench":
        from anime_recommendations_tpu_torch import bench

        bench.main(device=args.device)
        return 0
    cfg = load_config(args)

    if args.cmd in ("pipeline", "ingest", "preprocess", "train"):
        import torch.distributed as dist

        from anime_recommendations_tpu_torch.parallel.distributed import shutdown
        from anime_recommendations_tpu_torch.pipeline.runner import PipelineRunner

        runner = PipelineRunner(cfg, args.run_dir, device=args.device)
        try:
            if args.cmd == "pipeline":
                runner.run(args.steps)
                rank0 = not dist.is_initialized() or dist.get_rank() == 0
            else:
                result = getattr(runner, f"step_{args.cmd}")()
        finally:
            shutdown()   # torchrun: train went through parallel/
        if args.cmd == "pipeline":
            if rank0:   # rank 0 wrote timings.json
                print(json.dumps(json.loads((runner.run_dir / "timings.json").read_text()),
                                 indent=2))
        elif result is not None:
            print(f"best epoch {result.best_epoch}, val_loss {result.best_val_loss:.6f}, "
                  f"{result.epochs_run} epochs, {result.examples_per_sec:.0f} examples/s")
        return 0

    from anime_recommendations_tpu_torch.pipeline.runner import context_from_store

    ctx = context_from_store(cfg, args.run_dir, device=args.device)
    uc = cfg.users

    if args.cmd == "serve":
        from anime_recommendations_tpu_torch.serve.api import serve_http

        serve_http(ctx, cfg, host=args.host, port=args.port)
        return 0
    if args.cmd == "similar-anime":
        from anime_recommendations_tpu_torch.recommend.similar_anime import similar_anime

        frame, _, _ = similar_anime(ctx, args.name, count=args.k)
    elif args.cmd == "similar-users":
        from anime_recommendations_tpu_torch.recommend.similar_users import similar_users

        frame, _, _ = similar_users(ctx, args.user_id, n_users=args.k,
                                    num_faves=uc.num_faves, TV_only=uc.TV_only)
    elif args.cmd == "user-prefs":
        from anime_recommendations_tpu_torch.recommend.user_prefs import user_prefs

        frame = user_prefs(ctx, args.user_id, percentile=uc.favorite_percentile).merged
    elif args.cmd == "user-recs":
        from anime_recommendations_tpu_torch.recommend.similar_users import similar_users
        from anime_recommendations_tpu_torch.recommend.user_recs import user_recs

        sim, _, _ = similar_users(ctx, args.user_id, n_users=uc.recs_n_sim_ID,
                                  num_faves=uc.num_faves, TV_only=uc.TV_only)
        frame, _ = user_recs(ctx, args.user_id, sim["similar_users"].to_numpy(),
                             n=args.k, percentile=uc.favorite_percentile)
    else:  # model-recs
        from anime_recommendations_tpu_torch.recommend.model_recs import model_recs

        frame, _ = model_recs(ctx, args.user_id, n_recs=args.k)
    print(frame.to_string())
    return 0


if __name__ == "__main__":
    sys.exit(main())
