"""The port's multi-process runtime: full ShardedTrainer fits in gloo ranks.

``python -m anime_recommendations_tpu_torch.parallel.distributed --worker
--fit`` in 2 ranks, against 1 rank and against the one-device Trainer of
the same spec in this process (parallel.distributed.fit_data, FIT_KWARGS),
in the pattern of tests/test_distributed.py: both ranks report the same
curve; it matches a 1-rank run within 2e-4 relative (that test's bound:
the ranks only reorder f32 sums); a same-world resume continues from the
checkpoint, and a resume under another layout raises; a measured capacity
(-1) gives the default capacity's curve within 1e-5
(tests/test_sharded_trainer.py's bound); bf16 moments track the one-device
bf16m fit within 2e-2 (tests/test_sharded_trainer.py's bound: stochastic
rounding keys on the LOCAL row, so 2 ranks draw other bits than 1).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from anime_recommendations_tpu_torch.parallel.distributed import FIT_KWARGS, fit_data
from anime_recommendations_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORKER = "anime_recommendations_tpu_torch.parallel.distributed"


def failed_rank(rank: int, code: int, err: str) -> str:
    return f"rank {rank} exited with {code}; its whole stderr:\n{err}"


def run_ranks(m: int, cmd: list[str], timeout: int = 120, fail: bool = False) -> list[str]:
    """Standard outputs of m gloo ranks of ``cmd``, each started with its
    MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE; with ``fail`` (every rank
    must fail) their standard errors. A rank that succeeds must not have
    aborted on the way out."""
    port = _free_port()
    procs = []
    for rank in range(m):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(m), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if fail:
                assert p.returncode != 0, f"rank {rank} did not fail:\n{out}"
                outs.append(err)
                continue
            assert p.returncode == 0, failed_rank(rank, p.returncode, err)
            assert "terminate called" not in err, failed_rank(rank, p.returncode, err)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


def launch(m: int, extra: list[str], timeout: int = 120, fail: bool = False) -> list:
    """m gloo ranks of the distributed worker; their JSON lines, or with
    ``fail`` (every rank must fail) their standard errors."""
    outs = run_ranks(m, [sys.executable, "-m", WORKER, "--worker", "--device", "cpu", *extra],
                     timeout, fail)
    return outs if fail else [json.loads(out.strip().splitlines()[-1]) for out in outs]


FIT = ["--fit", "--epochs", "3", "--optimizer", "fused_adam"]


@pytest.fixture(scope="module")
def two_rank_fit(tmp_path_factory):
    """(checkpoint dir, both ranks' results) of a 2-rank fused_adam fit."""
    ck = str(tmp_path_factory.mktemp("dist") / "ck")
    return ck, launch(2, FIT + ["--checkpoint-dir", ck])


def test_two_rank_fit_matches_one_rank_and_resumes(two_rank_fit):
    ck, outs = two_rank_fit
    assert [o["world_size"] for o in outs] == [2, 2]
    assert outs[0]["loss"] == outs[1]["loss"]
    assert outs[0]["val_loss"] == outs[1]["val_loss"]
    assert outs[0]["user_emb_absum"] == pytest.approx(outs[1]["user_emb_absum"], rel=1e-6)
    assert len(outs[0]["loss"]) == 3
    assert outs[0]["loss"][-1] < outs[0]["loss"][0]               # it trained
    assert sorted(os.listdir(ck)) == ["rank0-of-2", "rank1-of-2"]  # per-rank checkpoints

    solo = launch(1, FIT)[0]
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(solo[key], outs[0][key], rtol=2e-4)
    assert solo["user_emb_absum"] == pytest.approx(outs[0]["user_emb_absum"], rel=2e-4)

    # Resume on the same world size: the fit continues from the checkpoint
    # (fewer fresh epochs, and a first loss below the cold start's).
    res = launch(2, ["--fit", "--epochs", "4", "--optimizer", "fused_adam",
                     "--checkpoint-dir", ck, "--resume"])
    assert res[0]["loss"] == res[1]["loss"]
    assert len(res[0]["loss"]) < 4
    assert res[0]["loss"][0] < outs[0]["loss"][0]


def test_resume_under_another_layout_raises(two_rank_fit):
    """The 2-rank alltoall checkpoint resumed by a psum 1 x 2 fit with the
    anime table split: each rank's tables have the same shapes under both
    layouts (256 user and 64 anime rows) but other rows, so the restore
    must refuse it rather than load it."""
    errs = launch(2, ["--fit", "--epochs", "4", "--optimizer", "adam", "--routing", "psum",
                      "--data-axis", "1", "--model-axis", "2", "--shard-anime",
                      "--checkpoint-dir", two_rank_fit[0], "--resume"], fail=True)
    for err in errs:
        assert "was written in the layout 'alltoall 2x1', not 'psum 1x2 shard_anime'" in err


def test_measured_capacity_and_bf16_moments(two_rank_fit):
    """capacity=-1 measures the slot count; bf16m trains with bf16 table
    moments and tracks the one-device bf16m fit."""
    default = two_rank_fit[1][0]
    measured = launch(2, FIT + ["--capacity", "-1"])[0]
    assert 8 <= measured["capacity"] < 256 and default["capacity"] is None
    np.testing.assert_allclose(measured["loss"], default["loss"], rtol=1e-5)

    bf16 = launch(2, ["--fit", "--epochs", "3", "--optimizer", "fused_adam_bf16m"])
    assert bf16[0]["loss"] == bf16[1]["loss"]
    assert "torch.bfloat16" in bf16[0]["moment_dtypes"]
    train, holdout = fit_data()
    one = Trainer(batch_size=512, epochs=3, optimizer="fused_adam_bf16m", seed=0, patience=3,
                  device="cpu", **FIT_KWARGS).fit(train, holdout, 512, 128)
    np.testing.assert_allclose(bf16[0]["loss"], one.history["loss"].to_numpy(), rtol=2e-2)
    np.testing.assert_allclose(bf16[0]["val_loss"], one.history["val_loss"].to_numpy(), rtol=2e-2)


# Runs a module's main(argv) as ``python -m`` would, with the automatic
# garbage collector off (the entry point must free its groups itself, not
# when a collection happens to run), then prints how many of gloo's worker
# threads ("pt_gloo_runloop") are still alive in the process. A thread
# joined just before is not: the kernel wakes its joiner before it takes the
# thread's /proc entry away, so an entry may vanish while the task list is
# read, or still show the thread exiting (PF_EXITING, 0x4, in its flags).
PROBE = """
import gc, importlib, json, os, sys
gc.disable()
importlib.import_module(sys.argv[1]).main(sys.argv[2:])
alive = []
for t in os.listdir("/proc/self/task"):
    try:
        stat = open(f"/proc/self/task/{t}/stat").read()
    except FileNotFoundError:
        continue
    comm, fields = stat[stat.index("(") + 1:stat.rindex(")")], stat[stat.rindex(")") + 2:].split()
    if not int(fields[6]) & 0x4:
        alive.append(comm)
print(json.dumps({"gloo_threads": alive.count("pt_gloo_runloop")}))
"""
PIPELINE_SETS = ["data.synthetic_users=300", "data.synthetic_anime=120",
                 "data.synthetic_interactions=30000", "data.num_reviews=50",
                 "model.embedding_size=8", "model.epochs=1", "model.batch_size=1024",
                 "model.test_size=1000", "parallel.routing=psum", "parallel.model_axis=2",
                 "parallel.shard_anime_table=true"]
ENTRY_POINTS = {
    "worker_step": (WORKER, ["--worker", "--device", "cpu", "--steps", "1"]),
    "worker_fit": (WORKER, ["--worker", "--device", "cpu", "--fit", "--epochs", "1",
                            "--optimizer", "fused_adam", "--checkpoint-dir", "{tmp}/ck"]),
    "worker_fit_psum": (WORKER, ["--worker", "--device", "cpu", "--fit", "--epochs", "1",
                                 "--routing", "psum", "--model-axis", "2", "--shard-anime"]),
    "scaling_bench": ("anime_recommendations_tpu_torch.parallel.scaling_bench",
                      ["--worker", "--device", "cpu", "--meshes", "2x1", "--steps", "2",
                       "--batch", "256", "--users", "512", "--anime", "128", "--emb", "16"]),
    "cli_train": ("anime_recommendations_tpu_torch.cli",
                  ["pipeline", "--run-dir", "{tmp}/run", "--device", "cpu", "--steps", "ingest",
                   "preprocess", "train", *[a for s in PIPELINE_SETS for a in ("--set", s)]]),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_join_their_gloo_threads(entry, tmp_path):
    """Every multi-rank entry point of the port ends with
    dist.destroy_process_group, which frees its process groups while the
    interpreter runs: when main returns, no gloo worker thread is left
    alive. One left alive (parallel.mesh's group cache held the groups
    strongly, past destroy_process_group) met the interpreter's finalisation
    still letting go of a collective's tensors now and then, and the rank
    aborted with "terminate called without an active exception" after its
    work was done."""
    module, argv = ENTRY_POINTS[entry]
    argv = [a.format(tmp=tmp_path) for a in argv]
    outs = run_ranks(2, [sys.executable, "-c", PROBE, module, *argv])
    assert [json.loads(out.strip().splitlines()[-1]) for out in outs] == \
        [{"gloo_threads": 0}] * 2


def gloo_threads() -> int:
    tasks = Path("/proc/self/task")
    return sum((t / "comm").read_text().strip() == "pt_gloo_runloop" for t in tasks.iterdir())


def test_bench_one_rank_group_joins_its_gloo_threads():
    """bench.one_rank_group's gloo group of one rank, made and destroyed in
    this process, with a mesh's groups made from it: their worker threads
    end with it."""
    import torch
    import torch.distributed as dist

    from anime_recommendations_tpu_torch.bench import one_rank_group
    from anime_recommendations_tpu_torch.parallel.mesh import make_world

    before = gloo_threads()
    with one_rank_group(torch.device("cpu")):
        world = make_world(device="cpu")
        x = torch.ones(4)
        dist.all_reduce(x, group=world.data_group)
        assert gloo_threads() > before
        del world
    assert gloo_threads() == before and not dist.is_initialized()
    assert x.tolist() == [1.0] * 4
