"""The port's benchmark suite (anime_recommendations_tpu_torch/bench.py), on the CPU.

``cli bench --device cpu`` runs the whole suite once at small sizes: its
stdout is one JSON line holding every key the repository root's bench.py
writes (read from bench.py's source by chip_smoke.bench_key_patterns, as
phase 11 reads it on the card) but scan_harness_base_ms, and no other; its
exact retrieval overlaps read 1.0. Section 10's overlaps and section 7's
IVF recall are held to the same calls through the JAX package on one numpy
table (the JAX scans in interpret mode, as its own tests run them): equal,
but within 0.01 for the scans of a shuffled table, whose permutation is
numpy's in the port and jax.random's in JAX. The bench's data builders
equal bench.py's lines, quoted here. ``--device cuda`` without a card
raises.
"""

import contextlib
import functools
import io
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from anime_recommendations_tpu.ops import ivf as jivf
from anime_recommendations_tpu.ops.quantized import quantize_rows as jquantize_rows
from anime_recommendations_tpu.ops.topk import ShuffledTable as JShuffledTable
from anime_recommendations_tpu.ops.topk import cosine_topk as jcosine_topk
from anime_recommendations_tpu.ops.topk import masked_topk as jmasked_topk
from anime_recommendations_tpu.ops.topk import shuffle_rows as jshuffle_rows
from anime_recommendations_tpu_torch import bench, cli
from anime_recommendations_tpu_torch.ops.ivf import build_ivf
from anime_recommendations_tpu_torch.ops.topk import masked_topk

torch.set_num_threads(2)

SMALL = bench.BenchSizes(
    n_users=700, n_anime=600, d=16, batch=256, steps=2, epoch_rows=1024, n_users_full=900,
    full_rows=512, routed_steps=3, routed_batches=3, query_batches=4, oracle_rows=500,
    ivf_rows=3000, ivf_clusters=32, trained_users=600, trained_users_full=800,
    trained_rows=5000, trained_epochs=2, serve_users=300, serve_anime=120,
    serve_interactions=30_000, serve_d=8)
EXACT_KEYS = ("topk_overlap_vs_oracle", "topk_q256_overlap_vs_oracle",
              "score_topk_overlap_vs_oracle")


@pytest.fixture(scope="module")
def small_run():
    """``cli bench --device cpu`` at SMALL: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "main", functools.partial(bench.main, SMALL))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["bench", "--device", "cpu"])
    return rc, out.getvalue(), err.getvalue()


def test_cli_bench_prints_one_result_line(small_run):
    rc, out, _ = small_run
    lines = out.splitlines()
    assert rc == 0 and len(lines) == 1
    result = json.loads(lines[0])
    assert result["metric"] == "train_examples_per_sec" and result["unit"] == "examples/s"
    assert result["vs_baseline"] is None
    assert result["value"] == result["details"]["train_examples_per_sec"] > 0
    details = result["details"]
    assert details["device"] == "cpu" and details["backend"] == "cpu"
    numbers = {k: v for k, v in details.items() if not isinstance(v, str)}
    assert numbers and all(math.isfinite(v) for v in numbers.values()), numbers


def test_cli_bench_writes_every_key_of_bench_py(small_run):
    details = json.loads(small_run[1])["details"]
    patterns, initial = chip_smoke.bench_key_patterns()
    assert initial == {"device", "backend"}
    # Every f-string field resolved: one literal key each, 93 in all.
    assert len(patterns) == 93 and not any(".+" in p for p in patterns)
    # bench.py's harness overhead has no counterpart (bench module docstring).
    assert "scan_harness_base_ms" in patterns and "scan_harness_base_ms" not in details
    assert chip_smoke.bench_key_mismatch(details) == ([], [])
    missing, unknown = chip_smoke.bench_key_mismatch(
        {**{k: v for k, v in details.items() if k != "topk_user_int8_q256_qps"}, "extra_ms": 1})
    assert (missing, unknown) == (["topk_user_int8_q256_qps"], ["extra_ms"])


def test_cli_bench_exact_retrieval_and_launch_line(small_run):
    _, out, err = small_run
    details = json.loads(out)["details"]
    assert {k: details[k] for k in EXACT_KEYS} == dict.fromkeys(EXACT_KEYS, 1.0)
    assert details["topk_int8_overlap_vs_oracle"] == 1.0
    launch_lines = [line for line in err.splitlines() if line.startswith("[bench] launches ")]
    # The CPU runs the plain versions: no kernel launches.
    assert [json.loads(line[len("[bench] launches "):]) for line in launch_lines] == [{}]


def test_bench_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the suite would run")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["bench", "--device", "cuda"])


def test_larger_process_group_raises(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="1 x 1"):
        with bench.one_rank_group(torch.device("cpu")):
            pass


# ---- data builders against bench.py's lines ------------------------------------------


def test_zipf_teacher_is_bench_py_draws():
    nu_t, na_t, lat, t_rows, nu_f = 900, 300, 16, 4000, 1200
    got = bench.zipf_teacher(np.random.default_rng(5), nu_t, na_t, t_rows)
    trng = np.random.default_rng(5)
    # bench.py:572-584
    Ulat = trng.normal(size=(nu_t, lat)).astype(np.float32) / np.sqrt(lat)
    Vlat = trng.normal(size=(na_t, lat)).astype(np.float32) / np.sqrt(lat)
    zu = np.minimum((trng.pareto(1.1, t_rows) * 40).astype(np.int64), nu_t - 1)
    za = np.minimum((trng.pareto(1.05, t_rows) * 15).astype(np.int64), na_t - 1)
    aff = np.einsum("ij,ij->i", Ulat[zu], Vlat[za])
    y = 1.0 / (1.0 + np.exp(-(3.0 * aff + trng.normal(0, 0.35, t_rows))))
    np.testing.assert_array_equal(got.users, zu.astype(np.int32))
    np.testing.assert_array_equal(got.anime, za.astype(np.int32))
    np.testing.assert_array_equal(got.ratings, y.astype(np.float32))
    assert got.users.dtype == got.anime.dtype == np.int32 and got.ratings.dtype == np.float32
    # bench.py:669-674, from the same generator right after.
    Ulat_f = trng.normal(size=(nu_f, lat)).astype(np.float32) / np.sqrt(lat)
    zu_f = np.minimum((trng.pareto(1.1, t_rows) * 40).astype(np.int64), nu_f - 1)
    aff_f = np.einsum("ij,ij->i", Ulat_f[zu_f], Vlat[za])
    y_f = 1.0 / (1.0 + np.exp(-(3.0 * aff_f + trng.normal(0, 0.35, t_rows))))
    rng = np.random.default_rng(5)
    teacher = bench.zipf_teacher(rng, nu_t, na_t, t_rows)
    got_f = bench.zipf_teacher_users(rng, teacher, nu_f)
    np.testing.assert_array_equal(got_f.users, zu_f.astype(np.int32))
    np.testing.assert_array_equal(got_f.anime, za.astype(np.int32))
    np.testing.assert_array_equal(got_f.ratings, y_f.astype(np.float32))
    # Both builders leave the generator where bench.py's lines leave it.
    assert rng.integers(0, 2**62) == trng.integers(0, 2**62)


def test_latent_table_is_bench_py_draws():
    n_ivf, d = 2000, 32
    got = bench.latent_table(np.random.default_rng(0), n_ivf, d, "cpu")
    rng = np.random.default_rng(0)
    # bench.py:476-490, the product and normalization in numpy (f32).
    lat_u = rng.standard_normal((n_ivf, 16)).astype(np.float32)
    lat_p = rng.standard_normal((16, d)).astype(np.float32) / 4.0
    w = lat_u @ lat_p
    want = w / np.linalg.norm(w, axis=1, keepdims=True)
    assert got.dtype == torch.float32 and got.shape == (n_ivf, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---- section 10's overlaps and section 7's recall against the JAX package -------------


def clustered_table(n=4096, d=16, size=10, clusters=51, seed=3):
    """Unit rows of rank 4. The first size * clusters rows, all in the first
    512-row group, are tight clusters of ``size`` rows each (latent noise
    0.01), far from every other row: a hot row's top-10 is its own cluster,
    all in one group, as trained tables put similar popular rows at adjacent
    low ids. The unshuffled scan (depth 9 at 4,096 rows, in both packages)
    keeps 9 of them whichever 9 its stage-1 precision picks: the port's
    stage 1 rounds f32 to TF32 from 2 queries and JAX's CPU path does not
    (ops/topk.py), so on a table where stage 1's precision decides which row
    makes a group's depth (a dense rank-4 table) the two unshuffled overlaps
    differ slightly, for that reason alone."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 4))
    hot = size * clusters
    z[:hot] = (np.repeat(rng.normal(size=(clusters, 4)), size, axis=0)
               + 0.01 * rng.normal(size=(hot, 4)))
    w = z @ rng.normal(size=(4, d))
    return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)


def jax_trained_overlaps(table: np.ndarray, n_hot: int) -> dict:
    """bench.py:596-661's calls through the JAX package."""
    user_n = jnp.asarray(table)
    hot_q = user_n[:n_hot]
    tix = np.asarray(jmasked_topk(user_n, hot_q, 10, exact_scan=True)[1])

    def ov(ti, rows=n_hot):
        return bench.overlap(np.asarray(ti), tix, rows, 5)

    st_sh = jshuffle_rows(user_n, seed=13)
    st_q = JShuffledTable(jquantize_rows(st_sh.table), st_sh.perm, st_sh.inv)
    st_b = JShuffledTable(st_sh.table.astype(jnp.bfloat16), st_sh.perm, st_sh.inv)
    bx = jmasked_topk(st_sh.table.astype(jnp.bfloat16), hot_q.astype(jnp.bfloat16), 10,
                      exact_scan=True)[1]
    got_b = jmasked_topk(st_sh.table.astype(jnp.bfloat16), hot_q.astype(jnp.bfloat16), 10)[1]
    out = {
        "twostage_unshuffled": ov(jmasked_topk(user_n, hot_q, 10)[1]),
        "twostage_vs_exact": ov(jcosine_topk(st_sh, hot_q, 10)[1]),
        "twostage_topr3": ov(jcosine_topk(st_sh, hot_q, 10, top_r=3)[1]),
        "int8_vs_exact": ov(jcosine_topk(st_q, hot_q, 10)[1]),
        "int8_q8_vs_exact": ov(jcosine_topk(st_q, hot_q[:8], 10)[1], 8),
        "bf16_vs_exact": ov(jcosine_topk(st_b, hot_q, 10)[1]),
        "bf16_vs_bf16exact": bench.overlap(np.asarray(got_b), np.asarray(bx), n_hot, 5),
    }
    return {f"topk_trained_{k}_overlap": v for k, v in out.items()}, tix


def test_trained_overlaps_match_jax():
    table, n_hot = clustered_table(), 64
    got = bench.trained_overlaps(torch.from_numpy(table), n_hot)
    want, jexact = jax_trained_overlaps(table, n_hot)
    assert got.keys() == want.keys()
    exact = masked_topk(torch.from_numpy(table), torch.from_numpy(table[:n_hot]), 10,
                        exact_scan=True)[1]
    np.testing.assert_array_equal(exact.numpy(), jexact)
    # The hazard the unshuffled key measures shows: one row of 10 lost a query.
    assert got["topk_trained_twostage_unshuffled_overlap"] == 0.9
    for key in ("topk_trained_twostage_unshuffled_overlap",
                "topk_trained_bf16_vs_bf16exact_overlap"):
        assert got[key] == want[key], key
    for key in got.keys() - {"topk_trained_twostage_unshuffled_overlap",
                             "topk_trained_bf16_vs_bf16exact_overlap"}:
        assert abs(got[key] - want[key]) <= 0.01, (key, got[key], want[key])


def test_ivf_recall_matches_jax():
    w = bench.latent_table(np.random.default_rng(0), 3000, 16, "cpu")
    ids = np.random.default_rng(1).integers(0, 3000, 64)
    queries = w[torch.from_numpy(ids)]
    got = bench.ivf_recalls(build_ivf(w, n_clusters=32, iters=8, seed=3), w, queries,
                            probes=(2, 8, 32))
    jw = jnp.asarray(w.numpy())
    jindex = jivf.build_ivf(jw, n_clusters=32, iters=8, seed=3)
    jq = jw[jnp.asarray(ids)]
    exact = np.asarray(jmasked_topk(jw, jq, 10, exact_scan=True)[1])
    want = {p: bench.overlap(np.asarray(jivf.ivf_topk(jindex, jq, 10, probes=p)[1]), exact, 64, 4)
            for p in (2, 8, 32)}
    assert got == want
    assert got[2] < 1.0 and got[32] == 1.0
