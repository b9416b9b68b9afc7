"""The port's gated download (data/ingest.py) against the JAX package's, on
the CPU, over an HTTP server on 127.0.0.1 that each test module starts.

The server serves small raw files: a numeric ratings CSV (and the same
ratings as parquet), an anime CSV with string columns and a synopses CSV.
The same DataConfig goes through both packages' load_raw: every frame
equal, the same ``source``, and each cache holding the served bytes. A 404
raises in both; a file that is neither local nor downloadable ends the
loop in both (synthetic data, nothing downloaded). ``cli pipeline --steps
ingest preprocess`` of each package over the server writes equal
full_data_set.parquet and preprocessed_stats.parquet, tagged "download".
"""

import functools
import http.server
import threading
import urllib.error
from pathlib import Path

import pandas as pd
import pytest
import requests

from anime_recommendations_tpu.cli import main as jmain
from anime_recommendations_tpu.config import Config as JConfig
from anime_recommendations_tpu.config import DataConfig as JDataConfig
from anime_recommendations_tpu.data.ingest import load_raw as jload_raw
from anime_recommendations_tpu.pipeline.runner import PipelineRunner as JPipelineRunner
from anime_recommendations_tpu_torch.cli import main
from anime_recommendations_tpu_torch.config import Config, DataConfig
from anime_recommendations_tpu_torch.data.ingest import _read_any, load_raw
from anime_recommendations_tpu_torch.pipeline.runner import PipelineRunner

NAMES = {"ratings": "user_stats.csv", "anime": "all_anime.csv", "synopses": "synopses.csv"}
FIELDS = {"ratings": ("stats_path", "stats_url"), "anime": ("anime_path", "anime_url"),
          "synopses": ("synopses_path", "synopses_url")}


@pytest.fixture(scope="module")
def served(tmp_path_factory, ratings_frame, anime_catalog_frame, synopses_frame):
    """(directory, base URL, request log) of a ThreadingHTTPServer on
    127.0.0.1 serving the raw files; the log lists each requested path."""
    root = tmp_path_factory.mktemp("served")
    ratings_frame.to_csv(root / NAMES["ratings"], index=False)
    ratings_frame.to_parquet(root / "user_stats.parquet", index=False)
    anime_catalog_frame.to_csv(root / NAMES["anime"], index=False)
    synopses_frame.to_csv(root / NAMES["synopses"], index=False)
    requested = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def do_GET(self):
            requested.append(self.path)
            super().do_GET()

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Handler, directory=str(root)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield root, f"http://127.0.0.1:{server.server_address[1]}", requested
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def data_kwargs(tmp_path, base, names=NAMES, local=(), allow=True) -> dict:
    """DataConfig fields: each file at a path under ``tmp_path/missing`` that
    does not exist (or, for the keys in ``local``, the path ``names`` gives
    under ``local``'s directory) and its URL on the server."""
    kw = dict(allow_download=allow, synthetic_users=60, synthetic_anime=30,
              synthetic_interactions=2000)
    for key, (path_field, url_field) in FIELDS.items():
        kw[path_field] = str(tmp_path / "missing" / names[key])
        kw[url_field] = f"{base}/{names[key]}"
    for key, directory in dict(local).items():
        kw[FIELDS[key][0]] = str(Path(directory) / names[key])
    return kw


def both(kw: dict, tmp_path):
    """(JAX RawData, port RawData) of one DataConfig, each downloading into
    its own cache directory."""
    return (jload_raw(JDataConfig(**kw), cache_dir=tmp_path / "jax_cache"),
            load_raw(DataConfig(**kw), cache_dir=tmp_path / "port_cache"))


def assert_same_raw(jraw, raw):
    assert raw.source == jraw.source
    for key in ("ratings", "anime", "synopses"):
        pd.testing.assert_frame_equal(getattr(raw, key), getattr(jraw, key))


@pytest.mark.parametrize("ratings_file", ["user_stats.csv", "user_stats.parquet"])
def test_all_three_downloaded(served, tmp_path, ratings_file):
    root, base, _ = served
    names = dict(NAMES, ratings=ratings_file)
    jraw, raw = both(data_kwargs(tmp_path, base, names), tmp_path)
    assert_same_raw(jraw, raw)
    assert raw.source == jraw.source == "download"
    for name in names.values():
        served_bytes = (root / name).read_bytes()
        assert (tmp_path / "port_cache" / name).read_bytes() == served_bytes
        assert (tmp_path / "jax_cache" / name).read_bytes() == served_bytes
    # The downloaded ratings are the served file read locally (a numeric
    # CSV through data/fastcsv.py).
    pd.testing.assert_frame_equal(raw.ratings, _read_any(root / ratings_file))


def test_one_local_two_downloaded(served, tmp_path):
    root, base, _ = served
    jraw, raw = both(data_kwargs(tmp_path, base, local={"ratings": root}), tmp_path)
    assert_same_raw(jraw, raw)
    assert raw.source == "download"
    assert sorted(p.name for p in (tmp_path / "port_cache").iterdir()) == \
        sorted([NAMES["anime"], NAMES["synopses"]])


def test_download_not_allowed_is_synthetic(served, tmp_path):
    _, base, requested = served
    before = len(requested)
    jraw, raw = both(data_kwargs(tmp_path, base, allow=False), tmp_path)
    assert_same_raw(jraw, raw)
    assert raw.source == "synthetic"
    assert len(requested) == before and not (tmp_path / "port_cache").exists()


def test_first_file_neither_local_nor_downloadable_ends_the_loop(served, tmp_path):
    """No ratings URL: both packages stop at the ratings and make synthetic
    data without asking for the other two files, whose URLs are set."""
    _, base, requested = served
    kw = dict(data_kwargs(tmp_path, base), stats_url="")
    before = len(requested)
    jraw, raw = both(kw, tmp_path)
    assert_same_raw(jraw, raw)
    assert raw.source == "synthetic"
    assert len(requested) == before


def test_http_error_raises_in_both(served, tmp_path):
    """A 404 raises (requests.HTTPError in JAX, urllib.error.HTTPError in the
    port: ROADMAP.md Queue 3), writes no file and falls back to nothing."""
    _, base, _ = served
    kw = data_kwargs(tmp_path, base, names=dict(NAMES, anime="not_there.csv"))
    with pytest.raises(requests.HTTPError):
        jload_raw(JDataConfig(**kw), cache_dir=tmp_path / "jax_cache")
    with pytest.raises(urllib.error.HTTPError) as err:
        load_raw(DataConfig(**kw), cache_dir=tmp_path / "port_cache")
    assert err.value.code == 404
    for cache in ("jax_cache", "port_cache"):
        assert sorted(p.name for p in (tmp_path / cache).iterdir()) == [NAMES["ratings"]]


CLI_SETS = ["data.synthetic_users=300", "data.synthetic_anime=120",
            "data.synthetic_interactions=30000", "data.num_reviews=50"]


def test_cli_ingest_preprocess_downloads_in_both(served, tmp_path):
    _, base, _ = served
    kw = data_kwargs(tmp_path, base)
    sets = [*CLI_SETS, "data.allow_download=true",
            *[f"data.{f}={kw[f]}" for fields in FIELDS.values() for f in fields]]
    args = [a for s in sets for a in ("--set", s)]
    steps = ["pipeline", "--steps", "ingest", "preprocess"]
    assert jmain([*steps, "--run-dir", str(tmp_path / "jax"), *args]) == 0
    assert main([*steps, "--run-dir", str(tmp_path / "port"), "--device", "cpu", *args]) == 0

    jcfg = JConfig()
    for field, value in kw.items():
        setattr(jcfg.data, field, value)
    jrunner = JPipelineRunner(jcfg, tmp_path / "jax")
    runner = PipelineRunner(Config.from_dict(jcfg.to_dict()), tmp_path / "port", device="cpu")
    for name in ("full_data_set.parquet", "preprocessed_stats.parquet"):
        jart, art = jrunner.store.get(f"{name}:latest"), runner.store.get(f"{name}:latest")
        pd.testing.assert_frame_equal(pd.read_parquet(art.file()), pd.read_parquet(jart.file()))
    meta = runner.store.get("full_data_set.parquet:latest").metadata
    assert meta["source"] == jrunner.store.get("full_data_set.parquet:latest").metadata[
        "source"] == "download"
    # A downloaded run keeps the configured query names, as in JAX.
    assert not runner._is_synthetic_run() and not jrunner._is_synthetic_run()
    for r in (jrunner, runner):
        assert sorted(p.name for p in (r.run_dir / "cache").iterdir()) == sorted(NAMES.values())
