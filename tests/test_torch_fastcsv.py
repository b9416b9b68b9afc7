"""The port's native CSV parser (data/fastcsv.py) against pandas and the
JAX package's read_numeric_csv: the cases of tests/test_fastcsv.py, on the
same files. The port builds its own copy of the parser's source
(anime_recommendations_tpu_torch/csrc/fastcsv.cpp, the same bytes as the
JAX package's native/fastcsv.cpp) into build/native/, reads with pandas
only where no compiler is found, and raises where the build fails."""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from anime_recommendations_tpu.data import fastcsv as jfastcsv
from anime_recommendations_tpu_torch.data import fastcsv
from anime_recommendations_tpu_torch.data.ingest import _read_any

REPO = Path(__file__).resolve().parents[1]


def same_as_jax_and_pandas(path, **kw):
    """The port's frame, after checking it equals JAX's (values and
    dtypes)."""
    ours = fastcsv.read_numeric_csv(path, **kw)
    pd.testing.assert_frame_equal(ours, jfastcsv.read_numeric_csv(path, **kw))
    return ours


@pytest.fixture(scope="module")
def csv_file(tmp_path_factory, ratings_frame):
    path = tmp_path_factory.mktemp("csv") / "ratings.csv"
    ratings_frame.to_csv(path, index=False)
    return path


def test_native_builds_into_build_native():
    assert fastcsv.native_available(), "g++ is on PATH here: the build must work"
    lib = fastcsv.build()
    assert lib.parent == fastcsv.BUILD_DIR and lib.parent.parts[-2:] == ("build", "native")
    assert lib.exists()
    assert fastcsv.SOURCE.parent == REPO / "anime_recommendations_tpu_torch" / "csrc"
    # The port's copy, not the JAX package's file: the same parser below
    # the header comment.
    code = lambda path: path.read_text().split("\n\n", 1)[1]
    assert code(fastcsv.SOURCE) == code(REPO / "native" / "fastcsv.cpp")


def test_parse_matches_pandas(csv_file):
    ours = same_as_jax_and_pandas(csv_file)
    ref = pd.read_csv(csv_file)
    assert list(ours.columns) == list(ref.columns) and len(ours) == len(ref)
    for col in ref.columns:
        np.testing.assert_allclose(ours[col].to_numpy(np.float64), ref[col].to_numpy(np.float64))
        assert ours[col].dtype == ref[col].dtype, col


def test_headerless_numeric(tmp_path):
    path = tmp_path / "raw.csv"
    path.write_text("1,2,0.5\n4,5,0.25\n")
    out = same_as_jax_and_pandas(path, columns=["a", "b", "c"])
    assert list(out.columns) == ["a", "b", "c"]
    np.testing.assert_allclose(out["c"], [0.5, 0.25])
    assert out["a"].dtype == np.int64


def test_floats_negatives_missing(tmp_path):
    path = tmp_path / "x.csv"
    path.write_text("a,b\n-1.5,2\n3.25,\n-0,7\n")
    out = same_as_jax_and_pandas(path)
    np.testing.assert_allclose(out["a"], [-1.5, 3.25, 0.0])
    assert np.isnan(out["b"].to_numpy(np.float64)[1])
    pd.testing.assert_frame_equal(out, pd.read_csv(path))


def test_non_numeric_goes_to_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b\n1,hello\n2,world\n")
    out = same_as_jax_and_pandas(path)
    assert out["b"].tolist() == ["hello", "world"]


def test_no_trailing_newline(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b\n1,2\n3,4")
    out = same_as_jax_and_pandas(path)
    assert len(out) == 2 and out["b"].tolist() == [2, 4]


def test_ingest_reads_csv_through_the_parser(csv_file, ratings_frame):
    pd.testing.assert_frame_equal(_read_any(csv_file), fastcsv.read_numeric_csv(csv_file))
    pd.testing.assert_frame_equal(_read_any(csv_file), ratings_frame, check_dtype=False)


def test_failed_build_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed on"):
        fastcsv.build(bad, tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so"))


def test_no_compiler_reads_with_pandas(tmp_path, monkeypatch):
    path = tmp_path / "t.csv"
    path.write_text("a,b\n1,2\n3,4\n")
    monkeypatch.setattr(fastcsv.shutil, "which", lambda name: None)
    fastcsv.library.cache_clear()
    try:
        assert not fastcsv.native_available()
        pd.testing.assert_frame_equal(fastcsv.read_numeric_csv(path), pd.read_csv(path))
    finally:
        fastcsv.library.cache_clear()
