"""ctypes binding of the port's numeric-CSV parser (csrc/fastcsv.cpp).

Counterpart of anime_recommendations_tpu/data/fastcsv.py: a memory-mapped,
multithreaded parse of an all-numeric CSV (the MyAnimeList rating dumps:
user_id, anime_id, rating, watching_status, watched_episodes) into column
arrays. The port keeps its own copy of the parser's C++ source, in its
package: at first use ``g++ -O3 -shared -fPIC -pthread`` compiles
csrc/fastcsv.cpp into ``build/native/`` at the repository root, named with
a hash of the source and the flags.

Where no C++ compiler is found, read_numeric_csv reads with pandas; where
one is found and the build fails, it raises. A file with a non-numeric
column goes to pandas, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pandas as pd

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fastcsv.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")


def build(src: Path = SOURCE, build_dir: Path = BUILD_DIR, cxx: str = "g++") -> Path:
    """Compile ``src`` into ``build_dir`` unless this exact source is built;
    raises RuntimeError when the compiler fails."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = build_dir / f"libfastcsv_{digest}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders never load half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL | None:
    """The loaded parser, built on first call; None where no C++ compiler
    is found."""
    cxx = shutil.which("g++")
    if cxx is None:
        logger.warning("no g++ on PATH: numeric CSVs are read with pandas")
        return None
    lib = ctypes.CDLL(str(build(cxx=cxx)))
    lib.fastcsv_count_rows.restype = ctypes.c_int64
    lib.fastcsv_count_rows.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.fastcsv_parse.restype = ctypes.c_int64
    lib.fastcsv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int,
    ]
    return lib


def native_available() -> bool:
    return library() is not None


def read_numeric_csv(path: str | Path, columns: list[str] | None = None,
                     n_threads: int | None = None) -> pd.DataFrame:
    """Read an all-numeric CSV into a DataFrame, as pandas.read_csv would.

    ``columns``: names for a file without a header line. Columns whose
    values are all whole numbers come back int64, the others float64
    (empty fields are NaN). A file with a non-numeric column, or a host
    without a compiler, is read by pandas."""
    path = Path(path)
    header_names = _sniff_header(path)
    lib = library() if header_names is not _NOT_NUMERIC else None
    if lib is None:
        return pd.read_csv(path)
    names = header_names or columns
    n_cols = len(names) if names else _sniff_n_cols(path)
    names = names or [f"c{i}" for i in range(n_cols)]

    encoded, header_skipped = str(path).encode(), ctypes.c_int(0)
    n_rows = lib.fastcsv_count_rows(encoded, ctypes.byref(header_skipped))
    if n_rows < 0:
        raise OSError(f"fastcsv could not read {path}")
    out = np.empty((n_rows, n_cols), dtype=np.float64)
    n_threads = n_threads or min(os.cpu_count() or 1, 8)
    got = lib.fastcsv_parse(encoded, n_cols, out, n_rows, n_threads)
    if got < 0:
        raise OSError(f"fastcsv failed to parse {path} (code {got})")
    # One transposed copy makes every column contiguous; whole-number
    # columns (ids, counts) become int64, as pandas infers them.
    cols = out[:got].T.copy()
    data = {}
    for name, col in zip(names, cols):
        whole = np.isfinite(col).all() and (col == np.floor(col)).all()
        data[name] = col.astype(np.int64) if whole else col
    return pd.DataFrame(data)


_NOT_NUMERIC = object()


def _sniff_header(path: Path):
    """Header names, None (a headerless numeric file) or _NOT_NUMERIC."""
    with open(path, encoding="utf-8", errors="replace") as f:
        first = f.readline().strip("\n\r")
        second = f.readline().strip("\n\r")
    if not first:
        return None

    def numeric_line(line: str) -> bool:
        for tok in line.split(","):
            tok = tok.strip()
            if tok:
                try:
                    float(tok)
                except ValueError:
                    return False
        return True

    if numeric_line(first):
        return None
    if second and numeric_line(second):
        return [t.strip() for t in first.split(",")]
    return _NOT_NUMERIC


def _sniff_n_cols(path: Path) -> int:
    with open(path, encoding="utf-8", errors="replace") as f:
        return len(f.readline().split(","))
