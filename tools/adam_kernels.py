#!/usr/bin/env python3
"""K1 (with its dense branch) and K5, the fused sparse-Adam kernels, on one CUDA card.

    python3 tools/adam_kernels.py --report
    python3 tools/adam_kernels.py --time [--root DIR | --variant NAME] [--cases LIST]
                                  [--out FILE]
    python3 tools/adam_kernels.py --mutant NAME [--out FILE]

--report: `-Xptxas -v` of csrc/fused_adam.cu (or of a variant's), each
kernel's registers and shared memory, and any spill.

--time: times chip_smoke.py's phase-4 cases (K1 and K5: the synthetic
training batch of each table, every id on one user, bench.py's skewed ids)
and its phase-7a dense cases (users, anime and skewed anime) through the
wrappers of one version of the port: this checkout's, the package of
another checkout (DIR, e.g. an unpacked `git archive <commit>` under
build/, whose wrapper has the same signature), or this checkout's with one
line or two of csrc/fused_adam.cu patched (NAME, VARIANTS; built under
build/adam_kernels/NAME). Each case's time is the device time per call of
every kernel of the call whose name holds "fused_adam" (the first pass, the
update, the gather's second pass; chip_smoke._profiled: 20 calls after 3
warm-up, every launch recorded), with each kernel's own, and the device time of all the call's kernels (the
wrapper's searchsorted and the sumsq's sum too). --cases times some alone.

One version per process, as tools/scan_kernels.py: two versions are compared
by one process each, in turn (parent, new, new, parent).

--mutant: copies the port's package, tests/test_torch_cuda.py and the
pytest settings into build/adam_kernels/mutant_NAME, patches one
line of csrc/fused_adam.cu there (MUTANTS: a tile edge off by one, a tile
sum dropped), and runs the file's fused-Adam card tests against it: a check
that the tests catch a wrong kernel. Prints the passed and failed counts.

Prints JSON lines; --out also writes them to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

PACKAGE = "anime_recommendations_tpu_torch"
CSRC = REPO / PACKAGE / "csrc"
BUILD = REPO / "build" / "adam_kernels"
# name -> the (line of csrc/fused_adam.cu, its replacement) pairs patched
VARIANTS = {
    "min1": [("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 1;")],
    "sumpipe8": [("constexpr int kSumPipe = 4;", "constexpr int kSumPipe = 8;")],
}
MUTANTS = {
    # a run ending on a tile's edge is taken for one crossing it
    "edge_off_by_one": [("  const int t1 = (hi - 1) / kTile;", "  const int t1 = hi / kTile;")],
    # the last tile's sum of a crossing run is dropped
    "tile_sum_dropped": [
        ("sum_in_order<kSumPipe>(add4(zero, ldg4(first)), rest, stride, chunks - 1);",
         "sum_in_order<kSumPipe>(add4(zero, ldg4(first)), rest, stride, chunks - 2);")],
}
MUTANT_TESTS = "fused_adam or tiles or passes"


def patched(name: str, lines, dst: Path) -> Path:
    """dst/fused_adam.cu (with the rest of csrc/) with the (old, new) lines
    replaced."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    path = dst / "fused_adam.cu"
    text = path.read_text()
    for old, new in lines:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in fused_adam.cu once")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def ptxas_report(csrc: Path = CSRC) -> list[str]:
    from anime_recommendations_tpu_torch.ops import _kernels

    BUILD.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [_kernels.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v",
         "-o", str(BUILD / "fused_adam.cubin"), str(csrc / "fused_adam.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on fused_adam.cu:\n{proc.stdout}{proc.stderr}")
    return [line.strip() for line in proc.stderr.splitlines()
            if "Compiling entry function" in line or "Used" in line or "spill" in line]


def cases():
    """(kind, name, table rows, ids, next ids or None, moment dtype, dense)."""
    adam = cs._adam_cases()
    for name, n, ids, dtype in adam:
        yield "k1", name, n, ids, None, dtype, False
    for name, n, ids, dtype in adam:
        if name in ("users_f32", "users_bf16_sr", "anime_f32", "anime_f32_skewed"):
            yield "dense", name, n, ids, None, dtype, True
    for name, n, ids, dtype in adam:
        yield "k5", name, n, ids, cs._next_ids(name, n), dtype, False


def time_cases(card: str, label: str, lib, emit, only=None) -> None:
    import numpy as np
    import torch

    from anime_recommendations_tpu_torch.ops import fused_adam

    kw = {} if lib is None else {"lib": lib}
    for i, (kind, name, n, ids_np, next_np, dtype, with_dense) in enumerate(cases()):
        if only and f"{kind}:{name}" not in only:
            continue
        rng = np.random.default_rng(cs.SEED + i)
        w, mu, nu, g = cs._adam_tables(rng, n, ids_np.shape[0], dtype)
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(w.device)
        order = torch.argsort(ids, stable=True)
        ids_s, g_s = ids[order], g[order]
        sr = dtype == torch.bfloat16
        scal = fused_adam.adam_scalars(cs.ADAM_STEP, cs.ADAM_LR, cs.ADAM_L2, 0.9, 0.999, 1e-7)
        dense = (torch.from_numpy((rng.standard_normal((n, cs.D)) * 1e-4).astype(np.float32))
                 .to(w.device) if with_dense else None)
        gather = None
        if next_np is not None:
            nids = torch.from_numpy(next_np.astype(np.int32)).to(w.device)
            norder = torch.argsort(nids, stable=True)
            gather = (nids[norder], norder.to(torch.int32))

        def run():
            return fused_adam._sparse_adam_update_cuda(w, mu, nu, ids_s, g_s, scal,
                                                       cs.ADAM_STEP, sr, gather, dense, **kw)

        prof = cs._profiled(run, match="fused_adam")
        emit("time", dict(card=card, version=label, kind=kind, case=name, ms=prof["match_ms"],
                          by_kernel=prof["match_by_kernel"], call_device_ms=prof["device_ms"],
                          call_by_kernel=prof["by_kernel"], sessions=prof["sessions"],
                          records_lost=prof["records_lost"]))


def run_mutant(name: str) -> dict:
    """The fused-Adam card tests against a copy of the package with mutant
    ``name``'s line patched."""
    dst = BUILD / f"mutant_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(REPO / PACKAGE, dst / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "tests").mkdir(parents=True)
    for rel in ("tests/test_torch_cuda.py", "pyproject.toml"):
        shutil.copy(REPO / rel, dst / rel)
    patched(name, MUTANTS[name], dst / PACKAGE / "csrc")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py", "-m", "cuda", "-q",
         "-p", "no:cacheprovider", "-k", MUTANT_TESTS],
        cwd=dst, capture_output=True, text=True, env={**os.environ, "ANIMEREC_TEST_TPU": "1"})
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else proc.stderr[-500:]
    failed = sorted({line.split(" ")[1].split("[")[0] for line in proc.stdout.splitlines()
                     if line.startswith("FAILED ")})
    return {"mutant": name, "rc": proc.returncode, "summary": tail, "failed_tests": failed}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--report", action="store_true", help="the ptxas report")
    parser.add_argument("--time", action="store_true", help="time the cases")
    parser.add_argument("--root", type=Path, default=None,
                        help="the root of another checkout whose package to time")
    parser.add_argument("--variant", choices=sorted(VARIANTS), default=None)
    parser.add_argument("--mutant", choices=sorted(MUTANTS), action="append", default=[])
    parser.add_argument("--cases", default=None,
                        help="comma-separated kind:case (e.g. k1:users_f32) to time alone")
    parser.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    args = parser.parse_args()
    if args.root is not None and args.variant is not None:
        parser.error("--root and --variant are two versions: one per process")
    lines = []

    def emit(tag, obj):
        line = f"[{tag}] {json.dumps(obj)}"
        lines.append(line)
        print(line, flush=True)

    if args.report:
        src = CSRC if args.variant is None else patched(
            args.variant, VARIANTS[args.variant], BUILD / f"{args.variant}_report")
        emit("ptxas", {"source": "fused_adam.cu", "variant": args.variant,
                       "report": [line for line in ptxas_report(src) if "Used" in line
                                  or "spill" in line and "0 bytes spill" not in line]})
    for name in args.mutant:
        emit("mutant", run_mutant(name))
    if args.time:
        if args.root is not None:   # before the package's first import
            sys.path.insert(0, str(args.root.resolve()))
        import torch

        from anime_recommendations_tpu_torch.ops import _kernels

        if not torch.cuda.is_available():
            raise SystemExit("adam_kernels: torch.cuda.is_available() is False")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
        # Every build and load before the first profiler session.
        lib = None
        if args.variant is not None:
            src = patched(args.variant, VARIANTS[args.variant], BUILD / args.variant)
            lib = _kernels.load(_kernels.build("fused_adam", csrc=src), "fused_adam")
        else:
            _kernels.library("fused_adam")
        cs._train_split()
        cs._zipf_ratings()
        cs.start_profiler()
        label = args.variant or (str(args.root) if args.root else "checkout")
        time_cases(card, label, lib, emit, args.cases and set(args.cases.split(",")))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
