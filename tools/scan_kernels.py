#!/usr/bin/env python3
"""K2, K3 and K2q, the scan kernels, on one CUDA card.

    python3 tools/scan_kernels.py --report
    python3 tools/scan_kernels.py --time phase2|sweep [--csrc DIR | --variant NAME]
                                  [--kernels LIST] [--out FILE]
    python3 tools/scan_kernels.py --mutant NAME [--out FILE]

--report: `-Xptxas -v` of csrc/packed_topk.cu, csrc/exact_topk.cu and
csrc/packed_topk_int8.cu, each kernel's registers, shared memory and spills.

--time: builds packed_topk, exact_topk and packed_topk_int8 from one
version of the sources (this checkout's csrc/ by default; DIR, another
version's .cu files with the same C entry points, e.g. those of `git archive
<commit> anime_recommendations_tpu_torch/csrc`; or NAME, a copy of csrc/
under build/scan_kernels/NAME with one line patched, VARIANTS), then starts
torch.profiler as chip_smoke.py does and times each case through the port's
wrappers (ops/topk._packed_candidates_cuda, _exact_candidates_cuda,
_packed_candidates_int8_cuda) with that library: device time per call by
chip_smoke._profiled (20 calls after 3 warm-up, every launch of the kernel
recorded, the table warm in L2) and the CUDA-event median of a call; a
variant times its own kernel only, --kernels (e.g. packed_topk_int8) the
ones listed. `phase2`: chip_smoke.py's phase-2 K2, K3
and K2q cases (the same shapes, k and features; this script's own seeded
data). `sweep`: K2 over the 91,641 x 128 user table, f32 and bf16, top_r 4
(k = 10), an exclude, at 1 to 256 queries; K3 at 9 to 256 queries over the
user table (exclude) and the anime table (head, mask), k = 10; K2q over the
int8 user table, k = 10 and an exclude, at 1 to 256 queries, and over the
anime table with the head and a mask at 2 to 256. Beside each K2q
case, as a yardstick for its product alone, the device time of
torch._int_mm on the same int8 [Q, D] x [D, n] product (the table padded to
a multiple of 8 rows; queries padded to 32 rows where _int_mm refuses
fewer): the port never calls it, and it is not the kernel's function.

--mutant: copies the port's package, tests/test_torch_cuda.py and the
pytest settings into build/scan_kernels/mutant_NAME, patches one line of
csrc/packed_topk_int8.cu there (MUTANTS), and runs the file's int8 card
tests against it: a check that the tests catch a wrong kernel. Prints the
passed and failed counts.

One version per process. On an H100 host, processes that had loaded two
builds of the same kernels, or built kernels after their first profiler
session, lost a launch record in most sessions. So two versions are
compared by one process each, in turn: parent, new, new, parent.

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

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

SOURCES = ("packed_topk", "exact_topk", "packed_topk_int8")
PACKAGE = "anime_recommendations_tpu_torch"
CSRC = REPO / "anime_recommendations_tpu_torch" / "csrc"
BUILD = REPO / "build" / "scan_kernels"
# variant -> (source, the line patched, its replacement)
K2_BRANCH = "  if (nq > 1)\n    return launch_big"
K3_TILE = "  if (nq == 1) return 1;\n"
K2Q_MIN_Q = "constexpr int kMmaMinQ = 2;"
K2Q_B_STEP = "mma_s8(c[mt][nt], xa.x, xb.x, xa.y, xb.y, w[nt].x, w[nt].y);"
K2Q_TAIL = "    const bool kok = c + 16 * tig < width;"
K2Q_TILE = "  return (nq <= 16) != short_grid ? 16 : 64;"
VARIANTS = {
    "tensor_core": ("packed_topk", K2_BRANCH, K2_BRANCH.replace("nq > 1", "nq > 0")),
    "small_q": ("packed_topk", K2_BRANCH, K2_BRANCH.replace("nq > 1", "nq < 0")),
    "tile8": ("exact_topk", K3_TILE, K3_TILE + "  return 8;\n"),
    "tile32": ("exact_topk", K3_TILE, K3_TILE + "  return 32;\n"),
    # K2q on the int8 tensor cores from one query
    "int8_mma": ("packed_topk_int8", K2Q_MIN_Q, K2Q_MIN_Q.replace("= 2", "= 1")),
    # K2q's tensor-core branch on 16- or 64-query tiles at every Q
    "int8_tile16": ("packed_topk_int8", K2Q_TILE, "  return 16;"),
    "int8_tile64": ("packed_topk_int8", K2Q_TILE, "  return 64;"),
}
MUTANTS = {
    # B's k32 step takes its two words swapped: another k permutation than A's
    "int8_k_permutation": ("packed_topk_int8", K2Q_B_STEP,
                           K2Q_B_STEP.replace("w[nt].x, w[nt].y", "w[nt].y, w[nt].x")),
    # the last 16 dimensions of B are dropped where d % 32 == 16
    "int8_tail_dropped": ("packed_topk_int8", K2Q_TAIL,
                          K2Q_TAIL.replace("< width", "< (width & ~31)")),
}
MUTANT_TESTS = "int8 or quantized"
SWEEP_K2_QS = (1, 2, 4, 8, 9, 12, 16, 24, 32, 48, 64, 96, 128, 256)
SWEEP_K3_QS = (9, 16, 32, 64, 128, 256)
SWEEP_K2Q_QS = (*range(1, 17), 24, 32, 48, 64, 96, 128, 256)
SWEEP_K2Q_ANIME_QS = (2, 8, 16, 32, 64, 128, 256)


def ptxas_report(source: str) -> list[str]:
    """Registers, shared memory and spills of each kernel in csrc/<source>.cu."""
    from anime_recommendations_tpu_torch.ops import _kernels

    BUILD.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [_kernels.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v",
         "-o", str(BUILD / f"{source}.cubin"), str(CSRC / f"{source}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}.cu:\n{proc.stdout}{proc.stderr}")
    return [line.strip() for line in proc.stderr.splitlines()
            if "Compiling entry function" in line or "Used" in line or "spill" in line]


def patched(name: str, patch, dst: Path) -> Path:
    """dst, a copy of csrc/ with patch's (source, line, replacement) applied."""
    source, old, new = patch
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    path = dst / f"{source}.cu"
    text = path.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: the line to patch is not in {source}.cu once")
    path.write_text(text.replace(old, new))
    return dst


def sources_dir(csrc: Path | None, variant: str | None) -> Path:
    """The directory to build from: csrc, or a patched copy of the checkout's."""
    if variant is None:
        return csrc or CSRC
    return patched(variant, VARIANTS[variant], BUILD / variant)


def run_mutant(name: str) -> dict:
    """The int8 card tests against a copy of the package with mutant
    ``name``'s line patched."""
    dst = BUILD / f"mutant_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(REPO / PACKAGE, dst / PACKAGE, ignore=shutil.ignore_patterns("__pycache__"))
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


def cases(which: str, tables, rng, head, anime_mask):
    """(kernel, case name, table, queries, k, kwargs) of phase 2 or the sweep;
    a K2q case's table is a QuantizedTable and its queries f32 rows."""
    import torch

    from anime_recommendations_tpu_torch.ops import quantized

    qtables = {name: quantized.quantize_rows(t) for name, t in tables.items()}
    if which == "phase2":
        for kernel, named in (("packed_topk", cs.k2_cases()), ("exact_topk", cs.K3_CASES),
                              ("packed_topk_int8", cs.INT8_CASES)):
            for case in named:
                int8 = kernel == "packed_topk_int8"
                table, queries, kw = cs._case_inputs(rng, qtables if int8 else tables, case,
                                                     head, anime_mask)
                yield kernel, case[0], table, queries if int8 else queries.to(table.dtype), \
                    case[4], kw
        return
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        table = tables["users"].to(dtype)
        for q in SWEEP_K2_QS:
            idx = torch.from_numpy(rng.choice(cs.N_USERS, size=q, replace=False)).to("cuda")
            yield "packed_topk", f"users_{tag}_q{q}", table, table[idx], 10, dict(exclude=idx)
    for which_table in ("users", "anime"):
        for q in SWEEP_K3_QS:
            idx = torch.from_numpy(rng.choice(cs.N_USERS, size=q, replace=False)).to("cuda")
            kw = (dict(exclude=idx) if which_table == "users"
                  else dict(mask=anime_mask, head=head))
            yield ("exact_topk", f"{which_table}_f32_q{q}", tables[which_table],
                   tables["users"][idx], 10, kw)
    for q in SWEEP_K2Q_QS:
        idx = torch.from_numpy(rng.choice(cs.N_USERS, size=q, replace=False)).to("cuda")
        yield ("packed_topk_int8", f"users_int8_q{q}", qtables["users"], tables["users"][idx], 10,
               dict(exclude=idx))
    for q in SWEEP_K2Q_ANIME_QS:
        idx = torch.from_numpy(rng.choice(cs.N_USERS, size=q, replace=False)).to("cuda")
        yield ("packed_topk_int8", f"anime_int8_q{q}_head_mask", qtables["anime"],
               tables["users"][idx], 10, dict(mask=anime_mask, head=head))


def int_mm_ms(qt, q_int) -> dict:
    """torch._int_mm's device time on the int8 product [Q, D] x [D, n] alone
    (the table padded to a multiple of 8 rows; the queries to 32 rows where
    _int_mm refuses fewer), or the reason it refused."""
    import torch

    n = qt.q.shape[0]
    table = torch.nn.functional.pad(qt.q, (0, 0, 0, -n % 8))
    out = {"int_mm_q": q_int.shape[0]}
    for queries in (q_int, torch.nn.functional.pad(q_int, (0, 0, 0, max(0, 32 - q_int.shape[0])))):
        try:
            torch._int_mm(queries, table.T)
        except RuntimeError as err:
            out["int_mm_refused"] = str(err).splitlines()[0][:200]
            continue
        out["int_mm_q"] = queries.shape[0]
        out["int_mm_ms"] = cs._profiled(lambda: torch._int_mm(queries, table.T))["device_ms"]
        return out
    return out


def time_cases(card: str, which: str, label: str, libs, kernels, emit) -> None:
    import torch

    from anime_recommendations_tpu_torch.ops import quantized, topk

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 5)
    tables = {"users": cs._normal_table(rng, cs.N_USERS, torch.float32, dev),
              "anime": cs._normal_table(rng, cs.N_ANIME, torch.float32, dev)}
    head = torch.tensor([4.3, -0.7], device=dev)
    anime_mask = torch.from_numpy(rng.uniform(size=cs.N_ANIME) > 0.2).to(dev)
    for kernel, name, table, queries, k, kw in cases(which, tables, rng, head, anime_mask):
        if kernel not in kernels:
            continue
        queries = queries.contiguous()
        side = (kw.get("mask"), kw.get("exclude"), kw.get("head"))
        extra = {}
        if kernel == "packed_topk_int8":
            depth = topk.top_r_policy(k, table.q.shape[0])
            q_int, q_scale = quantized._quantize(queries.float())
            args = (table.q, q_int.contiguous(), depth, *side, q_scale, table.scale)
            launch = topk._packed_candidates_int8_cuda
            extra = int_mm_ms(table, args[1])
        elif kernel == "packed_topk":
            depth = topk.top_r_policy(k, table.shape[0])
            args, launch = (table, queries, depth, *side), topk._packed_candidates_cuda
        else:
            depth = min(k, topk.GROUP)
            args, launch = (table, queries, depth, *side), topk._exact_candidates_cuda

        def run():
            return launch(*args, lib=libs[kernel])

        prof = cs._profiled(run, match=kernel)
        emit("time", dict(card=card, version=label, kernel=kernel, case=name,
                          q=queries.shape[0], depth=depth, ms=prof["match_ms"],
                          by_kernel_ms=prof["match_by_kernel"],
                          sessions=prof["sessions"], records_lost=prof["records_lost"],
                          event_ms=cs._median_ms(run), **extra))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--report", action="store_true", help="the ptxas report")
    parser.add_argument("--time", choices=("phase2", "sweep"), default=None)
    parser.add_argument("--csrc", type=Path, default=None,
                        help="a directory of another version's .cu files")
    parser.add_argument("--variant", choices=sorted(VARIANTS), default=None)
    parser.add_argument("--mutant", choices=sorted(MUTANTS), action="append", default=[])
    parser.add_argument("--kernels", default=",".join(SOURCES),
                        help="comma-separated kernels to time (default all)")
    parser.add_argument("--out", type=Path, default=None, help="also write the JSON lines here")
    args = parser.parse_args()
    lines = []

    def emit(tag, obj):
        line = f"[{tag}] {json.dumps(obj)}"
        lines.append(line)
        print(line, flush=True)

    if args.report:
        for name in SOURCES:
            emit("ptxas", {"source": f"{name}.cu", "report": ptxas_report(name)})
    for name in args.mutant:
        emit("mutant", run_mutant(name))
    if args.time is not None:
        import torch

        from anime_recommendations_tpu_torch.ops import _kernels

        if not torch.cuda.is_available():
            raise SystemExit("scan_kernels: torch.cuda.is_available() is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
        src = sources_dir(args.csrc, args.variant)
        # Every build and load before the first profiler session.
        libs = {name: _kernels.load(_kernels.build(name, csrc=src), name) for name in SOURCES}
        cs.start_profiler()
        label = args.variant or (str(args.csrc) if args.csrc else "checkout")
        # A variant times only the kernel it changes.
        kernels = (VARIANTS[args.variant][0],) if args.variant else args.kernels.split(",")
        time_cases(card, args.time, label, libs, kernels, emit)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
