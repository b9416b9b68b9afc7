"""The scan kernels' share of their roofline in a batch cell: the least time
of the bytes and operations that the port's scan counter says the traced
window's scan replays read and did (ScanGraphs.scan_report(), work.py's
peaks; TF32 where the calls have two queries or more) over the device time
of the operations those replays ran (the stage-1 kernel
packed_topk_mma_kernel or packed_topk_kernel, the pool's exact rescore and
the translations around them, matched to the replays' cudaGraphLaunch), in
%. Host-side operations between the replays do not dilute it."""

from portbench import peaks


def read(r: dict):
    if r.get("kind") != "batch" or not r.get("scan_kernel_s"):
        return None
    work = r.get("scan_work") or {}
    if not work.get("calls"):
        return None
    computed_in = "tf32" if work["queries"] >= 2 * work["calls"] else "float32"
    least = peaks.least_seconds(work["flops"], work["bytes"], computed_in)
    return 100.0 * least / r["scan_kernel_s"]
