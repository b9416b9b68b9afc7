"""The scan graphs' replay share in the batch cell: the RecContext's
ScanGraphs hits over its calls (hits and misses) in the window, in %."""


def read(r: dict):
    if r.get("kind") != "batch" or not r.get("scan_calls"):
        return None
    return 100.0 * r["scan_hits"] / r["scan_calls"]
