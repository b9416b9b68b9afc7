"""The whole request path's share of the chip's peak in the batch cell: the
least time of every scan the traced window's requests asked for over the
traced window's wall time, in %."""


def read(r: dict):
    if r.get("kind") != "batch" or not r.get("device_ops"):
        return None
    return 100.0 * r["least_scan_s"] / r["traced_window_s"]
