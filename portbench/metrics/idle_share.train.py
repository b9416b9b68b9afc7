"""The device's idle share in the traced epoch (the window's first): 1 less
the union of the device operations' intervals over the traced window, in %.
With fused_adam's short kernels most of it is the profiler's own activity
buffer requests and flushes, which the untraced epochs do not pay."""


def read(r: dict):
    if r.get("kind") != "train" or not r.get("device_ops"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["traced_window_s"])
