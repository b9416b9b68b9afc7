"""The device's idle share in the batch cell's traced window: 1 less the
union of the device operations' intervals over the window, in %."""


def read(r: dict):
    if r.get("kind") != "batch" or not r.get("device_ops"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["traced_window_s"])
