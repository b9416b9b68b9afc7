"""The scans' share of their roofline in the batch cell: the least time of
every scan the traced window's requests asked for (work.scan from the
shapes: the table read once, the queries in, k pairs out, the products in
TF32) over the device time of every operation in the traced window, in %."""


def read(r: dict):
    if r.get("kind") != "batch" or not r.get("device_ops"):
        return None
    return 100.0 * r["least_scan_s"] / r["device_op_s"]
