"""Device time of the training step: every device operation's time in the
traced epochs (the profiler's trace), summed, per step, in ms."""


def read(r: dict):
    if r.get("kind") != "train" or not r.get("traced_steps") or not r.get("device_ops"):
        return None
    return 1e3 * r["device_op_s"] / r["traced_steps"]
