"""The training step's share of the chip's peak: the least time of one
step's work (work.train_step at the card's peaks) over the wall time per
step of the traced run's epochs after its profiler closed, in %."""


def read(r: dict):
    if r.get("kind") != "train" or not r.get("untraced_steps"):
        return None
    return 100.0 * r["least_step_s"] / (r["untraced_wall_s"] / r["untraced_steps"])
