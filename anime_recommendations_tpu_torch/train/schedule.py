"""Trapezoid learning-rate schedule.

A copy of anime_recommendations_tpu/train/schedule.py: linear ramp from
start_lr to max_lr over rampup_epochs, hold at max_lr for sustain_epochs,
then exponential decay of the (max_lr - min_lr) gap toward min_lr.
"""

from __future__ import annotations


def lr_for_epoch(
    epoch: int,
    start_lr: float = 1e-5,
    max_lr: float = 5e-5,
    min_lr: float = 1e-5,
    rampup_epochs: int = 5,
    sustain_epochs: int = 0,
    exp_decay: float = 0.8,
) -> float:
    if epoch < rampup_epochs:
        return (max_lr - start_lr) / rampup_epochs * epoch + start_lr
    if epoch < rampup_epochs + sustain_epochs:
        return max_lr
    return (max_lr - min_lr) * exp_decay ** (epoch - rampup_epochs - sustain_epochs) + min_lr
