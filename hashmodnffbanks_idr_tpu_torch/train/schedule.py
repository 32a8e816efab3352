"""LR / alpha schedules (parity with idr_train.py:129-131,175-179,227-228).

A copy of ``hashmodnffbanks_idr_tpu/train/schedule.py``.
"""

from __future__ import annotations

from typing import Sequence


def multistep_lr(base_lr: float, milestones: Sequence[int], factor: float, epoch: int) -> float:
    """torch MultiStepLR: lr * factor^(#milestones passed)."""
    lr = base_lr
    for m in milestones:
        if epoch >= m:
            lr *= factor
    return lr


def annealed_alpha(base_alpha: float, milestones: Sequence[int], factor: float, epoch: int) -> float:
    """Mask-loss alpha doubled at each milestone epoch.

    Reference quirk preserved: on a fresh run the multiplication happens when
    `epoch in milestones` (idr_train.py:227-228), i.e. *at* the milestone;
    on resume the fast-forward uses `start_epoch > m` (idr_train.py:177-179).
    This helper reproduces the fresh-run behaviour for any epoch.
    """
    a = base_alpha
    for m in milestones:
        if epoch >= m:
            a *= factor
    return a
