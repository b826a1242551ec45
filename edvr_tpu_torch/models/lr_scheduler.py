"""Learning-rate schedules as plain functions of the iteration, copied from
``edvr_tpu/models/lr_scheduler.py`` (reference:
basicsr/models/lr_scheduler.py: MultiStepRestartLR :6-46,
CosineAnnealingRestartLR :70-118, and the linear warm-up of
base_model.py:140-162). The engine sets each param group's ``lr`` from
them before every step.
"""

from __future__ import annotations

import math


def multi_step_restart_lr(base_lr: float, milestones, gamma: float = 0.1,
                          restarts=(0,), restart_weights=(1,)):
    """MultiStep decay with restarts: at each restart the lr resets to
    ``base_lr * weight``; each milestone after the latest restart
    multiplies it by ``gamma``."""
    if len(restarts) != len(restart_weights):
        raise ValueError('restarts and restart_weights differ in length')
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        weight, last_restart = 1.0, 0
        for r, w in zip(restarts, restart_weights):
            if step >= r:
                weight, last_restart = w, r
        lr = base_lr * weight
        for m in milestones:
            if last_restart < m <= step:
                lr *= gamma
        return lr

    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods,
                                restart_weights=(1,), eta_min: float = 0.0):
    """Cosine annealing within each period, restarting with a weight."""
    if len(periods) != len(restart_weights):
        raise ValueError('periods and restart_weights differ in length')
    cumulative = [sum(periods[:i + 1]) for i in range(len(periods))]

    def schedule(step: int) -> float:
        idx = len(periods) - 1
        for i, c in enumerate(cumulative):
            if step <= c:
                idx = i
                break
        nearest_restart = 0 if idx == 0 else cumulative[idx - 1]
        return eta_min + restart_weights[idx] * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * (step - nearest_restart) / periods[idx]))

    return schedule


def constant_lr(base_lr: float):
    return lambda step: base_lr


def with_warmup(schedule, base_lr: float, warmup_iter: int = -1):
    """Linear warm-up from 0 over ``warmup_iter`` iterations, then the
    base schedule."""
    if warmup_iter is None or warmup_iter <= 0:
        return schedule

    def warmed(step: int) -> float:
        if step < warmup_iter:
            return base_lr * step / float(warmup_iter)
        return schedule(step)

    return warmed


def build_schedule(train_opt: dict, base_lr: float):
    """A step -> lr function from the YAML ``scheduler`` block."""
    sched_opt = dict(train_opt.get('scheduler') or {})
    sched_type = sched_opt.pop('type', None)
    if sched_type in ('MultiStepLR', 'MultiStepRestartLR'):
        schedule = multi_step_restart_lr(base_lr, **sched_opt)
    elif sched_type == 'CosineAnnealingRestartLR':
        schedule = cosine_annealing_restart_lr(base_lr, **sched_opt)
    elif sched_type in (None, 'ConstantLR'):
        schedule = constant_lr(base_lr)
    else:
        raise NotImplementedError(
            f'Scheduler {sched_type} is not implemented yet.')
    return with_warmup(schedule, base_lr, train_opt.get('warmup_iter', -1))
