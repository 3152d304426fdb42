"""Learning-rate schedules: a copy of ``gnn_fluid_dynamics_tpu/training/
lr_schedule.py`` (pure Python; the port imports nothing of the JAX package),
whose values the trainer writes into the optimizer's ``param_group["lr"]``.

The five schedules of reference ``src/utils/lr_schedule.py``, re-expressed as
pure functions ``lr(t) -> float`` of the mini-epoch counter (the reference
steps its torch schedulers once per mini-epoch, ``train.py:211-241``). Being
plain host-side functions, resume is trivial (no scheduler state to restore —
just the counter) and the value feeds the jitted train step as a traced scalar.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def step_then_decay(cfg, total_mini_epochs: int) -> Schedule:
    """Warmup -> hold -> single step decay -> exponential decay to lr_min
    (reference ``StepThenDecay``, lr_schedule.py:7-95)."""
    base_lr = cfg.lr_max
    milestone = int(cfg.lr_ms1 * total_mini_epochs)
    gamma1 = cfg.lr_ms1_gamma
    exp_start = int(cfg.lr_ms2 * total_mini_epochs) if cfg.lr_ms2 else total_mini_epochs
    exp_gamma = cfg.lr_ms2_gamma
    decay_steps = max(total_mini_epochs - exp_start, 1)
    min_lr = cfg.lr_min or 1e-6
    warmup = int((cfg.lr_wu or 0) * total_mini_epochs)

    def lr(t: int) -> float:
        if warmup > 0 and t < warmup:
            return base_lr * (t / max(1, warmup))
        if t <= milestone:
            return base_lr
        if t <= exp_start:
            return base_lr * gamma1
        factor = exp_gamma ** ((t - exp_start) / decay_steps)
        return min_lr + max(base_lr * gamma1 - min_lr, 0.0) * factor

    return lr


def one_cycle(cfg, total_mini_epochs: int) -> Schedule:
    """Cosine one-cycle (reference ``OneCycle`` wrapping torch OneCycleLR,
    lr_schedule.py:97-137): initial = max/div, cos up over pct_start, cos down
    to initial/final_div."""
    max_lr = cfg.lr_max
    pct_start = cfg.lr_wu or 0.2
    div_factor = 1.0 / (cfg.lr_wu_gamma or 0.04)
    final_div = 1.0 / (cfg.lr_ms1_gamma or 1e-4)
    initial = max_lr / div_factor
    final = initial / final_div
    up_steps = max(int(pct_start * total_mini_epochs) - 1, 1)
    down_steps = max(total_mini_epochs - up_steps - 1, 1)

    def _anneal(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)

    def lr(t: int) -> float:
        if t <= up_steps:
            return _anneal(initial, max_lr, t / up_steps)
        return _anneal(max_lr, final, min((t - up_steps) / down_steps, 1.0))

    return lr


def cosine_annealing(cfg, total_mini_epochs: int) -> Schedule:
    """Linear warmup then cosine to lr_min (reference ``CosineAnnealing``,
    lr_schedule.py:140-236)."""
    warmup = int((cfg.lr_wu or 0) * total_mini_epochs)
    max_lr, min_lr = cfg.lr_max, (cfg.lr_min or 0.0)
    t_max = max(total_mini_epochs - warmup, 1)

    def lr(t: int) -> float:
        if t < warmup:
            return max_lr * (t + 1) / warmup
        tc = t - warmup
        return min_lr + 0.5 * (max_lr - min_lr) * (1 + math.cos(math.pi * tc / t_max))

    return lr


def exponential_decay(cfg, total_mini_epochs: int) -> Schedule:
    """lr = lr_max * gamma^t (reference ``ExponentialDecay``,
    lr_schedule.py:239-266)."""
    del total_mini_epochs

    def lr(t: int) -> float:
        return cfg.lr_max * (cfg.lr_ms1_gamma ** t)

    return lr


def cosine_annealing_two_phase(cfg, total_mini_epochs: int) -> Schedule:
    """Five-phase: warmup -> hold -> cosine to ms2_gamma*max -> cosine to
    lr_min -> constant (reference ``CosineAnnealingTwoPhase``,
    lr_schedule.py:268-397). The schedule used by the shipped config."""
    max_lr = cfg.lr_max
    min_lr = cfg.lr_min or 1e-6
    wu_gamma = cfg.lr_wu_gamma if cfg.lr_wu_gamma is not None else 0.04
    ms2_gamma = cfg.lr_ms2_gamma if cfg.lr_ms2_gamma is not None else 0.1

    wu = int((cfg.lr_wu or 0.0) * total_mini_epochs)
    hold = int(cfg.lr_ms1 * total_mini_epochs) - wu
    d1 = max(int(cfg.lr_ms2 * total_mini_epochs) - (wu + hold), 0)
    if cfg.lr_ms3 is not None:
        d2 = max(int(cfg.lr_ms3 * total_mini_epochs) - (wu + hold + d1), 0)
    else:
        d2 = max(total_mini_epochs - (wu + hold + d1), 0)

    def lr(t: int) -> float:
        if t < wu:
            lo = wu_gamma * max_lr
            return lo + (max_lr - lo) * (t + 1) / max(1, wu)
        ta = t - wu
        if ta < hold:
            return max_lr
        ta -= hold
        if ta < d1:
            lo = ms2_gamma * max_lr
            return lo + 0.5 * (max_lr - lo) * (1 + math.cos(math.pi * ta / max(1, d1)))
        ta -= d1
        if ta < d2:
            hi = ms2_gamma * max_lr
            return min_lr + 0.5 * (hi - min_lr) * (1 + math.cos(math.pi * ta / max(1, d2)))
        return min_lr

    return lr


SCHEDULES = {
    "StepThenDecay": step_then_decay,
    "OneCycle": one_cycle,
    "CosineAnnealing": cosine_annealing,
    "ExponentialDecay": exponential_decay,
    "CosineAnnealingTwoPhase": cosine_annealing_two_phase,
}


def get_schedule(name: str, cfg, total_mini_epochs: int) -> Schedule:
    """Lookup by ``training.lr_class`` (reference train.py:426-431)."""
    try:
        return SCHEDULES[name](cfg, total_mini_epochs)
    except KeyError:
        raise KeyError(f"unknown lr schedule {name!r}; available: "
                       f"{sorted(SCHEDULES)}") from None
