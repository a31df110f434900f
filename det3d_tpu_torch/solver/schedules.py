"""Learning-rate and momentum schedules as functions of a step tensor.

Port of det3d_tpu/solver/schedules.py: the fastai schedules (``one_cycle``,
``exponential_decay``, ``manual_stepping``), the mmcv policy zoo
(``fixed_lr``, ``step_lr``, ``exp_lr``, ``poly_lr``, ``inv_lr``,
``cosine_lr``), ``with_warmup`` and ``build_lr_schedule``. Each schedule
maps a step count held as a tensor (the optimizer's, on the card) to an
fp32 tensor on the same device, in the JAX package's fp32 operations,
so a captured train step computes its lr and momentum on the device: a
Python float would be frozen into the graph.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch


def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


def annealing_cos(start: float, end: float, pct):
    """Cosine anneal from start to end as pct goes 0 -> 1 (fastai)."""
    cos_out = torch.cos(math.pi * pct) + 1.0
    return end + (start - end) / 2.0 * cos_out


def one_cycle(lr_max: float, total_step: int,
              moms: Sequence[float] = (0.95, 0.85), div_factor: float = 10.0,
              pct_start: float = 0.4) -> Tuple[Callable, Callable]:
    """(lr_fn, mom_fn) of the two-phase cosine OneCycle: for the first
    pct_start of the steps lr rises from lr_max / div_factor to lr_max and
    the momentum falls from moms[0] to moms[1]; then lr falls to
    lr_max / div_factor / 1e4 and the momentum rises back."""
    low_lr = lr_max / div_factor
    final_lr = low_lr / 1e4
    a1 = max(int(total_step * pct_start), 1)
    a2 = max(total_step - a1, 1)
    hi_m, lo_m = float(moms[0]), float(moms[1])

    def phases(step):
        step = _f32(step)
        return (step < a1, torch.clamp(step / a1, 0.0, 1.0),
                torch.clamp((step - a1) / a2, 0.0, 1.0))

    def lr_fn(step):
        first, p1, p2 = phases(step)
        return torch.where(first, annealing_cos(low_lr, lr_max, p1),
                           annealing_cos(lr_max, final_lr, p2))

    def mom_fn(step):
        first, p1, p2 = phases(step)
        return torch.where(first, annealing_cos(hi_m, lo_m, p1),
                           annealing_cos(lo_m, hi_m, p2))

    return lr_fn, mom_fn


def exponential_decay(initial_lr: float, total_step: int,
                      decay_length: float, decay_factor: float,
                      staircase: bool = True) -> Callable:
    decay_steps = max(int(decay_length * total_step), 1)

    def lr_fn(step):
        stage = _f32(step) / decay_steps
        if staircase:
            stage = torch.floor(stage)
        return initial_lr * torch.pow(decay_factor, stage)

    return lr_fn


def _count_passed(x, bounds):
    """How many of ``bounds`` (Python floats) lie at or below x, as fp32."""
    n = torch.zeros_like(x)
    for b in bounds:
        n = n + (x >= b).to(torch.float32)
    return n


def manual_stepping(total_step: int, boundaries: Sequence[float],
                    rates: Sequence[float]) -> Callable:
    """rates[i] from the i-th boundary (a fraction of total_step) on."""
    assert len(boundaries) + 1 == len(rates)
    bounds = [float(torch.tensor(b * total_step, dtype=torch.float32))
              for b in boundaries]
    rates = [float(torch.tensor(r, dtype=torch.float32)) for r in rates]

    def lr_fn(step):
        idx = _count_passed(_f32(step), bounds)
        lr = torch.full_like(idx, rates[0])
        for i, r in enumerate(rates[1:], 1):
            lr = torch.where(idx == i, r, lr)
        return lr

    return lr_fn


# mmcv's LR policies: epoch-based ones take steps_per_epoch and floor-
# divide, as the reference's by_epoch=True progress counting does.

def fixed_lr(base_lr: float) -> Callable:
    def lr_fn(step):
        return torch.full_like(_f32(step), base_lr)
    return lr_fn


def step_lr(base_lr: float, step_points: Sequence[int] | int,
            gamma: float = 0.1, steps_per_epoch: int = 1) -> Callable:
    """lr = base * gamma ** (milestones passed); milestones in epochs."""
    def lr_fn(step):
        progress = torch.div(_f32(step), steps_per_epoch,
                             rounding_mode="floor")
        if isinstance(step_points, int):
            exp = torch.floor(progress / step_points)
        else:
            exp = _count_passed(progress, [float(b) for b in step_points])
        return base_lr * torch.pow(gamma, exp)
    return lr_fn


def exp_lr(base_lr: float, gamma: float, steps_per_epoch: int = 1) -> Callable:
    def lr_fn(step):
        progress = torch.div(_f32(step), steps_per_epoch,
                             rounding_mode="floor")
        return base_lr * torch.pow(gamma, progress)
    return lr_fn


def poly_lr(base_lr: float, total_step: int, power: float = 1.0,
            min_lr: float = 0.0) -> Callable:
    def lr_fn(step):
        pct = torch.clamp(_f32(step) / total_step, 0.0, 1.0)
        return (base_lr - min_lr) * torch.pow(1.0 - pct, power) + min_lr
    return lr_fn


def inv_lr(base_lr: float, gamma: float, power: float = 1.0,
           steps_per_epoch: int = 1) -> Callable:
    def lr_fn(step):
        progress = torch.div(_f32(step), steps_per_epoch,
                             rounding_mode="floor")
        return base_lr * torch.pow(1.0 + gamma * progress, -power)
    return lr_fn


def cosine_lr(base_lr: float, total_step: int,
              target_lr: float = 0.0) -> Callable:
    def lr_fn(step):
        pct = torch.clamp(_f32(step) / total_step, 0.0, 1.0)
        return target_lr + 0.5 * (base_lr - target_lr) * (
            1.0 + torch.cos(math.pi * pct))
    return lr_fn


def with_warmup(lr_fn: Callable, warmup: str, warmup_iters: int,
                warmup_ratio: float = 0.1) -> Callable:
    """``lr_fn`` scaled by a constant, linear or exp warmup over the first
    ``warmup_iters`` steps."""
    if warmup not in ("constant", "linear", "exp"):
        raise ValueError(f"unsupported warmup {warmup!r}")
    assert warmup_iters > 0 and 0 < warmup_ratio <= 1.0

    def warmed(step):
        step = _f32(step)
        regular = lr_fn(step)
        pct = torch.clamp(step / warmup_iters, 0.0, 1.0)
        if warmup == "constant":
            k = torch.full_like(pct, warmup_ratio)
        elif warmup == "linear":
            k = 1.0 - (1.0 - pct) * (1.0 - warmup_ratio)
        else:
            k = torch.pow(warmup_ratio, 1.0 - pct)
        return torch.where(step < warmup_iters, regular * k, regular)

    return warmed


def build_lr_schedule(lr_config: dict, total_step: int,
                      steps_per_epoch: int = 1, base_lr: float = None):
    """(lr_fn, mom_fn or None) from a reference lr_config: the fastai
    ``type=`` schedules or the mmcv ``policy=`` zoo with its warmup (which
    needs ``base_lr``, the optimizer's lr)."""
    kind = lr_config.get("type") or lr_config.get("policy")
    if kind == "one_cycle":
        return one_cycle(lr_config["lr_max"], total_step,
                         lr_config.get("moms", (0.95, 0.85)),
                         lr_config.get("div_factor", 10.0),
                         lr_config.get("pct_start", 0.4))
    if kind == "exponential_decay":
        return (exponential_decay(lr_config["initial_learning_rate"],
                                  total_step, lr_config["decay_length"],
                                  lr_config["decay_factor"],
                                  lr_config.get("staircase", True)), None)
    if kind == "manual_stepping":
        return (manual_stepping(total_step, lr_config["boundaries"],
                                lr_config["rates"]), None)

    spe = steps_per_epoch if lr_config.get("by_epoch", True) else 1
    if base_lr is None:
        base_lr = lr_config.get("base_lr")
    if base_lr is None:
        raise ValueError(f"policy {kind!r} needs base_lr")
    if kind in ("fixed", "Fixed"):
        fn = fixed_lr(base_lr)
    elif kind in ("step", "Step"):
        fn = step_lr(base_lr, lr_config["step"], lr_config.get("gamma", 0.1),
                     spe)
    elif kind in ("exp", "Exp"):
        fn = exp_lr(base_lr, lr_config["gamma"], spe)
    elif kind in ("poly", "Poly"):
        fn = poly_lr(base_lr, total_step, lr_config.get("power", 1.0),
                     lr_config.get("min_lr", 0.0))
    elif kind in ("inv", "Inv"):
        fn = inv_lr(base_lr, lr_config["gamma"], lr_config.get("power", 1.0),
                    spe)
    elif kind in ("cosine", "Cosine"):
        fn = cosine_lr(base_lr, total_step, lr_config.get("target_lr", 0.0))
    else:
        raise ValueError(f"unknown lr schedule {kind}")
    if lr_config.get("warmup") is not None:
        fn = with_warmup(fn, lr_config["warmup"], lr_config["warmup_iters"],
                         lr_config.get("warmup_ratio", 0.1))
    return fn, None
