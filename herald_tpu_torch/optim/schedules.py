"""Learning-rate schedules (port of `herald_tpu/optim/schedules.py`).

The step-only schedules are factories of `fn(step) -> lr`. `step` is the
engine's 0-d int32 step tensor (1-based) and `lr` a 0-d float32 tensor on
the step's device, as the JAX functions return a 0-d f32 array, so the
optimizers see the same dtypes in both packages. `ReduceOnPlateau` depends
on observed metrics and runs on the host between steps.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def fixed(lr: float) -> Callable:
    # a fill on the device: `torch.tensor(lr, device=...)` would copy from
    # the host and wait for the card once per call
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def step_decay(lr: float, step_size: int, gamma: float = 0.1,
               ending: float = 1e-8) -> Callable:
    def f(step):
        k = torch.floor((step - 1) / step_size)
        return torch.clamp(lr * gamma ** k, min=ending).to(torch.float32)
    return f


def multistep(lr: float, milestones: Sequence[int],
              gamma: float = 0.1) -> Callable:
    ms = sorted(milestones)
    # the milestones on each device and dtype they meet, copied there once:
    # a copy per call would be a host-to-card copy inside every step
    held = {}

    def f(step):
        key = (step.device, step.dtype)
        if key not in held:
            held[key] = torch.tensor(ms, dtype=step.dtype,
                                     device=step.device)
        k = (step > held[key]).sum()
        return (lr * gamma ** k.to(torch.float32)).to(torch.float32)
    return f


def exponential(lr: float, gamma: float = 0.9,
                ending: float = 1e-8) -> Callable:
    def f(step):
        return torch.clamp(lr * gamma ** (step - 1).to(torch.float32),
                           min=ending).to(torch.float32)
    return f


def cosine(lr: float, total_steps: int, min_lr: float = 0.0) -> Callable:
    def f(step):
        t = torch.clamp((step - 1) / max(total_steps - 1, 1), 0.0, 1.0)
        return (min_lr + 0.5 * (lr - min_lr)
                * (1 + torch.cos(math.pi * t))).to(torch.float32)
    return f


SCHEDULES = {
    "constant": lambda lr, **kw: fixed(lr),
    "step": lambda lr, **kw: step_decay(lr, kw.get("step_size", 1000),
                                        kw.get("gamma", 0.1)),
    "multistep": lambda lr, **kw: multistep(lr, kw.get("milestones", [])),
    "exp": lambda lr, **kw: exponential(lr, kw.get("gamma", 0.9)),
    "cosine": lambda lr, **kw: cosine(lr, kw.get("total_steps", 10000)),
}


def get_schedule(name: str, lr: float, **kw) -> Callable:
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; have "
                         f"{sorted(SCHEDULES)}")
    return SCHEDULES[name](lr, **kw)


class ReduceOnPlateau:
    """Host-side plateau scheduler (reference ReduceOnPlateauScheduler,
    `lr_scheduler.py:83-130`)."""

    def __init__(self, lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 ending: float = 1e-8):
        if mode not in ("min", "max") or threshold_mode not in ("rel",
                                                                "abs"):
            raise ValueError(f"mode {mode!r} / threshold_mode "
                             f"{threshold_mode!r}: expected min|max and "
                             f"rel|abs")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.ending = ending
        self.best = None
        self.bad_count = 0
        self.cooldown_left = 0

    def _better(self, value) -> bool:
        if self.best is None:
            return True
        t = self.threshold
        if self.mode == "min":
            bound = self.best * (1 - t) if self.threshold_mode == "rel" \
                else self.best - t
            return value < bound
        bound = self.best * (1 + t) if self.threshold_mode == "rel" \
            else self.best + t
        return value > bound

    def step(self, value) -> float:
        if self._better(value):
            self.best = value
            self.bad_count = 0
        elif self.cooldown_left > 0:
            self.cooldown_left -= 1
        else:
            self.bad_count += 1
            if self.bad_count > self.patience:
                self.lr = max(self.lr * self.factor, self.ending)
                self.bad_count = 0
                self.cooldown_left = self.cooldown
        return self.lr

    def get(self) -> float:
        return self.lr
