"""Train state and optimizer (counterpart of itrx/train/state.py).

Reference semantics: one Adam over all parameters after a global-norm clip
at `grad_clip` (2.0), and the step-decay learning rate
base * 0.1^(epoch // lr_update).  As in the JAX package, the decay is a pure
function of the update count (steps_per_epoch is known at set-up), and the
rate is set on the parameter group before each update.

The clip is torch.nn.utils.clip_grad_norm_, the original reference's call:
it scales by max_norm / (norm + 1e-6) where optax scales by max_norm / norm,
a relative difference of 1e-6 / norm whenever the clip is active.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn


def step_decay_schedule(base_lr: float, steps_per_epoch: int,
                        lr_update: int) -> Callable[[int], float]:
    """count (updates so far) -> learning rate of the next update."""
    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * 0.1 ** (epoch // lr_update)

    return schedule


def make_optimizer(model: nn.Module, config: dict) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=config["learning_rate"],
                            betas=(0.9, 0.999), eps=1e-8)


@dataclass
class TrainState:
    """Model, optimizer, learning-rate schedule, clip norm and the update
    count `step` (the reference's Eiters)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    grad_clip: float
    step: int = 0

    def apply_gradients(self) -> None:
        """One update from the gradients in the parameters' `.grad`: clip
        to the global norm, set the scheduled rate, Adam, count."""
        torch.nn.utils.clip_grad_norm_(
            [p for p in self.model.parameters() if p.grad is not None], self.grad_clip)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, config: dict,
                       steps_per_epoch: int) -> TrainState:
    return TrainState(
        model=model,
        optimizer=make_optimizer(model, config),
        schedule=step_decay_schedule(config["learning_rate"], steps_per_epoch,
                                     config["lr_update"]),
        grad_clip=config["grad_clip"],
    )
