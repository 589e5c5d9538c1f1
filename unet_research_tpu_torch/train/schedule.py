"""Host-side per-epoch control: plateau LR decay + early stopping (twin of
unet_research_tpu/train/schedule.py, copied: pure Python).

Exact reimplementations of the schedules every reference entry point
configures (e.g. base_model_tests/training.py:31-51: torch
ReduceLROnPlateau(factor=0.1, patience=3, threshold=1e-3 rel) monitored on
val_loss_epoch; training.py:211-216: PL EarlyStopping(patience=10,
min_delta=0)). They run in Python between epochs; the trainer hands the
learning rate to the optimizer at every step.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics, 'min' mode."""

    def __init__(
        self,
        lr: float,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 3,
        threshold: float = 1e-3,
        threshold_mode: str = "rel",
        cooldown: int = 0,
        min_lr: float = 0.0,
        eps: float = 1e-8,
    ):
        if mode != "min" or threshold_mode != "rel":
            raise ValueError("the reference uses mode='min', threshold_mode='rel'")
        self.lr = float(lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.eps = eps
        self.best = float("inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def is_better(self, current: float) -> bool:
        return current < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        """Feed the epoch metric; returns the (possibly decayed) LR."""
        current = float(metric)
        if self.is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr


class EarlyStopping:
    """PL EarlyStopping(min_delta=0, patience=10, mode='min') semantics
    (training.py:211-216)."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.wait = 0
        self.stopped = False

    def step(self, metric: float) -> bool:
        """Feed the epoch metric; returns True when training should stop."""
        current = float(metric)
        if current < self.best - self.min_delta:
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
        return self.stopped
