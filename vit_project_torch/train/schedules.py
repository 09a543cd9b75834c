"""LR schedules (a copy of the JAX package's train/schedules.py).

CosineAnnealingLRWithWarmup with the reference's exact stepping semantics
(train_vit_sgd.py:206-244): stepped once per EPOCH (not per optimizer step), linear
warmup for `warmup_epochs` (scale (e+1)/warmup applied at step e), then cosine from
base_lr to eta_min. Stateful with state_dict/load_state_dict for checkpoint parity.
"""
from __future__ import annotations

import math


class CosineAnnealingLRWithWarmup:
    def __init__(self, base_lr: float, warmup_epochs: int, max_epochs: int,
                 eta_min: float = 0.0):
        self.base_lr = base_lr
        self.warmup_epochs = warmup_epochs
        self.max_epochs = max_epochs
        self.eta_min = eta_min
        self.current_epoch = 0
        self.lr = base_lr  # torch applies base_lr until the first .step()

    def step(self) -> float:
        if self.current_epoch < self.warmup_epochs:
            self.lr = self.base_lr * (self.current_epoch + 1) / self.warmup_epochs
        else:
            progress = ((self.current_epoch - self.warmup_epochs)
                        / (self.max_epochs - self.warmup_epochs))
            self.lr = (self.eta_min + (self.base_lr - self.eta_min)
                       * 0.5 * (1 + math.cos(math.pi * progress)))
        self.current_epoch += 1
        return self.lr

    def peek(self) -> float:
        """LR in effect for the CURRENT epoch's optimizer steps.

        The reference steps the scheduler after each epoch's training, so epoch 0
        trains at base_lr; we mirror by using `lr` (set by the previous step()).
        """
        return self.lr

    def state_dict(self) -> dict:
        return {"current_epoch": self.current_epoch,
                "base_lrs": [self.base_lr],
                "warmup_epochs": self.warmup_epochs,
                "max_epochs": self.max_epochs,
                "eta_min": self.eta_min,
                "lr": self.lr}

    def load_state_dict(self, d: dict):
        self.current_epoch = d["current_epoch"]
        self.base_lr = d["base_lrs"][0]
        self.warmup_epochs = d["warmup_epochs"]
        self.max_epochs = d["max_epochs"]
        self.eta_min = d["eta_min"]
        self.lr = d.get("lr", self.base_lr)
