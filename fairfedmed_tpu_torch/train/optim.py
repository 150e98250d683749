"""Optimizer and LR-schedule factories.

Port of ``fairfedmed_tpu/train/optim.py`` (Dassl optimizer.py:13-142 and
lr_scheduler.py:83-155).  The optimizer is ``torch.optim.SGD`` with coupled
weight decay (grad += wd * param before momentum), the reference's and the
JAX package's semantics.  The other optimizers the JAX package builds (adam,
amsgrad, rmsprop, radam, adamw) are not ported yet.  Schedules are pure
functions of the epoch counter evaluated on the host; the reference steps its
scheduler once per client-local epoch, and ``LRSchedule.lr(epoch_count)``
keeps that counting.
"""

from __future__ import annotations

import math

import torch

AVAI_OPTIMS = ["adam", "amsgrad", "sgd", "rmsprop", "radam", "adamw"]
PORTED_OPTIMS = ["sgd"]
AVAI_SCHEDS = ["single_step", "multi_step", "cosine"]


def build_optimizer(params, optim_cfg, lr: float) -> torch.optim.Optimizer:
    """Optimizer over ``params`` starting at learning rate ``lr``."""
    name = optim_cfg.NAME
    if name not in AVAI_OPTIMS:
        raise ValueError(f"optim must be one of {AVAI_OPTIMS}, but got {name}")
    if name not in PORTED_OPTIMS:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (ported: {PORTED_OPTIMS})")
    return torch.optim.SGD(params, lr=lr, momentum=optim_cfg.MOMENTUM,
                           weight_decay=optim_cfg.WEIGHT_DECAY,
                           nesterov=bool(optim_cfg.SGD_NESTEROV))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


class LRSchedule:
    """Epoch-indexed LR schedule with optional warmup."""

    def __init__(self, base_lr: float, kind: str, stepsize, gamma: float, max_epoch: int,
                 warmup_epoch: int = -1, warmup_type: str = "linear",
                 warmup_cons_lr: float = 1e-5, warmup_min_lr: float = 1e-5,
                 warmup_recount: bool = True):
        if kind not in AVAI_SCHEDS:
            raise ValueError(f"scheduler must be one of {AVAI_SCHEDS}, but got {kind}")
        if kind == "single_step":
            if isinstance(stepsize, (list, tuple)):
                stepsize = stepsize[-1]
            if stepsize <= 0:
                stepsize = max_epoch
        if kind == "multi_step" and not isinstance(stepsize, (list, tuple)):
            raise TypeError("For multi_step lr_scheduler, stepsize must be a list")
        self.base_lr = base_lr
        self.kind = kind
        self.stepsize = stepsize
        self.gamma = gamma
        self.max_epoch = max_epoch
        self.warmup_epoch = warmup_epoch
        self.warmup_type = warmup_type
        self.warmup_cons_lr = warmup_cons_lr
        self.warmup_min_lr = warmup_min_lr
        self.warmup_recount = warmup_recount

    def _base(self, epoch: int) -> float:
        if self.kind == "single_step":
            return self.base_lr * self.gamma ** (epoch // self.stepsize)
        if self.kind == "multi_step":
            k = sum(1 for m in self.stepsize if m <= epoch)
            return self.base_lr * self.gamma ** k
        return self.base_lr * (1 + math.cos(math.pi * epoch / self.max_epoch)) / 2

    def lr(self, epoch: int) -> float:
        if self.warmup_epoch > 0 and epoch < self.warmup_epoch:
            if self.warmup_type == "constant":
                return self.warmup_cons_lr
            if self.warmup_type == "linear":
                if epoch == 0:
                    return self.warmup_min_lr
                return self.base_lr * epoch / self.warmup_epoch
            raise ValueError(self.warmup_type)
        if self.warmup_epoch > 0 and self.warmup_recount:
            return self._base(epoch - self.warmup_epoch)
        return self._base(epoch)


def build_lr_scheduler(optim_cfg) -> LRSchedule:
    return LRSchedule(
        base_lr=optim_cfg.LR,
        kind=optim_cfg.LR_SCHEDULER,
        stepsize=optim_cfg.STEPSIZE,
        gamma=optim_cfg.GAMMA,
        max_epoch=optim_cfg.MAX_EPOCH,
        warmup_epoch=optim_cfg.WARMUP_EPOCH,
        warmup_type=optim_cfg.WARMUP_TYPE,
        warmup_cons_lr=optim_cfg.WARMUP_CONS_LR,
        warmup_min_lr=optim_cfg.WARMUP_MIN_LR,
        warmup_recount=optim_cfg.WARMUP_RECOUNT,
    )
