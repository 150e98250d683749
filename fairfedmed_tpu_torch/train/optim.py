"""Optimizer and LR-schedule factories.

Port of ``fairfedmed_tpu/train/optim.py`` (Dassl optimizer.py:13-142 and
lr_scheduler.py:83-155).  Weight decay is coupled (grad += wd * param before
the momentum and adaptive machinery) for every optimizer but ``adamw``,
which decays decoupled, as the JAX package's optax chains do.

``sgd``, ``adam``, ``radam`` and ``adamw`` are the ``torch.optim`` classes:
each computes the optax transform the JAX package builds.  ``amsgrad`` and
``rmsprop`` are written here, because ``torch.optim`` computes other
functions than optax for them:

* :class:`AMSGrad` keeps the running max of the *bias-corrected* second
  moment (``optax.amsgrad``); ``torch.optim.Adam(amsgrad=True)`` takes the
  max before the bias correction.
* :class:`RMSprop` scales by the learning rate *before* the momentum trace
  (``optax.rmsprop(..., eps_in_sqrt=False)``), so a change of learning rate
  leaves the trace's past steps as they were; ``torch.optim.RMSprop``
  multiplies the whole trace by the new rate.

Each reads its learning rate from ``param_groups`` at every step, so
:func:`set_learning_rate` works for all six.  Schedules are pure functions
of the epoch counter evaluated on the host; the reference steps its
scheduler once per client-local epoch, and ``LRSchedule.lr(epoch_count)``
keeps that counting.
"""

from __future__ import annotations

import math

import torch

AVAI_OPTIMS = ["adam", "amsgrad", "sgd", "rmsprop", "radam", "adamw"]
AVAI_SCHEDS = ["single_step", "multi_step", "cosine"]


class AMSGrad(torch.optim.Optimizer):
    """``optax.amsgrad`` with coupled weight decay: m, v the Adam moments,
    v_max = max(v_max, v / (1 - b2^t)), step = lr * (m / (1 - b1^t)) /
    (sqrt(v_max) + eps).  The bias corrections are fp32, as optax's are."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
                        st[key] = torch.zeros_like(p)
                st["step"] += 1
                m, v, v_max = st["exp_avg"], st["exp_avg_sq"], st["max_exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** st["step"]).item()
                bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** st["step"]).item()
                torch.maximum(v_max, v / bc2, out=v_max)
                p.add_((m / bc1) / (v_max.sqrt() + group["eps"]), alpha=-group["lr"])


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(eps_in_sqrt=False)`` with coupled weight decay:
    v = alpha * v + (1 - alpha) * g^2, u = lr * g / (sqrt(v) + eps), then
    with momentum the trace b = momentum * b + u, and the step is u (or b)."""

    def __init__(self, params, lr, alpha=0.99, eps=1e-8, momentum=0.0, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            alpha, momentum = group["alpha"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                st = self.state[p]
                if not st:
                    st["square_avg"] = torch.zeros_like(p)
                    if momentum > 0:
                        st["momentum_buffer"] = torch.zeros_like(p)
                v = st["square_avg"]
                v.mul_(alpha).addcmul_(g, g, value=1 - alpha)
                u = group["lr"] * (g / (v.sqrt() + group["eps"]))
                if momentum > 0:
                    u = st["momentum_buffer"].mul_(momentum).add_(u)
                p.sub_(u)


def build_optimizer(params, optim_cfg, lr: float) -> torch.optim.Optimizer:
    """The optimizer ``OPTIM.NAME`` over ``params``, starting at learning
    rate ``lr``."""
    name = optim_cfg.NAME
    if name not in AVAI_OPTIMS:
        raise ValueError(f"optim must be one of {AVAI_OPTIMS}, but got {name}")
    wd, momentum = optim_cfg.WEIGHT_DECAY, optim_cfg.MOMENTUM
    betas = (optim_cfg.ADAM_BETA1, optim_cfg.ADAM_BETA2)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=wd,
                               nesterov=bool(optim_cfg.SGD_NESTEROV))
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, weight_decay=wd)
    if name == "amsgrad":
        return AMSGrad(params, lr=lr, betas=betas, weight_decay=wd)
    if name == "rmsprop":
        return RMSprop(params, lr=lr, alpha=optim_cfg.RMSPROP_ALPHA,
                       momentum=max(momentum, 0.0), weight_decay=wd)
    if name == "radam":
        return torch.optim.RAdam(params, lr=lr, betas=betas, weight_decay=wd)
    return torch.optim.AdamW(params, lr=lr, betas=betas, weight_decay=wd)


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
