"""Optimizer and LR-schedule factories.

Port of ``fairfedmed_tpu/train/optim.py`` (Dassl optimizer.py:13-142 and
lr_scheduler.py:83-155).  Weight decay is coupled (grad += wd * param before
the momentum and adaptive machinery) for every optimizer but ``adamw``,
which decays decoupled, as the JAX package's optax chains do.

:class:`FunctionalOptimizer` computes the optax transform of each of the
six as a pure function over state the caller keeps, as the client-parallel
rounds need; :func:`build_optimizer` puts the same function behind the
``torch.optim`` interface for the sequential loop.  Two ``torch.optim``
classes compute other functions than optax: ``Adam(amsgrad=True)`` takes
the running max of the second moment before the bias correction (optax
after it), and ``RMSprop`` multiplies its whole momentum trace by a new
learning rate (optax scales by the rate before the trace).

Schedules are pure functions of the epoch counter evaluated on the host;
the reference steps its scheduler once per client-local epoch, and
``LRSchedule.lr(epoch_count)`` keeps that counting.
"""

from __future__ import annotations

import math

import torch

AVAI_OPTIMS = ["adam", "amsgrad", "sgd", "rmsprop", "radam", "adamw"]
AVAI_SCHEDS = ["single_step", "multi_step", "cosine"]


class FunctionalOptimizer:
    """The optax transform of ``OPTIM.NAME`` (the JAX package's
    ``build_optimizer``) as a pure function over flat ``{path: tensor}``
    dicts, for the client-parallel rounds: every client owns a state dict of
    device tensors, its step count among them, so a step is undone with
    ``torch.where`` and the state stacks per client.  ``update`` returns new
    tensors and changes none it was given; the learning rate is a host float.
    State keys are ``count`` and ``<slot>:<path>``."""

    def __init__(self, optim_cfg):
        if optim_cfg.NAME not in AVAI_OPTIMS:
            raise ValueError(f"optim must be one of {AVAI_OPTIMS}, but got {optim_cfg.NAME}")
        self.name = optim_cfg.NAME
        self.wd = optim_cfg.WEIGHT_DECAY
        self.momentum = optim_cfg.MOMENTUM
        self.nesterov = bool(optim_cfg.SGD_NESTEROV)
        self.betas = (optim_cfg.ADAM_BETA1, optim_cfg.ADAM_BETA2)
        self.alpha = optim_cfg.RMSPROP_ALPHA
        self.eps = 1e-8
        if self.name == "sgd":
            self.slots = ("trace",) if self.momentum > 0 else ()
        elif self.name == "rmsprop":
            self.slots = ("nu", "trace") if self.momentum > 0 else ("nu",)
        elif self.name == "amsgrad":
            self.slots = ("mu", "nu", "nu_max")
        else:
            self.slots = ("mu", "nu")

    def init(self, params: dict) -> dict:
        device = next(iter(params.values())).device
        state = {"count": torch.zeros((), dtype=torch.int32, device=device)}
        for slot in self.slots:
            state.update({f"{slot}:{k}": torch.zeros_like(p) for k, p in params.items()})
        return state

    def update(self, params: dict, grads: dict, state: dict, lr: float):
        """One step: ``(new params, new state)``."""
        b1, b2 = self.betas
        count = state["count"] + 1
        countf = count.float()
        new_state = {"count": count}
        new_params = {}
        for k, p in params.items():
            g = grads[k]
            if self.wd and self.name != "adamw":  # coupled decay (add_decayed_weights)
                g = g + self.wd * p
            if self.name == "sgd":
                if self.momentum > 0:
                    t = g + self.momentum * state[f"trace:{k}"]
                    new_state[f"trace:{k}"] = t
                    g = g + self.momentum * t if self.nesterov else t
                u = -lr * g
            elif self.name == "rmsprop":  # eps outside the sqrt; lr before the trace
                nu = (1 - self.alpha) * g * g + self.alpha * state[f"nu:{k}"]
                new_state[f"nu:{k}"] = nu
                u = -lr * (g / (torch.sqrt(nu) + self.eps))
                if self.momentum > 0:
                    u = u + self.momentum * state[f"trace:{k}"]
                    new_state[f"trace:{k}"] = u
            else:
                mu = (1 - b1) * g + b1 * state[f"mu:{k}"]
                nu = (1 - b2) * (g * g) + b2 * state[f"nu:{k}"]
                new_state[f"mu:{k}"], new_state[f"nu:{k}"] = mu, nu
                mu_hat = mu / (1 - torch.pow(b1, countf))
                nu_hat = nu / (1 - torch.pow(b2, countf))
                if self.name == "amsgrad":
                    nu_hat = torch.maximum(state[f"nu_max:{k}"], nu_hat)
                    new_state[f"nu_max:{k}"] = nu_hat
                u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
                if self.name == "radam":
                    ro_inf = 2.0 / (1 - b2) - 1
                    b2t = torch.pow(b2, countf)
                    ro = ro_inf - 2 * countf * b2t / (1 - b2t)
                    r = torch.sqrt((ro - 4) * (ro - 2) * ro_inf
                                   / ((ro_inf - 4) * (ro_inf - 2) * ro))
                    u = torch.where(ro >= 5.0, r * u, mu_hat)
                elif self.name == "adamw":
                    u = u + self.wd * p
                u = -lr * u
            new_params[k] = p + u
        return new_params, new_state


class Optimizer(torch.optim.Optimizer):
    """:class:`FunctionalOptimizer` behind the ``torch.optim`` interface:
    ``step()`` updates every parameter that has a gradient in place, from
    its own state in ``self.state[p]`` (``count`` and the slots of the
    path ``param``), at its group's ``lr``."""

    def __init__(self, params, optim_cfg, lr: float):
        self.functional = FunctionalOptimizer(optim_cfg)
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        fn = self.functional
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(fn.init({"param": p}))
                new_p, new_state = fn.update({"param": p}, {"param": p.grad}, state, group["lr"])
                p.copy_(new_p["param"])
                state.update(new_state)


def build_optimizer(params, optim_cfg, lr: float) -> Optimizer:
    """The optimizer ``OPTIM.NAME`` over ``params``, starting at learning
    rate ``lr``."""
    return Optimizer(params, optim_cfg, lr)


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
