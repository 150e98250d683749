"""Entropic optimal transport without a host sync per iteration.

Port of ``fairfedmed_tpu/ops/sinkhorn.py`` (reference
trainers/GLP_OT_SVLoRA.py:615-675).  The JAX solvers are ``lax.while_loop``s
that run while ``i < max_iter and err >= thresh``, ``err`` being the mean
change over the whole batch.  Here each solver runs ``max_iter`` iterations
and freezes its scalings with ``torch.where`` from the iteration after the
one whose ``err`` fell below ``thresh`` (or was NaN): the same plan as the
while loop, with no ``.item()`` inside the loop.  Each returns the number of
iterations the while loop would have taken, as a tensor the caller may read
when it syncs anyway.

Both run under ``torch.no_grad`` (the reference's no_grad, the JAX
package's ``stop_gradient``) and return ``(plan, valid, iterations)``:
``valid`` is ``isfinite(plan).all()`` and the plan has NaN and inf replaced,
so the caller can skip the step on device-resident data.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _iterate(step, x0, y0, thresh: float, max_iter: int):
    """Run ``(x, y, err) = step(x, y)`` as the JAX ``while_loop`` does, with
    the loop's stop turned into a device-side freeze."""
    x, y = x0, y0
    done = torch.zeros((), dtype=torch.bool, device=x0.device)
    iters = torch.zeros((), dtype=torch.int32, device=x0.device)
    for _ in range(max_iter):
        x_new, y_new, err = step(x, y)
        x = torch.where(done, x, x_new)
        y = torch.where(done, y, y_new)
        iters = iters + (~done).int()
        done = done | ~(err >= thresh)  # a NaN err stops the loop too
    return x, y, iters


def _finish(plan: torch.Tensor):
    valid = torch.isfinite(plan).all()
    return torch.nan_to_num(plan), valid


@torch.no_grad()
def sinkhorn(K: torch.Tensor, u: torch.Tensor, v: torch.Tensor, thresh: float = 1e-3,
             max_iter: int = 100) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Balanced entropic OT.  K: [B, M, N] Gibbs kernel exp(-cost/eps); u:
    [B, M] and v: [B, N] marginals.  r <- u / (K c), c <- v / (K^T r), until
    mean |dr| < thresh.  Returns (plan [B, M, N], valid, iterations)."""
    K, u, v = K.float(), u.float(), v.float()

    def step(r, c):
        r_new = u / torch.einsum("bmn,bn->bm", K, c)
        c_new = v / torch.einsum("bmn,bm->bn", K, r_new)
        return r_new, c_new, (r_new - r).abs().mean()

    r, c, iters = _iterate(step, torch.ones_like(u), torch.ones_like(v), thresh, max_iter)
    plan, valid = _finish(r[:, :, None] * c[:, None, :] * K)
    return plan, valid, iters


@torch.no_grad()
def entropic_cot(K: torch.Tensor, a: torch.Tensor, b: torch.Tensor, max_iter: int = 100,
                 thresh: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial (unbalanced) entropic OT, entropic_COT_fast.  a: [B, M] source
    marginal, b: [B, N] target marginal (already scaled by top_percent), K:
    [B, M, N].  u <- min(1 / (diag(1/a) K v), 1); v <- 1 / (diag(1/b) K^T u),
    until mean |dv| < thresh.  Returns (plan diag(u) K diag(v), valid,
    iterations)."""
    K, a, b = K.float(), a.float(), b.float()
    dx, dy = torch.ones_like(a), torch.ones_like(b)
    kp = K / a[:, :, None]
    kq = K.transpose(1, 2) / b[:, :, None]

    def step(u, v):
        u_new = torch.minimum(dx / torch.einsum("bmn,bn->bm", kp, v), dx)
        v_new = dy / torch.einsum("bnm,bm->bn", kq, u_new)
        return u_new, v_new, (v_new - v).abs().mean()

    u, v, iters = _iterate(step, dx, dy, thresh, max_iter)
    plan, valid = _finish(u[:, :, None] * K * v[:, None, :])
    return plan, valid, iters
