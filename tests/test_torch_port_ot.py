"""The port's OT solvers (``fairfedmed_tpu_torch/ops/sinkhorn.py``) against
the JAX package's ``lax.while_loop`` ones on the same seeded kernels.

The JAX solvers do not report their iteration count; the test reads it from
the final carry of their ``lax.while_loop``.  The port's count must equal it
exactly; plans agree to atol 1e-6 (fp32 sums in another order) and
``valid`` must be equal.  Cases: a loop that stops early, one that runs into
``max_iter``, and one whose kernel underflows (eps 1e-4) so the plan is
invalid on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairfedmed_tpu.ops.sinkhorn import entropic_cot as jax_cot
from fairfedmed_tpu.ops.sinkhorn import sinkhorn as jax_sinkhorn
from fairfedmed_tpu_torch.ops.sinkhorn import entropic_cot, sinkhorn

torch.set_num_threads(1)


def _problem(seed, rows=8, m=49, n=2, eps=0.1, top_percent=1.0):
    """A batch of [rows, m, n] Gibbs kernels exp(-(1 - sim)/eps) of cosine
    similarities in [-0.2, 0.6], uniform marginals (the trainer's)."""
    rng = np.random.default_rng(seed)
    sim = rng.uniform(-0.2, 0.6, size=(rows, m, n)).astype(np.float32)
    K = np.exp(-(1.0 - sim) / np.float32(eps)).astype(np.float32)
    a = np.full((rows, m), 1.0 / m, np.float32)
    b = np.full((rows, n), 1.0 / n, np.float32) * np.float32(top_percent)
    return K, a, b


def _jax(solver, K, a, b, thresh, max_iter):
    """(plan, valid, iterations) of the JAX solver.  Its ``while_loop``
    carry ends in the iteration counter, which the solver drops: a wrapper
    around ``jax.lax.while_loop`` keeps it."""
    seen = {}
    while_loop = jax.lax.while_loop

    def counting(cond, body, init):
        out = while_loop(cond, body, init)
        seen["iterations"] = int(out[-1])
        return out

    fn = jax_sinkhorn if solver == "sinkhorn" else jax_cot
    jax.lax.while_loop = counting
    try:
        plan, valid = fn(jnp.asarray(K), jnp.asarray(a), jnp.asarray(b), thresh=thresh,
                         max_iter=max_iter)
    finally:
        jax.lax.while_loop = while_loop
    return np.asarray(plan), bool(valid), seen["iterations"]


CASES = {  # name: (seed, eps, thresh, max_iter)
    "stops_early": (0, 0.1, 1e-3, 100),
    "hits_max_iter": (1, 0.1, 1e-9, 6),
    "overflows": (2, 1e-4, 1e-3, 100),
}


@pytest.mark.parametrize("solver", ["sinkhorn", "entropic_cot"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_matches_jax(solver, case):
    seed, eps, thresh, max_iter = CASES[case]
    K, a, b = _problem(seed, eps=eps, top_percent=0.8 if solver == "entropic_cot" else 1.0)
    want_plan, want_valid, want_iters = _jax(solver, K, a, b, thresh, max_iter)
    fn = sinkhorn if solver == "sinkhorn" else entropic_cot
    plan, valid, iters = fn(torch.tensor(K), torch.tensor(a), torch.tensor(b),
                            thresh=thresh, max_iter=max_iter)
    assert bool(valid) == want_valid == (case != "overflows")
    assert int(iters) == want_iters
    if case == "stops_early":
        assert 1 < int(iters) < max_iter
    elif case == "hits_max_iter":
        assert int(iters) == max_iter
    assert plan.dtype == torch.float32 and not plan.requires_grad
    np.testing.assert_allclose(plan.numpy(), want_plan, atol=1e-6, rtol=0)


def test_no_gradient_reaches_the_plan():
    K, a, b = _problem(3)
    Kt = torch.tensor(K, requires_grad=True)
    plan, valid, _ = sinkhorn(Kt, torch.tensor(a), torch.tensor(b))
    assert bool(valid) and not plan.requires_grad and plan.grad_fn is None
