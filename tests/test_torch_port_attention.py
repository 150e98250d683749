"""Port attention (fairfedmed_tpu_torch/ops/attention.py) against the JAX
package's Pallas kernel in interpret mode.  The CUDA kernels themselves are
held against their plain versions in test_torch_port_kernels.py (on a card).

Inputs come from numpy with a fixed seed and go to both stacks at fp32.
Tolerances: forward atol 2e-5, gradients atol 1e-4 -- fp32 sums taken in a
different order on each side (the Pallas kernel pads L to 128; the port masks
the tail instead).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fairfedmed_tpu.ops.attention import flash_attention as jax_flash_attention
from fairfedmed_tpu_torch.ops import attention as A

torch.set_num_threads(1)

SHAPES = [((2, 3, 197, 64), False), ((2, 2, 77, 64), True), ((2, 4, 16, 8), True)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _causal(length):
    return np.triu(np.full((length, length), -np.inf, np.float32), k=1)


@pytest.mark.parametrize("shape,causal", SHAPES)
def test_forward_and_grads_match_pallas_interpret(shape, causal):
    q, k, v, g = _inputs(shape, seed=shape[2])
    mask = _causal(shape[2]) if causal else None

    jmask = None if mask is None else jnp.asarray(mask)
    out_j, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, jmask, interpret=True),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = A.flash_attention(tq, tk, tv, None if mask is None else torch.tensor(mask))
    out_t.backward(torch.tensor(g))

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=2e-5, rtol=0)
    for t, j in zip((tq, tk, tv), grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-4, rtol=0)


def test_plain_backward_matches_autograd_of_plain_forward():
    """reference_attention_bwd is the hand-derived gradient of
    reference_attention (the formulas the CUDA backward implements)."""
    q, k, v, g = (torch.tensor(x) for x in _inputs((6, 33, 16), seed=3))
    mask = torch.tensor(_causal(33))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    A.reference_attention(*leaves, mask).backward(g)
    for auto, manual in zip(leaves, A.reference_attention_bwd(q, k, v, g, mask)):
        np.testing.assert_allclose(manual.numpy(), auto.grad.numpy(), atol=1e-5, rtol=0)


def test_cpu_path_launches_no_kernel():
    before = (A.attention_fwd.launches, A.attention_bwd.launches)
    q, k, v = (torch.randn(1, 2, 9, 8, requires_grad=True) for _ in range(3))
    A.flash_attention(q, k, v).sum().backward()
    assert (A.attention_fwd.launches, A.attention_bwd.launches) == before


def test_kernel_entry_points_refuse_cpu_tensors():
    q = torch.zeros(2, 5, 64)
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_bwd(q, q, q, q, torch.zeros(2, 5), q)


def test_dense_copies_only_misaligned_or_strided_tensors():
    t = torch.zeros(2, 5, 8)
    assert A._dense(t) is t
    shifted = torch.zeros(2 * 5 * 8 + 1)[1:].view(2, 5, 8)
    assert A._dense(shifted).data_ptr() % 16 == 0
    strided = torch.zeros(2, 8, 5).transpose(1, 2)
    assert A._dense(strided).is_contiguous()
