"""The port's CUDA attention kernels against their plain PyTorch versions.

The kernel tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  This file imports no JAX, so on a machine with a card it runs
on its own:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -q

The bf16 cases at head width 16, 32 and 64 run the tensor-core kernels; fp32
and the other widths the scalar ones.  Tolerances are relative to the
largest reference value: fp32 1e-4 (sums in another order), bf16 2e-2
(outputs rounded once to bf16, 2^-8, and the backward's rowsum(dO*O) taken
from the rounded output).
"""

import pytest
import torch

from fairfedmed_tpu_torch.ops import _build
from fairfedmed_tpu_torch.ops import attention as A

torch.set_num_threads(1)


def test_library_path_tracks_sources_and_flags(monkeypatch):
    fwd, bwd = _build.library_path("attention_fwd"), _build.library_path("attention_bwd")
    assert fwd.parent == bwd.parent == _build.BUILD_DIR
    assert fwd != bwd and fwd.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("attention_fwd") != fwd


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, n, length, dh, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(n, length, dh, device=device, generator=gen).to(dtype)
                   for _ in range(4))
    return (q * dh ** -0.5).contiguous(), k, v, do


def _causal(length, device):
    return torch.triu(torch.full((length, length), float("-inf"), device=device), 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,length,dh,causal", [(384, 197, 64, False), (32, 16, 64, True),
                                                (32, 77, 64, True), (4, 50, 8, True),
                                                (6, 33, 16, False), (5, 70, 32, False),
                                                (3, 130, 128, True)])
def test_kernels_match_plain_on_card(cuda_device, dtype, tol, n, length, dh, causal):
    q, k, v, do = _qkv(cuda_device, n, length, dh, dtype)
    mask = _causal(length, cuda_device) if causal else None
    o, lse = A.attention_fwd(q, k, v, mask)
    grads = A.attention_bwd(q, k, v, o, lse, do, mask)
    torch.cuda.synchronize()
    pairs = [(o, A.reference_attention(q, k, v, mask))]
    pairs += list(zip(grads, A.reference_attention_bwd(q, k, v, do, mask)))
    for got, ref in pairs:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.gpu
def test_flash_attention_on_card_goes_through_the_kernels(cuda_device):
    q, k, v, do = _qkv(cuda_device, 6, 77, 64, torch.float32, seed=1)
    q4, k4, v4 = (t.view(2, 3, 77, 64).clone().requires_grad_(True) for t in (q, k, v))
    mask = _causal(77, cuda_device)
    before = (A.attention_fwd.launches, A.attention_bwd.launches)
    out = A.flash_attention(q4, k4, v4, mask, scale=1.0)
    out.backward(do.view(2, 3, 77, 64))
    assert (A.attention_fwd.launches, A.attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = A.reference_attention(q, k, v, mask)
    dq, dk, dv = A.reference_attention_bwd(q, k, v, do, mask)
    for got, want in ((out, ref), (q4.grad, dq), (k4.grad, dk), (v4.grad, dv)):
        assert (got.reshape(want.shape) - want).abs().max().item() <= 1e-4 * max(
            1.0, want.abs().max().item())


@pytest.mark.gpu
def test_kernel_wrapper_rejects_unsupported_inputs_on_card(cuda_device):
    q = torch.zeros(2, 5, 256, device=cuda_device)
    with pytest.raises(ValueError, match="head width"):
        A.attention_fwd(q, q, q)
    h = torch.zeros(2, 5, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A.attention_fwd(h, h, h)
    s = torch.zeros(2, 64, 5, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous, 16-byte aligned"):
        A.attention_fwd(s, s, s)
    m = torch.zeros(2 * 5 * 64 + 1, device=cuda_device, dtype=torch.bfloat16)[1:].view(2, 5, 64)
    with pytest.raises(ValueError, match="contiguous, 16-byte aligned"):
        A.attention_fwd(m, m, m)
