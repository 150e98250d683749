"""The port's CUDA attention kernels against their plain PyTorch versions.

The kernel tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  This file imports no JAX, so on a machine with a card it runs
on its own:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -q

The bf16 cases at head width 16, 32 and 64 run the tensor-core kernels (the
packed short-row ones at L <= 64, the warpgroup ones beyond); fp32 and the
other widths the scalar ones.  Tolerances are relative to the largest
reference value: fp32 1e-4 (sums in another order), bf16 2e-2 (outputs
rounded once to bf16, 2^-8, and the backward's rowsum(dO*O) taken from the
rounded output); the wgmma unit check 1e-4 (fp32 sums of exact bf16
products, or of ~16-bit high + low parts).
"""

import ctypes
import re

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


def _c_prototypes(source: str) -> dict:
    """{symbol: [ctypes type per parameter]} of the ``extern "C"`` functions
    of one CUDA source: pointers (the stream included) are c_void_p, ints
    c_int."""
    protos = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source):
        types = []
        for param in params.split(","):
            decl = " ".join(param.split())
            if "*" in decl:
                types.append(ctypes.c_void_p)
            elif re.fullmatch(r"int \w+", decl):
                types.append(ctypes.c_int)
            else:
                raise AssertionError(f"{name}: parameter {decl!r} is neither a pointer nor int")
        protos[name] = types
    return protos


def test_build_signatures_match_the_c_prototypes():
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert [p.stem for p in sources] == sorted(_build.SOURCES) == sorted(_build.SIGNATURES)
    for path in sources:
        protos = _c_prototypes(path.read_text())
        assert protos == _build.SIGNATURES[path.stem], path.name


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


# 1-64: the packed kernels; 65 on: the warpgroup ones, whose last key tile runs
# 1-4 steps of 16 keys (65, 197: 1; 600: 2; 255, 256: 4); 257 and 600 run
# the ring paths and the backward's two launches
_LENGTHS = (1, 15, 16, 17, 63, 64, 65, 197, 255, 256, 257, 600)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("length", _LENGTHS)
def test_tensor_core_kernels_across_lengths(cuda_device, length, dh, causal):
    q, k, v, do = _qkv(cuda_device, 3, length, dh, torch.bfloat16, seed=length)
    mask = _causal(length, cuda_device) if causal else None
    o, lse = A.attention_fwd(q, k, v, mask)
    grads = A.attention_bwd(q, k, v, o, lse, do, mask)
    torch.cuda.synchronize()
    s = torch.einsum("nqd,nkd->nqk", q.float(), k.float()) + (0 if mask is None else mask)
    # lse: fp32 from the same bf16 inputs on both sides, sums in another order
    assert (lse - torch.logsumexp(s, -1)).abs().max().item() <= 1e-3
    pairs = [(o, A.reference_attention(q, k, v, mask))]
    pairs += list(zip(grads, A.reference_attention_bwd(q, k, v, do, mask)))
    for got, ref in pairs:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [16, 24, 77, 197, 300])
def test_fully_masked_row_gives_zeros(cuda_device, dtype, length):
    q, k, v, do = _qkv(cuda_device, 4, length, 64, dtype, seed=3)
    mask = _causal(length, cuda_device)
    mask[5] = float("-inf")  # query 5 sees no key
    o, lse = A.attention_fwd(q, k, v, mask)
    dq, dk, dv = A.attention_bwd(q, k, v, o, lse, do, mask)
    torch.cuda.synchronize()
    assert torch.isinf(lse[:, 5]).all() and (lse[:, 5] > 0).all()
    assert (o[:, 5] == 0).all() and (dq[:, 5] == 0).all()
    for t in (o, lse[:, 6:], dq, dk, dv):
        assert torch.isfinite(t).all()
    keep = torch.ones(length, dtype=torch.bool, device=cuda_device)
    keep[5] = False
    ref_o = A.reference_attention(q[:, keep], k, v, mask[keep])
    assert (o[:, keep].float() - ref_o.float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("length", [24, 197, 600])
def test_backward_is_deterministic(cuda_device, length):
    q, k, v, do = _qkv(cuda_device, 24, length, 64, torch.bfloat16, seed=5)
    o, lse = A.attention_fwd(q, k, v)
    first = A.attention_bwd(q, k, v, o, lse, do)
    second = A.attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_launch_info_of_the_tensor_core_kernels(cuda_device):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n, length in ((384, 197), (1600, 24), (800, 16), (32, 77), (3, 600), (531, 33)):
        for kind in ("fwd", "bwd"):
            info = A.launch_info(kind, n, length, 64)
            plan = A.launch_plan(kind, n, length, 64, sms)
            assert {k: info[k] for k in ("blocks", "threads", "smem_bytes", "slices_per_block",
                                         "launches")} == {
                k: plan[k] for k in ("blocks", "threads", "smem_bytes", "slices_per_block",
                                     "launches")}, (kind, n, length)
            assert info["blocks_per_sm"] >= 1 and 0 < info["registers"] <= 255
    # short rows: several packed blocks resident per SM, every warp with rows
    for kind in ("fwd", "bwd"):
        info = A.launch_info(kind, 1600, 24, 64)
        assert info["slices_per_block"] == 2 and info["threads"] == 2 * 2 * 32
        assert info["blocks_per_sm"] > 1
    with pytest.raises(RuntimeError, match="info"):
        A.launch_info("fwd", 4, 16, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(A.WGMMA_CHECK_MODES))
@pytest.mark.parametrize("d", [16, 32, 64])
def test_wgmma_unit_check_on_card(cuda_device, d, mode):
    gen = torch.Generator(device=cuda_device).manual_seed(10 * d + mode)
    a = torch.randn(*{2: (64, 64), 3: (64, 32)}.get(mode, (64, d)), device=cuda_device,
                    generator=gen)
    a = a if mode == 3 else a.to(torch.bfloat16)
    b = torch.randn(64, d, device=cuda_device, generator=gen).to(torch.bfloat16)
    got = A.wgmma_check(a, b, mode)
    torch.cuda.synchronize()
    ref = A.wgmma_check_reference(a, b, mode)
    assert (got - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("length", [1, 15, 16, 17, 24, 32])
def test_packed_kernels_with_a_partial_last_block(cuda_device, length):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n = 4 * sms + 3  # the last block holds fewer slices than the others
    for kind in ("fwd", "bwd"):
        spb = A.launch_info(kind, n, length, 32)["slices_per_block"]
        assert spb > 1 and n % spb != 0, (kind, spb)
    q, k, v, do = _qkv(cuda_device, n, length, 32, torch.bfloat16, seed=length)
    mask = _causal(length, cuda_device)
    o, lse = A.attention_fwd(q, k, v, mask)
    grads = A.attention_bwd(q, k, v, o, lse, do, mask)
    torch.cuda.synchronize()
    pairs = [(o, A.reference_attention(q, k, v, mask))]
    pairs += list(zip(grads, A.reference_attention_bwd(q, k, v, do, mask)))
    for got, ref in pairs:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, ref.float().abs().max().item()), err


# EVA02-CLIP-L/14-336: 16 heads of 64 over 577 tokens (more than 4 tiles of
# 64 rows: the forward's ring of K/V slots, the backward's two launches), the
# training step's 32 images and the evaluation's batches of 100
@pytest.mark.gpu
@pytest.mark.parametrize("n", [32 * 16, 100 * 16])
def test_kernels_at_eva02_length(cuda_device, n):
    q, k, v, do = _qkv(cuda_device, n, 577, 64, torch.bfloat16, seed=n)
    o, lse = A.attention_fwd(q, k, v)
    grads = A.attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    pairs = [(o, A.reference_attention(q, k, v))]
    pairs += list(zip(grads, A.reference_attention_bwd(q, k, v, do)))
    for got, ref in pairs:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, ref.float().abs().max().item()), err


def _rope_inputs(device, b, length, heads, dh, dtype, seed):
    """Packed q/k/v, the three heads' gradients and arbitrary fp32 tables
    (every dim its own angle, so a pairing mistake shows)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, length, 3 * heads * dh, device=device, generator=gen).to(dtype)
    grads = [torch.randn(b * heads, length, dh, device=device, generator=gen).to(dtype)
             for _ in range(3)]
    angles = 6 * torch.rand(length - 1, dh, device=device, generator=gen)
    return qkv, grads, angles.cos(), angles.sin()


# the kernels compute in fp32 and round once, as the plain version does; the
# fp32 values of the two sides differ by FMA contraction alone, a few fp32
# ulps of the largest input (absolute 1e-6 of it), and bf16 adds one
# rounding of either side (relative 2^-7); fp32 outputs to rounding (1e-6)
_ROPE_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -7}


def _rope_close(got, want, dtype, scale):
    return bool(((got.float() - want.float()).abs()
                 <= _ROPE_RTOL[dtype] * want.float().abs() + 1e-6 * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,length,heads,dh", [(32, 577, 16, 64), (100, 577, 16, 64),
                                               (3, 2, 2, 8), (5, 7, 3, 16), (1, 19, 1, 64),
                                               (2, 50, 4, 24)])
def test_rope_kernels_match_plain_on_card(cuda_device, dtype, b, length, heads, dh):
    from fairfedmed_tpu_torch.ops import rope as R

    qkv, grads, cos, sin = _rope_inputs(cuda_device, b, length, heads, dh, dtype, seed=length)
    before = (R.rope_qkv_fwd.launches, R.rope_qkv_bwd.launches)
    got = list(R.rope_qkv_fwd(qkv, cos, sin, heads))
    got.append(R.rope_qkv_bwd(*grads, cos, sin, heads))
    torch.cuda.synchronize()
    assert (R.rope_qkv_fwd.launches, R.rope_qkv_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = list(R.reference_rope_qkv(qkv, cos, sin, heads))
    want.append(R.reference_rope_qkv_bwd(*grads, cos, sin, heads))
    scale = max(t.float().abs().max().item() for t in [qkv, *grads])
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rope_close(g, w, dtype, scale), (g.float() - w.float()).abs().max().item()


@pytest.mark.gpu
def test_rope_op_on_card_goes_through_the_kernels(cuda_device):
    from fairfedmed_tpu_torch.ops import rope as R

    qkv, grads, cos, sin = _rope_inputs(cuda_device, 4, 37, 2, 64, torch.float32, seed=3)
    qkv.requires_grad_(True)
    before = (R.rope_qkv_fwd.launches, R.rope_qkv_bwd.launches)
    outs = R.rope_qkv(qkv, cos, sin, 2)
    torch.autograd.backward(outs, grads)
    assert (R.rope_qkv_fwd.launches, R.rope_qkv_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = R.reference_rope_qkv_bwd(*grads, cos, sin, 2)
    assert (qkv.grad - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_rope_kernel_wrapper_takes_cuda_tensors_only():
    from fairfedmed_tpu_torch.ops import rope as R

    qkv, grads, cos, sin = _rope_inputs("cpu", 2, 5, 2, 8, torch.float32, seed=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.rope_qkv_fwd(qkv, cos, sin, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.rope_qkv_bwd(*grads, cos, sin, 2)
    with pytest.raises(ValueError, match="packed"):
        R.rope_qkv_fwd(qkv[..., :-1], cos, sin, 2)
