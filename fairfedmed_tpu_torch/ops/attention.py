"""Fused multi-head attention: hand-written CUDA kernels for Hopper.

Port of ``fairfedmed_tpu/ops/attention.py``.  Two kernels replace the two
Pallas TPU kernels there:

* ``csrc/attention_fwd.cu`` replaces ``_fwd_kernel`` (``_attend_impl``);
* ``csrc/attention_bwd.cu`` replaces ``_bwd_kernel`` (``_attend_bwd_impl``).

What bounds them on the H100 and how their design answers it is written at
the top of each source.  In short: at CLIP's lengths (197 / <= 77 tokens,
head width 64) attention is memory-bound, so the kernels keep the [L, L]
scores on chip and move each [L, dh] tensor as few times as they can; the
forward saves the per-row log-sum-exp so the backward rebuilds P without a
second softmax pass.  bf16 at head width 16/32/64 (every CLIP tower) runs on
the tensor cores: the forward is one block per 128 query rows with the
head's K and V resident in shared memory, the backward one block per
(batch*head) that holds Q, K, V, dO and O, computes rowsum(dO*O) itself, and
produces dK/dV and then dQ in one launch without atomics.  Tiles arrive by
asynchronous copies and feed the tensor cores through ``ldmatrix``.  fp32
and the other widths run scalar fp32 kernels.  Unlike the TPU kernel, L is
not padded to 128: the ragged tail is masked inside the kernels.

:func:`attention_fwd` / :func:`attention_bwd` launch the kernels on CUDA
tensors and count their launches.  :func:`reference_attention` /
:func:`reference_attention_bwd` are the plain PyTorch versions of the same
two functions: the CPU path and the yardstick the kernels are checked
against.  ``_Attend`` (the counterpart of the JAX ``_attend`` custom VJP)
takes the plain version for a CPU tensor and the kernel for a CUDA tensor,
never falling back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH_HEADS = 65535  # gridDim.y


def _check_kernel_inputs(q, k, v, mask, *others):
    tensors = (q, k, v, *others)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("attention kernels take CUDA tensors on one device")
    if q.dim() != 3 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"attention kernels take equal [n, L, dh] tensors, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"attention kernels take float32 or bfloat16 tensors of one "
                         f"type, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("attention kernels take contiguous, 16-byte aligned tensors")
    n, length, dh = q.shape
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"attention kernels take head width in {SUPPORTED_HEAD_DIMS}, got {dh}")
    if not (0 < n <= _MAX_BATCH_HEADS and length > 0):
        raise ValueError(f"attention kernels take 1..{_MAX_BATCH_HEADS} (batch*head) slices "
                         f"of length >= 1, got n={n}, L={length}")
    if mask is not None and (mask.device != q.device or mask.dtype != torch.float32
                             or mask.shape != (length, length) or not mask.is_contiguous()):
        raise ValueError(f"the attention mask must be a contiguous float32 [{length}, {length}] "
                         f"tensor on {q.device}")


def _raise_on_error(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when contiguous and 16-byte aligned (the kernels' 16-byte
    loads), else a fresh contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def attention_fwd(q, k, v, mask=None):
    """Kernel forward.  q (already scaled), k, v: CUDA [n, L, dh]; mask: fp32
    [L, L] or None.  Returns (o [n, L, dh] in q's type, lse [n, L] fp32)."""
    _check_kernel_inputs(q, k, v, mask)
    n, length, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((n, length), device=q.device, dtype=torch.float32)
    fn = _build.load("attention_fwd")
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(o), _ptr(lse), n, length, dh,
             _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(err, "attention forward")
    attention_fwd.launches += 1
    return o, lse


attention_fwd.launches = 0


def attention_bwd(q, k, v, o, lse, do, mask=None):
    """Kernel backward.  Takes the forward's inputs, its output ``o`` and
    log-sum-exp ``lse``, and the output gradient ``do``; returns (dq, dk, dv)
    in q's type (dq with respect to the scaled q)."""
    _check_kernel_inputs(q, k, v, mask, o, do)
    n, length, dh = q.shape
    if lse.shape != (n, length) or lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise ValueError("lse must be the forward's contiguous float32 [n, L] output")
    delta = torch.empty_like(lse)  # scratch of the scalar kernels
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = _build.load("attention_bwd")
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(o), _ptr(do), _ptr(lse),
             _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv), n, length, dh,
             _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(err, "attention backward")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


def launch_info(kind: str, n: int, length: int, dh: int) -> dict:
    """How the tensor-core kernel ``kind`` ("fwd" or "bwd") launches for bf16
    [n, length, dh] (dh in 16, 32, 64), from the CUDA runtime on the current
    card: blocks, threads per block, shared bytes per block, resident blocks
    per SM, registers and local (spilled) bytes per thread."""
    out = (ctypes.c_int * 6)()
    fn = _build.load(f"attention_{kind}", f"ffm_attention_{kind}_info")
    _raise_on_error(fn(n, length, dh, _DTYPE_CODES[torch.bfloat16], ctypes.addressof(out)),
                    f"attention {kind} info")
    keys = ("blocks", "threads", "smem_bytes", "blocks_per_sm", "registers", "local_bytes")
    return dict(zip(keys, out))


def reference_attention(q, k, v, mask=None):
    """Plain forward of the kernel's function: q (already scaled), k, v
    [n, L, dh]; softmax in fp32 with P kept fp32; output in q's type."""
    s = torch.einsum("nqd,nkd->nqk", q.float(), k.float())
    if mask is not None:
        s = s + mask
    p = torch.softmax(s, dim=-1)
    return torch.einsum("nqk,nkd->nqd", p, v.float()).to(q.dtype)


def reference_attention_bwd(q, k, v, do, mask=None):
    """Plain backward of the kernel's function (the math of the TPU
    ``_bwd_kernel``): returns (dq, dk, dv) in q's type."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("nqd,nkd->nqk", qf, kf)
    if mask is not None:
        s = s + mask
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("nqk,nqd->nkd", p, dof)
    dp = torch.einsum("nqd,nkd->nqk", dof, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("nqk,nkd->nqd", ds, kf)
    dk = torch.einsum("nqk,nqd->nkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attend(torch.autograd.Function):
    """Counterpart of the JAX ``_attend`` custom VJP: kernel on CUDA tensors,
    plain version on CPU tensors; the mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        if q.is_cuda:
            o, lse = attention_fwd(q, k, v, mask)
            ctx.save_for_backward(q, k, v, mask, o, lse)
        else:
            o = reference_attention(q, k, v, mask)
            ctx.save_for_backward(q, k, v, mask)
        return o

    @staticmethod
    def backward(ctx, do):
        do = _dense(do)
        if do.is_cuda:
            q, k, v, mask, o, lse = ctx.saved_tensors
            dq, dk, dv = attention_bwd(q, k, v, o, lse, do, mask)
        else:
            q, k, v, mask = ctx.saved_tensors
            dq, dk, dv = reference_attention_bwd(q, k, v, do, mask)
        return dq, dk, dv, None


def flash_attention(q, k, v, mask=None, scale=None):
    """Fused attention.  q/k/v: [B, H, L, dh]; mask: additive [L, L] or None.

    The scale (dh^-0.5 by default) is folded into q before the kernel, as in
    the JAX ``flash_attention``.  Differentiable in q, k and v."""
    b, h, length, dh = q.shape
    scale = dh ** -0.5 if scale is None else scale
    q = _dense((q * scale).reshape(b * h, length, dh))
    k = _dense(k.reshape(b * h, length, dh))
    v = _dense(v.reshape(b * h, length, dh))
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    out = _Attend.apply(q, k, v, mask)
    return out.reshape(b, h, length, dh)
