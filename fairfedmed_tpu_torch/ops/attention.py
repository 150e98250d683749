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
second softmax pass, and the backward computes rowsum(dO*O) itself and
produces dK/dV and dQ without atomics.  bf16 at head width 16/32/64 (every
CLIP tower) runs on the tensor cores in one of two designs, chosen by
:func:`launch_plan`: at L <= 64 (the text towers) a block packs several
(batch*head) slices, one warp per 16 rows, on ``mma.sync``; at L > 64 (the
vision towers) one block per head holds a warpgroup per 64-row tile and
runs every product on ``wgmma``, with tiles copied asynchronously into
swizzled shared memory and completed on mbarriers.  ``csrc/wgmma_check.cu``
checks those products alone (:func:`wgmma_check`).  fp32 and the other
widths run scalar fp32 kernels.  Unlike the TPU kernel, L is not padded to
128: the ragged tail is masked inside the kernels.

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


PACKED_MAX_LENGTH = 64  # L at or below: the packed kernels (csrc: kPackedMaxL)
WG_ROWS = 64  # rows of a warpgroup's tile (csrc: kWgRows)
H100_SMS = 132


def launch_plan(kind: str, n: int, length: int, dh: int, sms: int = H100_SMS) -> dict:
    """How the tensor-core kernel ``kind`` ("fwd" or "bwd") launches for bf16
    [n, length, dh] (dh in 16, 32, 64) on a card with ``sms`` SMs: the same
    arithmetic as ``csrc/attention_common.cuh:make_plan``.

    At length <= 64 the packed kernel: ``warps_per_slice`` warps of 16 rows
    each cover a slice, ``slices_per_block`` slices share a block (about 4
    warps, and at most n // sms slices, so a small call spreads over the
    SMs), and shared memory holds the slice's rows rounded up to 16 (Q, K,
    V forward; K, V, Q, dO and lse / delta backward).  Beyond, the
    warpgroup kernel: one warpgroup per 64-row tile, up to 4
    (``tiles_per_block``); the forward's blocks are persistent up to 4
    tiles (at most ``sms * (4 // tiles)`` blocks, each taking heads in turn
    with two buffers of shared memory), otherwise there is one block per
    head and group of 4 tiles; the backward gives a head two blocks, one per
    phase, when 2 n <= sms, and takes two launches beyond 4 tiles."""
    if kind not in ("fwd", "bwd") or dh not in (16, 32, 64) or n < 1 or length < 1:
        raise ValueError(f"no tensor-core plan for {kind} [{n}, {length}, {dh}]")
    if length <= PACKED_MAX_LENGTH:
        lp = -(-length // 16) * 16
        wps = lp // 16
        spb = max(1, min(4 // wps, n // sms))
        tile = lp * (dh + 8) * 2
        smem = spb * 3 * tile if kind == "fwd" else spb * (4 * tile + 2 * lp * 4)
        return {"route": "packed", "blocks": -(-n // spb), "threads": 32 * wps * spb,
                "smem_bytes": smem, "slices_per_block": spb, "warps_per_slice": wps,
                "rows_per_slice": lp, "launches": 1}
    nt = -(-length // WG_ROWS)
    slots = min(4, nt)
    tile = WG_ROWS * dh * 2
    blocks = n * -(-nt // slots)
    if kind == "fwd" and nt <= 4:  # persistent blocks (as many as fit), two buffers
        blocks = min(blocks, sms * (4 // slots))
        smem = 1024 + 2 * (3 * slots * tile + 8 * (1 + 2 * slots))
    else:
        smem = (1024 + 3 * slots * tile + 8 * (1 + 2 * slots) if kind == "fwd"
                else 1024 + 4 * slots * tile + slots * WG_ROWS * 8 + 8 * 2 * slots)
    split = kind == "bwd" and nt <= 4 and 2 * n <= sms  # few heads: a block per head and phase
    return {"route": "wgmma", "blocks": 2 * n if split else blocks, "threads": 128 * slots,
            "smem_bytes": smem, "slices_per_block": 0, "tiles_per_block": slots,
            "launches": 2 if kind == "bwd" and nt > 4 else 1, "phase_blocks": split}


def launch_info(kind: str, n: int, length: int, dh: int) -> dict:
    """How the tensor-core kernel ``kind`` ("fwd" or "bwd") launches for bf16
    [n, length, dh] (dh in 16, 32, 64), from the CUDA runtime on the current
    card: blocks (of each launch), threads per block, shared bytes per block,
    resident blocks per SM, registers and local (spilled) bytes per thread,
    slices per block (packed kernel; 0 for the warpgroup kernel) and launches
    per call."""
    out = (ctypes.c_int * 8)()
    fn = _build.load(f"attention_{kind}", f"ffm_attention_{kind}_info")
    _raise_on_error(fn(n, length, dh, _DTYPE_CODES[torch.bfloat16], ctypes.addressof(out)),
                    f"attention {kind} info")
    keys = ("blocks", "threads", "smem_bytes", "blocks_per_sm", "registers", "local_bytes",
            "slices_per_block", "launches")
    return dict(zip(keys, out))


# The wgmma unit check (csrc/wgmma_check.cu): mode -> the product it runs.
WGMMA_CHECK_MODES = {
    0: "C[64, 64] = A[64, d] B[64, d]^T, both from shared memory, K-major",
    1: "C[64, 32] = A[64, d] B[32:64, d]^T, both from shared memory, K-major",
    2: "C[64, d] = A[64, 64] B[64, d], A (bf16) from registers, B MN-major",
    3: "C[64, d] = A[64, 32] B[32:64, d], A (fp32) in bf16 high and low parts "
       "from registers, B MN-major",
    4: "C[64, 16] = A[64, d] B[16:32, d]^T, both from shared memory, K-major",
}


def wgmma_check_reference(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """The product that ``wgmma_check`` computes on the card, in fp32."""
    a, b = a.float(), b.float()
    if mode == 0:
        return a @ b.T
    if mode == 1:
        return a @ b[32:].T
    if mode == 2:
        return a @ b
    if mode == 3:
        return a @ b[32:]
    if mode == 4:
        return a @ b[16:32].T
    raise ValueError(f"wgmma check mode {mode} not in {sorted(WGMMA_CHECK_MODES)}")


def wgmma_check(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """One warpgroup product on the card (``WGMMA_CHECK_MODES[mode]``) with
    the attention kernels' copies, swizzle and descriptors; b is bf16
    [64, d] (d in 16, 32, 64), a bf16 [64, d] (modes 0, 1, 4), bf16
    [64, 64] (mode 2) or fp32 [64, 32] (mode 3).  Returns C in fp32."""
    d = b.shape[1] if b.dim() == 2 else 0
    want_a = {0: ((64, d), torch.bfloat16), 1: ((64, d), torch.bfloat16),
              2: ((64, 64), torch.bfloat16), 3: ((64, 32), torch.float32),
              4: ((64, d), torch.bfloat16)}.get(mode)
    if want_a is None or d not in (16, 32, 64) or b.shape != (64, d) or \
            b.dtype != torch.bfloat16 or tuple(a.shape) != want_a[0] or a.dtype != want_a[1]:
        raise ValueError(f"wgmma check mode {mode}: a {tuple(a.shape)} {a.dtype}, "
                         f"b {tuple(b.shape)} {b.dtype}")
    if not (a.is_cuda and b.device == a.device and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the wgmma check takes contiguous CUDA tensors on one device")
    n_out = {0: 64, 1: 32, 4: 16}.get(mode, d)
    c = torch.empty((64, n_out), device=a.device, dtype=torch.float32)
    fn = _build.load("wgmma_check")
    _raise_on_error(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), d, mode,
                       torch.cuda.current_stream(a.device).cuda_stream), "wgmma check")
    return c


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
    the JAX ``flash_attention``; at scale 1 (q arrives scaled, as the RoPE
    op gives it) q is taken as it is.  Differentiable in q, k and v."""
    b, h, length, dh = q.shape
    scale = dh ** -0.5 if scale is None else scale
    q = _dense((q if scale == 1.0 else q * scale).reshape(b * h, length, dh))
    k = _dense(k.reshape(b * h, length, dh))
    v = _dense(v.reshape(b * h, length, dh))
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    out = _Attend.apply(q, k, v, mask)
    return out.reshape(b, h, length, dh)
