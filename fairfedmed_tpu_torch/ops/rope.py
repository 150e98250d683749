"""Rotary positions applied while a packed q/k/v projection is split into
heads: a hand-written CUDA kernel for each direction (``csrc/rope_qkv.cu``).

EVA02's attention (``models/eva_clip.py``) rotates q and k of every token
but the first (the class token) and hands q, scaled by dh^-0.5, k and v to
the attention kernels as contiguous ``[B*H, L, dh]`` tensors.  Done with
PyTorch operations that is a split, three transposes into heads, two
rotations on slices of q and k with their concatenations and a scale: some
ten passes over the [B, L, 3D] projection.  The kernels make one:

* forward: read ``qkv`` [B, L, 3D] once, write q, k, v [B*H, L, dh];
* backward: read dq, dk, dv once, write the packed gradient [B, L, 3D]
  (the inverse rotation and the scale).

Rotation (``rotate_half`` on interleaved pairs): ``y = u cos + r(u) sin``
with r(u)_{2i} = -u_{2i+1}, r(u)_{2i+1} = u_{2i}, in fp32 on inputs of the
tensors' type; ``cos`` and ``sin`` are fp32 [L-1, dh].  Its transpose gives
the gradient: ``du = dy cos + r^T(dy sin)``, r^T(z)_{2i} = z_{2i+1},
r^T(z)_{2i+1} = -z_{2i}.

:func:`rope_qkv_fwd` / :func:`rope_qkv_bwd` launch the kernels on CUDA
tensors and count their launches; :func:`reference_rope_qkv` /
:func:`reference_rope_qkv_bwd` are the plain versions, the CPU path and the
yardstick of the kernels.  ``_RopeQKV`` takes the plain version for a CPU
tensor and the kernel for a CUDA tensor, never falling back from one to the
other.
"""

from __future__ import annotations

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(qkv_like: torch.Tensor, heads_like: tuple, cos, sin, heads: int):
    """Raise where the kernels would not take the tensors; returns (B, L, D,
    dh)."""
    if qkv_like.dim() != 3 or qkv_like.shape[-1] % (3 * heads):
        raise ValueError(f"rope_qkv takes a packed [B, L, 3 * heads * dh] tensor, got "
                         f"{tuple(qkv_like.shape)} for {heads} heads")
    b, length, three_d = qkv_like.shape
    d = three_d // 3
    dh = d // heads
    tensors = (qkv_like, *heads_like, cos, sin)
    if not all(t.is_cuda and t.device == qkv_like.device and t.is_contiguous()
               and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("rope_qkv kernels take contiguous, 16-byte aligned CUDA tensors "
                         "on one device")
    if qkv_like.dtype not in _DTYPE_CODES or any(t.dtype != qkv_like.dtype for t in heads_like):
        raise ValueError(f"rope_qkv kernels take float32 or bfloat16 tensors of one type, got "
                         f"{[t.dtype for t in (qkv_like, *heads_like)]}")
    if dh % 8 or length < 2:
        raise ValueError(f"rope_qkv kernels take a head width that is a multiple of 8 and "
                         f"L >= 2, got dh={dh}, L={length}")
    if any(t.shape != (b * heads, length, dh) for t in heads_like):
        raise ValueError(f"rope_qkv heads must be [{b * heads}, {length}, {dh}], got "
                         f"{[tuple(t.shape) for t in heads_like]}")
    for t in (cos, sin):
        if t.dtype != torch.float32 or t.shape != (length - 1, dh):
            raise ValueError(f"rope tables must be float32 [{length - 1}, {dh}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return b, length, d, dh


def _raise_on_error(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def rope_qkv_fwd(qkv, cos, sin, heads: int):
    """Kernel forward: (q scaled by dh^-0.5, k, v), each [B*H, L, dh] in
    ``qkv``'s type, q and k rotated at tokens 1..L-1."""
    b, length, d, dh = _check(qkv, (), cos, sin, heads)
    q, k, v = (torch.empty((b * heads, length, dh), device=qkv.device, dtype=qkv.dtype)
               for _ in range(3))
    _check(qkv, (q, k, v), cos, sin, heads)
    fn = _build.load("rope_qkv", "ffm_rope_qkv_fwd")
    err = fn(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), q.data_ptr(), k.data_ptr(),
             v.data_ptr(), b, length, heads, dh, _DTYPE_CODES[qkv.dtype],
             torch.cuda.current_stream(qkv.device).cuda_stream)
    _raise_on_error(err, "rope_qkv forward")
    rope_qkv_fwd.launches += 1
    return q, k, v


rope_qkv_fwd.launches = 0


def rope_qkv_bwd(dq, dk, dv, cos, sin, heads: int):
    """Kernel backward: the packed gradient [B, L, 3D] of the forward's input
    from the gradients of its three outputs."""
    n, length, dh = dq.shape
    b = n // heads
    dqkv = torch.empty((b, length, 3 * heads * dh), device=dq.device, dtype=dq.dtype)
    _check(dqkv, (dq, dk, dv), cos, sin, heads)
    fn = _build.load("rope_qkv", "ffm_rope_qkv_bwd")
    err = fn(dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
             dqkv.data_ptr(), b, length, heads, dh, _DTYPE_CODES[dq.dtype],
             torch.cuda.current_stream(dq.device).cuda_stream)
    _raise_on_error(err, "rope_qkv backward")
    rope_qkv_bwd.launches += 1
    return dqkv


rope_qkv_bwd.launches = 0


def _rotate(u: torch.Tensor) -> torch.Tensor:
    """r(u): each interleaved pair (u0, u1) -> (-u1, u0)."""
    pairs = u.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def _rotate_t(z: torch.Tensor) -> torch.Tensor:
    """r^T(z): each pair (z0, z1) -> (z1, -z0)."""
    pairs = z.unflatten(-1, (-1, 2))
    return torch.stack([pairs[..., 1], -pairs[..., 0]], dim=-1).flatten(-2)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, L, D] -> [B*H, L, dh]."""
    b, length, d = t.shape
    return t.reshape(b, length, heads, d // heads).transpose(1, 2).reshape(b * heads, length, -1)


def _compute_type(dtype: torch.dtype) -> torch.dtype:
    """fp32 arithmetic, as the kernels do; float64 stays float64."""
    return torch.promote_types(dtype, torch.float32)


def reference_rope_qkv(qkv, cos, sin, heads: int):
    """Plain forward of the kernel's function (fp32 arithmetic, outputs in
    ``qkv``'s type)."""
    q, k, v = qkv.to(_compute_type(qkv.dtype)).chunk(3, dim=-1)
    scale = (q.shape[-1] // heads) ** -0.5

    def rope(u):
        u = _heads(u, heads)
        head, tail = u[:, :1], u[:, 1:]
        return torch.cat([head, tail * cos + _rotate(tail) * sin], dim=1)

    return tuple(t.to(qkv.dtype) for t in (rope(q) * scale, rope(k), _heads(v, heads)))


def reference_rope_qkv_bwd(dq, dk, dv, cos, sin, heads: int):
    """Plain backward of the kernel's function: the packed gradient [B, L, 3D]
    in ``dq``'s type."""
    n, length, dh = dq.shape
    b = n // heads
    scale = dh ** -0.5

    dtype, compute = dq.dtype, _compute_type(dq.dtype)

    def unrope(g):
        head, tail = g[:, :1], g[:, 1:]
        return torch.cat([head, tail * cos + _rotate_t(tail * sin)], dim=1)

    def packed(g):  # [B*H, L, dh] -> [B, L, D]
        return g.reshape(b, heads, length, dh).transpose(1, 2).reshape(b, length, heads * dh)

    dq, dk, dv = (g.to(compute) for g in (dq, dk, dv))
    out = torch.cat([packed(unrope(dq) * scale), packed(unrope(dk)), packed(dv)], dim=-1)
    return out.to(dtype)


class _RopeQKV(torch.autograd.Function):
    """Kernel on CUDA tensors, plain version on CPU tensors; the tables get no
    gradient."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, heads):
        ctx.heads = heads
        ctx.save_for_backward(cos, sin)
        if qkv.is_cuda:
            return rope_qkv_fwd(qkv, cos, sin, heads)
        return reference_rope_qkv(qkv, cos, sin, heads)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        cos, sin = ctx.saved_tensors
        grads = [g.contiguous() for g in (dq, dk, dv)]
        if grads[0].is_cuda:
            return rope_qkv_bwd(*grads, cos, sin, ctx.heads), None, None, None
        return reference_rope_qkv_bwd(*grads, cos, sin, ctx.heads), None, None, None


def rope_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int) -> tuple:
    """(q, k, v) of the packed projection ``qkv`` [B, L, 3D] as [B*H, L, dh]
    tensors: q and k rotated at tokens 1..L-1 by the fp32 tables ``cos`` /
    ``sin`` [L-1, dh], q scaled by dh^-0.5.  Differentiable in ``qkv``."""
    return _RopeQKV.apply(qkv.contiguous(), cos, sin, heads)
