"""The least time of each attention call on the H100, from the call's shape
alone (a copy of ``chip_smoke.py:_bounds_ms`` with the causal calls'
operations cut to the needed lower triangle): bytes moved, each input read
once and each output written once, over the HBM rate, against operations
over the type's peak, whichever is larger.  Forward: q, k, v read, o and the
fp32 log-sum-exp written (4 [n, L, dh] tensors), 4 n L^2 dh FLOPs (two
products).  Backward: q, k, v, o, dO read and dq, dk, dv written (8
tensors), the log-sum-exp read, 10 n L^2 dh FLOPs (S rebuilt, then dV, dP,
dQ, dK).  A causal call reads its [L, L] fp32 mask and needs L (L + 1) / 2
of the L^2 scores.

The calls are those the configuration demands of the traced rounds, worked
out from its shapes and the rounds' step and batch counts
(``_flops.attention_calls``), not caught in the program: a step replayed
from a CUDA graph, or attention fused into another kernel, does the same
work and keeps the same numerator.  The device time is that of the kernels
whose names match ``FWD`` or ``BWD``: the port's own kernels and PyTorch's
SDPA / flash / memory-efficient / cuDNN attention kernels, so the share
reads the same work whatever implements it."""

from __future__ import annotations

import re

from ..peaks import FLOPS_PER_S, HBM_BYTES_PER_S
from ._flops import attention_calls

FWD = re.compile(r"attention_fwd|flash_fwd|fmha_cutlassF|efficient_attention_forward"
                 r"|fmha.*fprop|sdpa.*fprop|flash_attn.*fwd")
BWD = re.compile(r"attention_bwd|flash_bwd|fmha_cutlassB|efficient_attention_backward"
                 r"|fmha.*bprop|sdpa.*bprop|flash_attn.*bwd")
TYPES = {2: "bf16", 4: "fp32"}


def bound_s(call: dict, which: str) -> float:
    n, length, dh, elt = call["n"], call["length"], call["dh"], call["itemsize"]
    t = n * length * dh * elt
    rows = n * length * 4
    mask = length * length * 4 if call["causal"] else 0
    needed = (length + 1) / (2 * length) if call["causal"] else 1.0
    sq = n * length * length * dh * needed
    nbytes, flops = (4 * t + rows + mask, 4 * sq) if which == "fwd" else (8 * t + rows + mask, 10 * sq)
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[TYPES[elt]])


def traced_calls(run) -> list:
    """The traced rounds' attention calls (``_flops.attention_calls``)."""
    return attention_calls(run.config, run.traffic, run.traced_rounds, run.batch_size,
                           run.eval_batch_size)


def kernel_times(run, which: str) -> list:
    """Device seconds of each traced kernel matching ``FWD`` or ``BWD``."""
    pattern = FWD if which == "fwd" else BWD
    return [d for name, _, d in run.trace.ops if pattern.search(name)]


def counts(run) -> dict:
    """The traced rounds' attention calls from shapes, and the traced
    kernels that match, forward and backward."""
    calls = traced_calls(run)
    return {"fwd_calls": len(calls), "bwd_calls": sum(c["backward"] for c in calls),
            "fwd_kernels": len(kernel_times(run, "fwd")),
            "bwd_kernels": len(kernel_times(run, "bwd"))}


def roofline_share(run, which: str):
    """Σ bound / Σ kernel time of the traced rounds' attention, in %, or None
    when the traced rounds make no attention call of the kind."""
    calls = [c for c in traced_calls(run) if which == "fwd" or c["backward"]]
    if not calls:
        return None
    device = sum(kernel_times(run, which))
    if device <= 0:
        raise RuntimeError(f"{len(calls)} attention {which} calls were counted but no kernel "
                           f"matching the {which} pattern ran")
    return 100.0 * sum(bound_s(c, which) for c in calls) / device
