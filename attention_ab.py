#!/usr/bin/env python3
"""Time the port's attention kernels from several checkouts in turns, on one card.

    python3 attention_ab.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``fairfedmed_tpu_torch`` package: the
repository root, or an older commit's package unpacked with ``git archive``
into a git-ignored directory such as ``build/``.  The roots run one after
another, each in a process of its own that builds that package's kernels
(into ``ROOT/build``) and times them with ``chip_smoke.py``'s timers at
every shape of its ``kernel_shapes()`` in bf16: device time warm and
L2-cold, CUDA events and host enqueue time per call, beside the plain
versions and ``scaled_dot_product_attention``.  Give the roots in mirrored
order (A B B A) to see the drift within one call.  Prints one JSON line per
turn, one summary line per shape (every turn's kernel, host enqueue and
SDPA times), the ``nvidia-smi`` name/power line, and writes every turn to
``build/attention_ab.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def worker(root: str):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if not os.path.abspath(cs.A.__file__).startswith(root + os.sep):
        raise RuntimeError(f"{cs.A.__file__} is not under {root}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for shape, (n, length, dh, causal) in cs.kernel_shapes().items():
        mask = torch.triu(torch.full((length, length), float("-inf"), device="cuda"), 1) \
            if causal else None
        q, k, v, do = (torch.randn(n, length, dh, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        q = (q * dh ** -0.5).contiguous()
        o, lse = cs.A.attention_fwd(q, k, v, mask)
        row = cs.time_attention(q, k, v, do, mask, o, lse)
        row.update(cs.time_attention_cold(n, length, dh, torch.bfloat16, mask, gen))
        rows[shape] = row
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "rows": rows}))


def main(roots) -> int:
    turns = []
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                             capture_output=True, text=True, check=True, timeout=900)
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    keys = ("kernel_fwd_ms", "kernel_fwd_ms_cold", "kernel_fwd_ms_events", "kernel_fwd_host_ms",
            "kernel_bwd_ms", "kernel_bwd_ms_cold", "kernel_bwd_ms_events", "kernel_bwd_host_ms",
            "sdpa_fwd_ms", "sdpa_fwd_ms_cold", "sdpa_bwd_ms", "sdpa_bwd_ms_cold", "plain_fwd_ms",
            "plain_bwd_ms")
    for shape in turns[0]["rows"]:
        print(json.dumps({shape: [{"root": os.path.relpath(t["root"], HERE),
                                   **{k: t["rows"][shape][k] for k in keys}} for t in turns]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "attention_ab.json"), "w") as f:
        json.dump({"nvidia_smi": smi.stdout.strip(), "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    elif len(sys.argv) > 1 and not sys.argv[1].startswith("-"):
        sys.exit(main(sys.argv[1:]))
    else:
        sys.exit(__doc__)
