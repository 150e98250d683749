"""The least time of each rotary head-split call on the H100, from the
call's shape alone: bytes moved over the HBM rate (the call does about one
operation a byte, so the memory bounds it).  Forward: the packed [B, L, 3D]
projection read once and q, k, v ([B*H, L, dh] each, together 3 B L D
elements) written once; backward the same in reverse.  The fp32 cos / sin
tables are not counted (under 0.2% of a call at L = 577).

The calls are those the configuration demands of the traced rounds, worked
out from its shapes and the rounds' step and batch counts as
``_flops.attention_calls`` works out attention's: the image tower's module
gives one image's calls (``archs/<kind>.py:rope``), a tower without one
makes none.  The device time is that of the kernels whose names match
``KERNELS``."""

from __future__ import annotations

import re

from .. import spec
from ..peaks import HBM_BYTES_PER_S
from ._flops import ITEMSIZE

KERNELS = re.compile(r"rope_qkv")


def rope_calls(config: dict, traffic: dict, rounds: list, batch_size: int,
               eval_batch_size: int) -> list:
    """One dict a call of ``rounds``: ``images``, ``length``, ``width``,
    ``itemsize`` and ``backward`` (whether its backward runs).  A training
    step makes the tower's calls over ``batch_size`` samples times the
    modality's images a sample, an evaluation batch its forward calls over
    ``eval_batch_size`` samples, padding included."""
    arch, method = config["arch"], config["method"]
    tower = getattr(spec.load_arch(arch["kind"]), "rope", None)
    if tower is None:
        return []
    modality = spec.load_modality(traffic["modality"])
    info = tower(arch, modality.TRAINABLE_FRONT)
    per = modality.images_per_sample(traffic)
    base = {"length": info["length"], "width": info["width"], "itemsize": ITEMSIZE[method["prec"]]}

    def forward(batch: int, backward: bool) -> list:
        return [{**base, "images": batch * per, "backward": backward and b} for b in info["backward"]]

    step, evaluation = forward(batch_size, True), forward(eval_batch_size, False)
    return [dict(c) for r in rounds
            for c in step * sum(r["n_steps"]) + evaluation * r["eval_batches_run"]]


def bound_s(call: dict) -> float:
    """The forward's least time (the backward's is the same)."""
    return 2 * 3 * call["images"] * call["length"] * call["width"] * call["itemsize"] \
        / HBM_BYTES_PER_S


def roofline_share(run):
    """Σ bound (forward and backward) / Σ traced time of the ``rope_qkv``
    kernels, in %; None where the traced rounds make no call or run no such
    kernel."""
    calls = rope_calls(run.config, run.traffic, run.traced_rounds, run.batch_size,
                       run.eval_batch_size)
    times = [d for name, _, d in run.trace.ops if KERNELS.search(name)]
    if not calls or not times:
        return None
    return 100.0 * sum(bound_s(c) * (2 if c["backward"] else 1) for c in calls) / sum(times)
