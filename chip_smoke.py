#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fairfedmed_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each printing one JSON line:

1. ``card``: the card, its power limit, the versions, and the time to build
   the CUDA kernels from ``fairfedmed_tpu_torch/csrc`` (one nvcc per source,
   all at once).
2. ``kernel_checks``: each attention kernel (forward, backward) against its
   plain PyTorch version at the paths' shapes (the SLO and OCT vision
   batches, the text tower), fp32 (TF32 off) and bf16, with the max error
   beside its tolerance; times of the kernel, the plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls).
   Times are device time from torch.profiler (the kernels' summed
   durations), warm (one input set, resident in L2) and L2-cold (rotating
   over input sets that together exceed 4x the L2); beside them, CUDA events
   around back-to-back calls and the host's enqueue time per call, which
   show when a call is bound by the host rather than the device.
3. ``small_reference``: the same seeded trainer built on the CPU (plain
   attention) and on the GPU (the kernels), fp32: FairLoRA at
   ``test-vit-224`` on SLO fundus, at ``test-rn`` on OCT with COT and at
   ``test-vit-224`` on OCT with Sinkhorn; logits, one training step and the
   state after it must agree, and the solvers stop at the same iteration.
4. ``main_path``: one FedOTPLoRA round of the GLP_OT_SVLoRA trainer at
   ViT-B/16 full width (seeded random weights, bf16): 2 clients x 3 local
   steps of batch 32 (two optimizer steps each), ``state_dict`` harvest,
   ``average_weights_ema``, local prompt rows kept per client, then
   ``test()`` on 100 images per client through ``Classification_oph``.  One
   more training step then runs under torch.profiler (``main_path_profile``):
   kernel time by class and the device's idle share of a step.
5. The port's CLI, ``fairfedmed_tpu_torch.federated_main.main``, with the
   flags of a launcher script read from the script (the real config files at
   full width and depth, batch 32 / 100, bf16), except ``--root`` and
   ``--output-dir`` (under ``build/``), ``--round`` and no
   ``--parallel_clients``, on FairFedMed fixtures written here (3 sites):
   - ``cli_path``: ``scripts/fairfedlora_fairfedmed.sh`` (ViT-B/16, SLO
     fundus), 2 rounds, 64 train / 100 test NPZs per site of 224x224 uint8
     SLO fundus, half of them deflate-compressed;
   - ``oct_path``: ``scripts/fairfedlora_fairfedmed_oct.sh`` (ViT-B/16 on
     3D OCT B-scans, 2 slices of 16), 2 rounds, 32 train / 8 test NPZs per
     site of ``oct_bscans`` uint8 [128, 200, 200], so the dataset's [::4]
     stride and per-slice 200->224 resize run for real; then a profiled step;
   - ``rn50_path``: ``scripts/fairfedlora_fairfedmed_rn50.sh`` (RN50,
     FairLoRA rank 32 / alpha 8) on cli_path's SLO fixture, 2 rounds; then a
     profiled step;
   - ``rn50_oct_path``: ``scripts/fairfedlora_fairfedmed_oct_rn50.sh`` on
     oct_path's fixture, 1 round.
   Round 0 trains all 3 clients, round 1 the 2 that ``np.random.choice``
   draws, and every round evaluates all 3.  Launch counts must match the
   batches of the clients the log shows were trained; losses, accuracies
   and AUCs must be finite, the final per-client weights written (with
   ``proj_per_3d_slice`` on OCT, and finite BatchNorm running statistics
   that moved from their init on RN50).  Beside them: time per round, step
   times, the NPZ decoder in use, the host's data time per batch, peak
   memory, and the time of the batch's host-to-device copy.
6. ``ot_path``: the trainer driven directly at ViT-B/16 on batch-32 SLO
   batches with the launchers' OT settings: FairLoRA with OT None, Sinkhorn
   and COT, and the prompt-only GLP_OT (COT, ln_pre unfrozen), a few steps
   each; every plan valid, the solver's iterations and the time OT adds per
   step against OT None.
7. The other CLI branches, through the CLI as in 5, on cli_path's SLO
   fixture (2 of its sites, as the launchers' ``--num_users 2`` reads),
   ViT-B/16 bf16.  The FedChexMimic launchers' flags are read from
   ``scripts/fedchexmimic/``, with three changed, as each phase's line
   says: ``--dataset-config-file configs/datasets/fairfedmed.yaml`` and
   FairFedMed's ``--attributes`` / ``--attribute_type race`` (their own
   dataset is not ported, and the fixture has no ``age``):
   - ``promptfl_path``: ``promptfl_fedchexmimic.sh`` (fedavg, PromptFL),
     2 rounds; then a profiled step;
   - ``fedotp_path``: ``fedotp_fedchexmimic.sh`` (FedOTP, prompt-only
     GLP_OT, COT, 2 prompts), 2 rounds, every plan valid;
   - ``clip_path``: the PromptFL flags with ``--trainer CLIP``: one round
     of zero-shot evaluation, no backward launch;
   - ``fedprox_path``: the PromptFL flags with ``--model fedprox --mu 0.5``,
     1 round; the proximal term is held in the loss (see the function).
   Nothing in the image tower trains on these paths, so the backward runs
   through the text blocks only.
8. The client-parallel rounds: the launchers of 5 and 7 with their own
   ``--parallel_clients`` (``fed/parallel_driver.py``: per-client state and
   optimizer state on the device, device data caches, one blocking fetch
   per round), through the CLI as in 5 (the runner is recorded by
   ``CheckedRunner``):
   - ``parallel_cli_path``, ``parallel_oct_path`` (2 rounds; round 1 trains
     from the device caches; oct_path's host data time beside it) and
     ``parallel_rn50_path`` (1 round; every client's ``__bn_stats__`` finite
     and moved);
   - ``parallel_branches``: promptfl_fedchexmimic.sh and
     fedotp_fedchexmimic.sh (every plan valid), 2 rounds, and
     fairfedlora_fedchexmimic_local.sh and the PromptFL flags with
     ``--model fedprox``, 1 round, with 7's substitutions;
   - ``parallel_equiv``: sequential then parallel at momentum 0 and fp32
     (``test-vit-224``, 2 clients, 2 rounds): equal acc/AUC and weights.
   Each checks one blocking fetch per round and, through
   ``torch.cuda.set_sync_debug_mode``, that nothing in the dispatch half of
   a round after the first waits for the device.  Beside them: per round
   the dispatch and resolve host times and the host data time, cache bytes
   and type, peak memory.

Every path zeroes the kernel launch counters just before it runs and reads
them just after; the counts must equal what the layer structure implies.
Then the ``kernels`` line (``launches`` from main_path, ``launches_<path>``
from each other path; with each tensor-core kernel's registers and spills
from ptxas, its shared memory and waves from the CUDA runtime, and its bound
share from the cold time), the total time, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``.  Any failure raises: the
exit code is then not 0 and the last line is not printed.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import math
import os
import re
import shlex
import shutil
import statistics
import subprocess
import sys
import time
import types
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from fairfedmed_tpu_torch.config import get_cfg_default
from fairfedmed_tpu_torch.fed.aggregate import average_weights_ema
from fairfedmed_tpu_torch.fed.parallel_driver import ParallelRoundRunner
from fairfedmed_tpu_torch.ops import _build
from fairfedmed_tpu_torch.ops import attention as A
from fairfedmed_tpu_torch.ops.sinkhorn import entropic_cot, sinkhorn
from fairfedmed_tpu_torch.train.engine import build_trainer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
L2_BYTES = 50e6
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity
ATTRIBUTES = ["gender", "race", "ethnicity", "language", "maritalstatus"]
GROUPS = {"gender": 2, "race": 3, "ethnicity": 2, "language": 3, "maritalstatus": 5}
CLASSNAMES = ["NOT Glaucoma", "Glaucoma"]
# kernel tolerances, relative to the largest reference value: fp32 sums in
# another order; bf16 outputs rounded once (2^-8) plus the backward's
# delta taken from the rounded output
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke_output")
SCRIPT = os.path.join(REPO, "scripts", "fairfedlora_fairfedmed.sh")
OCT_SCRIPT = os.path.join(REPO, "scripts", "fairfedlora_fairfedmed_oct.sh")
RN50_SCRIPT = os.path.join(REPO, "scripts", "fairfedlora_fairfedmed_rn50.sh")
RN50_OCT_SCRIPT = os.path.join(REPO, "scripts", "fairfedlora_fairfedmed_oct_rn50.sh")
PROMPTFL_SCRIPT = os.path.join(REPO, "scripts", "fedchexmimic", "promptfl_fedchexmimic.sh")
FEDOTP_SCRIPT = os.path.join(REPO, "scripts", "fedchexmimic", "fedotp_fedchexmimic.sh")
LOCAL_SCRIPT = os.path.join(REPO, "scripts", "fedchexmimic", "fairfedlora_fedchexmimic_local.sh")
# the FedChexMimic launchers run on the FairFedMed SLO fixture: their own
# dataset is not ported (ROADMAP M14), and the fixture has no ``age``
FAIRFEDMED_FLAGS = (("--dataset-config-file", "configs/datasets/fairfedmed.yaml"),
                    ("--attributes", *ATTRIBUTES), ("--attribute_type", "race"))
CLI_SITES, CLI_TRAIN, CLI_TEST = 3, 64, 100
# a FairFedMed OCT member: 128 B-scans of 200x200 uint8 (dataset.md:13-14);
# one full training batch of 32 volumes per site, 8 test volumes (the test
# batch of 100 cycles them)
OCT_SHAPE, OCT_TRAIN, OCT_TEST = (128, 200, 200), 32, 8


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """CUDA events around a run of back-to-back calls: device time plus any
    gap in which the device waits for the host to enqueue the next call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fns, warmup=3) -> float:
    """Mean device time of one call: the summed durations of the CUDA kernels
    that the calls launch (torch.profiler), cycling through ``fns`` at least
    once.  Unlike CUDA events around a run of calls, it leaves out the gaps
    when the device waits for the host to enqueue."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    iters = max(20, len(fns))
    with profile(activities=[ProfilerActivity.CUDA]):  # a first profiling pass may record nothing
        for i in range(warmup):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / 1e3 / iters


def host_ms(fn, iters=20, warmup=3) -> float:
    """Host time to enqueue one call (no synchronisation inside the run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #

KERNEL_SHAPES = {  # name: (n = batch*heads, L, dh, causal)
    "vision_train": (32 * 12, 197, 64, False),
    "vision_eval": (100 * 12, 197, 64, False),
    # OCT: 2 slices of 16 B-scans per volume double the vision batch
    "vision_train_oct": (64 * 12, 197, 64, False),
    "vision_eval_oct": (200 * 12, 197, 64, False),
    "text_16": (32, 16, 64, True),
    "text_77": (32, 77, 64, True),
    # PromptFL / CLIP: 1 prompt x 2 classes x 8 heads, "X X X X NOT
    # Glaucoma." cut after its EOT at 10 tokens, rounded up to 16
    "text_promptfl": (16, 16, 64, True),
}


def _bounds_ms(n, length, dh, dtype, causal):
    """Least time for each function: bytes moved (each input read once, each
    output written once) over HBM rate vs operations over the type's peak."""
    elt = torch.tensor([], dtype=dtype).element_size()
    t = n * length * dh * elt
    rows = n * length * 4  # the fp32 log-sum-exp
    mask = length * length * 4 if causal else 0
    sq = n * length * length * dh
    out = {}
    for name, nbytes, flops in (("fwd", 4 * t + rows + mask, 4 * sq),
                                ("bwd", 8 * t + rows + mask, 10 * sq)):
        mem, ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        out[name] = (max(mem, ops), "bytes" if mem >= ops else "operations")
    return out


def check_kernels(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape_name, (n, length, dh, causal) in KERNEL_SHAPES.items():
        mask = torch.triu(torch.full((length, length), float("-inf"), device=dev), 1) \
            if causal else None
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(n, length, dh, device=dev, generator=gen).to(dtype)
                           for _ in range(4))
            q = (q * dh ** -0.5).contiguous()
            o, lse = A.attention_fwd(q, k, v, mask)
            dq, dk, dv = A.attention_bwd(q, k, v, o, lse, do, mask)
            torch.cuda.synchronize()
            ro = A.reference_attention(q, k, v, mask)
            refs = A.reference_attention_bwd(q, k, v, do, mask)
            errs = {}
            for name, got, ref in (("o", o, ro), ("dq", dq, refs[0]), ("dk", dk, refs[1]),
                                   ("dv", dv, refs[2])):
                err = (got.float() - ref.float()).abs().max().item()
                tol = TOL[dtype] * max(1.0, ref.float().abs().max().item())
                if not err <= tol:
                    raise AssertionError(f"{shape_name} {dtype} {name}: max error {err} > {tol}")
                errs[name] = {"max_abs_err": err, "tol": tol}
            row = {"shape": shape_name, "n_L_dh": [n, length, dh], "causal": causal,
                   "dtype": str(dtype).replace("torch.", ""),
                   "fwd_max_abs_err": errs["o"]["max_abs_err"],
                   "bwd_max_abs_err": max(errs[g]["max_abs_err"] for g in ("dq", "dk", "dv")),
                   "errors": errs}
            if dtype == torch.bfloat16:  # the main path's type: time it
                row.update(time_attention(q, k, v, do, mask, o, lse))
                row.update(time_attention_cold(n, length, dh, dtype, mask, gen))
                bounds = _bounds_ms(n, length, dh, dtype, causal)
                row.update({"fwd_bound_ms": bounds["fwd"][0], "fwd_bound_by": bounds["fwd"][1],
                            "bwd_bound_ms": bounds["bwd"][0], "bwd_bound_by": bounds["bwd"][1]})
            rows.append(row)
    return rows


def time_attention(q, k, v, do, mask, o, lse):
    n, length, dh = q.shape
    causal = mask is not None
    q4, k4, v4 = (t.view(n, 1, length, dh).detach().requires_grad_(True) for t in (q, k, v))
    do4 = do.view(n, 1, length, dh)

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, scale=1.0, is_causal=causal)

    sdpa_out = sdpa()

    def fwd():
        return A.attention_fwd(q, k, v, mask)

    def bwd():
        return A.attention_bwd(q, k, v, o, lse, do, mask)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (q4, k4, v4), do4, retain_graph=True)

    return {
        "kernel_fwd_ms": device_ms([fwd]),
        "kernel_bwd_ms": device_ms([bwd]),
        "kernel_fwd_ms_events": cuda_ms(fwd),
        "kernel_bwd_ms_events": cuda_ms(bwd),
        "kernel_fwd_host_ms": host_ms(fwd),
        "kernel_bwd_host_ms": host_ms(bwd),
        "plain_fwd_ms": device_ms([lambda: A.reference_attention(q, k, v, mask)]),
        "plain_bwd_ms": device_ms([lambda: A.reference_attention_bwd(q, k, v, do, mask)]),
        "sdpa_fwd_ms": device_ms([sdpa]),
        "sdpa_bwd_ms": device_ms([sdpa_bwd]),
    }


def time_attention_cold(n, length, dh, dtype, mask, gen):
    """Kernel and SDPA device times with L2 cold: calls rotate over input
    sets whose bytes together exceed 4x the L2 (at most 256 sets: the text
    shapes' then exceed it 1.7x)."""
    dev = mask.device if mask is not None else "cuda"
    causal = mask is not None
    set_bytes = 5 * n * length * dh * torch.tensor([], dtype=dtype).element_size()
    sets = []
    for _ in range(min(256, max(2, math.ceil(4 * L2_BYTES / set_bytes)))):
        q, k, v, do = (torch.randn(n, length, dh, device=dev, generator=gen).to(dtype)
                       for _ in range(4))
        q = (q * dh ** -0.5).contiguous()
        o, lse = A.attention_fwd(q, k, v, mask)
        q4, k4, v4 = (t.view(n, 1, length, dh).detach().requires_grad_(True) for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0, is_causal=causal)
        sets.append((q, k, v, do, o, lse, q4, k4, v4, out4))

    def fwd(s):
        return lambda: A.attention_fwd(s[0], s[1], s[2], mask)

    def bwd(s):
        return lambda: A.attention_bwd(s[0], s[1], s[2], s[4], s[5], s[3], mask)

    def sdpa_fwd(s):
        return lambda: F.scaled_dot_product_attention(s[6], s[7], s[8], scale=1.0,
                                                      is_causal=causal)

    def sdpa_bwd(s):
        return lambda: torch.autograd.grad(s[9], (s[6], s[7], s[8]),
                                           s[3].view(n, 1, length, dh), retain_graph=True)

    return {"input_sets_cold": len(sets),
            "kernel_fwd_ms_cold": device_ms([fwd(s) for s in sets]),
            "kernel_bwd_ms_cold": device_ms([bwd(s) for s in sets]),
            "sdpa_fwd_ms_cold": device_ms([sdpa_fwd(s) for s in sets]),
            "sdpa_bwd_ms_cold": device_ms([sdpa_bwd(s) for s in sets])}


def ptxas_kernel(log: str, entry: str) -> dict:
    """Registers and spill bytes that ``nvcc -Xptxas=-v`` reported for the
    first entry function whose mangled name contains ``entry``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            props = " ".join(lines[i + 1:i + 4])
            return {"registers": int(re.search(r"Used (\d+) registers", props).group(1)),
                    "spill_bytes": int(re.search(r"(\d+) bytes spill stores", props).group(1))}
    raise AssertionError(f"no ptxas report for {entry}")


# --------------------------------------------------------------------------- #
# phases 3 and 4: the trainer
# --------------------------------------------------------------------------- #

def fairlora_cfg(backbone: str, size: int, prec: str, modality="slo_fundus", ot="None",
                 trainer="GLP_OT_SVLoRA"):
    """configs/trainers/GLP_OT/vit_b16_oph.yaml with the flags of
    scripts/fairfedlora_fairfedmed.sh (attribute race), built in code; the
    OCT launchers' 16 B-scans per slice, and the launchers' OT settings."""
    cfg = get_cfg_default()
    cfg.SEED = 1
    cfg.OUTPUT_DIR = OUT_DIR
    cfg.MODEL.BACKBONE.NAME = backbone
    cfg.MODEL.BACKBONE.PRETRAINED = False
    cfg.INPUT.SIZE = (size, size)
    cfg.INPUT.PIXEL_MEAN = [0.48145466, 0.4578275, 0.40821073]
    cfg.INPUT.PIXEL_STD = [0.26862954, 0.26130258, 0.27577711]
    cfg.DATASET.NAME = "FairFedMed"
    cfg.DATASET.USERS = 2
    cfg.DATASET.ATTRIBUTE_TYPE = "race"
    cfg.DATASET.ATTRIBUTES = list(ATTRIBUTES)
    cfg.DATASET.MODALITY_TYPE = modality
    cfg.DATASET.DIM_PER_3D_SLICE = 16
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 32
    cfg.DATALOADER.TEST.BATCH_SIZE = 100
    cfg.OPTIM.NAME = "sgd"
    cfg.OPTIM.LR = 0.001
    cfg.OPTIM.MAX_EPOCH = 1
    cfg.OPTIM.LR_SCHEDULER = "single_step"
    cfg.OPTIM.STEPSIZE = (200,)
    cfg.OPTIM.GAMMA = 0.1
    cfg.OPTIM.WARMUP_EPOCH = 0
    cfg.OPTIM.WARMUP_TYPE = "constant"
    cfg.TRAIN.CHECKPOINT_FREQ = 5
    cfg.TRAIN.PRINT_FREQ = 10
    cfg.TEST.EVALUATOR = "Classification_oph"
    cfg.TRAINER.NAME = trainer
    cfg.TRAINER.GLP_OT.PREC = prec
    cfg.TRAINER.GLP_OT.N = 2
    cfg.TRAINER.GLP_OT.N_CTX = 4
    cfg.TRAINER.GLP_OT.OT = ot
    cfg.TRAINER.GLP_OT.EPS = 0.1
    cfg.TRAINER.GLP_OT.THRESH = 0.001
    cfg.TRAINER.GLP_OT.MAX_ITER = 100
    cfg.TRAINER.GLP_OT.TOP_PERCENT = 0.8
    cfg.TRAINER.GLP_OT_LORA.UNFREEZE_IMAGE_ENCODER = True
    cfg.TRAINER.GLP_OT_LORA.RANK = 12
    cfg.TRAINER.GLP_OT_LORA.ALPHA = 2.0
    cfg.TRAINER.GLP_OT_LORA.TYPE = "FairLoRA"
    cfg.TRAINER.LAMBDA_FAIRNESS = 0.0
    return cfg


def make_batches(rng, n_batches, batch, size, oct_slices=0):
    """Batch dicts as the FairFedMed ClientLoader yields them: grayscale SLO
    fundus repeated to 3 channels, or ``oct_slices`` OCT B-scans, uint8.
    Labels and every attribute are laid out so each demographic group holds
    both classes (group AUCs are defined), then shuffled."""
    out = []
    for _ in range(n_batches):
        i = np.arange(batch)
        order = rng.permutation(batch)
        img = rng.integers(0, 256, (batch, oct_slices or 1, size, size), dtype=np.uint8)
        out.append({
            "img": img if oct_slices else np.repeat(img, 3, axis=1),
            "label": (i % 2).astype(np.int32)[order],
            "attrs": np.stack([(i // 2) % GROUPS[a] for a in ATTRIBUTES], 1).astype(np.int32)[order],
            "n_valid": batch,
        })
    return out


def make_dm(rng, n_train, train_batch, n_test, size, oct_slices=0):
    return types.SimpleNamespace(
        fed_train_loader_x_dict={c: make_batches(rng, n_train, train_batch, size, oct_slices)
                                 for c in (0, 1)},
        fed_test_loader_x_dict={c: make_batches(rng, 1, n_test, size, oct_slices)
                                for c in (0, 1)},
        num_classes=2, lab2cname=dict(enumerate(CLASSNAMES)),
        dataset=types.SimpleNamespace(classnames=list(CLASSNAMES)))


SMALL_REFERENCE = (  # (backbone, size, modality, OT)
    ("test-vit-224", 224, "slo_fundus", "None"),
    ("test-rn", 32, "oct_bscans", "COT"),
    ("test-vit-224", 224, "oct_bscans", "Sinkhorn"),
)


def small_reference(dev):
    """The same seeded trainer on the CPU (plain attention) and on the GPU (the
    kernels), fp32: FairLoRA at test-vit-224 (vision head width 64, text 16)
    on SLO fundus, at test-rn on OCT with COT and at test-vit-224 on OCT with
    Sinkhorn.  Logits, one training step's loss and the state after it must
    agree; ResNet running statistics (batch moments, not SGD-damped) to 1e-5
    relative to their largest value."""
    rows = []
    tol = {"logits": 1e-4, "loss": 1e-5, "state": 1e-6, "running_stats_rel": 1e-5}
    for backbone, size, modality, ot in SMALL_REFERENCE:
        cfg = fairlora_cfg(backbone, size, "fp32", modality=modality, ot=ot)
        oct_slices = 32 if modality == "oct_bscans" else 0
        dm = make_dm(np.random.default_rng(7), 1, 8, 8, size, oct_slices)
        trainers = {d: build_trainer(cfg, dm, device=d) for d in ("cpu", dev)}
        batch = dm.fed_train_loader_x_dict[0][0]
        attr = torch.as_tensor(batch["attrs"][:, ATTRIBUTES.index("race")])
        logits = {d: tr.model_inference(torch.as_tensor(batch["img"]).to(d), attr.to(d)).cpu()
                  for d, tr in trainers.items()}
        steps, iterations = {}, {}
        for d, tr in trainers.items():
            tr.batch_idx, tr.num_batches = 0, 2  # not the last batch: no LR step
            steps[d] = (tr.forward_backward(batch), tr.state_dict())
            iterations[d] = None if tr.ot_iterations is None else int(tr.ot_iterations)
        logit_err = (logits["cpu"] - logits[dev]).abs().max().item()
        loss_err = abs(steps["cpu"][0]["loss"] - steps[dev][0]["loss"])
        state_err, stats_ok = 0.0, True
        for k, want in steps["cpu"][1].items():
            err = float(np.abs(want - steps[dev][1][k]).max())
            if "running_" in k:
                stats_ok &= err <= tol["running_stats_rel"] * max(1.0, float(np.abs(want).max()))
            else:
                state_err = max(state_err, err)
        res = {"preset": backbone, "modality": modality, "ot": ot, "prec": "fp32",
               "logits_max_abs_err": logit_err, "loss_abs_err": loss_err,
               "state_max_abs_err": state_err, "running_stats_within_tol": stats_ok,
               "ot_iterations": iterations, "logits_shape": list(logits[dev].shape)}
        rows.append(res)
        if not (logit_err <= tol["logits"] and loss_err <= tol["loss"]
                and state_err <= tol["state"] and stats_ok
                and iterations["cpu"] == iterations[dev] and torch.isfinite(logits[dev]).all()):
            raise AssertionError(f"GPU trainer disagrees with the CPU trainer: {res}")
    return {"phase": "small_reference", "tol": tol, "rows": rows}


def main_path(dev):
    cfg = fairlora_cfg("ViT-B/16", 224, "fp16")
    n_steps, batch, n_test = 3, cfg.DATALOADER.TRAIN_X.BATCH_SIZE, cfg.DATALOADER.TEST.BATCH_SIZE
    dm = make_dm(np.random.default_rng(cfg.SEED), n_steps, batch, n_test, 224)
    t0 = time.perf_counter()
    trainer = build_trainer(cfg, dm, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    clip = trainer.bundle.clip_cfg

    steps, current = [], {}
    forward_backward = trainer.forward_backward

    def timed_step(b):  # forward_backward ends in a host fetch: the clock is honest
        t = time.perf_counter()
        out = forward_backward(b)
        steps.append({"client": current["idx"], "loss": out["loss"], "acc": out["acc"],
                      "ms": (time.perf_counter() - t) * 1e3})
        return out

    trainer.forward_backward = timed_step
    n_by_client = [len(dm.fed_train_loader_x_dict[c]) * batch for c in (0, 1)]
    n_by_attr = [np.bincount(np.concatenate([b["attrs"][:, 1] for b in
                                             dm.fed_train_loader_x_dict[c]]), minlength=3).tolist()
                 for c in (0, 1)]

    torch.cuda.reset_peak_memory_stats()
    A.attention_fwd.launches = 0
    A.attention_bwd.launches = 0
    t_round = time.perf_counter()
    global_w = trainer.state_dict()
    local = {}
    for idx in (0, 1):
        current["idx"] = idx
        trainer.load_state_dict(global_w)
        trainer.train(idx=idx, global_epoch=0, is_fed=True, is_last_client=idx == 1)
        local[idx] = trainer.state_dict()
    print("Use EMA")
    global_w = average_weights_ema(global_w, local, [0, 1], n_by_client, n_by_attr, 0, 50,
                                   shared_half_s=True)
    results = []
    for idx in (0, 1):
        personal = copy.deepcopy(global_w)
        personal["prompt_learner.ctx"][1:2] = local[idx]["prompt_learner.ctx"][1:2]
        trainer.load_state_dict(personal)
        results.append(trainer.test(idx=idx))
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t_round
    launches = {"attention_fwd": A.attention_fwd.launches,
                "attention_bwd": A.attention_bwd.launches}

    n_train_steps, n_eval_batches = len(steps), 2
    v, t = clip.vision_layers, clip.transformer_layers
    # every batch (train or eval) runs each vision and text block once; the
    # backward skips vision block 0, whose input carries no gradient
    expected = {"attention_fwd": (n_train_steps + n_eval_batches) * (v + t),
                "attention_bwd": n_train_steps * (v - 1 + t)}
    clients = [{"client": i, "acc": r[0], "auc": r[3],
                "esauc_race": 100.0 * float(r[7][ATTRIBUTES.index("race")])}
               for i, r in enumerate(results)]
    res = {"phase": "main_path", "model": cfg.MODEL.BACKBONE.NAME, "width": [clip.vision_width,
                                                                clip.transformer_width],
           "layers": [v, t], "prec": "fp16 (bf16)", "batch": batch, "test_batch": n_test,
           "build_s": build_s, "steps": steps,
           "step_ms_median_after_first": statistics.median(s["ms"] for s in steps[1:]),
           "round_s": round_s, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "clients": clients, "launches": launches, "expected_launches": expected}
    emit(res)
    if len(steps) != 2 * n_steps or not all(np.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"non-finite or missing losses: {steps}")
    if not all(np.isfinite([c["auc"], c["esauc_race"]]).all() for c in clients):
        raise AssertionError(f"non-finite AUC: {clients}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != expected {expected}")
    emit(profile_step(trainer, dm.fed_train_loader_x_dict[0][0],
                      res["step_ms_median_after_first"]))
    return launches


# --------------------------------------------------------------------------- #
# phase 5: the CLI
# --------------------------------------------------------------------------- #

PARALLEL_SWITCH = re.compile(r'^\$\(\[ "\$\{PARALLEL_CLIENTS:-1\}" = "1" \] && echo (--\S+)\)$')


def script_flags(path=SCRIPT, parallel=False) -> list:
    """The ``federated_main.py`` flags of a launcher script, with its shell
    variables substituted (``${VAR:-default}`` takes the default, in an
    assignment or inline).  The ``$(...)``-valued parallel-clients switch is
    dropped, or with ``parallel`` kept where the script passes it, as the
    scripts do by default (``PARALLEL_CLIENTS`` unset)."""
    with open(path) as f:
        text = f.read()
    env = {}
    for name, value in re.findall(r"^(\w+)=(\$\(.*)$", text, re.M):
        switch = PARALLEL_SWITCH.match(value)
        if parallel and switch:
            env[name] = switch.group(1)

    def subst(token):
        def value(m):
            name, default = m.group(1), m.group(2)
            return env[name] if name in env or default is None else default

        return re.sub(r"\$\{(\w+)(?::-([^}]*))?\}", value, token)

    for name, value in re.findall(r"^(\w+)=(.*)$", text, re.M):
        if value.startswith("$("):
            continue
        m = re.fullmatch(r"\$\{\w+:-(.*)\}", value)
        env[name] = subst(shlex.split(m.group(1) if m else value)[0])
    command = re.search(r"^python federated_main\.py((?:.*\\\n)*.*)$", text, re.M).group(1)
    out = []
    for token in shlex.split(command.replace("\\\n", " ")):
        var = re.fullmatch(r"\$\{(\w+)\}", token)
        if not (var and var.group(1) not in env):
            out.append(subst(token))
    return out


def write_fairfedmed_fixture(root, n_train=CLI_TRAIN, n_test=CLI_TEST, modality="slo_fundus",
                             size=224, seed=3):
    """The FairFedMed layout of tests/fixtures.py:13-45, written with numpy
    and csv for ``CLI_SITES`` sites: ``root/fairfedmed/all/data_*.npz``
    (glaucoma, the five attributes, and ``slo_fundus`` uint8 [size, size],
    every second file deflate-compressed, or ``oct_bscans`` uint8
    ``OCT_SHAPE``, stored) and ``meta_site{k}_{attr}_{split}.csv``.  Labels
    and attributes are laid out so every demographic group holds both
    classes, then shuffled."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "fairfedmed")
    all_dir = os.path.join(base, "all")
    os.makedirs(all_dir, exist_ok=True)
    counter, nbytes = 0, 0
    for site in range(1, CLI_SITES + 1):
        for split, n in (("train", n_train), ("test", n_test)):
            i, order = np.arange(n), rng.permutation(n)
            labels = (i % 2)[order]
            attrs = {a: ((i // 2) % GROUPS[a])[order] for a in ATTRIBUTES}
            fnames = []
            for j in range(n):
                fname = f"data_{counter:05d}.npz"
                path = os.path.join(all_dir, fname)
                if modality == "oct_bscans":
                    save = np.savez
                    pixels = rng.integers(0, 256, OCT_SHAPE, dtype=np.uint8)
                else:
                    save = np.savez_compressed if counter % 2 else np.savez
                    pixels = rng.integers(0, 256, (size, size), dtype=np.uint8)
                save(path, **{modality: pixels}, glaucoma=np.asarray(labels[j]),
                     **{a: np.asarray(attrs[a][j]) for a in attrs})
                nbytes += os.path.getsize(path)
                fnames.append(fname)
                counter += 1
            for attr in ATTRIBUTES:
                with open(os.path.join(base, f"meta_site{site}_{attr}_{split}.csv"), "w",
                          newline="") as f:
                    w = csv.writer(f)
                    w.writerow(["filename"])
                    w.writerows([fn] for fn in fnames)
    return {"files": counter, "bytes": nbytes, "modality": modality}


def time_h2d(batch_img, dev, iters=10):
    """Host-to-device copy of one training batch's images as
    ``prefetch_to_device`` makes it (pin, then a non-blocking copy), the
    device copy timed with CUDA events; a pageable copy beside it."""
    host = torch.as_tensor(batch_img)
    pin_ms, pinned_ms, pageable_ms = [], [], []
    for _ in range(iters):
        t = time.perf_counter()
        pinned = host.pin_memory()
        pin_ms.append((time.perf_counter() - t) * 1e3)
        for src, out in ((pinned, pinned_ms), (host, pageable_ms)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            src.to(dev, non_blocking=True)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
    nbytes = host.numel() * host.element_size()
    return {"h2d_bytes": nbytes, "h2d_dtype": str(host.dtype).replace("torch.", ""),
            "h2d_pinned_ms_median": statistics.median(pinned_ms),
            "h2d_pageable_ms_median": statistics.median(pageable_ms),
            "pin_memory_host_ms_median": statistics.median(pin_ms),
            "h2d_pinned_gb_per_s": nbytes / statistics.median(pinned_ms) / 1e6}


def set_flag(argv, flag, *values) -> list:
    """``argv`` with the value tokens of ``flag`` replaced by ``values``
    (the flag and values appended when ``flag`` is absent)."""
    if flag not in argv:
        return argv + [flag, *values]
    i = argv.index(flag)
    j = i + 1
    while j < len(argv) and not argv[j].startswith("--"):
        j += 1
    return argv[:i + 1] + list(values) + argv[j:]


@contextlib.contextmanager
def sync_watch():
    """Collect, as ``file:line: message``, every call in the block that
    makes the host wait for the device (``torch.cuda.set_sync_debug_mode``
    warns on each)."""
    found = []
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            yield found
    finally:
        torch.cuda.set_sync_debug_mode(prev)
        found.extend(f"{os.path.relpath(w.filename, REPO)}:{w.lineno}: {w.message}"
                     for w in rec if "synchroniz" in str(w.message))


class CheckedRunner(ParallelRoundRunner):
    """The CLI's client-parallel runner with its rounds recorded: per round
    the clients and their steps, the host time of the dispatch half and of
    the host data work in it (batch assembly, cache decode), every call in
    the dispatch half that waited for the device, the per-step metrics, the
    evaluation batches enqueued, and the blocking fetches."""

    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dispatches, self.resolved, self.eval_batches, self._data_s = [], [], 0, 0.0
        self.eval_calls = []  # the clients of each evaluation enqueued
        CheckedRunner.last = self

    def _timed(self, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self._data_s += time.perf_counter() - t

    def _round_batches_device(self, idxs_users):
        return self._timed(super()._round_batches_device, idxs_users)

    def _round_batches(self, idxs_users):
        return self._timed(super()._round_batches, idxs_users)

    def _ensure_eval_cache(self, idx):
        return self._timed(super()._ensure_eval_cache, idx)

    def _eval_dispatch(self, idxs_users):
        ctx = super()._eval_dispatch(idxs_users)
        if ctx is not None:
            self.eval_batches += ctx["logits"].shape[0] * ctx["logits"].shape[1]
            self.eval_calls.append(list(idxs_users))
        return ctx

    def run_round(self, epoch, idxs_users, max_epoch, **kwargs):
        self._data_s = 0.0
        t = time.perf_counter()
        with sync_watch() as syncs:
            out = super().run_round(epoch, idxs_users, max_epoch, **kwargs)
        self.dispatches.append({"round": epoch, "deferred": bool(kwargs.get("deferred")),
                                "dispatch_s": time.perf_counter() - t,
                                "host_data_s": self._data_s, "syncs": syncs})
        return out

    def resolve_round(self, handle):
        t = time.perf_counter()
        with sync_watch() as syncs:
            ms = super().resolve_round(handle)
        self.resolved.append({"round": handle["epoch"], "clients": handle["idxs_users"],
                              "n_steps": [int(n) for n in handle["n_steps"]], "metrics": ms,
                              "resolve_s": time.perf_counter() - t, "syncs": syncs})
        return ms

    def parallel_eval(self, idxs_users, current_epoch):
        with sync_watch() as syncs:  # after its round's resolve_round
            out = super().parallel_eval(idxs_users, current_epoch)
        self.resolved[-1]["syncs"] += syncs
        return out


def run_cli(script, data_root, out_dir, rounds, dev, overrides=(), on_build=None,
            parallel=False, opts=()):
    """``fairfedmed_tpu_torch.federated_main.main`` with the flags of a
    launcher script (the real config files, batch 32 / 100), except
    ``--root`` and ``--output-dir`` (under ``build/``), ``--round``, no
    ``--parallel_clients`` (with ``parallel`` the script's own switch kept),
    ``overrides`` (``(flag, value, ...)`` tuples) and config ``opts`` last.
    The kernel counters are zeroed just before and read just after; the
    expected counts come from the set sizes of the clients that the log (or
    with ``parallel`` the runner's rounds and evaluations) shows were
    trained and evaluated, and the runner's own step counts must equal
    them.
    ``on_build(trainer)`` runs once the CLI has built its trainer.  Returns
    what the path's checks read."""
    from fairfedmed_tpu_torch import federated_main as fm

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = script_flags(script, parallel=parallel)
    for flag, value in (("--root", data_root), ("--output-dir", out_dir), ("--round", str(rounds))):
        argv = set_flag(argv, flag, value)
    for flag, *values in overrides:
        argv = set_flag(argv, flag, *values)
    for flag in ("--config-file", "--dataset-config-file"):  # config paths from the repo
        i = argv.index(flag)
        argv[i + 1] = os.path.join(REPO, argv[i + 1])
    argv += list(opts)
    args = fm.build_arg_parser().parse_args(argv)
    if parallel != ("--parallel_clients" in argv):
        raise AssertionError(f"the launcher's parallel switch: {argv}")

    steps, epochs, holder = [], [], {}
    build_trainer = fm.build_trainer

    def recording_build(cfg, dm=None, device=None):
        trainer = build_trainer(cfg, dm, device=device)
        holder["trainer"] = trainer
        forward_backward, run_epoch = trainer.forward_backward, trainer.run_epoch

        def timed_step(b):  # forward_backward ends in a host fetch: the clock is honest
            t = time.perf_counter()
            out = forward_backward(b)
            steps.append({"loss": out["loss"], "ms": (time.perf_counter() - t) * 1e3})
            return out

        def recorded_epoch(idx, global_epoch):
            run_epoch(idx, global_epoch)
            epochs.append({"round": global_epoch, "client": idx,
                           "data_ms_per_batch": trainer.data_time.avg * 1e3,
                           "batch_ms": trainer.batch_time.avg * 1e3,
                           "batches": trainer.data_time.count})

        trainer.forward_backward, trainer.run_epoch = timed_step, recorded_epoch
        if on_build is not None:
            on_build(trainer)
        return trainer

    fm.build_trainer = recording_build
    fm.ParallelRoundRunner = CheckedRunner
    CheckedRunner.last = None
    console_path = out_dir + "_console.txt"
    saved_stdout = sys.stdout
    torch.cuda.reset_peak_memory_stats()
    A.attention_fwd.launches = 0
    A.attention_bwd.launches = 0
    t0 = time.perf_counter()
    try:
        with open(console_path, "w") as console:
            sys.stdout = console  # the CLI's log tee writes here and to log.txt
            try:
                result = fm.main(args)
            finally:
                tee, sys.stdout = sys.stdout, saved_stdout
                if tee is not console:
                    tee.close()  # while its console is still open
    except BaseException:
        with open(console_path) as f:
            print(f.read()[-6000:], file=sys.stderr)
        raise
    finally:
        fm.build_trainer = build_trainer
        fm.ParallelRoundRunner = ParallelRoundRunner
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"attention_fwd": A.attention_fwd.launches,
                "attention_bwd": A.attention_bwd.launches}

    trainer = holder["trainer"]
    with open(os.path.join(out_dir, "log.txt")) as f:
        log = f.read()
    evaluated = [int(c) for c in re.findall(r"Evaluate on the client(\d+)_test set", log)]
    runner = CheckedRunner.last
    if parallel:
        if runner is None:
            raise AssertionError("the CLI built no client-parallel runner")
        # the batches each round must run, from the set sizes: per client
        # its full batches, one cycled batch when it holds fewer than a
        # batch, none when it is empty; every evaluated client pads its test
        # batches to the most of its round
        loader_cfg = trainer.cfg.DATALOADER
        bs, bs_test = loader_cfg.TRAIN_X.BATCH_SIZE, loader_cfg.TEST.BATCH_SIZE
        n_tr = {c: len(ld.dataset) for c, ld in trainer.fed_train_loader_x_dict.items()}
        n_te = {c: len(ld.dataset) for c, ld in trainer.fed_test_loader_x_dict.items()}
        trained, n_train = {}, 0  # round -> clients that trained a step
        for r in runner.resolved:
            want = [n_tr[c] // bs if n_tr[c] >= bs else int(n_tr[c] > 0) for c in r["clients"]]
            if r["n_steps"] != want:
                raise AssertionError(f"round {r['round']}: the runner ran {r['n_steps']} "
                                     f"steps for clients {r['clients']}, the data gives {want}")
            trained.setdefault(r["round"], []).extend(
                c for c, n in zip(r["clients"], want) if n > 0)
            n_train += sum(want)
        n_eval = sum(len(cs) * max(-(-n_te[c] // bs_test) for c in cs) for cs in runner.eval_calls)
        if n_eval != runner.eval_batches or sorted(evaluated) != sorted(
                c for cs in runner.eval_calls for c in cs):
            raise AssertionError(f"the runner evaluated {runner.eval_batches} batches for "
                                 f"{runner.eval_calls}, the data gives {n_eval}; the log "
                                 f"evaluated {evaluated}")
        steps = [{"loss": float(r["metrics"][j, i, 0]), "valid": float(r["metrics"][j, i, 1])}
                 for r in runner.resolved for j, n in enumerate(r["n_steps"]) for i in range(n)]
    else:
        trained = {}  # round -> clients, from "Save checkpoint to .../epoch{r}_client{i}.npz"
        for r, c in re.findall(r"Save checkpoint to .*epoch(\d+)_client(\d+)\.npz", log):
            trained.setdefault(int(r), []).append(int(c))
        n_train = sum(len(trainer.fed_train_loader_x_dict[c])
                      for cs in trained.values() for c in cs)
        n_eval = sum(len(trainer.fed_test_loader_x_dict[c]) for c in evaluated)
    # every batch runs each text block (and each ViT block) once.  The
    # backward reaches every text block (the prompt context sits before
    # block 0) and the ViT blocks from the first whose input carries a
    # gradient: block 1 when only adapters train, block 0 when the slice
    # projector (or a trainable ln_pre) sits before it, none when nothing in
    # the image tower trains (PromptFL, GLP_OT with a frozen image encoder)
    clip = trainer.bundle.clip_cfg
    t = clip.transformer_layers
    trainable = trainer.trainable
    if trainer.backbone_type == "vit":
        v = clip.vision_layers
        if getattr(trainer, "is_3d_input", False) or "visual_ln_pre" in trainable:
            v_bwd = v
        else:
            v_bwd = v - 1 if "image_encoder_lora" in trainable else 0
        width, layers = [clip.vision_width, clip.transformer_width], [v, t]
    else:  # the ResNet tower runs no attention kernel
        rn = trainer.bundle.rn_cfg
        v = v_bwd = 0
        width, layers = [rn.width, rn.embed_dim, clip.transformer_width], [list(rn.layers), t]
    expected = {"attention_fwd": (n_train + n_eval) * (v + t),
                "attention_bwd": n_train * (v_bwd + t)}
    finals = {}
    for idx in range(args.num_users):
        with np.load(os.path.join(out_dir, f"global_client{idx}_final.npz")) as z:
            finals[idx] = {k: z[k] for k in z.files}
    cum = result["time"]

    def median(xs):
        xs = list(xs)
        return statistics.median(xs) if xs else None

    res = {"entry": "fairfedmed_tpu_torch.federated_main.main", "argv": argv,
           "model": trainer.cfg.MODEL.BACKBONE.NAME, "backbone_type": trainer.backbone_type,
           "modality": trainer.cfg.DATASET.MODALITY_TYPE, "width": width, "layers": layers,
           "aggregation": args.model, "trainer": args.trainer,
           "prec": trainer.cfg.TRAINER[getattr(trainer, "prec_node", "GLP_OT")].PREC,
           "device": str(trainer.device), "main_s": main_s,
           "round_s": [cum[0]] + [b - a for a, b in zip(cum, cum[1:])],
           "trained_clients": trained, "evaluated_clients": evaluated,
           "train_batches": n_train, "eval_batches": n_eval,
           "steps": steps, "step_ms_median": median(s["ms"] for s in steps if "ms" in s),
           "epochs": epochs,
           "data_ms_per_batch_median": median(e["data_ms_per_batch"] for e in epochs),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "rounds_wall_s": cum[-1] if cum else None,
           "acc": result["acc"], "auc": result["auc"],
           "final_npz_finite": {i: len(z) > 0 and all(np.isfinite(a).all() for a in z.values())
                                for i, z in finals.items()},
           "launches": launches, "expected_launches": expected}
    if parallel:
        res.update(
            rounds=[{**{k: v for k, v in d.items() if k != "syncs"}, "dispatch_syncs": d["syncs"],
                     "resolve_s": r["resolve_s"], "resolve_syncs": r["syncs"],
                     "clients": r["clients"], "n_steps": r["n_steps"]}
                    for d, r in zip(runner.dispatches, runner.resolved)],
            fetches=runner.fetches, cache_bytes=runner._cached_bytes,
            cached_clients={"train": sorted(c for c, v in runner._data_cache.items() if v),
                            "eval": sorted(c for c, v in runner._eval_cache.items() if v)},
            cache_dtypes=sorted({str(v["img"].dtype).replace("torch.", "")
                                 for v in list(runner._data_cache.values())
                                 + list(runner._eval_cache.values()) if v}))
        res["runner"] = runner
    else:
        res.update(time_h2d(next(iter(trainer.fed_train_loader_x_dict[0]))["img"], dev))
    return res, finals, trainer


def check_cli_run(res, rounds, trained_per_round=None, with_auc=True):
    """What every CLI path must show: how many clients each round trains
    (all of them in round 0; by default the FairLoRA launchers' 3 and then
    int(0.8 * 3)), finite losses and metrics (an AUC per round where the
    branch reports one), finite final weights, the expected launches."""
    if trained_per_round is None:
        trained_per_round = (CLI_SITES, int(0.8 * CLI_SITES))[:rounds]
    trained = res["trained_clients"]
    counts = tuple(len(trained.get(r, [])) for r in range(len(trained_per_round)))
    if counts != tuple(trained_per_round) or len(trained) != len(trained_per_round) or (
            trained and sorted(trained[0]) != list(range(trained_per_round[0]))):
        raise AssertionError(f"unexpected clients trained: {trained}")
    if trained_per_round and (not res["steps"]
                              or not all(np.isfinite(s["loss"]) for s in res["steps"])):
        raise AssertionError(f"non-finite or missing losses: {res['steps']}")
    if "rounds" in res:  # the client-parallel rounds
        check_parallel_rounds(res, rounds)
    if len(res["acc"]) != rounds or len(res["auc"]) != (rounds if with_auc else 0) \
            or not np.isfinite(res["acc"] + res["auc"]).all():
        raise AssertionError(f"non-finite or missing metrics: {res['acc']} {res['auc']}")
    if not all(res["final_npz_finite"].values()):
        raise AssertionError(f"final weights missing or not finite: {res['final_npz_finite']}")
    if res["launches"] != res["expected_launches"]:
        raise AssertionError(f"kernel launches {res['launches']} != expected "
                             f"{res['expected_launches']}")


def check_parallel_rounds(res, rounds):
    """The client-parallel rounds: one blocking fetch per round (the one
    call of the resolve half and its evaluation that waits for the device),
    and no such call in the dispatch half of a round after the first (round
    0 fills the device caches)."""
    if res["fetches"] != rounds or len(res["rounds"]) != rounds:
        raise AssertionError(f"{res['fetches']} blocking fetches in {len(res['rounds'])} "
                             f"rounds, expected one in each of {rounds}")
    for r in res["rounds"]:
        if len(r["resolve_syncs"]) != 1:
            raise AssertionError(f"round {r['round']}'s resolve waited for the device "
                                 f"{len(r['resolve_syncs'])} times: {r['resolve_syncs'][:20]}")
        if r["round"] >= 1 and r["deferred"] and r["dispatch_syncs"]:
            raise AssertionError(f"round {r['round']}'s dispatch waited for the device: "
                                 f"{r['dispatch_syncs'][:20]}")


SLO_ROOT = os.path.join(REPO, "build", "chip_smoke_data")
OCT_ROOT = os.path.join(REPO, "build", "chip_smoke_data_oct")


def _write_fixture(root, **kw):
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    fixture = write_fairfedmed_fixture(root, **kw)
    fixture["write_s"] = time.perf_counter() - t0
    return fixture


def cli_path(dev):
    """The launcher script's flags, ViT-B/16 on SLO fundus, 2 rounds."""
    from fairfedmed_tpu_torch import native

    fixture = _write_fixture(SLO_ROOT)
    t0 = time.perf_counter()
    decoder = native.decoder()  # builds the native reader now, not inside a step
    decoder_build_s = time.perf_counter() - t0
    res, _, _ = run_cli(SCRIPT, SLO_ROOT, os.path.join(REPO, "build", "chip_smoke_cli"), 2, dev)
    res = {"phase": "cli_path", **res, "fixture": fixture, "decoder": decoder,
           "decoder_build_s": decoder_build_s}
    if decoder != "native":
        res["decoder_build_log"] = native.build_log()[-2000:]
    emit(res)
    check_cli_run(res, 2)
    return res["launches"]


SEQUENTIAL = {}  # what the parallel phases compare with, from the sequential ones


def oct_path(dev):
    """scripts/fairfedlora_fairfedmed_oct.sh: ViT-B/16 FairLoRA on 3D OCT
    B-scans (32 of each volume's 128, 2 slices of 16), 2 rounds."""
    fixture = _write_fixture(OCT_ROOT, n_train=OCT_TRAIN, n_test=OCT_TEST, modality="oct_bscans")
    res, finals, trainer = run_cli(OCT_SCRIPT, OCT_ROOT,
                                   os.path.join(REPO, "build", "chip_smoke_oct"), 2, dev)
    res = {"phase": "oct_path", **res, "fixture": fixture}
    SEQUENTIAL["oct_path"] = {k: res[k] for k in ("round_s", "data_ms_per_batch_median",
                                                  "train_batches", "eval_batches",
                                                  "peak_mem_gib")}
    emit(res)
    check_cli_run(res, 2)
    if not all(z["proj_per_3d_slice.weight"].shape == (3, 16, 5, 5) for z in finals.values()):
        raise AssertionError("proj_per_3d_slice.weight missing from the final weights")
    emit(profile_step(trainer, next(iter(trainer.fed_train_loader_x_dict[0])),
                      res["step_ms_median"], "oct_path_profile"))
    return res["launches"]


def _check_bn_stats(finals):
    """Every BatchNorm running statistic in the final weights is finite and
    has moved from its init (mean 0, var 1)."""
    for idx, z in finals.items():
        keys = [k for k in z if "running_" in k]
        moved = all(np.abs(z[k]).max() > 0 if k.endswith("running_mean")
                    else np.abs(z[k] - 1).max() > 0 for k in keys)
        if not keys or not moved or not all(np.isfinite(z[k]).all() for k in keys):
            raise AssertionError(f"client {idx}: BatchNorm running statistics missing, "
                                 "non-finite or unmoved")
    return len(keys)


def rn50_path(dev):
    """scripts/fairfedlora_fairfedmed_rn50.sh: RN50 FairLoRA (rank 32, alpha
    8) on the SLO fixture cli_path wrote, 2 rounds."""
    res, finals, trainer = run_cli(RN50_SCRIPT, SLO_ROOT,
                                   os.path.join(REPO, "build", "chip_smoke_rn50"), 2, dev)
    res = {"phase": "rn50_path", **res, "bn_stat_tensors": _check_bn_stats(finals)}
    emit(res)
    check_cli_run(res, 2)
    emit(profile_step(trainer, next(iter(trainer.fed_train_loader_x_dict[0])),
                      res["step_ms_median"], "rn50_path_profile"))
    return res["launches"]


def rn50_oct_path(dev):
    """scripts/fairfedlora_fairfedmed_oct_rn50.sh: RN50 on the OCT fixture
    oct_path wrote, 1 round."""
    res, finals, trainer = run_cli(RN50_OCT_SCRIPT, OCT_ROOT,
                                   os.path.join(REPO, "build", "chip_smoke_rn50_oct"), 1, dev)
    res = {"phase": "rn50_oct_path", **res, "bn_stat_tensors": _check_bn_stats(finals)}
    emit(res)
    check_cli_run(res, 1)
    emit(profile_step(trainer, next(iter(trainer.fed_train_loader_x_dict[0])),
                      res["step_ms_median"], "rn50_oct_path_profile"))
    return res["launches"]


OT_RUNS = (  # (trainer, OT, UNFREEZE_IMAGE_ENCODER)
    ("GLP_OT_SVLoRA", "None", True),
    ("GLP_OT_SVLoRA", "Sinkhorn", True),
    ("GLP_OT_SVLoRA", "COT", True),
    ("GLP_OT", "COT", True),
)
OT_STEPS = 6


def ot_path(dev):
    """The trainer driven directly at ViT-B/16 (bf16), batch 32 SLO fundus
    in memory, at the launchers' EPS 0.1 / THRESH 0.001 / MAX_ITER 100 /
    TOP_PERCENT 0.8: FairLoRA with OT None (the baseline), Sinkhorn and COT,
    and the prompt-only GLP_OT (COT, ln_pre unfrozen), OT_STEPS steps each.
    Every step must be valid (finite loss); beside each: the solver's
    iterations per step, the median step time against OT None's, and the
    solver alone on the step's [B*n_cls, M, N] problem (its host enqueue
    time per call, which a host-bound step pays, and CUDA events around
    back-to-back calls)."""
    runs, expected = [], {"attention_fwd": 0, "attention_bwd": 0}
    A.attention_fwd.launches = 0
    A.attention_bwd.launches = 0
    for trainer_name, ot, unfreeze in OT_RUNS:
        cfg = fairlora_cfg("ViT-B/16", 224, "fp16", ot=ot, trainer=trainer_name)
        cfg.TRAINER.GLP_OT_LORA.UNFREEZE_IMAGE_ENCODER = unfreeze
        dm = make_dm(np.random.default_rng(cfg.SEED), OT_STEPS, 32, 1, 224)
        trainer = build_trainer(cfg, dm, device=dev)
        trainer.num_batches = OT_STEPS + 1  # no LR step
        steps = []
        for i, batch in enumerate(dm.fed_train_loader_x_dict[0]):
            trainer.batch_idx = i
            t = time.perf_counter()
            out = trainer.forward_backward(batch)  # ends in a host fetch
            ms = (time.perf_counter() - t) * 1e3
            steps.append({"loss": out["loss"], "ms": ms, "ot_iterations": (
                None if trainer.ot_iterations is None else int(trainer.ot_iterations))})
        clip = trainer.bundle.clip_cfg
        v, t = clip.vision_layers, clip.transformer_layers
        v_bwd = v if "visual_ln_pre" in trainer.trainable else v - 1
        expected["attention_fwd"] += OT_STEPS * (v + t)
        expected["attention_bwd"] += OT_STEPS * (v_bwd + t)
        run = {"trainer": trainer_name, "ot": ot, "unfreeze_image_encoder": unfreeze,
               "optimizer_steps_per_batch": trainer.opt_steps_per_batch, "steps": steps,
               "step_ms_median_after_first": statistics.median(s["ms"] for s in steps[1:])}
        if ot != "None":
            rows, m = 32 * len(CLASSNAMES), (224 // clip.vision_patch_size) ** 2
            gen = torch.Generator(device=dev).manual_seed(0)
            sim = torch.rand((rows, m, cfg.TRAINER.GLP_OT.N), device=dev, generator=gen) * 0.8 - 0.2
            kernel = torch.exp(-(1.0 - sim) / 0.1)
            xx = torch.full((rows, m), 1.0 / m, device=dev)
            yy = torch.full((rows, cfg.TRAINER.GLP_OT.N), 1.0 / cfg.TRAINER.GLP_OT.N, device=dev)
            solve = (lambda: sinkhorn(kernel, xx, yy, 0.001, 100)) if ot == "Sinkhorn" else \
                (lambda: entropic_cot(kernel, xx, yy * 0.8, 100, 0.001))
            run.update(solver_shape=[rows, m, cfg.TRAINER.GLP_OT.N],
                       solver_host_ms=host_ms(solve, iters=10),
                       solver_ms_events=cuda_ms(solve, iters=10))
        runs.append(run)
        del trainer
    launches = {"attention_fwd": A.attention_fwd.launches,
                "attention_bwd": A.attention_bwd.launches}
    base = runs[0]["step_ms_median_after_first"]
    for r in runs:
        r["ms_over_ot_none"] = r["step_ms_median_after_first"] - base
    emit({"phase": "ot_path", "model": "ViT-B/16", "prec": "fp16 (bf16)", "batch": 32,
          "eps": 0.1, "thresh": 0.001, "max_iter": 100, "top_percent": 0.8, "runs": runs,
          "launches": launches, "expected_launches": expected})
    for r in runs:
        if not all(np.isfinite(s["loss"]) for s in r["steps"]):
            raise AssertionError(f"invalid plan or non-finite loss: {r}")
        if r["ot"] != "None" and not all(1 <= s["ot_iterations"] <= 100 for s in r["steps"]):
            raise AssertionError(f"solver iterations out of range: {r}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != expected {expected}")
    return launches


def _kernel_class(name: str) -> str:
    if "attention_" in name:
        return "attention (port kernels)"
    if any(t in name.lower() for t in ("conv", "cudnn", "fprop", "dgrad", "wgrad")):
        return "convolution (cuDNN)"
    if any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "nvjet", "wgmma")):
        return "matmul (cuBLAS)"
    return "other (elementwise, norms, reductions, copies)"


def profile_step(trainer, batch, step_ms, phase="main_path_profile"):
    """One more training step of a path under torch.profiler: kernel time by
    class, and the device's idle share of an unprofiled step (``step_ms``:
    the path's median step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer.batch_idx, trainer.num_batches = 0, 2  # not the last batch: no LR step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.forward_backward(batch)
        torch.cuda.synchronize()
    by_class, by_kernel = {}, {}
    for evt in prof.key_averages():
        # "name#..." rows (Optimizer.step#SGD.step) are annotations spanning
        # kernels counted in their own rows
        if evt.device_type == DeviceType.CUDA and evt.device_time_total > 0 and "#" not in evt.key:
            ms = evt.device_time_total / 1e3
            cls = _kernel_class(evt.key)
            by_class[cls] = by_class.get(cls, 0.0) + ms
            by_kernel[evt.key[:90]] = ms
    device_ms = sum(by_class.values())
    return {"phase": phase, "kernel_ms": device_ms, "unprofiled_step_ms": step_ms,
            "device_idle_share": 1 - device_ms / step_ms,
            "kernel_ms_by_class": by_class,
            "top_kernels_ms": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]}


def _check_ctx(finals, n_prompts, trainer):
    """Every client's final prompt context is [n_prompts, 4 (--n_ctx), text
    width]."""
    shapes = {i: z["prompt_learner.ctx"].shape for i, z in finals.items()}
    if set(shapes.values()) != {(n_prompts, 4, trainer.bundle.clip_cfg.transformer_width)}:
        raise AssertionError(f"final prompt contexts: {shapes}")


def _branch_path(phase, script, rounds, dev, overrides=(), on_build=None):
    out_dir = os.path.join(REPO, "build", f"chip_smoke_{phase}")
    res, finals, trainer = run_cli(script, SLO_ROOT, out_dir, rounds, dev,
                                   FAIRFEDMED_FLAGS + tuple(overrides), on_build)
    changed = [list(f) for f in FAIRFEDMED_FLAGS + tuple(overrides)]
    return {"phase": phase, "changed_flags": changed, **res}, finals, trainer


def promptfl_path(dev):
    """scripts/fedchexmimic/promptfl_fedchexmimic.sh (fedavg, PromptFL,
    ViT-B/16) on cli_path's SLO fixture, 2 rounds; then a profiled step."""
    res, finals, trainer = _branch_path("promptfl_path", PROMPTFL_SCRIPT, 2, dev)
    emit(res)
    check_cli_run(res, 2, (2, 2), with_auc=False)
    _check_ctx(finals, 1, trainer)
    emit(profile_step(trainer, next(iter(trainer.fed_train_loader_x_dict[0])),
                      res["step_ms_median"], "promptfl_path_profile"))
    return res["launches"]


def fedotp_path(dev):
    """scripts/fedchexmimic/fedotp_fedchexmimic.sh (FedOTP, prompt-only
    GLP_OT, COT, 2 prompts) on cli_path's SLO fixture, 2 rounds: every plan
    valid (a finite loss on every step), an AUC per round."""
    res, finals, trainer = _branch_path("fedotp_path", FEDOTP_SCRIPT, 2, dev)
    res["ot_iterations_last_step"] = int(trainer.ot_iterations)
    emit(res)
    check_cli_run(res, 2, (2, 2), with_auc=True)
    _check_ctx(finals, 2, trainer)
    return res["launches"]


def clip_path(dev):
    """The PromptFL launcher's flags with ``--trainer CLIP``: zero-shot
    evaluation of both clients, one round, no backward."""
    res, finals, trainer = _branch_path("clip_path", PROMPTFL_SCRIPT, 1, dev,
                                        [("--trainer", "CLIP")])
    emit(res)
    check_cli_run(res, 1, (), with_auc=False)
    if res["launches"]["attention_bwd"] != 0 or sorted(res["evaluated_clients"]) != [0, 1]:
        raise AssertionError(f"CLIP ran a backward or missed a client: {res}")
    _check_ctx(finals, 1, trainer)
    return res["launches"]


def fedprox_path(dev):
    """The PromptFL launcher's flags with ``--model fedprox --mu 0.5``, one
    round.  Each step's loss, its plain CE and the proximal term
    ``(mu / 2) * ||ctx - ctx_global||^2`` are kept on the device and read
    after the round: the term is 0 on each client's first step (the client
    starts at the global context) and positive after; the loss is CE + term
    to fp32 rounding; the reported loss is never below the CE and exceeds
    it on every step whose term is above the rounding (two units in the
    last place of the CE), of which there must be one.  At lr 0.001 the
    term can be smaller than that."""
    from fairfedmed_tpu_torch.train.clip_common import cross_entropy, fedprox_term

    records = []

    def on_build(trainer):
        loss_fn = trainer._loss

        def recording_loss(logits, label):
            loss = loss_fn(logits, label)
            ctx_global = trainer._fedprox_ctx_global if trainer.fedprox else None
            term = (torch.zeros((), device=loss.device) if ctx_global is None
                    else fedprox_term(trainer.ctx, ctx_global, trainer.mu))
            records.append(torch.stack([loss.detach().float(),
                                        cross_entropy(logits, label).detach(), term.float()]))
            return loss

        trainer._loss = recording_loss

    res, finals, trainer = _branch_path("fedprox_path", PROMPTFL_SCRIPT, 1, dev,
                                        [("--model", "fedprox"), ("--mu", "0.5")], on_build)
    rec = torch.stack(records).cpu().numpy()  # fp32 [steps, (loss, ce, term)]
    ulp = np.spacing(rec[:, 1]).astype(np.float64)
    rec = rec.astype(np.float64)
    reported = np.array([s["loss"] for s in res["steps"]])
    first = np.cumsum([0] + [e["batches"] for e in res["epochs"]])[:-1]  # each client's first step
    later = np.setdiff1d(np.arange(len(rec)), first)
    visible = rec[:, 2] > 2 * ulp
    res.update(loss_ce_term=rec.tolist(), reported_minus_ce=(reported - rec[:, 1]).tolist(),
               term_above_rounding=visible.tolist())
    emit(res)
    check_cli_run(res, 1, (2,), with_auc=False)
    _check_ctx(finals, 1, trainer)
    if not (len(rec) == len(reported) and len(later) > 0 and np.all(rec[first, 2] == 0)
            and np.all(rec[later, 2] > 0)
            and np.all(np.abs(rec[:, 0] - (rec[:, 1] + rec[:, 2])) <= 2 * ulp)
            and np.all(reported >= rec[:, 1]) and visible.any()
            and np.all(reported[visible] > rec[visible, 1])):
        raise AssertionError(f"the FedProx term is missing from the loss: {rec.tolist()}")
    return res["launches"]


# --------------------------------------------------------------------------- #
# phase 8: the client-parallel rounds (--parallel_clients, the launchers' own)
# --------------------------------------------------------------------------- #

def _parallel_run(phase, script, data_root, rounds, dev, overrides=(), opts=()):
    """run_cli with the launcher's ``--parallel_clients``; the result
    without the runner object, the runner, the final weights and the
    trainer."""
    out_dir = os.path.join(REPO, "build", f"chip_smoke_{phase}")
    res, finals, trainer = run_cli(script, data_root, out_dir, rounds, dev, overrides,
                                   parallel=True, opts=opts)
    runner = res.pop("runner")
    return {"phase": phase, **res}, runner, finals, trainer


def parallel_cli_path(dev):
    """scripts/fairfedlora_fairfedmed.sh with its ``--parallel_clients``
    (FedOTPLoRA, ema_personal: per-client state and optimizer state on the
    device) on cli_path's SLO fixture, 2 rounds."""
    res, _, _, _ = _parallel_run("parallel_cli_path", SCRIPT, SLO_ROOT, 2, dev)
    emit(res)
    check_cli_run(res, 2)
    if res["cache_dtypes"] != ["uint8"] or res["cached_clients"]["train"] != [0, 1, 2]:
        raise AssertionError(f"SLO caches: {res['cache_dtypes']} {res['cached_clients']}")
    return res["launches"]


def parallel_oct_path(dev):
    """scripts/fairfedlora_fairfedmed_oct.sh with its ``--parallel_clients``
    on oct_path's fixture, 2 rounds: round 0 decodes every client's volumes
    once into the device caches (fp32: the 200 -> 224 slice resize leaves
    them fractional), round 1 trains from them.  The host data time per
    round beside oct_path's."""
    res, _, finals, _ = _parallel_run("parallel_oct_path", OCT_SCRIPT, OCT_ROOT, 2, dev)
    seq = SEQUENTIAL.get("oct_path")
    if seq is not None:  # its data time covers the training batches only
        res["oct_path"] = {**seq, "train_host_data_s": seq["data_ms_per_batch_median"] * 1e-3
                           * seq["train_batches"]}
    emit(res)
    check_cli_run(res, 2)
    if res["cached_clients"]["train"] != [0, 1, 2] or res["cached_clients"]["eval"] != [0, 1, 2]:
        raise AssertionError(f"round 1 did not train from the device caches: "
                             f"{res['cached_clients']}")
    if not all(z["proj_per_3d_slice.weight"].shape == (3, 16, 5, 5) for z in finals.values()):
        raise AssertionError("proj_per_3d_slice.weight missing from the final weights")
    return res["launches"]


def parallel_rn50_path(dev):
    """scripts/fairfedlora_fairfedmed_rn50.sh with its ``--parallel_clients``
    on the SLO fixture, 1 round: every client's ``__bn_stats__`` finite and
    moved from the init (mean 0, var 1)."""
    res, runner, finals, _ = _parallel_run("parallel_rn50_path", RN50_SCRIPT, SLO_ROOT, 1, dev)
    stats = {k: v for k, v in runner.personal_t.items() if k.startswith("__bn_stats__.")}
    per_client = []
    for c in range(runner.num_users):
        rows = {k: v[c].float() for k, v in stats.items()}
        per_client.append({
            "finite": all(bool(torch.isfinite(v).all()) for v in rows.values()),
            "moved": all(bool(((v != 0) if k.endswith(".mean") else (v != 1)).any())
                         for k, v in rows.items())})
    res.update(bn_stat_tensors=len(stats), bn_stats_per_client=per_client,
               final_bn_stat_tensors=_check_bn_stats(finals))
    emit(res)
    check_cli_run(res, 1)
    if not stats or not all(p["finite"] and p["moved"] for p in per_client):
        raise AssertionError(f"per-client BatchNorm statistics: {per_client}")
    return res["launches"]


def parallel_branches(dev):
    """The other branches with the launchers' ``--parallel_clients``, on
    cli_path's SLO fixture with the same FairFedMed substitutions as
    promptfl_path: promptfl_fedchexmimic.sh (fedavg, PromptFL) and
    fedotp_fedchexmimic.sh (FedOTP, prompt_personal, COT; every plan valid),
    2 rounds each; fairfedlora_fedchexmimic_local.sh (local) and the
    PromptFL flags with ``--model fedprox --mu 0.5``, 1 round each.  Launches
    are counted per run (the counters zeroed before each) and summed."""
    runs = (("parallel_promptfl", PROMPTFL_SCRIPT, 2, (), False),
            ("parallel_fedotp", FEDOTP_SCRIPT, 2, (), True),
            ("parallel_local", LOCAL_SCRIPT, 1, (), False),
            ("parallel_fedprox", PROMPTFL_SCRIPT, 1, (("--model", "fedprox"), ("--mu", "0.5")),
             False))
    total = {"attention_fwd": 0, "attention_bwd": 0}
    for phase, script, rounds, extra, with_auc in runs:
        overrides = FAIRFEDMED_FLAGS + tuple(extra)
        res, _, finals, trainer = _parallel_run(phase, script, SLO_ROOT, rounds, dev, overrides)
        res["changed_flags"] = [list(f) for f in overrides]
        emit(res)
        check_cli_run(res, rounds, (2,) * rounds, with_auc=with_auc)
        if phase == "parallel_fedotp" and not all(s["valid"] == 1 for s in res["steps"]):
            raise AssertionError(f"an invalid OT plan: {res['steps']}")
        _check_ctx(finals, 1 if script == PROMPTFL_SCRIPT else 2, trainer)
        for k in total:
            total[k] += res["launches"][k]
    emit({"phase": "parallel_branches", "launches": total})
    return total


def parallel_equiv(dev):
    """The client-parallel rounds against the sequential loop on the card
    where they compute the same function: momentum 0, fp32,
    ``test-vit-224``, the FairLoRA launcher's flags with 2 clients (frac
    1.0) for 2 rounds on the SLO fixture.  Tolerance: acc and AUC 1e-6
    (percent), final weights 1e-5 + 1e-4 relative (fp32, the optimizer's
    update rounded in another order)."""
    overrides = (("--backbone", "test-vit-224"), ("--num_users", "2"), ("--frac", "1.0"))
    opts = ("OPTIM.MOMENTUM", "0.0", "TRAINER.GLP_OT.PREC", "fp32")
    seq, seq_finals, _ = run_cli(SCRIPT, SLO_ROOT,
                                 os.path.join(REPO, "build", "chip_smoke_equiv_seq"), 2, dev,
                                 overrides, opts=opts)
    par, _, par_finals, _ = _parallel_run("parallel_equiv", SCRIPT, SLO_ROOT, 2, dev, overrides,
                                          opts)
    check_cli_run(seq, 2, (2, 2))
    check_cli_run(par, 2, (2, 2))
    tol = {"acc_auc": 1e-6, "weights_atol": 1e-5, "weights_rtol": 1e-4}
    metric_err = max(abs(a - b) for k in ("acc", "auc") for a, b in zip(par[k], seq[k]))
    weight_err, weight_excess = 0.0, 0.0
    for c, want in seq_finals.items():
        for k, w in want.items():
            err = np.abs(par_finals[c][k] - w)
            weight_err = max(weight_err, float(err.max()))
            weight_excess = max(weight_excess, float(
                (err - tol["weights_atol"] - tol["weights_rtol"] * np.abs(w)).max()))
    launches = {k: seq["launches"][k] + par["launches"][k] for k in seq["launches"]}
    res = {"phase": "parallel_equiv", "model": "test-vit-224", "prec": "fp32", "momentum": 0.0,
           "tol": tol, "acc": {"sequential": seq["acc"], "parallel": par["acc"]},
           "auc": {"sequential": seq["auc"], "parallel": par["auc"]},
           "metric_max_abs_err": metric_err, "weights_max_abs_err": weight_err,
           "round_s": {"sequential": seq["round_s"], "parallel": par["round_s"]},
           "parallel_rounds": par["rounds"], "fetches": par["fetches"],
           "launches": launches, "launches_sequential": seq["launches"],
           "launches_parallel": par["launches"]}
    emit(res)
    if len(par["acc"]) != 2 or metric_err > tol["acc_auc"] or weight_excess > 0:
        raise AssertionError(f"parallel != sequential: metrics {metric_err}, weights {weight_err}")
    return launches


PATHS = ("main_path", "cli_path", "oct_path", "rn50_path", "rn50_oct_path", "ot_path",
         "promptfl_path", "fedotp_path", "clip_path", "fedprox_path", "parallel_cli_path",
         "parallel_oct_path", "parallel_rn50_path", "parallel_branches", "parallel_equiv")


def kernels_line(rows, launches):
    """The two kernels at the vision training shape in bf16, the shape and type
    the main path spends most of its attention time on, with the tensor-core
    kernels' resources: registers and spills from ptxas, shared memory and
    resident blocks from the CUDA runtime, waves = blocks / (SMs x resident
    blocks per SM), and bound share = bound / cold time.  ``launches`` is
    main_path's count, ``launches_<path>`` every other path's."""
    row = next(r for r in rows if r["shape"] == "vision_train" and r["dtype"] == "bfloat16")
    n, length, dh = row["n_L_dh"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for kind, tpu_line in (("fwd", "fairfedmed_tpu/ops/attention.py:37 (_fwd_kernel, via "
                                    "_attend_impl :105)"),
                           ("bwd", "fairfedmed_tpu/ops/attention.py:54 (_bwd_kernel, via "
                                   "_attend_bwd_impl :118)")):
        name = f"attention_{kind}"
        log = _build.library_path(name).with_suffix(".log").read_text()
        info = A.launch_info(kind, n, length, dh)
        out.append(dict(
            ptxas_kernel(log, f"{name}_mma_kernelILi{dh}E"), name=name, route="cuda",
            source=f"fairfedmed_tpu_torch/csrc/{name}.cu", replaces=tpu_line,
            launches=launches["main_path"][name],
            **{f"launches_{p}": launches[p][name] for p in PATHS[1:]},
            max_abs_err=row[f"{kind}_max_abs_err"],
            ms=row[f"kernel_{kind}_ms"], ms_cold=row[f"kernel_{kind}_ms_cold"],
            ms_events=row[f"kernel_{kind}_ms_events"], host_ms=row[f"kernel_{kind}_host_ms"],
            plain_ms=row[f"plain_{kind}_ms"], bound_ms=row[f"{kind}_bound_ms"],
            bound_by=row[f"{kind}_bound_by"], library_ms=row[f"sdpa_{kind}_ms"],
            library_ms_cold=row[f"sdpa_{kind}_ms_cold"],
            bound_share=row[f"{kind}_bound_ms"] / row[f"kernel_{kind}_ms_cold"],
            smem_bytes=info["smem_bytes"], threads=info["threads"],
            blocks=info["blocks"], blocks_per_sm=info["blocks_per_sm"],
            waves=info["blocks"] / (sms * info["blocks_per_sm"])))
    return {"kernels": out}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = "cuda"
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    spills = sorted({line.strip() for log in logs.values() for line in log.splitlines()
                     if "spill" in line and not line.strip().startswith("0 bytes stack")})
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0), "kernel_build_s": build_s,
          "kernels_built": sorted(logs), "ptxas_spill_lines": spills})

    rows = check_kernels(dev)
    emit({"phase": "kernel_checks", "rows": rows})
    emit(small_reference(dev))
    launches = {}
    for name in PATHS:
        t0 = time.perf_counter()
        launches[name] = globals()[name](dev)
        emit({"phase": f"{name}_done", "s": time.perf_counter() - t0})
    emit(kernels_line(rows, launches))
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    print(nvidia_smi_line())
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
