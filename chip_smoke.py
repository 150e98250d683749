#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fairfedmed_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each printing one JSON line:

1. ``card``: the card, its power limit, the versions, and the time to build
   the CUDA kernels from ``fairfedmed_tpu_torch/csrc`` (one nvcc per source,
   all at once).
2. ``wgmma_check``: the warpgroup products the attention kernels issue,
   one at a time (``csrc/wgmma_check.cu``: A from shared memory and from
   registers, B K-major and MN-major, N = 64, 32, 16 and the head width,
   the swizzle of each head width 16, 32, 64), against ``torch.matmul`` on
   the card.  Then ``kernel_checks``: each attention kernel (forward,
   backward) against its plain PyTorch version at the paths' shapes (the
   SLO and OCT vision batches, the text tower, and the widest text shapes:
   PromptFL on CIFAR-100 and the CLI's default run on Caltech101, at their
   EOT-cut lengths, and EVA02-CLIP-L/14-336's 577 tokens, its long-L
   path), fp32 (TF32 off) and bf16, with the max error beside its
   tolerance; times of the kernel, the plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
   then the RoPE head split (``ops/rope.py``) each way at EVA02's training
   and evaluation batches in bf16 against its plain version, timed alike.
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
   ``graph_step``: the client-parallel local step replayed from a CUDA graph
   (``train/graphed.py``) against the eager step at the benchmark's two
   configurations (ViT-B/16 and RN50 FairLoRA, bf16), bit for bit, with
   ``tests/test_torch_port_graph_step.py``'s check; then the device ms of a
   replayed step and of its two optimizer updates captured alone.
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
   FairFedMed's ``--attributes`` / ``--attribute_type race`` (9 runs them
   on their own dataset):
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
   - ``eva02_path``: fairfedlora_fairfedmed_eva02.sh (EVA02-CLIP-L/14-336,
     seeded weights) on an SLO fixture at 336 px, 2 rounds: attention and
     RoPE launches, every local step a graph replay, adapters on w1/w2/w3;
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
9. FairFedMed-Chest and CIFAR, through the CLI as in 5 with each launcher's
   own dataset config:
   - ``chexmimic_path``: a FedChexMimic fixture (2 sites x 64 train / 100
     test grayscale JPEGs, CheXpert 320x320 and MIMIC 336x336, copies of
     the committed ``tests/data/fedchexmimic_jpeg/``; race / gender / age
     drawn inside the trainer's group tables), then ``jpeg_check``: the
     JPEG decoder the port picks (libjpeg or PIL; none raises) held against
     ``decoded.npz`` within 1 grey level, and its decode and resize to 224
     per image; then ``scripts/fedchexmimic/fairfedlora_fedchexmimic.sh``
     without its ``--parallel_clients``, 2 rounds;
   - ``parallel_chexmimic``: the same launcher with its
     ``--parallel_clients``, 2 rounds (the resized X-rays cached as fp32),
     then ``fairfedlora_fedchexmimic_local.sh``, ``promptfl_fedchexmimic.sh``
     and ``fedotp_fedchexmimic.sh`` on their own data, 1 round each;
   - ``cifar_path``: CIFAR-10 (5000 train / 1000 test 32x32x3 uint8,
     pickles written with numpy) under the CLI's 10 users, beta 0.1 and
     ``--partition noniid-labeldir``: the PromptFL launcher's flags
     (fedavg) and the FedOTP launcher's (GLP_OT, COT), 1 round each with
     ``--parallel_clients``; then PromptFL on a CIFAR-100 fixture of the
     same size under the default ``noniid-labeldir100``, 1 round,
     sequential.  The images are normalised and resized 32 -> 224 on the
     card inside the step.
   Each run prints a ``<run>_summary`` line: round times, host data time,
   the JPEG decoder and its ms per image, cache bytes, peak memory, the
   launches of each kernel.
10. The image-folder datasets, on trees written here with PIL from a seed:
   - ``caltech_path``: the JAX CLI's own default run, ``--root``,
     ``--output-dir`` and ``--round 2`` and no other flag: FedOTP over
     GLP_OT, RN50 from configs/trainers/GLP_OT/rn50.yaml (5 local epochs,
     host transforms: bicubic random resized crop, flip, normalize), bf16,
     COT, 16 context tokens, 2 prompts, 10 users of 2 shots, on a
     Caltech-101 tree of 102 folders (100 classes once BACKGROUND_Google
     and Faces_easy are ignored) x 8 JPEGs of about 300x230, one in ten
     grayscale; the text tower runs 100 classes x 2 prompts x 8 heads at
     its EOT-cut length (``text_caltech``);
   - ``caltech_vit_parallel``: the same with ``--config-file
     configs/trainers/GLP_OT/vit_b16.yaml --parallel_clients``, 2 rounds:
     the host transforms refuse every device cache, so each round
     assembles its batches on the host and evaluates on the sequential
     path, with no device wait in its dispatch half;
   - ``office_path``: ``--model fedavg --trainer PromptFL --config-file
     configs/trainers/PromptFL/vit_b16.yaml --dataset-config-file
     configs/datasets/office.yaml --num_users 4 --round 1`` on an
     Office-Caltech-10 tree (4 sites x 40 train / 20 test JPEGs of
     300x300), sequential.
   Each checks the classes, a valid OT plan on every step, every client
   evaluated, and prints a summary line with the host data time per batch.
11. Round checkpoints, the Baseline trainer and the standalone CLI:
   - ``resume_path``: the FairLoRA launcher with its ``--parallel_clients``
     and ``TRAIN.CHECKPOINT_FREQ 1`` on cli_path's fixture: 2 rounds under
     ``FAIRFEDMED_ROUND_CKPT`` (only ``step_1`` left, equal bit for bit to
     the runner's state after round 1, LR step counter 10), then ``--round
     4 --resume DIR`` (continues at epoch 2, restores step_1 bit for bit,
     runs rounds 2 and 3, leaves ``step_3``), then ``--resume DIR`` with
     another ``--attribute_type`` (ignored, rounds 0 and 1); one metrics
     fetch per round and one fetch per checkpoint; save and load ms and
     bytes per checkpoint;
   - ``baseline_path``: the Baseline trainer on the GPU against the CPU at
     a small size, then ``--model fedavg --trainer Baseline`` through the
     CLI, 1 round each: ResNet-50 and the Dassl ViT-B/16 on the SLO fixture
     at 224, ResNet-18 with the mlp head on cifar_path's CIFAR-10 fixture,
     cnn3 there with ``--parallel_clients`` (the sequential notice); fp32,
     no kernel launch;
   - ``train_cli_path``: ``python -m fairfedmed_tpu_torch.tools.train`` with
     GLP_OT_SVLoRA at ViT-B/16 on one SLO site: train 2 epochs and save;
     ``--eval-only`` from the checkpoint gives the same test results;
     ``--resume`` restarts at the saved epoch (nothing to train at 2
     epochs, the third epoch only at 3).
12. ``timing_path``: the FairLoRA launcher's parallel rounds with
   ``FAIRFEDMED_TIMING=1`` on cli_path's fixture (2 rounds) and on
   oct_path's (1 round), stdout and stderr kept: every round prints the
   JAX runner's labels in its order, every build stamp appears once per
   trainer build, the times are finite and >= 0, a round's labels sum to
   at most its wall time (dispatch, resolve and evaluation) plus 5%, and
   the SLO run launches the kernels as parallel_cli_path did; per round
   the seconds of each label and the wall times of both runs.
13. ``dist_path``: the client-parallel rounds over several ranks.  The
   FairLoRA launcher's flags with its ``--parallel_clients`` (ViT-B/16 at
   full width, rank 12, alpha 2, batch 32) on cli_path's fixture, 2 rounds,
   each run in spawned processes on the one card: 1 rank against 2 gloo
   ranks (each makes its group; the CLI's ``main`` on ``cuda:0`` adopts
   it).  (i) 2 users, bf16: one client per rank, the final weights and
   acc/AUC bit-equal to 1 rank; (ii) 3 users, fp32: each batch split over
   the ranks, the weights within 1e-5.  Per rank: round seconds, bytes
   and host seconds of the state gather, launches.  Where 2 or more cards
   are visible, the same through torchrun with NCCL, one wait per round.
   Phase names given as arguments run only those phases after the kernel
   checks (a debugging aid: the kernels line counts only their launches,
   and no final ``ok`` line).

Every path zeroes the kernel launch counters just before it runs and reads
them just after; the counts must equal what the layer structure implies.
A local step replayed from a CUDA graph counts, for each replay, the
attention (and RoPE) kernels that a profiled replay of its graph runs on the device
(``kernel_launches``), the Python counters seeing no replay; the capture's
own eager runs, which train nothing, are taken off (a ``graph_replays``
line gives the parts).
Then the ``kernels`` line (both kernels at the vision training shape and at
``text_caltech``; ``launches`` from main_path, ``launches_<path>`` from each
other path; the RoPE kernels at EVA02's training shape with eva02_path's
launches; with each kernel's registers and spills
from ptxas, its shared memory and waves from the CUDA runtime, and its bound
share from the cold time), the total time, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``.  Any failure raises: the
exit code is then not 0 and the last line is not printed.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import gc
import io
import json
import math
import os
import pickle
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
from fairfedmed_tpu_torch.fed.parallel_driver import ROUND_CKPT_ENV, ParallelRoundRunner
from fairfedmed_tpu_torch.ops import _build
from fairfedmed_tpu_torch.ops import attention as A
from fairfedmed_tpu_torch.ops import rope as R
from fairfedmed_tpu_torch.ops.sinkhorn import entropic_cot, sinkhorn
from fairfedmed_tpu_torch.train.checkpoint import TREE_FILE, load_pytree
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
EVA02_SCRIPT = os.path.join(REPO, "scripts", "fairfedlora_fairfedmed_eva02.sh")
PROMPTFL_SCRIPT = os.path.join(REPO, "scripts", "fedchexmimic", "promptfl_fedchexmimic.sh")
FEDOTP_SCRIPT = os.path.join(REPO, "scripts", "fedchexmimic", "fedotp_fedchexmimic.sh")
LOCAL_SCRIPT = os.path.join(REPO, "scripts", "fedchexmimic", "fairfedlora_fedchexmimic_local.sh")
CHEX_SCRIPT = os.path.join(REPO, "scripts", "fedchexmimic", "fairfedlora_fedchexmimic.sh")
# phases 7-8 run the FedChexMimic launchers on the FairFedMed SLO fixture
# (phase 9 on their own dataset); that fixture has no ``age``
FAIRFEDMED_FLAGS = (("--dataset-config-file", "configs/datasets/fairfedmed.yaml"),
                    ("--attributes", *ATTRIBUTES), ("--attribute_type", "race"))
CLI_SITES, CLI_TRAIN, CLI_TEST = 3, 64, 100
# a FairFedMed OCT member: 128 B-scans of 200x200 uint8 (dataset.md:13-14);
# one full training batch of 32 volumes per site, 8 test volumes (the test
# batch of 100 cycles them)
OCT_SHAPE, OCT_TRAIN, OCT_TEST = (128, 200, 200), 32, 8
# FairFedMed-Chest: 2 sites (CheXpert 320x320, MIMIC 336x336 grayscale
# JPEGs, both resized to 224), copied from the committed JPEGs; attributes
# drawn inside GROUP_TABLES["FedChexMimic"]
JPEG_DIR = os.path.join(REPO, "tests", "data", "fedchexmimic_jpeg")
JPEG_TOL = 1  # grey levels: two JPEG decoders' IDCTs may round a pixel apart by one
CHEX_GROUPS = {"race": 3, "gender": 2, "age": 2}
CHEX_TRAIN, CHEX_TEST = 64, 100
# Caltech-101's 102 folders (101 categories and BACKGROUND_Google); the
# dataset ignores BACKGROUND_Google and Faces_easy and renames airplanes,
# Faces, Leopards and Motorbikes, leaving 100 classes.  Each folder holds
# CALTECH_PER_CLASS JPEGs of about Caltech-101's size (short edge 200-300,
# long edge 250-400), one in ten grayscale
CALTECH_FOLDERS = [
    "BACKGROUND_Google", "Faces", "Faces_easy", "Leopards", "Motorbikes", "accordion",
    "airplanes", "anchor", "ant", "barrel", "bass", "beaver", "binocular", "bonsai", "brain",
    "brontosaurus", "buddha", "butterfly", "camera", "cannon", "car_side", "ceiling_fan",
    "cellphone", "chair", "chandelier", "cougar_body", "cougar_face", "crab", "crayfish",
    "crocodile", "crocodile_head", "cup", "dalmatian", "dollar_bill", "dolphin", "dragonfly",
    "electric_guitar", "elephant", "emu", "euphonium", "ewer", "ferry", "flamingo",
    "flamingo_head", "garfield", "gerenuk", "gramophone", "grand_piano", "hawksbill",
    "headphone", "hedgehog", "helicopter", "ibis", "inline_skate", "joshua_tree", "kangaroo",
    "ketch", "lamp", "laptop", "llama", "lobster", "lotus", "mandolin", "mayfly", "menorah",
    "metronome", "minaret", "nautilus", "octopus", "okapi", "pagoda", "panda", "pigeon", "pizza",
    "platypus", "pyramid", "revolver", "rhino", "rooster", "saxophone", "schooner", "scissors",
    "scorpion", "sea_horse", "snoopy", "soccer_ball", "stapler", "starfish", "stegosaurus",
    "stop_sign", "strawberry", "sunflower", "tick", "trilobite", "umbrella", "watch",
    "water_lilly", "wheelchair", "wild_cat", "windsor_chair", "wrench", "yin_yang"]
CALTECH_IGNORED = ("BACKGROUND_Google", "Faces_easy")
CALTECH_RENAMED = {"airplanes": "airplane", "Faces": "face", "Leopards": "leopard",
                   "Motorbikes": "motorbike"}
CALTECH_CLASSES = sorted(CALTECH_RENAMED.get(f, f) for f in CALTECH_FOLDERS
                         if f not in CALTECH_IGNORED)
CALTECH_PER_CLASS = 8
CALTECH_N_CTX, CALTECH_PROMPTS = 16, 2  # the CLI's defaults --n_ctx and --num_prompt
# Office-Caltech-10: 4 sites, 10 classes (data/datasets/domain.py:Office)
OFFICE_SITES = ("amazon", "caltech", "dslr", "webcam")
OFFICE_CLASSES = ("back_pack", "bike", "calculator", "headphones", "keyboard",
                  "laptop_computer", "monitor", "mouse", "mug", "projector")
OFFICE_TRAIN, OFFICE_TEST, OFFICE_HW = 40, 20, 300
# CIFAR at its real width (32x32x3 uint8) and a tenth of its length
CIFAR_TRAIN, CIFAR_TEST = 5000, 1000
CIFAR10_CLASSES = ["airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse",
                   "ship", "truck"]
CIFAR100_CLASSES = [
    "apple", "aquarium_fish", "baby", "bear", "beaver", "bed", "bee", "beetle", "bicycle",
    "bottle", "bowl", "boy", "bridge", "bus", "butterfly", "camel", "can", "castle",
    "caterpillar", "cattle", "chair", "chimpanzee", "clock", "cloud", "cockroach", "couch",
    "crab", "crocodile", "cup", "dinosaur", "dolphin", "elephant", "flatfish", "forest", "fox",
    "girl", "hamster", "house", "kangaroo", "keyboard", "lamp", "lawn_mower", "leopard", "lion",
    "lizard", "lobster", "man", "maple_tree", "motorcycle", "mountain", "mouse", "mushroom",
    "oak_tree", "orange", "orchid", "otter", "palm_tree", "pear", "pickup_truck", "pine_tree",
    "plain", "plate", "poppy", "porcupine", "possum", "rabbit", "raccoon", "ray", "road",
    "rocket", "rose", "sea", "seal", "shark", "shrew", "skunk", "skyscraper", "snail", "snake",
    "spider", "squirrel", "streetcar", "sunflower", "sweet_pepper", "table", "tank",
    "telephone", "television", "tiger", "tractor", "train", "trout", "tulip", "turtle",
    "wardrobe", "whale", "willow_tree", "wolf", "woman", "worm"]


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


PROFILER_MISSES = []  # device_ms calls whose profiler passes recorded no device time


def device_ms(fns, warmup=3, attempts=3) -> float:
    """Mean device time of one call: the summed durations of the CUDA kernels
    that the calls launch (torch.profiler), cycling through ``fns`` at least
    once.  Unlike CUDA events around a run of calls, it leaves out the gaps
    when the device waits for the host to enqueue.  A profiling pass now and
    then records no kernel at all; after ``attempts`` such passes the time
    comes from CUDA events around each call instead, and the miss is listed
    in ``PROFILER_MISSES`` (printed with the kernel checks)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    iters = max(20, len(fns))
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]):  # a first pass may record nothing
            for i in range(warmup):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for i, (start, end) in enumerate(events):
        start.record()
        fns[i % len(fns)]()
        end.record()
    torch.cuda.synchronize()
    ms = sum(start.elapsed_time(end) for start, end in events) / iters
    PROFILER_MISSES.append({"fns": len(fns), "attempts": attempts, "events_ms": ms})
    return ms


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
    # EVA02-CLIP-L/14-336: 16 heads of 64 over 577 tokens (the long-L path),
    # the step's 32 images and the evaluation's batches of 100
    "eva02_train": (32 * 16, 577, 64, False),
    "eva02_eval": (100 * 16, 577, 64, False),
}
# the RoPE head split (ops/rope.py) at the same EVA02 steps: (B, L, heads, dh)
ROPE_SHAPES = {"rope_eva02_train": (32, 577, 16, 64), "rope_eva02_eval": (100, 577, 16, 64)}


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


def text_length(classnames, n_ctx=4) -> int:
    """The text tower's length for the prompts "X X X X <name>." of
    ``classnames``: cut after the last EOT, rounded up to a multiple of 8
    (models/clip_model.py:text_encode)."""
    from fairfedmed_tpu_torch.models import tokenizer as tk

    prefix = " ".join(["X"] * n_ctx)
    eot = tk.tokenize([f"{prefix} {name.replace('_', ' ')}." for name in classnames]).argmax(-1)
    return max(8, -(-(int(eot.max()) + 1) // 8) * 8)


def kernel_shapes() -> dict:
    """KERNEL_SHAPES and the widest text shapes: PromptFL on CIFAR-100 (one
    prompt bank x 100 classes x 8 heads) and the CLI's default run, GLP_OT
    on Caltech101 (2 prompts x 100 classes x 8 heads, 16 context tokens),
    each at its EOT-cut length."""
    return {**KERNEL_SHAPES,
            "text_cifar100": (len(CIFAR100_CLASSES) * 8, text_length(CIFAR100_CLASSES), 64, True),
            "text_caltech": (len(CALTECH_CLASSES) * CALTECH_PROMPTS * 8,
                             text_length(CALTECH_CLASSES, CALTECH_N_CTX), 64, True)}


WGMMA_TOL = 1e-4  # relative to the largest |C|: fp32 sums of exact bf16 products
# (modes 0-2, 4) or of ~16-bit high + low parts (mode 3); a wrong descriptor,
# swizzle or fragment layout is off by O(1)


def check_wgmma(dev):
    """Each wgmma mode of ``A.WGMMA_CHECK_MODES`` at head width 16, 32 and 64
    against ``torch.matmul`` on the card (TF32 off); raises on a miss."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for d in (16, 32, 64):
        for mode in sorted(A.WGMMA_CHECK_MODES):
            shape_a = {2: (64, 64), 3: (64, 32)}.get(mode, (64, d))
            a = torch.randn(*shape_a, device=dev, generator=gen)
            a = a if mode == 3 else a.to(torch.bfloat16)
            b = torch.randn(64, d, device=dev, generator=gen).to(torch.bfloat16)
            got = A.wgmma_check(a, b, mode)
            torch.cuda.synchronize()
            ref = torch.matmul(*{0: (a.float(), b.float().T), 1: (a.float(), b[32:].float().T),
                                 2: (a.float(), b.float()), 3: (a, b[32:].float()),
                                 4: (a.float(), b[16:32].float().T)}[mode])
            err = (got - ref).abs().max().item()
            tol = WGMMA_TOL * max(1.0, ref.abs().max().item())
            if not err <= tol:
                raise AssertionError(f"wgmma check d={d} mode {mode} "
                                     f"({A.WGMMA_CHECK_MODES[mode]}): max error {err} > {tol}")
            rows.append({"d": d, "mode": mode, "max_abs_err": err, "tol": tol})
    return rows


def check_kernels(dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape_name, (n, length, dh, causal) in kernel_shapes().items():
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
                for kind in ("fwd", "bwd"):  # the launch of the design the plan picks
                    row[f"launch_{kind}"] = dict(
                        A.launch_info(kind, n, length, dh),
                        kernel=A.launch_plan(kind, n, length, dh)["route"])
                row.update(time_attention(q, k, v, do, mask, o, lse))
                row.update(time_attention_cold(n, length, dh, dtype, mask, gen))
                bounds = _bounds_ms(n, length, dh, dtype, causal)
                row.update({"fwd_bound_ms": bounds["fwd"][0], "fwd_bound_by": bounds["fwd"][1],
                            "bwd_bound_ms": bounds["bwd"][0], "bwd_bound_by": bounds["bwd"][1]})
            rows.append(row)
        torch.cuda.empty_cache()  # the EVA02 shapes' references hold GBs
    return rows + check_rope(dev, gen)


def check_rope(dev, gen):
    """The RoPE head-split kernels at ``ROPE_SHAPES`` in bf16 (the main
    path's type), each direction against its plain version, then timed as
    the attention kernels are: device ms warm and L2-cold, CUDA events, host
    enqueue, the plain version's device ms, and the bound (bytes over the
    HBM rate: [B, L, 3D] read and three [B*H, L, dh] written, each way)."""
    from fairfedmed_tpu_torch.models import eva_clip

    dtype = torch.bfloat16
    cos, sin = eva_clip.rope_tables(eva_clip.EVAConfig(), dev)
    rows = []
    for shape_name, (b, length, heads, dh) in ROPE_SHAPES.items():
        d = heads * dh
        set_bytes = 2 * 3 * b * length * d * torch.tensor([], dtype=dtype).element_size()

        def make():
            qkv = torch.randn(b, length, 3 * d, device=dev, generator=gen).to(dtype)
            grads = [torch.randn(b * heads, length, dh, device=dev, generator=gen).to(dtype)
                     for _ in range(3)]
            return qkv, grads

        qkv, grads = make()
        got = R.rope_qkv_fwd(qkv, cos, sin, heads)
        dqkv = R.rope_qkv_bwd(*grads, cos, sin, heads)
        torch.cuda.synchronize()
        errs = {}
        for kind, pairs in (("fwd", zip(got, R.reference_rope_qkv(qkv, cos, sin, heads))),
                            ("bwd", [(dqkv, R.reference_rope_qkv_bwd(*grads, cos, sin, heads))])):
            # one bf16 rounding of either side's fp32 value, which differ by
            # FMA contraction alone (a few fp32 ulps of the largest input)
            errs[kind] = max(((g.float() - r.float()).abs() - 2 ** -7 * r.float().abs()).max()
                             .item() for g, r in pairs)
        tol = 1e-6 * max(t.float().abs().max().item() for t in [qkv, *grads])
        if not max(errs.values()) <= tol:
            raise AssertionError(f"{shape_name}: errors beyond 2^-7 of each value {errs} > {tol}")
        sets = [(qkv, grads)] + [make() for _ in range(max(1, math.ceil(4 * L2_BYTES / set_bytes)))]
        bound = set_bytes / HBM_BYTES_PER_S * 1e3
        row = {"shape": shape_name, "kernel": "rope_qkv", "B_L_H_dh": [b, length, heads, dh],
               "dtype": "bfloat16", "input_sets_cold": len(sets), "tol": tol}

        def fwd(s=sets[0]):
            return R.rope_qkv_fwd(s[0], cos, sin, heads)

        def bwd(s=sets[0]):
            return R.rope_qkv_bwd(*s[1], cos, sin, heads)

        for kind, fn, plain in (("fwd", fwd, lambda: R.reference_rope_qkv(qkv, cos, sin, heads)),
                                ("bwd", bwd,
                                 lambda: R.reference_rope_qkv_bwd(*grads, cos, sin, heads))):
            row.update({f"{kind}_err_beyond_rtol": errs[kind], f"{kind}_bound_ms": bound,
                        f"{kind}_bound_by": "bytes", f"kernel_{kind}_ms": device_ms([fn]),
                        f"kernel_{kind}_ms_cold": device_ms([lambda s=s: fn(s) for s in sets]),
                        f"kernel_{kind}_ms_events": cuda_ms(fn),
                        f"kernel_{kind}_host_ms": host_ms(fn),
                        f"plain_{kind}_ms": device_ms([plain])})
        rows.append(row)
        del sets, qkv, grads, got, dqkv
        torch.cuda.empty_cache()
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


def sass_counts() -> dict:
    """Per built library, the tensor-core instructions in its machine code
    (``cuobjdump -sass``): HGMMA (wgmma) and HMMA (mma.sync)."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = {}
    for name in _build.SOURCES:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        out[name] = {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HGMMA", "HMMA")}
    return out


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


GRAPH_CELLS = ("vit_slo_fairlora", "rn50_slo_fairlora")


# the kernels that begin each attention call on the device: the forward's
# one kernel, and the backward's first (its tensor-core kernels are one
# kernel a call, but two beyond 4 tiles: the keys' phase (MODE 1), counted,
# then the queries' (MODE 2); the plain path starts with its delta kernel)
ATTN_KERNELS = {"attention_fwd": re.compile(r"attention_fwd(_packed|_wgmma)?_kernel"),
                "attention_bwd": re.compile(r"attention_bwd_(wgmma_kernel<\d+, [013]>|packed_kernel"
                                            r"|delta_kernel)")}
# the RoPE head split's one kernel each way (EVA02's tower only)
ROPE_KERNELS = {"rope_qkv_fwd": re.compile(r"rope_qkv_fwd"),
                "rope_qkv_bwd": re.compile(r"rope_qkv_bwd")}
COUNTERS = {"attention_fwd": A.attention_fwd, "attention_bwd": A.attention_bwd,
            "rope_qkv_fwd": R.rope_qkv_fwd, "rope_qkv_bwd": R.rope_qkv_bwd}


@contextlib.contextmanager
def counting_captures():
    """While open, each CUDA-graph capture of the port's local step
    (``GraphedStep._capture``) records on its graph's entry the calls of
    each kernel of ``COUNTERS`` that its eager runs (the warm-ups and the
    captured run, which train nothing) made, as ``capture_calls``.
    ``GraphedStep._capture`` is restored on leaving."""
    from fairfedmed_tpu_torch.train import graphed

    capture = graphed.GraphedStep._capture

    def counted(self, *args):
        before = {k: f.launches for k, f in COUNTERS.items()}
        entry = capture(self, *args)
        entry.capture_calls = {k: COUNTERS[k].launches - n for k, n in before.items()}
        return entry

    graphed.GraphedStep._capture = counted
    try:
        yield
    finally:
        graphed.GraphedStep._capture = capture


def replay_calls(graph, kernels=ATTN_KERNELS, passes=3) -> list:
    """The calls of ``kernels`` one replay of ``graph`` makes, counted from
    the device traces of ``passes`` profiled replays, one dict a pass.  A
    profiled pass may miss kernels (a first pass may record none at all),
    never add one: the most a pass counts is the replay's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(passes):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        counts.append({k: sum(bool(p.search(n)) for n in names) for k, p in kernels.items()})
    return counts


def kernel_launches(runner=None, path=None, kernels=ATTN_KERNELS) -> dict:
    """The calls of ``kernels`` (by default the attention kernels) in a
    run.  The Python counters count the eager
    calls, a graph capture's among them (``counting_captures``); those
    are taken off, and each graph of ``runner``'s local steps adds its
    replays times the calls that one replay makes on the device
    (the most that a profiled pass of ``replay_calls`` counts, after the
    run: the state it changes is no longer read).  Each capture's eager runs must have made what one replay makes,
    run for run.  Where a step was graphed, prints a ``graph_replays`` line
    with each graph's replays, calls a replay and the capture's calls."""
    out = {k: COUNTERS[k].launches for k in kernels}
    graphs = []
    for step in (runner._steps.values() if runner is not None else ()):
        for g in getattr(step, "graphs", {}).values():
            passes = replay_calls(g.graph, kernels)
            per_replay = {k: max(c[k] for c in passes) for k in kernels}
            graphs.append({"replays": g.replays, "calls_a_replay": per_replay,
                           "profiled_passes": passes, "capture_runs": g.runs,
                           "capture_calls": g.capture_calls})
            for k, n in per_replay.items():
                if g.capture_calls[k] != g.runs * n:
                    raise AssertionError(f"{path}: a capture's {g.runs} eager runs called {k} "
                                         f"{g.capture_calls[k]} times; one replay calls it {n}")
                out[k] += g.replays * n - g.capture_calls[k]
    if graphs:
        emit({"phase": "graph_replays", "path": path, "graphs": graphs})
    return out


def _graph_ms(fn, dev, iters=20) -> float:
    """Device ms of one replay of ``fn`` captured alone in a CUDA graph
    (CUDA events around back-to-back replays)."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        fn()
    return cuda_ms(g.replay, iters=iters)


def graph_step(dev):
    """The client-parallel local step replayed from a CUDA graph
    (``train/graphed.py``) against the eager step, at the two published
    configurations of ``benchmark/configs/`` (full width and depth, bf16),
    each on a fixture of 128 training images a site: the check of
    ``tests/test_torch_port_graph_step.py`` (two clients alternating runs
    of steps from carried momentum and moved BatchNorm statistics, two
    later epochs' rates; every output bit for bit, the eager step against
    itself too; returned tensors unchanged by later replays), then the
    device ms of one step's graph replayed back to back and of the two
    optimizer updates captured alone, and the host ms a call of each kind."""
    import importlib.util

    from benchmark import spec

    # by its path: a ``tests`` package installed elsewhere would shadow the folder
    path = os.path.join(REPO, "tests", "test_torch_port_graph_step.py")
    spec_ = importlib.util.spec_from_file_location("test_torch_port_graph_step", path)
    check = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(check)
    A.attention_fwd.launches = A.attention_bwd.launches = 0
    total = {"attention_fwd": 0, "attention_bwd": 0}
    for name in GRAPH_CELLS:
        work = os.path.join(REPO, "build", "chip_smoke_graph_step", name)
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runner = check.build_cell_runner(spec.load_cell(name), dev, work, 2 ** 31 + 29,
                                         train_per_site=128, test_per_site=8)
        graphed = runner._steps[(None, None)]
        with counting_captures():
            res = check.graph_against_eager(runner, graphed)
        trainer = runner.trainer
        (entry,) = graphed.graphs.values()
        opt, n_opt = trainer.parallel_optimizer, trainer.opt_steps_per_batch
        params = {k: v.clone() for k, v in graphed._static["params"].items()
                  if not k.startswith("__bn_stats__")}
        state = {k: v.clone() for k, v in graphed._static["opt"].items()}
        grads = {k: torch.randn_like(v) for k, v in params.items()}

        def update():
            p, o = params, state
            for _ in range(n_opt):
                p, o = opt.update(p, grads, o, graphed._lr)

        res.update(phase="graph_step", cell=name, model=trainer.cfg.MODEL.BACKBONE.NAME,
                   step_graph_device_ms=cuda_ms(entry.graph.replay, iters=20),
                   update_graph_device_ms=_graph_ms(update, dev),
                   update_leaves=len(params), capture_eager_runs=entry.runs,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        launches = kernel_launches(runner, f"graph_step {name}")
        emit(res)
        check.assert_graph_equals_eager(res)
        if res["copies_in"] != 2 * check.COPIES_IN or res["graphs"] != 1:
            raise AssertionError(f"graph_step {name}: {res['copies_in']} copies in, "
                                 f"{res['graphs']} graphs")
        del runner, graphed, entry, params, state, grads
        for k in total:
            total[k] += launches[k]
        A.attention_fwd.launches = A.attention_bwd.launches = 0
        shutil.rmtree(work, ignore_errors=True)
    return total


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
        self.saves, self.loads = [], []  # round checkpoints written and restored
        CheckedRunner.last = self

    def save_round_state(self, directory, epoch, state=None, lr_steps=None):
        """A round checkpoint, timed (it ends in its own fetch and the file
        write), with its device waits recorded apart from the resolve
        half's one fetch."""
        t = time.perf_counter()
        with sync_watch() as syncs:
            path = super().save_round_state(directory, epoch, state=state, lr_steps=lr_steps)
        g, p, o = state if state is not None else (self.global_t, self.personal_t, self.stacked_o)
        self.saves.append({"round": epoch, "save_ms": (time.perf_counter() - t) * 1e3,
                           "syncs": syncs, "file_bytes": os.path.getsize(
                               os.path.join(path, TREE_FILE)),
                           "tensor_bytes": sum(v.numel() * v.element_size()
                                               for d in (g, p, o) for v in d.values())})
        return path

    def load_round_state(self, path):
        t = time.perf_counter()
        epoch = super().load_round_state(path)
        torch.cuda.synchronize()
        self.loads.append({"path": path, "load_ms": (time.perf_counter() - t) * 1e3,
                           "state": {k: {n: v.clone() for n, v in d.items()} for k, d in (
                               ("global_t", self.global_t), ("personal_t", self.personal_t),
                               ("stacked_o", self.stacked_o))}})
        return epoch

    def _timed(self, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self._data_s += time.perf_counter() - t

    def _round_batches_device(self, *args):
        return self._timed(super()._round_batches_device, *args)

    def _round_batches(self, *args):
        return self._timed(super()._round_batches, *args)

    def _ensure_eval_cache(self, idx):
        return self._timed(super()._ensure_eval_cache, idx)

    def _eval_dispatch(self, idxs_users, epoch=None):
        ctx = super()._eval_dispatch(idxs_users, epoch)
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
        t = time.perf_counter()
        with sync_watch() as syncs:  # after its round's resolve_round
            out = super().parallel_eval(idxs_users, current_epoch)
        self.resolved[-1]["syncs"] += syncs
        self.resolved[-1]["eval_s"] = time.perf_counter() - t
        return out


def run_cli(script, data_root, out_dir, rounds, dev, overrides=(), on_build=None,
            parallel=False, opts=(), host_eval=False, fallback=False):
    """``fairfedmed_tpu_torch.federated_main.main`` with the flags of a
    launcher script (the real config files, batch 32 / 100), except
    ``--root`` and ``--output-dir`` (under ``build/``), ``--round``, no
    ``--parallel_clients`` (with ``parallel`` the script's own switch kept),
    ``overrides`` (``(flag, value, ...)`` tuples) and config ``opts`` last.
    ``script`` None takes the CLI's own defaults (no flag but those).
    The kernel counters are zeroed just before and read just after; the
    expected counts come from the set sizes of the clients that the log (or
    with ``parallel`` the runner's rounds and evaluations) shows were
    trained and evaluated, and the runner's own step counts must equal
    them.  With ``host_eval`` a parallel run may evaluate a client on the
    sequential path, where the runner refused its device eval cache (the
    host transforms' datasets).  With ``fallback`` the argv keeps
    ``--parallel_clients`` for a trainer the runner does not take: the run
    must print the JAX CLI's notice and build no runner.
    ``on_build(trainer)`` runs once the CLI has built its trainer.  Returns
    what the path's checks read."""
    from fairfedmed_tpu_torch import federated_main as fm

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = script_flags(script, parallel=parallel) if script is not None else []
    for flag, value in (("--root", data_root), ("--output-dir", out_dir), ("--round", str(rounds))):
        argv = set_flag(argv, flag, value)
    for flag, *values in overrides:
        argv = set_flag(argv, flag, *values)
    for flag in ("--config-file", "--dataset-config-file"):  # config paths from the repo
        if flag in argv:
            i = argv.index(flag)
            argv[i + 1] = os.path.join(REPO, argv[i + 1])
    argv += list(opts)
    args = fm.build_arg_parser().parse_args(argv)
    if (parallel or fallback) != ("--parallel_clients" in argv):
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
    gc.collect()  # free the trainers of earlier runs, so the peak is this run's own
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()  # what earlier phases still hold
    for counter in COUNTERS.values():
        counter.launches = 0
    t0 = time.perf_counter()
    try:
        with open(console_path, "w") as console:
            sys.stdout = console  # the CLI's log tee writes here and to log.txt
            try:
                with counting_captures():
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
    trainer = holder["trainer"]
    eva = getattr(trainer, "backbone_type", None) == "eva"
    launches = kernel_launches(CheckedRunner.last, out_dir,
                               {**ATTN_KERNELS, **ROPE_KERNELS} if eva else ATTN_KERNELS)

    with open(os.path.join(out_dir, "log.txt")) as f:
        log = f.read()
    evaluated = [int(c) for c in re.findall(r"Evaluate on the client(\d+)_test set", log)]
    runner = CheckedRunner.last
    if fallback and (runner is not None or "parallel_clients not supported for this "
                     "model/trainer; using sequential rounds" not in log):
        raise AssertionError("--parallel_clients did not fall back to the sequential rounds "
                             "with the JAX CLI's notice")
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
        on_host = list(evaluated)  # the clients evaluated on the sequential path
        for c in (c for cs in runner.eval_calls for c in cs):
            if c in on_host:
                on_host.remove(c)
        if host_eval and any(runner._eval_cache.get(c) is not None for c in on_host):
            raise AssertionError(f"clients {on_host} with an eval cache were evaluated on "
                                 "the sequential path")
        if n_eval != runner.eval_batches or (on_host and not host_eval) or len(on_host) + sum(
                len(cs) for cs in runner.eval_calls) != len(evaluated):
            raise AssertionError(f"the runner evaluated {runner.eval_batches} batches for "
                                 f"{runner.eval_calls}, the data gives {n_eval}; the log "
                                 f"evaluated {evaluated}")
        n_eval += sum(len(trainer.fed_test_loader_x_dict[c]) for c in on_host)
        steps = [{"loss": float(r["metrics"][j, i, 0]), "valid": float(r["metrics"][j, i, 1])}
                 for r in runner.resolved for j, n in enumerate(r["n_steps"]) for i in range(n)]
    else:
        trained = {}  # round -> clients, from "Save checkpoint to .../epoch{r}_client{i}.npz"
        for r, c in re.findall(r"Save checkpoint to .*epoch(\d+)_client(\d+)\.npz", log):
            trained.setdefault(int(r), []).append(int(c))
        # each trained client runs OPTIM.MAX_EPOCH local epochs of its loader
        # (1 in the FairFedMed launchers' configs, 5 in rn50.yaml, 30 in
        # PromptFL/vit_b16.yaml)
        local_epochs = trainer.cfg.OPTIM.MAX_EPOCH
        n_train = local_epochs * sum(len(trainer.fed_train_loader_x_dict[c])
                                     for cs in trained.values() for c in cs)
        if sum(e["batches"] for e in epochs) != n_train:
            raise AssertionError(f"the epochs ran {[e['batches'] for e in epochs]} batches, "
                                 f"the data gives {n_train} over {local_epochs} epochs")
        n_eval = sum(len(trainer.fed_test_loader_x_dict[c]) for c in evaluated)
    # every batch runs each text block (and each ViT or EVA02 block) once.
    # The backward reaches every text block (the prompt context sits before
    # block 0) and the vision blocks from the first whose input carries a
    # gradient: block 1 when only adapters train, block 0 when the slice
    # projector (or a trainable ln_pre) sits before it, none when nothing in
    # the image tower trains (PromptFL, GLP_OT with a frozen image encoder).
    # An EVA02 block splits q/k/v into heads with one RoPE call each way.
    bundle = getattr(trainer, "bundle", None)  # None: the Baseline trainer's Dassl backbone
    clip = bundle.clip_cfg if bundle is not None else None
    t = clip.transformer_layers if bundle is not None else 0
    trainable = trainer.trainable
    if bundle is None:  # plain attention in the ViT, none elsewhere: no kernel launch
        v = v_bwd = 0
        width, layers = [trainer.fdim], [trainer.cfg.MODEL.BACKBONE.NAME or "cnn3"]
    elif trainer.backbone_type in ("vit", "eva"):
        v, vision_width = ((bundle.eva_cfg.vision_layers, bundle.eva_cfg.vision_width) if eva
                           else (clip.vision_layers, clip.vision_width))
        if getattr(trainer, "is_3d_input", False) or "visual_ln_pre" in trainable:
            v_bwd = v
        else:
            v_bwd = v - 1 if "image_encoder_lora" in trainable else 0
        width, layers = [vision_width, clip.transformer_width], [v, t]
    else:  # the ResNet tower runs no attention kernel
        rn = trainer.bundle.rn_cfg
        v = v_bwd = 0
        width, layers = [rn.width, rn.embed_dim, clip.transformer_width], [list(rn.layers), t]
    expected = {"attention_fwd": (n_train + n_eval) * (v + t),
                "attention_bwd": n_train * (v_bwd + t)}
    if eva:
        expected.update(rope_qkv_fwd=(n_train + n_eval) * v, rope_qkv_bwd=n_train * v_bwd)
    finals = {}
    for idx in range(args.num_users):
        with np.load(os.path.join(out_dir, f"global_client{idx}_final.npz")) as z:
            finals[idx] = {k: z[k] for k in z.files}
    cum = result["time"]

    def median(xs):
        xs = list(xs)
        return statistics.median(xs) if xs else None

    res = {"entry": "fairfedmed_tpu_torch.federated_main.main", "argv": argv,
           "model": trainer.cfg.MODEL.BACKBONE.NAME,
           "backbone_type": getattr(trainer, "backbone_type", "dassl"),
           "modality": trainer.cfg.DATASET.MODALITY_TYPE, "width": width, "layers": layers,
           "aggregation": args.model, "trainer": args.trainer,
           "prec": (trainer.cfg.TRAINER[getattr(trainer, "prec_node", "GLP_OT")].PREC
                    if bundle is not None else "fp32"),
           "device": str(trainer.device), "main_s": main_s,
           "round_s": [cum[0]] + [b - a for a, b in zip(cum, cum[1:])],
           "trained_clients": trained, "evaluated_clients": evaluated,
           "train_batches": n_train, "eval_batches": n_eval,
           "steps": steps, "step_ms_median": median(s["ms"] for s in steps if "ms" in s),
           "epochs": epochs,
           "data_ms_per_batch_median": median(e["data_ms_per_batch"] for e in epochs),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "start_mem_gib": start_mem / 2 ** 30,
           "rounds_wall_s": cum[-1] if cum else None,
           "acc": result["acc"], "auc": result["auc"],
           "final_npz_finite": {i: len(z) > 0 and all(np.isfinite(a).all() for a in z.values())
                                for i, z in finals.items()},
           "launches": launches, "expected_launches": expected}
    if parallel:
        res.update(
            rounds=[{**{k: v for k, v in d.items() if k != "syncs"}, "dispatch_syncs": d["syncs"],
                     "resolve_s": r["resolve_s"], "resolve_syncs": r["syncs"],
                     "eval_s": r.get("eval_s"),
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


def check_cli_run(res, rounds, trained_per_round=None, with_auc=True, fenced=False):
    """What every CLI path must show: how many clients each round trains
    (all of them in round 0; by default the FairLoRA launchers' 3 and then
    int(0.8 * 3)), finite losses and metrics (an AUC per round where the
    branch reports one), finite final weights, the expected launches.
    ``fenced``: rounds run under FAIRFEDMED_TIMING=1 (see
    :func:`check_parallel_rounds`)."""
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
        check_parallel_rounds(res, rounds, fenced)
    if len(res["acc"]) != rounds or len(res["auc"]) != (rounds if with_auc else 0) \
            or not np.isfinite(res["acc"] + res["auc"]).all():
        raise AssertionError(f"non-finite or missing metrics: {res['acc']} {res['auc']}")
    if not all(res["final_npz_finite"].values()):
        raise AssertionError(f"final weights missing or not finite: {res['final_npz_finite']}")
    if res["launches"] != res["expected_launches"]:
        raise AssertionError(f"kernel launches {res['launches']} != expected "
                             f"{res['expected_launches']}")


def check_parallel_rounds(res, rounds, fenced=False):
    """The client-parallel rounds: one blocking fetch per round (the one
    call of the resolve half and its evaluation that waits for the device),
    and no such call in the dispatch half of a round after the first (round
    0 fills the device caches), unless ``fenced``: the FAIRFEDMED_TIMING=1
    lines wait for the device in the dispatch half on purpose."""
    if res["fetches"] != rounds or len(res["rounds"]) != rounds:
        raise AssertionError(f"{res['fetches']} blocking fetches in {len(res['rounds'])} "
                             f"rounds, expected one in each of {rounds}")
    for r in res["rounds"]:
        if len(r["resolve_syncs"]) != 1:
            raise AssertionError(f"round {r['round']}'s resolve waited for the device "
                                 f"{len(r['resolve_syncs'])} times: {r['resolve_syncs'][:20]}")
        if not fenced and r["round"] >= 1 and r["deferred"] and r["dispatch_syncs"]:
            raise AssertionError(f"round {r['round']}'s dispatch waited for the device: "
                                 f"{r['dispatch_syncs'][:20]}")


SLO_ROOT = os.path.join(REPO, "build", "chip_smoke_data")
OCT_ROOT = os.path.join(REPO, "build", "chip_smoke_data_oct")
EVA02_ROOT = os.path.join(REPO, "build", "chip_smoke_data_336")


def _write_fixture_with(writer, root, **kw):
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    fixture = writer(root, **kw)
    fixture["write_s"] = time.perf_counter() - t0
    return fixture


def _write_fixture(root, **kw):
    return _write_fixture_with(write_fairfedmed_fixture, root, **kw)


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


def _check_ctx(finals, n_prompts, trainer, n_ctx=4):
    """Every client's final prompt context is [n_prompts, n_ctx (the
    launchers' --n_ctx 4), text width]."""
    shapes = {i: z["prompt_learner.ctx"].shape for i, z in finals.items()}
    if set(shapes.values()) != {(n_prompts, n_ctx, trainer.bundle.clip_cfg.transformer_width)}:
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
    PARALLEL_WALLS["parallel_cli_path"] = {"launches": res["launches"],
                                           "walls": _round_walls(res)}
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


def eva02_path(dev):
    """scripts/fairfedlora_fairfedmed_eva02.sh with its ``--parallel_clients``
    (EVA02-CLIP-L/14-336 at its published size, seeded weights) on an SLO
    fixture at 336 px, 2 rounds: the launches of attention and of the RoPE
    head split (counted from zero as every CLI path's), every local step a
    replay of the step's CUDA graph, and the adapters on w1/w2/w3 in the
    final weights."""
    fixture = _write_fixture(EVA02_ROOT, size=336)
    res, runner, finals, trainer = _parallel_run("eva02_path", EVA02_SCRIPT, EVA02_ROOT, 2, dev)
    graphs = [g for step in runner._steps.values() for g in getattr(step, "graphs", {}).values()]
    steps = sum(sum(r["n_steps"]) for r in res["rounds"])
    res.update(fixture=fixture, step_calls=steps, graph_replays=sum(g.replays for g in graphs))
    emit(res)
    check_cli_run(res, 2)
    if trainer.backbone_type != "eva" or res["model"] != "EVA02-CLIP-L-14-336":
        raise AssertionError(f"the EVA02 launcher ran {res['model']} ({trainer.backbone_type})")
    if not graphs or res["graph_replays"] != steps:
        raise AssertionError(f"{res['graph_replays']} graph replays for {steps} local steps")
    keys = [k for k in finals[0] if ".mlp.w" in k and ".lora_" in k]
    if len(keys) != 3 * 3 * trainer.bundle.eva_cfg.vision_layers:
        raise AssertionError(f"adapter keys in the final weights: {sorted(keys)[:9]} ...")
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
        res, runner, finals, trainer = _parallel_run(phase, script, SLO_ROOT, rounds, dev,
                                                     overrides)
        res["changed_flags"] = [list(f) for f in overrides]
        emit(res)
        check_cli_run(res, rounds, (2,) * rounds, with_auc=with_auc)
        if phase == "parallel_fedotp" and not all(s["valid"] == 1 for s in res["steps"]):
            raise AssertionError(f"an invalid OT plan: {res['steps']}")
        _check_ctx(finals, 1 if script == PROMPTFL_SCRIPT else 2, trainer)
        for k in total:
            total[k] += res["launches"][k]
        del res, runner, finals, trainer  # the next run's peak memory is its own
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


# --------------------------------------------------------------------------- #
# phase 9: FairFedMed-Chest and CIFAR
# --------------------------------------------------------------------------- #

CHEX_ROOT = os.path.join(REPO, "build", "chip_smoke_data_chex")
CIFAR_ROOT = os.path.join(REPO, "build", "chip_smoke_data_cifar")


def write_chexmimic_fixture(root, n_train=CHEX_TRAIN, n_test=CHEX_TEST, seed=5):
    """The FedChexMimic layout (data/datasets/fedchexmimic.py): CheXpert
    (site 1) under ``root/fedchexmimic``, MIMIC (site 2) under its
    ``files_336p``, each file a copy of a committed JPEG of the site's size
    under its own name, and ``meta_{chexpert,mimic}_{attr}_{split}.csv`` for
    each attribute with ``filename``, ``disease_label`` and every
    ``{attr}_label``.  Labels and attributes are laid out so every group
    holds both classes, then shuffled."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "fedchexmimic")
    sources = {"chexpert": sorted(f for f in os.listdir(JPEG_DIR) if f.startswith("chexpert")),
               "mimic": sorted(f for f in os.listdir(JPEG_DIR) if f.startswith("mimic"))}
    counter, nbytes = 0, 0
    for site, img_dir in (("chexpert", base), ("mimic", os.path.join(base, "files_336p"))):
        os.makedirs(img_dir, exist_ok=True)
        for split, n in (("train", n_train), ("test", n_test)):
            i, order = np.arange(n), rng.permutation(n)
            cols = {"disease_label": (i % 2)[order]}
            cols.update({f"{a}_label": ((i // 2) % g)[order] for a, g in CHEX_GROUPS.items()})
            fnames = []
            for j in range(n):
                fname = f"{site}_{counter:05d}.jpg"
                shutil.copyfile(os.path.join(JPEG_DIR, sources[site][j % len(sources[site])]),
                                os.path.join(img_dir, fname))
                nbytes += os.path.getsize(os.path.join(img_dir, fname))
                fnames.append(fname)
                counter += 1
            for attr in CHEX_GROUPS:
                with open(os.path.join(base, f"meta_{site}_{attr}_{split}.csv"), "w",
                          newline="") as f:
                    w = csv.writer(f)
                    w.writerow(["filename", *cols])
                    w.writerows([fn, *(int(c[j]) for c in cols.values())]
                                for j, fn in enumerate(fnames))
    return {"files": counter, "bytes": nbytes}


def jpeg_check():
    """The JPEG decoder the port picks here, held against the committed
    pixels (``decoded.npz``, libjpeg's) within JPEG_TOL grey levels, and the
    synchronous decode and resize to 224 of one X-ray through the dataset
    (the path of every item the native pool has not prefetched).  Raises
    when there is no decoder."""
    from fairfedmed_tpu_torch import native
    from fairfedmed_tpu_torch.data.datasets.fedchexmimic import (FedChexMimicDataset,
                                                                 decode_gray_pil)

    decoder = native.decoder("jpeg")
    if decoder == "none":
        raise RuntimeError("no JPEG decoder: the native JPEG build did not load "
                           f"({native.build_log()[-400:]}) and PIL does not import")
    want = np.load(os.path.join(JPEG_DIR, "decoded.npz"))
    err = 0.0
    for name in want.files:
        path, ref = os.path.join(JPEG_DIR, name), want[name].astype(np.float32)
        got = (native.decode_jpeg_gray(path, ref.shape[0]) if decoder == "libjpeg"
               else decode_gray_pil(path))
        err = max(err, float(np.abs(got - ref).max()))
    ds = FedChexMimicDataset(os.path.join(CHEX_ROOT, "fedchexmimic"), 2, "race",
                             list(CHEX_GROUPS), resolution=224, train=False)
    n = 32
    t = time.perf_counter()
    imgs = [ds.load_item(i)[0] for i in range(n)]
    ms = (time.perf_counter() - t) * 1e3 / n
    res = {"phase": "jpeg_check", "decoder": decoder, "files": len(want.files),
           "max_abs_err_grey_levels": err, "tol_grey_levels": JPEG_TOL,
           "decode_resize_ms_per_image": ms, "source_hw": [336, 336],
           "item_shape": list(imgs[0].shape), "build_log_tail": native.build_log()[-300:]}
    emit(res)
    if not err <= JPEG_TOL or imgs[0].shape != (3, 224, 224):
        raise AssertionError(f"the JPEG decoder disagrees with decoded.npz: {res}")
    return res


def _summary(phase, res, jpeg=None):
    """The numbers a run is read by, on one line."""
    out = {"phase": f"{phase}_summary", "round_s": res["round_s"],
           "rounds_wall_s": res["rounds_wall_s"],
           "data_ms_per_batch_median": res["data_ms_per_batch_median"],
           "step_ms_median": res["step_ms_median"], "peak_mem_gib": res["peak_mem_gib"],
           "start_mem_gib": res["start_mem_gib"],
           "launches": res["launches"], "train_batches": res["train_batches"],
           "eval_batches": res["eval_batches"]}
    if "rounds" in res:
        out.update(cache_bytes=res["cache_bytes"], cache_dtypes=res["cache_dtypes"],
                   host_data_s_per_round=[r["host_data_s"] for r in res["rounds"]],
                   dispatch_s_per_round=[r["dispatch_s"] for r in res["rounds"]])
    if jpeg is not None:  # parallel runs: round 0's host data time per cached X-ray
        out.update(jpeg_decoder=jpeg["decoder"],
                   jpeg_decode_resize_ms_per_image=jpeg["decode_resize_ms_per_image"])
    emit(out)


def _check_lora_groups(finals, groups):
    """Every client's final FairLoRA singular values have one row per group."""
    shapes = {i: z["image_encoder.transformer.resblocks.0.mlp.c_fc.lora_S.weight"].shape
              for i, z in finals.items()}
    if {s[0] for s in shapes.values()} != {groups}:
        raise AssertionError(f"lora_S shapes {shapes}, expected {groups} groups")


def chexmimic_path(dev):
    """scripts/fedchexmimic/fairfedlora_fedchexmimic.sh without its
    ``--parallel_clients`` (FedOTPLoRA, FairLoRA rank 12 / alpha 2, race /
    gender / age, frac 0.8 of 2 users), ViT-B/16, 2 rounds, on 2 sites x 64
    train / 100 test grayscale JPEGs (320x320 and 336x336, resized to 224):
    round 0 trains both sites, round 1 the one ``np.random.choice`` draws."""
    fixture = _write_fixture_with(write_chexmimic_fixture, CHEX_ROOT)
    jpeg = jpeg_check()
    res, finals, _ = run_cli(CHEX_SCRIPT, CHEX_ROOT, os.path.join(REPO, "build",
                                                                  "chip_smoke_chexmimic"), 2, dev)
    res = {"phase": "chexmimic_path", **res, "fixture": fixture, "jpeg_decoder": jpeg["decoder"]}
    emit(res)
    check_cli_run(res, 2, (2, 1))
    _check_lora_groups(finals, CHEX_GROUPS["race"])
    _summary("chexmimic_path", res, jpeg)
    return res["launches"]


def parallel_chexmimic(dev):
    """The FedChexMimic launchers with their own ``--parallel_clients`` on
    chexmimic_path's fixture: fairfedlora_fedchexmimic.sh 2 rounds (the
    resized X-rays cached on the device as fp32), then
    fairfedlora_fedchexmimic_local.sh, promptfl_fedchexmimic.sh and
    fedotp_fedchexmimic.sh (every plan valid), 1 round each.  Launches are
    counted per run and summed."""
    from fairfedmed_tpu_torch import native

    decoder = native.decoder("jpeg")
    runs = (("parallel_chexmimic_fairlora", CHEX_SCRIPT, 2, (2, 1), True),
            ("parallel_chexmimic_local", LOCAL_SCRIPT, 1, (2,), False),
            ("parallel_chexmimic_promptfl", PROMPTFL_SCRIPT, 1, (2,), False),
            ("parallel_chexmimic_fedotp", FEDOTP_SCRIPT, 1, (2,), True))
    total = {"attention_fwd": 0, "attention_bwd": 0}
    for phase, script, rounds, trained, with_auc in runs:
        res, runner, finals, trainer = _parallel_run(phase, script, CHEX_ROOT, rounds, dev)
        # round 0 decodes both sites' train and test X-rays into the caches
        jpeg = {"decoder": decoder, "decode_resize_ms_per_image":
                res["rounds"][0]["host_data_s"] * 1e3 / (2 * (CHEX_TRAIN + CHEX_TEST))}
        res["jpeg_decoder"] = decoder
        emit(res)
        check_cli_run(res, rounds, trained, with_auc=with_auc)
        if res["cache_dtypes"] != ["float32"] or res["cached_clients"]["train"] != [0, 1]:
            raise AssertionError(f"X-ray caches: {res['cache_dtypes']} {res['cached_clients']}")
        if script in (CHEX_SCRIPT, LOCAL_SCRIPT):
            _check_lora_groups(finals, CHEX_GROUPS["race"])
        else:
            _check_ctx(finals, 1 if script == PROMPTFL_SCRIPT else 2, trainer)
        if script == FEDOTP_SCRIPT and not all(st["valid"] == 1 for st in res["steps"]):
            raise AssertionError(f"an invalid OT plan: {res['steps']}")
        _summary(phase, res, jpeg)
        for k in total:
            total[k] += res["launches"][k]
        del res, runner, finals, trainer  # the next run's peak memory is its own
    emit({"phase": "parallel_chexmimic", "launches": total})
    return total


def write_cifar_fixture(root, which, n_train=CIFAR_TRAIN, n_test=CIFAR_TEST, seed=9):
    """CIFAR-10 (``cifar-10/cifar-10-batches-py``: 5 data batches, the test
    batch, ``batches.meta``) or CIFAR-100 (``cifar-100/cifar-100-python``:
    train, test, meta) pickles as torchvision's archives hold them, written
    with numpy: uint8 rows of 3072 (CHW) pixels, uniform labels."""
    rng = np.random.default_rng(seed)
    classes = CIFAR10_CLASSES if which == "cifar10" else CIFAR100_CLASSES

    def batch(n, key):
        return {"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                key: rng.integers(0, len(classes), n).tolist()}

    def dump(path, obj):
        with open(path, "wb") as f:
            pickle.dump(obj, f)

    if which == "cifar10":
        d = os.path.join(root, "cifar-10", "cifar-10-batches-py")
        os.makedirs(d, exist_ok=True)
        for i in range(1, 6):
            dump(os.path.join(d, f"data_batch_{i}"), batch(n_train // 5, "labels"))
        dump(os.path.join(d, "test_batch"), batch(n_test, "labels"))
        dump(os.path.join(d, "batches.meta"), {"label_names": classes})
    else:
        d = os.path.join(root, "cifar-100", "cifar-100-python")
        os.makedirs(d, exist_ok=True)
        dump(os.path.join(d, "train"), batch(n_train, "fine_labels"))
        dump(os.path.join(d, "test"), batch(n_test, "fine_labels"))
        dump(os.path.join(d, "meta"), {"fine_label_names": classes})
    return {"dataset": which, "train": n_train, "test": n_test, "hwc": [32, 32, 3]}


def cifar_path(dev):
    """CIFAR through the CLI, ViT-B/16 bf16, the CLI's default 10 users and
    beta 0.1, configs/trainers/GLP_OT/vit_b16.yaml (the Classification
    evaluator), on 5000 train / 1000 test 32x32x3 uint8 images resized to
    224 on the card inside the step: the PromptFL launcher's flags
    (fedavg, PromptFL) and the FedOTP launcher's (FedOTP, GLP_OT, 2 prompts,
    COT; every plan valid) on CIFAR-10 under noniid-labeldir, 1 round each
    with ``--parallel_clients`` (the uint8 images cached as they are); then
    PromptFL on CIFAR-100 under the CLI's default noniid-labeldir100
    (coarse -> fine Dirichlet, its per-sample loop on the host), 1 round,
    sequential."""
    shutil.rmtree(CIFAR_ROOT, ignore_errors=True)
    fixtures = [write_cifar_fixture(CIFAR_ROOT, w) for w in ("cifar10", "cifar100")]
    common = (("--num_users", "10"), ("--beta", "0.1"),
              ("--config-file", "configs/trainers/GLP_OT/vit_b16.yaml"))
    runs = (("cifar10_promptfl", PROMPTFL_SCRIPT, "cifar10", "noniid-labeldir", True, 1),
            ("cifar10_fedotp", FEDOTP_SCRIPT, "cifar10", "noniid-labeldir", True, 2),
            ("cifar100_promptfl", PROMPTFL_SCRIPT, "cifar100", "noniid-labeldir100", False, 1))
    total = {"attention_fwd": 0, "attention_bwd": 0}
    for phase, script, which, partition, parallel, n_prompts in runs:
        overrides = common + (("--dataset-config-file", f"configs/datasets/{which}.yaml"),
                              ("--partition", partition))
        out_dir = os.path.join(REPO, "build", f"chip_smoke_{phase}")
        t = time.perf_counter()
        res, finals, trainer = run_cli(script, CIFAR_ROOT, out_dir, 1, dev, overrides,
                                       parallel=parallel)
        res = {"phase": phase, "changed_flags": [list(f) for f in overrides], **res,
               "fixture": fixtures[0 if which == "cifar10" else 1],
               "partition_and_rounds_s": time.perf_counter() - t}
        res.pop("runner", None)
        emit(res)
        check_cli_run(res, 1, (10,), with_auc=False)
        _check_ctx(finals, n_prompts, trainer)
        if trainer.n_cls != (10 if which == "cifar10" else 100) or trainer._cifar is None:
            raise AssertionError(f"{phase}: {trainer.n_cls} classes, CIFAR preprocess "
                                 f"{trainer._cifar}")
        if parallel and res["cache_dtypes"] != ["uint8"]:
            raise AssertionError(f"CIFAR caches: {res['cache_dtypes']}")
        if script == FEDOTP_SCRIPT and not all(st["valid"] == 1 for st in res["steps"]):
            raise AssertionError(f"an invalid OT plan: {res['steps']}")
        _summary(phase, res)
        for k in total:
            total[k] += res["launches"][k]
        del res, finals, trainer  # the next run's peak memory is its own
    emit({"phase": "cifar_path", "launches": total})
    return total


CALTECH_ROOT = os.path.join(REPO, "build", "chip_smoke_data_caltech")
OFFICE_ROOT = os.path.join(REPO, "build", "chip_smoke_data_office")


def _smooth_image(rng, h, w, gray=False):
    """A uint8 photo-like image: coarse random colours upsampled by PIL,
    with fine noise, so a JPEG of it is about a photo's size."""
    from PIL import Image

    coarse = rng.integers(0, 256, (max(2, h // 24), max(2, w // 24), 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC), np.int16)
    img = np.clip(img + rng.integers(-12, 13, img.shape), 0, 255).astype(np.uint8)
    out = Image.fromarray(img)
    return out.convert("L") if gray else out


def write_caltech_fixture(root, seed=11):
    """Caltech-101's layout (``caltech-101/101_ObjectCategories/<folder>/``),
    written with PIL: CALTECH_PER_CLASS JPEGs (quality 90) in each of its 102
    folders, the short edge 200-300 and the long edge 250-400 px, one in ten
    grayscale (the dataset converts it to RGB)."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "caltech-101", "101_ObjectCategories")
    files, nbytes, n_gray = 0, 0, 0
    for folder in CALTECH_FOLDERS:
        os.makedirs(os.path.join(base, folder))
        for i in range(CALTECH_PER_CLASS):
            short, long_ = int(rng.integers(200, 301)), int(rng.integers(250, 401))
            long_ = max(long_, short)
            h, w = (short, long_) if rng.random() < 0.7 else (long_, short)
            gray = rng.random() < 0.1
            path = os.path.join(base, folder, f"image_{i + 1:04d}.jpg")
            _smooth_image(rng, h, w, gray).save(path, quality=90)
            files, nbytes, n_gray = files + 1, nbytes + os.path.getsize(path), n_gray + gray
    return {"folders": len(CALTECH_FOLDERS), "files": files, "bytes": nbytes, "gray": n_gray}


def write_office_fixture(root, seed=12):
    """Office-Caltech-10 in the layout of tests/fixtures.py:make_domain_fixture:
    ``office_caltech_10/{site}_{train,test}.pkl`` numpy pickles of (paths,
    text labels) and the JPEGs they name, OFFICE_TRAIN / OFFICE_TEST of
    OFFICE_HW x OFFICE_HW per site, the labels cycling through the 10
    classes."""
    rng = np.random.default_rng(seed)
    pdir = os.path.join(root, "office_caltech_10")
    os.makedirs(pdir)
    files, nbytes = 0, 0
    for site in OFFICE_SITES:
        for split, n in (("train", OFFICE_TRAIN), ("test", OFFICE_TEST)):
            paths, labels = [], []
            for i in range(n):
                rel = os.path.join("office_caltech_10", "imgs", site, f"{split}_{i}.jpg")
                full = os.path.join(root, rel)
                os.makedirs(os.path.dirname(full), exist_ok=True)
                _smooth_image(rng, OFFICE_HW, OFFICE_HW).save(full, quality=90)
                files, nbytes = files + 1, nbytes + os.path.getsize(full)
                paths.append(rel)
                labels.append(OFFICE_CLASSES[i % len(OFFICE_CLASSES)])
            with open(os.path.join(pdir, f"{site}_{split}.pkl"), "wb") as f:
                np.save(f, np.array([np.array(paths, dtype=object),
                                     np.array(labels, dtype=object)], dtype=object),
                        allow_pickle=True)
    return {"sites": len(OFFICE_SITES), "files": files, "bytes": nbytes}


def _text_length_of(trainer) -> int:
    """The text tower's length in the run: the prompts' last EOT, rounded up
    to a multiple of 8 (models/clip_model.py:text_encode)."""
    eot = int(np.asarray(trainer.prompt_state.eot_indices).max()) + 1
    return min(77, max(8, -(-eot // 8) * 8))


def _check_imagefolder_run(phase, res, trainer, n_cls, n_users):
    """A run on an image-folder dataset: the classes, the text length of the
    kernel check's shape, a valid OT plan on every step, the host transform
    built (and no device preprocessing), every client evaluated."""
    shape = kernel_shapes()["text_caltech"] if n_cls == len(CALTECH_CLASSES) else None
    if trainer.n_cls != n_cls or trainer._cifar is not None \
            or trainer.fed_train_loader_x_dict[0].transform is None:
        raise AssertionError(f"{phase}: {trainer.n_cls} classes, CIFAR preprocess "
                             f"{trainer._cifar}, transform "
                             f"{trainer.fed_train_loader_x_dict[0].transform}")
    if shape is not None and (res["text_length"] != shape[1] or res["text_rows"] != shape[0]):
        raise AssertionError(f"{phase}: text [{res['text_rows']}, {res['text_length']}] is not "
                             f"the kernel check's {shape[:2]}")
    if res["valid_plans"] != len(res["steps"]):
        raise AssertionError(f"{phase}: {res['valid_plans']} valid OT plans of "
                             f"{len(res['steps'])} steps")
    if sorted(set(res["evaluated_clients"])) != list(range(n_users)):
        raise AssertionError(f"{phase}: evaluated {res['evaluated_clients']}")


def _imagefolder_res(phase, res, trainer, fixture, n_prompts):
    heads = trainer.bundle.clip_cfg.transformer_heads
    res = {"phase": phase, **res, "fixture": fixture, "n_cls": trainer.n_cls,
           "text_length": _text_length_of(trainer),
           "text_rows": trainer.n_cls * n_prompts * heads,
           "valid_plans": sum(1 for st in res["steps"]
                              if np.isfinite(st["loss"]) and st.get("valid", 1) == 1)}
    res.pop("runner", None)
    return res


def _check_default_run(res, model):
    """The run is the CLI's default branch (FedOTP over GLP_OT) at ``model``."""
    if (res["model"], res["trainer"], res["aggregation"]) != (model, "GLP_OT", "FedOTP"):
        raise AssertionError(f"not the CLI's default run at {model}: {res['argv']}")


def caltech_path(dev):
    """The JAX CLI's default run, ``python -m fairfedmed_tpu_torch.federated_main
    --root <tree> --output-dir <dir> --round 2`` and no other flag:
    FedOTP over GLP_OT, RN50 from configs/trainers/GLP_OT/rn50.yaml at full
    width (bf16, 5 local epochs, batch 32 / 100, bicubic random resized crop,
    flip, normalize on the host), Caltech101, COT, 16 context tokens, 2
    prompts, 10 users of 2 shots, sequential; on a Caltech-101 tree of 102
    folders x 8 JPEGs written here.  Round 0 and round 1 train all 10
    clients (frac 1)."""
    fixture = _write_fixture_with(write_caltech_fixture, CALTECH_ROOT)
    out_dir = os.path.join(REPO, "build", "chip_smoke_caltech")
    with contextlib.chdir(REPO):  # the defaults name the config files from the repository root
        res, finals, trainer = run_cli(None, CALTECH_ROOT, out_dir, 2, dev)
    res = _imagefolder_res("caltech_path", res, trainer, fixture, CALTECH_PROMPTS)
    res["ot_iterations_last_step"] = int(trainer.ot_iterations)
    emit(res)
    check_cli_run(res, 2, (10, 10), with_auc=False)
    _check_imagefolder_run("caltech_path", res, trainer, len(CALTECH_CLASSES), 10)
    _check_default_run(res, "RN50")
    _check_ctx(finals, CALTECH_PROMPTS, trainer, CALTECH_N_CTX)
    _summary("caltech_path", res)
    return res["launches"]


def caltech_vit_parallel(dev):
    """The default run with ``--config-file configs/trainers/GLP_OT/vit_b16.yaml
    --parallel_clients --round 2`` on caltech_path's tree: ViT-B/16, so the
    vision kernel runs at [384, 197, 64] (a client's 20 images padded to the
    batch of 32).  The host transforms refuse every device cache, train and
    eval: each round assembles its batches on the host and evaluates on the
    sequential path, and its dispatch half waits for the device nowhere."""
    out_dir = os.path.join(REPO, "build", "chip_smoke_caltech_vit_parallel")
    with contextlib.chdir(REPO):
        res, finals, trainer = run_cli(
            None, CALTECH_ROOT, out_dir, 2, dev, parallel=True, host_eval=True,
            overrides=(("--config-file", "configs/trainers/GLP_OT/vit_b16.yaml"),
                       ("--parallel_clients",)))
    res = _imagefolder_res("caltech_vit_parallel", res, trainer, None, CALTECH_PROMPTS)
    emit(res)
    check_cli_run(res, 2, (10, 10), with_auc=False)
    _check_imagefolder_run("caltech_vit_parallel", res, trainer, len(CALTECH_CLASSES), 10)
    if res["cache_bytes"] != 0 or res["cached_clients"] != {"train": [], "eval": []}:
        raise AssertionError(f"a device cache was built on the host transforms' path: "
                             f"{res['cached_clients']} {res['cache_bytes']}")
    _check_default_run(res, "ViT-B/16")
    _check_ctx(finals, CALTECH_PROMPTS, trainer, CALTECH_N_CTX)
    _summary("caltech_vit_parallel", res)
    return res["launches"]


def office_path(dev):
    """``--model fedavg --trainer PromptFL --config-file
    configs/trainers/PromptFL/vit_b16.yaml --dataset-config-file
    configs/datasets/office.yaml --num_users 4 --round 1``, sequential, on an
    Office-Caltech-10 tree written here (4 sites, one client each, 40 train
    / 20 test JPEGs of 300x300 per site)."""
    fixture = _write_fixture_with(write_office_fixture, OFFICE_ROOT)
    out_dir = os.path.join(REPO, "build", "chip_smoke_office")
    overrides = (("--model", "fedavg"), ("--trainer", "PromptFL"),
                 ("--config-file", "configs/trainers/PromptFL/vit_b16.yaml"),
                 ("--dataset-config-file", "configs/datasets/office.yaml"),
                 ("--num_users", "4"))
    with contextlib.chdir(REPO):
        res, finals, trainer = run_cli(None, OFFICE_ROOT, out_dir, 1, dev, overrides)
    res = _imagefolder_res("office_path", res, trainer, fixture, 1)
    emit(res)
    check_cli_run(res, 1, (4,), with_auc=False)
    _check_imagefolder_run("office_path", res, trainer, len(OFFICE_CLASSES), 4)
    _check_ctx(finals, 1, trainer, 16)
    _summary("office_path", res)
    return res["launches"]


# --------------------------------------------------------------------------- #
# phase 11: round checkpoints, the Baseline trainer, the standalone CLI
# --------------------------------------------------------------------------- #

RESUME_CKPT = os.path.join(REPO, "build", "chip_smoke_round_ckpt")
CKPT_KEYS = ("global_t", "personal_t", "stacked_o")


def _same_state(tree, state) -> bool:
    """``tree`` (a round checkpoint, on the host) equals ``state`` (the
    runner's tensors) bit for bit: the same keys, dtypes and values."""
    for part in CKPT_KEYS:
        if set(tree[part]) != set(state[part]):
            return False
        for k, v in state[part].items():
            if tree[part][k].dtype != v.dtype or not torch.equal(tree[part][k], v.cpu()):
                return False
    return True


def _check_resumed_run(res, runner, epochs, clients_per_round):
    """A resumed client-parallel run: it ran ``epochs`` and no other, each
    training ``clients_per_round`` clients, finite metrics, one metrics
    fetch per round and one checkpoint fetch per due round (every round at
    CHECKPOINT_FREQ 1), no device wait in a dispatch half, the expected
    launches."""
    rounds = [r["round"] for r in runner.resolved]
    if rounds != list(epochs) or [len(r["clients"]) for r in runner.resolved] != \
            [clients_per_round] * len(epochs):
        raise AssertionError(f"the resumed run ran rounds {rounds} with clients "
                             f"{[r['clients'] for r in runner.resolved]}, expected {list(epochs)}")
    if len(res["acc"]) != len(epochs) or not np.isfinite(res["acc"] + res["auc"]).all() \
            or not all(np.isfinite(s["loss"]) for s in res["steps"]):
        raise AssertionError(f"non-finite or missing metrics: {res['acc']} {res['auc']}")
    if res["fetches"] != len(epochs) or any(len(r["resolve_syncs"]) != 1 for r in res["rounds"]) \
            or any(r["dispatch_syncs"] for r in res["rounds"][1:]):
        raise AssertionError(f"fetches {res['fetches']}, rounds {res['rounds']}")
    if res["launches"] != res["expected_launches"]:
        raise AssertionError(f"kernel launches {res['launches']} != expected "
                             f"{res['expected_launches']}")


def _check_saves(runner, epochs):
    """One checkpoint per round (CHECKPOINT_FREQ 1), each one fetch."""
    if [s["round"] for s in runner.saves] != list(epochs) or any(
            len(s["syncs"]) != 1 for s in runner.saves):
        raise AssertionError(f"round checkpoints {[(s['round'], s['syncs']) for s in runner.saves]}"
                             f", expected one fetch for each of rounds {list(epochs)}")


def resume_path(dev):
    """Round checkpoints and ``--resume`` on the client-parallel rounds, with
    the flags of scripts/fairfedlora_fairfedmed.sh and its
    ``--parallel_clients`` (ViT-B/16 FairLoRA rank 12 / alpha 2, 3 users,
    frac 0.8) on cli_path's SLO fixture, ``TRAIN.CHECKPOINT_FREQ 1``:

    1. ``FAIRFEDMED_ROUND_CKPT`` set, ``--round 2``: only ``step_1`` is
       left; it holds, bit for bit, the runner's own state after round 1 and
       its LR step counter (5 clients x 2 steps per local epoch);
    2. ``--resume`` alone, same directory, ``--round 4``: "continuing at
       epoch 2", the restored state equal to step_1 bit for bit, exactly
       rounds 2 and 3, only ``step_3`` left;
    3. ``--resume`` again with ``--attribute_type race`` (the launcher's is
       language): "ignoring round checkpoint", rounds 0 and 1.
    Each round makes its one metrics fetch and each checkpoint its own one;
    the save and load times and the bytes per checkpoint are printed."""
    shutil.rmtree(RESUME_CKPT, ignore_errors=True)
    opts = ("TRAIN.CHECKPOINT_FREQ", "1")
    total = {"attention_fwd": 0, "attention_bwd": 0}
    runs = []
    os.environ[ROUND_CKPT_ENV] = RESUME_CKPT
    try:
        first, runner, _, trainer = _parallel_run("resume_first", SCRIPT, SLO_ROOT, 2, dev,
                                                  opts=opts)
    finally:
        os.environ.pop(ROUND_CKPT_ENV, None)
    check_cli_run(first, 2)
    _check_saves(runner, (0, 1))
    left = sorted(os.listdir(RESUME_CKPT))
    tree = load_pytree(os.path.join(RESUME_CKPT, "step_1"))
    live = dict(zip(CKPT_KEYS, (runner.global_t, runner.personal_t, runner.stacked_o)))
    lr_steps = (int(tree["lr_steps"]), int(trainer._lr_steps))
    first.update(checkpoints_left=left, checkpoint_equals_state=_same_state(tree, live),
                 checkpoint_lr_steps=lr_steps, saves=[{k: v for k, v in sv.items()}
                                                     for sv in runner.saves])
    emit(first)
    if left != ["step_1"] or not first["checkpoint_equals_state"] or lr_steps != (10, 10) \
            or int(tree["epoch"]) != 1:
        raise AssertionError(f"round checkpoint: {left}, equal "
                             f"{first['checkpoint_equals_state']}, lr steps {lr_steps}")
    runs.append(("resume_first", first, runner))
    del live, trainer

    second, runner, _, _ = _parallel_run("resume_second", SCRIPT, SLO_ROOT, 4, dev,
                                         (("--resume", RESUME_CKPT),), opts)
    log = open(os.path.join(REPO, "build", "chip_smoke_resume_second", "log.txt")).read()
    restored = len(runner.loads) == 1 and _same_state(tree, runner.loads[0]["state"])
    second.update(checkpoints_left=sorted(os.listdir(RESUME_CKPT)), restored_bitwise=restored,
                  saves=runner.saves, loads=[{"load_ms": ld["load_ms"]} for ld in runner.loads])
    emit(second)
    _check_resumed_run(second, runner, (2, 3), int(0.8 * CLI_SITES))
    _check_saves(runner, (2, 3))
    if f"resumed round state from {RESUME_CKPT}/step_1 (continuing at epoch 2)" not in log \
            or not restored or second["checkpoints_left"] != ["step_3"]:
        raise AssertionError(f"resume: restored {restored}, left {second['checkpoints_left']}")
    runs.append(("resume_second", second, runner))

    third, runner, _, _ = _parallel_run("resume_foreign", SCRIPT, SLO_ROOT, 2, dev,
                                        (("--resume", RESUME_CKPT), ("--attribute_type", "race")),
                                        opts)
    log = open(os.path.join(REPO, "build", "chip_smoke_resume_foreign", "log.txt")).read()
    third.update(saves=runner.saves, loads=len(runner.loads))
    emit(third)
    check_cli_run(third, 2)
    _check_saves(runner, (0, 1))
    if f"ignoring round checkpoint {RESUME_CKPT}/step_3" not in log or runner.loads:
        raise AssertionError("a foreign run shape's checkpoint was not ignored")
    runs.append(("resume_foreign", third, runner))

    saves = [sv for _, _, r in runs for sv in r.saves]
    res = {"phase": "resume_path",
           "save_ms": [sv["save_ms"] for sv in saves],
           "load_ms": [ld["load_ms"] for _, _, r in runs for ld in r.loads],
           "checkpoint_file_bytes": sorted({sv["file_bytes"] for sv in saves}),
           "checkpoint_tensor_bytes": sorted({sv["tensor_bytes"] for sv in saves}),
           "fetches_per_round": {name: [1 + sum(sv["round"] == r["round"] for sv in rn.saves)
                                        for r in rn.resolved] for name, _, rn in runs},
           "round_s": {name: r["round_s"] for name, r, _ in runs},
           "peak_mem_gib": max(r["peak_mem_gib"] for _, r, _ in runs)}
    for _, r, _ in runs:
        for k in total:
            total[k] += r["launches"][k]
    res["launches"] = total
    emit(res)
    return total


BASELINE_TOL = {"logits": 1e-4, "loss": 1e-5, "state": 1e-6, "running_stats_rel": 1e-4}


def baseline_reference(dev):
    """The Baseline trainer built on the CPU and on the GPU from one seed
    (cnn3, and ResNet-18 with the mlp head), fp32: the logits, one training
    step's loss and the state after it agree (the running statistics to
    1e-4 of their largest value), on CIFAR-shaped uint8 NHWC batches of 8 at
    64x64."""
    rows = []
    for backbone, head in (("cnn3", ()), ("resnet18", (128,))):
        cfg = fairlora_cfg("ViT-B/16", 64, "fp32", trainer="Baseline")
        cfg.MODEL.BACKBONE.NAME = backbone
        cfg.MODEL.HEAD.NAME = "mlp" if head else ""
        cfg.MODEL.HEAD.HIDDEN_LAYERS = head
        rng = np.random.default_rng(3)
        batch = {"img": rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8),
                 "label": rng.integers(0, 10, 8).astype(np.int64)}
        dm = types.SimpleNamespace(fed_train_loader_x_dict={0: [batch]},
                                   fed_test_loader_x_dict={0: [dict(batch, n_valid=8)]},
                                   num_classes=10, lab2cname={i: str(i) for i in range(10)})
        trainers = {d: build_trainer(cfg, dm, device=d) for d in ("cpu", dev)}
        logits = {d: tr.model_inference(torch.as_tensor(batch["img"])).cpu()
                  for d, tr in trainers.items()}
        steps = {}
        for d, tr in trainers.items():
            tr.batch_idx, tr.num_batches = 0, 2
            steps[d] = (tr.forward_backward(batch), tr.state_dict())
        state_err, stats_ok = 0.0, True
        for k, want in steps["cpu"][1].items():
            err = float(np.abs(want - steps[dev][1][k]).max())
            if k.startswith("stats."):
                stats_ok &= err <= BASELINE_TOL["running_stats_rel"] * max(
                    1.0, float(np.abs(want).max()))
            else:
                state_err = max(state_err, err)
        row = {"backbone": backbone, "head": list(head), "prec": "fp32",
               "logits_max_abs_err": (logits["cpu"] - logits[dev]).abs().max().item(),
               "loss_abs_err": abs(steps["cpu"][0]["loss"] - steps[dev][0]["loss"]),
               "state_max_abs_err": state_err, "running_stats_within_tol": stats_ok}
        rows.append(row)
        if not (row["logits_max_abs_err"] <= BASELINE_TOL["logits"]
                and row["loss_abs_err"] <= BASELINE_TOL["loss"]
                and state_err <= BASELINE_TOL["state"] and stats_ok):
            raise AssertionError(f"the GPU Baseline trainer disagrees with the CPU one: {row}")
    return {"phase": "baseline_reference", "tol": BASELINE_TOL, "rows": rows}


def _check_baseline_finals(finals, backbone):
    """Every client's final state holds the classifier and, on a ResNet, its
    BatchNorm statistics (``stats.*``), finite and moved from their init."""
    for idx, z in finals.items():
        stats = [k for k in z if k.startswith("stats.")]
        moved = all(np.abs(z[k] - (1.0 if k.endswith(".var") else 0.0)).max() > 0 for k in stats)
        if "classifier.weight" not in z or (backbone.startswith("resnet") and not stats) \
                or not moved:
            raise AssertionError(f"client {idx}: Baseline state {sorted(z)[:5]}...")


def baseline_path(dev):
    """``--model fedavg --trainer Baseline`` through the CLI, 1 round each,
    sequential: ``--backbone resnet50`` and ``--backbone vit_base_patch16``
    with the flags of scripts/fairfedlora_fairfedmed.sh on cli_path's SLO
    fixture at 224 (the supervised baseline on the FairLoRA users' data;
    ``--frac 1.0``, so all 3 sites train); ``--backbone resnet18`` with the
    mlp head (``MODEL.HEAD.HIDDEN_LAYERS (128,)``) on cifar_path's CIFAR-10
    fixture with its 10 users, and cnn3 there with ``--parallel_clients``,
    which prints the JAX CLI's notice and runs sequentially.  fp32
    throughout; the Dassl ViT computes plain attention, so no kernel
    launches.  First the GPU trainer against the CPU trainer at a small
    size."""
    emit(baseline_reference(dev))
    slo = (("--model", "fedavg"), ("--trainer", "Baseline"), ("--frac", "1.0"))
    cifar = (("--num_users", "10"), ("--beta", "0.1"),
             ("--config-file", "configs/trainers/GLP_OT/vit_b16.yaml"),
             ("--dataset-config-file", "configs/datasets/cifar10.yaml"),
             ("--partition", "noniid-labeldir"), ("--trainer", "Baseline"))
    runs = (("baseline_resnet50", SCRIPT, SLO_ROOT, slo + (("--backbone", "resnet50"),), (),
             False, CLI_SITES),
            ("baseline_vit", SCRIPT, SLO_ROOT, slo + (("--backbone", "vit_base_patch16"),), (),
             False, CLI_SITES),
            ("baseline_resnet18_cifar", PROMPTFL_SCRIPT, CIFAR_ROOT,
             cifar + (("--backbone", "resnet18"),),
             ("MODEL.HEAD.NAME", "mlp", "MODEL.HEAD.HIDDEN_LAYERS", "(128,)"), False, 10),
            ("baseline_cnn3_parallel", PROMPTFL_SCRIPT, CIFAR_ROOT,
             cifar + (("--backbone", "cnn3"), ("--parallel_clients",)), (), True, 10))
    total = {"attention_fwd": 0, "attention_bwd": 0}
    for phase, script, root, overrides, opts, fallback, n_users in runs:
        res, finals, trainer = run_cli(script, root, os.path.join(REPO, "build",
                                                                  f"chip_smoke_{phase}"),
                                       1, dev, overrides, opts=opts, fallback=fallback)
        res = {"phase": phase, "changed_flags": [list(f) for f in overrides], **res}
        emit(res)
        check_cli_run(res, 1, (n_users,), with_auc=False)
        _check_baseline_finals(finals, trainer.cfg.MODEL.BACKBONE.NAME)
        if res["launches"] != {"attention_fwd": 0, "attention_bwd": 0} or res["prec"] != "fp32":
            raise AssertionError(f"{phase}: {res['launches']} {res['prec']}")
        _summary(phase, res)
        for k in total:
            total[k] += res["launches"][k]
        del res, finals, trainer
        # every client's full backbone per epoch (save_model): gigabytes on CIFAR
        shutil.rmtree(os.path.join(REPO, "build", f"chip_smoke_{phase}"), ignore_errors=True)
    emit({"phase": "baseline_path", "launches": total})
    return total


def _results_equal(a, b, tol=1e-6) -> bool:
    """Two evaluator result lists (scalars, arrays, per-group dicts) equal
    to ``tol``."""
    if isinstance(b, dict):
        return set(a) == set(b) and all(_results_equal(a[k], b[k], tol) for k in b)
    if isinstance(b, (list, tuple)) and any(isinstance(x, (dict, list, tuple, np.ndarray))
                                            for x in b):
        return len(a) == len(b) and all(_results_equal(x, y, tol) for x, y in zip(a, b))
    return bool(np.all(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) <= tol))


def run_train_cli(phase, argv, dev):
    """``fairfedmed_tpu_torch.tools.train.main`` (``python -m
    fairfedmed_tpu_torch.tools.train``) on ``argv``, the kernel counters
    zeroed just before and read just after; the expected launches from the
    training batches the trainer ran and the test batches of its one site."""
    from fairfedmed_tpu_torch.tools import train as st

    out_dir = argv[argv.index("--output-dir") + 1]
    shutil.rmtree(out_dir, ignore_errors=True)
    holder, steps = {}, []
    build = st.build_trainer

    def recording_build(cfg, dm=None, device=None):
        tr = build(cfg, dm, device=device)
        holder["trainer"] = tr
        fb = tr.forward_backward

        def timed(b):
            t = time.perf_counter()
            out = fb(b)
            steps.append({"loss": out["loss"], "ms": (time.perf_counter() - t) * 1e3,
                          "epoch": tr.epoch})
            return out

        tr.forward_backward = timed
        return tr

    st.build_trainer = recording_build
    A.attention_fwd.launches = 0
    A.attention_bwd.launches = 0
    saved = sys.stdout
    t0 = time.perf_counter()
    try:
        with open(out_dir + "_console.txt", "w") as console:
            sys.stdout = console
            try:
                out = st.main(st.build_arg_parser().parse_args(argv))
            finally:
                tee, sys.stdout = sys.stdout, saved
                if tee is not console:
                    tee.close()
    finally:
        st.build_trainer = build
    torch.cuda.synchronize()
    launches = {"attention_fwd": A.attention_fwd.launches,
                "attention_bwd": A.attention_bwd.launches}
    tr = holder["trainer"]
    clip = tr.bundle.clip_cfg
    v, t = clip.vision_layers, clip.transformer_layers
    n_eval = len(tr.fed_test_loader_x_dict[0]) if "test" in out else 0
    expected = {"attention_fwd": (len(steps) + n_eval) * (v + t),
                "attention_bwd": len(steps) * (v - 1 + t)}  # LoRA only: from block 1
    with open(os.path.join(out_dir, "log.txt")) as f:
        log = f.read()
    res = {"phase": phase, "entry": "fairfedmed_tpu_torch.tools.train.main", "argv": argv,
           "s": time.perf_counter() - t0, "train_batches": len(steps),
           "epochs_run": sorted({s["epoch"] for s in steps}), "eval_batches": n_eval,
           "step_ms_median": statistics.median(s["ms"] for s in steps) if steps else None,
           "test": out.get("test"), "launches": launches, "expected_launches": expected}
    if launches != expected or (steps and not all(np.isfinite(s["loss"]) for s in steps)):
        raise AssertionError(f"{phase}: launches {launches} != {expected} or a bad loss")
    return res, log, tr


def train_cli_path(dev):
    """``python -m fairfedmed_tpu_torch.tools.train``, in process, on one site
    of cli_path's SLO fixture with the GLP_OT_SVLoRA trainer at ViT-B/16
    (configs/trainers/GLP_OT/vit_b16_oph.yaml with the FairLoRA launcher's
    settings: 4 context tokens, 2 prompts, rank 12 / alpha 2, OT None,
    attribute language; batch 32 / 100, bf16, 2 local epochs):
    train -> ``save_checkpoint`` -> test; ``--eval-only --model-dir`` on
    that checkpoint gives the same test results; ``--resume`` restarts at the
    saved epoch: with ``OPTIM.MAX_EPOCH 2`` it trains nothing and tests the
    same, with 3 it trains the third epoch only."""
    base = os.path.join(REPO, "build", "chip_smoke_train_cli")
    ckpt = os.path.join(base + "_train", "checkpoints")
    flags = ["--root", SLO_ROOT, "--seed", "1", "--trainer", "GLP_OT_SVLoRA",
             "--dataset-config-file", os.path.join(REPO, "configs/datasets/fairfedmed.yaml"),
             "--config-file", os.path.join(REPO, "configs/trainers/GLP_OT/vit_b16_oph.yaml")]

    def opts(epochs):
        return ["TRAINER.GLP_OT.N_CTX", "4", "TRAINER.GLP_OT.N", "2", "TRAINER.GLP_OT.OT",
                "'None'", "TRAINER.GLP_OT_LORA.UNFREEZE_IMAGE_ENCODER", "True",
                "TRAINER.GLP_OT_LORA.RANK", "12", "TRAINER.GLP_OT_LORA.ALPHA", "2.0",
                "TRAINER.GLP_OT_LORA.TYPE", "FairLoRA", "DATASET.ATTRIBUTE_TYPE", "language",
                "OPTIM.LR", "0.001", "DATALOADER.TRAIN_X.BATCH_SIZE", "32",
                "DATALOADER.TEST.BATCH_SIZE", "100", "OPTIM.MAX_EPOCH", str(epochs)]

    runs = {}
    trained, _, tr = run_train_cli("train_cli_train", flags + ["--output-dir", base + "_train"]
                                   + opts(2), dev)
    n_batches = len(tr.fed_train_loader_x_dict[0])
    runs["train"] = trained
    ok = (trained["epochs_run"] == [0, 1] and trained["train_batches"] == 2 * n_batches
          and os.path.exists(os.path.join(ckpt, "model.pth.tar-1"))
          and open(os.path.join(ckpt, "checkpoint")).read() == "model.pth.tar-1")
    evald, _, _ = run_train_cli("train_cli_eval_only",
                                flags + ["--output-dir", base + "_eval", "--eval-only",
                                         "--model-dir", ckpt] + opts(2), dev)
    runs["eval_only"] = evald
    same, log, _ = run_train_cli("train_cli_resume_done",
                                 flags + ["--output-dir", base + "_resume2", "--resume", ckpt]
                                 + opts(2), dev)
    runs["resume_at_saved_epoch"] = same
    ok &= "Resumed from model.pth.tar-1 (epoch=2)" in log and same["train_batches"] == 0
    more, log, _ = run_train_cli("train_cli_resume_more",
                                 flags + ["--output-dir", base + "_resume3", "--resume", ckpt]
                                 + opts(3), dev)
    runs["resume_one_more_epoch"] = more
    ok &= (more["epochs_run"] == [2] and more["train_batches"] == n_batches
           and f"epoch [3/3][{n_batches}/{n_batches}]" in log and "epoch [1/3]" not in log)
    equal = {"eval_only": _results_equal(evald["test"], trained["test"]),
             "resume_at_saved_epoch": _results_equal(same["test"], trained["test"])}
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in runs["train"]["launches"]}
    res = {"phase": "train_cli_path", "runs": {k: {kk: vv for kk, vv in r.items() if kk != "test"}
                                               for k, r in runs.items()},
           "test_acc": {k: r["test"][0] for k, r in runs.items()},
           "test_equal_to_trained": equal, "launches": total}
    emit(res)
    if not ok or not all(equal.values()) or not np.isfinite(more["test"][0]):
        raise AssertionError(f"train_cli_path: ok {ok}, equal {equal}")
    return total


# --------------------------------------------------------------------------- #
# phase 12: the FAIRFEDMED_TIMING lines
# --------------------------------------------------------------------------- #

# the JAX runner's [timing] round lines, in its order (fairfedmed_tpu/fed/
# parallel_driver.py:460-600, :929-972)
TIMING_LABELS = ("batch assembly", "device_put", "train program", "aggregate+scatter",
                 "eval assemble+dispatch", "metrics fetch", "eval logits fetch",
                 "eval host metrics")
BUILD_STAMPS = ("clip_bundle:params_cast_done", "build:clip_bundle_done",
                "prompt_learner:tokenizer_ready", "prompt_learner:gather_dispatched",
                "prompt_learner:rows_fetched", "build:prompt_learner_done",
                "build:lora_init_done", "build:opt_init_done")
TIMING_SLACK = 1.05  # the labels of a round sum to at most its wall time plus 5%
PARALLEL_WALLS = {}  # parallel_cli_path's launches and round wall times, for timing_path


class _TeeText(io.StringIO):
    """A text stream kept in memory and written through to ``other``."""

    def __init__(self, other):
        super().__init__()
        self.other = other

    def write(self, s):
        self.other.write(s)
        return super().write(s)


def _round_walls(res) -> list:
    """Per round the host seconds of its dispatch, resolve and evaluation."""
    return [r["dispatch_s"] + r["resolve_s"] + (r["eval_s"] or 0.0) for r in res["rounds"]]


def _timed_run(phase, script, data_root, rounds, dev):
    """A launcher's parallel rounds under FAIRFEDMED_TIMING=1, with what
    they print: per round the seconds of each [timing] label (the k-th line
    of a label is round k's: deferral prints round k+1's dispatch lines
    before round k's fetch), its wall time, and the stamps."""
    err = _TeeText(sys.stderr)
    prev = os.environ.get("FAIRFEDMED_TIMING")
    os.environ["FAIRFEDMED_TIMING"] = "1"
    try:
        with contextlib.redirect_stderr(err):
            res, _, _, _ = _parallel_run(phase, script, data_root, rounds, dev)
    finally:
        if prev is None:
            os.environ.pop("FAIRFEDMED_TIMING")
        else:
            os.environ["FAIRFEDMED_TIMING"] = prev
    with open(os.path.join(REPO, "build", f"chip_smoke_{phase}_console.txt")) as f:
        lines = re.findall(r"^\[timing\] (.+): (\S+)s$", f.read(), re.M)
    stamps = re.findall(r"^\[timing\] (.+)$", err.getvalue(), re.M)
    labels = [re.sub(r" \+\S+s$", "", s) for s in stamps]
    at = {label: [i for i, (lb, _) in enumerate(lines) if lb == label] for label in TIMING_LABELS}
    counts = {label: len(at[label]) for label in TIMING_LABELS}
    if set(counts.values()) != {rounds} or len(lines) != rounds * len(TIMING_LABELS):
        raise AssertionError(f"{phase}: [timing] lines per label {counts}, expected {rounds} "
                             f"each: {lines}")
    walls, out = _round_walls(res), []
    for k in range(rounds):
        pos = [at[label][k] for label in TIMING_LABELS]
        secs = {label: float(lines[at[label][k]][1]) for label in TIMING_LABELS}
        if pos != sorted(pos):
            raise AssertionError(f"{phase}: round {k}'s labels out of the JAX order: {lines}")
        if not all(math.isfinite(s) and s >= 0 for s in secs.values()):
            raise AssertionError(f"{phase}: round {k}: {secs}")
        total = sum(secs.values())
        if total > walls[k] * TIMING_SLACK:
            raise AssertionError(f"{phase}: round {k}'s labels sum to {total} s, its wall time "
                                 f"is {walls[k]} s")
        out.append({"round": k, "seconds": secs, "labels_sum_s": total, "wall_s": walls[k],
                    **{f"{key}_s": res["rounds"][k][f"{key}_s"]
                       for key in ("dispatch", "resolve", "eval")}})
    want = {**{s: 1 for s in BUILD_STAMPS}, "eval:dispatch_start": rounds,
            **{f"round:start epoch={k}": 1 for k in range(rounds)}}
    got = {s: labels.count(s) for s in want}
    decoded = sorted(int(m) for s in labels
                     for m in re.findall(r"^device_cache:decode_start client=(\d+)$", s))
    if got != want or decoded != list(range(CLI_SITES)):
        raise AssertionError(f"{phase}: stamps {got} (expected {want}), decoded {decoded}: "
                             f"{stamps}")
    # the other checks of the launcher's parallel rounds; the fences of the
    # timing lines wait for the device inside the dispatch half, so only the
    # dispatch half's no-wait check is left out: the resolve half still waits
    # once, in its fetch
    check_cli_run(res, rounds, fenced=True)
    return {"run": phase, "argv": res["argv"], "rounds": out, "stamps": stamps,
            "launches": res["launches"], "peak_mem_gib": res["peak_mem_gib"],
            "main_s": res["main_s"]}


def timing_path(dev):
    """The FairLoRA launcher's parallel rounds under FAIRFEDMED_TIMING=1:
    cli_path's SLO fixture (ViT-B/16, bf16, 3 sites), 2 rounds, then
    oct_path's fixture, 1 round (round 0 decodes every volume).  Every round
    prints every JAX label in the JAX order, each build stamp appears once
    per trainer build, every time is finite and >= 0, a round's labels sum
    to at most its wall time plus 5%, and the SLO run launches the kernels
    as often as parallel_cli_path (timing adds fences, no launch)."""
    runs = [_timed_run("timing_slo", SCRIPT, SLO_ROOT, 2, dev),
            _timed_run("timing_oct", OCT_SCRIPT, OCT_ROOT, 1, dev)]
    ref = PARALLEL_WALLS.get("parallel_cli_path")
    if ref is not None:
        runs[0]["parallel_cli_path_wall_s"] = ref["walls"]
        if runs[0]["launches"] != ref["launches"]:
            raise AssertionError(f"timing_path launched {runs[0]['launches']}, "
                                 f"parallel_cli_path {ref['launches']}")
    total = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    emit({"phase": "timing_path", "runs": runs, "slack": TIMING_SLACK, "launches": total})
    return total


# --------------------------------------------------------------------------- #
# phase 13: the client-parallel rounds over several ranks
# --------------------------------------------------------------------------- #

DIST_DIR = os.path.join(REPO, "build", "chip_smoke_dist")
DIST_TIMEOUT_S = 240  # per launch; a rank that hangs fails the phase
DIST_TOL = 1e-5  # fp32 weights with a client's batch split over ranks (as parallel_equiv)


def _dist_argv(name, n_users, frac, opts=()):
    """The FairLoRA launcher's flags with its ``--parallel_clients`` on
    cli_path's fixture, 2 rounds, ``n_users`` users at ``frac``."""
    argv = script_flags(SCRIPT, parallel=True)
    for flag, value in (("--root", SLO_ROOT), ("--output-dir", os.path.join(DIST_DIR, name)),
                        ("--round", "2"), ("--num_users", str(n_users)), ("--frac", str(frac))):
        argv = set_flag(argv, flag, value)
    for flag in ("--config-file", "--dataset-config-file"):
        i = argv.index(flag)
        argv[i + 1] = os.path.join(REPO, argv[i + 1])
    return argv + list(opts)


class DistRunner(ParallelRoundRunner):
    """The runner with each rank's rounds recorded: host seconds of the
    dispatch and resolve halves, bytes and host seconds of the state gather,
    and (with ``watch``) every call that waited for the device."""

    watch = False
    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rounds, self.gathers = [], []
        DistRunner.last = self

    def _all_gather(self, t):
        out = super()._all_gather(t)
        self.gathered_bytes = out.numel() * out.element_size()
        return out

    def _gather_round(self, mesh, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = super()._gather_round(mesh, *args)
        torch.cuda.synchronize()
        self.gathers.append({"s": time.perf_counter() - t, "bytes": self.gathered_bytes,
                             "c": mesh.c, "d": mesh.d})
        return out

    def run_round(self, epoch, idxs_users, max_epoch, **kwargs):
        t = time.perf_counter()
        with (sync_watch() if self.watch else contextlib.nullcontext([])) as syncs:
            out = super().run_round(epoch, idxs_users, max_epoch, **kwargs)
        self.rounds.append({"round": epoch, "clients": len(idxs_users),
                            "dispatch_s": time.perf_counter() - t, "dispatch_syncs": syncs})
        return out

    def resolve_round(self, handle):
        t = time.perf_counter()
        with (sync_watch() if self.watch else contextlib.nullcontext([])) as syncs:
            ms = super().resolve_round(handle)
        r = next(r for r in self.rounds if r["round"] == handle["epoch"])
        r.update(resolve_s=time.perf_counter() - t, resolve_syncs=syncs)
        return ms


def _dist_rank(argv, report, device=None, watch=False):
    """The port's CLI on this rank (its group, if any, already made), with
    the kernel counters zeroed just before and read just after; writes what
    the phase reads to ``report``."""
    from fairfedmed_tpu_torch import federated_main as fm
    from fairfedmed_tpu_torch.fed import dist as fdist

    DistRunner.watch = watch
    fm.ParallelRoundRunner = DistRunner
    A.attention_fwd.launches = A.attention_bwd.launches = 0
    t0 = time.perf_counter()
    with counting_captures():
        result = fm.main(fm.build_arg_parser().parse_args(argv), device=device)
    torch.cuda.synchronize()
    runner = DistRunner.last
    with open(report, "w") as f:
        json.dump({"rank": fdist.get_rank(), "world": fdist.get_world_size(),
                   "backend": fdist.backend(), "main_s": time.perf_counter() - t0,
                   "rounds": runner.rounds, "gathers": runner.gathers, "fetches": runner.fetches,
                   "acc": result["acc"], "auc": result["auc"],
                   "launches": kernel_launches(runner, f"rank {fdist.get_rank()}")}, f)


def _dist_spawned(rank, world, port, argv, report, device):
    """A spawned rank: its own gloo group over ``tcp://localhost:port`` (the
    CLI adopts it), the CLI on ``cuda:0`` (every rank on the one card), its
    console to a file."""
    import datetime

    import torch.distributed as dist

    sys.stdout = open(report.replace(".json", f"_rank{rank}_console.txt"), "w")
    if world > 1:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        _dist_rank(argv, report.replace(".json", f"_rank{rank}.json"), device=device)
    finally:
        if world > 1:
            dist.destroy_process_group()
        sys.stdout.close()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _dist_run(runs, device="cuda:0"):
    """Each ``(name, world, argv)`` of ``runs`` as ``world`` spawned ranks on
    the one card (gloo), the runs at the same time; their reports."""
    import torch.multiprocessing as mp

    ctxs = [mp.start_processes(_dist_spawned, args=(world, _free_port(), argv,
                                                    os.path.join(DIST_DIR, f"{name}.json"),
                                                    device),
                               nprocs=world, join=False, start_method="spawn")
            for name, world, argv in runs]
    deadline = time.perf_counter() + DIST_TIMEOUT_S
    try:
        for (name, _, _), ctx in zip(runs, ctxs):
            while not ctx.join(timeout=5):
                if time.perf_counter() > deadline:
                    raise TimeoutError(f"{name}: the ranks did not finish in {DIST_TIMEOUT_S} s")
    finally:
        for proc in (p for ctx in ctxs for p in ctx.processes):
            if proc.is_alive():
                proc.kill()
    out = []
    for name, world, _ in runs:
        reports = []
        for rank in range(world):
            with open(os.path.join(DIST_DIR, f"{name}_rank{rank}.json")) as f:
                reports.append(json.load(f))
        out.append(reports)
    return out


def _nccl_run(name, world, argv):
    """``world`` ranks on ``world`` cards through torchrun (NCCL); their
    reports, each rank checking one wait per round in its resolve half and
    none in its dispatch half after round 0."""
    report = os.path.join(DIST_DIR, f"{name}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(world), os.path.abspath(__file__), "--dist-rank", report, *argv]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=DIST_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"{name}: torchrun exited {out.returncode}:\n{out.stderr[-4000:]}")
    reports = []
    for rank in range(world):
        with open(report.replace(".json", f"_rank{rank}.json")) as f:
            reports.append(json.load(f))
    for rep in reports:
        for r in rep["rounds"]:
            if len(r["resolve_syncs"]) != 1 or (r["round"] >= 1 and r["dispatch_syncs"]):
                raise AssertionError(f"{name} rank {rep['rank']} round {r['round']} waited for "
                                     f"the device: {r}")
    return reports


def _final_weights(name, n_users):
    out = {}
    for idx in range(n_users):
        with np.load(os.path.join(DIST_DIR, name, f"global_client{idx}_final.npz")) as z:
            out[idx] = {k: z[k] for k in z.files}
    return out


def _weights_err(a, b) -> float:
    return max(float(np.abs(a[i][k].astype(np.float64) - b[i][k]).max()) for i in b for k in b[i])


def _rank_lines(reports):
    return [{"rank": r["rank"], "world": r["world"], "backend": r["backend"],
             "main_s": r["main_s"], "fetches": r["fetches"],
             "round_s": [x["dispatch_s"] + x.get("resolve_s", 0.0) for x in r["rounds"]],
             "dispatch_s": [x["dispatch_s"] for x in r["rounds"]],
             "resolve_s": [x.get("resolve_s") for x in r["rounds"]],
             "gathered_bytes_per_round": [g["bytes"] for g in r["gathers"]],
             "gather_s": [g["s"] for g in r["gathers"]],
             "grid": [[g["c"], g["d"]] for g in r["gathers"]], "launches": r["launches"]}
            for r in reports]


def dist_path(dev):
    """The FairLoRA launcher's client-parallel rounds over 2 ranks on the one
    card (gloo; each rank a spawned process that makes its group, then the
    CLI's ``main`` on ``cuda:0`` adopts it), against 1 rank in the same
    phase, ViT-B/16 at full width, rank 12, alpha 2, batch 32, 2 rounds on
    cli_path's fixture:
    (i) 2 users at frac 1.0, bf16: ``m = 2`` over 2 ranks, ``c = 2, d = 1``,
        one client per rank; the final weights bit-equal to one rank's and
        acc/AUC equal (the launcher's 3 users at frac 0.8 train all 3 in
        round 0, a ``c = 1, d = 2`` round);
    (ii) 3 users at frac 1.0, fp32: ``m = 3``, ``c = 1, d = 2``, every
        client's batch split over the ranks; weights within 1e-5.
    Launches: in (i) the ranks' together equal one rank's (each training
    step runs once, rank 0 evaluates); in (ii) each rank runs every
    training step on half the batch.  The two one-rank references run at
    the same time (their times share the card), each 2-rank run alone.  Where 2 or more cards are visible,
    (i) on 2 and (ii) on min(4, count) ranks through torchrun with NCCL,
    each rank checking one device wait per round (in its resolve half)."""
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    total = {"attention_fwd": 0, "attention_bwd": 0}
    out = {"phase": "dist_path", "cases": {}}
    cases = (("i_d1_bf16", 2, ()), ("ii_d2_fp32", 3, ("TRAINER.GLP_OT.PREC", "fp32")))
    # the two one-rank references at once, then each 2-rank run alone
    ones = _dist_run([(f"{case}_one", 1, _dist_argv(f"{case}_one", n_users, 1.0, opts))
                      for case, n_users, opts in cases])
    for (case, n_users, opts), (one,) in zip(cases, ones):
        (two,) = _dist_run([(f"{case}_two", 2, _dist_argv(f"{case}_two", n_users, 1.0, opts))])
        w_one = _final_weights(f"{case}_one", n_users)
        w_two = _final_weights(f"{case}_two", n_users)
        err = _weights_err(w_two, w_one)
        equal = all(np.array_equal(w_two[i][k], w_one[i][k]) for i in w_one for k in w_one[i])
        metric_err = max(abs(a - b) for k in ("acc", "auc") for a, b in zip(two[0][k], one[k]))
        launches = {k: one["launches"][k] + sum(r["launches"][k] for r in two) for k in total}
        for k in total:
            total[k] += launches[k]
        out["cases"][case] = {
            "users": n_users, "grid": [[g["c"], g["d"]] for g in two[0]["gathers"]],
            "weights_bit_equal": equal, "weights_max_abs_err": err, "metric_max_abs_err": metric_err,
            "acc": {"one": one["acc"], "two": two[0]["acc"]},
            "auc": {"one": one["auc"], "two": two[0]["auc"]},
            "one_rank": _rank_lines([one])[0], "ranks": _rank_lines(two)}
        if len(two[0]["acc"]) != 2 or not all(np.isfinite(two[0]["acc"] + two[0]["auc"])):
            raise AssertionError(f"dist_path {case}: metrics {two[0]['acc']} {two[0]['auc']}")
        one_l, ranks_l = one["launches"], [r["launches"] for r in two]
        if case.startswith("i_"):
            if not equal or metric_err != 0:
                raise AssertionError(f"dist_path (i): 2 ranks != 1 rank: weights {err}, "
                                     f"metrics {metric_err}")
            if {k: sum(r[k] for r in ranks_l) for k in total} != one_l or min(
                    r["attention_bwd"] for r in ranks_l) == 0:
                raise AssertionError(f"dist_path (i) launches: ranks {ranks_l}, one {one_l}")
        else:
            if err > DIST_TOL or metric_err > 1e-6:
                raise AssertionError(f"dist_path (ii): weights {err}, metrics {metric_err}")
            if not (ranks_l[0] == one_l and ranks_l[1]["attention_bwd"] == one_l["attention_bwd"]
                    and 0 < ranks_l[1]["attention_fwd"] < one_l["attention_fwd"]):
                raise AssertionError(f"dist_path (ii) launches: ranks {ranks_l}, one {one_l}")
    count = torch.cuda.device_count()
    if count >= 2:
        for (case, n_users, opts), world in zip(cases, (2, min(4, count))):
            reps = _nccl_run(f"{case}_nccl", world, _dist_argv(f"{case}_nccl", n_users, 1.0, opts))
            err = _weights_err(_final_weights(f"{case}_nccl", n_users),
                               _final_weights(f"{case}_one", n_users))
            out["cases"][f"{case}_nccl"] = {"weights_max_abs_err": err, "ranks": _rank_lines(reps)}
            if err > (DIST_TOL if "fp32" in case else 0.0):
                raise AssertionError(f"dist_path {case} over NCCL: weights {err}")
            for k in total:
                total[k] += sum(r["launches"][k] for r in reps)
    else:
        out["nccl"] = f"the NCCL run needs two cards; {count} visible"
        print(f"dist_path: the NCCL run needs two cards; {count} visible")
    out["launches"] = total
    emit(out)
    return total


PATHS = ("main_path", "graph_step", "cli_path", "oct_path", "rn50_path", "rn50_oct_path", "ot_path",
         "promptfl_path", "fedotp_path", "clip_path", "fedprox_path", "parallel_cli_path",
         "parallel_oct_path", "parallel_rn50_path", "eva02_path", "parallel_branches",
         "parallel_equiv", "chexmimic_path", "parallel_chexmimic", "cifar_path", "caltech_path",
         "caltech_vit_parallel", "office_path", "resume_path", "baseline_path",
         "train_cli_path", "timing_path", "dist_path")


def kernels_line(rows, launches):
    """The two kernels in bf16 at the vision training shape, the shape and
    type the main path spends most of its attention time on, and at the
    CLI's default run's text shape (GLP_OT on Caltech101), with the
    tensor-core kernels' resources (``kernel``: the packed short-row kernel
    or the warpgroup one, as ``launch_plan`` picks): registers and spills
    from ptxas of the instance that runs, shared
    memory and resident blocks from the CUDA runtime, waves = blocks / (SMs x
    resident blocks per SM), and bound share = bound / cold time.
    ``launches`` is main_path's count, ``launches_<path>`` every other
    path's (counts are per kernel, the same on both shapes' rows; None for a
    phase that did not run).  Then the RoPE head split at EVA02's training
    shape, with eva02_path's launches, the one path that runs it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for shape in ("vision_train", "text_caltech"):
        row = next(r for r in rows if r["shape"] == shape and r["dtype"] == "bfloat16")
        n, length, dh = row["n_L_dh"]
        for kind, tpu_line in (("fwd", "fairfedmed_tpu/ops/attention.py:37 (_fwd_kernel, via "
                                        "_attend_impl :105)"),
                               ("bwd", "fairfedmed_tpu/ops/attention.py:54 (_bwd_kernel, via "
                                       "_attend_bwd_impl :118)")):
            name = f"attention_{kind}"
            log = _build.library_path(name).with_suffix(".log").read_text()
            info = A.launch_info(kind, n, length, dh)
            plan = A.launch_plan(kind, n, length, dh, sms)
            # the instance that runs: the packed kernel, or the warpgroup one
            # (forward: by the last key tile's 16-key steps; backward: one launch)
            entry = (f"{name}_packed_kernelILi{dh}E" if plan["route"] == "packed" else
                     f"{name}_wgmma_kernelILi{dh}ELi{((length - 1) % 64) // 16 + 1}E"
                     if kind == "fwd" else f"{name}_wgmma_kernelILi{dh}ELi0E")
            out.append(dict(
                ptxas_kernel(log, entry), name=name, route="cuda", kernel=plan["route"],
                source=f"fairfedmed_tpu_torch/csrc/{name}.cu", replaces=tpu_line,
                shape=shape, n_L_dh=[n, length, dh], causal=row["causal"],
                launches=launches.get("main_path", {}).get(name),
                **{f"launches_{p}": launches.get(p, {}).get(name) for p in PATHS[1:]},
                max_abs_err=row[f"{kind}_max_abs_err"],
                ms=row[f"kernel_{kind}_ms"], ms_cold=row[f"kernel_{kind}_ms_cold"],
                ms_events=row[f"kernel_{kind}_ms_events"], host_ms=row[f"kernel_{kind}_host_ms"],
                plain_ms=row[f"plain_{kind}_ms"], bound_ms=row[f"{kind}_bound_ms"],
                bound_by=row[f"{kind}_bound_by"], library_ms=row[f"sdpa_{kind}_ms"],
                library_ms_cold=row[f"sdpa_{kind}_ms_cold"],
                bound_share=row[f"{kind}_bound_ms"] / row[f"kernel_{kind}_ms_cold"],
                smem_bytes=info["smem_bytes"], threads=info["threads"],
                blocks=info["blocks"], blocks_per_sm=info["blocks_per_sm"],
                slices_per_block=info["slices_per_block"],
                waves=info["blocks"] / (sms * info["blocks_per_sm"])))
    row = next(r for r in rows if r["shape"] == "rope_eva02_train")
    log = _build.library_path("rope_qkv").with_suffix(".log").read_text()
    for kind in ("fwd", "bwd"):
        name = f"rope_qkv_{kind}"
        out.append(dict(
            ptxas_kernel(log, f"12{name}I13__nv_bfloat16"), name=name, route="cuda",
            kernel="grid-stride, 8 elements a thread",
            source="fairfedmed_tpu_torch/csrc/rope_qkv.cu",
            replaces=None, shape=row["shape"], B_L_H_dh=row["B_L_H_dh"],
            launches=launches.get("eva02_path", {}).get(name),
            err_beyond_rtol=row[f"{kind}_err_beyond_rtol"], ms=row[f"kernel_{kind}_ms"],
            ms_cold=row[f"kernel_{kind}_ms_cold"], ms_events=row[f"kernel_{kind}_ms_events"],
            host_ms=row[f"kernel_{kind}_host_ms"], plain_ms=row[f"plain_{kind}_ms"],
            bound_ms=row[f"{kind}_bound_ms"], bound_by=row[f"{kind}_bound_by"],
            bound_share=row[f"{kind}_bound_ms"] / row[f"kernel_{kind}_ms_cold"]))
    return {"kernels": out}


def _ensure_fixtures(names):
    """The fixtures the named phases read but an unselected phase writes."""
    if any(n in names for n in ("rn50_path", "ot_path", "parallel_cli_path", "parallel_rn50_path",
                                "parallel_branches", "parallel_equiv", "resume_path",
                                "baseline_path", "train_cli_path", "timing_path", "dist_path")) \
            and "cli_path" not in names:
        _write_fixture(SLO_ROOT)
    if any(n in names for n in ("rn50_oct_path", "parallel_oct_path", "timing_path")) \
            and "oct_path" not in names:
        _write_fixture(OCT_ROOT, n_train=OCT_TRAIN, n_test=OCT_TEST, modality="oct_bscans")
    if "baseline_path" in names and "cifar_path" not in names:
        shutil.rmtree(CIFAR_ROOT, ignore_errors=True)
        write_cifar_fixture(CIFAR_ROOT, "cifar10")


def main(argv=()):
    """With no arguments every phase runs and the contract's lines are
    printed.  Phase names as arguments run only those phases (after the
    kernel checks), to debug them: then the ``kernels`` line counts only
    their launches, and no final ``ok`` line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if argv and argv[0] == "--dist-rank":  # one torchrun rank of dist_path (NCCL)
        _dist_rank(list(argv[2:]), argv[1].replace(".json", f"_rank{os.environ['RANK']}.json"),
                   watch=True)
        return 0
    names = tuple(argv) or PATHS
    unknown = [n for n in names if n not in PATHS]
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; phases: {PATHS}", file=sys.stderr)
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
          "kernels_built": sorted(logs), "ptxas_spill_lines": spills,
          "sass_tensor_instructions": sass_counts()})

    emit({"phase": "wgmma_check", "modes": A.WGMMA_CHECK_MODES, "rows": check_wgmma(dev)})
    rows = check_kernels(dev)
    emit({"phase": "kernel_checks", "rows": rows, "profiler_misses": PROFILER_MISSES})
    emit(small_reference(dev))
    launches = {}
    if names != PATHS:
        _ensure_fixtures(names)
    for name in names:
        t0 = time.perf_counter()
        launches[name] = globals()[name](dev)
        emit({"phase": f"{name}_done", "s": time.perf_counter() - t0})
    emit(kernels_line(rows, launches))
    if names != PATHS:
        emit({"phase": "total", "s": time.perf_counter() - t_start, "phases": list(names)})
        return 0
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    print(nvidia_smi_line())
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
