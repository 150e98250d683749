"""Standalone (one-site) training CLI of the port: the counterpart of the
repository's ``tools/train.py`` (Dassl's ``tools/train.py:1-190``).

    python -m fairfedmed_tpu_torch.tools.train --root DATA --trainer PromptFL \\
        --output-dir out [--eval-only --model-dir out/checkpoints] [KEY VALUE ...]

argparse -> ``setup_cfg`` (the method config nodes of the port's federated
CLI, the dataset and method config files, ``reset_cfg``, the ``KEY VALUE``
overrides, one site, ``clean_cfg``) -> seed, logger, the startup block ->
``build_trainer`` -> ``--eval-only`` (``load_model``, then ``test``) |
``--no-train`` | train, ``save_checkpoint`` (the full format with the
optimizer state) and ``test``.  With ``--resume DIR`` the trainer first
restarts from that directory's full-format checkpoint at the saved epoch.
Standalone means one site: the whole train split is client 0
(``DATASET.USERS`` 1).

Runs on ``cuda`` and raises when no GPU is present; the override
``USE_CUDA False`` (or ``main(args, device="cpu")``) runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import federated_main
from ..config import get_cfg_default
from ..core.device import resolve_device
from ..train.engine import build_trainer, load_checkpoint
from ..utils.logger import setup_logger
from ..utils.tools import set_random_seed

# Nodes a trainer reads beyond its own name: CLIP and Baseline share
# PromptFL's precision node, the GLP_OT family reads TRAINER.GLP_OT_LORA.
_EXTRA_TRAINER_NODES = {
    "CLIP": ("PROMPTFL",),
    "BASELINE": ("PROMPTFL",),
    "GLP_OT": ("GLP_OT_LORA",),
    "GLP_OT_SVLORA": ("GLP_OT", "GLP_OT_LORA"),
}


def clean_cfg(cfg, trainer):
    """Remove other trainers' config nodes, keeping those the selected
    trainer reads: every node whose name prefixes the trainer's (GLP_OT for
    GLP_OT_SVLORA) and the shared nodes of ``_EXTRA_TRAINER_NODES``.  Only
    nodes go, as Dassl's clean_cfg pops only nodes: the JAX package's
    version also drops the plain keys ``TRAINER.LAMBDA_FAIRNESS`` and
    ``TRAINER.DIFFERENTIABLE_FEDPROX``, which the GLP_OT trainers read, so
    there they fail to build."""
    if not trainer:
        return
    want = trainer.upper()
    keep = {"NAME", want, *_EXTRA_TRAINER_NODES.get(want, ())}
    for key, value in list(cfg.TRAINER.items()):
        if isinstance(value, dict) and key not in keep and not want.startswith(key):
            dict.pop(cfg.TRAINER, key, None)


def reset_cfg(cfg, args):
    """Flag -> config overrides (Dassl tools/train.py:23-52)."""
    if args.root:
        cfg.DATASET.ROOT = args.root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.resume:
        cfg.RESUME = args.resume
    if args.seed is not None and args.seed >= 0:
        cfg.SEED = args.seed
    if args.source_domains:
        cfg.DATASET.SOURCE_DOMAINS = args.source_domains
    if args.target_domains:
        cfg.DATASET.TARGET_DOMAINS = args.target_domains
    if args.transforms:
        cfg.INPUT.TRANSFORMS = args.transforms
    if args.trainer:
        cfg.TRAINER.NAME = args.trainer
    if args.backbone:
        cfg.MODEL.BACKBONE.NAME = args.backbone
    if args.head:
        cfg.MODEL.HEAD.NAME = args.head


def _fed_defaults(args):
    """The federated parser's defaults, for the method config nodes the
    trainers read (one site)."""
    fed = federated_main.build_arg_parser().parse_args([])
    if args.backbone:
        fed.backbone = args.backbone
    if args.trainer:
        fed.trainer = args.trainer
    fed.num_users = 1
    fed.frac = 1.0
    return fed


def setup_cfg(args):
    cfg = get_cfg_default()
    federated_main.extend_cfg(cfg, _fed_defaults(args))
    if args.dataset_config_file:
        cfg.merge_from_file(args.dataset_config_file)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    reset_cfg(cfg, args)
    if args.opts:
        cfg.merge_from_list(args.opts)
    # one site, forced after the merges: a reused federated config must not
    # shard the split and train on shard 0
    if cfg.DATASET.USERS != 1:
        if cfg.DATASET.USERS > 1:
            print(f"Note: overriding DATASET.USERS={cfg.DATASET.USERS} -> 1 "
                  "(standalone CLI trains the whole split as one site; use "
                  "federated_main.py for federated runs)")
        cfg.DATASET.USERS = 1
    clean_cfg(cfg, args.trainer)
    cfg.freeze()
    return cfg


def load_model(trainer, directory, epoch=None):
    """Weights for ``--eval-only`` from ``directory``: ``model.pth.tar-{epoch}``
    when ``epoch`` is given, else the checkpoint the ``checkpoint`` pointer
    file names, else the newest grad-only ``.npz``."""
    if not directory:
        print("Note: model directory empty, evaluating the built model as-is")
        return
    if epoch is not None:
        path = os.path.join(directory, f"model.pth.tar-{epoch}")
        if not os.path.exists(path):
            raise FileNotFoundError(f'No checkpoint "model.pth.tar-{epoch}" under {directory}')
        ckpt = load_checkpoint(path)
        trainer.load_state_dict(ckpt["state_dict"], strict=False)
        print(f"Loaded {path} (epoch={ckpt['epoch']})")
        return
    if os.path.exists(os.path.join(directory, "checkpoint")):
        trainer.resume_from_checkpoint(directory)
        return
    npzs = sorted(p for p in os.listdir(directory) if p.endswith(".npz"))
    if not npzs:
        raise FileNotFoundError(f"No checkpoint found under {directory}")
    path = os.path.join(directory, npzs[-1])
    with np.load(path) as z:
        trainer.load_state_dict({k: z[k] for k in z.files}, strict=False)
    print(f"Loaded {path}")


def main(args, device=None):
    """Returns ``{"test": [...]}`` (nothing with ``--no-train``); ``device``
    defaults to ``cuda`` (``cpu`` when the config sets ``USE_CUDA False``)."""
    cfg = setup_cfg(args)
    if cfg.SEED >= 0:
        print("Setting fixed seed: {}".format(cfg.SEED))
        set_random_seed(cfg.SEED)
    setup_logger(cfg.OUTPUT_DIR)
    federated_main.print_args(args, cfg)
    device = resolve_device(device if device is not None else "cuda" if cfg.USE_CUDA else "cpu")

    trainer = build_trainer(cfg, device=device)

    if args.eval_only:
        load_model(trainer, args.model_dir, epoch=args.load_epoch)
        return {"test": trainer.test(idx=0)}

    out = {}
    if not args.no_train:
        trainer.fed_before_train()
        if cfg.RESUME:
            trainer.start_epoch = trainer.resume_from_checkpoint(cfg.RESUME)
        trainer.train(idx=0, global_epoch=0, is_fed=False)
        trainer.fed_after_train()
        trainer.save_checkpoint(trainer.max_epoch - 1, os.path.join(cfg.OUTPUT_DIR, "checkpoints"))
        if not cfg.TEST.NO_TEST:
            out["test"] = trainer.test(idx=0, current_epoch=trainer.max_epoch)
    return out


def build_arg_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=str, default="", help="path to dataset")
    parser.add_argument("--output-dir", type=str, default="", help="output directory")
    parser.add_argument("--resume", type=str, default="",
                        help="checkpoint directory (from which the training resumes)")
    parser.add_argument("--seed", type=int, default=-1,
                        help="only positive value enables a fixed seed")
    parser.add_argument("--source-domains", type=str, nargs="+",
                        help="source domains for DA/DG")
    parser.add_argument("--target-domains", type=str, nargs="+",
                        help="target domains for DA/DG")
    parser.add_argument("--transforms", type=str, nargs="+", help="data augmentation methods")
    parser.add_argument("--config-file", type=str, default="", help="path to config file")
    parser.add_argument("--dataset-config-file", type=str, default="",
                        help="path to config file for dataset setup")
    parser.add_argument("--trainer", type=str, default="", help="name of trainer")
    parser.add_argument("--backbone", type=str, default="", help="name of CNN backbone")
    parser.add_argument("--head", type=str, default="", help="name of head")
    parser.add_argument("--eval-only", action="store_true", help="evaluation only")
    parser.add_argument("--model-dir", type=str, default="",
                        help="load model from this directory for eval-only mode")
    parser.add_argument("--load-epoch", type=int,
                        help="load model weights at this epoch for evaluation")
    parser.add_argument("--no-train", action="store_true", help="do not call trainer.train()")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="modify config options using the command-line")
    return parser


if __name__ == "__main__":
    main(build_arg_parser().parse_args())
