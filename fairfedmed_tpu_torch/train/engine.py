"""Trainer engine (port of ``fairfedmed_tpu/train/engine.py``; capability
match of Dassl/dassl/engine/trainer.py:108-751).

Model state is a frozen tree (the CLIP backbone) and a trainable tree
(prompt context, adapters) of tensors.  The federated weight exchange
(``state_dict``/``load_state_dict``) moves only the trainable tree, as
dotted-path numpy dicts with the reference's key names, so aggregation
predicates such as ``'lora_S' in key`` carry over.

The trainer builds its ``DataManager`` from the config, as the JAX package's
does; a caller may hand it ``dm`` instead: any object with
``fed_train_loader_x_dict`` / ``fed_test_loader_x_dict`` (per-client
iterables of the batch dicts ``ClientLoader`` yields), ``num_classes``,
``lab2cname`` and ``dataset.classnames``.  Training batches reach the device
through ``prefetch_to_device``.  The printed lines match the JAX package's
byte for byte (``tools/parse_test_res.py`` reads them).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.manager import DataManager, prefetch_to_device
from ..evaluation.evaluator import build_evaluator
from ..utils.meters import AverageMeter, MetricMeter
from ..utils.profiling import profile_trace
from ..utils.registry import TRAINER_REGISTRY
from ..utils.tools import mkdir_if_missing
from .checkpoint import host_copy
from .clip_common import fedprox_term
from .optim import LRSchedule, set_learning_rate


def build_trainer(cfg, dm=None, device=None):
    """The trainer named by ``cfg.TRAINER.NAME``, on ``device`` (default
    ``cuda``; ``"cpu"`` runs the plain PyTorch paths), over ``dm`` (default:
    ``DataManager(cfg)``)."""
    from . import trainers  # noqa: F401  (registers the trainers)

    return TRAINER_REGISTRY.get(cfg.TRAINER.NAME)(cfg, dm, device=device)


class TrainerBase:
    """Generic lifecycle over one client's local epochs."""

    def __init__(self):
        self._writer = None
        self.epoch = 0
        self.start_epoch = 0
        self.max_epoch = 0
        self.fedprox = False  # FedProx proximal term on (train(fedprox=True))
        self.mu = 0.5
        self._fedprox_ctx_global = None  # the round's global prompt context

    # -- tensorboard -------------------------------------------------------
    def init_writer(self, log_dir):
        """The scalars' writer under ``log_dir``.  ``log_dir`` None imports
        the writer's module and makes no writer: a rank that writes no
        scalars then draws from numpy's global RNG what rank 0's import
        draws (TensorFlow's import draws where it is installed), so the ranks
        sample alike."""
        if self._writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:  # tensorboard is optional
                print(f"TensorBoard unavailable ({e}); scalars will not be written")
                return
            if log_dir is None:
                return
            mkdir_if_missing(log_dir)
            self._writer = SummaryWriter(log_dir=log_dir)
            print(f"Initialize tensorboard (log_dir={log_dir})")

    def close_writer(self):
        if self._writer is not None:
            self._writer.close()

    def write_scalar(self, tag, value, step):
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def train(self, idx=-1, global_epoch=0, is_fed=False, is_last_client=False,
              global_weight=None, fedprox=False, mu=0.5):
        """Run MAX_EPOCH local epochs for client ``idx`` (TrainerBase.train,
        trainer.py:281-291).  With ``fedprox`` the trainer's loss adds the
        proximal term ``(mu / 2) * ||ctx - ctx_global||^2`` towards the
        prompt context of ``global_weight``."""
        self.set_model_mode("train")
        self.fedprox = fedprox
        self.mu = mu
        if fedprox and global_weight is not None and hasattr(self, "set_fedprox_global"):
            self.set_fedprox_global(global_weight)
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            self.run_epoch(idx, global_epoch)
            self.after_epoch(idx, global_epoch, is_last_client)

    def before_epoch(self):
        pass

    def after_epoch(self, idx, global_epoch, is_last_client):
        pass

    def run_epoch(self, idx, global_epoch):
        raise NotImplementedError

    def set_model_mode(self, mode="train"):
        self._mode = mode

    def detect_anomaly(self, loss):
        if not np.isfinite(loss):
            raise FloatingPointError("Loss is infinite or NaN!")

    def state_dict(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def load_state_dict(self, state: Dict[str, np.ndarray], strict: bool = False):
        raise NotImplementedError

    def save_model(self, epoch, directory, idx=None):
        """Grad-only checkpoint ``epoch{g}_client{i}.npz`` (save_model_with_grad,
        trainer.py:177-186)."""
        os.makedirs(directory, exist_ok=True)
        tag = f"epoch{epoch}_client{idx}" if idx is not None else f"epoch{epoch}"
        path = os.path.join(directory, f"{tag}.npz")
        np.savez(path, **self.state_dict())
        return path

    def save_checkpoint(self, epoch, directory, name="model"):
        """Full-format checkpoint ``{name}.pth.tar-{epoch}`` (torchtools.py:
        27-82): the state dict, ``epoch + 1`` and the optimizer state, written
        with ``torch.save`` (tensors on the CPU), and the ``checkpoint`` file
        naming it."""
        mkdir_if_missing(directory)
        fpath = os.path.join(directory, f"{name}.pth.tar-{epoch}")
        torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                                   for k, v in self.state_dict().items()},
                    "epoch": epoch + 1, "optimizer": self.optimizer_state_dict()}, fpath)
        with open(os.path.join(directory, "checkpoint"), "w") as f:
            f.write(os.path.basename(fpath))
        return fpath

    def resume_from_checkpoint(self, directory, name="model"):
        """Load the checkpoint the ``checkpoint`` file of ``directory`` names
        (weights and optimizer state); returns the epoch to start from, 0
        when there is no pointer file."""
        pointer = os.path.join(directory, "checkpoint")
        if not os.path.exists(pointer):
            return 0
        with open(pointer) as f:
            fname = f.read().strip()
        ckpt = load_checkpoint(os.path.join(directory, fname))
        self.load_state_dict(ckpt["state_dict"], strict=False)
        if ckpt.get("optimizer") is not None:
            self.load_optimizer_state_dict(ckpt["optimizer"])
        print(f"Resumed from {fname} (epoch={ckpt['epoch']})")
        return int(ckpt["epoch"])

    def optimizer_state_dict(self):
        """The sequential optimizer's state (``torch.optim`` format, tensors
        on the CPU), or None for a trainer without one.  Every trainer of the
        port steps one ``train/optim.py:Optimizer``, so this one method
        serves them all (JAX glp_ot.py:858-865, promptfl.py:240-246)."""
        opt = getattr(self, "optimizer", None)
        return None if opt is None else host_copy(opt.state_dict())

    def load_optimizer_state_dict(self, state):
        opt = getattr(self, "optimizer", None)
        if opt is not None:
            opt.load_state_dict(state)


def load_checkpoint(path: str) -> dict:
    """A :meth:`TrainerBase.save_checkpoint` file, its state dict as numpy."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    ckpt["state_dict"] = {k: v.numpy() for k, v in ckpt["state_dict"].items()}
    return ckpt


class SimpleTrainer(TrainerBase):
    """Model, evaluator and the federated train/test lifecycle over the
    caller's per-client loaders (SimpleTrainer, trainer.py:345-589)."""

    def __init__(self, cfg, dm=None, device=None):
        super().__init__()
        self.check_cfg(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.start_epoch = self.epoch = 0
        self.max_epoch = cfg.OPTIM.MAX_EPOCH
        self.output_dir = cfg.OUTPUT_DIR

        self.dm = dm = DataManager(cfg) if dm is None else dm
        self.fed_train_loader_x_dict = dm.fed_train_loader_x_dict
        self.fed_test_loader_x_dict = dm.fed_test_loader_x_dict
        self.num_classes = dm.num_classes
        self.lab2cname = dm.lab2cname
        self.build_model()
        self.evaluator = build_evaluator(cfg, lab2cname=self.lab2cname)

        # the reference steps its scheduler once per client-local epoch
        self.lr_sched: Optional[LRSchedule] = getattr(self, "lr_sched", None)
        self._lr_steps = 0

    def check_cfg(self, cfg):
        pass

    def build_model(self):
        raise NotImplementedError

    def _to_device(self, x):
        """A batch array (numpy, or a tensor from ``prefetch_to_device``) on
        the trainer's device."""
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    # -- FedProx -----------------------------------------------------------
    def set_fedprox_global(self, state):
        self._fedprox_ctx_global = torch.tensor(np.asarray(state["prompt_learner.ctx"]),
                                                dtype=torch.float32, device=self.device)

    def with_fedprox(self, loss, ctx):
        """``loss`` plus the FedProx proximal term towards the round's global
        context when this client trains under FedProx (``train(fedprox=True)``),
        detached unless ``TRAINER.DIFFERENTIABLE_FEDPROX``."""
        if not self.fedprox or self._fedprox_ctx_global is None:
            return loss
        differentiable = bool(getattr(self.cfg.TRAINER, "DIFFERENTIABLE_FEDPROX", False))
        return loss + fedprox_term(ctx, self._fedprox_ctx_global, self.mu,
                                   differentiable=differentiable)

    # -- fed lifecycle -----------------------------------------------------
    def fed_before_train(self):
        self.init_writer(os.path.join(self.output_dir, "tensorboard"))
        self.time_start = time.time()

    def fed_after_train(self):
        print("Finish training")
        elapsed = round(time.time() - self.time_start)
        print(f"Elapsed: {datetime.timedelta(seconds=elapsed)}")
        self.close_writer()

    def after_epoch(self, idx, global_epoch, is_last_client):
        """Per-client grad-only checkpoint at a local-epoch CHECKPOINT_FREQ
        cadence, and always at the last local epoch of the round
        (trainer.py:497-521)."""
        last_epoch = (self.epoch + 1) == self.max_epoch
        freq = self.cfg.TRAIN.CHECKPOINT_FREQ
        meet_freq = (self.epoch + 1) % freq == 0 if freq > 0 else False
        if meet_freq or last_epoch:
            path = self.save_model(global_epoch, os.path.join(self.output_dir, "checkpoints"),
                                   idx=idx)
            print("Save checkpoint to", path)

    def test(self, idx=-1, current_epoch=0):
        """Evaluate client ``idx``; returns list(results.values()) positionally
        (trainer.py:523-569 + federated_main.py:686-690)."""
        self.set_model_mode("eval")
        self.evaluator.reset()
        print(f"Evaluate on the client{idx}_test set")
        for batch in self.fed_test_loader_x_dict[idx]:
            inp, label, attrs, tgt_attr = self.parse_batch_test(batch)
            n = batch["n_valid"]
            output = self.model_inference(inp, tgt_attr).float().cpu().numpy()[:n]
            attrs_h = None if attrs is None else np.asarray(attrs)[:n].T  # [A, B]
            self.evaluator.process(output, np.asarray(label)[:n], attrs_h)
        results = self.evaluator.evaluate()
        for k, v in results.items():
            if np.isscalar(v):
                self.write_scalar(f"test/{k}/{idx}", v, current_epoch)
        return list(results.values())

    def model_inference(self, inp, attr=None):
        raise NotImplementedError

    def parse_batch_test(self, batch):
        return batch["img"], batch["label"], batch.get("attrs"), None


class TrainerX(SimpleTrainer):
    """Supervised epoch loop over one client's loader
    (TrainerX.run_epoch, trainer.py:685-741).  The epoch's meters stay on
    the trainer (``batch_time``, ``data_time``: host time per batch and the
    part of it spent waiting for the batch).  Every batch writes the
    ``train/<metric>/<client>`` and ``train/lr/<client>`` scalars; with
    ``TRAIN.PROFILE_DIR`` set, the trainer's first epoch is traced there."""

    def run_epoch(self, idx, global_epoch):
        profile_dir = getattr(self.cfg.TRAIN, "PROFILE_DIR", "")
        if profile_dir and not getattr(self, "_profiled", False):
            self._profiled = True
            with profile_trace(profile_dir, self.device):
                return self._run_epoch(idx, global_epoch)
        return self._run_epoch(idx, global_epoch)

    def _run_epoch(self, idx, global_epoch):
        self.set_model_mode("train")
        losses = MetricMeter()
        self.batch_time = batch_time = AverageMeter()
        self.data_time = data_time = AverageMeter()

        loader = self.fed_train_loader_x_dict[idx]
        self.num_batches = len(loader)
        lr_steps_before = self._lr_steps
        n_seen = 0
        end = time.time()
        # keep 2 batches on the device while the host decodes ahead
        for self.batch_idx, batch in enumerate(prefetch_to_device(loader, 2, self.device)):
            n_seen += 1
            data_time.update(time.time() - end)
            loss_summary = self.forward_backward(batch)
            batch_time.update(time.time() - end)
            if loss_summary:
                losses.update(loss_summary)

            meet_freq = (self.batch_idx + 1) % self.cfg.TRAIN.PRINT_FREQ == 0
            only_few_batches = self.num_batches < self.cfg.TRAIN.PRINT_FREQ
            if meet_freq or only_few_batches:
                nb_remain = self.num_batches - self.batch_idx - 1
                eta = str(datetime.timedelta(seconds=int(batch_time.avg * nb_remain)))
                print(
                    f"epoch [{self.epoch + 1}/{self.max_epoch}]"
                    f"[{self.batch_idx + 1}/{self.num_batches}]"
                    f"\ttime {batch_time.val:.3f} ({batch_time.avg:.3f})"
                    f"\tdata {data_time.val:.3f} ({data_time.avg:.3f})"
                    f"\teta {eta}"
                    f"\t{losses}"
                    f"\tlr {self.get_current_lr():.6e}"
                )
            # the reference's x-axis (trainer.py:729-734): the local epoch and
            # the federated round both advance it
            n_iter = self.epoch * self.num_batches + self.batch_idx
            if global_epoch >= 0:
                n_iter += global_epoch * self.max_epoch * self.num_batches
            if loss_summary:
                for name, meter in losses.meters.items():
                    self.write_scalar(f"train/{name}/{idx}", meter.avg, n_iter)
            self.write_scalar(f"train/lr/{idx}", self.get_current_lr(), n_iter)
            end = time.time()

        # The LR schedule steps on the batch where (batch_idx + 1) ==
        # num_batches, but len(loader) is an estimate for structured
        # samplers: if the stream ended short the gate never fired, so step
        # here instead.  An empty epoch does not step (the reference's gate
        # never fires on an empty loader either).
        if n_seen and self._lr_steps == lr_steps_before:
            self.update_lr()
            if getattr(self, "optimizer", None) is not None:
                set_learning_rate(self.optimizer, self.get_current_lr())

    def get_current_lr(self) -> float:
        if self.lr_sched is None:
            return float(self.cfg.OPTIM.LR)
        return self.lr_sched.lr(self._lr_steps)

    def update_lr(self):
        """Advance the per-epoch LR step counter (trainer.py:253-258), once per
        registered model name: with an unfrozen image encoder the reference
        advances the schedule by two per local epoch."""
        self._lr_steps += getattr(self, "lr_step_multiplier", 1)

    def forward_backward(self, batch):
        raise NotImplementedError
