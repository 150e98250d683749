"""PromptFL and zero-shot CLIP trainers.

Port of ``fairfedmed_tpu/train/trainers/promptfl.py`` (reference
trainers/promptfl.py:228-345 and trainers/clip.py:76-231):

* ``PromptFL``: one learnable prompt bank (``n_prompts=1``) in front of the
  class names, cosine logits between the pooled image feature and the text
  features, CE loss with the optional FedProx proximal term, one optimizer
  step per batch.
* ``CLIP``: the frozen zero-shot baseline, prompts initialised from
  "a photo of a" and never trained; the CLI only evaluates it.
* ``Baseline``: a supervised Dassl backbone (``models/backbones.py``), an
  optional MLP head and a linear classifier (SimpleNet), fp32, CE loss; the
  BatchNorm running statistics travel in its state dict as ``stats.*``.

Both CLIP towers are frozen and hold ``requires_grad=False``, so the image
tower builds no autograd graph; the gradient reaches the context through
the text tower only.  On the medical datasets the image tower takes the
loader's raw 0-255 pixels, as the reference forward does;
``TRAINER.PROMPTFL.NORMALIZE_MEDICAL_INPUT`` opts into CLIP's /255 and
mean/std.  CIFAR-10/100 batches (uint8 NHWC) are normalised and resized on
the device inside the step (``data/transforms.py:CifarPreprocess``, JAX
promptfl.py:87-94); the other datasets' batches come normalised from the host
transforms and pass unchanged (JAX promptfl.py:72-95).  The logits are
``exp(logit_scale) * (im @ txt^T)`` over the l2-normalised features, the
product in the compute type and then cast to fp32, as the JAX package
computes it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ...core.pytree import flatten_paths, unflatten_like
from ...data.transforms import device_preprocess
from ...fed.dist import all_reduce_sum
from ...models.clip_model import l2_normalize, pool_index, text_encode
from ...models.prompt_learner import assemble_prompts, init_prompt_learner
from ...utils.profiling import span
from ...utils.registry import TRAINER_REGISTRY
from ..clip_common import (accuracy_from_logits, cross_entropy, encode_image, fedprox_term,
                           load_clip_bundle)
from ..engine import TrainerX
from ..optim import FunctionalOptimizer, build_lr_scheduler, build_optimizer, set_learning_rate
from .glp_ot import MEDICAL_DATASETS, check_dataset


class _CosineCLIPTrainer(TrainerX):
    """Shared: pooled-feature cosine logits with a learnable prompt."""

    prec_node = "PROMPTFL"
    trainable_prompt = True

    def check_cfg(self, cfg):
        if cfg.TRAINER[self.prec_node].PREC not in ("fp16", "fp32", "amp"):
            raise ValueError(f"PREC must be fp16/fp32/amp, got {cfg.TRAINER[self.prec_node].PREC}")
        check_dataset(cfg)

    def build_model(self):
        cfg = self.cfg
        node = cfg.TRAINER[self.prec_node]
        bundle = load_clip_bundle(cfg, node.PREC, self.device)
        self.bundle = bundle
        self.policy = bundle.policy
        self.backbone_type = bundle.backbone_type
        classnames = list(self.dm.dataset.classnames)
        self.n_cls = len(classnames)

        gen = torch.Generator().manual_seed(cfg.SEED if cfg.SEED >= 0 else 0)
        ctx_init = node.CTX_INIT if node.CTX_INIT else (
            "a photo of a" if not self.trainable_prompt else False)
        pl_params, self.prompt_state = init_prompt_learner(
            gen, classnames, bundle.params["text"]["token_embedding"], bundle.clip_cfg,
            n_ctx=node.N_CTX, n_prompts=1, ctx_init=ctx_init, csc=node.CSC,
            class_token_position=node.CLASS_TOKEN_POSITION)
        self.trainable = {"prompt_learner": pl_params}
        self.frozen = bundle.params
        if bundle.backbone_type == "resnet":
            self.frozen["visual_bn"] = bundle.visual_bn
            self.frozen["visual_stats"] = bundle.visual_stats
        for p in flatten_paths(self.frozen).values():
            p.requires_grad_(False)
        self.ctx = self.trainable["prompt_learner"]["ctx"]
        self.ctx.requires_grad_(self.trainable_prompt)

        # device constants, made once: a copy from the host inside a step
        # would synchronise with the device
        self._pixel_mean = torch.tensor(cfg.INPUT.PIXEL_MEAN).reshape(1, -1, 1, 1).to(self.device)
        self._pixel_std = torch.tensor(cfg.INPUT.PIXEL_STD).reshape(1, -1, 1, 1).to(self.device)
        self._cifar = device_preprocess(cfg, self.device)
        self._eot_pool = pool_index(self.prompt_state.eot_indices, self.device)

        self.lr_sched = build_lr_scheduler(cfg.OPTIM)
        # start at the schedule's epoch-0 LR (warmup)
        self.optimizer = build_optimizer([self.ctx], cfg.OPTIM, self.lr_sched.lr(0))
        self.parallel_optimizer = FunctionalOptimizer(cfg.OPTIM)

    # ------------------------------------------------------------- forward
    def _preprocess(self, image):
        if self._cifar is not None:
            return self._cifar(image)
        x = image.float()
        if (self.cfg.DATASET.NAME in MEDICAL_DATASETS
                and getattr(self.cfg.TRAINER[self.prec_node], "NORMALIZE_MEDICAL_INPUT", False)):
            x = (x / 255.0 - self._pixel_mean) / self._pixel_std
        return x

    def _forward(self, image, ctx=None):
        """Logits [b, n_cls] for ``image`` under the prompt context ``ctx``
        (default: the trainer's own)."""
        ctx = self.ctx if ctx is None else ctx
        x = self._preprocess(image)
        frozen = self.frozen
        # ResNet BatchNorm in inference mode: the image encoder is frozen entirely
        pooled, _ = encode_image(self.bundle, frozen["visual"], x, return_tokens=False,
                                 bn=frozen.get("visual_bn"), stats=frozen.get("visual_stats"))
        cd = self.policy.compute_dtype
        pooled = l2_normalize(pooled)
        prompts = assemble_prompts(ctx.to(cd), self.prompt_state)
        text = text_encode(frozen, prompts, self.prompt_state.eot_indices, self.bundle.clip_cfg,
                           self.policy, pool=self._eot_pool)
        text = l2_normalize(text)
        # the product in the compute type, then fp32 (JAX promptfl.py:117-118)
        return frozen["logit_scale"].float().exp() * (pooled.to(cd) @ text.to(cd).T).float()

    def _loss(self, logits, label):
        return self.with_fedprox(cross_entropy(logits, label), self.ctx)

    # ------------------------------------------------------------- hot loop
    def forward_backward(self, batch):
        image, label = self.parse_batch_train(batch)
        logits = self._forward(image)
        loss = self._loss(logits, label)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():  # one host fetch: [loss, acc]
            m = torch.stack([loss.detach().float(),
                             accuracy_from_logits(logits.detach(), label)]).cpu().numpy()
        loss_v = float(m[0])
        self.detect_anomaly(loss_v)
        if (self.batch_idx + 1) == self.num_batches:
            self.update_lr()
            set_learning_rate(self.optimizer, self.get_current_lr())
        return {"loss": loss_v, "acc": float(m[1])}

    def parse_batch_train(self, batch):
        return self._to_device(batch["img"]), self._to_device(batch["label"])

    def parse_batch_test(self, batch):
        return self._to_device(batch["img"]), batch["label"], batch.get("attrs"), None

    @torch.no_grad()
    def model_inference(self, inp, attr=None):
        return self._forward(inp)

    # ------------------------------------------------------------- client-parallel rounds
    def parallel_trainable(self) -> dict:
        """What the client-parallel runner keeps per client: the prompt
        context (both towers are frozen, BatchNorm statistics included)."""
        return {"prompt_learner.ctx": self.ctx.detach()}

    def parallel_opt_state(self) -> dict:
        """A fresh ``parallel_optimizer`` state over the context."""
        return self.parallel_optimizer.init(self.parallel_trainable())

    @torch.no_grad()
    def adopt_parallel_trainable(self, flat: dict):
        self.ctx.copy_(flat["prompt_learner.ctx"])

    def make_parallel_local_step(self, fedprox_mu=None, data_group=None):
        """One client's step for the client-parallel round (JAX
        promptfl.py:150-185): ``local_step(params, opt_state, batch, lr,
        ctx_global) -> (params, opt_state, metrics)`` over flat dicts, new
        tensors out, ``metrics`` = [loss, 1, acc] on the device.  With
        ``fedprox_mu`` the loss adds the FedProx term toward
        ``ctx_global``.  With ``data_group`` (the ranks a client's batch is
        split over) the gradient, loss and accuracy are averaged over the
        group in one ``all_reduce`` (JAX promptfl.py:177-180); both towers
        are frozen, BatchNorm included, so ResNet splits its batch too."""
        opt = self.parallel_optimizer
        differentiable = bool(getattr(self.cfg.TRAINER, "DIFFERENTIABLE_FEDPROX", False))
        n_data = dist.get_world_size(data_group) if data_group is not None else 1

        def local_step(params, opt_state, batch, lr, ctx_global=None):
            with span("step.forward"):
                ctx = params["prompt_learner.ctx"].detach().requires_grad_(True)
                logits = self._forward(batch["img"], ctx)
                loss = cross_entropy(logits, batch["label"])
                if fedprox_mu is not None:
                    loss = loss + fedprox_term(ctx, ctx_global, fedprox_mu,
                                               differentiable=differentiable)
            with span("step.backward"):
                (grad,) = torch.autograd.grad(loss, [ctx])
            with torch.no_grad(), span("step.update"):
                loss = loss.detach().float()
                acc = accuracy_from_logits(logits.detach(), batch["label"])
                if data_group is not None:
                    grad, stats = all_reduce_sum([grad, torch.stack([loss, acc])], data_group)
                    grad, loss, acc = grad / n_data, stats[0] / n_data, stats[1] / n_data
                new_p, new_o = opt.update({"prompt_learner.ctx": ctx.detach()},
                                          {"prompt_learner.ctx": grad}, opt_state, lr)
                metrics = torch.stack([loss, torch.ones_like(loss), acc])
            return new_p, new_o, metrics

        return local_step

    def make_parallel_infer(self):
        """``infer(params, image, attr) -> logits`` under one client's
        context."""

        @torch.no_grad()
        def infer(params, image, attr):
            return self._forward(image, params["prompt_learner.ctx"])

        return infer

    # ------------------------------------------------------------- weights
    def state_dict(self):
        # a host copy: on the CPU .numpy() would alias the live parameter
        return {"prompt_learner.ctx": self.ctx.detach().float().cpu().numpy().copy()}

    @torch.no_grad()
    def load_state_dict(self, state, strict=False):
        """Copies ``prompt_learner.ctx`` into the live context in place (the
        optimizer keeps its state, as the JAX package's opt state does).  A
        reference PromptFL checkpoint stores ctx as [n_ctx, dim], with no
        prompt-bank axis: it gets one."""
        if "prompt_learner.ctx" in state:
            new = torch.tensor(np.asarray(state["prompt_learner.ctx"]))
            if new.dim() == self.ctx.dim() - 1:
                new = new[None]
            self.ctx.copy_(new)
        elif strict:
            raise KeyError("Missing keys: ['prompt_learner.ctx']")

    def named_parameters(self):
        out = flatten_paths({"image_encoder": self.frozen["visual"],
                             "text_encoder": self.frozen["text"]})
        out.update(self.state_dict())
        return out


@TRAINER_REGISTRY.register()
class PromptFL(_CosineCLIPTrainer):
    """Prompt-only federated learning (trainers/promptfl.py:228-345)."""


@TRAINER_REGISTRY.register()
class CLIP(_CosineCLIPTrainer):
    """Zero-shot CLIP baseline, eval-only (trainers/clip.py:76-231)."""

    trainable_prompt = False

    def forward_backward(self, batch):  # frozen model: nothing to train
        image, label = self.parse_batch_train(batch)
        acc = accuracy_from_logits(self.model_inference(image), label)
        return {"loss": 0.0, "acc": float(acc)}


@TRAINER_REGISTRY.register()
class Baseline(TrainerX):
    """Supervised backbone (+ MLP head) + linear classifier, SimpleNet
    (trainers/promptfl.py:348-372, Dassl/dassl/engine/trainer.py:48-105;
    JAX promptfl.py:266-382), fp32 throughout.

    ``MODEL.BACKBONE.NAME`` names a backbone of ``models/backbones.py``
    (``cnn3`` when empty) and ``MODEL.HEAD.*`` an optional MLP head.  An
    NHWC batch with 1 or 3 channels last (CIFAR's uint8 arrays) is moved to
    NCHW and divided by 255; any other batch enters raw, as the JAX forward
    takes it.  One optimizer step per batch at the schedule's epoch-0 LR,
    stepped on the epoch's last batch.  The BatchNorm running statistics are
    replaced by the forward's after each step and travel in the state dict
    under ``stats.``.  There is no client-parallel step: ``--parallel_clients``
    runs its rounds sequentially, with the JAX CLI's notice."""

    def build_model(self):
        from ...models.backbones import build_backbone, build_head

        cfg = self.cfg
        dev = self.device
        self.n_cls = self.dm.num_classes
        gen = torch.Generator().manual_seed(cfg.SEED if cfg.SEED >= 0 else 0)
        name = cfg.MODEL.BACKBONE.NAME or "cnn3"
        if cfg.MODEL.BACKBONE.PRETRAINED and name != "cnn3":
            print(f"NOTE: pretrained {name} weights unavailable offline; using random init")
        bb_init, self._bb_apply, fdim = build_backbone(name)
        self._head_apply = None
        trainable, stats = {}, {}
        trainable["backbone"], stats["backbone"] = bb_init(gen, dev)
        if cfg.MODEL.HEAD.NAME and cfg.MODEL.HEAD.HIDDEN_LAYERS:
            head_init, self._head_apply, fdim = build_head(
                cfg.MODEL.HEAD.NAME, fdim, cfg.MODEL.HEAD.HIDDEN_LAYERS,
                activation=cfg.MODEL.HEAD.ACTIVATION, bn=cfg.MODEL.HEAD.BN,
                dropout=cfg.MODEL.HEAD.DROPOUT)
            trainable["head"], stats["head"] = head_init(gen, dev)
        trainable["classifier"] = {
            "weight": (torch.randn((self.n_cls, fdim), generator=gen) * 0.01).to(dev),
            "bias": torch.zeros(self.n_cls, device=dev)}
        self.trainable, self.stats = trainable, stats
        self.fdim = fdim
        self._params = list(flatten_paths(trainable).values())
        for p in self._params:
            p.requires_grad_(True)
        self.lr_sched = build_lr_scheduler(cfg.OPTIM)
        # start at the schedule's epoch-0 LR (warmup)
        self.optimizer = build_optimizer(self._params, cfg.OPTIM, self.lr_sched.lr(0))

    def _forward(self, image, train):
        """``(logits, new_stats)``."""
        x = image.float()
        if x.dim() == 4 and x.shape[-1] in (1, 3):
            x = x.permute(0, 3, 1, 2) / 255.0
        t, stats = self.trainable, self.stats
        f, new_bb = self._bb_apply(t["backbone"], stats["backbone"], x, train)
        new_stats = {"backbone": new_bb}
        if self._head_apply is not None:
            f, new_stats["head"] = self._head_apply(t["head"], stats["head"], f, train)
        return f @ t["classifier"]["weight"].T + t["classifier"]["bias"], new_stats

    def forward_backward(self, batch):
        image, label = self._to_device(batch["img"]), self._to_device(batch["label"])
        logits, new_stats = self._forward(image, train=True)
        loss = cross_entropy(logits, label)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.stats = new_stats
        with torch.no_grad():  # one host fetch: [loss, acc]
            m = torch.stack([loss.detach().float(),
                             accuracy_from_logits(logits.detach(), label)]).cpu().numpy()
        loss_v = float(m[0])
        self.detect_anomaly(loss_v)
        if (self.batch_idx + 1) == self.num_batches:
            self.update_lr()
            set_learning_rate(self.optimizer, self.get_current_lr())
        return {"loss": loss_v, "acc": float(m[1])}

    def parse_batch_test(self, batch):
        return self._to_device(batch["img"]), batch["label"], batch.get("attrs"), None

    @torch.no_grad()
    def model_inference(self, inp, attr=None):
        return self._forward(self._to_device(inp), train=False)[0]

    def _named(self) -> dict:
        out = dict(flatten_paths(self.trainable))
        out.update({f"stats.{k}": v for k, v in flatten_paths(self.stats).items()})
        return out

    def state_dict(self):
        """The trainable tree and the BatchNorm statistics (``stats.``-prefixed)
        as fp32 numpy copies under dotted paths."""
        return {k: v.detach().float().cpu().numpy().copy() for k, v in self._named().items()}

    @torch.no_grad()
    def load_state_dict(self, state, strict=False):
        """Copies the given parameters in place (the optimizer keeps its
        state) and takes the given ``stats.`` entries; ``strict`` raises on a
        missing key."""
        named = self._named()
        missing = [k for k in named if k not in state]
        if strict and missing:
            raise KeyError(f"Missing keys: {missing[:3]}...")
        stats = flatten_paths(self.stats)
        for k, t in named.items():
            if k not in state:
                continue
            new = torch.tensor(np.asarray(state[k]), dtype=t.dtype, device=t.device)  # a copy
            if k.startswith("stats."):
                stats[k[len("stats."):]] = new
            else:
                t.copy_(new)
        self.stats = unflatten_like(self.stats, stats)

    def named_parameters(self):
        return self.state_dict()
