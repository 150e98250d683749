"""PromptFL and zero-shot CLIP trainers.

Port of ``fairfedmed_tpu/train/trainers/promptfl.py`` (reference
trainers/promptfl.py:228-345 and trainers/clip.py:76-231):

* ``PromptFL``: one learnable prompt bank (``n_prompts=1``) in front of the
  class names, cosine logits between the pooled image feature and the text
  features, CE loss with the optional FedProx proximal term, one optimizer
  step per batch.
* ``CLIP``: the frozen zero-shot baseline, prompts initialised from
  "a photo of a" and never trained; the CLI only evaluates it.
* ``Baseline`` (a supervised backbone and linear head) needs the Dassl
  backbones, which are not ported yet (ROADMAP M17): it raises.

Both CLIP towers are frozen and hold ``requires_grad=False``, so the image
tower builds no autograd graph; the gradient reaches the context through
the text tower only.  On the medical datasets the image tower takes the
loader's raw 0-255 pixels, as the reference forward does;
``TRAINER.PROMPTFL.NORMALIZE_MEDICAL_INPUT`` opts into CLIP's /255 and
mean/std.  The logits are ``exp(logit_scale) * (im @ txt^T)`` over the
l2-normalised features, the product in the compute type and then cast to
fp32, as the JAX package computes it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.pytree import flatten_paths
from ...models.clip_model import l2_normalize, pool_index, text_encode, vit_encode
from ...models.prompt_learner import assemble_prompts, init_prompt_learner
from ...models.resnet_clip import resnet_encode
from ...utils.registry import TRAINER_REGISTRY
from ..clip_common import accuracy_from_logits, cross_entropy, fedprox_term, load_clip_bundle
from ..engine import TrainerX
from ..optim import FunctionalOptimizer, build_lr_scheduler, build_optimizer, set_learning_rate
from .glp_ot import MEDICAL_DATASETS


class _CosineCLIPTrainer(TrainerX):
    """Shared: pooled-feature cosine logits with a learnable prompt."""

    prec_node = "PROMPTFL"
    trainable_prompt = True

    def check_cfg(self, cfg):
        if cfg.TRAINER[self.prec_node].PREC not in ("fp16", "fp32", "amp"):
            raise ValueError(f"PREC must be fp16/fp32/amp, got {cfg.TRAINER[self.prec_node].PREC}")
        if cfg.DATASET.NAME not in MEDICAL_DATASETS:
            raise NotImplementedError(f"dataset {cfg.DATASET.NAME} is not ported yet "
                                      "(ROADMAP M14)")

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
        self._eot_pool = pool_index(self.prompt_state.eot_indices, self.device)

        self.lr_sched = build_lr_scheduler(cfg.OPTIM)
        # start at the schedule's epoch-0 LR (warmup)
        self.optimizer = build_optimizer([self.ctx], cfg.OPTIM, self.lr_sched.lr(0))
        self.parallel_optimizer = FunctionalOptimizer(cfg.OPTIM)

    # ------------------------------------------------------------- forward
    def _preprocess(self, image):
        x = image.float()
        if getattr(self.cfg.TRAINER[self.prec_node], "NORMALIZE_MEDICAL_INPUT", False):
            x = (x / 255.0 - self._pixel_mean) / self._pixel_std
        return x

    def _forward(self, image, ctx=None):
        """Logits [b, n_cls] for ``image`` under the prompt context ``ctx``
        (default: the trainer's own)."""
        ctx = self.ctx if ctx is None else ctx
        x = self._preprocess(image)
        frozen = self.frozen
        if self.backbone_type == "resnet":
            # BatchNorm in inference mode: the image encoder is frozen entirely
            pooled, _ = resnet_encode(frozen["visual"], frozen["visual_bn"], frozen["visual_stats"],
                                      x, self.bundle.rn_cfg, self.policy, train=False,
                                      return_tokens=False)
        else:
            pooled = vit_encode(frozen["visual"], x, self.bundle.clip_cfg, self.policy)
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

    def make_parallel_local_step(self, fedprox_mu=None):
        """One client's step for the client-parallel round (JAX
        promptfl.py:150-185): ``local_step(params, opt_state, batch, lr,
        ctx_global) -> (params, opt_state, metrics)`` over flat dicts, new
        tensors out, ``metrics`` = [loss, 1, acc] on the device.  With
        ``fedprox_mu`` the loss adds the FedProx term toward
        ``ctx_global``."""
        opt = self.parallel_optimizer
        differentiable = bool(getattr(self.cfg.TRAINER, "DIFFERENTIABLE_FEDPROX", False))

        def local_step(params, opt_state, batch, lr, ctx_global=None):
            ctx = params["prompt_learner.ctx"].detach().requires_grad_(True)
            logits = self._forward(batch["img"], ctx)
            loss = cross_entropy(logits, batch["label"])
            if fedprox_mu is not None:
                loss = loss + fedprox_term(ctx, ctx_global, fedprox_mu,
                                           differentiable=differentiable)
            (grad,) = torch.autograd.grad(loss, [ctx])
            with torch.no_grad():
                new_p, new_o = opt.update({"prompt_learner.ctx": ctx.detach()},
                                          {"prompt_learner.ctx": grad}, opt_state, lr)
                loss = loss.detach().float()
                metrics = torch.stack([loss, torch.ones_like(loss),
                                       accuracy_from_logits(logits.detach(), batch["label"])])
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
    """Supervised backbone + linear classifier (trainers/promptfl.py:348-372):
    needs ``models/backbones.py``, not ported yet."""

    def __init__(self, cfg, dm=None, device=None):
        raise NotImplementedError("the Baseline trainer is not ported yet (ROADMAP M17: "
                                  "models/backbones.py)")
