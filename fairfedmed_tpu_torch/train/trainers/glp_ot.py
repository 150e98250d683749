"""FairLoRA trainer (GLP_OT_SVLoRA) on a ViT backbone.

Port of ``fairfedmed_tpu/train/trainers/glp_ot.py`` (reference
trainers/GLP_OT_SVLoRA.py:575-1054) for 2D medical input with OT = None: CLIP
with a multi-prompt learner and FairLoRA adapters on every vision MLP, the
demographic group of each sample selecting a blend of singular values.  The
3D-OCT slice path, the Sinkhorn/COT transport, ResNet backbones and the
prompt-only GLP_OT trainer are not ported yet and raise.

Each batch runs one forward and backward and then steps the optimizer TWICE
on the same gradients: the reference registers prompt_learner and
image_encoder with one shared optimizer and Dassl steps once per registered
name (GLP_OT_SVLoRA.py:868-881, trainer.py:333-342).
TRAINER.GLP_OT_LORA.SINGLE_OPT_STEP opts out, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ...adapters.lora import group_mix, init_lora
from ...evaluation import metrics as eval_metrics
from ...models.clip_model import l2_normalize, text_encode, vit_encode
from ...models.prompt_learner import assemble_prompts, init_prompt_learner
from ...utils.registry import TRAINER_REGISTRY
from ..clip_common import (accuracy_from_logits, cross_entropy, fairness_confidence_loss,
                           load_clip_bundle)
from ..engine import TrainerX
from ..optim import build_lr_scheduler, build_optimizer, set_learning_rate

MEDICAL_DATASETS = ("FairFedMed", "FedChexMimic", "WangGrant")
MODALITY_3D = ("oct_bscans", "oct_bscans_3d", "mac_onh", "onh_mac")

# per-dataset demographic group tables (GLP_OT_SVLoRA.py:775-790)
GROUP_TABLES = {
    "FairFedMed": {
        "race": ["Asian", "Black", "White"],
        "language": ["English", "Spanish", "Others"],
        "ethnicity": ["Non-hispanic", "Hispanic"],
        "gender": ["Male", "Female"],
    },
    "FedChexMimic": {
        "race": ["White", "Asian", "Black"],
        "gender": ["Male", "Female"],
        "age": ["0-60", "60+"],
    },
}
LORA_PARTS = ("c_fc", "c_proj")


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy that never aliases the live parameter (``.cpu()`` of a CPU
    tensor is the tensor itself)."""
    return t.detach().to("cpu", copy=True).numpy()


def _lora_key(i: int, part: str, leaf: str) -> str:
    return f"image_encoder.transformer.resblocks.{i}.mlp.{part}.{leaf}.weight"


@TRAINER_REGISTRY.register()
class GLP_OT_SVLoRA(TrainerX):
    """FairLoRA: GLP-OT + grouped low-rank adapters
    (trainers/GLP_OT_SVLoRA.py:767-1054)."""

    def check_cfg(self, cfg):
        if cfg.TRAINER.GLP_OT.PREC not in ("fp16", "fp32", "amp"):
            raise ValueError(f"PREC must be fp16/fp32/amp, got {cfg.TRAINER.GLP_OT.PREC}")
        if cfg.TRAINER.GLP_OT.OT != "None":
            raise NotImplementedError(f"OT={cfg.TRAINER.GLP_OT.OT} is not ported yet (only None)")
        if cfg.DATASET.MODALITY_TYPE in MODALITY_3D:
            raise NotImplementedError(f"3D input ({cfg.DATASET.MODALITY_TYPE}) is not ported yet")
        if cfg.DATASET.NAME not in MEDICAL_DATASETS:
            raise NotImplementedError(f"dataset {cfg.DATASET.NAME} is not ported yet")

    # ------------------------------------------------------------- build
    def build_model(self):
        cfg = self.cfg
        t = cfg.TRAINER.GLP_OT
        lc = cfg.TRAINER.GLP_OT_LORA
        bundle = load_clip_bundle(cfg, t.PREC, self.device)
        if bundle.backbone_type != "vit":
            raise NotImplementedError("only ViT backbones are ported")
        self.bundle = bundle
        self.policy = bundle.policy
        classnames = list(self.dm.dataset.classnames)
        self.n_cls = len(classnames)
        self.N = t.N

        clip_res = bundle.clip_cfg.image_resolution
        cfg_size = cfg.INPUT.SIZE[0] if not isinstance(cfg.INPUT.SIZE, str) else 224
        if cfg_size != clip_res:
            raise ValueError(f"cfg_imsize ({cfg_size}) must equal to clip_imsize ({clip_res})")

        # CPU draws: the same seed gives the same trainer on every device
        gen = torch.Generator().manual_seed(cfg.SEED if cfg.SEED >= 0 else 0)
        print("Building custom CLIP")
        pl_params, self.prompt_state = init_prompt_learner(
            gen, classnames, bundle.params["text"]["token_embedding"], bundle.clip_cfg,
            n_ctx=t.N_CTX, n_prompts=t.N, ctx_init=t.CTX_INIT, csc=t.CSC,
            class_token_position=t.CLASS_TOKEN_POSITION)
        trainable = {"prompt_learner": pl_params}

        self.disable_attr = bool(lc.DISABLE_ATTR)
        if not lc.DISABLE_ATTR and cfg.DATASET.NAME in GROUP_TABLES:
            self.num_groups = len(GROUP_TABLES[cfg.DATASET.NAME][cfg.DATASET.ATTRIBUTE_TYPE])
            self.disable_attr = False
        else:
            self.num_groups = 1

        # FairLoRA on every resblock's mlp.c_fc / mlp.c_proj
        # (apply_lora_to_model, GLP_OT_SVLoRA.py:503-573), stacked per layer
        self.lora_scaling = 0.0
        if lc.UNFREEZE_IMAGE_ENCODER:
            self.lora_scaling = lc.ALPHA / lc.RANK
            vw = bundle.clip_cfg.vision_width
            layers = bundle.clip_cfg.vision_layers
            dims = {"c_fc": (vw, 4 * vw), "c_proj": (4 * vw, vw)}
            lora = {}
            for part in LORA_PARTS:
                per_layer = [init_lora(gen, *dims[part], lc.RANK, lora_type=lc.TYPE,
                                       num_groups=self.num_groups, global_s=lc.GLOBAL_S,
                                       device=self.device)
                             for _ in range(layers)]
                lora[part] = {leaf: torch.stack([p[leaf] for p in per_layer])
                              for leaf in per_layer[0]}
            trainable["image_encoder_lora"] = lora

        self.trainable = trainable
        self.frozen = bundle.params
        for p in self._trainable_leaves():
            p.requires_grad_(True)

        self.lr_sched = build_lr_scheduler(cfg.OPTIM)
        # start at the schedule's epoch-0 LR (warmup)
        self.optimizer = build_optimizer(self._trainable_leaves(), cfg.OPTIM, self.lr_sched.lr(0))
        single = bool(getattr(lc, "SINGLE_OPT_STEP", False))
        self.opt_steps_per_batch = 1 if single or not lc.UNFREEZE_IMAGE_ENCODER else 2
        self.lr_step_multiplier = self.opt_steps_per_batch

    def _trainable_leaves(self):
        out = [self.trainable["prompt_learner"]["ctx"]]
        lora = self.trainable.get("image_encoder_lora")
        if lora is not None:
            out += [lora[part][leaf] for part in LORA_PARTS for leaf in sorted(lora[part])]
        return out

    # ------------------------------------------------------------- forward
    def _preprocess(self, image):
        """/255 then CLIP mean/std (CustomCLIP.forward, GLP_OT_SVLoRA.py:677-693)."""
        cfg = self.cfg
        mean = torch.tensor(cfg.INPUT.PIXEL_MEAN, device=self.device).reshape(1, -1, 1, 1)
        std = torch.tensor(cfg.INPUT.PIXEL_STD, device=self.device).reshape(1, -1, 1, 1)
        return (image.float() / 255.0 - mean) / std

    def _forward(self, image, attr):
        """CustomCLIP forward (GLP_OT_SVLoRA.py:677-757) -> logits [b, n_cls]."""
        policy = self.policy
        x = self._preprocess(image)
        lora = self.trainable.get("image_encoder_lora")
        attr_mix = None
        if lora is not None:
            batch = x.shape[0] if attr is None else attr.shape[0]
            attr_mix = group_mix(attr, self.num_groups, batch, device=self.device)
        tokens = vit_encode(self.frozen["visual"], x, self.bundle.clip_cfg, policy,
                            return_tokens=True, lora=lora, attr_mix=attr_mix,
                            lora_scaling=self.lora_scaling)  # [B, 1+M, d]
        image_feats = l2_normalize(tokens[:, 1:])  # [B, M, d]
        b, m, d = image_feats.shape

        ctx = self.trainable["prompt_learner"]["ctx"].to(policy.compute_dtype)
        prompts = assemble_prompts(ctx, self.prompt_state)
        text_feats = text_encode(self.frozen, prompts, self.prompt_state.eot_indices,
                                 self.bundle.clip_cfg, policy)
        text_feats = l2_normalize(text_feats.reshape(self.N, self.n_cls, d))

        # patch-prompt cosine similarity in fp32: [B, M, N, n_cls]
        sim = torch.einsum("bmd,ncd->bmnc", image_feats.float(), text_feats.float())
        sim = sim.permute(0, 3, 1, 2).reshape(b * self.n_cls, m, self.N)
        sim_op = sim.mean((1, 2)).reshape(image.shape[0], -1, self.n_cls).mean(1)  # OT = None
        return self.frozen["logit_scale"].float().exp() * sim_op

    def _loss(self, logits, label, attr):
        loss = cross_entropy(logits, label)
        lam = self.cfg.TRAINER.LAMBDA_FAIRNESS
        if not self.disable_attr and lam != 0.0:
            diff = bool(getattr(self.cfg.TRAINER.GLP_OT_LORA, "DIFFERENTIABLE_FAIRNESS", False))
            loss = loss + lam * fairness_confidence_loss(logits, label, attr, self.num_groups,
                                                         differentiable=diff)
        return loss

    # ------------------------------------------------------------- hot loop
    def forward_backward(self, batch):
        image, label, _, tgt_attr = self.parse_batch_train(batch)
        logits = self._forward(image, tgt_attr)
        loss = self._loss(logits, label, tgt_attr)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for _ in range(self.opt_steps_per_batch):
            self.optimizer.step()

        with torch.no_grad():  # one host fetch: [loss, acc, probs, labels]
            probs = torch.softmax(logits.detach().float(), -1)
            m = torch.cat([loss.detach().float()[None],
                           accuracy_from_logits(logits.detach(), label)[None],
                           probs.ravel(), label.float()]).cpu().numpy()
        loss_v, acc = float(m[0]), float(m[1])
        self.detect_anomaly(loss_v)
        loss_summary = {"loss": loss_v, "acc": acc}
        n = label.shape[0]
        label_h = m[2 + n * self.n_cls:].astype(np.int64)
        if len(set(label_h.tolist())) == 1:
            loss_summary["auc"] = 1
        else:
            loss_summary["auc"] = eval_metrics.compute_auc(
                m[2:2 + n * self.n_cls].reshape(n, self.n_cls), label_h, num_classes=self.n_cls)

        if (self.batch_idx + 1) == self.num_batches:
            self.update_lr()
            set_learning_rate(self.optimizer, self.get_current_lr())
        return loss_summary

    def _to_device(self, x):
        """A batch array (numpy, or a tensor from ``prefetch_to_device``) on
        the trainer's device."""
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def _target_attr(self, attrs):
        if self.disable_attr:
            return None
        idx = list(self.cfg.DATASET.ATTRIBUTES).index(self.cfg.DATASET.ATTRIBUTE_TYPE)
        return self._to_device(attrs[:, idx])

    def parse_batch_train(self, batch):
        attrs = batch["attrs"]
        return (self._to_device(batch["img"]), self._to_device(batch["label"]), attrs,
                self._target_attr(attrs))

    def parse_batch_test(self, batch):
        attrs = batch["attrs"]
        return self._to_device(batch["img"]), batch["label"], attrs, self._target_attr(attrs)

    @torch.no_grad()
    def model_inference(self, inp, attr=None):
        return self._forward(inp, attr).float()

    # ------------------------------------------------------------- weights
    def state_dict(self):
        """Flat numpy dict with reference-style keys; LoRA leaves unstacked to
        ``image_encoder.transformer.resblocks.{i}.mlp.{c_fc,c_proj}.{lora_*}.weight``
        so lora_S keeps its [num_groups, rank] shape for the group-weighted
        FedAvg predicate."""
        out = {"prompt_learner.ctx": _host_copy(self.trainable["prompt_learner"]["ctx"])}
        lora = self.trainable.get("image_encoder_lora")
        if lora is not None:
            for part in LORA_PARTS:
                for leaf, arr in lora[part].items():
                    host = _host_copy(arr)
                    for i in range(host.shape[0]):
                        out[_lora_key(i, part, leaf)] = host[i]
        return out

    def named_parameters(self):
        """Every parameter (frozen and trainable) under dotted names, the
        keys of the JAX trainer's: the CLI's count_parameters tables
        (utils/fed_utils.py:103) read them."""
        out = {}

        def flatten(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    flatten(v, f"{prefix}.{k}")
                else:
                    out[f"{prefix}.{k}"] = v

        flatten(self.frozen["visual"], "image_encoder")
        flatten(self.frozen["text"], "text_encoder")
        out.update(self.state_dict())
        return out

    @torch.no_grad()
    def load_state_dict(self, state, strict=False):
        """Copies the given entries into the trainable tensors in place (the
        optimizer keeps its momentum, as the JAX package's opt state does)."""
        ctx = self.trainable["prompt_learner"]["ctx"]
        if "prompt_learner.ctx" in state:
            ctx.copy_(torch.as_tensor(np.asarray(state["prompt_learner.ctx"])))
        lora = self.trainable.get("image_encoder_lora")
        if lora is None:
            return
        layers = self.bundle.clip_cfg.vision_layers
        for part in LORA_PARTS:
            for leaf, arr in lora[part].items():
                keys = [_lora_key(i, part, leaf) for i in range(layers)]
                if all(k in state for k in keys):
                    arr.copy_(torch.as_tensor(np.stack([np.asarray(state[k]) for k in keys])))
                elif strict:
                    missing = [k for k in keys if k not in state]
                    raise KeyError(f"Missing keys: {missing[:3]}...")
