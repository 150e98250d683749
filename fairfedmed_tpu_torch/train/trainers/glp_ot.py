"""GLP-OT and FairLoRA (GLP_OT_SVLoRA) method trainers.

Port of ``fairfedmed_tpu/train/trainers/glp_ot.py`` (reference
trainers/GLP_OT.py:390-568 and trainers/GLP_OT_SVLoRA.py:575-1054): CLIP
with a multi-prompt learner, optional Sinkhorn or COT optimal transport
between image patch tokens and prompts, and, in GLP_OT_SVLoRA, LoRA /
SVLoRA / FairLoRA adapters on the image tower whose singular values blend by
the sample's demographic group.  The three backbones (ViT, ModifiedResNet,
EVA02) and both input kinds (2D images; 3D OCT volumes, cut into slices of
``DIM_PER_3D_SLICE`` B-scans that a trainable 5x5 conv projects to 3
channels) run on the medical datasets (FairFedMed, FedChexMimic), and 2D on
CIFAR-10/100, whose uint8 NHWC batches are normalised and resized on the
device inside the step (``data/transforms.py:CifarPreprocess``).

Each batch runs one forward and backward and then steps the optimizer
TWICE on the same gradients when the image encoder is unfrozen: the
reference registers prompt_learner and image_encoder with one shared
optimizer and Dassl steps once per registered name (GLP_OT_SVLoRA.py:
868-881, trainer.py:333-342).  TRAINER.GLP_OT_LORA.SINGLE_OPT_STEP opts out,
as in the JAX package.

An OT plan that is not finite skips the whole optimizer step (parameters,
momentum and weight decay stay as they were; the reference returns None
from forward and never steps, GLP_OT_SVLoRA.py:738-743) and reports a NaN
loss.  The step's one host fetch, which carries the validity flag, sits
between the backward and the optimizer steps.  ResNet BatchNorm running
statistics move on every training forward, valid or not, as torch's
buffers do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ...adapters.lora import group_mix, init_lora
from ...core.pytree import flatten_paths, unflatten_like
from ...data.transforms import device_preprocess
from ...evaluation import metrics as eval_metrics
from ...fed.dist import all_reduce_sum
from ...models import eva_clip
from ...models.clip_model import l2_normalize, pool_index, text_encode
from ...models.prompt_learner import assemble_prompts, init_prompt_learner
from ...ops.sinkhorn import entropic_cot, sinkhorn
from ...utils.profiling import span, stamp
from ...utils.registry import DATASET_REGISTRY, TRAINER_REGISTRY
from ..clip_common import (accuracy_from_logits, cross_entropy, encode_image,
                           fairness_confidence_loss, fedprox_term, load_clip_bundle)
from ..engine import TrainerX
from ..optim import FunctionalOptimizer, build_lr_scheduler, build_optimizer, set_learning_rate

MEDICAL_DATASETS = ("FairFedMed", "FedChexMimic", "WangGrant")
MODALITY_3D = ("oct_bscans", "oct_bscans_3d", "mac_onh", "onh_mac")
OT_METHODS = ("None", "Sinkhorn", "COT")

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
# the transformer towers' adapted MLP products, stacked per layer
LORA_PARTS = {"vit": ("c_fc", "c_proj"), "eva": eva_clip.LORA_PARTS}
ATTNPOOL_PROJ = ("q_proj", "k_proj", "v_proj", "c_proj")
BN_STATS = "__bn_stats__"  # the ResNet running statistics in a client's parallel state


def _host_copies(named: dict) -> dict:
    """``{key: numpy copy}`` of fp32 tensors in one device-to-host transfer.
    The copies never alias the live tensors (``.cpu()`` of a CPU tensor is
    the tensor itself; ``torch.cat`` makes new storage)."""
    tensors = [t.detach().float().reshape(-1) for t in named.values()]
    flat = torch.cat(tensors).cpu().numpy() if tensors else np.zeros(0, np.float32)
    out, offset = {}, 0
    for key, t in named.items():
        out[key] = flat[offset:offset + t.numel()].reshape(tuple(t.shape)).copy()
        offset += t.numel()
    return out


def _leaves(tree) -> list:
    return list(flatten_paths(tree).values())


def _lora_key(kind: str, i: int, part: str, leaf: str) -> str:
    """A stacked adapter leaf's reference key, layer ``i``: the ViT's
    ``transformer.resblocks``, EVA02's ``blocks`` (``eva_vit_model.py``)."""
    blocks = "blocks" if kind == "eva" else "transformer.resblocks"
    return f"image_encoder.{blocks}.{i}.mlp.{part}.{leaf}.weight"


def _stat_key(path: str) -> str:
    """``layer1.0.bn1.mean`` -> ``image_encoder.layer1.0.bn1.running_mean``."""
    node, leaf = path.rsplit(".", 1)
    return f"image_encoder.{node}.running_{leaf}"


def check_dataset(cfg):
    """Raise for a dataset name that is not registered (the port registers
    every dataset of the JAX package)."""
    from ...data import datasets  # noqa: F401  (registers the datasets)

    DATASET_REGISTRY.get(cfg.DATASET.NAME)


class GLPOTBase(TrainerX):
    """Shared machinery; GLP_OT sets ``use_lora = False``, GLP_OT_SVLoRA
    ``True``."""

    use_lora = False

    def check_cfg(self, cfg):
        t = cfg.TRAINER.GLP_OT
        if t.PREC not in ("fp16", "fp32", "amp"):
            raise ValueError(f"PREC must be fp16/fp32/amp, got {t.PREC}")
        if t.OT not in OT_METHODS:
            raise NotImplementedError(f"OT={t.OT} (one of {OT_METHODS})")
        check_dataset(cfg)

    # ------------------------------------------------------------- build
    def build_model(self):
        cfg = self.cfg
        t = cfg.TRAINER.GLP_OT
        lc = cfg.TRAINER.GLP_OT_LORA
        bundle = load_clip_bundle(cfg, t.PREC, self.device)
        self.bundle = bundle
        self.policy = bundle.policy
        self.backbone_type = bundle.backbone_type
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
        stamp("build:clip_bundle_done")
        pl_params, self.prompt_state = init_prompt_learner(
            gen, classnames, bundle.params["text"]["token_embedding"], bundle.clip_cfg,
            n_ctx=t.N_CTX, n_prompts=t.N, ctx_init=t.CTX_INIT, csc=t.CSC,
            class_token_position=t.CLASS_TOKEN_POSITION)
        stamp("build:prompt_learner_done")
        trainable = {"prompt_learner": pl_params}

        # Without LoRA, UNFREEZE_IMAGE_ENCODER trains the ViT's ln_pre, the
        # only image-encoder parameter the reference hands the optimizer
        # (GLP_OT.py:414-426,444-453); EVA02 has no ln_pre to train.
        # UNFREEZE_TEXT_ENCODER is a no-op there (no text parameter reaches
        # the optimizer), and here.
        if lc.UNFREEZE_IMAGE_ENCODER and not self.use_lora and self.backbone_type == "eva":
            raise NotImplementedError("GLP_OT's UNFREEZE_IMAGE_ENCODER trains the image tower's "
                                      "ln_pre, which EVA02 does not have")
        if lc.UNFREEZE_IMAGE_ENCODER and not self.use_lora and self.backbone_type == "vit":
            trainable["visual_ln_pre"] = {k: v.detach().float().clone()
                                          for k, v in bundle.params["visual"]["ln_pre"].items()}

        # demographic groups: only GLP_OT_SVLoRA reads them
        self.disable_attr = bool(lc.DISABLE_ATTR) if self.use_lora else True
        if self.use_lora and not lc.DISABLE_ATTR and cfg.DATASET.NAME in GROUP_TABLES:
            self.num_groups = len(GROUP_TABLES[cfg.DATASET.NAME][cfg.DATASET.ATTRIBUTE_TYPE])
            self.disable_attr = False
        else:
            self.num_groups = 1

        # ResNet BatchNorm: affine trainable only in GLP_OT_SVLoRA
        # (GLP_OT_SVLoRA.py:825-827; GLP_OT keeps it frozen, GLP_OT.py:416-429);
        # the running statistics are the trainer's, updated by each forward
        self.stats = bundle.visual_stats if self.backbone_type == "resnet" else {}
        if self.backbone_type == "resnet":
            if self.use_lora:
                trainable["visual_bn"] = bundle.visual_bn
            else:
                bundle.params["visual_bn"] = bundle.visual_bn

        # adapters (apply_lora_to_model, GLP_OT_SVLoRA.py:503-573): ViT, every
        # resblock's mlp.c_fc / mlp.c_proj, stacked per layer; EVA02 the same
        # on its SwiGLU's mlp.w1 / w2 / w3; ResNet, every bottleneck's 1x1
        # conv1 / conv3 (FairLoRA) and the attnpool projections (plain LoRA)
        self.lora_scaling = 0.0
        if self.use_lora and lc.UNFREEZE_IMAGE_ENCODER:
            self.lora_scaling = lc.ALPHA / lc.RANK

            def adapter(din, dout, lora_type=lc.TYPE):
                return init_lora(gen, din, dout, lc.RANK, lora_type=lora_type,
                                 num_groups=self.num_groups, global_s=lc.GLOBAL_S,
                                 device=self.device)

            if self.backbone_type in LORA_PARTS:
                vw = bundle.clip_cfg.vision_width
                if self.backbone_type == "vit":
                    dims = {"c_fc": (vw, 4 * vw), "c_proj": (4 * vw, vw)}
                else:
                    hidden = bundle.eva_cfg.mlp_hidden
                    dims = {"w1": (vw, hidden), "w2": (vw, hidden), "w3": (hidden, vw)}
                lora = {}
                for part in LORA_PARTS[self.backbone_type]:
                    per_layer = [adapter(*dims[part])
                                 for _ in range(bundle.clip_cfg.vision_layers)]
                    lora[part] = {leaf: torch.stack([p[leaf] for p in per_layer])
                                  for leaf in per_layer[0]}
                trainable["image_encoder_lora"] = lora
            elif self.backbone_type == "resnet":
                rn = bundle.rn_cfg
                lora, inplanes = {}, rn.width
                for li, nblocks in enumerate(rn.layers):
                    planes = rn.width * (2 ** li)
                    blocks = []
                    for _ in range(nblocks):
                        blocks.append({"conv1": adapter(inplanes, planes),
                                       "conv3": adapter(planes, planes * 4)})
                        inplanes = planes * 4
                    lora[f"layer{li + 1}"] = blocks
                trainable["image_encoder_lora"] = lora
                ed = rn.embed_dim
                trainable["attnpool_lora"] = {
                    name: adapter(ed, rn.output_dim if name == "c_proj" else ed, "LoRA")
                    for name in ATTNPOOL_PROJ}
            else:
                raise ValueError(f"no adapters for backbone type {self.backbone_type!r}")

        stamp("build:lora_init_done")
        # 3D slice projector (GLP_OT_SVLoRA.py:584-595)
        self.is_3d_input = cfg.DATASET.MODALITY_TYPE in MODALITY_3D
        if self.is_3d_input:
            d = self.dim_per_3d_slice = cfg.DATASET.DIM_PER_3D_SLICE
            trainable["proj_per_3d_slice"] = {
                "weight": (torch.randn((3, d, 5, 5), generator=gen) * d ** -0.5).to(self.device),
                "bias": torch.zeros(3, device=self.device),
            }

        self.trainable = trainable
        self.frozen = bundle.params
        self.ot_iterations = None  # the last forward's solver iterations (a tensor)
        for p in _leaves(self.trainable):
            p.requires_grad_(True)

        # device constants, made once: a copy from the host inside a step
        # would synchronise with the device
        self._pixel_mean = torch.tensor(cfg.INPUT.PIXEL_MEAN).reshape(1, -1, 1, 1).to(self.device)
        self._pixel_std = torch.tensor(cfg.INPUT.PIXEL_STD).reshape(1, -1, 1, 1).to(self.device)
        self._cifar = device_preprocess(cfg, self.device)
        self._eot_pool = pool_index(self.prompt_state.eot_indices, self.device)

        self.lr_sched = build_lr_scheduler(cfg.OPTIM)
        # start at the schedule's epoch-0 LR (warmup)
        self.optimizer = build_optimizer(_leaves(self.trainable), cfg.OPTIM, self.lr_sched.lr(0))
        stamp("build:opt_init_done")
        self.parallel_optimizer = FunctionalOptimizer(cfg.OPTIM)
        single = bool(getattr(lc, "SINGLE_OPT_STEP", False))
        self.opt_steps_per_batch = 1 if single or not lc.UNFREEZE_IMAGE_ENCODER else 2
        self.lr_step_multiplier = self.opt_steps_per_batch

    # ------------------------------------------------------------- forward
    def _preprocess(self, image, trainable):
        """CustomCLIP.forward's head (GLP_OT_SVLoRA.py:677-693): /255, for 3D
        volumes the slice projector and a per-slice min-max, then the CLIP
        mean/std.  The projector's /255 is folded into its (tiny) weight; the
        conv runs in the compute type, the bias and min-max in fp32.  CIFAR
        batches take ``CifarPreprocess`` instead (JAX glp_ot.py:295-303);
        the other datasets' batches come normalised from the host transforms
        and pass unchanged (JAX glp_ot.py:265-303)."""
        if self._cifar is not None:
            return self._cifar(image)
        x = image.float()
        if self.cfg.DATASET.NAME not in MEDICAL_DATASETS:
            return x
        if self.is_3d_input:
            _, _, h, w = x.shape
            x = x.reshape(-1, self.dim_per_3d_slice, h, w)  # volume v -> rows v*S .. v*S+S-1
            p = trainable["proj_per_3d_slice"]
            dt = self.policy.compute_dtype
            x = F.conv2d(x.to(dt), (p["weight"] / 255.0).to(dt), padding=2).float() \
                + p["bias"].reshape(1, -1, 1, 1)
            mn = x.amin(dim=(1, 2, 3), keepdim=True)
            mx = x.amax(dim=(1, 2, 3), keepdim=True)
            x = (x - mn) / (mx - mn + 1e-5)
        else:
            x = x / 255.0
        return (x - self._pixel_mean) / self._pixel_std

    def _forward(self, image, attr, train, trainable=None, stats=None):
        """CustomCLIP forward (GLP_OT_SVLoRA.py:677-757) under ``trainable``
        and the BatchNorm statistics ``stats`` (default: the trainer's own).
        Returns (logits [b, n_cls], the OT plan's validity as a tensor or
        None, new BN statistics)."""
        cfg_t = self.cfg.TRAINER.GLP_OT
        policy = self.policy
        trainable = self.trainable if trainable is None else trainable
        stats = self.stats if stats is None else stats
        visual = self.frozen["visual"]
        if "visual_ln_pre" in trainable:  # the trainable override (GLP_OT.py:414-426)
            visual = {**visual, "ln_pre": trainable["visual_ln_pre"]}
        x = self._preprocess(image, trainable)  # [B', 3, H, W]; B' = b * slices for 3D volumes

        lora = trainable.get("image_encoder_lora")
        attr_mix = None
        if lora is not None:
            # per volume when attrs exist; the adapters repeat it over slices
            batch = x.shape[0] if attr is None else attr.shape[0]
            attr_mix = group_mix(attr, self.num_groups, batch, device=self.device)

        # the JAX package runs a ViT slice batch in chunks of b rows (a TPU
        # schedule); every row is independent, so one pass gives the same tokens
        tokens, new_stats = encode_image(
            self.bundle, visual, x, return_tokens=True, lora=lora, attr_mix=attr_mix,
            lora_scaling=self.lora_scaling,
            bn=trainable.get("visual_bn", self.frozen.get("visual_bn")), stats=stats,
            train=train, attnpool_lora=trainable.get("attnpool_lora"))
        image_feats = l2_normalize(tokens[:, 1:])  # [B', M, d]
        bp, m, d = image_feats.shape

        ctx = trainable["prompt_learner"]["ctx"].to(policy.compute_dtype)
        prompts = assemble_prompts(ctx, self.prompt_state)
        text_feats = text_encode(self.frozen, prompts, self.prompt_state.eot_indices,
                                 self.bundle.clip_cfg, policy, pool=self._eot_pool)
        text_feats = l2_normalize(text_feats.reshape(self.N, self.n_cls, d))

        # patch-prompt cosine similarity in fp32: [B', M, N, n_cls] -> [B'*n_cls, M, N]
        sim = torch.einsum("bmd,ncd->bmnc", image_feats.float(), text_feats.float())
        sim = sim.permute(0, 3, 1, 2).reshape(bp * self.n_cls, m, self.N)

        valid = None
        if cfg_t.OT == "None":
            sim_op = sim.mean((1, 2))
        else:
            rows = sim.shape[0]
            xx = torch.full((rows, m), 1.0 / m, device=sim.device)
            yy = torch.full((rows, self.N), 1.0 / self.N, device=sim.device)
            kernel = torch.exp(-(1.0 - sim.detach()) / cfg_t.EPS)
            if cfg_t.OT == "Sinkhorn":
                plan, valid, self.ot_iterations = sinkhorn(
                    kernel, xx, yy, thresh=cfg_t.THRESH, max_iter=cfg_t.MAX_ITER)
            else:
                # the reference caps the kept mass at sum(xx), the number of
                # rows, not at 1.0 (GLP_OT_SVLoRA.py:726)
                plan, valid, self.ot_iterations = entropic_cot(
                    kernel, xx, yy * min(float(rows), cfg_t.TOP_PERCENT),
                    max_iter=cfg_t.MAX_ITER, thresh=cfg_t.THRESH)
            sim_op = (plan * sim).sum((1, 2))

        # [B'*n_cls] -> [b, slices, n_cls] -> mean over slices (GLP_OT_SVLoRA.py:753-754)
        sim_op = sim_op.reshape(image.shape[0], -1, self.n_cls).mean(1)
        return self.frozen["logit_scale"].float().exp() * sim_op, valid, new_stats

    def _task_loss(self, logits, label, attr, group=None):
        """CE plus the fairness term; ``group`` is the data group a client's
        batch is split over, whose group counts and confidence sums the term
        sums before it forms the gap."""
        loss = cross_entropy(logits, label)
        lam = self.cfg.TRAINER.LAMBDA_FAIRNESS if self.use_lora else 0.0
        if not self.disable_attr and lam != 0.0:
            diff = bool(getattr(self.cfg.TRAINER.GLP_OT_LORA, "DIFFERENTIABLE_FAIRNESS", False))
            loss = loss + lam * fairness_confidence_loss(logits, label, attr, self.num_groups,
                                                         differentiable=diff, group=group)
        return loss

    def _loss(self, logits, label, attr):
        # FedProx: an extension, as in the JAX package (the reference GLP
        # trainers take no FedProx)
        return self.with_fedprox(self._task_loss(logits, label, attr),
                                 self.trainable["prompt_learner"]["ctx"])

    # ------------------------------------------------------------- hot loop
    def forward_backward(self, batch):
        image, label, _, tgt_attr = self.parse_batch_train(batch)
        logits, valid, self.stats = self._forward(image, tgt_attr, train=True)
        loss = self._loss(logits, label, tgt_attr)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()

        # the training AUC is the medical datasets' only (JAX glp_ot.py:649)
        with_auc = self.cfg.DATASET.NAME in MEDICAL_DATASETS
        with torch.no_grad():  # one host fetch: [loss, valid, acc(, probs, labels)]
            ok = torch.ones((), device=self.device) if valid is None else valid.float()
            parts = [loss.detach().float()[None], ok[None],
                     accuracy_from_logits(logits.detach(), label)[None]]
            if with_auc:
                parts += [torch.softmax(logits.detach().float(), -1).ravel(), label.float()]
            m = torch.cat(parts).cpu().numpy()
        valid_h = bool(m[1])
        if valid_h:  # an invalid plan skips the whole optimizer step
            for _ in range(self.opt_steps_per_batch):
                self.optimizer.step()
        loss_v, acc = (float(m[0]) if valid_h else float("nan")), float(m[2])
        loss_summary = {"loss": loss_v, "acc": acc}
        if valid_h:
            # a genuine NaN/Inf raises like the reference's detect_anomaly;
            # an invalid plan is the only sanctioned NaN
            self.detect_anomaly(loss_v)
        if valid_h and with_auc:
            n = label.shape[0]
            label_h = m[3 + n * self.n_cls:].astype(np.int64)
            if len(set(label_h.tolist())) == 1:
                loss_summary["auc"] = 1
            else:
                loss_summary["auc"] = eval_metrics.compute_auc(
                    m[3:3 + n * self.n_cls].reshape(n, self.n_cls), label_h,
                    num_classes=self.n_cls)

        if (self.batch_idx + 1) == self.num_batches:
            self.update_lr()
            set_learning_rate(self.optimizer, self.get_current_lr())
        return loss_summary

    def _target_attr(self, attrs):
        if self.disable_attr:
            return None
        idx = list(self.cfg.DATASET.ATTRIBUTES).index(self.cfg.DATASET.ATTRIBUTE_TYPE)
        return self._to_device(attrs[:, idx])

    def parse_batch_train(self, batch):
        image, label = self._to_device(batch["img"]), self._to_device(batch["label"])
        if self.cfg.DATASET.NAME not in MEDICAL_DATASETS:  # no attributes (CIFAR)
            return image, label, None, None
        attrs = batch["attrs"]
        return image, label, attrs, self._target_attr(attrs)

    def parse_batch_test(self, batch):
        image = self._to_device(batch["img"])
        if self.cfg.DATASET.NAME not in MEDICAL_DATASETS:
            return image, batch["label"], None, None
        attrs = batch["attrs"]
        return image, batch["label"], attrs, self._target_attr(attrs)

    @torch.no_grad()
    def model_inference(self, inp, attr=None):
        return self._forward(inp, attr, train=False)[0].float()

    # ------------------------------------------------------------- client-parallel rounds
    def _parallel_tree(self):
        if self.backbone_type == "resnet":
            return {**self.trainable, BN_STATS: self.stats}
        return self.trainable

    def parallel_trainable(self) -> dict:
        """What the client-parallel runner keeps per client, as a flat
        ``{path: tensor}`` dict (JAX ``parallel_trainable``): the trainable
        tree and, on ResNet, the BatchNorm running statistics under
        ``__bn_stats__``, so each client's statistics stay its own and
        aggregate with its state."""
        return {k: v.detach() for k, v in flatten_paths(self._parallel_tree()).items()}

    def parallel_opt_state(self) -> dict:
        """A fresh ``parallel_optimizer`` state over the trainable tree."""
        return self.parallel_optimizer.init(
            {k: v.detach() for k, v in flatten_paths(self.trainable).items()})

    @torch.no_grad()
    def adopt_parallel_trainable(self, flat: dict):
        """Copy one client's ``parallel_trainable`` state into the trainer's
        own tensors (for evaluation and the final save)."""
        for k, t in flatten_paths(self._parallel_tree()).items():
            t.copy_(flat[k])

    def _unflatten(self, flat: dict):
        tree = unflatten_like(self._parallel_tree(), flat)
        stats = tree.pop(BN_STATS, {}) if self.backbone_type == "resnet" else self.stats
        return tree, stats

    @property
    def supports_data_axis(self) -> bool:
        """ResNet BatchNorm batch statistics would be per data shard; a
        within-client data split would change them (JAX glp_ot.py:586-589).
        The transformer towers have no batch statistics."""
        return self.backbone_type in ("vit", "eva")

    @property
    def parallel_step_graphable(self) -> bool:
        """Whether the parallel local step may be captured in a CUDA graph
        (``fed/parallel_driver.py:graphs_step``): it makes no host
        synchronisation and its shapes follow the batch's.  True without
        OT; the solvers' steps stay eager."""
        return self.cfg.TRAINER.GLP_OT.OT == "None"

    def make_parallel_local_step(self, fedprox_mu=None, data_group=None):
        """One client's step for the client-parallel round (JAX
        ``make_parallel_local_step``, glp_ot.py:483-546):
        ``local_step(params, opt_state, batch, lr, ctx_global) -> (params,
        opt_state, metrics)`` over flat dicts (``parallel_trainable``,
        ``parallel_optimizer.init``), returning new tensors.  The optimizer
        steps ``opt_steps_per_batch`` times on one gradient; where the OT
        plan is invalid the parameters and the optimizer state keep their
        old values by ``torch.where``, with no host fetch.  ResNet running
        statistics take the forward's, valid or not.  ``metrics`` stays on
        the device: [loss * valid, valid, acc * valid].  With ``fedprox_mu``
        the loss adds the FedProx term toward ``ctx_global``, the round's
        global context.  With ``data_group`` (the ranks a client's batch is
        split over) the gradients, loss and accuracy are averaged over the
        group in one ``all_reduce``, the plan is valid only where it is
        valid on every rank, and the fairness term sums its group statistics
        over the group first (JAX glp_ot.py:462-467, :525-529)."""
        if self.backbone_type == "resnet" and data_group is not None:
            raise NotImplementedError("ResNet parallel rounds do not split the within-client batch")
        opt, n_opt = self.parallel_optimizer, self.opt_steps_per_batch
        n_data = dist.get_world_size(data_group) if data_group is not None else 1
        differentiable = bool(getattr(self.cfg.TRAINER, "DIFFERENTIABLE_FEDPROX", False))

        def local_step(params, opt_state, batch, lr, ctx_global=None):
            with span("step.forward"):
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()
                          if not k.startswith(BN_STATS)}
                tree, stats = self._unflatten({**params, **leaves})
                logits, valid, new_stats = self._forward(batch["img"], batch.get("attr"),
                                                         train=True, trainable=tree, stats=stats)
                loss = self._task_loss(logits, batch["label"], batch.get("attr"),
                                       group=data_group)
                if fedprox_mu is not None:
                    loss = loss + fedprox_term(tree["prompt_learner"]["ctx"], ctx_global,
                                               fedprox_mu, differentiable=differentiable)
            with span("step.backward"):
                grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            with torch.no_grad(), span("step.update"):
                grads = {k: torch.zeros_like(v) if g is None else g
                         for (k, v), g in zip(leaves.items(), grads)}
                loss = loss.detach().float()
                acc = accuracy_from_logits(logits.detach(), batch["label"])
                if data_group is not None:
                    ok = torch.ones_like(loss) if valid is None else valid.float()
                    *summed, stats = all_reduce_sum(
                        list(grads.values()) + [torch.stack([loss, acc, ok])], data_group)
                    grads = {k: g / n_data for k, g in zip(grads, summed)}
                    loss, acc = stats[0] / n_data, stats[1] / n_data
                    if valid is not None:  # valid on every rank of the group
                        valid = stats[2] == n_data
                old = {k: v.detach() for k, v in leaves.items()}
                new_p, new_o = old, opt_state
                for _ in range(n_opt):
                    new_p, new_o = opt.update(new_p, grads, new_o, lr)
                if valid is None:
                    metrics = torch.stack([loss, torch.ones_like(loss), acc])
                else:  # an invalid plan keeps the old parameters and optimizer state
                    new_p = {k: torch.where(valid, new_p[k], old[k]) for k in old}
                    new_o = {k: torch.where(valid, new_o[k], opt_state[k]) for k in opt_state}
                    zero = torch.zeros_like(loss)
                    metrics = torch.stack([torch.where(valid, loss, zero), valid.float(),
                                           torch.where(valid, acc, zero)])
                if self.backbone_type == "resnet":
                    new_p.update({f"{BN_STATS}.{k}": v.detach()
                                  for k, v in flatten_paths(new_stats).items()})
            return new_p, new_o, metrics

        return local_step

    def make_parallel_infer(self):
        """``infer(params, image, attr) -> logits`` under one client's flat
        state (JAX ``make_parallel_infer``): ResNet evaluates with the
        client's own running statistics."""

        @torch.no_grad()
        def infer(params, image, attr):
            tree, stats = self._unflatten(params)
            return self._forward(image, attr, train=False, trainable=tree, stats=stats)[0].float()

        return infer

    # ------------------------------------------------------------- weights
    def _named_state(self) -> dict:
        """The trainable state (and BN statistics) as live tensors under the
        reference's keys, ViT and EVA02 LoRA still stacked per layer."""
        tr = self.trainable
        out = {"prompt_learner.ctx": tr["prompt_learner"]["ctx"]}
        for name, key in (("visual_ln_pre", "image_encoder.ln_pre"),
                          ("proj_per_3d_slice", "proj_per_3d_slice")):
            if name in tr:
                out[f"{key}.weight"], out[f"{key}.bias"] = tr[name]["weight"], tr[name]["bias"]
        lora = tr.get("image_encoder_lora")
        if lora is not None and self.backbone_type == "resnet":
            for path, t in flatten_paths(lora).items():
                out[f"image_encoder.{path}.weight"] = t
        for path, t in flatten_paths(tr.get("attnpool_lora", {})).items():
            out[f"image_encoder.attnpool.{path}.weight"] = t
        if self.backbone_type == "resnet":
            # BN affine and running statistics both travel in the federated
            # state, as in save_model_with_grad (trainer.py:177-186)
            for path, t in flatten_paths(tr.get("visual_bn", self.frozen.get("visual_bn"))).items():
                out[f"image_encoder.{path}"] = t
            for path, t in flatten_paths(self.stats).items():
                out[_stat_key(path)] = t
        return out

    def state_dict(self):
        """Flat numpy dict with reference-style keys; ViT LoRA leaves unstacked
        to ``image_encoder.transformer.resblocks.{i}.mlp.{c_fc,c_proj}.{lora_*}.weight``
        (EVA02: ``image_encoder.blocks.{i}.mlp.{w1,w2,w3}.{lora_*}.weight``)
        so lora_S keeps its [num_groups, rank] shape for the group-weighted
        FedAvg predicate."""
        named = self._named_state()
        lora = self.trainable.get("image_encoder_lora")
        kind = self.backbone_type
        if lora is not None and kind in LORA_PARTS:
            for part in LORA_PARTS[kind]:
                for leaf, arr in lora[part].items():
                    named[f"__stacked__.{part}.{leaf}"] = arr
        out = {}
        for key, arr in _host_copies(named).items():
            if key.startswith("__stacked__."):
                _, part, leaf = key.split(".", 2)
                for i in range(arr.shape[0]):
                    out[_lora_key(kind, i, part, leaf)] = arr[i]
            else:
                out[key] = arr
        return out

    def named_parameters(self):
        """Every parameter (frozen and trainable) under dotted names, the
        keys of the JAX trainer's: the CLI's count_parameters tables
        (utils/fed_utils.py:103) read them."""
        out = flatten_paths({"image_encoder": self.frozen["visual"],
                             "text_encoder": self.frozen["text"]})
        out.update(self.state_dict())
        return out

    @torch.no_grad()
    def load_state_dict(self, state, strict=False):
        """Copies the given entries into the trainable tensors (and BN
        statistics) in place; the optimizer keeps its momentum, as the JAX
        package's opt state does.  ``strict`` raises on a missing key."""
        targets = self._named_state()
        lora = self.trainable.get("image_encoder_lora")
        kind = self.backbone_type
        if lora is not None and kind in LORA_PARTS:
            for part in LORA_PARTS[kind]:
                for leaf, arr in lora[part].items():
                    for i in range(arr.shape[0]):
                        targets[_lora_key(kind, i, part, leaf)] = arr[i]
        missing = [k for k in targets if k not in state]
        if strict and missing:
            raise KeyError(f"Missing keys: {missing[:3]}...")
        for key, t in targets.items():
            if key in state:
                t.copy_(torch.as_tensor(np.asarray(state[key])))


@TRAINER_REGISTRY.register()
class GLP_OT(GLPOTBase):
    """Prompt-only GLP-OT (trainers/GLP_OT.py:390-568)."""

    use_lora = False


@TRAINER_REGISTRY.register()
class GLP_OT_SVLoRA(GLPOTBase):
    """FairLoRA: GLP-OT + grouped low-rank adapters
    (trainers/GLP_OT_SVLoRA.py:767-1054)."""

    use_lora = True
