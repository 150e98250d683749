"""Plain PyTorch reference of the measured FairLoRA method: CLIP (ViT or
ModifiedResNet image tower, the text transformer) read straight from an
OpenAI-layout state dict, the multi-prompt learner, FairLoRA adapters whose
singular values blend by the sample's demographic group, the loss, SGD and
the EMA aggregation.

It follows the published descriptions (Radford et al. 2021, arXiv:2103.00020,
and OpenAI's ``clip/model.py``; FairFedMed's ``GLP_OT_SVLoRA`` trainer with
OT None; Dassl's SGD) and imports nothing of the program under test.  Every
product runs in float32 with TF32 off, computed the plain way: the patch
embedding as a strided convolution, attention as softmax(Q K^T / sqrt(d)) V
over all 77 text positions under the causal mask, the patch-prompt score as
the dot product of the mean patch feature and the mean prompt feature.

``prec="fp8"`` is the control: every input and every output of a matrix
product or convolution (activations and weights) is rounded to float8 e4m3
with one scale per tensor, as the program at bfloat16 rounds them to
bfloat16; the product itself sums in float32; gradients pass the rounding
unrounded, as a scaled float8 backward keeps them.

Trainable state is a flat ``{name: tensor}`` dict under the names the
program's client state uses (``prompt_learner.ctx``,
``image_encoder_lora.<part>.lora_{A,S,B}``, ``attnpool_lora.*``,
``visual_bn.*``, ``__bn_stats__.*``); the reference reads those names to
judge the program's state and computes everything else itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .tokenizer import tokenize

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)  # OpenAI CLIP's preprocessing
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
OWN_GROUP = 0.7  # FairLoRA: weight of the sample's own group in its singular values
BN_MOMENTUM, BN_EPS, LN_EPS = 0.1, 1e-5, 1e-5
FP8_MAX = 448.0  # largest finite float8 e4m3


class Numerics:
    """Where the precision of a product is decided."""

    def __init__(self, prec: str = "fp32"):
        if prec not in ("fp32", "fp8"):
            raise ValueError(f"reference precision is fp32 or fp8, got {prec!r}")
        self.prec = prec

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` rounded to the product's input type; the gradient passes
        through unrounded (a scaled float8 backward keeps it)."""
        if self.prec == "fp32":
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        rounded = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (rounded - t.detach())

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def mm(self, a, b):
        return self.q(self.q(a) @ self.q(b))

    def conv(self, x, w, stride=1, padding=0):
        return self.q(F.conv2d(self.q(x), self.q(w), stride=stride, padding=padding))


def normalize(x):
    return x / x.norm(dim=-1, keepdim=True)


def group_mix(attr: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, G]: 0.7 on the sample's group, the rest shared evenly."""
    mix = torch.full((attr.shape[0], groups), (1.0 - OWN_GROUP) / (groups - 1),
                     device=attr.device)
    mix[torch.arange(attr.shape[0], device=attr.device), attr.long()] = OWN_GROUP
    return mix


class ReferenceCLIP:
    """CLIP with prompts and FairLoRA over an OpenAI state dict (fp32 on the
    device).  ``method``: the configuration's method block."""

    def __init__(self, sd: dict, classnames, method: dict, device, prec: str = "fp32"):
        self.sd = {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()
                   if torch.is_tensor(v) and v.is_floating_point()}
        self.num = Numerics(prec)
        self.device = device
        self.kind = "vit" if "visual.proj" in self.sd else "resnet"
        self.n_ctx, self.n_prompts = method["n_ctx"], method["num_prompt"]
        self.groups = method["groups"]
        self.scaling = method["lora_alpha"] / method["lora_rank"]
        self.n_cls = len(classnames)
        ids = tokenize([f"{' '.join(['X'] * self.n_ctx)} {c}." for c in classnames])
        ids = np.tile(ids, (self.n_prompts, 1))  # prompt-major: [N * n_cls, 77]
        self.eot = torch.as_tensor(ids.argmax(-1), device=device)
        emb = self.sd["token_embedding.weight"][torch.as_tensor(ids, device=device)]
        self.prefix, self.suffix = emb[:, :1], emb[:, 1 + self.n_ctx:]
        length = ids.shape[1]
        self.causal = torch.full((length, length), float("-inf"), device=device).triu(1)
        self.mean = torch.tensor(CLIP_MEAN, device=device).reshape(1, 3, 1, 1)
        self.std = torch.tensor(CLIP_STD, device=device).reshape(1, 3, 1, 1)

    # ------------------------------------------------------------ layers
    def layer_norm(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.sd[f"{name}.weight"], self.sd[f"{name}.bias"],
                            LN_EPS)

    def attention(self, x, name, heads, mask=None):
        b, length, d = x.shape
        qkv = self.num.linear(x, self.sd[f"{name}.in_proj_weight"], self.sd[f"{name}.in_proj_bias"])
        q, k, v = (t.reshape(b, length, heads, d // heads).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        scores = self.num.mm(q, k.transpose(-1, -2)) / math.sqrt(d // heads)
        if mask is not None:
            scores = scores + mask
        out = self.num.mm(scores.softmax(-1), v).transpose(1, 2).reshape(b, length, d)
        return self.num.linear(out, self.sd[f"{name}.out_proj.weight"],
                               self.sd[f"{name}.out_proj.bias"])

    def lora(self, x, a, s_rows, b):
        """FairLoRA delta ((x A) diag(s_b) B) * alpha / rank; ``s_rows`` [B, r]
        per sample, or None for plain LoRA."""
        h = self.num.mm(x, a)
        if s_rows is not None:
            h = h * s_rows.reshape(s_rows.shape[0], *([1] * (h.dim() - 2)), s_rows.shape[-1])
        return self.num.mm(h, b) * self.scaling

    def blocks(self, x, prefix, layers, heads, mask=None, lora=None, mix=None):
        for i in range(layers):
            name = f"{prefix}.resblocks.{i}"
            x = x + self.attention(self.layer_norm(x, f"{name}.ln_1"), f"{name}.attn", heads, mask)
            h_in = self.layer_norm(x, f"{name}.ln_2")
            h = self.num.linear(h_in, self.sd[f"{name}.mlp.c_fc.weight"], self.sd[f"{name}.mlp.c_fc.bias"])
            if lora is not None:
                h = h + self.lora(h_in, *self._lora_layer(lora, "c_fc", i, mix))
            h = h * torch.sigmoid(1.702 * h)  # QuickGELU
            y = self.num.linear(h, self.sd[f"{name}.mlp.c_proj.weight"], self.sd[f"{name}.mlp.c_proj.bias"])
            if lora is not None:
                y = y + self.lora(h, *self._lora_layer(lora, "c_proj", i, mix))
            x = x + y
        return x

    @staticmethod
    def _lora_layer(lora, part, i, mix):
        pre = f"image_encoder_lora.{part}"
        return lora[f"{pre}.lora_A"][i], mix @ lora[f"{pre}.lora_S"][i], lora[f"{pre}.lora_B"][i]

    # ------------------------------------------------------------ towers
    def text_features(self, ctx):
        """[N, n_cls, embed] unit prompt features for the context bank ctx
        [N, n_ctx, width]."""
        n, c = self.n_prompts, self.n_cls
        rows = ctx[:, None].expand(n, c, *ctx.shape[1:]).reshape(n * c, *ctx.shape[1:])
        x = torch.cat([self.prefix, rows, self.suffix], dim=1) + self.sd["positional_embedding"]
        width = x.shape[-1]
        x = self.blocks(x, "transformer", self._count("transformer.resblocks"), width // 64,
                        mask=self.causal)
        x = self.layer_norm(x, "ln_final")[torch.arange(x.shape[0], device=x.device), self.eot]
        return normalize(self.num.mm(x, self.sd["text_projection"])).reshape(n, c, -1)

    def _count(self, prefix):
        return len({k[len(prefix) + 1:].split(".")[0] for k in self.sd if k.startswith(prefix + ".")})

    def vit_tokens(self, x, state, mix):
        sd = self.sd
        width, patch = sd["visual.conv1.weight"].shape[0], sd["visual.conv1.weight"].shape[-1]
        x = self.num.conv(x, sd["visual.conv1.weight"], stride=patch)  # [B, width, g, g]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([sd["visual.class_embedding"].expand(x.shape[0], 1, width), x], dim=1)
        x = self.layer_norm(x + sd["visual.positional_embedding"], "visual.ln_pre")
        x = self.blocks(x, "visual.transformer", self._count("visual.transformer.resblocks"),
                        width // 64, lora=state, mix=mix)
        return self.num.mm(self.layer_norm(x, "visual.ln_post"), sd["visual.proj"])

    def batch_norm(self, x, path, state, stats, train):
        w, b = state[f"visual_bn.{path}.weight"], state[f"visual_bn.{path}.bias"]
        run_mean, run_var = state[f"__bn_stats__.{path}.mean"], state[f"__bn_stats__.{path}.var"]
        if train:
            mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
            n = x.numel() // x.shape[1]
            stats[f"__bn_stats__.{path}.mean"] = (1 - BN_MOMENTUM) * run_mean + BN_MOMENTUM * mean.detach()
            stats[f"__bn_stats__.{path}.var"] = ((1 - BN_MOMENTUM) * run_var
                                                 + BN_MOMENTUM * var.detach() * n / (n - 1))
        else:
            mean, var = run_mean, run_var
        y = (x - mean[None, :, None, None]) / torch.sqrt(var[None, :, None, None] + BN_EPS)
        return y * w[None, :, None, None] + b[None, :, None, None]

    def conv1x1_lora(self, x, weight, key, state, mix):
        y = self.num.conv(x, weight)
        a = state[f"image_encoder_lora.{key}.lora_A"]
        s = mix @ state[f"image_encoder_lora.{key}.lora_S"]
        h = self.num.mm(x.permute(0, 2, 3, 1), a) * s[:, None, None, :]
        return y + self.num.mm(h, state[f"image_encoder_lora.{key}.lora_B"]).permute(0, 3, 1, 2) * self.scaling

    def resnet_tokens(self, x, state, mix, train):
        sd, stats = self.sd, {}
        for i, stride in ((1, 2), (2, 1), (3, 1)):
            x = self.num.conv(x, sd[f"visual.conv{i}.weight"], stride=stride, padding=1)
            x = F.relu(self.batch_norm(x, f"stem.bn{i}", state, stats, train))
        x = F.avg_pool2d(x, 2)
        for layer in range(1, 5):
            for blk in range(self._count(f"visual.layer{layer}")):
                pre, path = f"visual.layer{layer}.{blk}", f"layer{layer}.{blk}"
                stride = 2 if layer > 1 and blk == 0 else 1
                out = self.conv1x1_lora(x, sd[f"{pre}.conv1.weight"], f"{path}.conv1", state, mix)
                out = F.relu(self.batch_norm(out, f"{path}.bn1", state, stats, train))
                out = self.num.conv(out, sd[f"{pre}.conv2.weight"], padding=1)
                out = F.relu(self.batch_norm(out, f"{path}.bn2", state, stats, train))
                if stride > 1:
                    out = F.avg_pool2d(out, stride)
                out = self.conv1x1_lora(out, sd[f"{pre}.conv3.weight"], f"{path}.conv3", state, mix)
                out = self.batch_norm(out, f"{path}.bn3", state, stats, train)
                if f"{pre}.downsample.0.weight" in sd:
                    idn = F.avg_pool2d(x, stride) if stride > 1 else x
                    idn = self.num.conv(idn, sd[f"{pre}.downsample.0.weight"])
                    idn = self.batch_norm(idn, f"{path}.downsample_bn", state, stats, train)
                else:
                    idn = x
                x = F.relu(out + idn)
        return self.attention_pool(x, state), stats

    def attention_pool(self, x, state):
        """CLIP's AttentionPool2d with every token as a query (the method's
        variant returns all tokens), plain LoRA on the four projections."""
        sd, pre = self.sd, "visual.attnpool"
        b, c = x.shape[:2]
        t = x.flatten(2).transpose(1, 2)
        t = torch.cat([t.mean(1, keepdim=True), t], dim=1) + sd[f"{pre}.positional_embedding"]
        heads = c // 64

        def proj(name, inp):
            out = self.num.linear(inp, sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"])
            return out + self.lora(inp, state[f"attnpool_lora.{name}.lora_A"], None,
                                   state[f"attnpool_lora.{name}.lora_B"])

        length = t.shape[1]
        q, k, v = (proj(n, t).reshape(b, length, heads, c // heads).transpose(1, 2)
                   for n in ("q_proj", "k_proj", "v_proj"))
        att = (self.num.mm(q, k.transpose(-1, -2)) / math.sqrt(c // heads)).softmax(-1)
        out = self.num.mm(att, v).transpose(1, 2).reshape(b, length, c)
        return proj("c_proj", out)

    # ------------------------------------------------------------ model
    def logits(self, state: dict, img_u8: torch.Tensor, attr: torch.Tensor, train: bool):
        """(logits [B, n_cls], new BatchNorm statistics or {}): images uint8
        [B, 3, H, W] as the dataset gives them, ``attr`` the group ids."""
        x = (img_u8.float() / 255.0 - self.mean) / self.std
        mix = group_mix(attr, self.groups)
        stats = {}
        if self.kind == "vit":
            tokens = self.vit_tokens(x, state, mix)
        else:
            tokens, stats = self.resnet_tokens(x, state, mix, train)
        image = normalize(tokens[:, 1:]).mean(1)  # mean over patches of unit features
        text = self.text_features(state["prompt_learner.ctx"]).mean(0)  # mean over prompts
        return self.sd["logit_scale"].exp() * image @ text.T, stats


def trainable_keys(state: dict) -> list:
    return [k for k in state if not k.startswith("__bn_stats__")]


def sgd(params: dict, grads: dict, trace: dict, lr: float, optim: dict):
    """``optim["steps_per_batch"]`` steps of SGD with momentum and coupled
    weight decay (torch.optim.SGD, dampening 0) on one gradient."""
    params, trace = dict(params), dict(trace)
    for _ in range(optim["steps_per_batch"]):
        for k, g in grads.items():
            d = g + optim["weight_decay"] * params[k]
            trace[k] = d + optim["momentum"] * trace[k]
            params[k] = params[k] - lr * trace[k]
    return params, trace


def train_step(model: ReferenceCLIP, state: dict, trace: dict, batch: dict, lr: float,
               optim: dict):
    """One batch: (new state, new momentum, loss, gradients)."""
    keys = trainable_keys(state)
    leaves = {k: state[k].detach().clone().requires_grad_(True) for k in keys}
    stats = {k: v for k, v in state.items() if k not in leaves}
    logits, new_stats = model.logits({**stats, **leaves}, batch["img"], batch["attr"], train=True)
    loss = F.cross_entropy(logits, batch["label"])
    grads = dict(zip(keys, torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)))
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g.detach() for k, g in grads.items()}
    with torch.no_grad():
        new, new_trace = sgd({k: v.detach() for k, v in leaves.items()}, grads, trace, lr, optim)
    return {**stats, **{k: v.detach() for k, v in new_stats.items()}, **new}, new_trace, \
        float(loss.detach()), grads


def aggregate(prev_global: dict, trained: list, weights, group_weights, groups: int,
              beta_decay: float, shared_half_s: bool) -> dict:
    """FedAvg of the trained clients' states by ``weights`` (lora_S leaves by
    their per-group weights ``group_weights`` [m, G]), the first half of each
    group's singular values shared across groups, then the EMA toward the
    previous global state (FairFedMed's ``average_weights_ema``)."""
    out = {}
    for k in trained[0]:
        is_s = "lora_S" in k and trained[0][k].dim() >= 2 and trained[0][k].shape[-2] == groups
        acc = torch.zeros_like(trained[0][k], dtype=torch.float32)
        for j, t in enumerate(trained):
            w = group_weights[j][:, None] if is_s else weights[j]
            acc = acc + t[k].float() * w
        if is_s and shared_half_s:
            half = acc.shape[-1] // 2
            acc = torch.cat([acc[..., :half].mean(-2, keepdim=True).expand_as(acc[..., :half]),
                             acc[..., half:]], dim=-1)
        out[k] = (1 - beta_decay) * acc + beta_decay * prev_global[k].float()
    return out
