"""Dassl legacy modeling ops as PyTorch functions (port of
``fairfedmed_tpu/ops/dassl.py``; reference ``Dassl/dassl/modeling/ops/``:
mixstyle.py, efdmix.py, mmd.py, mixup.py, reverse_grad.py,
cross_entropy.py, dsbn.py, transnorm.py, attention.py, conv.py, utils.py and
optimal_transport.py, whose log-domain Sinkhorn divergence is distinct from
the runtime solver in ``ops/sinkhorn.py``).

* The stochastic ops (MixStyle, EFDMix, mixup, ``shuffle_index``) take a
  ``torch.Generator`` on the CPU and draw there: the coin, the partner
  permutation (``torch.randperm``) and the Beta weights (numpy's Beta,
  seeded from the generator, as torch has no Beta sampler that takes a
  generator).  The draws then go to the input's device, so a GPU call waits
  for nothing.  Each has a deterministic core (``mixstyle_mix``,
  ``efdmix_mix``, ``mixup_mix``) that takes the draws as arguments.
* Running statistics (DSBN, TransNorm) are explicit dicts of tensors passed
  in and returned, like every BatchNorm of ``models/backbones.py``.
* ``reverse_grad`` is a ``torch.autograd.Function``.
* The Sinkhorn plan runs ``max_iter`` log-domain steps and freezes the
  potentials once a step changes them by less than ``thre``: the JAX
  package's masked scan, whose plan equals its early-exit loop's, with no
  host sync per iteration.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------- #
# random draws on a CPU generator
# --------------------------------------------------------------------------- #


def _beta(generator: torch.Generator, a: float, b: float, shape) -> torch.Tensor:
    """Beta(a, b) samples of ``shape`` (fp32, CPU) from ``generator``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.from_numpy(np.random.default_rng(seed).beta(a, b, shape).astype(np.float32))


def _coin(generator: torch.Generator, p: float) -> bool:
    return bool(torch.rand((), generator=generator) < p)


def mix_perm(generator: torch.Generator, batch: int, mix: str = "random") -> torch.Tensor:
    """Partner permutation for style mixing (mixstyle.py:100-116):
    ``random`` shuffles; ``crossdomain`` reverses the batch (so the two
    domain halves swap) and shuffles within each half."""
    if mix == "random":
        return torch.randperm(batch, generator=generator)
    if mix == "crossdomain":
        perm = torch.arange(batch - 1, -1, -1)
        half = batch - batch // 2  # torch.chunk: the first chunk gets the ceil
        perm_b = perm[:half][torch.randperm(half, generator=generator)]
        perm_a = perm[half:][torch.randperm(batch - half, generator=generator)]
        return torch.cat([perm_b, perm_a])
    raise NotImplementedError(f"mix={mix!r}")


# --------------------------------------------------------------------------- #
# style-statistics mixing (mixstyle.py / efdmix.py)
# --------------------------------------------------------------------------- #


def mixstyle_mix(x: torch.Tensor, lmda: torch.Tensor, perm: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """MixStyle's mixing (mixstyle.py:53-123) of ``x`` (B, C, H, W) with the
    weights ``lmda`` (B, 1, 1, 1) and the partner ``perm`` (B,).  The
    statistics are detached, the variance unbiased, as torch's ``.var``."""
    x32 = x.float()
    mu = x32.mean(dim=(2, 3), keepdim=True).detach()
    n = x.shape[2] * x.shape[3]
    var = (x32.var(dim=(2, 3), keepdim=True, unbiased=False) * (n / max(n - 1, 1))).detach()
    sig = torch.sqrt(var + eps)
    x_normed = (x32 - mu) / sig
    lmda = lmda.to(x32.device, torch.float32)
    perm = perm.to(x32.device)
    mu_mix = mu * lmda + mu[perm] * (1 - lmda)
    sig_mix = sig * lmda + sig[perm] * (1 - lmda)
    return (x_normed * sig_mix + mu_mix).to(x.dtype)


def mixstyle(x: torch.Tensor, generator: torch.Generator, p: float = 0.5, alpha: float = 0.1,
             eps: float = 1e-6, mix: str = "random", train: bool = True) -> torch.Tensor:
    """MixStyle (Zhou et al., ICLR 2021): with probability ``p``, each
    sample's channel mean and std mixed with a partner's by Beta(alpha,
    alpha) weights."""
    if not train:
        return x
    b = x.shape[0]
    apply_it = _coin(generator, p)
    lmda = _beta(generator, alpha, alpha, (b, 1, 1, 1))
    perm = mix_perm(generator, b, mix)
    return mixstyle_mix(x, lmda, perm, eps) if apply_it else x


def efdmix_mix(x: torch.Tensor, lmda: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """EFDMix's exact feature-distribution matching (efdmix.py:53-121):
    each (B, C) row's sorted spatial values grafted from the partner through
    the inverse sort; the gradient reaches the partner as the reference's
    ``x_view + (x_view_copy - x_view.detach()) * (1 - lmda)``."""
    b, c = x.shape[0], x.shape[1]
    x_view = x.reshape(b, c, -1).float()
    value_x, index_x = torch.sort(x_view, dim=-1, stable=True)
    inverse_index = torch.argsort(index_x, dim=-1, stable=True)
    lmda = lmda.to(x_view.device, torch.float32)
    perm = perm.to(x_view.device)
    x_view_copy = torch.gather(value_x[perm], -1, inverse_index)
    new_x = x_view + (x_view_copy - x_view.detach()) * (1 - lmda)
    return new_x.reshape(x.shape).to(x.dtype)


def efdmix(x: torch.Tensor, generator: torch.Generator, p: float = 0.5, alpha: float = 0.1,
           eps: float = 1e-6, mix: str = "random", train: bool = True) -> torch.Tensor:
    """EFDMix (Zhang et al., CVPR 2022), applied with probability ``p``."""
    if not train:
        return x
    b = x.shape[0]
    apply_it = _coin(generator, p)
    lmda = _beta(generator, alpha, alpha, (b, 1, 1))
    perm = mix_perm(generator, b, mix)
    return efdmix_mix(x, lmda, perm) if apply_it else x


# --------------------------------------------------------------------------- #
# maximum mean discrepancy (mmd.py)
# --------------------------------------------------------------------------- #


def _offdiag_mean(k: torch.Tensor) -> torch.Tensor:
    """Mean over the off-diagonal entries (mmd.py:59-64's per-row removal)."""
    n = k.shape[0]
    mask = 1.0 - torch.eye(n, dtype=k.dtype, device=k.device)
    return (k * mask).sum() / (n * (n - 1))


def _sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance matrix (mmd.py:66-75), clamped at 0."""
    d = (x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None, :] - 2 * x @ y.T
    return d.clamp_min(0.0)


def _rbf_mixture(exponent: torch.Tensor, sigmas=(1, 5, 10)) -> torch.Tensor:
    k = 0.0
    for sigma in sigmas:
        k = k + torch.exp(-exponent / (2.0 * sigma ** 2))
    return k


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def mmd(x: torch.Tensor, y: torch.Tensor, kernel_type: str = "rbf",
        normalize: bool = False) -> torch.Tensor:
    """MMD^2(x, y) with a linear, polynomial or RBF-mixture kernel
    (mmd.py:6-56)."""
    if normalize:
        x, y = _l2n(x), _l2n(y)
    if kernel_type == "linear":
        k_xx, k_yy, k_xy = x @ x.T, y @ y.T, x @ y.T
    elif kernel_type == "poly":
        alpha, c, d = 1.0, 2.0, 2
        k_xx = (alpha * (x @ x.T) + c) ** d
        k_yy = (alpha * (y @ y.T) + c) ** d
        k_xy = (alpha * (x @ y.T) + c) ** d
    elif kernel_type == "rbf":
        k_xx = _rbf_mixture(_sq_dist(x, x))
        k_yy = _rbf_mixture(_sq_dist(y, y))
        k_xy = _rbf_mixture(_sq_dist(x, y))
    else:
        raise NotImplementedError(f"kernel_type={kernel_type!r}")
    return _offdiag_mean(k_xx) + _offdiag_mean(k_yy) - 2 * k_xy.mean()


# --------------------------------------------------------------------------- #
# mixup (mixup.py)
# --------------------------------------------------------------------------- #


def mixup_mix(x1, x2, y1, y2, lmda: torch.Tensor):
    """Input and label mixing with the weights ``lmda`` (B, 1, 1, 1)."""
    lmda = lmda.to(x1.device, x1.dtype)
    xmix = x1 * lmda + x2 * (1 - lmda)
    lm = lmda[:, :, 0, 0]
    return xmix, y1 * lm + y2 * (1 - lm)


def mixup(x1, x2, y1, y2, beta: float, generator: torch.Generator,
          preserve_order: bool = False):
    """Beta(beta, beta)-weighted input and label mixing (mixup.py:4-23);
    ``preserve_order`` keeps the weight of ``x1`` at least 0.5."""
    lmda = _beta(generator, beta, beta, (x1.shape[0], 1, 1, 1))
    if preserve_order:
        lmda = torch.maximum(lmda, 1 - lmda)
    return mixup_mix(x1, x2, y1, y2, lmda)


# --------------------------------------------------------------------------- #
# gradient reversal (reverse_grad.py)
# --------------------------------------------------------------------------- #


class _ReverseGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grad_scaling):
        ctx.grad_scaling = grad_scaling
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return -ctx.grad_scaling * grad, None


def reverse_grad(x: torch.Tensor, grad_scaling: float = 1.0) -> torch.Tensor:
    """Identity forward, gradient times ``-grad_scaling`` backward
    (reverse_grad.py:5-34)."""
    return _ReverseGrad.apply(x, grad_scaling)


# --------------------------------------------------------------------------- #
# losses and probability utilities (cross_entropy.py, utils.py)
# --------------------------------------------------------------------------- #


def cross_entropy(logits: torch.Tensor, target: torch.Tensor, label_smooth: float = 0.0,
                  reduction: str = "mean") -> torch.Tensor:
    """Label-smoothed cross entropy (cross_entropy.py:5-31); the Dassl
    utility, not the runtime loss of ``train/clip_common.py``."""
    num_classes = logits.shape[1]
    log_prob = F.log_softmax(logits, dim=1)
    onehot = F.one_hot(target.long(), num_classes).to(logits.dtype)
    soft = (1 - label_smooth) * onehot + label_smooth / num_classes
    loss = -(soft * log_prob).sum(1)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction={reduction!r}")


def sharpen_prob(p: torch.Tensor, temperature: float = 2.0) -> torch.Tensor:
    """Temperature sharpening of a probability matrix (utils.py:6-14)."""
    p = p ** temperature
    return p / p.sum(1, keepdim=True)


def reverse_index(data, label):
    """The batch in reverse order (utils.py:17-20)."""
    inv = torch.arange(data.shape[0] - 1, -1, -1, device=data.device)
    return data[inv], label[inv]


def shuffle_index(data, label, generator: torch.Generator):
    """The batch in a random order (utils.py:23-26)."""
    idx = torch.randperm(data.shape[0], generator=generator).to(data.device)
    return data[idx], label[idx]


def create_onehot(label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """One-hot fp32 encoding of an int label vector (utils.py:29-40)."""
    return F.one_hot(label.long(), num_classes).float()


def sigmoid_rampup(current, rampup_length: int) -> float:
    """Exponential ramp-up weight (utils.py:43-53), a host scalar."""
    assert rampup_length > 0
    current = float(np.clip(current, 0.0, rampup_length))
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))


def linear_rampup(current, rampup_length: int) -> float:
    """Linear ramp-up weight (utils.py:56-64), a host scalar."""
    assert rampup_length > 0
    return float(np.clip(current / rampup_length, 0.0, 1.0))


def ema_update(ema_params, params, alpha: float):
    """``alpha * ema + (1 - alpha) * param`` over nested dicts and lists of
    tensors (utils.py:67-77's ema_model_update); new tensors out."""
    if isinstance(ema_params, dict):
        return {k: ema_update(ema_params[k], params[k], alpha) for k in ema_params}
    if isinstance(ema_params, (list, tuple)):
        return [ema_update(e, p, alpha) for e, p in zip(ema_params, params)]
    return alpha * ema_params + (1 - alpha) * params


# --------------------------------------------------------------------------- #
# domain-specific batch norm (dsbn.py)
# --------------------------------------------------------------------------- #

_BN_MOMENTUM = 0.1
_BN_EPS = 1e-5


def dsbn_init(num_features: int, n_domain: int, device=None):
    """Per-domain BatchNorm parameters and statistics stacked on a leading
    domain axis (dsbn.py:4-35's ModuleList of BatchNorms)."""
    params = {"weight": torch.ones(n_domain, num_features, device=device),
              "bias": torch.zeros(n_domain, num_features, device=device)}
    stats = {"mean": torch.zeros(n_domain, num_features, device=device),
             "var": torch.ones(n_domain, num_features, device=device)}
    return params, stats


def dsbn_apply(params, stats, x: torch.Tensor, domain_idx: int, train: bool):
    """Batch norm of ``x`` (B, C) or (B, C, H, W) with the ``domain_idx``-th
    parameters and statistics (dsbn.py:32-35); returns ``(y, new_stats)``."""
    axes = (0,) if x.dim() == 2 else (0, 2, 3)
    shape = (1, -1) if x.dim() == 2 else (1, -1, 1, 1)
    w = params["weight"][domain_idx].reshape(shape)
    b = params["bias"][domain_idx].reshape(shape)
    x32 = x.float()
    if train:
        mean = x32.mean(axes)
        var = x32.var(axes, unbiased=False)
        n = x32.numel() // x32.shape[1]
        unbiased = var * n / max(n - 1, 1)
        new_mean, new_var = stats["mean"].clone(), stats["var"].clone()
        new_mean[domain_idx] = (1 - _BN_MOMENTUM) * stats["mean"][domain_idx] + _BN_MOMENTUM * mean
        new_var[domain_idx] = (1 - _BN_MOMENTUM) * stats["var"][domain_idx] \
            + _BN_MOMENTUM * unbiased
        new_stats = {"mean": new_mean.detach(), "var": new_var.detach()}
    else:
        mean, var = stats["mean"][domain_idx], stats["var"][domain_idx]
        new_stats = stats
    y = (x32 - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + _BN_EPS)
    return (y * w + b).to(x.dtype), new_stats


# --------------------------------------------------------------------------- #
# transferable normalization (transnorm.py)
# --------------------------------------------------------------------------- #


def transnorm_init(num_features: int, device=None):
    """TransNorm (Wang et al., NeurIPS 2019) parameters and statistics
    (transnorm.py:21-44)."""
    params = {"weight": torch.ones(num_features, device=device),
              "bias": torch.zeros(num_features, device=device)}
    stats = {"mean_s": torch.zeros(num_features, device=device),
             "var_s": torch.ones(num_features, device=device),
             "mean_t": torch.zeros(num_features, device=device),
             "var_t": torch.ones(num_features, device=device)}
    return params, stats


def _tn_alpha(mean_s, var_s, mean_t, var_t, eps):
    """Domain-adaptive channel attention (transnorm.py:49-56)."""
    c = mean_s.shape[0]
    ratio_s = mean_s / torch.sqrt(var_s + eps)
    ratio_t = mean_t / torch.sqrt(var_t + eps)
    dist_inv = 1.0 / (1.0 + (ratio_s - ratio_t).abs())
    return c * dist_inv / dist_inv.sum()


def transnorm_apply(params, stats, x: torch.Tensor, train: bool, adaptive_alpha: bool = True,
                    momentum: float = 0.1, eps: float = 1e-5):
    """TransNorm forward (transnorm.py:58-116); returns ``(y, new_stats)``.
    Training splits the batch into source and target halves, each normalised
    with its own statistics, and updates the running statistics with the
    reference's convention ``running = momentum * running + (1 - momentum) *
    batch``; evaluation normalises with the target statistics.  The
    adaptive alpha is detached."""
    c = params["weight"].shape[0]
    shape = (1, c) if x.dim() == 2 else (1, c, 1, 1)
    axes = (0,) if x.dim() == 2 else (0, 2, 3)
    weight, bias = params["weight"].reshape(shape), params["bias"].reshape(shape)
    x32 = x.float()
    if not train:
        out = (x32 - stats["mean_t"].reshape(shape)) / torch.sqrt(
            stats["var_t"].reshape(shape) + eps)
        out = out * weight + bias
        if adaptive_alpha:
            alpha = _tn_alpha(stats["mean_s"], stats["var_s"], stats["mean_t"], stats["var_t"],
                              eps)
            out = (1 + alpha.detach().reshape(shape)) * out
        return out.to(x.dtype), stats
    if x32.shape[0] % 2 != 0:
        # the reference's torch.split(input, B // 2) yields 3 chunks on an odd
        # batch and its 2-way unpack raises
        raise ValueError("transnorm training expects an even batch (source/target halves); "
                         f"got batch={x32.shape[0]}")
    half = x32.shape[0] // 2
    new_stats, outs, halves = dict(stats), [], {}
    for name, part in (("s", x32[:half]), ("t", x32[half:2 * half])):
        mean = part.mean(axes)
        n = part.numel() // c
        var = part.var(axes, unbiased=False) * n / max(n - 1, 1)
        new_stats[f"mean_{name}"] = (momentum * stats[f"mean_{name}"]
                                     + (1 - momentum) * mean).detach()
        new_stats[f"var_{name}"] = (momentum * stats[f"var_{name}"]
                                    + (1 - momentum) * var).detach()
        out = (part - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
        outs.append(out * weight + bias)
        halves[name] = (mean, var)
    out = torch.cat(outs, 0)
    if adaptive_alpha:
        alpha = _tn_alpha(*halves["s"], *halves["t"], eps)
        out = (1 + alpha.detach().reshape(shape)) * out
    return out.to(x.dtype), new_stats


# --------------------------------------------------------------------------- #
# dynamic convolution (attention.py, conv.py: DDG)
# --------------------------------------------------------------------------- #


def _uniform(generator, shape, bound, device):
    return ((torch.rand(shape, generator=generator) * 2 - 1) * bound).to(device)


def se_attention_init(generator: torch.Generator, in_channels: int, out_features: int,
                      squeeze: Optional[int] = None, device=None):
    """Squeeze-excite attention head (attention.py:8-31), torch Linear's
    default init: weight and bias uniform(+-1/sqrt(fan_in))."""
    squeeze = squeeze if squeeze else in_channels // 16
    assert squeeze > 0
    s1, s2 = (1.0 / in_channels) ** 0.5, (1.0 / squeeze) ** 0.5
    return {"fc1": {"weight": _uniform(generator, (squeeze, in_channels), s1, device),
                    "bias": _uniform(generator, (squeeze,), s1, device)},
            "fc2": {"weight": _uniform(generator, (out_features, squeeze), s2, device),
                    "bias": _uniform(generator, (out_features,), s2, device)}}


def se_attention_apply(params, x: torch.Tensor) -> torch.Tensor:
    """Global average pool -> fc -> relu -> fc -> softmax (attention.py:26-31)."""
    v = x.mean((2, 3))
    v = F.relu(v @ params["fc1"]["weight"].T + params["fc1"]["bias"])
    v = v @ params["fc2"]["weight"].T + params["fc2"]["bias"]
    return torch.softmax(v, dim=-1)


def conv2d_dynamic_init(generator: torch.Generator, in_channels: int, out_channels: int,
                        kernel_size: int, squeeze: Optional[int] = None,
                        attention_in_channels: Optional[int] = None, device=None):
    """Conv2dDynamic (conv.py:10-84): a base conv, four kernel templates
    (grouped kxk, 1x1, kx1, 1xk) and an attention head mixing them; torch
    Conv2d's default init."""
    if kernel_size % 2 == 0:
        raise ValueError("kernel_size must be odd")
    groups = min(in_channels, out_channels)

    def w(cout, cin, kh, kw):
        bound = (1.0 / (cin * kh * kw)) ** 0.5
        return {"weight": _uniform(generator, (cout, cin, kh, kw), bound, device),
                "bias": _uniform(generator, (cout,), bound, device)}

    k = kernel_size
    return {"conv": w(out_channels, in_channels, k, k),
            "conv_nn": w(out_channels, in_channels // groups, k, k),
            "conv_11": w(out_channels, in_channels, 1, 1),
            "conv_n1": w(out_channels, in_channels, k, 1),
            "conv_1n": w(out_channels, in_channels, 1, k),
            "attention": se_attention_init(generator, attention_in_channels or in_channels, 4,
                                           squeeze, device)}


def _conv_b(x, wb, stride, padding, groups=1):
    return F.conv2d(x, wb["weight"].to(x.dtype), wb["bias"].to(x.dtype), stride=stride,
                    padding=padding, groups=groups)


def conv2d_dynamic_apply(params, x: torch.Tensor, stride: int = 1,
                         attention_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dynamic conv forward (conv.py:86-96): ``conv(x) + sum_i y_i *
    template_i(x)`` with ``y`` the attention head's mix."""
    k = params["conv"]["weight"].shape[2]
    p = k // 2
    groups = params["conv"]["weight"].shape[1] // params["conv_nn"]["weight"].shape[1]
    y = se_attention_apply(params["attention"], x if attention_x is None else attention_x)
    out = _conv_b(x, params["conv"], stride, (p, p))
    templates = (("conv_nn", (p, p), groups), ("conv_11", (0, 0), 1),
                 ("conv_n1", (p, 0), 1), ("conv_1n", (0, p), 1))
    for i, (name, pad, g) in enumerate(templates):
        out = out + _conv_b(x, params[name], stride, pad, g) * y[:, i].reshape(-1, 1, 1, 1)
    return out


# --------------------------------------------------------------------------- #
# log-domain Sinkhorn divergence (optimal_transport.py)
# --------------------------------------------------------------------------- #


def ot_distance(batch1: torch.Tensor, batch2: torch.Tensor,
                dist_metric: str = "cosine") -> torch.Tensor:
    """Cost matrix between two batches (optimal_transport.py:9-32)."""
    if dist_metric == "cosine":
        return 1 - _l2n(batch1) @ _l2n(batch2).T
    if dist_metric in ("euclidean", "fast_euclidean"):
        return _sq_dist(batch1, batch2)
    raise ValueError(f"Unknown cost function: {dist_metric}")


def sinkhorn_plan(cost: torch.Tensor, eps: float, max_iter: int, thre: float) -> torch.Tensor:
    """Log-domain Sinkhorn plan (optimal_transport.py:67-101): ``max_iter``
    steps, the potentials frozen after the first step that changes ``u`` by
    less than ``thre`` in L1 (the reference's early exit, as a mask)."""
    nx, ny = cost.shape
    log_mu = torch.log(torch.full((nx,), 1.0 / nx, dtype=cost.dtype, device=cost.device) + 1e-8)
    log_nu = torch.log(torch.full((ny,), 1.0 / ny, dtype=cost.dtype, device=cost.device) + 1e-8)

    def m(u, v):
        return (-cost + u[:, None] + v[None, :]) / eps

    u = torch.zeros(nx, dtype=cost.dtype, device=cost.device)
    v = torch.zeros(ny, dtype=cost.dtype, device=cost.device)
    active = torch.ones((), dtype=torch.bool, device=cost.device)
    for _ in range(max_iter):
        u_new = eps * (log_mu - torch.logsumexp(m(u, v), dim=1)) + u
        v_new = eps * (log_nu - torch.logsumexp(m(u_new, v), dim=0)) + v
        err = (u_new - u).abs().sum()
        u = torch.where(active, u_new, u)
        v = torch.where(active, v_new, v)
        active = active & (err >= thre)
    return torch.exp(m(u, v))


def sinkhorn_transport_cost(x, y, dist_metric: str = "cosine", eps: float = 0.01,
                            max_iter: int = 5, thre: float = 1e-3,
                            bp_to_sinkhorn: bool = False) -> torch.Tensor:
    """W(x, y) = <pi, C> (optimal_transport.py:58-66); the plan is detached
    unless ``bp_to_sinkhorn``."""
    cost = ot_distance(x, y, dist_metric)
    pi = sinkhorn_plan(cost, eps, max_iter, thre)
    if not bp_to_sinkhorn:
        pi = pi.detach()
    return (pi * cost).sum()


def sinkhorn_divergence(x, y, dist_metric: str = "cosine", eps: float = 0.01,
                        max_iter: int = 5, thre: float = 1e-3,
                        bp_to_sinkhorn: bool = False) -> torch.Tensor:
    """Debiased Sinkhorn divergence 2W(x, y) - W(x, x) - W(y, y)
    (optimal_transport.py:35-57)."""
    kw = dict(dist_metric=dist_metric, eps=eps, max_iter=max_iter, thre=thre,
              bp_to_sinkhorn=bp_to_sinkhorn)
    return (2 * sinkhorn_transport_cost(x, y, **kw) - sinkhorn_transport_cost(x, x, **kw)
            - sinkhorn_transport_cost(y, y, **kw))


def minibatch_energy_distance(x, y, dist_metric: str = "cosine", eps: float = 0.01,
                              max_iter: int = 5, thre: float = 1e-3,
                              bp_to_sinkhorn: bool = False) -> torch.Tensor:
    """Minibatch energy distance over split halves
    (optimal_transport.py:104-130)."""
    kw = dict(dist_metric=dist_metric, eps=eps, max_iter=max_iter, thre=thre,
              bp_to_sinkhorn=bp_to_sinkhorn)
    hx, hy = x.shape[0] // 2, y.shape[0] // 2
    x1, x2 = x[:hx], x[hx:2 * hx]
    y1, y2 = y[:hy], y[hy:2 * hy]
    w = sinkhorn_transport_cost
    return (w(x1, y1, **kw) + w(x1, y2, **kw) + w(x2, y1, **kw) + w(x2, y2, **kw)
            - 2 * w(x1, x2, **kw) - 2 * w(y1, y2, **kw))
