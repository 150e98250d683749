"""DDAIG perturbation networks (Dassl legacy; port of
``fairfedmed_tpu/models/networks.py``, reference
``Dassl/dassl/modeling/network/ddaig_fcn.py``): the FCN perturbation
generator (reflection-padded residual blocks, instance norm, global-context
fusion, tanh regression head) and its spatial-transformer variant (LocNet,
affine grid, bilinear sample).

``init(generator, device) -> (params, stats)`` and ``apply(params, stats,
x, train, lmda) -> (x_p, p, new_stats)``, as ``models/backbones.py``.  The
affine grid and the bilinear sample are the JAX package's own arithmetic
(``align_corners=False``, zero padding) as gathers and lerps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .backbones import _bn, _bn_init, _conv, _max_pool

NETWORK_REGISTRY = {}


def register_network(name):
    def deco(fn):
        NETWORK_REGISTRY[name] = fn
        return fn
    return deco


def build_network(name: str, **kwargs):
    """``(init, apply)`` of a registered network (build.py:9-17)."""
    if name not in NETWORK_REGISTRY:
        raise KeyError(f"network {name!r} not registered; available: "
                       f"{sorted(NETWORK_REGISTRY)}")
    return NETWORK_REGISTRY[name](**kwargs)


# --------------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------------- #

def _normal_conv_init(gen, cout, cin, k, device, gain=0.02):
    """init_network_weights(init_type='normal', gain=0.02), ddaig_fcn.py:12-42."""
    return (gain * torch.randn((cout, cin, k, k), generator=gen)).to(device)


def _instance_norm(x, eps=1e-5):
    """InstanceNorm2d(affine=False, track_running_stats=False)."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = x32.var(dim=(2, 3), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _reflect_pad(x, p=1):
    return F.pad(x, (p, p, p, p), mode="reflect")


def affine_grid(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``F.affine_grid(theta, (N, C, H, W), align_corners=False)``: the
    normalised sampling coordinates (N, H, W, 2) as (x, y)."""
    dev = theta.device
    xs = (2 * torch.arange(w, device=dev) + 1) / w - 1
    ys = (2 * torch.arange(h, device=dev) + 1) / h - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3).float()
    out = torch.einsum("nij,pj->npi", theta.float(), base)
    return out.reshape(theta.shape[0], h, w, 2)


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(x, grid, mode='bilinear', padding_mode='zeros',
    align_corners=False)`` as four gathers, each corner weighted and masked
    outside the image."""
    n, c, h, w = x.shape
    x32 = x.float()
    ix = ((grid[..., 0] + 1) * w - 1) / 2
    iy = ((grid[..., 1] + 1) * h - 1) / 2
    x0, y0 = torch.floor(ix), torch.floor(iy)
    flat = x32.reshape(n, c, h * w)
    out = 0.0
    for dx, wx in ((0, x0 + 1 - ix), (1, ix - x0)):
        for dy, wy in ((0, y0 + 1 - iy), (1, iy - y0)):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            xc = xi.clamp(0, w - 1).long()
            yc = yi.clamp(0, h - 1).long()
            idx = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
            vals = torch.gather(flat, 2, idx).reshape(n, c, *xi.shape[1:])
            out = out + vals * (wx * wy * valid)[:, None]
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# residual block (ddaig_fcn.py:61-112)
# --------------------------------------------------------------------------- #

def _resblock_init(gen, dim, norm, device):
    p = {"conv1": _normal_conv_init(gen, dim, dim, 3, device),
         "conv2": _normal_conv_init(gen, dim, dim, 3, device)}
    s = {}
    if norm == "batch":
        p["bn1"], s["bn1"] = _bn_init(dim, device)
        p["bn2"], s["bn2"] = _bn_init(dim, device)
    return p, s


def _resblock_apply(p, s, x, train, norm, padding_type):
    new_s = {}

    def norm_fn(name, y):
        if norm == "instance":
            return _instance_norm(y)
        y, new_s[name] = _bn(p[name], s[name], y, train)
        return y

    def pad_conv(y, wname):
        if padding_type == "reflect":
            return _conv(_reflect_pad(y), p[wname])
        return _conv(y, p[wname], padding=1)  # "zero"

    y = F.relu(norm_fn("bn1", pad_conv(x, "conv1")))
    y = norm_fn("bn2", pad_conv(y, "conv2"))
    return x + y, new_s


# --------------------------------------------------------------------------- #
# LocNet (ddaig_fcn.py:115-160)
# --------------------------------------------------------------------------- #

def _locnet_init(gen, input_nc, nc, n_blocks, image_size, device):
    params = {"conv1": _normal_conv_init(gen, nc, input_nc, 3, device)}
    stats = {}
    params["bn1"], stats["bn1"] = _bn_init(nc, device)
    params["blocks"], stats["blocks"] = [], []
    for _ in range(n_blocks):
        p, s = _resblock_init(gen, nc, "batch", device)
        params["blocks"].append(p)
        stats["blocks"].append(s)
    reduced = int(image_size * 0.5 ** (n_blocks + 1))
    # init_loc_layer (ddaig_fcn.py:240-246): the identity transform
    params["fc_loc"] = {"weight": torch.zeros(4, nc * reduced ** 2, device=device),
                        "bias": torch.tensor([1.0, 0.0, 0.0, 1.0], device=device)}
    return params, stats


def _locnet_apply(params, stats, x, train):
    new_stats = {}
    y, new_stats["bn1"] = _bn(params["bn1"], stats["bn1"],
                              _conv(x, params["conv1"], stride=2, padding=1), train)
    y = F.relu(y)
    new_stats["blocks"] = []
    for p, s in zip(params["blocks"], stats["blocks"]):
        y, ns = _resblock_apply(p, s, y, train, "batch", "zero")
        new_stats["blocks"].append(ns)
        y = _max_pool(y, 2, 2, 0)
    y = y.reshape(y.shape[0], -1)
    y = torch.tanh(y @ params["fc_loc"]["weight"].T + params["fc_loc"]["bias"])
    a = y.reshape(-1, 2, 2)
    # theta (N, 2, 3) with a zero translation column (ddaig_fcn.py:152-159)
    theta = torch.cat([a, torch.zeros(a.shape[0], 2, 1, dtype=a.dtype, device=a.device)], dim=2)
    return theta, new_stats


# --------------------------------------------------------------------------- #
# FCN (ddaig_fcn.py:163-279)
# --------------------------------------------------------------------------- #

def _fcn(input_nc=3, output_nc=3, nc=32, n_blocks=3, norm="instance", padding_type="reflect",
         gctx=True, stn=False, image_size=32):
    def init(gen, device=None):
        params = {"conv1": _normal_conv_init(gen, nc, input_nc, 3, device)}
        stats = {}
        if norm == "batch":
            params["bn1"], stats["bn1"] = _bn_init(nc, device)
        params["blocks"], stats["blocks"] = [], []
        for _ in range(n_blocks):
            p, s = _resblock_init(gen, nc, norm, device)
            params["blocks"].append(p)
            stats["blocks"].append(s)
        if gctx:
            params["gctx"] = _normal_conv_init(gen, nc, 2 * nc, 1, device)
            if norm == "batch":
                params["gctx_bn"], stats["gctx_bn"] = _bn_init(nc, device)
        params["regress"] = {"weight": _normal_conv_init(gen, output_nc, nc, 1, device),
                             "bias": torch.zeros(output_nc, device=device)}
        if stn:
            params["locnet"], stats["locnet"] = _locnet_init(gen, input_nc, nc, n_blocks,
                                                             image_size, device)
        return params, stats

    def apply(params, stats, x, train=True, lmda=1.0):
        """``(x_p, p, new_stats)``: the reference's ``return_p=True`` form."""
        new_stats = {}
        if "locnet" in params:
            theta, new_stats["locnet"] = _locnet_apply(params["locnet"], stats["locnet"], x,
                                                       train)
            x = grid_sample(x, affine_grid(theta, x.shape[2], x.shape[3]))
        inp = x
        if padding_type == "reflect":
            y = _conv(_reflect_pad(x), params["conv1"])
        else:
            y = _conv(x, params["conv1"], padding=1)
        if norm == "instance":
            y = _instance_norm(y)
        else:
            y, new_stats["bn1"] = _bn(params["bn1"], stats["bn1"], y, train)
        y = F.relu(y)
        new_stats["blocks"] = []
        for p, s in zip(params["blocks"], stats["blocks"]):
            y, ns = _resblock_apply(p, s, y, train, norm, padding_type)
            new_stats["blocks"].append(ns)
        if "gctx" in params:
            c = y.mean((2, 3), keepdim=True).expand_as(y)
            y = _conv(torch.cat([y, c], dim=1), params["gctx"])
            if norm == "instance":
                y = _instance_norm(y)
            else:
                y, new_stats["gctx_bn"] = _bn(params["gctx_bn"], stats["gctx_bn"], y, train)
            y = F.relu(y)
        p_out = torch.tanh(_conv(y, params["regress"]["weight"])
                           + params["regress"]["bias"].reshape(1, -1, 1, 1))
        return inp + lmda * p_out, p_out, new_stats

    return init, apply


@register_network("fcn_3x32_gctx")
def fcn_3x32_gctx(**kwargs):
    return _fcn(3, 3, nc=32, n_blocks=3, norm="instance")


@register_network("fcn_3x64_gctx")
def fcn_3x64_gctx(**kwargs):
    return _fcn(3, 3, nc=64, n_blocks=3, norm="instance")


@register_network("fcn_3x32_gctx_stn")
def fcn_3x32_gctx_stn(image_size=32, **kwargs):
    return _fcn(3, 3, nc=32, n_blocks=3, norm="instance", stn=True, image_size=image_size)


@register_network("fcn_3x64_gctx_stn")
def fcn_3x64_gctx_stn(image_size=224, **kwargs):
    return _fcn(3, 3, nc=64, n_blocks=3, norm="instance", stn=True, image_size=image_size)
