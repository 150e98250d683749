"""The run's inputs, made from its seed: a FairFedMed-Oph fixture (the
traffic), a CLIP checkpoint of seeded random weights in OpenAI's key layout
(the configuration), and the launcher script's flags.

``write_fixture`` is a copy of ``chip_smoke.py:write_fairfedmed_fixture``
(the layout of ``dataset.md``: ``fairfedmed/all/data_*.npz`` and
``meta_site{k}_{attr}_{split}.csv``) driven by a traffic file, with smooth
grey images in the manner of ``chip_smoke.py:_smooth_image`` made in bulk.
``launcher_flags`` is a copy of ``chip_smoke.py:script_flags``.
"""

from __future__ import annotations

import csv
import math
import os
import re
import shlex
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

WRITERS = 4  # threads writing the fixture's files

# --------------------------------------------------------------------------- traffic


def _smooth_images(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """[n, size, size] uint8 photo-like grey images: coarse random levels
    upsampled bicubically, plus fine noise (so deflate finds some structure,
    as it does in a fundus photograph)."""
    coarse = max(2, size // 24)
    levels = torch.from_numpy(rng.integers(0, 256, (n, 1, coarse, coarse)).astype(np.float32))
    up = F.interpolate(levels, size=(size, size), mode="bicubic", align_corners=False)[:, 0]
    noise = torch.from_numpy(rng.integers(-12, 13, (n, size, size)).astype(np.float32))
    return (up + noise).round().clamp(0, 255).to(torch.uint8).numpy()


def _cup(pixels: np.ndarray, labels: np.ndarray, cup: dict) -> np.ndarray:
    """``pixels`` with a bright central disc (the optic cup) whose radius, a
    share of the side, is ``cup["radius"][label]``: the cup-to-disc ratio
    that grows with glaucoma, so each class's images differ in content."""
    size = pixels.shape[-1]
    yy, xx = np.mgrid[:size, :size]
    r = np.hypot(yy - (size - 1) / 2, xx - (size - 1) / 2) / size
    discs = np.stack([r < rad for rad in cup["radius"]])  # [classes, size, size]
    return np.clip(pixels.astype(np.int16) + cup["level"] * discs[labels], 0, 255).astype(np.uint8)


def write_fixture(root: str, traffic: dict, seed: int) -> dict:
    """Write the traffic's FairFedMed sites under ``root/fairfedmed`` and
    return what the reference needs, in each split's CSV order:
    ``{site: {split: {"pixels": uint8 [n, H, W] as stored, "label": [n],
    "attrs": {attr: [n]}}}}``.  Labels and attributes are laid out so every
    demographic group holds both classes, then shuffled; with ``cup`` each
    image carries its class's optic cup (``_cup``)."""
    rng = np.random.default_rng([seed, 17])
    base = os.path.join(root, "fairfedmed")
    all_dir = os.path.join(base, "all")
    os.makedirs(all_dir, exist_ok=True)
    modality, size = traffic["modality"], traffic["size"]
    if modality != "slo_fundus":
        raise NotImplementedError(f"the fixture writer makes slo_fundus sites, not {modality}")
    groups = traffic["groups"]
    every = traffic["deflate_every"]
    out, counter, jobs = {}, 0, []
    pool = ThreadPoolExecutor(WRITERS)  # deflate releases the GIL
    for site in range(1, traffic["sites"] + 1):
        out[site] = {}
        for split in ("train", "test"):
            n = traffic[f"{split}_per_site"]
            i, order = np.arange(n), rng.permutation(n)
            labels = (i % 2)[order]
            attrs = {a: ((i // 2) % g)[order] for a, g in groups.items()}
            pixels = _smooth_images(rng, n, size)
            if "cup" in traffic:
                pixels = _cup(pixels, labels, traffic["cup"])
            fnames = []
            for j in range(n):
                fname = f"data_{counter:05d}.npz"
                save = np.savez_compressed if every and counter % every else np.savez
                jobs.append(pool.submit(
                    save, os.path.join(all_dir, fname), **{modality: pixels[j]},
                    glaucoma=np.asarray(labels[j]), **{a: np.asarray(v[j]) for a, v in attrs.items()}))
                fnames.append(fname)
                counter += 1
            for attr in groups:
                with open(os.path.join(base, f"meta_site{site}_{attr}_{split}.csv"), "w",
                          newline="") as f:
                    w = csv.writer(f)
                    w.writerow(["filename"])
                    w.writerows([fn] for fn in fnames)
            out[site][split] = {"pixels": pixels, "label": labels, "attrs": attrs}
    for job in jobs:
        job.result()
    pool.shutdown()
    return out


def fed_images(pixels: np.ndarray) -> np.ndarray:
    """What the dataset gives the model for stored SLO pixels [n, H, W]:
    the transpose, repeated over 3 channels -> [n, 3, W, H] uint8."""
    t = np.ascontiguousarray(np.transpose(pixels, (0, 2, 1)))
    return np.repeat(t[:, None], 3, axis=1)


# --------------------------------------------------------------------------- weights


def checkpoint_leaves(arch: dict, init: dict = None) -> list:
    """``(key, shape, init)`` of an OpenAI CLIP state dict of ``arch`` (the
    keyword names of ``clip/model.py:CLIP``); ``init`` is ``("normal",
    std)``, ``("ones",)``, ``("zeros",)`` or ``("const", value)``.  Standard
    deviations follow ``CLIP.initialize_parameters`` and, for convolutions,
    He's rule, except where the configuration's ``init`` says otherwise:
    ``positional_embedding_std`` (the text tower's; CLIP draws 0.01) and
    ``bn3_weight`` (each bottleneck's last BatchNorm weight; CLIP starts it
    at 0, so that each residual block starts as the identity)."""
    init = init or {}
    leaves = []

    def ln(name, dim):
        leaves.extend([(f"{name}.weight", (dim,), ("ones",)), (f"{name}.bias", (dim,), ("zeros",))])

    def blocks(prefix, layers, width):
        attn_std, proj_std, fc_std = width ** -0.5, width ** -0.5 * (2 * layers) ** -0.5, (2 * width) ** -0.5
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            leaves.extend([
                (f"{p}.attn.in_proj_weight", (3 * width, width), ("normal", attn_std)),
                (f"{p}.attn.in_proj_bias", (3 * width,), ("zeros",)),
                (f"{p}.attn.out_proj.weight", (width, width), ("normal", proj_std)),
                (f"{p}.attn.out_proj.bias", (width,), ("zeros",)),
                (f"{p}.mlp.c_fc.weight", (4 * width, width), ("normal", fc_std)),
                (f"{p}.mlp.c_fc.bias", (4 * width,), ("zeros",)),
                (f"{p}.mlp.c_proj.weight", (width, 4 * width), ("normal", proj_std)),
                (f"{p}.mlp.c_proj.bias", (width,), ("zeros",))])
            ln(f"{p}.ln_1", width)
            ln(f"{p}.ln_2", width)

    def bn(name, dim, weight=None):
        if weight is not None:
            leaves.extend([(f"{name}.weight", (dim,), ("const", weight)),
                           (f"{name}.bias", (dim,), ("zeros",))])
        else:
            ln(name, dim)
        leaves.extend([(f"{name}.running_mean", (dim,), ("zeros",)),
                       (f"{name}.running_var", (dim,), ("ones",))])

    def conv(name, cout, cin, k):
        leaves.append((name, (cout, cin, k, k), ("normal", math.sqrt(2.0 / (cin * k * k)))))

    embed, res = arch["embed_dim"], arch["image_resolution"]
    if arch["kind"] == "vit":
        w, p = arch["vision_width"], arch["vision_patch_size"]
        grid = res // p
        leaves.extend([
            ("visual.class_embedding", (w,), ("normal", w ** -0.5)),
            ("visual.positional_embedding", (grid * grid + 1, w), ("normal", w ** -0.5)),
            ("visual.conv1.weight", (w, 3, p, p), ("normal", (3 * p * p) ** -0.5)),
            ("visual.proj", (w, embed), ("normal", w ** -0.5))])
        ln("visual.ln_pre", w)
        ln("visual.ln_post", w)
        blocks("visual.transformer", arch["vision_layers"], w)
    else:
        w = arch["vision_width"]
        conv("visual.conv1.weight", w // 2, 3, 3)
        conv("visual.conv2.weight", w // 2, w // 2, 3)
        conv("visual.conv3.weight", w, w // 2, 3)
        for i, dim in ((1, w // 2), (2, w // 2), (3, w)):
            bn(f"visual.bn{i}", dim)
        inplanes = w
        for li, nblocks in enumerate(arch["vision_layers"]):
            planes = w * 2 ** li
            for bi in range(nblocks):
                pre = f"visual.layer{li + 1}.{bi}"
                conv(f"{pre}.conv1.weight", planes, inplanes, 1)
                conv(f"{pre}.conv2.weight", planes, planes, 3)
                conv(f"{pre}.conv3.weight", planes * 4, planes, 1)
                for name, dim in (("bn1", planes), ("bn2", planes), ("bn3", planes * 4)):
                    bn(f"{pre}.{name}", dim,
                       init.get("bn3_weight", 0.0) if name == "bn3" else None)
                if bi == 0 and (li > 0 or inplanes != planes * 4):
                    conv(f"{pre}.downsample.0.weight", planes * 4, inplanes, 1)
                    bn(f"{pre}.downsample.1", planes * 4)
                inplanes = planes * 4
        c = w * 32
        grid = res // 32
        leaves.append(("visual.attnpool.positional_embedding", (grid * grid + 1, c),
                       ("normal", c ** -0.5)))
        for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
            out = embed if name == "c_proj" else c
            leaves.extend([(f"visual.attnpool.{name}.weight", (out, c), ("normal", c ** -0.5)),
                           (f"visual.attnpool.{name}.bias", (out,), ("zeros",))])
    tw = arch["transformer_width"]
    leaves.extend([
        ("token_embedding.weight", (arch["vocab_size"], tw), ("normal", 0.02)),
        ("positional_embedding", (arch["context_length"], tw),
         ("normal", init.get("positional_embedding_std", 0.01))),
        ("text_projection", (tw, embed), ("normal", tw ** -0.5)),
        ("logit_scale", (), ("const", arch["logit_scale"]))])
    ln("ln_final", tw)
    blocks("transformer", arch["transformer_layers"], tw)
    return leaves


def make_checkpoint(arch: dict, seed: int, device, init: dict = None) -> dict:
    """The state dict of ``arch`` (``init``: see ``checkpoint_leaves``) in
    float16 on the host, its normal leaves drawn on ``device`` in one call
    from a generator seeded with ``seed``, scaled, cast and copied back in
    one transfer (views of one storage)."""
    leaves = checkpoint_leaves(arch, init)
    normal = [(k, s, init[1]) for k, s, init in leaves if init[0] == "normal"]
    sizes = [math.prod(s) for _, s, _ in normal]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    stds = torch.repeat_interleave(torch.tensor([std for _, _, std in normal], device=device),
                                   torch.tensor(sizes, device=device))
    flat = (flat * stds).half().cpu()
    sd, offset = {}, 0
    for (key, shape, _), n in zip(normal, sizes):
        sd[key] = flat[offset:offset + n].view(shape)
        offset += n
    for key, shape, init in leaves:
        if init[0] == "ones":
            sd[key] = torch.ones(shape, dtype=torch.float16)
        elif init[0] == "zeros":
            sd[key] = torch.zeros(shape, dtype=torch.float16)
        elif init[0] == "const":
            sd[key] = torch.full(shape, init[1], dtype=torch.float16)
    return sd


def checkpoint_file(root: str, backbone: str) -> str:
    """Where the program looks for the backbone's checkpoint
    (``<root>/clip/<ViT-B-16|RN50>.pt``)."""
    return os.path.join(root, "clip", backbone.replace("/", "-") + ".pt")


# --------------------------------------------------------------------------- launcher

_PARALLEL_SWITCH = re.compile(r'^\$\(\[ "\$\{PARALLEL_CLIENTS:-1\}" = "1" \] && echo (--\S+)\)$')


def launcher_flags(path: str) -> list:
    """The ``federated_main.py`` flags of a launcher script as it runs by
    default (``PARALLEL_CLIENTS`` unset, so its client-parallel switch is
    kept), with its shell variables substituted (``${VAR:-default}`` takes
    the default)."""
    with open(path) as f:
        text = f.read()
    env = {}
    for name, value in re.findall(r"^(\w+)=(\$\(.*)$", text, re.M):
        switch = _PARALLEL_SWITCH.match(value)
        if switch:
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


def set_flag(argv: list, flag: str, *values) -> list:
    """``argv`` with ``flag`` set to ``values`` (replaced where present)."""
    argv = list(argv)
    if flag in argv:
        i = argv.index(flag)
        j = i + 1
        while j < len(argv) and not argv[j].startswith("--"):
            j += 1
        argv[i:j] = [flag, *values]
    else:
        argv += [flag, *values]
    return argv
