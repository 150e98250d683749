"""The run's inputs, made from its seed: a FairFedMed-Oph fixture (the
traffic), a CLIP checkpoint of seeded random weights in OpenAI's key layout
(the configuration), and the launcher script's flags.

``write_fixture`` is a copy of ``chip_smoke.py:write_fairfedmed_fixture``
(the layout of ``dataset.md``: ``fairfedmed/all/data_*.npz`` and
``meta_site{k}_{attr}_{split}.csv``) driven by a traffic file; the images
come from the traffic's modality module (``modalities/``).
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

from . import spec

WRITERS = 4  # threads writing the fixture's files

# --------------------------------------------------------------------------- traffic


def write_fixture(root: str, traffic: dict, seed: int, device="cpu") -> dict:
    """Write the traffic's FairFedMed sites under ``root/fairfedmed`` and
    return what the reference needs, in each split's CSV order:
    ``{site: {split: {"pixels": the stored arrays [n, ...], "label": [n],
    "attrs": {attr: [n]}}}}``.  Labels and attributes are laid out so every
    demographic group holds both classes, then shuffled.  The modality's
    module (``modalities/<modality>.py``) makes each split's stored arrays,
    from the run's generator and on ``device`` where it draws there, and
    names the NPZ's members.  A file whose running number is not a multiple
    of ``deflate_every`` is deflated (``deflate_every`` 0 or absent: none
    is)."""
    rng = np.random.default_rng([seed, 17])
    base = os.path.join(root, "fairfedmed")
    all_dir = os.path.join(base, "all")
    os.makedirs(all_dir, exist_ok=True)
    modality = spec.load_modality(traffic["modality"])
    groups = traffic["groups"]
    every = traffic.get("deflate_every", 0)
    out, counter, jobs = {}, 0, []
    pool = ThreadPoolExecutor(WRITERS)  # deflate and file writes release the GIL
    for site in range(1, traffic["sites"] + 1):
        out[site] = {}
        for split in ("train", "test"):
            n = traffic[f"{split}_per_site"]
            i, order = np.arange(n), rng.permutation(n)
            labels = (i % 2)[order]
            attrs = {a: ((i // 2) % g)[order] for a, g in groups.items()}
            stored = modality.make_split(rng, labels, traffic, device)
            fnames = []
            for j in range(n):
                fname = f"data_{counter:05d}.npz"
                save = np.savez_compressed if every and counter % every else np.savez
                jobs.append(pool.submit(
                    save, os.path.join(all_dir, fname), **modality.npz_members(stored[j]),
                    glaucoma=np.asarray(labels[j]), **{a: np.asarray(v[j]) for a, v in attrs.items()}))
                fnames.append(fname)
                counter += 1
            for attr in groups:
                with open(os.path.join(base, f"meta_site{site}_{attr}_{split}.csv"), "w",
                          newline="") as f:
                    w = csv.writer(f)
                    w.writerow(["filename"])
                    w.writerows([fn] for fn in fnames)
            out[site][split] = {"pixels": stored, "label": labels, "attrs": attrs}
    for job in jobs:
        job.result()
    pool.shutdown()
    return out


# --------------------------------------------------------------------------- weights


def ln_leaves(name: str, dim: int) -> list:
    """A LayerNorm's (or a BatchNorm's affine) weight 1 and bias 0."""
    return [(f"{name}.weight", (dim,), ("ones",)), (f"{name}.bias", (dim,), ("zeros",))]


def block_leaves(prefix: str, layers: int, width: int) -> list:
    """CLIP's residual attention blocks ``<prefix>.resblocks.<i>``, with the
    standard deviations of ``CLIP.initialize_parameters``."""
    attn_std, proj_std, fc_std = width ** -0.5, width ** -0.5 * (2 * layers) ** -0.5, (2 * width) ** -0.5
    leaves = []
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
        leaves += ln_leaves(f"{p}.ln_1", width) + ln_leaves(f"{p}.ln_2", width)
    return leaves


def checkpoint_leaves(arch: dict, init: dict = None) -> list:
    """``(key, shape, init)`` of an OpenAI CLIP state dict of ``arch`` (the
    keyword names of ``clip/model.py:CLIP``); ``init`` is ``("normal",
    std)``, ``("ones",)``, ``("zeros",)`` or ``("const", value)``.  The image
    tower's leaves come from its module (``archs/<kind>.py``), then the text
    tower's.  Standard deviations follow ``CLIP.initialize_parameters`` and,
    for convolutions, He's rule, except where the configuration's ``init``
    says otherwise (``positional_embedding_std``, the text tower's: CLIP
    draws 0.01; the tower's own keys)."""
    init = init or {}
    leaves = list(spec.load_arch(arch["kind"]).image_leaves(arch, init))
    embed, tw = arch["embed_dim"], arch["transformer_width"]
    leaves.extend([
        ("token_embedding.weight", (arch["vocab_size"], tw), ("normal", 0.02)),
        ("positional_embedding", (arch["context_length"], tw),
         ("normal", init.get("positional_embedding_std", 0.01))),
        ("text_projection", (tw, embed), ("normal", tw ** -0.5)),
        ("logit_scale", (), ("const", arch["logit_scale"]))])
    leaves += ln_leaves("ln_final", tw)
    return leaves + block_leaves("transformer", arch["transformer_layers"], tw)


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
