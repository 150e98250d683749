"""The architecture and modality plug-ins (``archs/``, ``modalities/``):
the ``vit``, ``resnet`` and ``slo_fundus`` code held to the values the
harness gave before it moved into them (``data/pinned.json``: checkpoint
leaves and bytes, multiply-adds, attention calls, the SLO fixture, and the
reference's logits, loss, gradients and stepped state at tiny sizes, bit
for bit on the CPU), and a toy kind and a toy modality, added as files in a
temporary root, run through the checkpoint, the counts and the
reference."""

import glob
import hashlib
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from benchmark import inputs, spec
from benchmark.metrics import _flops
from benchmark.reference import model as ref

DATA = spec.HERE / "tests" / "data"
PINNED = spec.load_json(DATA / "pinned.json")
NAMES = ["NOT Glaucoma", "Glaucoma"]
SLO = spec.load_json(spec.HERE / "traffic" / "slo_fundus.json")
ROUNDS = [{"n_steps": [16, 15], "eval_rows": 590, "eval_batches": 6, "eval_batches_run": 8},
          {"n_steps": [3, 0, 2], "eval_rows": 7, "eval_batches": 1, "eval_batches_run": 3}]
CONFIGS = {"clip_vit_b16_fairlora": spec.HERE / "configs", "clip_rn50_fairlora": spec.HERE / "configs",
           "tiny_vit": DATA / "configs", "tiny_rn": DATA / "configs"}


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().contiguous().numpy() if torch.is_tensor(a) else np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _config(name):
    return spec.load_json(CONFIGS[name] / f"{name}.json")


def _state(shapes: dict, g: torch.Generator) -> dict:
    """A trainable state under the program's names, drawn from ``g``."""
    state = {}
    for k in sorted(shapes):
        r = torch.randn(shapes[k], generator=g)
        if k.endswith(".var"):
            state[k] = 0.5 + r.abs()
        elif k.startswith("visual_bn.") and k.endswith(".weight"):
            state[k] = 1.0 + 0.1 * r
        elif k == "prompt_learner.ctx":
            state[k] = 0.02 * r
        else:
            state[k] = 0.1 * r
    return state


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_leaves_counts_and_calls_are_pinned(name):
    config = _config(name)
    arch, rank = config["arch"], config["method"]["lora_rank"]
    leaves = inputs.checkpoint_leaves(arch, config.get("init"))
    assert len(leaves) == PINNED[f"{name}.n_leaves"]
    assert hashlib.sha256(json.dumps(leaves).encode()).hexdigest() == PINNED[f"{name}.leaves"]
    assert list(spec.load_arch(arch["kind"]).image_macs(arch, rank)) == PINNED[f"{name}.image_macs"]
    assert _flops.round_flops(config, SLO, ROUNDS, 32) == PINNED[f"{name}.round_flops"]
    calls = _flops.attention_calls(config, SLO, ROUNDS, 32, 100)
    assert len(calls) == PINNED[f"{name}.n_attention_calls"]
    assert hashlib.sha256(json.dumps(calls).encode()).hexdigest() == PINNED[f"{name}.attention_calls"]


@pytest.mark.parametrize("name", ["tiny_vit", "tiny_rn"])
def test_checkpoint_and_reference_are_pinned(name):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = _config(name)
        sd = inputs.make_checkpoint(config["arch"], 2 ** 31 + 3, "cpu", config.get("init"))
        assert _sha(*[sd[k] for k in sorted(sd)]) == PINNED[f"{name}.checkpoint"]
        g = torch.Generator().manual_seed(5)
        state = _state(PINNED[f"{name}.state_shapes"], g)
        img = torch.randint(0, 256, (4, 3, 32, 32), generator=g).to(torch.uint8)
        batch = {"img": img, "label": torch.tensor([0, 1, 1, 0]), "attr": torch.tensor([0, 1, 2, 1])}
        for prec in ("fp32", "fp8"):
            model = ref.ReferenceCLIP(sd, config, SLO, "cpu", prec)
            with torch.no_grad():
                logits, _ = model.logits(state, img, batch["attr"], train=False)
            assert _sha(logits) == PINNED[f"{name}.{prec}.eval_logits"]
            trace = {k: torch.zeros_like(v) for k, v in state.items() if not k.startswith("__bn_stats__")}
            new, _, loss, grads = ref.train_step(model, state, trace, batch, 0.01, config["optim"])
            assert repr(loss) == PINNED[f"{name}.{prec}.loss"]
            assert _sha(*[grads[k] for k in sorted(grads)]) == PINNED[f"{name}.{prec}.grads"]
            assert _sha(*[new[k] for k in sorted(new)]) == PINNED[f"{name}.{prec}.state"]
    finally:
        torch.set_num_threads(threads)


def test_slo_fixture_is_pinned(tmp_path):
    traffic = spec.load_json(DATA / "traffic" / "tiny_slo.json")
    fixture = inputs.write_fixture(str(tmp_path), traffic, 2 ** 31 + 5)
    modality = spec.load_modality("slo_fundus")
    arrays = []
    for site in sorted(fixture):
        for split in ("train", "test"):
            d = fixture[site][split]
            arrays += [d["pixels"], d["label"]] + [d["attrs"][a] for a in sorted(d["attrs"])]
            arrays.append(modality.fed(d["pixels"], traffic))
    assert _sha(*arrays) == PINNED["tiny_slo.fixture"]
    files = sorted(glob.glob(str(tmp_path / "fairfedmed" / "all" / "*.npz")))
    h = hashlib.sha256()
    for f in files:
        with np.load(f) as z:
            for k in sorted(z.files):
                h.update(k.encode())
                h.update(z[k].tobytes())
                h.update(str(z[k].dtype).encode())
        h.update(str(os.path.getsize(f) > 0).encode())
    assert h.hexdigest() == PINNED["tiny_slo.npz_members"]
    assert [zipfile.ZipFile(f).infolist()[0].compress_type for f in files][:6] \
        == PINNED["tiny_slo.compressed"]
    h = hashlib.sha256()
    for f in sorted(glob.glob(str(tmp_path / "fairfedmed" / "*.csv"))):
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    assert h.hexdigest() == PINNED["tiny_slo.csvs"]


# --------------------------------------------------------------------------- a toy kind and modality

TOY_ARCH = '''"""A toy image tower: patches, one projection with FairLoRA, the mean
patch as the class token."""

import torch

PATCH = 8


def image_leaves(arch, init):
    return [("visual.proj_in", (arch["embed_dim"], 3 * PATCH * PATCH), ("normal", 0.05))]


def image_macs(arch, rank, input_grad=False):
    patches = (arch["image_resolution"] // PATCH) ** 2
    fwd = patches * 3 * PATCH * PATCH * (arch["embed_dim"] + rank) + patches * rank * arch["embed_dim"]
    return fwd, 2 * fwd


def attention(arch, input_grad=False):
    return {"length": (arch["image_resolution"] // PATCH) ** 2 + 1, "dh": 8, "heads": 2,
            "backward": [True, False]}


def tokens(model, x, state, mix, train):
    p = x.unfold(2, PATCH, PATCH).unfold(3, PATCH, PATCH)  # [B, 3, g, g, P, P]
    p = p.permute(0, 2, 3, 1, 4, 5).reshape(x.shape[0], -1, 3 * PATCH * PATCH)
    y = model.num.linear(p, model.sd["visual.proj_in"])
    s = mix @ state["image_encoder_lora.toy.lora_S"]
    y = y + model.lora(p, state["image_encoder_lora.toy.lora_A"], s,
                       state["image_encoder_lora.toy.lora_B"])
    return torch.cat([y.mean(1, keepdim=True), y], dim=1), {}
'''

TOY_MODALITY = '''"""A toy modality: one grey image a sample; the dataset gives it and its
mirror image, each the model sees as 3 equal channels."""

import numpy as np

TRAINABLE_FRONT = False


def make_split(rng, labels, traffic, device):
    size = traffic["size"]
    return (rng.integers(0, 200, (len(labels), size, size)) + 40 * labels[:, None, None]).astype(np.uint8)


def npz_members(stored):
    return {"toy_grey": stored}


def fed(stored, traffic):
    return np.stack([stored, stored[:, :, ::-1]], axis=1)


def images_per_sample(traffic):
    return 2


def front_macs(traffic):
    return 0, 0


def front(model, img, state):
    n, k, h, w = img.shape
    x = img.float().reshape(n * k, 1, h, w).expand(n * k, 3, h, w) / 255.0
    return (x - model.mean) / model.std
'''


def test_a_toy_kind_and_modality_are_files(tmp_path, monkeypatch):
    """A kind and a modality that the harness has never seen, added as files
    under a cell's root, drive the checkpoint, the counts and the reference
    without an edit to the harness."""
    harness_files = {p: p.read_bytes() for p in spec.HERE.rglob("*.py")}
    for sub in ("archs", "modalities", "configs", "traffic", "workloads"):
        (tmp_path / sub).mkdir()
    (tmp_path / "archs" / "toy_patch.py").write_text(TOY_ARCH)
    (tmp_path / "modalities" / "toy_grey.py").write_text(TOY_MODALITY)
    config = _config("tiny_vit")
    config["arch"] = {"kind": "toy_patch", "embed_dim": 16, "image_resolution": 16,
                      **{k: config["arch"][k] for k in ("context_length", "vocab_size",
                                                        "transformer_width", "transformer_heads",
                                                        "transformer_layers", "logit_scale")}}
    config["name"] = "toy_cfg"
    traffic = {**spec.load_json(DATA / "traffic" / "tiny_slo.json"), "modality": "toy_grey",
               "size": 16, "train_per_site": 6, "test_per_site": 4}
    (tmp_path / "configs" / "toy_cfg.json").write_text(json.dumps(config))
    (tmp_path / "traffic" / "toy_mix.json").write_text(json.dumps(traffic))
    (tmp_path / "workloads" / "toy_cell.json").write_text(
        (DATA / "workloads" / "tiny_vit_slo.json").read_text())
    bench = {"configs": [{"name": "toy_cfg", "file": "benchmark/configs/toy_cfg.json"}],
             "workloads": [{"name": "toy_cell", "config": "toy_cfg", "traffic": "toy_mix",
                            "chips": 1}], "end_to_end": [], "per_layer": []}
    cell = spec.load_cell("toy_cell", bench, root=tmp_path)
    assert cell.config["arch"]["kind"] == "toy_patch" and cell.traffic["modality"] == "toy_grey"
    monkeypatch.setattr(spec, "PLUGIN_ROOTS", [tmp_path, spec.HERE])
    arch, modality = spec.load_arch("toy_patch"), spec.load_modality("toy_grey")
    assert arch.__file__ == str(tmp_path.resolve() / "archs" / "toy_patch.py")
    assert spec.load_arch("vit").__name__ == "benchmark.archs.vit"  # the harness's own stays

    # the fixture: NPZs named by the modality, what the dataset gives
    fixture = inputs.write_fixture(str(tmp_path / "data"), traffic, 11)
    stored = fixture[1]["train"]["pixels"]
    with np.load(tmp_path / "data" / "fairfedmed" / "all" / "data_00000.npz") as z:
        assert np.array_equal(z["toy_grey"], stored[0])
    fed = modality.fed(stored, traffic)
    assert fed.shape == (6, 2, 16, 16)

    # the checkpoint: the toy tower's leaf, then the text tower's
    leaves = inputs.checkpoint_leaves(config["arch"], config.get("init"))
    assert leaves[0] == ("visual.proj_in", (16, 192), ("normal", 0.05))
    sd = inputs.make_checkpoint(config["arch"], 3, "cpu", config.get("init"))
    assert sd["visual.proj_in"].shape == (16, 192)

    # the counts: two images a sample through the toy tower
    rank = config["method"]["lora_rank"]
    image = arch.image_macs(config["arch"], rank)
    assert image == (4 * 192 * (16 + rank) + 4 * rank * 16, 2 * (4 * 192 * (16 + rank) + 4 * rank * 16))
    text = _flops.text_macs(config["arch"], config["method"], NAMES)
    rounds = [{"n_steps": [2, 1], "eval_rows": 5, "eval_batches": 2, "eval_batches_run": 2}]
    assert _flops.round_flops(config, traffic, rounds, 4) == 2 * (
        3 * 4 * 2 * sum(image) + 3 * sum(text) + 5 * 2 * image[0] + 2 * text[0])
    calls = _flops.attention_calls(config, traffic, rounds, 4, 3)
    vision = [c for c in calls if not c["causal"]]
    assert len(vision) == 2 * 3 + 2 * 2
    assert {(c["n"], c["length"], c["dh"], c["backward"]) for c in vision} == {
        (4 * 2 * 2, 5, 8, True), (4 * 2 * 2, 5, 8, False), (3 * 2 * 2, 5, 8, False)}

    # the reference: logits of a sample are its two images' mean; gradients reach the adapter
    g = torch.Generator().manual_seed(1)
    state = {"prompt_learner.ctx": 0.02 * torch.randn(2, 4, 64, generator=g),
             "image_encoder_lora.toy.lora_A": 0.1 * torch.randn(192, rank, generator=g),
             "image_encoder_lora.toy.lora_S": torch.rand(3, rank, generator=g),
             "image_encoder_lora.toy.lora_B": 0.1 * torch.randn(rank, 16, generator=g)}
    model = ref.ReferenceCLIP(sd, config, traffic, "cpu")
    img, attr = torch.as_tensor(fed[:3]), torch.tensor([0, 2, 1])
    logits, stats = model.logits(state, img, attr, train=True)
    assert logits.shape == (3, 2) and stats == {}
    halves = [model.logits(state, img[:, k:k + 1].expand(3, 2, 16, 16).contiguous(), attr,
                           train=False)[0] for k in (0, 1)]
    assert torch.allclose(logits, (halves[0] + halves[1]) / 2, atol=1e-5)
    batch = {"img": img, "label": torch.tensor([0, 1, 1]), "attr": attr}
    trace = {k: torch.zeros_like(v) for k, v in state.items()}
    new, _, loss, grads = ref.train_step(model, state, trace, batch, 0.01, config["optim"])
    assert np.isfinite(loss)
    assert all(float(grads[k].abs().sum()) > 0 for k in state)
    assert not torch.equal(new["image_encoder_lora.toy.lora_B"], state["image_encoder_lora.toy.lora_B"])
    assert harness_files == {p: p.read_bytes() for p in spec.HERE.rglob("*.py")}
    monkeypatch.undo()
    with pytest.raises(KeyError):  # outside the test's root the toy kind is unknown
        spec.load_arch("toy_patch")
