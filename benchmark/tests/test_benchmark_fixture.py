"""The traffic generator's fixture as the port reads it, on the CPU."""

import os

import numpy as np
import pytest
import torch

from benchmark import harness, inputs, spec
from benchmark.reference import model as ref

DATA = spec.HERE / "tests" / "data"


def _tiny_cell():
    bench = {"configs": [{"name": "tiny_vit", "file": "benchmark/tests/data/configs/tiny_vit.json"}],
             "workloads": [{"name": "tiny_vit_slo", "config": "tiny_vit", "traffic": "tiny_slo",
                            "chips": 1}], "end_to_end": [], "per_layer": []}
    return spec.load_cell("tiny_vit_slo", bench, root=DATA)


def test_fixture_is_deterministic_and_read_by_the_data_manager(tmp_path):
    from fairfedmed_tpu_torch import federated_main as fm
    from fairfedmed_tpu_torch.data.manager import DataManager

    cell = _tiny_cell()
    fixture = inputs.write_fixture(str(tmp_path / "a"), cell.traffic, 2 ** 31 + 5)
    again = inputs.write_fixture(str(tmp_path / "b"), cell.traffic, 2 ** 31 + 5)
    assert all(np.array_equal(fixture[s][sp]["pixels"], again[s][sp]["pixels"])
               for s in fixture for sp in ("train", "test"))
    names = sorted(os.listdir(tmp_path / "a" / "fairfedmed" / "all"))
    assert len(names) == 3 * (96 + 20)
    argv = harness.build_argv(cell, str(tmp_path / "a"), str(tmp_path / "out"), 7)
    args = fm.build_arg_parser().parse_args(argv)
    dm = DataManager(fm.setup_cfg(args))
    attr = cell.traffic["attribute_type"]
    col = list(dm.dataset.federated_train_x[0].attributes).index(attr)
    for site in (1, 2, 3):
        for split, loaders in (("train", dm.fed_train_loader_x_dict),
                               ("test", dm.fed_test_loader_x_dict)):
            ds = loaders[site - 1].dataset
            want = fixture[site][split]
            images = spec.load_modality(cell.traffic["modality"]).fed(want["pixels"], cell.traffic)
            assert len(ds) == len(want["label"])
            for i in (0, len(ds) - 1):
                img, label, attrs = ds.load_item_u8(i)
                assert np.array_equal(img, images[i])
                assert label == want["label"][i] and attrs[col] == want["attrs"][attr][i]
            assert ds.count_by_attribute(attr) == np.bincount(want["attrs"][attr]).tolist()


def test_launcher_flags_and_overrides():
    cell = _tiny_cell()
    argv = harness.build_argv(cell, "/data", "/out", 2 ** 31 + 9)
    assert argv[argv.index("--seed") + 1] == "9"
    assert argv[argv.index("--round") + 1] == "10000"
    assert argv[argv.index("--lora_rank") + 1] == "12"
    assert "--parallel_clients" in argv
    assert argv[-6:] == cell.config["opts"]


def _oct_cell(**traffic):
    bench = {"configs": [{"name": "tiny_vit", "file": "benchmark/tests/data/configs/tiny_vit.json"}],
             "workloads": [{"name": "tiny_vit_oct", "config": "tiny_vit", "traffic": "tiny_oct",
                            "chips": 1}], "end_to_end": [], "per_layer": []}
    cell = spec.load_cell("tiny_vit_oct", bench, root=DATA)
    cell.traffic = {**cell.traffic, **traffic}
    return cell


@pytest.mark.parametrize("height", [40, 32], ids=["resized", "at_size"])
def test_oct_fixture_as_the_port_reads_it(height, tmp_path):
    """The OCT volumes the generator writes, what ``fed`` says the dataset
    gives and what the port's dataset gives (``load_item``, and
    ``load_item_u8`` where no resize is needed), bit for bit; and the
    reference's front end against the port's ``_preprocess``."""
    from fairfedmed_tpu_torch import federated_main as fm

    cell = _oct_cell(height=height, width=height, train_per_site=6, test_per_site=4)
    fixture = inputs.write_fixture(str(tmp_path / "a"), cell.traffic, 2 ** 31 + 13)
    again = inputs.write_fixture(str(tmp_path / "b"), cell.traffic, 2 ** 31 + 13)
    stored = fixture[1]["train"]["pixels"]
    assert stored.dtype == np.uint8 and stored.shape == (6, 128, height, height)
    assert np.array_equal(stored, again[1]["train"]["pixels"])
    labels = fixture[1]["train"]["label"]
    # the rows just inside class 0's thicker band and just outside it: a step
    # of the band's level in class 0's volumes, none in class 1's
    layer = cell.traffic["layer"]
    y = (np.arange(height) + 0.5) / height
    edge = layer["centre"] - layer["thickness"][0] / 2
    inside, outside = (y >= edge) & (y < edge + 0.04), (y < edge) & (y >= edge - 0.04)
    rows = stored.astype(np.float64).mean(axis=(1, 3))  # [n, height]
    step = rows[:, inside].mean(1) - rows[:, outside].mean(1)
    assert step[labels == 0].min() > layer["level"] / 2 > step[labels == 1].max()

    ckpt = inputs.checkpoint_file(str(tmp_path / "a"), cell.config["backbone"])
    os.makedirs(os.path.dirname(ckpt))
    torch.save(inputs.make_checkpoint(cell.config["arch"], 3, "cpu", cell.config.get("init")), ckpt)
    argv = harness.build_argv(cell, str(tmp_path / "a"), str(tmp_path / "out"), 7)
    cfg = fm.setup_cfg(fm.build_arg_parser().parse_args(argv))
    trainer = fm.build_trainer(cfg, device=torch.device("cpu"))
    ds = trainer.fed_train_loader_x_dict[0].dataset
    fed = spec.load_modality(cell.traffic["modality"]).fed(stored, cell.traffic)
    assert fed.dtype == np.float32 and fed.shape == (6, 32, 32, 32)
    for i in range(len(ds)):
        img, label, _ = ds.load_item(i)
        assert np.array_equal(img, fed[i]) and label == labels[i]
        u8 = ds.load_item_u8(i)
        if height == 32:
            assert np.array_equal(u8[0], fed[i])
        else:
            assert u8 is None

    # the front end: the trainer's slice projector, the reference's own arithmetic
    proj = trainer.trainable["proj_per_3d_slice"]
    state = {f"proj_per_3d_slice.{k}": v.detach().float() + (0.1 if k == "bias" else 0.0)
             for k, v in proj.items()}
    sd = {"token_embedding.weight": torch.zeros(49408, 64), "positional_embedding": torch.zeros(77, 64)}
    model = ref.ReferenceCLIP(sd, cell.config, cell.traffic, "cpu")
    img = torch.as_tensor(fed[:4])
    want = spec.load_modality(cell.traffic["modality"]).front(model, img, state)
    with torch.no_grad():
        got = trainer._preprocess(img, {"proj_per_3d_slice": {
            k: state[f"proj_per_3d_slice.{k}"] for k in proj}})
    assert want.shape == got.shape == (8, 3, 32, 32)
    assert torch.allclose(want, got, atol=1e-5, rtol=1e-5)
    assert spec.load_modality(cell.traffic["modality"]).images_per_sample(cell.traffic) == 2
