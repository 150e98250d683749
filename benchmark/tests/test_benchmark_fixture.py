"""The traffic generator's fixture as the port reads it, on the CPU."""

import os

import numpy as np

from benchmark import harness, inputs, spec

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
            images = inputs.fed_images(want["pixels"])
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
