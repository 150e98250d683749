"""The port's checkpoints (``train/checkpoint.py``, the engine's full
format) and host timers (``utils/profiling.py``), against the JAX package's
semantics (``tests/test_checkpoint_profiling.py``,
``tests/test_e2e_federated.py:257-286``).

* ``save_pytree`` / ``load_pytree`` round-trip a nested tree of tensors
  and ints bit for bit, into ``step_N`` directories that ``latest_step``
  finds; a save replaces an earlier one of the same step and leaves no
  temporary directory; a template refuses a tree whose keys, shapes or
  dtypes differ; ``host_copy`` keeps every dtype;
* the full format: PromptFL and GLP_OT_SVLoRA (``test-vit`` at 32x32, fp32,
  on ``make_fairfedmed_fixture``) train an epoch, ``save_checkpoint``,
  have their weights clobbered, and ``resume_from_checkpoint`` restores the
  weights and the optimizer state exactly (the returned epoch is the saved
  one + 1); the root ``tools/train.py``'s ``.pth.tar`` name and pointer file;
* a trainer resumed from that checkpoint takes the same next step as the
  one that wrote it (bit for bit: the same arithmetic on the same state);
* ``HostTimers`` and ``stamp`` behave as the JAX package's.
"""

import os
import sys

import numpy as np
import pytest
import torch

from fairfedmed_tpu.utils import profiling as jprof
from fairfedmed_tpu_torch import federated_main as tfm
from fairfedmed_tpu_torch.train import checkpoint as ck
from fairfedmed_tpu_torch.train.engine import build_trainer, load_checkpoint
from fairfedmed_tpu_torch.utils import profiling as tprof
from tests.fixtures import make_fairfedmed_fixture
from tests.test_torch_port_cli import small_argv

torch.set_num_threads(1)


# --------------------------------------------------------------------------- #
# step_N pytrees
# --------------------------------------------------------------------------- #

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(2, 3, generator=g),
            "nested": {"b": torch.arange(4, dtype=torch.int32),
                       "c": torch.randn(5, generator=g).to(torch.bfloat16),
                       "flags": torch.tensor([True, False])},
            "blocks": [torch.randn(1, generator=g), torch.zeros(())],
            "count": 7}


def _assert_equal(got, want):
    assert type(got) is type(want) or (isinstance(want, tuple) and isinstance(got, list))
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        for a, b in zip(got, want):
            _assert_equal(a, b)
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    else:
        assert got == want


def test_pytree_round_trip_and_latest_step(tmp_path):
    tree = _tree()
    path = ck.save_pytree(str(tmp_path / "ckpt"), tree, step=3)
    assert path == str(tmp_path / "ckpt" / "step_3")
    assert ck.latest_step(str(tmp_path / "ckpt")) == 3
    _assert_equal(ck.load_pytree(path), tree)
    _assert_equal(ck.load_pytree(path, template=tree), tree)
    ck.save_pytree(str(tmp_path / "ckpt"), tree, step=11)
    assert ck.latest_step(str(tmp_path / "ckpt")) == 11
    # the same step again replaces it; no temporary directory stays behind
    tree2 = dict(tree, count=8)
    ck.save_pytree(str(tmp_path / "ckpt"), tree2, step=3)
    assert ck.load_pytree(path)["count"] == 8
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_11", "step_3"]
    # no step: the directory itself
    flat = ck.save_pytree(str(tmp_path / "flat"), tree)
    _assert_equal(ck.load_pytree(flat), tree)


def test_latest_step_empty(tmp_path):
    assert ck.latest_step(str(tmp_path / "missing")) is None
    os.makedirs(tmp_path / "empty" / "step_x")
    assert ck.latest_step(str(tmp_path / "empty")) is None


@pytest.mark.parametrize("change", ["missing_key", "extra_key", "shape", "dtype", "list_length",
                                    "tensor_for_int"])
def test_template_refuses_another_tree(tmp_path, change):
    tree = _tree()
    other = _tree()
    if change == "missing_key":
        del other["nested"]["b"]
    elif change == "extra_key":
        other["nested"]["d"] = torch.zeros(1)
    elif change == "shape":
        other["a"] = torch.zeros(3, 2)
    elif change == "dtype":
        other["a"] = other["a"].double()
    elif change == "list_length":
        other["blocks"].append(torch.zeros(1))
    else:
        other["count"] = torch.tensor(7)
    path = ck.save_pytree(str(tmp_path), other, step=0)
    with pytest.raises(ValueError, match="checkpoint"):
        ck.load_pytree(path, template=tree)


def test_host_copy_keeps_values_and_owns_its_storage():
    tree = _tree()
    out = ck.host_copy(tree)
    _assert_equal(out, tree)
    out["a"].add_(1.0)  # a copy: the source is untouched
    assert not torch.equal(out["a"], tree["a"])


# --------------------------------------------------------------------------- #
# the full format
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ffm_ckpt")
    make_fairfedmed_fixture(str(root), n_sites=2, n_train=8, n_test=6, size=32)
    return root


def _trainer(root, out_dir, trainer):
    argv = small_argv(root, out_dir, 1, extra=["--trainer", trainer]) + [
        "TRAINER.PROMPTFL.PREC", "fp32", "OPTIM.MOMENTUM", "0.9"]
    saved = sys.stdout
    try:
        args = tfm.build_arg_parser().parse_args(argv)
        args.idxs_users_train, args.idxs_users_test = [], []
        cfg = tfm.setup_cfg(args)
    finally:
        sys.stdout = saved
    torch.manual_seed(0)
    np.random.seed(0)
    return build_trainer(cfg, device="cpu")


def _opt_state(tr):
    return {i: {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in s.items()}
            for i, s in enumerate(tr.optimizer.state.values())}


@pytest.mark.parametrize("trainer", ["PromptFL", "GLP_OT_SVLoRA"])
def test_save_and_resume_checkpoint(fixture_root, tmp_path, trainer):
    tr = _trainer(fixture_root, tmp_path / "out", trainer)
    np.random.seed(1)
    tr.train(idx=0, global_epoch=0, is_fed=True)
    before = {k: v.copy() for k, v in tr.state_dict().items()}
    opt_before = _opt_state(tr)
    assert opt_before and all(s for s in opt_before.values())  # momentum traces exist
    path = tr.save_checkpoint(epoch=0, directory=str(tmp_path / "ck"))
    assert path.endswith("model.pth.tar-0")
    assert (tmp_path / "ck" / "checkpoint").read_text() == "model.pth.tar-0"
    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 1 and sorted(ckpt["state_dict"]) == sorted(before)
    # clobber the weights and the optimizer state, then resume from the pointer
    tr.load_state_dict({k: np.zeros_like(v) for k, v in before.items()})
    for s in tr.optimizer.state.values():
        for k, v in s.items():
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                v.zero_()
    assert tr.resume_from_checkpoint(str(tmp_path / "ck")) == 1
    for k, v in tr.state_dict().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    for i, s in _opt_state(tr).items():
        for k, v in s.items():
            assert torch.equal(v, opt_before[i][k]) if isinstance(v, torch.Tensor) \
                else v == opt_before[i][k]
    assert tr.resume_from_checkpoint(str(tmp_path / "nothing")) == 0


@pytest.mark.parametrize("trainer", ["PromptFL", "GLP_OT_SVLoRA"])
def test_resumed_trainer_takes_the_same_next_step(fixture_root, tmp_path, trainer):
    writer = _trainer(fixture_root, tmp_path / "a", trainer)
    np.random.seed(1)
    writer.train(idx=0, global_epoch=0, is_fed=True)
    writer.save_checkpoint(0, str(tmp_path / "ck"))
    batch = next(iter(writer.fed_train_loader_x_dict[1]))
    resumed = _trainer(fixture_root, tmp_path / "b", trainer)
    assert resumed.resume_from_checkpoint(str(tmp_path / "ck")) == 1
    states = []
    for tr in (writer, resumed):
        tr.batch_idx, tr.num_batches = 0, 2  # not the epoch's last batch: the LR stays
        tr.set_model_mode("train")
        out = tr.forward_backward(batch)
        states.append((out, tr.state_dict(), _opt_state(tr)))
    (out_w, sd_w, opt_w), (out_r, sd_r, opt_r) = states
    assert out_w == out_r
    for k in sd_w:
        np.testing.assert_array_equal(sd_r[k], sd_w[k], err_msg=k)
    for i in opt_w:
        for k, v in opt_w[i].items():
            assert torch.equal(opt_r[i][k], v)


# --------------------------------------------------------------------------- #
# host timers
# --------------------------------------------------------------------------- #

def test_host_timers_match_jax():
    for mod in (tprof, jprof):
        t = mod.HostTimers()
        for _ in range(2):
            with t.timed("round"):
                pass
        with pytest.raises(RuntimeError):
            with t.timed("eval"):
                raise RuntimeError("timed even on an error")
        assert len(t.laps["round"]) == 2 and len(t.laps["eval"]) == 1
        assert t.summary().startswith("eval: ") and "round: " in t.summary()
        assert t.summary().split("  ")[1].endswith("/2x")


@pytest.mark.parametrize("env", [None, "FAIRFEDMED_TIMING", "FAIRFEDMED_BUILD_STAMPS"])
def test_stamp_and_heartbeat(monkeypatch, capsys, env):
    for name in ("FAIRFEDMED_TIMING", "FAIRFEDMED_BUILD_STAMPS"):
        monkeypatch.delenv(name, raising=False)
    if env:
        monkeypatch.setenv(env, "1")
    tprof.stamp("phase one")
    tprof.stamp("phase two")
    out = capsys.readouterr()
    assert out.out == ""
    if env:
        lines = out.err.splitlines()
        assert lines[0].startswith("[timing] phase one")
        assert lines[1].startswith("[timing] phase two +")
    else:
        assert out.err == ""
