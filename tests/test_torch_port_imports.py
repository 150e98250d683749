"""The port (fairfedmed_tpu_torch) and chip_smoke.py stand alone: they import
neither JAX nor anything of the JAX package, and none of the packages the
GPU machine lacks (PyYAML, cv2, pandas, tensorboard) at import time."""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "fairfedmed_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_and_chip_smoke_import_without_jax():
    code = "\n".join(
        ["import sys"]
        + [f"import {m}" for m in _port_modules()]
        + ["import chip_smoke",
           "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'optax', "
           "'fairfedmed_tpu.')) or m == 'fairfedmed_tpu')",
           "bad += sorted(m for m in sys.modules if m.split('.')[0] in "
           "('yaml', 'cv2', 'pandas', 'tensorboard'))",
           "assert not bad, bad", "print('clean')"])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_no_port_file_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|optax|fairfedmed_tpu)\b(?!_torch)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text()) or "fairfedmed_tpu." in f.read_text()]
    assert not offenders, offenders


def test_the_client_parallel_modules_are_guarded():
    """The modules of the client-parallel rounds are among those the guard
    above imports and scans."""
    mods = set(_port_modules())
    for name in ("fed.parallel", "fed.parallel_driver", "fed.sampler", "utils.profiling"):
        assert f"fairfedmed_tpu_torch.{name}" in mods, name
        assert (PORT / (name.replace(".", "/") + ".py")).read_text().count("import jax") == 0
