"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``build/lib<name>-<digest>.so`` at the repository root, where the digest
covers the source files and the flags, so an edited source never loads a stale
library.  The libraries have a plain C interface and load with ``ctypes``;
nothing here includes PyTorch's headers, which keeps a build to seconds.
Building happens at first use (or up front through :func:`build`, which starts
one ``nvcc`` per source at once), never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("attention_fwd", "attention_bwd", "rope_qkv", "wgmma_check")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
# argument types of each library's entry points, in the order of their C
# prototypes (pointers and the stream as c_void_p: ctypes would otherwise pass
# them as 32-bit ints); every entry point returns a CUDA error code as int
SIGNATURES = {
    "attention_fwd": {
        "ffm_attention_fwd": [_VOID] * 6 + [_INT] * 4 + [_VOID],
        "ffm_attention_fwd_info": [_INT] * 4 + [_VOID],
    },
    "attention_bwd": {
        "ffm_attention_bwd": [_VOID] * 11 + [_INT] * 4 + [_VOID],
        "ffm_attention_bwd_info": [_INT] * 4 + [_VOID],
    },
    "rope_qkv": {
        "ffm_rope_qkv_fwd": [_VOID] * 6 + [_INT] * 5 + [_VOID],
        "ffm_rope_qkv_bwd": [_VOID] * 6 + [_INT] * 5 + [_VOID],
    },
    "wgmma_check": {
        "ffm_wgmma_check": [_VOID] * 3 + [_INT] * 2 + [_VOID],
    },
}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh") and (src.stem == name or src.suffix == ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, all ``nvcc``
    processes at once.  Returns ``{name: compiler output}`` for the ones
    compiled here (``-Xptxas=-v`` lists registers, shared memory and spills);
    the output is also kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        target.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.cache
def load(name: str, symbol: str = ""):
    """Entry point ``symbol`` (by default ``ffm_<name>``) of ``csrc/<name>.cu``
    as a ctypes function returning a CUDA error code; builds the library
    first if needed."""
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    symbol = symbol or f"ffm_{name}"
    fn = getattr(lib, symbol)
    fn.argtypes = SIGNATURES[name][symbol]
    fn.restype = ctypes.c_int
    return fn
