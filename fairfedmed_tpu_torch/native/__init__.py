"""Native (C++) host data runtime: NPZ reader + threaded prefetch pool.

The port's own copy of the JAX package's ``native`` module, NPZ only.
``csrc/npz_loader.cpp`` is a zip/NPY parser with zlib inflate and a GIL-free
producer-consumer thread pool, bound over a C ABI with ctypes.  It is
compiled with ``g++`` at first use into ``build/native/`` at the repository
root, under a name that carries a digest of the source and flags, written to
a temporary name and renamed into place (several processes may build at
once).

When the build fails (no compiler, no zlib headers), every entry point falls
back to numpy's ``np.load``, as the JAX package's does: this is a host
decoder, not a device kernel.  The fallback is visible: :func:`decoder` says
which decoder runs and :func:`build_log` holds the compiler's output.

Public surface:

* ``NpzReader(path)``         -- dict-like ``.keys()`` / ``.get(name)`` -> np.ndarray
* ``PrefetchPool(n_threads)`` -- ``submit(path, member)`` -> ticket; ``collect(ticket)``
* ``native_available()``      -- True when the compiled library loaded
* ``decoder()``               -- ``"native"`` or ``"numpy"``
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "npz_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-lz", "-lpthread")

_lib = None  # None: not tried yet; False: the build or load failed
_log = ""
_lib_lock = threading.Lock()
_DTYPES = {
    "<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
    "<i2": np.int16, "<u2": np.uint16, "|i1": np.int8, "|u1": np.uint8,
    "|b1": np.bool_, "<f2": np.float16, "<u4": np.uint32, "<u8": np.uint64,
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + LINK_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libnpz_loader-{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """The library, compiled if missing; None (and the reason in ``_log``)
    when it cannot be built.  A failed build leaves ``<name>.failed`` with the
    compiler's output, so later processes do not retry it."""
    global _log
    target = library_path()
    failed = target.with_name(target.name + ".failed")
    if target.exists():
        return target
    if failed.exists():
        _log = failed.read_text()
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp), *LINK_FLAGS]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        _log = f"{' '.join(cmd)}: {e}"
        return None
    if out.returncode != 0:
        _log = f"{' '.join(cmd)} (exit {out.returncode}):\n{out.stdout}{out.stderr}"
        tmp_failed = failed.with_name(f"{failed.name}.{os.getpid()}.tmp")
        tmp_failed.write_text(_log)
        os.replace(tmp_failed, failed)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    return target


def _load():
    global _lib, _log
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        so = _build()
        if so is None:
            print(f"[native] NPZ reader not built, using numpy's np.load: {_log[-400:]}")
            _lib = False
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _log = f"cannot load {so}: {e}"
            print(f"[native] {_log}; using numpy's np.load")
            _lib = False
            return None
        lib.nlz_open.restype = ctypes.c_void_p
        lib.nlz_open.argtypes = [ctypes.c_char_p]
        lib.nlz_close.restype = None
        lib.nlz_close.argtypes = [ctypes.c_void_p]
        lib.nlz_num_members.restype = ctypes.c_int
        lib.nlz_num_members.argtypes = [ctypes.c_void_p]
        lib.nlz_member_name.restype = ctypes.c_char_p
        lib.nlz_member_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.nlz_member_info.restype = ctypes.c_int
        lib.nlz_member_info.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64)]
        lib.nlz_read.restype = ctypes.c_int
        lib.nlz_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_void_p, ctypes.c_int64]
        lib.nlp_create.restype = ctypes.c_void_p
        lib.nlp_create.argtypes = [ctypes.c_int]
        lib.nlp_destroy.restype = None
        lib.nlp_destroy.argtypes = [ctypes.c_void_p]
        lib.nlp_submit.restype = ctypes.c_long
        lib.nlp_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.nlp_wait_info.restype = ctypes.c_int
        lib.nlp_wait_info.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64)]
        lib.nlp_collect.restype = ctypes.c_int
        lib.nlp_collect.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                    ctypes.c_void_p, ctypes.c_int64]
        lib.nlp_discard.restype = ctypes.c_int
        lib.nlp_discard.argtypes = [ctypes.c_void_p, ctypes.c_long]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def decoder() -> str:
    """``"native"`` when the C++ reader serves the NPZs, else ``"numpy"``."""
    return "native" if native_available() else "numpy"


def build_log() -> str:
    """Why the native build or load failed ("" when it did not)."""
    _load()
    return _log


def _meta():
    """Buffers native code fills with a payload's dtype, shape, rank and size."""
    return (ctypes.create_string_buffer(16), (ctypes.c_int64 * 8)(), ctypes.c_int(),
            ctypes.c_int64())


def _empty(meta, what: str) -> np.ndarray:
    """An uninitialised array of the payload's dtype and shape."""
    dtype16, shape8, ndim, nbytes = meta
    dt = _DTYPES.get(dtype16.value.decode())
    if dt is None:
        raise TypeError(f"unsupported dtype {dtype16.value!r} in {what}")
    arr = np.empty(tuple(shape8[i] for i in range(ndim.value)), dtype=dt)
    if arr.nbytes != nbytes.value:
        raise IOError(f"{what}: payload of {nbytes.value} bytes for {arr.shape} {arr.dtype}")
    return arr


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(arr.nbytes)


class NpzReader:
    """Read members of one .npz without numpy's zipfile layer."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _load()
        self._h = None
        if self._lib is not None:
            h = self._lib.nlz_open(path.encode())
            if h:
                self._h = ctypes.c_void_p(h)
        self._fallback = np.load(path, allow_pickle=False) if self._h is None else None

    def keys(self) -> List[str]:
        if self._fallback is not None:
            return list(self._fallback.keys())
        out = []
        for i in range(self._lib.nlz_num_members(self._h)):
            name = self._lib.nlz_member_name(self._h, i).decode()
            out.append(name[:-4] if name.endswith(".npy") else name)
        return out

    def get(self, name: str) -> np.ndarray:
        if self._fallback is not None:
            return self._fallback[name]
        meta = _meta()
        if self._lib.nlz_member_info(self._h, name.encode(), meta[0], meta[1],
                                     ctypes.byref(meta[2]), ctypes.byref(meta[3])) != 0:
            raise KeyError(name)
        arr = _empty(meta, f"{self.path}:{name}")
        if self._lib.nlz_read(self._h, name.encode(), *_ptr(arr)) < 0:
            raise IOError(f"read failed for {self.path}:{name}")
        return arr

    def __getitem__(self, name: str) -> np.ndarray:
        return self.get(name)

    def close(self):
        if self._h is not None:
            self._lib.nlz_close(self._h)
            self._h = None
        if self._fallback is not None:
            self._fallback.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PrefetchPool:
    """Decode (path, member) requests on C++ threads ahead of consumption."""

    def __init__(self, n_threads: int = 2):
        self._lib = _load()
        self._p = None
        if self._lib is not None:
            self._p = ctypes.c_void_p(self._lib.nlp_create(n_threads))

    @property
    def native(self) -> bool:
        return self._p is not None

    def submit(self, path: str, member: str):
        if self._p is None:
            # fallback: decode synchronously, stash the result as the ticket
            with np.load(path, allow_pickle=False) as z:
                return ("_sync", z[member])
        t = self._lib.nlp_submit(self._p, path.encode(), member.encode())
        if t < 0:
            raise IOError(f"cannot open {path}")
        return t

    def collect(self, ticket) -> np.ndarray:
        if isinstance(ticket, tuple) and ticket[0] == "_sync":
            return ticket[1]
        meta = _meta()
        if self._lib.nlp_wait_info(self._p, ctypes.c_long(ticket), meta[0], meta[1],
                                   ctypes.byref(meta[2]), ctypes.byref(meta[3])) != 0:
            raise IOError(f"prefetch ticket {ticket} failed")
        arr = _empty(meta, f"prefetch ticket {ticket}")
        if self._lib.nlp_collect(self._p, ctypes.c_long(ticket), *_ptr(arr)) != 0:
            raise IOError(f"prefetch collect {ticket} failed")
        return arr

    def discard(self, ticket):
        """Drop an uncollected ticket so its decoded payload is freed."""
        if isinstance(ticket, tuple) and ticket[0] == "_sync":
            return
        if self._p is not None:
            self._lib.nlp_discard(self._p, ctypes.c_long(ticket))

    def close(self):
        if self._p is not None:
            self._lib.nlp_destroy(self._p)
            self._p = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
