"""Native (C++) host data runtime: NPZ reader, grayscale JPEG decoder and a
threaded prefetch pool.

The port's own copy of the JAX package's ``native`` module.
``csrc/npz_loader.cpp`` is a zip/NPY parser with zlib inflate, a libjpeg
decoder with a bilinear resize (FedChexMimic's X-rays), and a GIL-free
producer-consumer thread pool, bound over a C ABI with ctypes.  It is
compiled with ``g++`` at first use into ``build/native/`` at the repository
root, under a name that carries a digest of the source and flags, written to
a temporary name and renamed into place (several processes may build at
once).  Two builds are tried in order, as in the JAX package: with the JPEG
decoder (``-DFFM_WITH_JPEG -ljpeg``), then without it.  A build that fails
leaves a stamp with the compiler's output, so later processes do not retry
it (a host without libjpeg's headers pays one failed ``g++`` run, once).

When no build succeeds (no compiler, no zlib headers), every NPZ entry point
falls back to numpy's ``np.load``, as the JAX package's does: this is a host
decoder, not a device kernel.  Without the JPEG build, FedChexMimic decodes
with PIL.  The fallbacks are visible: :func:`decoder` says which decoder
runs and :func:`build_log` holds the compiler's output.

Public surface:

* ``NpzReader(path)``         -- dict-like ``.keys()`` / ``.get(name)`` -> np.ndarray
* ``PrefetchPool(n_threads)`` -- ``submit(path, member)`` / ``submit_jpeg(path, res)``
  -> ticket; ``collect(ticket)``
* ``native_available()``      -- True when a compiled library loaded
* ``jpeg_available()``        -- True when it holds the JPEG decoder
* ``decode_jpeg_gray(path, res)`` -- fp32 [res, res] on the 0-255 scale
* ``decoder()``               -- ``"native"`` or ``"numpy"`` (NPZ);
  ``decoder("jpeg")``: ``"libjpeg"``, ``"PIL"`` or ``"none"``
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
# (name, extra compile flags, extra link flags), in the order they are tried
BUILDS = (("jpeg", ("-DFFM_WITH_JPEG",), ("-ljpeg",)), ("plain", (), ()))

_lib = None  # None: not tried yet; False: the build or load failed
_log = ""
_lib_lock = threading.Lock()
_DTYPES = {
    "<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
    "<i2": np.int16, "<u2": np.uint16, "|i1": np.int8, "|u1": np.uint8,
    "|b1": np.bool_, "<f2": np.float16, "<u4": np.uint32, "<u8": np.uint64,
}


def library_path(build: str = "plain") -> Path:
    _, cflags, libs = next(b for b in BUILDS if b[0] == build)
    h = hashlib.sha256(" ".join(GXX_FLAGS + cflags + LINK_FLAGS + libs).encode())
    h.update(_SRC.read_bytes())
    suffix = "" if build == "plain" else f"{build}-"
    return BUILD_DIR / f"libnpz_loader-{suffix}{h.hexdigest()[:16]}.so"


def _build(build: str) -> Path | None:
    """The library of ``build`` (one of ``BUILDS``), compiled if missing;
    None (and the reason in ``_log``) when it cannot be built.  A failed
    build leaves ``<name>.failed`` with the compiler's output, so later
    processes do not retry it."""
    global _log
    _, cflags, libs = next(b for b in BUILDS if b[0] == build)
    target = library_path(build)
    failed = target.with_name(target.name + ".failed")
    if target.exists():
        return target
    if failed.exists():
        _log += failed.read_text()
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, *cflags, str(_SRC), "-o", str(tmp), *LINK_FLAGS, *libs]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        _log += f"{' '.join(cmd)}: {e}\n"
        return None
    if out.returncode != 0:
        msg = f"{' '.join(cmd)} (exit {out.returncode}):\n{out.stdout}{out.stderr}"
        _log += msg
        tmp_failed = failed.with_name(f"{failed.name}.{os.getpid()}.tmp")
        tmp_failed.write_text(msg)
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
        lib = None
        for build, _, _ in BUILDS:  # the JPEG build first
            so = _build(build)
            if so is None:
                continue
            try:
                lib = ctypes.CDLL(str(so))
                break
            except OSError as e:  # e.g. libjpeg removed after the build
                _log += f"cannot load {so}: {e}\n"
        if lib is None:
            print(f"[native] NPZ reader not built, using numpy's np.load: {_log[-400:]}")
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
        if hasattr(lib, "njd_decode_gray"):  # the FFM_WITH_JPEG build
            lib.njd_decode_gray.restype = ctypes.c_int
            lib.njd_decode_gray.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_float)]
            lib.nlp_submit_jpeg.restype = ctypes.c_long
            lib.nlp_submit_jpeg.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def jpeg_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "njd_decode_gray")


def _pil_available() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def decoder(kind: str = "npz") -> str:
    """The decoder in use.  ``"npz"``: ``"native"`` when the C++ reader
    serves the NPZs, else ``"numpy"``.  ``"jpeg"`` (FedChexMimic's X-rays):
    ``"libjpeg"`` when the native JPEG build loaded (the prefetch pool then
    decodes on its threads), else ``"PIL"`` when PIL imports, else
    ``"none"`` (decoding a JPEG then raises)."""
    if kind == "npz":
        return "native" if native_available() else "numpy"
    if kind == "jpeg":
        return "libjpeg" if jpeg_available() else "PIL" if _pil_available() else "none"
    raise ValueError(f"kind must be 'npz' or 'jpeg', got {kind!r}")


def decode_jpeg_gray(path: str, resolution: int) -> np.ndarray | None:
    """Native grayscale JPEG decode and bilinear resize to ``(resolution,
    resolution)``, fp32 on the 0-255 scale; None when the JPEG build is not
    loaded or libjpeg rejects the file."""
    if not jpeg_available():
        return None
    out = np.empty((resolution, resolution), np.float32)
    rc = _lib.njd_decode_gray(path.encode(), resolution,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def build_log() -> str:
    """What failed of the native builds and loads ("" when nothing did):
    on a host without libjpeg's headers, the JPEG build's compiler output."""
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

    @property
    def supports_jpeg(self) -> bool:
        return self._p is not None and hasattr(self._lib, "njd_decode_gray")

    def submit_jpeg(self, path: str, resolution: int):
        """Queue a grayscale JPEG decode and resize to ``(resolution,
        resolution)`` fp32; the ticket resolves through ``collect`` /
        ``discard`` as an NPZ ticket does.  Check :attr:`supports_jpeg`
        first: without the JPEG build there is nothing to overlap."""
        if not self.supports_jpeg:
            raise RuntimeError("the native JPEG build is not loaded "
                               "(check PrefetchPool.supports_jpeg)")
        return self._lib.nlp_submit_jpeg(self._p, path.encode(), resolution)

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
