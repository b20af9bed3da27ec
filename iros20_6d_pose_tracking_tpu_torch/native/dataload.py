"""ctypes binding of the native PNG decoder (``dataload.cc``, libpng and a C++
thread pool).

Counterpart of ``iros20_6d_pose_tracking_tpu/native/dataload.py`` (the C++
source is the JAX package's, byte for byte). The library is built with g++
at first use, never at import, into the git-ignored
``iros20_6d_pose_tracking_tpu_torch/_build/`` beside the CUDA kernels, under
a name that carries the hash of the source and the flags (an edited source
is rebuilt, an unchanged one loaded). Where g++ or libpng is missing,
:class:`NativeLoader` raises and the callers decode with Pillow.

The batch API decodes N same-shape PNGs on the thread pool straight into
one numpy buffer: the tracking CLI's frame chunks and ``PairDataset``'s
batches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "dataload.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-lz", "-lpthread")


def library_path() -> str:
    """Path of the library for the current source and flags (which need not
    exist yet)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libdataload-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is built; returns its path. Raises
    ``RuntimeError`` with the compiler's output when g++ fails, and
    ``FileNotFoundError`` when there is no g++."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on dataload.cc (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds cannot clash
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


_INT_P = ctypes.POINTER(ctypes.c_int)
_U8_P = ctypes.POINTER(ctypes.c_ubyte)
_U16_P = ctypes.POINTER(ctypes.c_ushort)


class NativeLoader:
    """Typed wrapper over the C ABI. Construction builds and loads the
    library, and raises where it cannot."""

    def __init__(self):
        self._lib = ctypes.CDLL(build())
        lib = self._lib
        lib.pngio_info.argtypes = [ctypes.c_char_p] + [_INT_P] * 4
        for name, ptr in (("pngio_read_u8", _U8_P),
                          ("pngio_read_u16", _U16_P)):
            getattr(lib, name).argtypes = [ctypes.c_char_p, ptr,
                                           ctypes.c_long] + [_INT_P] * 3
        for name, ptr in (("pngio_read_batch_u8", _U8_P),
                          ("pngio_read_batch_u16", _U16_P)):
            getattr(lib, name).argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ptr,
                ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
        for name in ("pngio_info", "pngio_read_u8", "pngio_read_u16",
                     "pngio_read_batch_u8", "pngio_read_batch_u16"):
            getattr(lib, name).restype = ctypes.c_int

    def info(self, path: str):
        """(width, height, channels, bit depth), or None where the file is
        no readable PNG."""
        w, h, c, d = (ctypes.c_int() for _ in range(4))
        rc = self._lib.pngio_info(path.encode(), ctypes.byref(w),
                                  ctypes.byref(h), ctypes.byref(c),
                                  ctypes.byref(d))
        if rc != 0:
            return None
        return w.value, h.value, c.value, d.value

    def read_png(self, path: str):
        """Decode one PNG: uint8 (H, W, C) or (H, W), or uint16 (H, W) for a
        16-bit file. None on failure (the caller falls back to Pillow)."""
        meta = self.info(path)
        if meta is None:
            return None
        w, h, c, depth = meta
        shape = (h, w) if c == 1 else (h, w, c)
        if depth == 16:
            out = np.empty(shape, np.uint16)
            fn, ptr = self._lib.pngio_read_u16, _U16_P
        else:
            out = np.empty(shape, np.uint8)
            fn, ptr = self._lib.pngio_read_u8, _U8_P
        wi, hi, ci = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = fn(path.encode(), out.ctypes.data_as(ptr), out.size,
                ctypes.byref(wi), ctypes.byref(hi), ctypes.byref(ci))
        return out if rc == 0 else None

    def read_png_batch(self, paths: list[str], dtype=np.uint8,
                       n_threads: int = 0) -> np.ndarray:
        """Decode N same-shape PNGs on the native thread pool into one
        (N, H, W[, C]) array of ``dtype`` (uint8 for 8-bit files, uint16
        for 16-bit ones; 0 threads: one per core). Raises ``OSError`` when a
        file cannot be read or differs from the first in shape or depth,
        ``ValueError`` when ``dtype`` does not fit the first file."""
        if not paths:
            raise ValueError("no paths")
        meta = self.info(paths[0])
        if meta is None:
            raise OSError(f"cannot read {paths[0]}")
        w, h, c, depth = meta
        dtype = np.dtype(dtype)
        if (dtype, depth) not in ((np.dtype(np.uint8), 8),
                                  (np.dtype(np.uint16), 16)):
            raise ValueError(f"{paths[0]} has {depth}-bit samples, not "
                             f"{dtype}")
        shape = (len(paths), h, w) if c == 1 else (len(paths), h, w, c)
        arr = np.empty(shape, dtype)
        c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        if dtype == np.uint16:
            fn, ptr = self._lib.pngio_read_batch_u16, _U16_P
        else:
            fn, ptr = self._lib.pngio_read_batch_u8, _U8_P
        rc = fn(c_paths, len(paths), arr.ctypes.data_as(ptr), h * w * c,
                w, h, c, n_threads)
        if rc != 0:
            raise OSError(f"native batch decode failed (rc {rc})")
        return arr
