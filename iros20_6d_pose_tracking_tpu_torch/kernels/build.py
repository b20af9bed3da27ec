"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source compiles on its own, with nvcc, into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build dir>/<name>-<hash>.so csrc/<name>.cu

and is loaded with ``ctypes``. Nothing includes PyTorch's headers, so a
build takes seconds. The library file is named by the hash of its source,
of the shared headers (``csrc/*.cuh``) and of the flags, so an edited
source or header is rebuilt at its next use and an unchanged one is loaded
from the build directory. Builds happen at first
use, never at import: ``import`` works on machines without nvcc.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns the launch's ``cudaError_t`` (0 on success); each
library also exports ``const char* error_string(int)``. The entry points
launch on the current CUDA device: the Python wrappers call them inside
``torch.cuda.device(...)`` of their tensors, which restores the previous
device afterwards.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signature of each kernel entry point: (argtypes, restype).
SIGNATURES = {
    "raster_pass1": {
        # coef, block_bbox, iz, winner, F, n_blocks, face_block, H, W,
        # pix_tile, B (views), stream
        "raster_pass1": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
                         _I),
    },
    "gather_rows": {
        # attr, winner, covered, rows, F, C, P, stream
        "gather_rows": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    },
    "pass2_shade": {
        # attr, iz, winner, R, t, lighting, texture, rgb, depth, B, H, W, F,
        # C, r_sv, r_si, r_sj, t_sv, t_si, th, tw, far, stream
        "pass2_shade": ([_P] * 9 + [_I] * 12 + [ctypes.c_float, _P], _I),
    },
    "raster_pass1_worklist": {
        # coef, block_bbox, scratch, scratch_bytes, iz, winner, F, n_blocks,
        # face_block, H, W, pix_tile, stream
        "raster_pass1_worklist": (
            [_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
    },
    "render_setup": {
        # fverts, fnormals, fcolors, fuvs, fmask, pose, K, window, w_left,
        # w_right, w_top, w_bottom, coef, block_bbox, attr, B, F, face_block,
        # H, W, near, cull, stacked, stream
        "render_setup": ([_P] * 8 + [_F] * 4 + [_P] * 3 + [_I] * 5
                         + [_F, _I, _I, _P], _I),
    },
}


def nvcc_path() -> str:
    """nvcc on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(cand):
        raise FileNotFoundError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "build only on a machine with the CUDA toolkit")
    return cand


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` at the current hash
    of its source and the shared headers (which need not exist yet)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns (library path, nvcc's output; empty when nothing was built).
    Raises ``RuntimeError`` with nvcc's output when the build fails."""
    out = library_path(name)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC_DIR, f"{name}.cu")],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds cannot clash
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, with the argument and
    return types of its entry points declared. One load per process."""
    path, _ = build(name)
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, fn: str, err: int) -> None:
    """Raise when a launch returned a nonzero cudaError_t."""
    if err:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {fn} failed: cudaError {err} ({msg})")
