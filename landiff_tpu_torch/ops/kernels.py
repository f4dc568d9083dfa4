"""Build and bind the port's CUDA kernels.

csrc/flash_fwd.cu is compiled by nvcc for sm_90a into a shared library
with a plain C interface and loaded with ctypes. The build runs at first
use, into a directory git ignores (ops/_build/), keyed by a hash of the
source and the flags, so a checkout builds everything from its own
sources. No --use_fast_math: the int8 flash kernel's codes depend on IEEE
division and round-half-to-even.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")
BUILD_DIR = Path(__file__).resolve().parent / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return str(path)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{SOURCE.stem}-{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; nvcc's register and
    shared-memory report goes to <lib>.log. The library appears under its
    name only once complete, so concurrent processes never load half a
    file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def flash_library() -> ctypes.CDLL:
    """The flash-forward library with its C signatures declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.landiff_flash_fwd_bf16.argtypes = (
        [ptr] * 8 + [i32] * 5 + [f32] + [i32] * 5 + [ptr])
    lib.landiff_flash_fwd_bf16.restype = i32
    lib.landiff_flash_fwd_i8.argtypes = (
        [ptr] * 9 + [i32] * 5 + [f32] + [i32] * 5 + [ptr])
    lib.landiff_flash_fwd_i8.restype = i32
    return lib
