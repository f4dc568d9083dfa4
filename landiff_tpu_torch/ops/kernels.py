"""Build and bind the port's CUDA kernels.

Each source under csrc/ (flash_fwd.cu, adaln.cu) is compiled by nvcc for
sm_90a into its own shared library with a plain C interface and loaded
with ctypes. The build runs at first use, into a directory git ignores
(ops/_build/), keyed by a hash of the source and the flags, so a checkout
builds everything from its own sources; `build()` starts one nvcc per
source, all at once. No --use_fast_math: the int8 flash kernel's codes
depend on IEEE division and round-half-to-even.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"flash_fwd": CSRC / "flash_fwd.cu", "adaln": CSRC / "adaln.cu"}
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


def library_path(name: str) -> Path:
    source = SOURCES[name]
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the libraries of `names` (default: all) that are not built
    yet, one nvcc process per source, started together; nvcc's register
    and shared-memory report goes to <lib>.log. A library appears under
    its name only once complete, so concurrent processes never load half
    a file. Returns {name: library path}."""
    names = list(SOURCES) if names is None else list(names)
    out = {name: library_path(name) for name in names}
    started = []
    for name, lib in out.items():
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started.append((name, lib, tmp, proc))
    failures = []
    for name, lib, tmp, proc in started:   # wait for every process
        report, _ = proc.communicate()
        lib.with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {SOURCES[name].name}:\n{report}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


@functools.lru_cache(maxsize=None)
def flash_library() -> ctypes.CDLL:
    """The flash-forward library with its C signatures declared."""
    lib = ctypes.CDLL(str(build(["flash_fwd"])["flash_fwd"]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.landiff_flash_fwd_bf16.argtypes = (
        [ptr] * 8 + [i32] * 5 + [f32] + [i32] * 5 + [ptr])
    lib.landiff_flash_fwd_bf16.restype = i32
    lib.landiff_flash_fwd_i8.argtypes = (
        [ptr] * 9 + [i32] * 5 + [f32] + [i32] * 5 + [ptr])
    lib.landiff_flash_fwd_i8.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def adaln_library() -> ctypes.CDLL:
    """The fused adaLN library with its C signature declared."""
    lib = ctypes.CDLL(str(build(["adaln"])["adaln"]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.landiff_adaln_modulate.argtypes = (
        [ptr] * 8 + [i32] * 8 + [f32, i32, ptr])
    lib.landiff_adaln_modulate.restype = i32
    return lib
