"""Build and bind the port's CUDA kernels.

Each source under csrc/ (flash_fwd.cu, flash_bwd.cu, flash_f32.cu,
adaln.cu, qkv_prep.cu) is compiled
by nvcc for sm_90a into its own shared library with a plain C interface
and loaded with ctypes. The build runs at first use, into a directory git
ignores (ops/_build/), keyed by a hash of the source, the shared headers
(csrc/*.cuh) and the flags, so a checkout builds everything from its own
sources; `build()` starts one nvcc per
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
SOURCES = {"flash_fwd": CSRC / "flash_fwd.cu",
           "flash_bwd": CSRC / "flash_bwd.cu",
           "flash_f32": CSRC / "flash_f32.cu", "adaln": CSRC / "adaln.cu",
           "qkv_prep": CSRC / "qkv_prep.cu"}
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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers
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
    return bind_flash_fwd(build(["flash_fwd"])["flash_fwd"])


def bind_flash_fwd(path: Path) -> ctypes.CDLL:
    """A library built from flash_fwd.cu, at `path`, with its C signatures
    declared."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.landiff_flash_fwd_bf16.argtypes = (
        [ptr] * 8 + [i32] * 5 + [f32] + [i32] * 6 + [ptr])
    lib.landiff_flash_fwd_bf16.restype = i32
    lib.landiff_flash_fwd_i8.argtypes = (
        [ptr] * 10 + [i32] * 5 + [f32] + [i32] * 8 + [ptr])
    lib.landiff_flash_fwd_i8.restype = i32
    lib.landiff_ex2_bf16x2.argtypes = [ptr, ptr, i32, ptr]
    lib.landiff_ex2_bf16x2.restype = i32
    lib.landiff_ex2_rate.argtypes = [ptr, i32, i32, i32, ptr]
    lib.landiff_ex2_rate.restype = i32
    lib.landiff_flash_quantize_k.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.landiff_flash_quantize_k.restype = i32
    lib.landiff_flash_fwd_smem_bytes.argtypes = [i32, i32]
    lib.landiff_flash_fwd_smem_bytes.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def flash_bwd_library() -> ctypes.CDLL:
    """The flash-backward library (prologue and main kernel) with its C
    signatures declared."""
    return bind_flash_bwd(build(["flash_bwd"])["flash_bwd"])


def bind_flash_bwd(path: Path) -> ctypes.CDLL:
    """A library built from flash_bwd.cu, at `path`, with its C signatures
    declared."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.landiff_flash_bwd_prep.argtypes = [ptr] * 8 + [i32] * 4 + [f32, ptr]
    lib.landiff_flash_bwd_prep.restype = i32
    lib.landiff_flash_bwd.argtypes = (
        [ptr] * 13 + [i32] * 6 + [f32] + [i32] * 5 + [ptr])
    lib.landiff_flash_bwd.restype = i32
    lib.landiff_flash_bwd_smem_bytes.argtypes = []
    lib.landiff_flash_bwd_smem_bytes.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def flash_f32_library() -> ctypes.CDLL:
    """The f32 flash library (the 3xTF32 exact forward and backward with
    their split prologues, the int8-score forward (int8 scores, 3xTF32 or
    int8 p.v) and its K quantization prologue, the backward's q-side
    prologue) with its C signatures declared."""
    return bind_flash_f32(build(["flash_f32"])["flash_f32"])


def bind_flash_f32(path: Path) -> ctypes.CDLL:
    """A library built from flash_f32.cu, at `path`, with its C signatures
    declared."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.landiff_flash_fwd_f32.argtypes = (
        [ptr] * 10 + [i32] * 6 + [f32] + [i32] * 6 + [ptr])
    lib.landiff_flash_fwd_i8_f32.argtypes = (
        [ptr] * 11 + [i32] * 7 + [f32] + [i32] * 7 + [ptr])
    lib.landiff_flash_fwd_i8_f32_block_q.argtypes = [i32, i32]
    lib.landiff_flash_quantize_k_f32.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.landiff_tf32_split.argtypes = [ptr] * 3 + [i64, ptr]
    lib.landiff_tf32_split_t.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.landiff_flash_bwd_prep_f32.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.landiff_flash_bwd_f32.argtypes = (
        [ptr] * 16 + [i32] * 7 + [f32, f32] + [i32] * 5 + [ptr])
    lib.landiff_flash_f32_smem_bytes.argtypes = [i32]
    for fn in (lib.landiff_flash_fwd_f32, lib.landiff_flash_fwd_i8_f32,
               lib.landiff_flash_fwd_i8_f32_block_q,
               lib.landiff_flash_quantize_k_f32, lib.landiff_tf32_split,
               lib.landiff_tf32_split_t, lib.landiff_flash_bwd_prep_f32,
               lib.landiff_flash_bwd_f32, lib.landiff_flash_f32_smem_bytes):
        fn.restype = i32
    return lib


def ptxas_report(name: str, entry: str) -> dict:
    """Registers, spill bytes and barriers of the kernel whose mangled
    name contains `entry`, from the -Xptxas -v log of library `name`;
    "notes": ptxas's other lines that name that kernel (such as C7519, a
    wgmma fence it added), and "warnings": those of its lines, and of its
    own report, that warn or say "Potential Performance Loss" (a wgmma
    serialized)."""
    import re

    text = library_path(name).with_suffix(".log").read_text()
    block = text.split("Compiling entry function")
    found = [b for b in block[1:] if entry in b.split("\n", 1)[0]]
    if not found:
        raise RuntimeError(f"no ptxas report for {entry} in {name}")
    b = found[0]
    mangled = re.search(r"'([^']+)'", b.split("\n", 1)[0]).group(1)
    notes = [line.strip() for line in text.splitlines()
             if mangled in line and "Compiling entry" not in line
             and "Function properties" not in line]
    warns = lambda lines: [line.strip() for line in lines
                           if "arning" in line or "Performance Loss" in line]
    num = lambda pat: int(re.search(pat, b).group(1))
    return {"registers": num(r"Used (\d+) registers"),
            "spill_stores": num(r"(\d+) bytes spill stores"),
            "spill_loads": num(r"(\d+) bytes spill loads"),
            "barriers": num(r"used (\d+) barriers"),
            "notes": notes,
            "warnings": warns(b.splitlines()) + warns(notes)}


@functools.lru_cache(maxsize=None)
def adaln_library() -> ctypes.CDLL:
    """The fused adaLN library with its C signature declared."""
    lib = ctypes.CDLL(str(build(["adaln"])["adaln"]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.landiff_adaln_modulate.argtypes = (
        [ptr] * 8 + [i32] * 8 + [f32, i32, ptr])
    lib.landiff_adaln_modulate.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def qkv_prep_library() -> ctypes.CDLL:
    """The DiT's qkv preparation library with its C signature declared."""
    lib = ctypes.CDLL(str(build(["qkv_prep"])["qkv_prep"]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.landiff_qkv_prep.argtypes = [ptr] * 11 + [i32] * 6 + [f32, i32, ptr]
    lib.landiff_qkv_prep.restype = i32
    return lib
