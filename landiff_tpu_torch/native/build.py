"""On-demand build + ctypes load for the native library.

No pybind11 in this image, so the native layer is a plain C ABI compiled
with g++ at first use and loaded via ctypes. The .so is cached under
$LANDIFF_NATIVE_CACHE (default ~/.cache/landiff_torch_native) keyed by a hash of
the source, so rebuilds only happen when the source changes. Everything
degrades gracefully: if g++ or libjpeg is missing the callers fall back to
their pure-python paths (PIL), mirroring how the reference degrades when
ffmpeg is absent.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

logger = logging.getLogger("landiff_tpu_torch.native")

_SRC = Path(__file__).with_name("jpeg.cpp")
_LIB = None
_TRIED = False


def _cache_dir() -> Path:
    d = os.environ.get("LANDIFF_NATIVE_CACHE")
    if d:
        return Path(d)
    return Path(os.path.expanduser("~")) / ".cache" / "landiff_torch_native"


def build_library(force: bool = False) -> Path | None:
    """Compile jpeg.cpp -> cached .so; returns the path or None on failure."""
    try:
        src = _SRC.read_bytes()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _cache_dir() / f"liblandiff_torch_jpeg_{tag}.so"
    if out.exists() and not force:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # unique temp per process: concurrent first-use builds (multi-process
    # training sharing a cache dir) must not interleave g++ output into one
    # file and promote a corrupt .so via os.replace
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", str(_SRC),
           "-o", str(tmp), "-ljpeg", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        err = getattr(e, "stderr", b"") or b""
        logger.warning("native build failed (%s): %s", e,
                       err.decode(errors="replace")[:500])
        tmp.unlink(missing_ok=True)
        # another process may have finished its build meanwhile
        return out if out.exists() else None
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL | None:
    """Build if needed and load the native library (memoized).

    Returns None when unavailable (LANDIFF_NATIVE=0, no toolchain, or no
    libjpeg) — callers must fall back to python paths.
    """
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("LANDIFF_NATIVE", "1") == "0":
        return None
    path = build_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        logger.warning("native load failed: %s", e)
        return None

    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.lt_free.argtypes = [ctypes.c_void_p]
    lib.lt_free.restype = None
    lib.lt_jpeg_encode.argtypes = [
        c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(c_u8p), ctypes.POINTER(ctypes.c_size_t)]
    lib.lt_jpeg_encode.restype = ctypes.c_int
    lib.lt_jpeg_probe.argtypes = [
        c_u8p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.lt_jpeg_probe.restype = ctypes.c_int
    lib.lt_jpeg_decode.argtypes = [
        c_u8p, ctypes.c_size_t, c_u8p, ctypes.c_int, ctypes.c_int]
    lib.lt_jpeg_decode.restype = ctypes.c_int
    lib.lt_jpeg_encode_batch.argtypes = [
        c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(c_u8p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
    lib.lt_jpeg_encode_batch.restype = ctypes.c_int
    lib.lt_jpeg_decode_batch.argtypes = [
        ctypes.POINTER(c_u8p), ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
        c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.lt_jpeg_decode_batch.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None
