"""numpy-facing wrappers over the native JPEG codec (PIL fallback).

encode/decode single frames and contiguous frame batches; the batch entry
points release the GIL inside one C call and fan frames out over an
std::thread pool (LANDIFF_NATIVE_THREADS, default hardware concurrency) —
the role torch's C++ DataLoader workers play for the reference's ingestion
(SURVEY §2.9), without multiprocessing.
"""

from __future__ import annotations

import ctypes
import io
import os

import numpy as np

from . import build

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _threads() -> int:
    return int(os.environ.get("LANDIFF_NATIVE_THREADS", "0"))


def available() -> bool:
    return build.available()


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


def encode_jpeg(frame: np.ndarray, quality: int = 92) -> bytes:
    """(H, W, 3) uint8 RGB -> JPEG bytes."""
    frame = np.ascontiguousarray(frame, dtype=np.uint8)
    assert frame.ndim == 3 and frame.shape[2] == 3, frame.shape
    lib = build.load()
    if lib is None:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
        return buf.getvalue()
    out = _u8p()
    out_len = ctypes.c_size_t()
    rc = lib.lt_jpeg_encode(_as_u8p(frame), frame.shape[0], frame.shape[1],
                            quality, ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"jpeg encode failed (rc={rc})")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.lt_free(out)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB."""
    lib = build.load()
    if lib is None:
        from PIL import Image

        try:
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception as e:  # match the native path's error type
            raise ValueError(f"jpeg decode failed: {e}") from e
    src = np.frombuffer(data, dtype=np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.lt_jpeg_probe(_as_u8p(src), src.size, ctypes.byref(h),
                           ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"jpeg probe failed (rc={rc})")
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    rc = lib.lt_jpeg_decode(_as_u8p(src), src.size, _as_u8p(out), h.value,
                            w.value)
    if rc != 0:
        raise ValueError(f"jpeg decode failed (rc={rc})")
    return out


def encode_frames(frames: np.ndarray, quality: int = 92) -> list[bytes]:
    """(N, H, W, 3) uint8 -> N JPEG byte strings (one threaded C call)."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    assert frames.ndim == 4 and frames.shape[3] == 3, frames.shape
    n, h, w, _ = frames.shape
    if n == 0:
        return []
    lib = build.load()
    if lib is None:
        return [encode_jpeg(f, quality) for f in frames]
    outs = (_u8p * n)()
    lens = (ctypes.c_size_t * n)()
    fails = lib.lt_jpeg_encode_batch(
        _as_u8p(frames), n, h, w, quality,
        ctypes.cast(outs, ctypes.POINTER(_u8p)),
        ctypes.cast(lens, ctypes.POINTER(ctypes.c_size_t)), _threads())
    try:
        if fails:
            raise ValueError(f"jpeg batch encode: {fails}/{n} frames failed")
        return [ctypes.string_at(outs[i], lens[i]) for i in range(n)]
    finally:
        for i in range(n):
            if outs[i]:
                lib.lt_free(outs[i])


def decode_frames(datas: list[bytes]) -> np.ndarray:
    """N equally-sized JPEGs -> (N, H, W, 3) uint8 (one threaded C call)."""
    if not datas:
        return np.zeros((0, 0, 0, 3), dtype=np.uint8)
    lib = build.load()
    if lib is None:
        return np.stack([decode_jpeg(d) for d in datas])
    n = len(datas)
    srcs = [np.frombuffer(d, dtype=np.uint8) for d in datas]
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.lt_jpeg_probe(_as_u8p(srcs[0]), srcs[0].size, ctypes.byref(h),
                           ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"jpeg probe failed (rc={rc})")
    ptrs = (_u8p * n)(*[_as_u8p(s) for s in srcs])
    lens = (ctypes.c_size_t * n)(*[s.size for s in srcs])
    out = np.empty((n, h.value, w.value, 3), dtype=np.uint8)
    fails = lib.lt_jpeg_decode_batch(
        ctypes.cast(ptrs, ctypes.POINTER(_u8p)),
        ctypes.cast(lens, ctypes.POINTER(ctypes.c_size_t)), n,
        _as_u8p(out), h.value, w.value, _threads())
    if fails:
        raise ValueError(f"jpeg batch decode: {fails}/{n} frames failed")
    return out
