"""Video file IO without ffmpeg: a Motion-JPEG AVI muxer/demuxer.

The reference writes mp4 via imageio-ffmpeg (utils.py:334-343) and ingests
video through torch's native DataLoader; minimal images often lack
ffmpeg, so this provides a universally-playable fallback container
(RIFF-AVI with JPEG frames) used by save_video_tensor, plus the matching
reader for training ingestion. Frame codec work runs through the native
C++ libjpeg library (landiff_tpu_torch/native, threaded batch encode/decode in
one GIL-free C call) with a PIL fallback."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .native import jpeg as _njpeg


def _pad_riff(data: bytes) -> bytes:
    return data + b"\x00" if len(data) % 2 else data


def _jpeg_bytes(frame: np.ndarray, quality: int = 92) -> bytes:
    return _pad_riff(_njpeg.encode_jpeg(frame, quality))


def write_mjpeg_avi(frames, path: str | Path, fps: int = 8,
                    quality: int = 92) -> Path:
    """frames: iterable of (H, W, 3) uint8 arrays -> .avi file."""
    frames = list(frames)
    assert frames, "no frames"
    h, w = frames[0].shape[:2]
    if all(f.shape == frames[0].shape for f in frames):
        # uniform stack -> one threaded native batch-encode call
        jpegs = [_pad_riff(j) for j in _njpeg.encode_frames(
            np.stack(frames), quality)]
    else:
        jpegs = [_jpeg_bytes(f, quality) for f in frames]
    n = len(jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack(
        "<14I",
        int(1e6 / fps),          # microseconds per frame
        max(len(j) for j in jpegs) * fps,  # max bytes/sec (approx)
        0,                        # padding granularity
        0x10,                     # flags: AVIF_HASINDEX
        n, 0, 1, 0,               # total frames, initial, streams, sug. buf
        w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"MJPG" + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1,
                                            fps, 0, n, 0, 0, 0)
            + struct.pack("<4H", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_payload = b"".join(chunk(b"00dc", j) for j in jpegs)
    movi = lst(b"movi", movi_payload)

    idx = b""
    offset = 4  # relative to start of 'movi' fourcc
    for j in jpegs:
        idx += b"00dc" + struct.pack("<3I", 0x10, offset, len(j))
        offset += 8 + len(j)
    idx1 = chunk(b"idx1", idx)

    body = b"AVI " + hdrl + movi + idx1
    out = b"RIFF" + struct.pack("<I", len(body)) + body
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(out)
    return path


def _iter_riff_chunks(data: bytes, start: int, end: int):
    """Yield (fourcc, payload_start, payload_len) walking [start, end)."""
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (length,) = struct.unpack_from("<I", data, pos + 4)
        yield fourcc, pos + 8, length
        pos += 8 + length + (length & 1)  # chunks are word-aligned


def read_mjpeg_avi(path: str | Path) -> tuple[np.ndarray, int]:
    """Read an MJPEG .avi -> ((N, H, W, 3) uint8 RGB, fps).

    The ingestion counterpart of write_mjpeg_avi for the training data
    pipeline (the reference reads clips through torch/decord native code).
    Walks the RIFF tree for '00dc' frame chunks in stream order and decodes
    them in one threaded native call (PIL fallback)."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF-AVI file")
    fps = 0
    jpegs: list[bytes] = []

    def walk(start: int, end: int):
        nonlocal fps
        for fourcc, pstart, plen in _iter_riff_chunks(data, start, end):
            if fourcc == b"LIST":
                walk(pstart + 4, pstart + plen)  # skip the list type fourcc
            elif fourcc == b"avih" and plen >= 4:
                (us_per_frame,) = struct.unpack_from("<I", data, pstart)
                fps = round(1e6 / us_per_frame) if us_per_frame else 0
            elif fourcc == b"00dc" and plen:
                jpegs.append(data[pstart:pstart + plen])

    walk(12, 8 + struct.unpack_from("<I", data, 4)[0])
    if not jpegs:
        raise ValueError(f"{path}: no MJPEG frames found")
    return _njpeg.decode_frames(jpegs), fps
