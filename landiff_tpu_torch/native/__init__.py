"""Native (C++) runtime components, loaded via ctypes with python fallbacks.

Currently: a libjpeg video-frame codec with a threaded batch path
(`landiff_tpu_torch.native.jpeg`), backing `video_io` writes and the AVI training
ingestion reader — the counterpart of the reference's native IO
surface (imageio-ffmpeg writer, torch C++ DataLoader workers; SURVEY §2.9).
Disable with LANDIFF_NATIVE=0.
"""

from . import build, jpeg  # noqa: F401

available = build.available
