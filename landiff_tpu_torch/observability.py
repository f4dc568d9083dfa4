"""Observability (counterpart of landiff_tpu/observability.py): profiler
traces and the program's spans, a JSONL metrics logger and determinism.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("landiff_tpu_torch")


@contextlib.contextmanager
def trace(trace_dir: str | None = None, device="cuda"):
    """Profile the block with torch.profiler (host activity, and the
    device's where `device` is a CUDA device) and write a Chrome-trace JSON
    into `trace_dir` (a new temporary directory by default); yields the
    directory. View it in chrome://tracing or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="landiff_trace_")
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield trace_dir
    finally:
        prof.stop()
        path = Path(trace_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        logger.info("profiler trace written to %s", path)


# what `named_scope` returns while no profiler records: one shared object,
# so that a span costs one flag check when nothing traces
_NO_SPAN = contextlib.nullcontext()


def named_scope(name: str):
    """A span of the profiler's trace (the reference's
    @torch.profiler.record_function, blocks.py:143): a
    `torch.profiler.record_function` range while a profiler records, which
    the trace puts on the clock of the device's kernels, else a shared
    no-op context that calls nothing. The program's own spans are named
    `landiff.<layer>.<part>`."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class MetricsLogger:
    """Accumulate scalar metrics per step; dump JSONL."""

    def __init__(self, path: str | None = None):
        self.path = Path(path) if path else None
        self.history: list[dict] = []

    def log(self, step: int, **metrics):
        row = {"step": step}
        for k, v in metrics.items():
            row[k] = float(v.detach().float().cpu()
                           if isinstance(v, torch.Tensor) else np.asarray(v))
        self.history.append(row)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")

    def last(self) -> dict:
        return self.history[-1] if self.history else {}


def set_deterministic(seed: int, device="cpu") -> torch.Generator:
    """Seed numpy and torch's global generators and return a root
    `torch.Generator` on `device` (the JAX function returns a root key)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
