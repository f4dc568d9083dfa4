"""Observability (counterpart of landiff_tpu/observability.py): profiler
traces and named scopes, step timers, a JSONL metrics logger, device
memory and determinism.
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


def named_scope(name: str):
    """Annotate a region for the profiler (the reference's
    @torch.profiler.record_function, blocks.py:143)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timer with EMA; `stop(sync_on=...)` waits for the
    device that holds `sync_on` (a tensor) before reading the clock."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_s: float | None = None
        self._t0: float | None = None

    def start(self):
        self._t0 = time.time()

    def stop(self, sync_on=None) -> float:
        if isinstance(sync_on, torch.Tensor) and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        dt = time.time() - self._t0
        self.avg_s = dt if self.avg_s is None else (
            self.ema * self.avg_s + (1 - self.ema) * dt)
        return dt


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


def device_memory_stats(device=None) -> dict:
    """Device memory snapshot: bytes_in_use, peak_bytes_in_use and
    bytes_limit of a CUDA device; empty where there is none."""
    if not torch.cuda.is_available():
        return {}
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": total}


def set_deterministic(seed: int, device="cpu") -> torch.Generator:
    """Seed numpy and torch's global generators and return a root
    `torch.Generator` on `device` (the JAX function returns a root key)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
