"""The device trace of a traced run: torch.profiler over the window,
exported as a Chrome trace under TMPDIR and read back.

Device time is the union of the intervals of every kernel, copy and set
on the device timeline, so kernels that overlap count once. Kernels are
named by the classes under portbench/kernel_classes/<class>/*.json: each
file lists substrings of kernel names, and a class's `priority` orders
the classes when a name matches more than one.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

CLASSES_DIR = Path(__file__).resolve().parents[1] / "kernel_classes"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_classes(directory: Path = CLASSES_DIR):
    """[(priority, class, [substring, ...])], highest priority first."""
    out = {}
    for f in sorted(directory.glob("*/*.json")):
        spec = json.loads(f.read_text())
        cls = f.parent.name
        prio, pats = out.get(cls, (0, []))
        out[cls] = (max(prio, spec.get("priority", 0)),
                    pats + list(spec["patterns"]))
    return sorted(((p, c, pats) for c, (p, pats) in out.items()),
                  key=lambda e: (-e[0], e[1]))


def classify(name: str, classes) -> str | None:
    for _, cls, pats in classes:
        if any(p in name for p in pats):
            return cls
    return None


def union_seconds(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle (start, end) gaps inside [lo, hi] between intervals."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


class Trace:
    """Device events and harness ranges of one traced window, in seconds
    on the profiler's clock, clipped to the window's range."""

    def __init__(self, events, window_name="portbench.window",
                 classes=None):
        classes = load_classes() if classes is None else classes
        ranges = [e for e in events if e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith("portbench.")]
        win = [e for e in ranges if e["name"] == window_name]
        if not win:
            raise ValueError("the trace holds no window range")
        w = win[0]
        self.lo = w["ts"] * 1e-6
        self.hi = (w["ts"] + w["dur"]) * 1e-6
        self.kernels = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            s = max(e["ts"] * 1e-6, self.lo)
            t = min((e["ts"] + e["dur"]) * 1e-6, self.hi)
            if t > s:
                name = str(e.get("name", ""))
                self.kernels.append((name, classify(name, classes), s, t))
        self.ranges = [(e["name"][len("portbench."):], e["ts"] * 1e-6,
                        (e["ts"] + e["dur"]) * 1e-6)
                       for e in ranges if e is not w]

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_seconds((s, t) for _, _, s, t in self.kernels)

    def class_seconds(self, cls: str) -> float:
        return union_seconds((s, t) for _, c, s, t in self.kernels
                             if c == cls)

    def device_ops(self, n: int = 10):
        """The n largest shares of device time, by kernel class (a kernel
        of no class by its own name)."""
        by = {}
        for name, c, s, t in self.kernels:
            key = c if c is not None else name[:80]
            by[key] = by.get(key, 0.0) + (t - s)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda e: -e[1])[:n]

    def idle_gaps(self, n: int = 10):
        """Idle device time by the innermost harness range it fell in
        (`window` where none), the n largest."""
        by = {}
        for a, b in gaps([(s, t) for _, _, s, t in self.kernels],
                         self.lo, self.hi):
            mid = 0.5 * (a + b)
            inner = [r for r in self.ranges if r[1] <= mid <= r[2]]
            name = min(inner, key=lambda r: r[2] - r[1])[0] if inner \
                else "window"
            by[name] = by.get(name, 0.0) + (b - a)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda e: -e[1])[:n]


class Profiler:
    """torch.profiler over CPU and CUDA activity; `stop()` exports the
    trace to a file under TMPDIR, reads it and deletes it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def start(self):
        self.prof.__enter__()

    def stop(self):
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="portbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return data.get("traceEvents", data) if isinstance(data, dict) \
            else data
