"""The measured window: a deadline, the units completed before it, and
the harness's spans.

A cell's runner calls `begin_unit()` where each unit of work starts.
Once the host clock has passed the deadline there, the window waits for
the device, records its end and raises `Closed`: the units counted are
exactly those whose work the device has finished, and the window's time
runs from `start()` to that wait. In a traced run every unit boundary and
every span waits for the device, so that spans measure device work; in an
untraced run nothing inside the window waits.
"""

from __future__ import annotations

import contextlib
import time


class Closed(Exception):
    """The deadline passed at a unit boundary."""


class Window:
    def __init__(self, seconds: float, device, traced: bool,
                 max_units: int | None = None):
        self.seconds = float(seconds)
        self.device = device
        self.traced = traced
        self.max_units = max_units
        self.units = 0
        self.started = 0
        self.t_start = self.t_end = None
        self.unit_times = []       # host time at each unit's start
        self.spans = []            # (name, t0, t1), host seconds

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def start(self):
        self.sync()
        self.t_start = time.perf_counter()
        self.deadline = self.t_start + self.seconds

    def _close(self):
        self.sync()
        self.t_end = time.perf_counter()
        raise Closed()

    def begin_unit(self):
        """Called where a unit starts: counts the unit before it as
        complete and closes the window past the deadline (or after
        max_units units, for set-up's warm units)."""
        if self.traced:
            self.sync()
        now = time.perf_counter()
        if self.started:
            self.units += 1
        if now >= self.deadline or (self.max_units is not None
                                    and self.units >= self.max_units):
            self._close()
        self.started += 1
        self.unit_times.append(now)

    @property
    def elapsed(self) -> float:
        return self.t_end - self.t_start

    @contextlib.contextmanager
    def span(self, name: str):
        """A named span: host times, waiting for the device at both ends
        in a traced run, and a profiler range of the same name."""
        if not self.traced:
            yield
            return
        import torch
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{name}"):
            yield
            self.sync()
        self.spans.append((name, t0, time.perf_counter()))

    def unit_spans(self):
        """(start, end) host times of every completed unit."""
        ends = self.unit_times[1:self.units] + [self.t_end]
        return list(zip(self.unit_times[:self.units], ends))
