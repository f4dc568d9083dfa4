"""The program's spans on a traced window's device timeline.

The port marks its stage-2 work with `landiff.<layer>.<part>` ranges
(`landiff_tpu_torch.observability.named_scope`), which record while a
profiler runs: host ranges in the same torch.profiler trace as the
kernels, on the same clock. A kernel, copy or set carries
`args.correlation`, and so does the CUDA runtime or driver call that
launched it (categories `cuda_runtime` / `cuda_driver`). So each device
event is put down to the `landiff.*` ranges open on the launching thread
at the launch: its innermost one for self time, each of them for time
with nested spans included. An idle gap of the device is put down to the
innermost range around the launch of the event that ends the gap when
that launch came after the gap began (the host was late), else to
`device` (the launch was queued in time); the gap that the window's end
closes goes to `window`.

Read from the raw Chrome-trace events, which core/trace.py's `Trace`
does not keep. Device events are clipped to the window's range as
there. A reading is trusted only where at least MIN_MATCHED of the
window's device time has a matched launch.

    python3 -m portbench.core.spans --workload <cell> --seed <n> \\
        --seconds <s>

runs one traced run of the cell through the harness (its result line as
usual) and prints, as the last line, the window's device and idle time by
span per unit and the per-layer readings of `metrics`.
"""

from __future__ import annotations

import bisect
import json
import sys

from portbench.core.trace import DEVICE_CATS, gaps, union_seconds

PREFIX = "landiff."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MIN_MATCHED = 0.99
# where an event or a gap has no span of its own
UNMATCHED, OUTSIDE, DEVICE, WINDOW = "unmatched", "none", "device", "window"


def _stacks(ranges, queries):
    """{key: names of the ranges open at t, outermost first} for each
    (t, key) of queries; ranges (start, end, name) nest, as the ranges
    of one thread do."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(queries):
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = tuple(r[2] for r in stack)
    return out


class Spans:
    """Device events of one traced window with the program's spans open
    at their launches; times in seconds on the profiler's clock."""

    def __init__(self, events, window_name="portbench.window"):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == window_name]
        if not win:
            raise ValueError("the trace holds no window range")
        self.lo = win[0]["ts"] * 1e-6
        self.hi = (win[0]["ts"] + win[0]["dur"]) * 1e-6
        ranges, launches, device = {}, {}, []
        for e in events:
            cat = e.get("cat")
            if cat == "user_annotation" and "dur" in e \
                    and str(e.get("name", "")).startswith(PREFIX):
                ranges.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                     e["name"]))
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e["ts"] * 1e-6,
                                      (e.get("pid"), e.get("tid")))
            elif cat in DEVICE_CATS and "dur" in e:
                s = max(e["ts"] * 1e-6, self.lo)
                t = min((e["ts"] + e["dur"]) * 1e-6, self.hi)
                if t > s:
                    device.append((s, t, (e.get("args") or {})
                                   .get("correlation")))
        self.span_counts = {}
        for rs in ranges.values():
            for a, _, name in rs:
                if self.lo <= a <= self.hi:
                    self.span_counts[name] = \
                        self.span_counts.get(name, 0) + 1
        queries = {}
        for corr, (t, thread) in launches.items():
            queries.setdefault(thread, []).append((t, corr))
        paths = {}
        for thread, qs in queries.items():
            paths.update(_stacks(ranges.get(thread, []), qs))
        # (start, end, launch time or None, spans open at the launch)
        self.events = sorted(
            (s, t) + ((launches[c][0], paths[c]) if c in launches
                      else (None, None))
            for s, t, c in device)

    @property
    def busy_s(self) -> float:
        return union_seconds((s, t) for s, t, _, _ in self.events)

    def _total(self, keep) -> float:
        total = sum(t - s for s, t, _, _ in self.events)
        part = sum(t - s for s, t, _, path in self.events if keep(path))
        return part / total if total > 0 else 0.0

    def matched_share(self) -> float:
        """The share of device time whose launch was matched."""
        return self._total(lambda path: path is not None)

    def in_span_share(self) -> float:
        """The share of device time launched inside a `landiff.*` span."""
        return self._total(lambda path: bool(path))

    def idle_by_span(self):
        """{span, `device` or `window`: idle seconds} over the window."""
        starts = [s for s, _, _, _ in self.events]
        out = {}
        for a, b in gaps([(s, t) for s, t, _, _ in self.events],
                         self.lo, self.hi):
            i = bisect.bisect_left(starts, b)
            if b >= self.hi or i == len(starts):
                key = WINDOW
            else:
                _, _, launched, path = self.events[i]
                if path is None:
                    key = UNMATCHED
                elif launched <= a:
                    key = DEVICE
                else:
                    key = path[-1] if path else OUTSIDE
            out[key] = out.get(key, 0.0) + (b - a)
        return out

    def by_span(self, units: int):
        """{span: {"self_ms", "total_ms", "launches", "launches_total",
        "idle_ms"} a unit, and "count": its ranges in the window}; events
        launched outside every span under `none`, unmatched ones under
        `unmatched`. "self" is what the innermost span launched, "total"
        what it launched with its nested spans."""
        out = {}

        def row(name):
            return out.setdefault(name, {
                "self_ms": 0.0, "total_ms": 0.0, "launches": 0,
                "launches_total": 0, "idle_ms": 0.0,
                "count": self.span_counts.get(name, 0)})

        for s, t, _, path in self.events:
            inner = UNMATCHED if path is None else (path[-1] if path
                                                    else OUTSIDE)
            row(inner)["self_ms"] += t - s
            row(inner)["launches"] += 1
            for name in set(path) if path else {inner}:
                row(name)["total_ms"] += t - s
                row(name)["launches_total"] += 1
        for name, idle in self.idle_by_span().items():
            row(name)["idle_ms"] += idle
        for r in out.values():
            for k in ("self_ms", "total_ms", "idle_ms"):
                r[k] *= 1e3 / units
            r["launches"] /= units
            r["launches_total"] /= units
        return out


# per-layer readings: name -> (span, what), "self" / "total" device ms a
# unit, "launches" the events a span launched (nested spans included)
# over its ranges, "idle" the idle ms a unit of every span under the
# prefix
READINGS = {
    "sampler_update_ms": ("landiff.sampler.update", "total"),
    "dit_modulate_ms": ("landiff.dit.modulate", "self"),
    "dit_attn_ms": ("landiff.dit.attn", "self"),
    "dit_flash_ms": ("landiff.dit.flash", "total"),
    "dit_mlp_ms": ("landiff.dit.mlp", "self"),
    "dit_launches_per_layer": ("landiff.dit.layer", "launches"),
    "idle_in_dit_ms": ("landiff.dit.", "idle"),
    "vae_norm_ms": ("landiff.vae.norm", "self"),
    "vae_conv_ms": ("landiff.vae.conv", "self"),
    "idle_in_vae_ms": ("landiff.vae.", "idle"),
}


def metrics(spans: Spans, units: int):
    """{reading: value} of READINGS, None where the window holds no range
    of its span or under MIN_MATCHED of its device time was matched."""
    out = dict.fromkeys(READINGS)
    if units <= 0 or spans.matched_share() < MIN_MATCHED:
        return out
    table = spans.by_span(units)
    for name, (span, what) in READINGS.items():
        if what == "idle":
            family = {k: r for k, r in table.items() if k.startswith(span)}
            if any(r["count"] for r in family.values()):
                out[name] = sum(r["idle_ms"] for r in family.values())
        elif table.get(span, {}).get("count"):
            r = table[span]
            out[name] = (r["launches_total"] * units / r["count"]
                         if what == "launches" else r[f"{what}_ms"])
    return out


def main(argv=None) -> int:
    """One traced run of a cell through the harness, then the spans."""
    from portbench.core import harness, trace

    kept = {}
    stop, run_cell = trace.Profiler.stop, harness.run_cell

    def keep_events(self):
        kept["events"] = stop(self)
        return kept["events"]

    def keep_result(*args, **kwargs):
        kept["result"], numbers = run_cell(*args, **kwargs)
        return kept["result"], numbers

    trace.Profiler.stop, harness.run_cell = keep_events, keep_result
    argv = list(sys.argv[1:] if argv is None else argv)
    rc = harness.main(argv + ["--trace", "1"])
    if rc or "events" not in kept:
        return rc or 1
    sp = Spans(kept.pop("events"))
    units = int(kept["result"]["attempted"])
    table = sp.by_span(units) if units else {}
    print(json.dumps({
        "units": units, "busy_s": sp.busy_s,
        "window_s": sp.hi - sp.lo,
        "span_self_s": sum(r["self_ms"] for k, r in table.items()
                           if k.startswith(PREFIX)) * units * 1e-3,
        "matched_share": sp.matched_share(),
        "in_span_share": sp.in_span_share(),
        "metrics": metrics(sp, units), "by_span": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
