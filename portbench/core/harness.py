"""The benchmark's entry: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration (a file under
portbench/configs/) and its traffic (portbench/traffic/<traffic>.json),
whose "kind" names the runner of its units (portbench/kinds/<kind>.py).
Per-layer metrics are read by portbench/metrics/<metric>.py, limits of the
comparison come from portbench/limits/<cell>.json. So a configuration, a
traffic mix, a metric or a cell is added by adding files and entries.

A run: set-up (weights and inputs from the seed on the device, the
program built and every shape of the cell's units warmed), the window
(units until `--seconds` have passed), the device's peak memory, then,
with the program's state freed, the plain reference on a sample of the
window's units drawn from the seed. It prints each compared number with
its limit on standard error and, as the last line of standard output,
one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "landiff_tpu")
PEAKS = json.loads((BENCH / "peaks.json").read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(name: str, root: Path = ROOT):
    """(cell, configuration, traffic, benchmark)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic, bench


def limits_of(cell_name: str) -> dict:
    path = BENCH / "limits" / f"{cell_name}.json"
    return json.loads(path.read_text())["limits"]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def seeds(seed: int, n: int) -> list[int]:
    """n independent 63-bit seeds derived from the run's seed."""
    ss = np.random.SeedSequence([seed & 0xFFFFFFFF, seed >> 32, 0x5EED])
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64) >> 1]


class Run:
    """What a kind's runner gets: the cell's files, the seed, the device,
    the window and the spans."""

    def __init__(self, cell, config, traffic, seed, seconds, traced,
                 device, control=False, t0=None):
        import torch
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.device = torch.device(device)
        self.control = control
        self.phases = {}
        self._t = t0

    def mark(self, name: str):
        """Record the seconds since the last mark as set-up phase `name`,
        once the device is done."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now


def _metric_readers(bench, cell_name: str, traced: bool):
    """The metrics this run reports: the cell's end-to-end metrics, or
    with --trace 1 its per-layer metrics (each with a `workloads` key
    naming the cells it is read in)."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def run_cell(cell, config, traffic, bench, seed: int, seconds: float,
             traced: bool, device: str, t0: float, control=False,
             limits=None, max_units=None):
    """One run; returns (result dict, [(name, value, limit)]). max_units
    closes the window after that many units, for tests that need the
    same units on every run."""
    import torch

    from portbench.core.window import Closed, Window

    kind = load_module(BENCH / "kinds" / f"{traffic['kind']}.py",
                       f"portbench_kind_{traffic['kind']}")
    run = Run(cell, config, traffic, seed, seconds, traced, device,
              control, t0)
    runner = kind.Runner(run)
    runner.setup()
    prof = None
    if traced:
        from portbench.core.trace import Profiler
        prof = Profiler()
        prof.start()
    window = Window(seconds, run.device, traced, max_units)
    run.window = window
    window.start()
    setup_s = window.t_start - t0
    rf = (torch.profiler.record_function("portbench.window") if traced
          else None)
    if rf is not None:
        rf.__enter__()
    try:
        runner.drive(window)   # returns only by the window's Closed
    except Closed:
        pass
    finally:
        if rf is not None:
            rf.__exit__(None, None, None)
    events = prof.stop() if prof is not None else None
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": int(cell.get("chips", 1))}
    if run.device.type == "cuda":
        dev["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(run.device))
    ctx = dict(kind=traffic["kind"], units=window.units,
               window_s=window.elapsed,
               spans=window.spans, unit_spans=window.unit_spans(),
               peaks=PEAKS, config=config, trace=None)
    metrics = {}
    breakdown = None
    if traced:
        from portbench.core.trace import Trace
        tr = Trace(events)
        del events
        ctx["trace"] = tr
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
    for m in _metric_readers(bench, cell["name"], traced):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_"
                                 + m["name"].replace(".", "_")
                                 .replace("-", "_"))
            value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    runner.release()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = runner.check(limits if limits is not None
                           else limits_of(cell["name"]))
    if getattr(runner, "detail", None):
        print(f"portbench: check detail {json.dumps(runner.detail)}",
              file=sys.stderr)
    phases = ", ".join(f"{k} {v:.3f}" for k, v in run.phases.items())
    print(f"portbench: setup {setup_s:.3f} s ({phases}), window "
          f"{window.elapsed:.3f} s"
          f" ({window.units} units), read-out "
          f"{t_check - window.t_end:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    result = {"correct": all(v is not None and v <= lim
                             for _, v, lim in numbers),
              "attempted": int(window.units),
              "failed": sum(1 for _, v, lim in numbers
                            if v is None or v > lim),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in numbers}
    return result, numbers


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, config, traffic, bench = cell_files(args.workload)
    # fixed cache directories inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(BENCH / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / ".cache" / "torch_ext")
    os.environ["USE_FLAX"] = "0"
    import torch
    chips = int(cell.get("chips", 1))
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, numbers = run_cell(cell, config, traffic, bench, args.seed,
                               args.seconds, bool(args.trace), "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 3
    for name, v, lim in numbers:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(result))
    return 0
