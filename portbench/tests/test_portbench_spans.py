"""The program's spans on a synthetic profiler timeline (core/spans.py):
device time by the innermost span open at each launch, matched by
correlation, nested spans, unmatched kernels, idle gaps by the launch
that ends them, the coverage rule; and the trace reader and every
existing metric unchanged by the program's ranges in the trace."""

import json

import pytest

from portbench.core import spans as sp
from portbench.core import trace as tr
from portbench.core.harness import BENCH, PEAKS, load_module
from portbench.tests.test_portbench_trace import ev, timeline

T1, T2 = 11, 12     # threads


def rng(name, ts, dur, tid=T1):
    return dict(ev("user_annotation", name, ts, dur), pid=1, tid=tid)


def launch(cat, ts, corr, tid=T1):
    return dict(ev(cat, "cudaLaunchKernel", ts, 1), pid=1, tid=tid,
                args={"correlation": corr})


def dev(cat, name, ts, dur, corr):
    return dict(ev(cat, name, ts, dur), pid=0, tid=7,
                args={"correlation": corr})


def program(unmatched=True):
    """Window 1000-1100 us; a layer 1000-1060 holds an attention span
    1005-1040 that holds a flash span 1010-1020. Another thread's range
    covers the window and owns none of this thread's launches."""
    events = [
        rng("portbench.window", 1000, 100),
        rng("landiff.dit.layer", 1000, 60),
        rng("landiff.dit.attn", 1005, 35),
        rng("landiff.dit.flash", 1010, 10),
        rng("landiff.vae.norm", 1000, 100, tid=T2),
        launch("cuda_runtime", 1006, 1),         # in attn
        launch("cuda_driver", 1012, 2),          # in flash
        launch("cuda_runtime", 1025, 3),         # in attn, early
        launch("cuda_runtime", 1065, 4),         # outside every span
        dev("kernel", "gemm", 1010, 10, 1),
        dev("kernel", "flash_fwd_kernel", 1020, 10, 2),
        dev("kernel", "elementwise", 1050, 5, 3),
        dev("gpu_memcpy", "Memcpy DtoD", 1070, 5, 4),
        dev("kernel", "outside the window", 1200, 10, 4),
    ]
    if unmatched:
        events.append(dev("kernel", "no launch", 1080, 5, 99))
    return events


def test_self_and_nested_time_by_the_innermost_span():
    table = sp.Spans(program()).by_span(units=1)
    us = lambda name, k: table[name][k] * 1e3
    assert us("landiff.dit.attn", "self_ms") == pytest.approx(15)
    assert us("landiff.dit.flash", "self_ms") == pytest.approx(10)
    assert us("landiff.dit.layer", "self_ms") == pytest.approx(0)
    assert us("landiff.dit.layer", "total_ms") == pytest.approx(25)
    assert us("landiff.dit.attn", "total_ms") == pytest.approx(25)
    assert table["landiff.dit.layer"]["launches_total"] == 3
    assert table["landiff.dit.attn"]["launches"] == 2
    assert table["landiff.dit.layer"]["count"] == 1
    # launched outside every span, and with no launch at all
    assert us(sp.OUTSIDE, "self_ms") == pytest.approx(5)
    assert us(sp.UNMATCHED, "self_ms") == pytest.approx(5)
    # another thread's range takes nothing
    assert "landiff.vae.norm" not in table


def test_per_unit():
    one = sp.Spans(program()).by_span(units=1)
    two = sp.Spans(program()).by_span(units=2)
    for name, row in one.items():
        for k in ("self_ms", "total_ms", "idle_ms", "launches"):
            assert two[name][k] == pytest.approx(row[k] / 2)


def test_idle_gaps_by_the_launch_that_ends_them():
    idle = {k: v * 1e6 for k, v in sp.Spans(program()).idle_by_span()
            .items()}
    assert idle == pytest.approx({
        "landiff.dit.attn": 10,   # 1000-1010: launched at 1006, late
        sp.DEVICE: 20,            # 1030-1050: launched at 1025, in time
        sp.OUTSIDE: 15,           # 1055-1070: late, outside every span
        sp.UNMATCHED: 5,          # 1075-1080: its kernel has no launch
        sp.WINDOW: 15})           # 1085-1100: the window's end


def test_shares_and_the_coverage_rule():
    s = sp.Spans(program())
    assert s.matched_share() == pytest.approx(30 / 35)
    assert s.in_span_share() == pytest.approx(25 / 35)
    assert s.busy_s == pytest.approx(35e-6)
    assert all(v is None for v in sp.metrics(s, 2).values())

    s = sp.Spans(program(unmatched=False))
    assert s.matched_share() == pytest.approx(1.0)
    m = sp.metrics(s, 2)
    assert m["dit_attn_ms"] == pytest.approx(7.5e-3)
    assert m["dit_flash_ms"] == pytest.approx(5e-3)
    assert m["dit_launches_per_layer"] == pytest.approx(3)
    assert m["idle_in_dit_ms"] == pytest.approx(5e-3)
    # no range in the window, or no device time under it: nothing read
    for name in ("dit_modulate_ms", "dit_mlp_ms", "sampler_update_ms",
                 "vae_norm_ms", "vae_conv_ms", "idle_in_vae_ms"):
        assert m[name] is None


def test_a_parent_trace_without_spans_reads_nothing():
    events = [e for e in program(unmatched=False)
              if not e["name"].startswith("landiff.")]
    s = sp.Spans(events)
    assert s.matched_share() == pytest.approx(1.0)
    assert s.in_span_share() == 0
    assert all(v is None for v in sp.metrics(s, 2).values())


def test_a_trace_without_the_window_range_is_refused():
    with pytest.raises(ValueError):
        sp.Spans([ev("kernel", "k", 0, 1)])


def test_program_ranges_leave_the_trace_and_its_readers_as_they_were():
    """test_portbench_trace.py's timeline, and the same timeline with
    program ranges, launches and correlation ids: the trace reader, the
    breakdown and every metric reader read the same."""
    plain = timeline()
    corr = 0
    spanned = [rng("landiff.dit.layer", 1000, 60),
               rng("landiff.dit.flash", 1005, 10)]
    for e in plain:
        e = dict(e)
        if e["cat"] in tr.DEVICE_CATS:
            corr += 1
            e["args"] = {"correlation": corr}
            spanned.append(launch("cuda_runtime", e["ts"] - 3, corr))
        spanned.append(e)
    a, b = tr.Trace(plain), tr.Trace(spanned)
    assert (a.window_s, a.busy_s) == (b.window_s, b.busy_s)
    assert a.kernels == b.kernels and a.ranges == b.ranges
    assert a.device_ops() == b.device_ops()
    assert a.idle_gaps() == b.idle_gaps()
    config = json.loads((BENCH / "configs" / "landiff-2b.json").read_text())
    spans = list(a.ranges)
    readers = sorted((BENCH / "metrics").glob("*.py"))
    assert len(readers) >= 9
    for kind in ("denoise", "vae_decode"):
        for path in readers:
            m = load_module(path, "t_spans_" + path.stem.replace(".", "_"))
            read = [m.read(dict(kind=kind, units=2, window_s=a.window_s,
                                spans=spans, unit_spans=[(0, 1), (1, 2)],
                                peaks=PEAKS, config=config, trace=t))
                    for t in (a, b)]
            assert read[0] == read[1], path.name
