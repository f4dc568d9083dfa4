"""The window's unit counting and spans on a fake closure."""

import time

import pytest
import torch

from portbench.core.window import Closed, Window


def drive(window, unit_s):
    while True:
        window.begin_unit()
        with window.span("call"):
            time.sleep(unit_s)


@pytest.mark.parametrize("traced", [False, True])
def test_units_are_those_completed_before_the_deadline(traced):
    w = Window(0.2, torch.device("cpu"), traced)
    w.start()
    with pytest.raises(Closed):
        drive(w, 0.02)
    assert w.elapsed >= 0.2
    # every counted unit ended inside the window, none after it
    assert w.units == pytest.approx(w.elapsed / 0.02, abs=1.5)
    assert len(w.unit_spans()) == w.units
    assert all(b >= a for a, b in w.unit_spans())
    assert (len(w.spans) == w.units) if traced else not w.spans


def test_max_units_closes_a_warm_up_window():
    w = Window(1e9, torch.device("cpu"), False, max_units=3)
    w.start()
    with pytest.raises(Closed):
        drive(w, 0.0)
    assert w.units == 3


def test_spans_are_read_by_the_span_metrics():
    from portbench.core.harness import BENCH, load_module
    w = Window(0.1, torch.device("cpu"), True)
    w.start()
    with pytest.raises(Closed):
        drive(w, 0.01)
    spans = [("dit_call", a, b) for _, a, b in w.spans]
    ctx = {"spans": spans, "unit_spans": w.unit_spans()}
    call = load_module(BENCH / "metrics" / "dit_call_ms.py", "t_call")
    self_ = load_module(BENCH / "metrics" / "sampler_self_ms.py", "t_self")
    assert call.read(ctx) == pytest.approx(10.0, abs=5.0)
    assert 0 <= self_.read(ctx) < 5.0
