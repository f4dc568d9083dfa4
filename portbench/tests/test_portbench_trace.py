"""The trace reader on a synthetic profiler timeline: the idle share as a
union of intervals, the kernel classes, the breakdown."""

import pytest

from portbench.core import trace as tr


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


def timeline():
    return [
        ev("user_annotation", "portbench.window", 1000, 100),
        ev("user_annotation", "portbench.dit_call", 1000, 60),
        # two overlapping kernels: 1010-1040 counts once
        ev("kernel", "void flash_fwd_kernel<true, false, false>", 1010, 20),
        ev("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", 1020, 20),
        ev("kernel", "quantize_k_kernel", 1050, 5),
        ev("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", 1070, 10),
        ev("gpu_memcpy", "Memcpy DtoD", 1085, 5),
        # outside the window: clipped away
        ev("kernel", "void flash_fwd_kernel<true, false, false>", 1200, 50),
        ev("cpu_op", "aten::mm", 1000, 90),
    ]


def test_union_of_intervals():
    assert tr.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert tr.union_seconds([]) == 0
    assert tr.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]


def test_busy_and_idle_share():
    t = tr.Trace(timeline())
    assert t.window_s == pytest.approx(100e-6)
    # busy: 1010-1040, 1050-1055, 1070-1080, 1085-1090 = 50 us
    assert t.busy_s == pytest.approx(50e-6)
    import importlib.util
    path = tr.CLASSES_DIR.parent / "metrics" / "idle_pct.denoise.py"
    spec = importlib.util.spec_from_file_location("idle", path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    assert m.read({"trace": t, "kind": "denoise"}) == pytest.approx(50.0)


def test_kernel_classes():
    classes = tr.load_classes()
    assert tr.classify("void flash_fwd_kernel<true, false, false>(x)",
                       classes) == "attn_fwd"
    assert tr.classify("quantize_k_kernel", classes) == "attn_fwd"
    assert tr.classify("flash_bwd_kernel", classes) == "attn_bwd"
    # cuDNN's implicit-GEMM convolutions are convolutions, not GEMMs
    assert tr.classify("sm90_xmma_fprop_implicit_gemm_bf16", classes) \
        == "conv"
    assert tr.classify("sm90_xmma_gemm_bf16bf16_bf16f32", classes) == "gemm"
    assert tr.classify("nvjet_tst_128x256", classes) == "gemm"
    assert tr.classify("void at::native::vectorized_elementwise_kernel<4>",
                       classes) == "elementwise"
    assert tr.classify("adaln_kernel", classes) == "adaln"
    assert tr.classify("something_else", classes) is None


def test_class_seconds_and_breakdown():
    t = tr.Trace(timeline())
    assert t.class_seconds("attn_fwd") == pytest.approx(25e-6)
    ops = dict(t.device_ops())
    assert ops["attn_fwd"] == pytest.approx(25e-6)
    assert ops["gemm"] == pytest.approx(20e-6)
    assert ops["conv"] == pytest.approx(10e-6)
    gaps = dict(t.idle_gaps())
    # 1000-1010 and 1040-1050 fall in dit_call; 1055-1070 (its middle
    # after dit_call's end), 1080-1085 and 1090-1100 outside it
    assert gaps["dit_call"] == pytest.approx(20e-6)
    assert gaps["window"] == pytest.approx(30e-6)


def test_a_trace_without_the_window_range_is_refused():
    with pytest.raises(ValueError):
        tr.Trace([ev("kernel", "k", 0, 1)])
