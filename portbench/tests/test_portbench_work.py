"""The work and byte counts of the metric readers against hand counts."""

import json

import pytest

from portbench.core.harness import BENCH, PEAKS, load_module


def reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "t_" + name.replace(".", "_"))


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_landiff_2b_step_flops_match_the_hand_count():
    d = config("landiff-2b")["dit"]
    # 45 layers x (linears 44.2 M params x 2 x 35,552 rows + attention
    # 4 x 2 x 30 x 17,776^2 x 64), plus the 15 control output linears
    rows = 2 * 17776
    layer = 2 * 44236800 * rows + 4 * 2 * 30 * 17776 ** 2 * 64
    hand = 45 * layer + 15 * 2 * 1920 ** 2 * rows
    flops = reader("denoise_mfu").step_flops(d)
    assert flops == pytest.approx(hand, rel=2e-3)
    assert flops == pytest.approx(3.6e14, rel=0.02)


def test_cogvideox_5b_step_flops_are_1e15():
    d = config("cogvideox-5b")["dit"]
    flops = reader("denoise_mfu").step_flops(d)
    assert flops == pytest.approx(1.0e15, rel=0.02)
    # 63 layers x (linears 8.05e12 + attention 7.76e12)
    assert flops == pytest.approx(63 * (8.05e12 + 7.76e12), rel=0.02)


def test_attention_call_least_time():
    d = config("landiff-2b")["dit"]
    m = reader("attn_fwd_roofline")
    flops = 4 * 2 * 30 * 17776 ** 2 * 64
    assert flops == pytest.approx(4.85e12, rel=1e-3)
    assert m.call_least_s(d, PEAKS) * 1e3 == pytest.approx(4.91, abs=0.005)
    d5 = config("cogvideox-5b")["dit"]
    assert m.call_least_s(d5, PEAKS) * 1e3 == pytest.approx(7.85, abs=0.01)


def test_attention_bound_takes_bytes_when_they_bind():
    d = dict(config("landiff-2b")["dit"], latent_frames=1, latent_height=2,
             latent_width=2, text_length=0)
    m = reader("attn_fwd_roofline")
    S, H, Dk = 1, 30, 64
    byts = 4 * 2 * S * H * Dk * 2
    assert m.call_least_s(d, PEAKS) == pytest.approx(
        byts / PEAKS["hbm_bytes_per_s"])


def test_vae_decode_flops_count_every_convolution():
    c = config("landiff-2b")
    m = reader("vae_mfu")
    flops = m.decode_flops(json.dumps(c["vae"], sort_keys=True),
                           json.dumps(c["dit"], sort_keys=True))

    def conv(ci, co, k, t, h, w):
        return 2 * ci * co * k * t * h * w

    # (channels, frames, height, width) of levels 3..0; the chunked
    # decode sees every output frame once, 13 latent frames -> 49
    levels = [(512, 13, 60, 90), (256, 25, 120, 180), (256, 49, 240, 360),
              (128, 49, 480, 720)]
    hand, c_in = conv(16, 512, 27, 13, 60, 90), 512        # conv_in
    zq = 2 * 2 * 16                # each SpatialNorm's two 1x1x1 convs
    for blocks, (ch, t, h, w) in [(2, levels[0])] + [(4, lv)
                                                     for lv in levels]:
        for b in range(blocks):
            cin = c_in if b == 0 else ch
            hand += conv(cin, ch, 27, t, h, w) + conv(ch, ch, 27, t, h, w)
            hand += zq * (cin + ch) * 13 * 60 * 90
            if cin != ch:
                hand += conv(cin, ch, 1, t, h, w)
        c_in = ch
    for (ch, _, _, _), (_, t, h, w) in zip(levels[:3], levels[1:]):
        hand += conv(ch, ch, 9, t, h, w)                    # upsample convs
    hand += zq * 128 * 13 * 60 * 90 + conv(128, 3, 27, 49, 480, 720)
    assert flops == pytest.approx(hand, rel=0.01)
    assert flops == pytest.approx(3.13e14, rel=0.01)


def test_mfu_is_a_share_of_the_peak():
    d = config("landiff-2b")["dit"]
    m = reader("denoise_mfu")
    ctx = {"kind": "denoise", "units": 10, "window_s": 10 * 1.2,
           "trace": object(), "config": {"dit": d}, "peaks": PEAKS}
    assert m.read(ctx) == pytest.approx(
        100 * m.step_flops(d) / (1.2 * 989e12))
    assert m.read(dict(ctx, trace=None)) is None
