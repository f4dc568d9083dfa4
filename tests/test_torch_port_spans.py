"""PyTorch port: the program's spans (observability.named_scope) through
stage 2, at the tiny config in f32 on the CPU.

With no profiler recording, a span is one shared no-op context and makes
no call into the dispatcher. Under `observability.trace` a ControlNet DiT
call, a sampler run over the denoise closure and a streaming decode emit
the `landiff.*` spans, as many as the model's structure gives and nested
as the code is, and compute the same bits as without a profiler."""

import json

import pytest
import torch

from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch import observability
from landiff_tpu_torch.diffusion import engine, samplers
from landiff_tpu_torch.models import dit as dit_lib
from landiff_tpu_torch.models import semantic_cond as sc_lib
from landiff_tpu_torch.models import vae as vae_lib

torch.set_num_threads(2)   # tier-1 runs six xdist workers

CFG = tcfg.tiny_test_config()
# latent frames of the decode: chunks [0, 3) and [3, 5)
DECODE_FRAMES, DECODE_CHUNKS = 5, 2


def _perturbed(tree, gen):
    """The tree with every float leaf moved by a small draw, so that the
    zero-init gates and taps carry something."""
    if isinstance(tree, dict):
        return {k: _perturbed(v, gen) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturbed(v, gen) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree + 0.05 * torch.randn(tree.shape, generator=gen)
    return tree


def _inputs():
    gen = torch.Generator().manual_seed(0)
    d, tok = CFG.dit, CFG.tokenizer.titok
    n_codes = tok.iframe_latent_tokens + (tok.temporal_size - 1) \
        * tok.pframe_latent_tokens
    return {
        "main": _perturbed(dit_lib.init(gen, d), gen),
        "control": _perturbed(dit_lib.init(gen, d, control=True), gen),
        "sem": _perturbed(sc_lib.init(gen, CFG.tokenizer, CFG.semantic_cond),
                          gen),
        "vae": _perturbed(vae_lib.init(gen, CFG.vae), gen),
        "context": torch.randn((1, d.text_length, d.text_dim),
                               generator=gen),
        "codes": torch.randint(0, CFG.tokenizer.vq.codebook_size,
                               (1, n_codes), generator=gen),
        "x": torch.randn((1, d.latent_frames, d.in_channels,
                          d.latent_height, d.latent_width), generator=gen),
        "x2": torch.randn((2, d.latent_frames, d.in_channels,
                           d.latent_height, d.latent_width), generator=gen),
        "sem2": torch.randn((2, d.latent_frames, d.in_channels,
                             d.latent_height, d.latent_width),
                            generator=gen),
        "noises": torch.randn((CFG.sampler.num_steps, 1, d.latent_frames,
                               d.in_channels, d.latent_height,
                               d.latent_width), generator=gen),
        "z": torch.randn((1, DECODE_FRAMES, CFG.vae.z_channels,
                          d.latent_height, d.latent_width), generator=gen),
    }


def _stage2(inp):
    """One ControlNet DiT call, a sampler run over the denoise closure
    (which computes the semantic feature) and a streaming decode with
    its post-processing, in f32."""
    d, f32 = CFG.dit, torch.float32
    with torch.no_grad():
        call = dit_lib.control_warp_forward(
            inp["main"], inp["control"], inp["x2"],
            torch.tensor([500.0, 500.0]), inp["context"].expand(2, -1, -1),
            d, inp["sem2"], compute_dtype=f32)
        fn = engine.make_denoise_fn(
            inp["main"], inp["control"], inp["sem"], d, CFG.sampler,
            CFG.tokenizer, CFG.semantic_cond, inp["context"],
            torch.zeros_like(inp["context"]), inp["codes"], compute_dtype=f32)
        latents = samplers.vpsde_dpmpp2m_sample(fn, inp["x"], CFG.sampler,
                                                noises=inp["noises"])
        video = engine.decode_first_stage(inp["vae"], inp["z"], CFG.vae,
                                          compute_dtype=f32)
        video8 = engine.video_to_uint8(engine.post_process_video(video))
    return call, latents, video8


def test_named_scope_off_is_a_shared_no_op(monkeypatch):
    def entered(*args, **kwargs):
        raise AssertionError("a span entered the profiler")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        entered)
    with pytest.raises(AssertionError, match="entered the profiler"):
        with torch.profiler.record_function("landiff.probe"):
            pass
    assert not torch.autograd._profiler_enabled()
    assert observability.named_scope("landiff.a") is \
        observability.named_scope("landiff.b")
    _stage2(_inputs())


def test_stage2_spans_under_a_trace(tmp_path):
    inp = _inputs()
    want = _stage2(inp)
    with observability.trace(str(tmp_path), device="cpu"):
        got = _stage2(inp)
    for a, b in zip(want, got):
        assert torch.equal(a, b)

    (path,) = tmp_path.glob("*.json")
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("landiff.")]
    count = {}
    for e in spans:
        count[e["name"]] = count.get(e["name"], 0) + 1
    d, steps = CFG.dit, CFG.sampler.num_steps
    calls = 1 + steps                      # the direct call + one a step
    layers = d.num_layers + d.control_layers
    assert count["landiff.sampler.step"] == steps
    assert count["landiff.sampler.update"] == steps
    assert count["landiff.denoise.call"] == steps
    assert count["landiff.semantic.feature"] == 1
    assert count["landiff.dit.layer"] == layers * calls
    assert count["landiff.dit.modulate"] == 3 * layers * calls
    for part in ("attn", "flash", "mlp"):
        assert count[f"landiff.dit.{part}"] == layers * calls
    assert count["landiff.dit.control"] == 2 * d.control_layers * calls
    assert count["landiff.dit.embed"] == 2 * calls
    assert count["landiff.dit.head"] == calls
    assert count["landiff.vae.chunk"] == DECODE_CHUNKS
    assert count["landiff.vae.post"] == 2
    for part in ("block", "norm", "conv", "resample"):
        assert count[f"landiff.vae.{part}"] > 0

    def inside(inner, outer):
        return [any(o["tid"] == e["tid"] and o["ts"] <= e["ts"]
                    and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
                    for o in spans if o["name"] == outer)
                for e in spans if e["name"] == inner]

    assert all(inside("landiff.dit.flash", "landiff.dit.attn"))
    assert all(inside("landiff.dit.attn", "landiff.dit.layer"))
    assert all(inside("landiff.denoise.call", "landiff.sampler.step"))
    assert all(inside("landiff.vae.block", "landiff.vae.chunk"))
    assert any(inside("landiff.vae.conv", "landiff.vae.norm"))
