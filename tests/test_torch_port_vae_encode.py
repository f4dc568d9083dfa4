"""PyTorch port: the VAE's encode side (DownSample3D, the encoder whole and
streamed in 9 + 8 frame chunks, encode_first_stage as the posterior's
mode and sampled with a given noise) and image-to-video through the
stage-2 wrapper's prefix_video, held against the JAX package at the tiny
config in f32 on the parameters of _torch_port_helpers.stage2_params
(the port's init, zero leaves filled; the JAX layouts for JAX, the
bridge for the port).

Tolerances: 1e-4 relative + 1e-4 absolute for f32 work that sums in
another order (one conv3d against JAX's per-frame 2-D taps, as the
decoder's test); the prefix-video request as the stage-2 wrapper's test:
latents 1e-3, video within one uint8 step, and the prefix frame's
latents held to the encoder's own 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_helpers import (assert_close, fast_compiles, fast_jit,
                                 randn, sampler_noises, stage2_params)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.diffusion import engine as jengine
from landiff_tpu.models import vae as jvae
from landiff_tpu.pipeline import dif_infer as jdi
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.diffusion import engine as tengine
from landiff_tpu_torch.models import vae as tvae
from landiff_tpu_torch.pipeline import dif_infer as tdi

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy
TOL = dict(atol=1e-4, rtol=1e-4)


def _video(seed, frames, h=32, w=48):
    return np.clip(randn(seed, 1, 3, frames, h, w) * 0.5, -1.0, 1.0)


def test_downsample3d_matches_jax():
    jp, tp = (p["vae"]["encoder"]["down"][0]["down"]
              for p in stage2_params())
    c = TC.vae.ch
    for frames, compress in ((5, True), (4, True), (3, False)):
        x = randn(30 + frames, 1, c, frames, 8, 12)
        want = jvae.downsample3d(jp, jnp.asarray(x.transpose(0, 2, 3, 4, 1)),
                                 compress)
        got = tvae.downsample3d(tp, T(x), compress)
        assert_close(got, np.asarray(want).transpose(0, 4, 1, 2, 3), **TOL)


def test_encode_whole_and_streaming_match_jax():
    """13 frames: whole, and streamed as [0:9] + [9:13] with the conv
    cache carried (per-chunk GroupNorm: a different function)."""
    jp, tp = (p["vae"]["encoder"] for p in stage2_params())
    x = _video(31, 13)
    want = fast_jit(lambda p, v: jvae.encode(p, v, JC.vae, jnp.float32),
                    jp, x)(jp, x)
    got = tvae.encode(tp, T(x), TC.vae, torch.float32)
    assert got.shape == want.shape == (1, 2 * TC.vae.z_channels, 7, 16, 24)
    assert_close(got, want, **TOL)
    want_s = jvae.encode_streaming(jp, jnp.asarray(x), JC.vae,
                                   compute_dtype=jnp.float32)
    got_s = tvae.encode_streaming(tp, T(x), TC.vae, torch.float32)
    assert got_s.shape == want_s.shape
    assert_close(got_s, want_s, **TOL)
    assert float(np.abs(np.asarray(want_s) - np.asarray(want)).max()) > 1e-4


def test_sliced_causal_conv_equals_whole(monkeypatch):
    """A conv past the 32-bit element limit runs in slices of output
    frames: with the limit cut to a few frames' worth, the kt=3 conv
    (repeated first frame and a carried cache front, ragged last slice)
    and the whole encode equal the unsliced results bit for bit."""
    tp = stage2_params()[1]["vae"]["encoder"]
    x = T(_video(36, 13))
    conv = tp["conv_in"]
    assert tuple(conv["w"].shape[2:]) == (3, 3, 3)
    cache = {"c": T(randn(37, 1, 3, 2, 32, 48))}
    whole = [tvae.causal_conv3d(conv, x, c, "c", {}, False)
             for c in (None, cache)]
    want = tvae.encode(tp, x, TC.vae, torch.float32)
    # conv_in: 8 output channels of 32 x 48 a frame, so 4 output frames
    # a slice (13 = 3 * 4 + 1); deeper levels slice at other widths
    monkeypatch.setattr(tvae, "_INT32_ELEMS", 6 * 8 * 32 * 48 + 5)
    calls = []
    conv3d = tvae.F.conv3d
    monkeypatch.setattr(tvae.F, "conv3d", lambda xp, w, **kw: (
        calls.append((xp.shape[2], w.shape[2])), conv3d(xp, w, **kw))[1])
    for c, ref in zip((None, cache), whole):
        calls.clear()
        got = tvae.causal_conv3d(conv, x, c, "c", {}, False)
        assert calls == [(6, 3)] * 3 + [(3, 3)]
        assert torch.equal(got, ref)
    calls.clear()
    got = tvae.encode(tp, x, TC.vae, torch.float32)
    assert len(calls) > len(set(calls))
    assert torch.equal(got, want)


def test_encode_first_stage_matches_jax():
    """The posterior's mode, and a sample with JAX's noise for the key
    handed to the port; streamed too."""
    jp, tp = (p["vae"] for p in stage2_params())
    x = _video(32, 5)
    key = jax.random.PRNGKey(3)
    noise = None
    for k in (None, key):
        want = fast_jit(lambda p, v: jengine.encode_first_stage(
            p, v, JC.vae, key=k, compute_dtype=jnp.float32), jp, x)(jp, x)
        got = tengine.encode_first_stage(tp, T(x), TC.vae, noise=noise,
                                         compute_dtype=torch.float32)
        assert got.shape == want.shape == (1, 3, TC.vae.z_channels, 16, 24)
        assert_close(got, want, **TOL)
        # the draw of jax.random.normal(key, mean.shape) for the sample
        noise = T(np.array(jax.random.normal(
            key, np.asarray(want).transpose(0, 2, 1, 3, 4).shape,
            jnp.float32)))
    want = jengine.encode_first_stage(jp, jnp.asarray(x), JC.vae,
                                      compute_dtype=jnp.float32,
                                      streaming=True)
    got = tengine.encode_first_stage(tp, T(x), TC.vae, streaming=True,
                                     compute_dtype=torch.float32)
    assert_close(got, want, **TOL)
    gen = torch.Generator().manual_seed(4)
    drawn = tengine.encode_first_stage(tp, T(x), TC.vae, generator=gen,
                                       compute_dtype=torch.float32)
    assert not torch.equal(drawn, got)
    assert_close(tengine.pre_process_video(T(np.array([0.25, 1.5],
                                                      np.float32))),
                 np.array([-0.5, 1.0]), atol=0, rtol=0)


def test_prefix_video_request_matches_jax():
    """Image to video: a 1-frame prefix in [0, 1] is encoded and held over
    the first latent frame while the rest is sampled (the JAX wrapper's
    init noise and SDE noise handed to the port)."""
    jparams, tparams = stage2_params()
    d = TC.dit
    codes = np.random.default_rng(33).integers(
        0, TC.tokenizer.vq.codebook_size, TC.tokenizer.titok.latent_tokens)
    noise = randn(34, 1, d.latent_frames, d.in_channels, d.latent_height,
                  d.latent_width)
    prefix = np.clip(randn(35, 1, 3, 1, 2 * d.latent_height,
                           2 * d.latent_width) * 0.3 + 0.5, 0.0, 1.0)
    seed = 6
    _, k_samp = jax.random.split(jax.random.PRNGKey(seed))
    steps = sampler_noises(k_samp, TC.sampler.num_steps, noise.shape)
    with fast_compiles():
        want = jdi.CogModelInferWrapper(jparams, JC,
                                        compute_dtype=jnp.float32)(
            jdi.VideoTask("x", "a red panda", seed, semantic_token=codes),
            prefix_video=prefix, init_noise=noise)
    tw = tdi.CogModelInferWrapper(tparams, TC, compute_dtype=torch.float32,
                                  device="cpu")
    got = tw(tdi.VideoTask("x", "a red panda", seed, semantic_token=codes),
             prefix_video=prefix, init_noise=noise, step_noise=steps)
    assert "vae_encode" in tw.phase_seconds
    assert got.latent.shape == want.latent.shape
    enc = tengine.encode_first_stage(
        tparams["vae"], tengine.pre_process_video(T(prefix)), TC.vae,
        compute_dtype=torch.float32)
    assert_close(T(got.latent[:, :1]), enc.numpy(), atol=0, rtol=0)
    np.testing.assert_allclose(got.latent[:, :1], want.latent[:, :1],
                               **TOL)
    np.testing.assert_allclose(got.latent, want.latent, atol=1e-3,
                               rtol=1e-3)
    apart = np.abs(np.round(got.result * 255.0)
                   - np.round(want.result * 255.0))
    assert apart.max() <= 1.0
