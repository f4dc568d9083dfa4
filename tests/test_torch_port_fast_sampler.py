"""PyTorch port: cross-step reuse of the model output (LANDIFF_STEP_REUSE)
and the guidance window (LANDIFF_CFG_WINDOW) in the VPSDE sampler, the
engine's cond_only twin, and how sample_latents reads the two knobs,
LANDIFF_FAST=2 supplying both, held against the JAX package."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (assert_close, fast_compiles, fast_jit,
                                 randn, sampler_noises, stage2_params)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.diffusion import engine as jeng
from landiff_tpu.diffusion import samplers as jsamp
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.diffusion import engine as teng
from landiff_tpu_torch.diffusion import samplers as tsamp

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
_KNOBS = ("LANDIFF_FAST", "LANDIFF_STEP_REUSE", "LANDIFF_CFG_WINDOW")


def test_schedules_match_jax():
    for n in (1, 4, 7, 50):
        for k in (1, 2, 3):
            for head in (0, 1, 3):
                for tail in (0, 1, 3):
                    np.testing.assert_array_equal(
                        tsamp.reuse_compute_schedule(n, k, head, tail),
                        jsamp.reuse_compute_schedule(n, k, head, tail))
        for lo, hi in ((0, 0), (2, 44), (-1, -3), (3, 2), (1, 99)):
            np.testing.assert_array_equal(
                tsamp.cfg_window_schedule(n, lo, hi),
                jsamp.cfg_window_schedule(n, lo, hi))
    assert (tsamp.REUSE_HEAD_DEFAULT, tsamp.REUSE_TAIL_DEFAULT) == (
        jsamp.REUSE_HEAD_DEFAULT, jsamp.REUSE_TAIL_DEFAULT)
    # the released sampler under LANDIFF_FAST=2: 28 calls, 6 cond-only
    compute = tsamp.reuse_compute_schedule(50, 2)
    full = tsamp.cfg_window_schedule(50, 2, 44)
    assert compute.sum() == 28 and (compute & full).sum() == 22
    assert list(np.nonzero(compute & ~full)[0]) == [0, 1, 45, 47, 48, 49]


def _denoisers(w, calls):
    """The same denoiser for both packages, with a cond_only twin that
    differs from it; the port's counts its calls."""
    def jden(x, step):
        return jnp.tanh(x * step["alpha"] + w) * step["cfg_scale"]

    def jcond(x, step):
        return jnp.tanh(x * step["alpha"] - w)

    jden.cond_only = jcond
    tw = torch.from_numpy(w)

    def tden(x, step):
        calls.append(("full", step["idx"]))
        return torch.tanh(x * step["alpha"] + tw) * step["cfg_scale"]

    def tcond(x, step):
        calls.append(("cond", step["idx"]))
        return torch.tanh(x * step["alpha"] - tw)

    tden.cond_only = tcond
    return jden, tden


def test_sampler_with_reuse_and_window_matches_jax():
    """4 steps with head = tail = 1, so step 2 reuses the residual of step
    1; the window (1, 3) makes steps 0 and 3 cond-only. The SDE noise as
    the JAX scan draws it, one draw per step whether the model ran or
    not. Tolerance 1e-5: f32 elementwise work only. (One JAX run covers
    both: each program it compiles costs seconds.)"""
    x0 = randn(0, 1, 3, 4, 8, 12)
    w = randn(1, 1, 3, 4, 8, 12, scale=0.3)
    calls = []
    jden, tden = _denoisers(w, calls)
    key = jax.random.PRNGKey(13)
    kw = dict(reuse_every=2, reuse_head=1, reuse_tail=1, cfg_window=(1, 3))
    with fast_compiles():
        want = jsamp.vpsde_dpmpp2m_sample(jden, jnp.asarray(x0),
                                          jcfg.SamplerConfig(num_steps=4),
                                          key=key, **kw)
    got = tsamp.vpsde_dpmpp2m_sample(
        tden, torch.from_numpy(x0), tcfg.SamplerConfig(num_steps=4),
        noises=sampler_noises(key, 4, x0.shape), **kw)
    assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert [kind for kind, _ in calls] == ["cond", "full", "cond"]
    plain = tsamp.vpsde_dpmpp2m_sample(
        tden, torch.from_numpy(x0), tcfg.SamplerConfig(num_steps=4),
        noises=sampler_noises(key, 4, x0.shape))
    assert not torch.equal(plain, got)


def _count_sample(monkeypatch, env, with_cond_only=True, **kw):
    """engine.sample_latents at 50 steps on a counting denoiser; returns
    the calls [(kind, step index)]."""
    for name in _KNOBS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    w = randn(2, 1, 3, 4, 8, 12, scale=0.3)
    calls = []
    _, tden = _denoisers(w, calls)
    if not with_cond_only:
        del tden.cond_only
    d = TC.dit
    teng.sample_latents(tden, tcfg.SamplerConfig(num_steps=50), d,
                        generator=torch.Generator().manual_seed(0),
                        init_noise=randn(3, 1, d.latent_frames,
                                         d.in_channels, d.latent_height,
                                         d.latent_width), **kw)
    return calls


def test_sample_latents_reads_the_knobs(monkeypatch, caplog):
    """Fault 1 of the port (sample_latents read neither knob): with
    LANDIFF_STEP_REUSE=2 alone JAX calls the model at 28 of 50 steps, so
    must the port; LANDIFF_FAST=2 adds the window [2, 44): 22 two-row
    calls and 6 cond-only ones; an explicit argument wins."""
    assert len(_count_sample(monkeypatch, {})) == 50
    calls = _count_sample(monkeypatch, {"LANDIFF_STEP_REUSE": "2"})
    assert len(calls) == 28 and {k for k, _ in calls} == {"full"}
    calls = _count_sample(monkeypatch, {"LANDIFF_FAST": "2"})
    assert len(calls) == 28
    cond = [50 - idx for kind, idx in calls if kind == "cond"]
    assert cond == [0, 1, 45, 47, 48, 49]      # step i has idx 50 - i
    calls = _count_sample(monkeypatch, {"LANDIFF_FAST": "2"},
                          reuse_every=0, cfg_window=(0, 50))
    assert len(calls) == 50 and {k for k, _ in calls} == {"full"}
    # a window from the environment without a cond_only twin: dropped with
    # a warning (engine.py:188-198); an explicit one raises
    with caplog.at_level(logging.WARNING, logger="landiff_tpu_torch"):
        calls = _count_sample(monkeypatch, {"LANDIFF_CFG_WINDOW": "2,44"},
                              with_cond_only=False)
    assert len(calls) == 50 and "LANDIFF_CFG_WINDOW ignored" in caplog.text
    with pytest.raises(ValueError, match="cond_only"):
        _count_sample(monkeypatch, {}, with_cond_only=False,
                      cfg_window=(2, 44))


def test_cond_only_matches_jax():
    """Fault 2 of the port (no cond_only): make_denoise_fn's twin runs the
    cond row alone, batch 1, no CFG combination (engine.py:125-145), at
    the tiny config in f32. JAX's twin gets the port's semantic feature
    (held to JAX's in tests/test_torch_port_semantic.py), which spares an
    eager TiTok run here. Tolerance 1e-4 as the DiT's."""
    from landiff_tpu_torch.models import semantic_cond as tsc

    jparams, tparams = stage2_params()
    d = JC.dit
    ctx = randn(4, 1, d.text_length, d.text_dim)
    codes = np.random.default_rng(5).integers(
        0, TC.tokenizer.vq.codebook_size, (1, TC.tokenizer.titok.latent_tokens))
    x = randn(6, 1, d.latent_frames, d.in_channels, d.latent_height,
              d.latent_width)
    step = tsamp.step_dicts(TC.sampler)[1]
    sem = tsc.semantic_feature_from_tokens(
        tparams["semantic"], torch.from_numpy(codes), TC.tokenizer,
        TC.semantic_cond, forward_t=d.latent_frames,
        compute_dtype=torch.float32)
    jfn, bundle = jeng.make_denoise_fn(
        jparams["main"], None, None, d, JC.sampler, JC.tokenizer,
        JC.semantic_cond, jnp.asarray(ctx), jnp.zeros_like(jnp.asarray(ctx)),
        None, compute_dtype=jnp.float32)
    bundle.update(control=jparams["control"],
                  sem_feature=jnp.asarray(sem.numpy()))
    jstep = {k: jnp.asarray(step[k]) for k in ("alpha", "timestep", "idx",
                                               "cfg_scale")}
    cond = fast_jit(jfn.cond_only, jnp.asarray(x), jstep, bundle)
    want = np.asarray(cond(jnp.asarray(x), jstep, bundle))
    tfn = teng.make_denoise_fn(
        tparams["main"], tparams["control"], tparams["semantic"], TC.dit,
        TC.sampler, TC.tokenizer, TC.semantic_cond, torch.from_numpy(ctx),
        torch.zeros(ctx.shape), torch.from_numpy(codes),
        compute_dtype=torch.float32)
    got = tfn.cond_only(torch.from_numpy(x), step)
    assert got.shape == x.shape
    assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert not torch.allclose(got, tfn(torch.from_numpy(x), step))
