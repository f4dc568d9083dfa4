"""PyTorch port: Rotary3D in the DiT (pos_embed="rotary3d", JAX
models/dit.py:101-162, :454-461, :818-827) held against the JAX package
at the tiny config, params from _torch_port_helpers.stage2_params (zero
leaves filled: a fresh DiT's output does not depend on attention).

Tolerances: the tables, the rotation (f32 and bf16) and shard offsets to
the bit (the same elementwise operations, each rounded alike); the DiT
forward as in test_torch_port_dit.py, 1e-4 relative + absolute in f32
and 8e-3 in bf16; the loss 1e-5 relative and the control gradients as in
test_torch_port_train_dit.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (assert_close, dit_loss_draws, fast_jit,
                                 randn, stage2_params, train_dit_params)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.models import dit as jdit
from landiff_tpu.training import diffusion_loss as jdl
from landiff_tpu_torch import bridge
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import dit as tdit
from landiff_tpu_torch.training import diffusion_loss as tdl
from landiff_tpu_torch.training import optim as toptim
from landiff_tpu_torch.utils import tree_map

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy


def _rot(cfg, **kw):
    return dataclasses.replace(cfg, pos_embed="rotary3d", **kw)


def _seq_len(d):
    return d.text_length + d.video_tokens


def _inputs(batch=2):
    d = JC.dit
    x = randn(0, batch, d.latent_frames, d.in_channels, d.latent_height,
              d.latent_width)
    sem = randn(1, *x.shape)
    ctx = randn(2, batch, d.text_length, d.text_dim)
    ts = np.array([999.0, 421.0][:batch], np.float32)
    return x, sem, ctx, ts


def test_tables_equal_jax_to_the_bit():
    for kw in ({}, {"rope_theta": 50.0}):
        got = tdit.rotary3d_tables(_rot(TC.dit, **kw))
        want = jdit.rotary3d_tables(_rot(JC.dit, **kw))
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rot_v", [False, True])
def test_rotation_equals_jax_to_the_bit(rot_v):
    """q and k rotated on the video positions only; v with rot_v alone;
    in f32 and (each product and sum rounded alike) in bf16."""
    jc, tc = _rot(JC.dit, rot_v=rot_v), _rot(TC.dit, rot_v=rot_v)
    shape = (2, _seq_len(tc), tc.num_heads, tc.head_dim)
    q, k, v = (randn(10 + i, *shape) for i in range(3))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jdit._maybe_rotary(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                  jc, jc.text_length)
        got = tdit._maybe_rotary(*(T(a).to(tdt) for a in (q, k, v)), tc)
        for g, w in zip(got, want):
            assert g.dtype == tdt
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w.astype(jnp.float32)))
    got = tdit._maybe_rotary(T(q), T(k), T(v), tc)
    tl = tc.text_length
    np.testing.assert_array_equal(got[0][:, :tl].numpy(), q[:, :tl])
    assert not np.array_equal(got[0][:, tl:].numpy(), q[:, tl:])
    if rot_v:
        assert not np.array_equal(got[2][:, tl:].numpy(), v[:, tl:])
        # a rotation keeps each pair's norm
        np.testing.assert_allclose(got[2].norm(dim=-1).numpy(),
                                   np.linalg.norm(v, axis=-1), rtol=1e-5)
    else:
        np.testing.assert_array_equal(got[2].numpy(), v)


def test_shard_offsets_rotate_as_the_whole():
    """Slices rotated with their offsets (boundaries inside the text and
    mid-video) equal the whole sequence rotated, to the bit."""
    tc = _rot(TC.dit)
    S = _seq_len(tc)
    q = T(randn(20, 1, S, tc.num_heads, tc.head_dim))
    full = tdit._maybe_rotary(q, q, q, tc)[0]
    cuts = [0, tc.text_length // 2, tc.text_length + 5, S // 2 + 3, S]
    parts = [tdit._maybe_rotary(q[:, a:b], q[:, a:b], q[:, a:b], tc,
                                offset=a)[0]
             for a, b in zip(cuts, cuts[1:])]
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(),
                                  full.numpy())


def _jax_call(cfg, jdt):
    def fn(main, control, x, ts, ctx, sem):
        return jdit.control_warp_forward(main, control, x, ts, ctx, cfg, sem,
                                         compute_dtype=jdt)
    return fn


@functools.lru_cache(maxsize=8)
def _jax_forward(dtype, **kw):
    jparams, _ = stage2_params()
    x, sem, ctx, ts = _inputs()
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    fn = _jax_call(_rot(JC.dit, **kw), jdt)
    args = (jparams["main"], jparams["control"], jnp.asarray(x),
            jnp.asarray(ts), jnp.asarray(ctx), jnp.asarray(sem))
    out = fast_jit(fn, *args)(*args)
    return np.asarray(out.astype(jnp.float32))


def _port_forward(dit_cfg, dtype, params=None):
    _, tparams = stage2_params()
    params = params or tparams
    x, sem, ctx, ts = _inputs()
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    return tdit.control_warp_forward(
        params["main"], params["control"], T(x), T(ts), T(ctx), dit_cfg,
        T(sem), compute_dtype=tdt)


@pytest.mark.parametrize("dtype,kw", [
    ("f32", ()), ("f32", (("rot_v", True),)), ("f32", (("rope_theta", 50.0),)),
    ("bf16", ())])
def test_control_warp_forward_matches_jax(dtype, kw):
    """The forward under rotary3d against JAX's; it differs from the
    sincos forward of the same inputs, which it equalled before Rotary3D
    was ported (the table was added and q / k never rotated)."""
    kw = dict(kw)
    tol = {"f32": 1e-4, "bf16": 8e-3}[dtype]
    want = _jax_forward(dtype, **kw)
    got = _port_forward(_rot(TC.dit, **kw), dtype)
    assert got.shape == want.shape
    assert float(np.abs(want).max()) > 1e-2   # not vacuous
    assert_close(got, want, atol=tol, rtol=tol)
    sincos = _port_forward(TC.dit, dtype).float()
    assert float((got.float() - sincos).abs().max()) > 20 * tol


def test_w8a8_forward_takes_the_rotation():
    """The W8A8 route (LANDIFF_FAST=2's DiT) under rotary3d against JAX's
    quantized forward; 1e-4 as the f32 forward (the int8 products are
    exact sums on both sides)."""
    jparams, tparams = stage2_params()
    x, sem, ctx, ts = _inputs()
    jq = {k: jdit.quantize_int8(jparams[k]) for k in ("main", "control")}
    fn = _jax_call(_rot(JC.dit), jnp.float32)
    args = (jq["main"], jq["control"], jnp.asarray(x), jnp.asarray(ts),
            jnp.asarray(ctx), jnp.asarray(sem))
    want = np.asarray(fast_jit(fn, *args)(*args))
    tq = {k: tdit.quantize_int8(tparams[k]) for k in ("main", "control")}
    got = _port_forward(_rot(TC.dit), "f32", tq)
    assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_pos_embedding_is_a_dead_leaf():
    """rotary3d + learnable_pos_embed makes the reference's zeros (1, S, D)
    parameter, of JAX's shape, which no forward reads: set to 7, the
    output is the same to the bit; it crosses the bridge unchanged."""
    tc = _rot(TC.dit, learnable_pos_embed=True)
    jc = _rot(JC.dit, learnable_pos_embed=True)
    shape = jax.eval_shape(lambda k: jdit.init(k, jc),
                           jax.random.PRNGKey(0))["pos_embedding"].shape
    gen = torch.Generator().manual_seed(0)
    for control in (False, True):
        p = tdit.init(gen, tc, control=control)
        assert tuple(p["pos_embedding"].shape) == shape == (
            1, _seq_len(tc), tc.hidden_size)
    assert "pos_embedding" not in tdit.init(gen, _rot(TC.dit))
    _, tparams = stage2_params()
    main = dict(tparams["main"], pos_embedding=torch.zeros(shape))
    crossed = bridge.to_torch({"p": np.full(shape, 7.0, np.float32)},
                              device="cpu")["p"]
    assert tuple(crossed.shape) == shape
    x, _, ctx, ts = _inputs()
    a = tdit.forward(main, T(x), T(ts), T(ctx), tc,
                     compute_dtype=torch.float32)
    b = tdit.forward(dict(main, pos_embedding=crossed), T(x), T(ts), T(ctx),
                     tc, compute_dtype=torch.float32)
    assert torch.equal(a, b)


def test_train_loss_and_grads_match_jax_under_rotary3d():
    """One stage-2 loss and its control gradients (the `train --model
    dit` step) under rotary3d against JAX's, as
    test_torch_port_train_dit.test_loss_and_control_grads_match_jax;
    remat and LANDIFF_REMAT_SAVE_ATTN give the same loss and gradients
    on the port's side."""
    jp, tp = train_dit_params()
    d = JC.dit
    lat = randn(100, 2, d.latent_frames, d.in_channels, d.latent_height,
                d.latent_width)
    ctx = randn(200, 2, d.text_length, d.text_dim)
    t = JC.tokenizer.titok
    n_sem = t.iframe_latent_tokens + (t.temporal_size - 1) * \
        t.pframe_latent_tokens
    tokens = np.random.default_rng(300).integers(
        0, JC.tokenizer.vq.codebook_size, (2, n_sem), dtype=np.int32)
    key = jax.random.PRNGKey(5)

    def jloss(control, main, sem, lat, ctx, tokens, key):
        return jdl.video_diffusion_loss(
            main, control, sem, lat, ctx, tokens, key, _rot(JC.dit),
            JC.sampler, JC.tokenizer, JC.semantic_cond,
            compute_dtype=jnp.float32)

    jargs = (jp["control"], jp["main"], jp["semantic"], jnp.asarray(lat),
             jnp.asarray(ctx), jnp.asarray(tokens), key)
    want_loss, want = fast_jit(jax.value_and_grad(jloss), *jargs)(*jargs)
    want = bridge.to_torch(jax.tree_util.tree_map(np.asarray, want),
                           device="cpu")
    draws = dit_loss_draws(key, lat.shape, JC.sampler.num_train_timesteps)

    def port(remat):
        ctrl = toptim.require_grad(tp["control"])
        loss = tdl.video_diffusion_loss(
            tp["main"], ctrl, tp["semantic"], T(lat), T(ctx), T(tokens),
            draws, _rot(TC.dit), TC.sampler, TC.tokenizer, TC.semantic_cond,
            compute_dtype=torch.float32, remat=remat)
        return float(loss.detach()), toptim.grad(loss, ctrl)

    loss, got = port(False)
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    pairs = []
    tree_map(lambda g, w: pairs.append((g, w.numpy())), got, want)
    for g, w in pairs:
        assert_close(g, w, atol=1e-4 * float(np.abs(w).max()) + 1e-9,
                     rtol=1e-5)
    assert sum(bool(np.abs(w).max() > 0) for _, w in pairs) == len(pairs) - 2
    with pytest.MonkeyPatch.context() as mp:
        for save in ("0", "1"):
            mp.setenv("LANDIFF_REMAT_SAVE_ATTN", save)
            loss_r, got_r = port(True)
            assert loss_r == loss
            tree_map(lambda a, b: torch.testing.assert_close(
                a, b, rtol=0, atol=0), got_r, got)
