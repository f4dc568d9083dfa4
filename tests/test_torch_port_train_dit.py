"""PyTorch port: the stage-2 trainer (video_diffusion_loss,
make_train_step, stochastic rounding) held against the JAX package at the
tiny config. Both get the same parameters (zero leaves filled), the same
batch and the same draws, regenerated from the JAX key chain
(_torch_port_helpers.dit_loss_draws); each JAX step is compiled once.

Tolerances, f32 compute. Loss: 1e-5 relative. Control gradients: 1e-4 of
the largest entry of the leaf + 1e-5 relative + 1e-9 (sums in another
order through three layers and a backward). Parameters after three updates:
2e-5 absolute: Adam's m / sqrt(v) turns a relative gradient difference
of d into an update difference of about lr * d, lr 1e-3. With the flash
route (JAX's Pallas kernels in interpret mode at their tiles, the port's
plain versions at the CUDA kernels' 64-wide tiles) the same limits hold:
in f32 the two differ only in the order of sums. bf16 masters with
stochastic rounding: the two optimizers round at different places (optax
after every operation in bf16, the port once), so an update may differ
in its last bf16 bit and the same random bits then round the sum to the
other neighbour. Readings over two nonzero updates: 11 % of the elements
differ (limit 15 %), 0.1 % of them by more than two bf16 steps and none
by more than four (limit six), steps taken at the larger of the element
and the learning rate (the size of an Adam update)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (assert_close, dit_loss_draws, fast_jit,
                                 randn, train_dit_params)
from landiff_tpu import config as jcfg
from landiff_tpu.training import diffusion_loss as jdl
from landiff_tpu.training import sr as jsr
from landiff_tpu.training import train as jtrain
from landiff_tpu_torch import bridge
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.training import diffusion_loss as tdl
from landiff_tpu_torch.training import optim as toptim
from landiff_tpu_torch.training import sr as tsr
from landiff_tpu_torch.training import train as ttrain
from landiff_tpu_torch.utils import tree_leaves, tree_map

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy
LR, STEPS, B = 1e-3, 3, 2


def _batch(step):
    d, t = JC.dit, JC.tokenizer.titok
    n_sem = t.iframe_latent_tokens + (t.temporal_size - 1) * \
        t.pframe_latent_tokens
    lat = randn(100 + step, B, d.latent_frames, d.in_channels,
                d.latent_height, d.latent_width)
    ctx = randn(200 + step, B, d.text_length, d.text_dim)
    tokens = np.random.default_rng(300 + step).integers(
        0, JC.tokenizer.vq.codebook_size, (B, n_sem), dtype=np.int32)
    return lat, ctx, tokens


def _jax_args():
    return JC.dit, JC.sampler, JC.tokenizer, JC.semantic_cond


def _port_args():
    return TC.dit, TC.sampler, TC.tokenizer, TC.semantic_cond


class _flash_route:
    """Send both packages' control_warp_forward through the flash route
    (neither loss takes an attn_impl)."""

    def __init__(self, monkeypatch):
        for mod in (jdl.dit_lib, tdl.dit_lib):
            monkeypatch.setattr(mod, "control_warp_forward", functools.partial(
                mod.control_warp_forward, attn_impl="pallas"))


def _run_both(n_steps, *, control_dtype=None, **step_kw):
    """n_steps of both train steps from the same state: per step the two
    losses, and the final control trees."""
    jp, tp = train_dit_params(control_dtype)
    jopt = jtrain.make_optimizer(LR, STEPS)
    topt = ttrain.make_optimizer(LR, STEPS)
    jstep = jdl.make_train_step(jopt, *_jax_args(),
                                compute_dtype=jnp.float32, **step_kw)
    tstep = tdl.make_train_step(
        topt, *_port_args(), compute_dtype=torch.float32,
        **{k: v for k, v in step_kw.items() if k != "ucg_rate"})
    jctrl, jstate = jp["control"], jopt.init(jp["control"])
    tctrl, tstate = tp["control"], topt.init(tp["control"])
    losses = []
    for i in range(n_steps):
        lat, ctx, tokens = _batch(i)
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        jargs = (jctrl, jstate, jp["main"], jp["semantic"], jnp.asarray(lat),
                 jnp.asarray(ctx), jnp.asarray(tokens), key)
        if i == 0:
            jstep = fast_jit(jstep, *jargs)
        jctrl, jstate, jloss = jstep(*jargs)
        draws = dit_loss_draws(
            key, lat.shape, JC.sampler.num_train_timesteps,
            ucg_rate=step_kw.get("ucg_rate", 0.0),
            sr_tree=jp["control"] if step_kw.get("sr_updates") else None)
        tctrl, tstate, tloss = tstep(
            tctrl, tstate, tp["main"], tp["semantic"], T(lat), T(ctx),
            T(tokens), draws)
        losses.append((float(tloss), float(jloss)))
    return losses, tctrl, jctrl, tp["control"]


def _pairs(got, jwant):
    """[(port tensor, JAX array as f32 numpy in the port's layout)] over
    two parameter-shaped trees."""
    want = bridge.to_torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32), jwant), device="cpu")
    pairs = []
    tree_map(lambda t, w: pairs.append((t, w.numpy())), got, want)
    assert pairs
    return pairs


def _assert_trees_close(got, want, *, atol):
    for t, w in _pairs(got, want):
        assert_close(t, w, atol=atol, rtol=0)


def test_loss_and_control_grads_match_jax():
    jp, tp = train_dit_params()
    lat, ctx, tokens = _batch(0)
    key = jax.random.PRNGKey(5)

    def jloss(control, main, sem, lat, ctx, tokens, key):
        return jdl.video_diffusion_loss(
            main, control, sem, lat, ctx, tokens, key, *_jax_args(),
            compute_dtype=jnp.float32)

    jargs = (jp["control"], jp["main"], jp["semantic"], jnp.asarray(lat),
             jnp.asarray(ctx), jnp.asarray(tokens), key)
    want_loss, want = fast_jit(jax.value_and_grad(jloss), *jargs)(*jargs)
    draws = dit_loss_draws(key, lat.shape, JC.sampler.num_train_timesteps)
    ctrl = toptim.require_grad(tp["control"])
    loss = tdl.video_diffusion_loss(
        tp["main"], ctrl, tp["semantic"], T(lat), T(ctx), T(tokens), draws,
        *_port_args(), compute_dtype=torch.float32)
    got = toptim.grad(loss, ctrl)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    pairs = _pairs(got, want)
    reached = 0
    for g, w in pairs:
        # k_ln_b shifts every score of a row alike: its gradient is 0 but
        # for rounding (1e-14), hence the absolute floor
        assert_close(g, w, atol=1e-4 * float(np.abs(w).max()) + 1e-9,
                     rtol=1e-5)
        reached += bool(np.abs(w).max() > 0)
    # every control leaf but the unused final LayerNorm gets a gradient
    assert reached == len(pairs) - 2


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_three_train_steps_match_jax(route, monkeypatch):
    if route == "pallas":
        _flash_route(monkeypatch)
    losses, tctrl, jctrl, start = _run_both(STEPS)
    for got, want in losses:
        assert got == pytest.approx(want, rel=1e-5)
    _assert_trees_close(tctrl, jctrl, atol=2e-5)
    # the schedule starts at 0: only the later updates move anything
    moved = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(tctrl), tree_leaves(start))]
    assert max(moved) > 1e-4


def test_fixed_frames_and_context_dropout_match_jax():
    # batch 2 at rate 0.5 under these keys drops a sample in some step
    losses, tctrl, jctrl, _ = _run_both(STEPS, fixed_frames=1, ucg_rate=0.5)
    for got, want in losses:
        assert got == pytest.approx(want, rel=1e-5)
    _assert_trees_close(tctrl, jctrl, atol=2e-5)
    keeps = [dit_loss_draws(jax.random.fold_in(jax.random.PRNGKey(0), i),
                            (B, 1), 1000, ucg_rate=0.5).keep
             for i in range(STEPS)]
    assert any(not bool(k.all()) for k in keeps)


def test_generator_draws_have_the_loss_draws_layout():
    gen = torch.Generator().manual_seed(3)
    d = tdl.draw_loss_inputs(gen, (4, 3, 4, 8, 12), 1000, ucg_rate=0.5,
                             dp_rank=1, dp_size=2)
    assert d.idx.shape == (4,) and d.noise.shape == (4, 3, 4, 8, 12)
    assert d.keep.dtype == torch.bool and d.sr_bits is gen
    # rank 1 of 2 draws from the upper half of the timesteps
    assert int(d.idx.min()) >= 500 and int(d.idx.max()) < 1000
    assert tdl.draw_loss_inputs(gen, (1, 1), 1000).keep is None


def test_sr_updates_on_bf16_masters_match_jax():
    losses, tctrl, jctrl, start = _run_both(
        STEPS, control_dtype=(jnp.bfloat16, torch.bfloat16), sr_updates=True)
    for got, want in losses:
        assert got == pytest.approx(want, rel=2e-2)      # bf16 weights
    off = total = 0
    for t, w in _pairs(tctrl, jctrl):
        assert t.dtype == torch.bfloat16
        t = t.float().numpy()
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), LR))) - 7)
        assert np.all(np.abs(t - w) <= 6 * step)
        off += int((t != w).sum())
        total += t.size
    assert off <= 0.15 * total, (off, total)
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(tctrl), tree_leaves(start)))


def test_stochastic_rounding_is_bit_exact_from_the_same_bits():
    v = randn(7, 4096)
    v[:4] = [np.inf, -np.inf, np.nan, 0.0]
    key = jax.random.PRNGKey(3)
    want = np.asarray(jsr.stochastic_round_bf16(jnp.asarray(v), key)
                      .astype(jnp.float32))
    bits = np.array(jax.random.bits(key, v.shape, jnp.uint32)
                    & jnp.uint32(0xFFFF)).astype(np.int32)
    got = tsr.stochastic_round_bf16(T(v), T(bits))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # and the tree form, bf16 leaves rounded, f32 leaves plainly added
    params = {"a": jnp.asarray(v[:64], jnp.bfloat16), "b": jnp.asarray(v[64:96])}
    upd = {"a": jnp.asarray(v[100:164] * 1e-3, jnp.bfloat16),
           "b": jnp.asarray(v[200:232] * 1e-3)}
    jout = jsr.apply_updates_sr(params, upd, key)
    tbits = {"a": T(np.array(jax.random.bits(
        jax.random.fold_in(key, 0), (64,), jnp.uint32) & jnp.uint32(0xFFFF))
        .astype(np.int32)), "b": None}
    as_t = lambda tree: {k: T(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)
        for k, x in tree.items()}
    tout = tsr.apply_updates_sr(as_t(params), as_t(upd), tbits)
    for k in params:
        np.testing.assert_array_equal(
            tout[k].float().numpy(),
            np.asarray(jout[k].astype(jnp.float32)))
    drawn = tsr.stochastic_round_bf16(T(v[4:]), torch.Generator().manual_seed(1))
    assert float((drawn.float() - T(v[4:])).abs().max()) <= 2 ** -7 * 4
