"""PyTorch port: LANDIFF_REMAT_SAVE_ATTN=1, the layer checkpoint that keeps
the flash forward's out / lse (JAX dit.py:469, the tensors tagged
flash_out / flash_lse). The tiny stage-2 loss and control gradients with
the knob are those without it, bit for bit on the CPU, from half the
exact flash forwards of the differentiated layers; and they match JAX's
with the knob on, at the tolerances of test_torch_port_train_dit.py (f32:
loss 1e-5 relative; gradients 1e-4 of the leaf's largest entry + 1e-5
relative + 1e-9)."""

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
from landiff_tpu_torch import bridge
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.ops import attention as TA
from landiff_tpu_torch.training import diffusion_loss as tdl
from landiff_tpu_torch.training import optim as toptim
from landiff_tpu_torch.utils import tree_leaves, tree_map

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
T = torch.from_numpy


def _batch():
    d, t = JC.dit, JC.tokenizer.titok
    n_sem = t.iframe_latent_tokens + (t.temporal_size - 1) * \
        t.pframe_latent_tokens
    lat = randn(700, 2, d.latent_frames, d.in_channels, d.latent_height,
                d.latent_width)
    ctx = randn(701, 2, d.text_length, d.text_dim)
    tokens = np.random.default_rng(702).integers(
        0, JC.tokenizer.vq.codebook_size, (2, n_sem), dtype=np.int32)
    return lat, ctx, tokens


@pytest.fixture
def flash_route(monkeypatch):
    """Both packages' control_warp_forward through the flash route, and a
    count of the port's exact flash forwards (on the CPU the plain
    version, which is what a launch on the card would be)."""
    for mod in (jdl.dit_lib, tdl.dit_lib):
        monkeypatch.setattr(mod, "control_warp_forward", functools.partial(
            mod.control_warp_forward, attn_impl="pallas"))
    calls = {"exact": 0}
    exact = TA.flash_fwd_exact

    def counted(*a, **kw):
        calls["exact"] += 1
        return exact(*a, **kw)

    monkeypatch.setattr(TA, "flash_fwd_exact", counted)
    # layers without grad take the int8 route, as at the full-width shapes,
    # so that the exact forwards counted are the differentiated layers'
    monkeypatch.setattr(TA, "_takes_int8", lambda *a: bool(a[-1]))
    return calls


def _port_step(tp, key):
    lat, ctx, tokens = _batch()
    draws = dit_loss_draws(key, lat.shape, JC.sampler.num_train_timesteps)
    ctrl = toptim.require_grad(tp["control"])
    loss = tdl.video_diffusion_loss(
        tp["main"], ctrl, tp["semantic"], T(lat), T(ctx), T(tokens), draws,
        TC.dit, TC.sampler, TC.tokenizer, TC.semantic_cond,
        compute_dtype=torch.float32, remat=True)
    return loss.detach(), toptim.grad(loss, ctrl)


def test_knob_keeps_the_gradients_and_halves_the_exact_forwards(
        flash_route, monkeypatch):
    _, tp = train_dit_params()
    key = jax.random.PRNGKey(9)
    n_grad = TC.dit.control_layers + TC.dit.num_layers - 1
    loss, grads = _port_step(tp, key)
    assert flash_route["exact"] == 2 * n_grad
    monkeypatch.setenv("LANDIFF_REMAT_SAVE_ATTN", "1")
    flash_route["exact"] = 0
    loss_k, grads_k = _port_step(tp, key)
    assert flash_route["exact"] == n_grad
    assert torch.equal(loss, loss_k)
    pairs = list(zip(tree_leaves(grads), tree_leaves(grads_k)))
    assert pairs and all(torch.equal(a, b) for a, b in pairs)


def test_knob_on_matches_jax_with_the_knob_on(flash_route, monkeypatch):
    monkeypatch.setenv("LANDIFF_REMAT_SAVE_ATTN", "1")
    jp, tp = train_dit_params()
    lat, ctx, tokens = _batch()
    key = jax.random.PRNGKey(9)

    def jloss(control, main, sem, lat, ctx, tokens, key):
        return jdl.video_diffusion_loss(
            main, control, sem, lat, ctx, tokens, key, JC.dit, JC.sampler,
            JC.tokenizer, JC.semantic_cond, compute_dtype=jnp.float32,
            remat=True)

    jargs = (jp["control"], jp["main"], jp["semantic"], jnp.asarray(lat),
             jnp.asarray(ctx), jnp.asarray(tokens), key)
    want_loss, want = fast_jit(jax.value_and_grad(jloss), *jargs)(*jargs)
    loss, grads = _port_step(tp, key)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    want = bridge.to_torch(jax.tree_util.tree_map(np.asarray, want),
                           device="cpu")
    pairs = []
    tree_map(lambda g, w: pairs.append((g, w.numpy())), grads, want)
    assert pairs
    for g, w in pairs:
        assert_close(g, w, atol=1e-4 * float(np.abs(w).max()) + 1e-9,
                     rtol=1e-5)
