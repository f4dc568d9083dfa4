"""PyTorch port: the tokenizer's encode side (Theia, the TiTok encoder, the
quantizers, VideoVQ encode, the semantic conditioner's visual path) held
against the JAX package at the tiny config in f32. Parameters are the
port's init with its zero leaves filled, handed to JAX in the JAX layouts
(_torch_port_helpers.to_jax_layout) and to the port through the bridge;
inputs come from numpy seeds. The JAX Theia reads its position table on
the host, so the JAX functions close over their parameters.

Tolerances: 1e-4 relative + 1e-4 absolute for f32 work that sums in
another order (the semantic tests' bar); the host-side position
interpolation bit for bit; code indices exactly (the nearest-code margins
at these seeds are far above the f32 differences); the FSQ codes and
indices exactly (elementwise f32 arithmetic in the same order)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (assert_close, fast_jit, randn,
                                 to_jax_layout)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu import config as jcfg
from landiff_tpu.models import semantic_cond as jsc
from landiff_tpu.models import theia as jtheia
from landiff_tpu.models import titok as jtitok
from landiff_tpu.models import vq as jvq
from landiff_tpu_torch import bridge
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import semantic_cond as tsc
from landiff_tpu_torch.models import theia as ttheia
from landiff_tpu_torch.models import titok as ttitok
from landiff_tpu_torch.models import vq as tvq
from landiff_tpu_torch.utils import fill_zero_leaves

torch.set_num_threads(2)   # tier-1 runs six xdist workers

JC, TC = jcfg.tiny_test_config(), tcfg.tiny_test_config()
JT, TT = JC.tokenizer, TC.tokenizer
T = torch.from_numpy
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(tparams):
    """(JAX tree, port tree) of the same filled parameters."""
    arrays = to_jax_layout(tparams)
    return (jax.tree_util.tree_map(jnp.asarray, arrays),
            bridge.to_torch(arrays, device="cpu"))


@functools.lru_cache(maxsize=1)
def vq_params():
    """VideoVQ with Theia, seed 11, zero leaves filled."""
    gen = torch.Generator().manual_seed(11)
    return _pair(fill_zero_leaves(tvq.init(gen, TT, with_theia=True), gen))


def _frames(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,),
                                                dtype=np.uint8)


def test_interpolate_pos_embed_bit_for_bit():
    pos = randn(21, 1 + 14 * 14, 8)
    for dst, dino in (((30, 45), False), ((45, 45), True), ((4, 6), False)):
        want = jtheia.interpolate_pos_embed(pos, *dst, dino_scale=dino)
        got = ttheia.interpolate_pos_embed(pos, *dst, dino_scale=dino)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["plain", "registers", "no_cls"])
def test_theia_forward_features_matches_jax(variant):
    """The CLS backbone, DeiTReg (2 register tokens) and DeiTNoCLS, on a
    grid other than the train grid (interpolated positions)."""
    extra = {"plain": {}, "registers": {"num_register_tokens": 2},
             "no_cls": {"no_cls": True}}[variant]
    jc = dataclasses.replace(JT.theia, **extra)
    tc = dataclasses.replace(TT.theia, **extra)
    gen = torch.Generator().manual_seed(12)
    jp, tp = _pair(fill_zero_leaves(ttheia.init(gen, tc), gen))
    assert ("reg_token" in tp) == (variant == "registers")
    imgs = _frames(13, 2, 48, 80)
    want = fast_jit(lambda x: jtheia.forward_features(
        jp, x, jc, compute_dtype=jnp.float32), imgs)(imgs)
    got = ttheia.forward_features(tp, T(imgs), tc,
                                  compute_dtype=torch.float32)
    assert got.shape == want.shape == (2, 3, 5, tc.hidden_size)
    assert_close(got, want, **TOL)


def test_titok_encode_matches_jax():
    jp, tp = (p["encoder"] for p in vq_params())
    t = TT.titok
    feats = randn(14, 1, t.temporal_size, t.grid_h, t.grid_w, TT.feature_dim)
    want = fast_jit(lambda p, f: jtitok.encode(
        p, f, JT.titok, compute_dtype=jnp.float32), jp, feats)(jp, feats)
    got = ttitok.encode(tp, T(feats), t, compute_dtype=torch.float32)
    assert got.shape == want.shape == (1, t.latent_tokens, t.token_size)
    assert_close(got, want, **TOL)


def test_quantizers_match_jax():
    jp, tp = (p["quant"] for p in vq_params())
    z = randn(15, 2, 10, TT.vq.dim)
    (jq, jidx), (jl, jcidx) = fast_jit(
        lambda p, x: (jvq.quantize(p, x), jvq.commit_loss(p, x)), jp, z)(jp, z)
    tq, tidx = tvq.quantize(tp, T(z))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert_close(tq, jq, **TOL)
    tl, tcidx = tvq.commit_loss(tp, T(z))
    np.testing.assert_array_equal(tcidx.numpy(), np.asarray(jcidx))
    assert_close(tl, jl, atol=1e-6, rtol=1e-5)
    for levels in ((8, 5, 5, 5), (7, 5, 3)):
        zf = randn(16, 3, 7, len(levels), scale=2.0)

        def fsq(x, levels=levels):
            codes, idx = jvq.fsq_quantize(x, levels)
            return codes, idx, jvq.fsq_indices_to_codes(idx, levels)

        jcodes, jfidx, jback = fast_jit(fsq, zf)(zf)
        tcodes, tfidx = tvq.fsq_quantize(T(zf), levels)
        np.testing.assert_array_equal(tfidx.numpy(), np.asarray(jfidx))
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        back = tvq.fsq_indices_to_codes(tfidx, levels)
        np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
        np.testing.assert_array_equal(back.numpy(), tcodes.numpy())


def test_encode_to_index_and_encode_codes_match_jax():
    """Frames -> Theia -> TiTok encode -> VQ; encode_codes over two
    segments; the mean / std normalisation when asked for."""
    jp, tp = vq_params()
    t = TT.titok
    video = _frames(17, 1, 2 * TT.segment_length, 4 * 16, 6 * 16)
    one = video[:, :TT.segment_length]
    jq, jidx = fast_jit(lambda v: jvq.encode_to_index(
        jp, v, JT, compute_dtype=jnp.float32), one)(one)
    tq, tidx = tvq.encode_to_index(tp, T(one), TT,
                                   compute_dtype=torch.float32)
    assert tidx.shape == (1, t.latent_tokens)
    assert len(np.unique(np.asarray(jidx))) > 1
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert_close(tq, jq, **TOL)
    want = fast_jit(lambda v: jvq.encode_codes(
        jp, v, JT, compute_dtype=jnp.float32), video)(video)
    got = tvq.encode_codes(tp, T(video), TT, compute_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (1, 2 * t.latent_tokens)
    feats = randn(18, 1, t.temporal_size, t.grid_h, t.grid_w, TT.feature_dim)
    jn = jvq.norm_features(jp, jnp.asarray(feats), use_mean_std=True)
    tn = tvq.norm_features(tp, T(feats), use_mean_std=True)
    assert_close(tn, jn, atol=1e-6, rtol=1e-6)
    assert_close(tvq.denorm_features(tp, tn, use_mean_std=True), feats,
                 atol=1e-5, rtol=1e-5)


def test_semantic_feature_from_video_matches_jax():
    """A 64 x 96 clip pads to 96 x 96 (Theia sees 6 x 6 patches, extract
    crops to 4 x 6), VQ round trip, crop, upsampler, conv_out."""
    jv, tv = vq_params()
    gen = torch.Generator().manual_seed(19)
    sem = fill_zero_leaves(tsc.init(gen, TT, TC.semantic_cond), gen)
    arrays = to_jax_layout(sem)
    jp = jax.tree_util.tree_map(jnp.asarray, arrays)
    tp = bridge.to_torch(arrays, device="cpu")
    assert "theia" not in tp["vq"]
    video = randn(20, 1, TT.segment_length, 3, 64, 96) * 0.9
    want = fast_jit(lambda v: jsc.semantic_feature_from_video(
        jp, v, JT, JC.semantic_cond, compute_dtype=jnp.float32,
        theia_params=jv["theia"]), video)(video)
    got = tsc.semantic_feature_from_video(
        tp, T(video), TT, TC.semantic_cond, compute_dtype=torch.float32,
        theia_params=tv["theia"])
    assert got.shape == want.shape == (1, TT.segment_length,
                                       TC.semantic_cond.out_channels, 8, 12)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    assert_close(got, want, **TOL)
    sq = tsc.pad_to_square(T(_frames(21, 2, 8, 5)), 127)
    np.testing.assert_array_equal(sq.numpy(), np.asarray(
        jsc.pad_to_square(jnp.asarray(_frames(21, 2, 8, 5)), 127)))
