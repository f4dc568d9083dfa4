"""PyTorch port: the off-path modules held against the JAX package,
mirroring tests/test_lfq.py, test_token_sequence.py,
test_theia_translate.py and test_aux.py:13-37 (packing): models/lfq.py,
models/token_sequence.py (the port's own copy), models/theia_translate.py
and ops/packing.py. Parameters: the port's own init, zero leaves filled,
handed to JAX in its layouts (conv kernels HWIO), its shapes held to the
JAX init's by jax.eval_shape; the transposed conv's kernel goes the
other way, through the bridge (HWIO -> OIHW).

Tolerances: integer results (indices, tokens, masks) exact; LFQ in f32
1e-5 relative (entropies 1e-5 relative + 1e-7 absolute: softmax sums in
another order); the primitives (conv, transposed conv, LayerNorm) and
the MLP head 1e-4 relative + absolute (sums in another order, as the
DiT's); the light-conv heads and translators 1e-3 against JAX and 1e-5
against the port's own float64 run: at the 16 -> 64 head JAX's f32
result errs by up to 6.2e-4 from float64 (outputs of RMS 2.2), the
port's by 4.7e-6; attention under the packed mask 1e-5 (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import assert_close
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu.models import lfq as jlfq
from landiff_tpu.models import theia_translate as jtt
from landiff_tpu.models import token_sequence as jts
from landiff_tpu.ops import attention as jattn
from landiff_tpu.ops import packing as jpack
from landiff_tpu_torch import bridge
from landiff_tpu_torch.models import lfq as tlfq
from landiff_tpu_torch.models import theia_translate as ttt
from landiff_tpu_torch.models import token_sequence as tts
from landiff_tpu_torch.ops import attention as tattn
from landiff_tpu_torch.ops import packing as tpack
from landiff_tpu_torch.utils import fill_zero_leaves, tree_map

torch.set_num_threads(2)   # tier-1 runs six xdist workers

T = torch.from_numpy


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _to_jax(ttree):
    """The port's tree (its own init: a JAX init costs seconds of eager
    compiles) -> the JAX package's: conv kernels OIHW -> HWIO, Python
    values unchanged."""
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return t
        a = t.numpy()
        return jnp.asarray(np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4
                           else a)

    return tree_map(leaf, ttree)


def _shapes(tree):
    """The shapes of a tree's arrays, its Python values dropped."""
    return jax.tree_util.tree_map(
        lambda a: tuple(a.shape) if isinstance(
            a, (jax.Array, jax.ShapeDtypeStruct)) else None, tree)


def _jax_init_shapes(init):
    """The shapes of a JAX init's arrays, without running it."""
    return _shapes(jax.eval_shape(
        lambda k: jax.tree_util.tree_map(
            lambda a: a if isinstance(a, jax.Array) else None, init(k)),
        jax.random.PRNGKey(0)))


def _assert_trees_equal(a, b):
    """Same structure, equal tensors and equal Python values."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.shape == b.shape and torch.equal(a, b)
    else:
        assert a == b


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# LFQ


def test_lfq_codebook_and_bit_mask_equal_jax():
    for cfg in (tlfq.LFQConfig(codebook_size=16),
                tlfq.LFQConfig(codebook_size=256, codebook_scale=0.5)):
        jc = jlfq.LFQConfig(codebook_size=cfg.codebook_size,
                            codebook_scale=cfg.codebook_scale)
        np.testing.assert_array_equal(tlfq.bit_mask(cfg), jlfq.bit_mask(jc))
        np.testing.assert_array_equal(tlfq.codebook(cfg), jlfq.codebook(jc))
    cb = tlfq.codebook(tlfq.LFQConfig(codebook_size=16))
    np.testing.assert_array_equal(cb[8], [1, -1, -1, -1])   # big-endian


@pytest.mark.parametrize("kw", [dict(codebook_size=256, dim=12),
                                dict(codebook_size=16, num_codebooks=2)])
def test_lfq_inference_matches_jax(kw):
    jc, tc = jlfq.LFQConfig(**kw), tlfq.LFQConfig(**kw)
    tp = fill_zero_leaves(tlfq.init(_gen(), tc), _gen(1), scale=0.3)
    jp = _to_jax(tp)
    shapes = jax.eval_shape(lambda k: jlfq.init(k, jc), jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in shapes.items()} == \
        {k: v.shape for k, v in jp.items()}
    x = _rand(0, 2, 5, tc.effective_dim)
    jout, jidx, jaux, _ = jlfq.quantize(jp, jc, jnp.asarray(x))
    out, idx, aux, _ = tlfq.quantize(tp, tc, T(x))
    assert idx.dtype == torch.int32 and float(aux) == 0.0
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert_close(out, jout, atol=1e-6, rtol=1e-5)
    codes = tlfq.indices_to_codes(tp, tc, idx)
    assert_close(codes, out, atol=1e-6, rtol=1e-5)
    assert_close(codes, jlfq.indices_to_codes(jp, jc, jidx), atol=1e-6,
                 rtol=1e-5)


@pytest.mark.parametrize("case", ["plain", "mask", "frac"])
def test_lfq_training_losses_match_jax(case):
    """The entropy and commit losses; with a sample mask; with
    frac_per_sample_entropy, JAX's permutation passed to the port."""
    kw = dict(codebook_size=16)
    if case == "frac":
        kw["frac_per_sample_entropy"] = 0.5
    jc, tc = jlfq.LFQConfig(**kw), tlfq.LFQConfig(**kw)
    x = _rand(1, 2, 6, 4)
    mask = (np.arange(12).reshape(2, 6) % 3 != 0) if case == "mask" else None
    key = jax.random.PRNGKey(4)
    jout, jidx, jaux, jbd = jlfq.quantize(
        {}, jc, jnp.asarray(x), training=True, key=key, sample_mask=mask)
    perm = (T(np.array(jax.random.permutation(key, 12)))
            if case == "frac" else None)
    out, idx, aux, bd = tlfq.quantize({}, tc, T(x), training=True, perm=perm,
                                      sample_mask=mask)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    for k in ("per_sample_entropy", "codebook_entropy", "commitment"):
        np.testing.assert_allclose(float(bd[k]), float(jbd[k]), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    if case == "frac":
        drawn = tlfq.quantize({}, tc, T(x), training=True,
                              generator=torch.Generator().manual_seed(0))
        assert np.isfinite(float(drawn[2]))
        with pytest.raises(ValueError):
            tlfq.quantize({}, tc, T(x), training=True)


def test_lfq_straight_through_gradient():
    cfg = tlfq.LFQConfig(codebook_size=16, entropy_loss_weight=0.0,
                         commitment_loss_weight=0.0)
    x = T(_rand(2, 1, 3, 4)).requires_grad_()
    out, _, _, _ = tlfq.quantize({}, cfg, x, training=True)
    (out ** 2).sum().backward()
    q = torch.where(x.detach() > 0, 1.0, -1.0)
    assert torch.equal(x.grad, 2 * q)   # d(out)/dx = 1


# ---------------------------------------------------------------------------
# token sequence


def test_vocab_ranges_and_specials():
    v = tts.Vocab()
    v.add_range("visual", 2048)
    for sp in ("EOS", "BOS", "START_OF_IFrame", "END_OF_IFrame",
               "START_OF_PFrame", "END_OF_PFrame", "PAD"):
        v.add_special(sp)
    assert v.size() == 2055 and v.range("visual") == (0, 2048)
    assert v.EOS == 2048 and v.BOS == 2049 and v.PAD == 2054
    with pytest.raises(AttributeError):
        v.MISSING


def _build(mod, feat_fn):
    seq = mod.TokenSequence()
    seq.append_token(np.array([5]), False, name="bos")
    seq.append_feature(feat_fn(np.arange(12, dtype=np.float32).reshape(3, 4)),
                       name="text")
    seq.append_token(np.array([7, 8, 9]), True, name="codes")
    seq.append_token_and_feature(np.array([1, 2]),
                                 feat_fn(np.ones((2, 4), np.float32)),
                                 np.array([True, False]), name="mix")
    return seq


def test_token_sequence_matches_jax():
    tseq, jseq = _build(tts, T), _build(jts, jnp.asarray)
    assert len(tseq) == 9 and tseq.ranges == jseq.ranges == {
        "bos": (0, 1), "text": (1, 4), "codes": (4, 7), "mix": (7, 9)}
    np.testing.assert_array_equal(tseq.get_tokens(), jseq.get_tokens())
    assert tseq.get_tokens()[1] == tts.IGNORE_INDEX == -100
    np.testing.assert_array_equal(tseq.get_loss_mask(),
                                  jseq.get_loss_mask())
    emb = np.zeros((16, 4), np.float32)
    emb[np.arange(16), 0] = np.arange(16)
    feats = tseq.get_features(emb)
    assert isinstance(feats, torch.Tensor) and feats.shape == (9, 4)
    np.testing.assert_array_equal(feats.numpy(),
                                  np.asarray(jseq.get_features(emb)))
    bare = tts.TokenSequence()
    bare.append_token(np.array([1, 2]), False)
    with pytest.raises(AssertionError):
        bare.get_features(None)


def test_collate_matches_jax():
    def build(mod, offset):
        s = mod.TokenSequence()
        s.append_token(np.array([offset]), False)
        s.append_feature(np.full((2, 3), float(offset), np.float32))
        return s

    emb = np.arange(24, dtype=np.float32).reshape(8, 3)
    got = tts.TokenSequence.collate([build(tts, 1), build(tts, 2)], emb)
    want = jts.TokenSequence.collate([build(jts, 1), build(jts, 2)], emb)
    assert got[1].shape == (2, 3, 3) and not got[2].any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    bad = tts.TokenSequence()
    bad.append_token(np.array([1]), False)
    with pytest.raises(AssertionError):
        tts.TokenSequence.collate([build(tts, 1), bad])


# ---------------------------------------------------------------------------
# Theia translator heads


def _nchw(a):
    return T(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


@pytest.mark.parametrize("stride,padding,outpad", [
    (1, 0, 0), (2, 1, 0), (2, 0, 1), (2, 1, 1), (1, 0, 2)])
def test_conv_transpose2d_matches_jax(stride, padding, outpad):
    """The bridged OIHW kernel, first two axes swapped, not flipped;
    stride 2 with output_padding 1, and output_padding 2 at stride 1 (the
    pad-to-16 head of a 12-row grid), which nn.ConvTranspose2d refuses
    and JAX's lhs-dilated conv computes."""
    x = _rand(0, 2, 14, 14, 3)
    w = _rand(1, 3, 3, 3, 5, scale=0.2)
    b = _rand(2, 5)
    want = jtt.conv_transpose2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                jnp.asarray(x), stride=stride,
                                padding=padding, output_padding=outpad)
    p = bridge.to_torch({"w": w, "b": b}, device="cpu")
    got = ttt.conv_transpose2d(p, _nchw(x), stride=stride, padding=padding,
                               output_padding=outpad)
    assert_close(got.permute(0, 2, 3, 1), want, atol=1e-4, rtol=1e-4)


def test_conv2d_and_layer_norm_chw_match_jax():
    x = _rand(3, 2, 6, 6, 5)
    conv = {"w": _rand(4, 4, 4, 5, 7, scale=0.2), "b": _rand(5, 7)}
    want = jtt.conv2d(jax.tree_util.tree_map(jnp.asarray, conv),
                      jnp.asarray(x), stride=2, padding=1)
    got = ttt.conv2d(bridge.to_torch(conv, device="cpu"), _nchw(x),
                     stride=2, padding=1)
    assert_close(got.permute(0, 2, 3, 1), want, atol=1e-4, rtol=1e-4)
    ln = {"g": _rand(6, 6, 6, 5), "b": _rand(7, 6, 6, 5)}
    want = jtt.layer_norm_chw(jax.tree_util.tree_map(jnp.asarray, ln),
                              jnp.asarray(x))
    got = ttt.layer_norm_chw(bridge.to_torch(ln, device="cpu"), _nchw(x))
    assert_close(got.permute(0, 2, 3, 1), want, atol=1e-4, rtol=1e-4)


def _f64(fn, params, x):
    """fn run in float64 on the same parameters and input, back in f32."""
    out = fn(tree_map(lambda t: t.double() if isinstance(t, torch.Tensor)
                      else t, params), x.double())
    return tree_map(lambda t: t.float().numpy(), out)


LIGHT_CASES = [
    ((16, 16, 16), (12, 64, 64)),   # 16 -> 64 (transposed convs)
    ((16, 16, 16), (12, 16, 16)),   # same size
    ((16, 64, 64), (12, 16, 16)),   # 64 -> 16
    ((16, 14, 14), (12, 7, 7)),     # 14 -> 7
    ((16, 14, 14), (12, 64, 64)),   # pad 14 -> 16 -> 64
]


@pytest.mark.parametrize("source,target", LIGHT_CASES)
def test_light_conv_head_matches_jax(source, target):
    """The port's init (LayerNorm affines filled) against JAX's init's
    shapes, its forward against JAX's on the same parameters."""
    th = fill_zero_leaves(ttt.light_conv_head_init(_gen(), source, target),
                          _gen(1), scale=0.3)
    th = tree_map(lambda t: t + 1.0 if isinstance(t, torch.Tensor)
                  and t.dim() == 3 else t, th)      # gains about 1
    jh = _to_jax(th)
    assert _jax_init_shapes(lambda k: jtt.light_conv_head_init(
        k, source, target)) == _shapes(jh)
    # the JAX tree crosses the bridge back to the port's (HWIO -> OIHW,
    # the kind, shapes and conv arguments unchanged)
    back = bridge.to_torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, jh),
        device="cpu")
    _assert_trees_equal(back, th)
    x = _rand(8, 2, 1 + source[1] * source[2], source[0])
    want = jtt.head_forward(jh, jnp.asarray(x))
    got = ttt.head_forward(th, T(x))
    assert got.shape == (2, target[1] * target[2], target[0])
    assert_close(got, want, atol=1e-3, rtol=1e-3)
    assert_close(got, _f64(ttt.head_forward, th, T(x)), atol=1e-5,
                 rtol=1e-5)


def test_mlp_head_matches_jax():
    """Nearest resize 4 -> 8 (F.interpolate's default, floor(i * src /
    dst)) and a 3-layer MLP, hidden 2 * C."""
    th = fill_zero_leaves(ttt.mlp_head_init(_gen(), (8, 4, 4), (6, 8, 8),
                                            num_layer=3), _gen(1))
    x = _rand(9, 2, 17, 8)
    assert_close(ttt.head_forward(th, T(x)),
                 jtt.head_forward(_to_jax(th), jnp.asarray(x)), atol=1e-4,
                 rtol=1e-4)


@pytest.mark.parametrize("kind", ["light_conv", "mlp"])
def test_translators_and_distill_loss_match_jax(kind):
    """Both translators ("_cls" targets take the linear head) and the
    distillation objective on the same parameters; the port's init has
    JAX's tree."""
    backbone = (8, 14, 14)
    targets, kw = {
        "light_conv": ({"clip_cls": (24, 1, 1), "dinov2": (12, 14, 14)}, {}),
        "mlp": ({"sam": (8, 21, 21)}, {"hidden_size": 16, "n_layer": 2}),
    }[kind]
    tp = fill_zero_leaves(ttt.init_translator(_gen(), backbone, targets,
                                              kind=kind, **kw), _gen(1))
    jp = _to_jax(tp)
    assert _jax_init_shapes(lambda k: jtt.init_translator(
        k, backbone, targets, kind=kind, **kw)) == _shapes(jp)
    x = _rand(10, 2, 1 + 14 * 14, 8)
    want = jtt.translate(jp, jnp.asarray(x))
    got = ttt.translate(tp, T(x))
    exact = _f64(ttt.translate, tp, T(x))
    assert set(got) == set(targets)
    for name in targets:
        assert_close(got[name], want[name], atol=1e-3, rtol=1e-3)
        assert_close(got[name], exact[name], atol=1e-5, rtol=1e-5)
    teachers = {k: _rand(11, *v.shape) for k, v in got.items()}
    jtot, _ = jtt.distill_loss(want, {k: jnp.asarray(v)
                                      for k, v in teachers.items()})
    ttot, tper = ttt.distill_loss(got, {k: T(v) for k, v in teachers.items()})
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-4)
    assert set(tper) == set(targets) and float(ttot) >= 0


# ---------------------------------------------------------------------------
# packing


def test_packed_seqlens_equal_jax():
    t, j = tpack.PackedSeqlens((3, 2, 4)), jpack.PackedSeqlens((3, 2, 4))
    np.testing.assert_array_equal(t.cu_seqlens, [0, 3, 5, 9])
    for name in ("segment_ids", "position_ids"):
        np.testing.assert_array_equal(getattr(t, name)(), getattr(j, name)())
    np.testing.assert_array_equal(t.cu_seqlens, j.cu_seqlens)
    assert t.total == j.total == 9


def test_packed_causal_mask_matches_jax():
    fn, jfn = tpack.packed_causal_mask((3, 2)), jpack.packed_causal_mask(
        (3, 2))
    qi, ki = torch.arange(5)[:, None], torch.arange(5)[None, :]
    m = fn(qi, ki)
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(jfn(jnp.arange(5)[:, None],
                                  jnp.arange(5)[None, :])))
    np.testing.assert_array_equal(
        fn(np.arange(5)[:, None], np.arange(5)[None, :]), m.numpy())
    assert m[2, 0] and m[2, 2] and not m[0, 2]       # causal in segment 0
    assert not m[3, 2] and not m[2, 3]                # no cross segment
    q = _rand(12, 1, 5, 1, 4)
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(q),
                               jnp.asarray(q), mask_fn=jfn)
    got = tattn.mha_reference(T(q), T(q), T(q), mask_fn=fn)
    assert_close(got, want, atol=1e-5, rtol=1e-5)
    plain, _ = tattn.flash_exact_plain(T(q), T(q), T(q), mask_fn=fn)
    assert_close(plain, want, atol=1e-5, rtol=1e-5)
