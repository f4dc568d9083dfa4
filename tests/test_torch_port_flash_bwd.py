"""PyTorch port: the flash backward. `flash_bwd_plain` (the plain version
of the CUDA kernel, what the CPU route runs) held against the JAX
package's Pallas backward in interpret mode and against its XLA
double-scan oracle, tile for tile (block_q = block_kv = 16), from the
same out / lse; the autograd route against autograd of the dense
reference; the route rule of `attention`.

Tolerances. f32: 2e-5 absolute + 2e-5 relative (sums in another order).
bf16 against the Pallas kernel: both round q', p and scale*ds to bf16 at
the same places, so one bf16 step (2^-8 relative) + 2e-3 absolute for a
p or ds that lands on the other side of a rounding boundary. bf16 against
the XLA oracle, which neither pre-rounds q nor takes the saved lse: 3e-2
of the largest gradient. Rows that see nothing give exactly 0."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (assert_close, check_ablation_variant,
                                 fast_jit, randn, stage2_params)
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu.ops import attention as JA
from landiff_tpu.ops import masks as JM
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.models import dit as tdit
from landiff_tpu_torch.ops import attention as TA
from landiff_tpu_torch.ops import masks as TM
from landiff_tpu_torch.training import optim

torch.set_num_threads(2)   # tier-1 runs six xdist workers

J_LAYOUT = JM.VideoMaskLayout(num_frames=3, tokens_per_frame=8,
                              iframe_tokens=5, pframe_tokens=2)
T_LAYOUT = TM.VideoMaskLayout(num_frames=3, tokens_per_frame=8,
                              iframe_tokens=5, pframe_tokens=2)
_MASKS = {
    "none": (None, None),
    "causal": (JM.causal, TM.causal),
    "decoder": (JM.video_decoder_mask(J_LAYOUT),
                TM.video_decoder_mask(T_LAYOUT)),
    "encoder": (JM.video_encoder_mask(J_LAYOUT),
                TM.video_encoder_mask(T_LAYOUT)),
}
# (mask, Sq, Skv): an uneven kv length is a ragged last tile; decoder rows
# past the layout's seq_len (33) see nothing
_CASES = [("none", 48, 48), ("none", 40, 37), ("causal", 48, 48),
          ("decoder", 33, 33), ("decoder", 41, 41)]
_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
T = torch.from_numpy


def _inputs(seed, Sq, Skv, H=2, D=32):
    return (randn(seed, 1, Sq, H, D, scale=2.0), randn(seed + 1, 1, Skv, H, D),
            randn(seed + 2, 1, Skv, H, D), randn(seed + 3, 1, Sq, H, D))


@functools.lru_cache(maxsize=None)
def _jax_case(name, Sq, Skv, dtype):
    """The JAX side of one case, computed once: inputs, the exact forward
    (interpret mode) and both JAX backwards from its out / lse."""
    jm = _MASKS[name][0]
    jdt = _DTYPES[dtype][0]
    q, k, v, do = (jnp.asarray(a, jdt) for a in _inputs(10, Sq, Skv))
    def run(q, k, v, do):
        out, lse = JA.flash_attention(
            q, k, v, mask_fn=jm, block_q=16, block_kv=16, interpret=True,
            int8_scores=False, exp_bf16=False, int8_pv=False,
            return_lse=True)
        pallas = JA._flash_bwd_pallas(q, k, v, out, lse, do, jm, None,
                                      block_q=16, block_kv=16,
                                      interpret=True)
        xla = JA._flash_diff_bwd_xla(jm, None, (q, k, v, out), do, bq=16,
                                     bkv=16)
        return out, lse, pallas, xla

    out, lse, pallas, xla = fast_jit(run, q, k, v, do)(q, k, v, do)
    f32 = lambda a: np.array(a.astype(jnp.float32))     # writable copies
    return ([f32(a) for a in (q, k, v, do, out)], np.array(lse),
            [f32(a) for a in pallas], [f32(a) for a in xla])


def _port_bwd(name, Sq, Skv, dtype, block_kv=16):
    tm = _MASKS[name][1]
    tdt = _DTYPES[dtype][1]
    (q, k, v, do, out), lse, pallas, xla = _jax_case(name, Sq, Skv, dtype)
    q, k, v, do, out = (T(a).to(tdt) for a in (q, k, v, do, out))
    got = TA.flash_bwd_plain(q, k, v, out, T(lse), do, mask_fn=tm,
                             block_q=16, block_kv=block_kv)
    assert [g.dtype for g in got] == [tdt] * 3
    return got, pallas, xla


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,Sq,Skv", _CASES)
def test_plain_bwd_matches_jax_pallas_interpret(name, Sq, Skv, dtype):
    _check_against_pallas(name, Sq, Skv, dtype, block_kv=16)


# at the CUDA kernel's kv tile (BWD_BLOCK_KV, the plain version's default),
# which changes only the order of the f32 sums
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,Sq,Skv", _CASES)
def test_plain_bwd_at_the_kernel_tile_matches_jax_pallas_interpret(
        name, Sq, Skv, dtype):
    _check_against_pallas(name, Sq, Skv, dtype, block_kv=TA.BWD_BLOCK_KV)


def _check_against_pallas(name, Sq, Skv, dtype, block_kv):
    got, want, _ = _port_bwd(name, Sq, Skv, dtype, block_kv)
    atol, rtol = (2e-5, 2e-5) if dtype == "f32" else (2e-3, 2 ** -8)
    for g, w in zip(got, want):
        assert float(np.abs(w).max()) > 1e-2          # not vacuous
        assert_close(g, w, atol=atol, rtol=rtol)
    if Sq > T_LAYOUT.seq_len and name == "decoder":   # rows that see nothing
        n = T_LAYOUT.seq_len
        assert float(got[0][:, n:].abs().max()) == 0.0
        assert float(np.abs(want[0][:, n:]).max()) == 0.0
        assert float(got[1][:, n:].abs().max()) == 0.0
        assert float(got[2][:, n:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,Sq,Skv", _CASES)
def test_plain_bwd_matches_jax_xla_oracle(name, Sq, Skv, dtype):
    got, _, want = _port_bwd(name, Sq, Skv, dtype)
    for g, w in zip(got, want):
        if dtype == "f32":
            assert_close(g, w, atol=2e-5, rtol=2e-5)
        else:
            assert_close(g, w, atol=3e-2 * float(np.abs(w).max()), rtol=0)


def test_cpu_wrapper_runs_the_plain_version():
    (q, k, v, do, out), lse, _, _ = _jax_case("causal", 48, 48, "f32")
    args = [T(a) for a in (q, k, v, out, lse, do)]
    TA.reset_launch_counts()
    got = TA.flash_bwd(*args, mask_fn=TM.causal)
    want = TA.flash_bwd_plain(*args, mask_fn=TM.causal)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert TA.LAUNCHES["flash_bwd"] == 0


@pytest.mark.parametrize("bq", [None, 8, 64])
def test_plain_bwd_tiles_change_only_the_sum_order(bq):
    (q, k, v, do, out), lse, want, _ = _jax_case("decoder", 41, 41, "f32")
    got = TA.flash_bwd_plain(*(T(a) for a in (q, k, v, out, lse, do)),
                             mask_fn=_MASKS["decoder"][1], block_q=bq,
                             block_kv=64)
    for g, w in zip(got, want):
        assert_close(g, w, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["none", "causal", "decoder", "encoder"])
@pytest.mark.parametrize("kv_major", [False, True])
def test_tile_tables_match_the_jax_construction(name, kv_major):
    """masks.tile_tables against the loops of flash_attention (:537-545)
    and, transposed, of _flash_bwd_call (:713-724)."""
    jm, tm = _MASKS[name]
    S = T_LAYOUT.seq_len + 7
    if name == "none":
        vis = tvis = np.full((5, 5), 2, np.int8)
    else:
        vis = JM.block_visibility(jm, S, S, 8, 8)
        tvis = TM.block_visibility(tm, S, S, 8, 8)
    _check_tile_tables(vis, tvis, kv_major)


# a layout large enough for partial and skipped tiles at the backward
# kernel's 64 x 128 tiles (seq_len 560, S = 600: 10 q x 5 kv tiles)
J_BIG = JM.VideoMaskLayout(num_frames=3, tokens_per_frame=150,
                           iframe_tokens=70, pframe_tokens=20)
T_BIG = TM.VideoMaskLayout(num_frames=3, tokens_per_frame=150,
                           iframe_tokens=70, pframe_tokens=20)
_BIG_MASKS = {"none": (None, None), "causal": (JM.causal, TM.causal),
              "decoder": (JM.video_decoder_mask(J_BIG),
                          TM.video_decoder_mask(T_BIG)),
              "encoder": (JM.video_encoder_mask(J_BIG),
                          TM.video_encoder_mask(T_BIG))}


@pytest.mark.parametrize("name", ["none", "causal", "decoder", "encoder"])
@pytest.mark.parametrize("kv_major", [False, True])
def test_tile_tables_at_the_bwd_tile_match_the_jax_construction(name,
                                                                 kv_major):
    """The same at the backward kernel's BWD_BLOCK_Q x BWD_BLOCK_KV tiles,
    and kv-major, attention.visibility_tables as it builds them for the
    kernel."""
    jm, tm = _BIG_MASKS[name]
    S, bq, bkv = T_BIG.seq_len + 40, TA.BWD_BLOCK_Q, TA.BWD_BLOCK_KV
    if name == "none":
        vis = tvis = np.full((-(-S // bq), -(-S // bkv)), 2, np.int8)
    else:
        vis = JM.block_visibility(jm, S, S, bq, bkv)
        tvis = TM.block_visibility(tm, S, S, bq, bkv)
        assert {0, 1, 2} <= set(np.unique(vis)) or name == "causal"
    tables = _check_tile_tables(vis, tvis, kv_major)
    if kv_major and name != "none":
        built = TA.visibility_tables(tm, S, S, "cpu", kv_major=True)
        for a, b in zip(built, tables):
            np.testing.assert_array_equal(a.numpy(), b)


def _check_tile_tables(vis, tvis, kv_major):
    if kv_major:
        vis, tvis = vis.T, tvis.T
    count, order, kind = TM.tile_tables(tvis)
    for r in range(vis.shape[0]):
        ids = np.nonzero(vis[r])[0]
        assert count[r] == len(ids)
        np.testing.assert_array_equal(order[r, :len(ids)], ids)
        np.testing.assert_array_equal(kind[r, :len(ids)], vis[r, ids])
    assert count.dtype == order.dtype == kind.dtype == np.int32
    return count, order, kind


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Sq", [40, 64, 100])
def test_bwd_prologue_plain_matches_numpy(Sq, dtype):
    """flash_bwd_prep_plain against numpy from a seed: q' = q * scale*log2e
    rounded to the dtype, lse padded with +inf to Sq rounded up to 64,
    delta = rowsum(do * out) in f32 (0 past Sq), a zeroed (B, H, Sq_pad, D)
    dq workspace."""
    B, H, D = 2, 3, 16
    tdt = _DTYPES[dtype][1]
    q, out, do = (T(randn(60 + i, B, Sq, H, D)).to(tdt) for i in range(3))
    lse = T(randn(63, B, H, Sq))
    qs, lse_pad, delta, ws = TA.flash_bwd_prep_plain(q, out, lse, do)
    sq_pad = -(-Sq // 64) * 64
    assert lse_pad.shape == delta.shape == (B, H, sq_pad)
    assert ws.shape == (B, H, sq_pad, D) and not bool(ws.any())
    qscale = np.float32(TA.LOG2E / np.sqrt(D))
    want_qs = torch.from_numpy(q.float().numpy() * qscale).to(tdt)
    assert qs.dtype == tdt and torch.equal(qs, want_qs)
    assert np.array_equal(lse_pad[:, :, :Sq].numpy(), lse.numpy())
    assert bool(torch.isinf(lse_pad[:, :, Sq:]).all())
    assert bool((lse_pad[:, :, Sq:] > 0).all())
    want = np.einsum("bshd,bshd->bhs", do.float().numpy().astype(np.float64),
                     out.float().numpy().astype(np.float64))
    np.testing.assert_allclose(delta[:, :, :Sq].numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert not bool(delta[:, :, Sq:].any())


@pytest.mark.parametrize("Sq", [1, 64, 100])
def test_dq_workspace_cast_is_the_identity(Sq):
    """dq_from_workspace, the cast and permute of the (B, H, Sq_pad, D)
    workspace to BSHD that the CUDA route and the plain route share:
    exactly the first Sq rows, transposed, whatever the padding rows
    hold."""
    B, H, D = 2, 3, 8
    sq_pad = -(-Sq // 64) * 64
    ws = T(randn(70, B, H, sq_pad, D))
    want = np.ascontiguousarray(ws.numpy()[:, :, :Sq].transpose(0, 2, 1, 3))
    got = TA.dq_from_workspace(ws, Sq, torch.float32)
    assert got.is_contiguous() and np.array_equal(got.numpy(), want)
    got16 = TA.dq_from_workspace(ws, Sq, torch.bfloat16)
    assert torch.equal(got16, T(want).bfloat16())


_ABLATIONS = ["exp2f", "no_exp2", "no_reduce", "no_dq_product",
              "no_ds_store", "no_video_mask"]


@pytest.mark.parametrize("variant", _ABLATIONS)
def test_ablation_variants_still_apply_to_the_kernel_source(variant):
    """chip_ablation.py --kernel bwd: each edit of flash_bwd.cu's text
    matches the source exactly once."""
    check_ablation_variant("bwd", variant, _ABLATIONS)


# ---------------------------------------------------------------------------
# the autograd route


def _grads(fn, q, k, v):
    leaves = [T(a).clone().requires_grad_() for a in (q, k, v)]
    fn(*leaves).square().sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("name", ["none", "causal", "decoder"])
def test_flash_route_grads_match_the_dense_reference(name):
    """attention(impl="pallas") under grad: _FlashDiff (exact forward,
    flash backward) against autograd of mha_reference, at the 2e-4 the
    JAX package holds its own to (tests/test_masks_attention.py:183)."""
    tm = _MASKS[name][1]
    q, k, v, _ = _inputs(20, T_LAYOUT.seq_len, T_LAYOUT.seq_len, D=16)
    q = q / 2.0
    got = _grads(lambda *a: TA.attention(*a, mask_fn=tm, impl="pallas"),
                 q, k, v)
    want = _grads(lambda *a: TA.mha_reference(*a, mask_fn=tm), q, k, v)
    for g, w in zip(got, want):
        assert_close(g, w.numpy(), atol=2e-4, rtol=2e-4)
    # and against the JAX package's own differentiable flash route
    jm = _MASKS[name][0]
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    jwant = fast_jit(jax.grad(
        lambda *a: jnp.sum(JA._flash_diff(*a, jm, None) ** 2),
        argnums=(0, 1, 2)), *jargs)(*jargs)
    for g, w in zip(got, jwant):
        assert_close(g, w, atol=2e-4, rtol=2e-4)


def test_flash_route_fully_masked_rows_give_exactly_zero_dq():
    S = T_LAYOUT.seq_len + 5                  # padding rows see nothing
    tm = _MASKS["encoder"][1]
    q, k, v, _ = _inputs(30, S, S, H=1, D=8)
    dq, dk, dv = _grads(lambda *a: TA.attention(*a, mask_fn=tm,
                                                impl="pallas"), q, k, v)
    for g in (dq, dk, dv):
        assert bool(torch.isfinite(g).all())
    assert float(dq[0, T_LAYOUT.seq_len:].abs().max()) == 0.0
    want = _grads(lambda *a: TA.mha_reference(*a, mask_fn=tm), q, k, v)
    for g, w in zip((dq, dk, dv), want):
        assert_close(g, w.numpy(), atol=2e-4, rtol=2e-4)


class _Recorder:
    """Wraps the two forward wrappers and counts their calls."""

    def __init__(self, monkeypatch):
        self.calls = {"exact": 0, "int8": 0}
        for name, fn in (("exact", TA.flash_fwd_exact),
                         ("int8", TA.flash_fwd_int8)):
            monkeypatch.setattr(TA, f"flash_fwd_{name}",
                                functools.partial(self._call, name, fn))

    def _call(self, name, fn, *a, **kw):
        self.calls[name] += 1
        return fn(*a, **kw)


def test_route_rule_exact_under_grad_todays_selection_without(monkeypatch):
    monkeypatch.setenv("LANDIFF_ATTN_INT8", "1")
    rec = _Recorder(monkeypatch)
    # 640 rows: two 512-row q blocks, so the int8 rule holds (K/V resident)
    q, k, v, _ = (T(a) for a in _inputs(40, 640, 640, H=1, D=16))
    out = TA.attention(q.clone().requires_grad_(), k, v, impl="pallas")
    assert out.grad_fn is not None and rec.calls == {"exact": 1, "int8": 0}
    TA.attention(q, k, v.clone().requires_grad_(), impl="pallas")
    assert rec.calls == {"exact": 2, "int8": 0}
    TA.attention(q, k, v, impl="pallas")               # nothing requires grad
    assert rec.calls == {"exact": 2, "int8": 1}
    with torch.no_grad():
        TA.attention(q.clone().requires_grad_(), k, v, impl="pallas")
    assert rec.calls == {"exact": 2, "int8": 2}
    TA.attention(q, k, v, impl="pallas", int8_scores=False)
    assert rec.calls == {"exact": 3, "int8": 2}
    monkeypatch.setenv("LANDIFF_ATTN_INT8", "0")
    TA.attention(q, k, v, impl="pallas")
    assert rec.calls == {"exact": 4, "int8": 2}
    # auto: the dense reference below 2,048 positions; xla: always
    TA.attention(q, k, v)
    TA.attention(q, k, v, impl="xla")
    assert rec.calls == {"exact": 4, "int8": 2}
    with pytest.raises(ValueError):
        TA.attention(q, k, v, impl="pallas",
                     mask=torch.ones(640, 640, dtype=torch.bool))
    with pytest.raises(ValueError):
        TA.attention(q, k, v, impl="flash")


def test_auto_takes_the_flash_route_from_2048_positions(monkeypatch):
    rec = _Recorder(monkeypatch)
    q, k, v, _ = (T(a) for a in _inputs(41, 2048, 130, H=1, D=8))
    out = TA.attention(q.requires_grad_(), k, v)
    assert rec.calls == {"exact": 1, "int8": 0} and out.grad_fn is not None


def test_bwd_knob_selects_the_plain_version(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("flash_bwd called with LANDIFF_ATTN_BWD=xla")

    q, k, v, _ = _inputs(42, 40, 40, D=8)
    want = _grads(lambda *a: TA.attention(*a, impl="pallas"), q, k, v)
    monkeypatch.setenv("LANDIFF_ATTN_BWD", "xla")
    monkeypatch.setattr(TA, "flash_bwd", refuse)
    got = _grads(lambda *a: TA.attention(*a, impl="pallas"), q, k, v)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _dit_loss_and_grads(remat):
    _, tparams = stage2_params()
    d = tcfg.tiny_test_config().dit
    x = T(randn(50, 1, d.latent_frames, d.in_channels, d.latent_height,
                d.latent_width))
    sem = T(randn(51, *x.shape))
    ctx = T(randn(52, 1, d.text_length, d.text_dim))
    ctrl = optim.require_grad(tparams["control"])
    out = tdit.control_warp_forward(
        tparams["main"], ctrl, x, torch.tensor([321.0]), ctx, d, sem,
        attn_impl="pallas", compute_dtype=torch.float32, remat=remat)
    loss = out.square().mean()
    return loss.detach(), optim.grad(loss, ctrl)


def test_loss_and_grads_equal_with_and_without_remat_bit_for_bit(monkeypatch):
    """The checkpoint must run its first forward under the caller's grad
    mode: a first forward under no_grad would take the int8 kernel where
    the recompute takes the exact one (the int8 rule is forced on here, as
    at the full-width shapes), and the loss would not be the loss whose
    gradient is taken."""
    monkeypatch.setenv("LANDIFF_ATTN_INT8", "1")
    monkeypatch.setattr(TA, "_takes_int8", lambda *a: bool(a[-1]))
    rec = _Recorder(monkeypatch)
    loss_plain, grads_plain = _dit_loss_and_grads(remat=False)
    # 1 control layer + main layer 1 differentiated; main layer 0 is not
    assert rec.calls == {"exact": 2, "int8": 1}
    loss_remat, grads_remat = _dit_loss_and_grads(remat=True)
    assert rec.calls == {"exact": 2 + 4, "int8": 2}
    assert torch.equal(loss_plain, loss_remat)
    layer0, layer1 = grads_plain["layers"][0], grads_remat["layers"][0]
    assert all(torch.equal(layer0[k], layer1[k]) for k in layer0)
    assert all(bool(g.any()) for g in layer0.values())


def test_remat_save_attn_knob_is_refused(monkeypatch):
    """The knob was refused until the port kept the flash out / lse across
    the layer checkpoint itself; it is no longer refused: with it the remat
    step's loss and gradients are those without it, bit for bit, and the
    recompute launches no exact forward."""
    rec = _Recorder(monkeypatch)
    loss_plain, grads_plain = _dit_loss_and_grads(remat=True)
    # three forwards (main layer 0 without grad), two recomputed
    assert rec.calls == {"exact": 5, "int8": 0}
    monkeypatch.setenv("LANDIFF_REMAT_SAVE_ATTN", "1")
    loss_saved, grads_saved = _dit_loss_and_grads(remat=True)
    assert rec.calls == {"exact": 5 + 3, "int8": 0}
    assert torch.equal(loss_plain, loss_saved)
    layer0, layer1 = grads_plain["layers"][0], grads_saved["layers"][0]
    assert all(torch.equal(layer0[k], layer1[k]) for k in layer0)
    _dit_loss_and_grads(remat=False)          # the knob is about remat only
