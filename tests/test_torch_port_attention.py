"""PyTorch port: mask specs, block visibility, and the plain versions of
the two flash kernels held against the JAX Pallas kernels run in
interpret mode (as tests/test_masks_attention.py runs them), tile for
tile (block_q = block_kv = 16)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import assert_close, randn
from landiff_tpu.ops import attention as JA
from landiff_tpu.ops import masks as JM
from landiff_tpu_torch.ops import attention as TA
from landiff_tpu_torch.ops import masks as TM

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


@pytest.mark.parametrize("name", ["causal", "decoder", "encoder"])
def test_mask_specs_match_jax(name):
    jm, tm = _MASKS[name]
    n = T_LAYOUT.seq_len + 8
    want = JM.materialize(jm, n, n)
    np.testing.assert_array_equal(tm(np.arange(n)[:, None],
                                     np.arange(n)[None]), want)
    qi = torch.arange(n)[:, None]
    np.testing.assert_array_equal(tm(qi, torch.arange(n)[None]).numpy(),
                                  want)
    kind = tm.descriptor()[0]
    assert kind == {"causal": TM.MASK_CAUSAL, "decoder":
                    TM.MASK_VIDEO_DECODER,
                    "encoder": TM.MASK_VIDEO_ENCODER}[name]


@pytest.mark.parametrize("name", ["causal", "decoder", "encoder"])
@pytest.mark.parametrize("bq,bkv", [(8, 8), (16, 8), (8, 32), (64, 64)])
def test_block_visibility_matches_jax(name, bq, bkv):
    jm, tm = _MASKS[name]
    for q_len, kv_len in ((T_LAYOUT.seq_len, T_LAYOUT.seq_len), (40, 29)):
        np.testing.assert_array_equal(
            TM.block_visibility(tm, q_len, kv_len, bq, bkv),
            JM.block_visibility(jm, q_len, kv_len, bq, bkv))
        np.testing.assert_array_equal(
            TM.block_visibility(TM.kv_limit(tm, kv_len - 3), q_len, kv_len,
                                bq, bkv),
            JM.block_visibility(JM.kv_limit(jm, kv_len - 3), q_len, kv_len,
                                bq, bkv))


def _qkv(seed, Sq, Skv, H=2, D=32, dtype=np.float32):
    q = randn(seed, 1, Sq, H, D, scale=2.0)
    k = randn(seed + 1, 1, Skv, H, D)
    v = randn(seed + 2, 1, Skv, H, D)
    return q, k, v


@pytest.mark.parametrize("name", ["none", "causal", "decoder", "encoder"])
def test_mha_reference_matches_jax(name):
    jm, tm = _MASKS[name]
    S = T_LAYOUT.seq_len
    q, k, v = _qkv(1, S, S)
    want = JA.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mask_fn=jm)
    got = TA.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), mask_fn=tm)
    assert_close(got, want, atol=1e-5, rtol=1e-5)


def _jax_flash(q, k, v, jm, int8, dtype):
    """flash_attention compiled as a whole, as it runs inside the jitted
    models (the K quantization included)."""
    fn = jax.jit(functools.partial(
        JA.flash_attention, mask_fn=jm, block_q=16, block_kv=16,
        interpret=True, int8_scores=int8, exp_bf16=False, int8_pv=False,
        return_lse=True))
    out, lse = fn(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                  jnp.asarray(v, dtype))
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _port_flash(q, k, v, tm, int8, dtype):
    fn = TA.flash_int8_plain if int8 else TA.flash_exact_plain
    out, lse = fn(torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
                  torch.from_numpy(v).to(dtype), mask_fn=tm, block_kv=16)
    return out.float(), lse


# (mask, Sq, Skv): uneven kv is a ragged last tile; decoder rows past the
# layout's seq_len (33) see nothing
_CASES = [("none", 48, 48), ("none", 40, 37), ("causal", 48, 48),
          ("decoder", 33, 33), ("decoder", 41, 41), ("encoder", 33, 33)]


@pytest.mark.parametrize("name,Sq,Skv", _CASES)
def test_plain_exact_flash_matches_jax_interpret(name, Sq, Skv):
    """The exact kernel's plain version vs _flash_kernel_cached in
    interpret mode, bf16 inputs as on the main path. Tolerance: one bf16
    step of the output (2^-8 relative) plus 1e-3, for f32 sums taken in
    another order; the log2 lse to 1e-4."""
    jm, tm = _MASKS[name]
    q, k, v = _qkv(3, Sq, Skv)
    want, want_lse = _jax_flash(q, k, v, jm, False, jnp.bfloat16)
    got, lse = _port_flash(q, k, v, tm, False, torch.bfloat16)
    assert_close(got, want, atol=1e-3, rtol=2 ** -8)
    assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


def test_plain_exact_flash_fully_masked_row_is_zero():
    """A row that sees nothing gives 0 and lse NEG_INF (attention.py:190)."""
    def jm(qi, ki):
        return (qi != 5) & (ki <= qi)

    class TMask:
        def __call__(self, qi, ki):
            return (qi != 5) & (ki <= qi)

    q, k, v = _qkv(4, 32, 32)
    want, want_lse = _jax_flash(q, k, v, jm, False, jnp.float32)
    got, lse = _port_flash(q, k, v, TMask(), False, torch.float32)
    assert float(got[0, 5].abs().max()) == 0.0
    assert float(lse[0, :, 5].max()) == float(np.float32(TA.NEG_INF))
    assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


def test_int8_codes_match_jax_exactly():
    """q codes per row (attention.py:298-303) and K codes per position
    (:567-570) against the same JAX expressions compiled by XLA, on
    inputs that include exact ties at .5 (round half to even)."""
    q = randn(5, 2, 512, 2, 64, scale=2.0)
    q[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]    # row absmax 127: halves
    k = randn(6, 2, 512, 2, 64)
    c = (1.0 / 8.0) * 1.4426950408889634

    @jax.jit
    def jax_codes(qb, kb):
        qf = qb.astype(jnp.float32)
        sq = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1, keepdims=True),
                         1e-30) / 127.0
        q8 = jnp.round(qf / sq).astype(jnp.int8)
        kf = kb.astype(jnp.float32)
        sk = jnp.maximum(jnp.max(jnp.abs(kf), axis=-1, keepdims=True),
                         1e-30) / 127.0
        k8 = jnp.round(kf / sk).astype(jnp.int8)
        return q8, sq * (1.0 / 8.0 * 1.4426950408889634), k8, sk[..., 0]

    want = [np.asarray(a) for a in jax_codes(jnp.asarray(q, jnp.bfloat16),
                                             jnp.asarray(k, jnp.bfloat16))]

    codes, sq = TA.quantize_q_rows(torch.from_numpy(q).to(torch.bfloat16), c)
    k8, sk = TA.quantize_k_positions(torch.from_numpy(k).to(torch.bfloat16))
    np.testing.assert_array_equal(codes.to(torch.int8).numpy(), want[0])
    # XLA may fold the two constant factors of the folded scale into one
    # product: one f32 ulp
    np.testing.assert_allclose(sq.numpy(), want[1], rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(k8.numpy(), want[2])
    np.testing.assert_array_equal(sk.numpy(), want[3])
    np.testing.assert_array_equal(want[0][0, 0, 0, :4], [127, 0, 2, -2])


@pytest.mark.parametrize("name,Sq,Skv", _CASES)
def test_plain_int8_flash_matches_jax_interpret(name, Sq, Skv):
    """The int8 kernel's plain version vs _flash_kernel_cached_i8 in
    interpret mode (Sq > block_q, so nq > 1 and JAX really takes the
    int8 kernel). The codes and scores are identical on both sides;
    tolerance as the exact kernel's."""
    jm, tm = _MASKS[name]
    q, k, v = _qkv(6, Sq, Skv)
    want, want_lse = _jax_flash(q, k, v, jm, True, jnp.bfloat16)
    got, lse = _port_flash(q, k, v, tm, True, torch.bfloat16)
    assert_close(got, want, atol=1e-3, rtol=2 ** -8)
    assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


def test_cpu_wrappers_run_the_plain_versions():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(7, 70, 70, D=64))
    TA.reset_launch_counts()
    out, _ = TA.flash_fwd_int8(q, k, v, mask_fn=TM.causal)
    ref, _ = TA.flash_int8_plain(q, k, v, mask_fn=TM.causal)
    assert torch.equal(out, ref)
    out, _ = TA.flash_fwd_exact(q, k, v)
    assert torch.equal(out, TA.flash_exact_plain(q, k, v)[0])
    assert TA.flash_fwd_exact.launches == 0
    assert TA.flash_fwd_int8.launches == 0


def test_kernel_error_counts_bf16_steps_at_the_largest_value():
    ref = torch.tensor([0.3, -0.3, 2 ** -10, 0.0]).bfloat16()
    out = ref.float() + torch.tensor([2 ** -9, 0.0, 2 ** -8, 0.0])
    steps, rel_rms = TA.kernel_error(out.bfloat16(), ref)
    assert steps == 2.0
    want = math.hypot(2 ** -9, 2 ** -8) / ref.float().norm().item()
    assert rel_rms == pytest.approx(want, rel=1e-3)
