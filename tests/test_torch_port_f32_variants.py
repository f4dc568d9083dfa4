"""PyTorch port: the f32 forms of the fast path's variants and the 3xTF32
split.

  - The int8_pv and exp_bf16 variants given f32 inputs: their plain
    versions (what the f32 kernels of csrc/flash_f32.cu are held to on the
    card) against JAX's flash_attention compiled as a whole (V
    quantization included) with the Pallas kernels in interpret mode, in
    f32, at JAX's tile (block_q = block_kv = 128, so the V block is 128
    rows too), with the video-decoder mask and with none. exp_bf16 takes
    jnp.exp2 as Mosaic lowers it in a TPU kernel (2^x rounded to bf16; see
    tests/test_torch_port_fast_attention.py, whose fixture this reuses).
  - The dispatcher's f32 route under LANDIFF_ATTN_INT8_PV=1 against JAX's
    attention(impl="pallas") under the same knob.
  - The plain 3xTF32 split (attention.tf32_split_plain): hi is x rounded
    to tf32 (low 13 bits clear, ties away from zero), and hi + lo is x to
    2^-21 relative; the transposed split's layout.
  - chip_ablation.py's tables for the f32 kernels (the 3xTF32 exact
    forward and backward, the int8-score forward) still apply to
    csrc/flash_f32.cu.

Tolerances are stated at each test, from the readings on this CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import check_ablation_variant, randn
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu.ops import attention as JA
from landiff_tpu.ops import masks as JM
from landiff_tpu_torch.ops import attention as TA
from landiff_tpu_torch.ops import masks as TM
from test_torch_port_fast_attention import mosaic_exp2  # noqa: F401

torch.set_num_threads(2)   # tier-1 runs six xdist workers

# 3 x 64 + 40 + 2 x 12 = 256 positions: two q blocks of 128, so JAX takes
# its int8-score kernel; 260 unmasked positions leave a padded kv tile
_LAYOUT = dict(num_frames=3, tokens_per_frame=64, iframe_tokens=40,
               pframe_tokens=12)
_MASKS = {"none": (None, None, 260),
          "decoder": (JM.video_decoder_mask(JM.VideoMaskLayout(**_LAYOUT)),
                      TM.video_decoder_mask(TM.VideoMaskLayout(**_LAYOUT)),
                      256)}
_BLOCK = 128
_VARIANTS = [(True, True, False), (True, True, True), (True, False, True),
             (False, False, True)]


def _inputs(seed, S):
    return (randn(seed, 1, S, 2, 64, scale=2.0), randn(seed + 1, 1, S, 2, 64),
            randn(seed + 2, 1, S, 2, 64))


@pytest.mark.parametrize("mask", ["none", "decoder"])
@pytest.mark.parametrize("int8,int8_pv,exp_bf16", _VARIANTS)
def test_f32_plain_variants_match_jax_interpret(mosaic_exp2, mask, int8,
                                                int8_pv, exp_bf16):
    """int8 scores: the same p on both sides (the scores are exact integer
    sums), f32 sums in another order: within 2e-5 of the largest |JAX|
    output (max) and 1e-5 relative RMS (readings at most 6.3e-7 and
    2.2e-7). Exact scores with exp_bf16: JAX's f32 dot and the plain
    version's f32 product sum in other orders and may differ in the last
    bit of s, and bf16(s - m) then may round the other way, moving that p
    by up to 2^-8: within 1e-4 and 2e-5. lse within 1e-5 (log2 units)."""
    jm, tm, S = _MASKS[mask]
    q, k, v = _inputs(11, S)
    fn = jax.jit(functools.partial(
        JA.flash_attention, mask_fn=jm, block_q=_BLOCK, block_kv=_BLOCK,
        interpret=True, int8_scores=int8, exp_bf16=exp_bf16,
        int8_pv=int8_pv, return_lse=True))
    out, lse = fn(*(jnp.asarray(a) for a in (q, k, v)))
    assert out.dtype == jnp.float32
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    if int8:
        got, got_lse = TA.flash_int8_plain(
            qt, kt, vt, mask_fn=tm, block_kv=_BLOCK, int8_pv=int8_pv,
            exp_bf16=exp_bf16, v_block=_BLOCK)
    else:
        got, got_lse = TA.flash_exact_plain(qt, kt, vt, mask_fn=tm,
                                            block_kv=_BLOCK,
                                            exp_bf16=exp_bf16)
    assert got.dtype == torch.float32
    max_rel, rel_rms = TA.kernel_error_rel(got, torch.from_numpy(
        np.asarray(out)))
    lim = (2e-5, 1e-5) if int8 else (1e-4, 2e-5)
    assert max_rel <= lim[0] and rel_rms <= lim[1], (max_rel, rel_rms)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=1e-5,
                               rtol=0)


def test_f32_dispatcher_takes_int8_pv_as_jax(monkeypatch):
    """attention(impl="pallas") on f32 inputs under LANDIFF_ATTN_INT8_PV=1
    (640 positions: two 512-row q blocks, the "cached" rule holds) takes
    the int8_pv route, as JAX's attention under the same knob (interpret
    mode on the CPU). JAX walks kv in one 640-row block and the port's
    plain version in 128-row tiles, so p8 = rint(127 p) is taken at other
    running maxima: the two are compared at JAX's tile, within 2e-3 of the
    largest |JAX| output and 3e-4 relative RMS (readings 6.8e-4 and
    1.1e-4); the int8-score and exact routes read 3.2e-2 and 3.5e-2
    relative RMS from it."""
    monkeypatch.setenv("LANDIFF_ATTN_INT8_PV", "1")
    q, k, v = _inputs(21, 640)
    want = torch.from_numpy(np.asarray(JA.attention(
        *(jnp.asarray(a) for a in (q, k, v)), impl="pallas")))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    before = dict(TA.LAUNCHES)
    got = TA.attention(qt, kt, vt, impl="pallas")
    assert TA.LAUNCHES == before    # the CPU runs the plain version
    assert torch.equal(got, TA.flash_int8_plain(qt, kt, vt, int8_pv=True)[0])
    at_jax_tile = TA.flash_int8_plain(qt, kt, vt, int8_pv=True,
                                      block_kv=640)[0]
    max_rel, rel_rms = TA.kernel_error_rel(at_jax_tile, want)
    assert max_rel <= 2e-3 and rel_rms <= 3e-4, (max_rel, rel_rms)
    for other in (TA.flash_int8_plain(qt, kt, vt, block_kv=640)[0],
                  TA.flash_exact_plain(qt, kt, vt, block_kv=640)[0]):
        assert TA.kernel_error_rel(other, want)[1] > 10 * rel_rms


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """x rounded to 11 significant bits, ties away from zero, in float64
    arithmetic (an independent construction of cvt.rna.tf32.f32)."""
    x = x.astype(np.float64)
    m, e = np.frexp(x)                     # x = m * 2^e, |m| in [0.5, 1)
    scaled = np.abs(m) * 2.0 ** 11         # 11 significant bits
    r = np.floor(scaled + 0.5)             # ties away from zero
    return (np.sign(m) * r * 2.0 ** (e - 11)).astype(np.float32)


def _edge_values() -> np.ndarray:
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -23)
    vals = [0.0, -0.0, 1.0, -1.0, 2.0 ** -126, 1.5, 3.0e38, -3.0e38,
            float(one + 2.0 ** -11),                   # a tie: rounds up
            float(one + 2.0 ** -11 - ulp),             # just below it
            float(one + 2.0 ** -11 + ulp),
            float(one + 3 * 2.0 ** -11),               # tie at an odd step
            float(np.float32(2.0) - ulp),              # carries into 2
            -float(one + 2.0 ** -11), 1e-30, 1.17549435e-38,
            0.1, -0.3, 123456.789, 2.0 ** 100 * 1.2345]
    return np.array(vals, dtype=np.float32)


@pytest.mark.parametrize("kind", ["random", "edge"])
def test_tf32_split_plain(kind):
    """hi = tf32(x): its low 13 bits clear and equal to the float64
    construction; lo = tf32(x - hi); |x - hi - lo| <= 2^-21 |x| (the bound
    is 2^-22 for normal x)."""
    if kind == "random":
        rng = np.random.default_rng(5)
        x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(
            -20, 20, 20000)).astype(np.float32)
    else:
        x = _edge_values()
    hi, lo = TA.tf32_split_plain(torch.from_numpy(x))
    bits = hi.view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    np.testing.assert_array_equal(hi.numpy(), _tf32_reference(x))
    np.testing.assert_array_equal(lo.numpy(),
                                  _tf32_reference(x - hi.numpy()))
    xd = x.astype(np.float64)
    err = np.abs(xd - hi.double().numpy() - lo.double().numpy())
    assert np.all(err <= 2.0 ** -21 * np.abs(xd)), err.max()


def test_tf32_split_t_plain_layout():
    """The transposed split: (B, H, D, s_pad), position p of each 8-group
    holding s 2j (j = p % 8 < 4) or 2(j - 4) + 1, zero where s >= S, and
    the values those of tf32_split_plain; the CPU wrappers run the plain
    versions."""
    x = torch.from_numpy(randn(3, 2, 70, 3, 64, scale=3.0))
    hi, lo = TA.tf32_split_t(x, 128)
    assert hi.shape == lo.shape == (2, 3, 64, 128)
    ref_hi, ref_lo = TA.tf32_split(x)
    for p in range(128):
        j = p % 8
        s = p - j + (2 * j if j < 4 else 2 * (j - 4) + 1)
        for got, ref in ((hi, ref_hi), (lo, ref_lo)):
            want = (ref[:, s] if s < 70
                    else torch.zeros((2, 3, 64)))
            assert torch.equal(got[..., p], want), (p, s)


_F32_ABLATIONS = {"fwd_f32": ["one_pass", "two_pass", "group_4", "group_2",
                              "stages_2"],
                  "bwd_f32": ["one_pass", "two_pass", "exp2f", "slice_adds",
                              "group_4", "group_2", "no_reduce",
                              "no_dq_product"],
                  "fwd_i8_f32": ["wgs_3", "narrow_wgs_2", "q_regs", "group_4",
                                 "stages_2", "stages_4", "no_overlap",
                                 "no_exp2", "two_pass", "no_pv_product"]}


@pytest.mark.parametrize("kernel,variant", [
    (k, v) for k, names in _F32_ABLATIONS.items() for v in names])
def test_f32_ablation_variants_still_apply_to_the_kernel_source(kernel,
                                                                variant):
    """chip_ablation.py --kernel fwd_f32 | bwd_f32 | fwd_i8_f32: each edit
    of flash_f32.cu's text matches the source exactly once."""
    check_ablation_variant(kernel, variant, _F32_ABLATIONS[kernel])
