"""PyTorch port: the int8_pv and exp_bf16 variants of the flash forward.

Their plain versions are held against JAX's flash_attention compiled as a
whole (V quantization included) with the Pallas kernels in interpret mode,
at JAX's tile (block_q = block_kv = 128, so the V block is 128 rows too),
and the V codes bit for bit. Then the knobs: the dispatcher ignores
LANDIFF_ATTN_EXP_BF16 as JAX's does and takes int8_pv under
LANDIFF_ATTN_INT8_PV=1 only on its int8 route; the direct flash_attention
reads all three knobs.

Two things of JAX's CPU run are not the TPU kernel's arithmetic, and the
exp_bf16 cases set them aside:
  - On the CPU jnp.exp2 lowers through XLA (jax/_src/lax/lax.py,
    _exp2_lower) to exp(ln 2 * x) in the input's dtype: for bf16,
    exp(bf16(ln 2) * x) with the product in bf16, which is
    2^(0.99750 x). Inside a Pallas kernel on a TPU, Mosaic lowers it to
    math.exp2 (jax/_src/pallas/mosaic/lowering.py, _exp2_lowering_rule;
    the exp(ln 2 * x) detour only for forward-compatible lowering or a
    TPU runtime older than 2025-07-26). The port's plain version follows
    the TPU kernel: 2^x rounded to bf16 (attention.exp2_bf16), and the
    comparison evaluates the JAX kernel with jnp.exp2 as Mosaic lowers it
    (_MosaicJnp). A separate test shows the CPU lowering differs.
  - With nothing to multiply p by (no mask, no padded kv), XLA may sum
    the f32 exp results before their bf16 rounding (excess precision).
    Every case here has a mask or a padded kv tile, so p is rounded first.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import randn
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu.ops import attention as JA
from landiff_tpu.ops import masks as JM
from landiff_tpu_torch.ops import attention as TA
from landiff_tpu_torch.ops import masks as TM

torch.set_num_threads(2)   # tier-1 runs six xdist workers

_LAYOUT = dict(num_frames=3, tokens_per_frame=100, iframe_tokens=60,
               pframe_tokens=20)
_MASKS = {"none": (None, None),
          "decoder": (JM.video_decoder_mask(JM.VideoMaskLayout(**_LAYOUT)),
                      TM.video_decoder_mask(TM.VideoMaskLayout(**_LAYOUT)))}
_BLOCK = 128


def _jax_exp2_bf16(x):
    """XLA's lowering of jnp.exp2 on bf16 (see the module docstring)."""
    return torch.exp(x * torch.tensor(np.log(2.0)).bfloat16())


class _MosaicJnp:
    """jax.numpy, but exp2 as Mosaic lowers it in a TPU kernel (math.exp2,
    see the module docstring): 2^x in f32, rounded to the input's dtype.
    Stands in for the JAX attention module's `jnp` during a comparison."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp2(x):
        return jnp.exp2(x.astype(jnp.float32)).astype(x.dtype)


@pytest.fixture
def mosaic_exp2(monkeypatch):
    """The JAX attention module's jnp.exp2 as Mosaic lowers it, for one
    test; JA._flash_call, jitted at import, drops its traces before and
    after, so no other test meets a trace of the stand-in."""
    monkeypatch.setattr(JA, "jnp", _MosaicJnp())
    JA._flash_call.clear_cache()
    yield
    JA._flash_call.clear_cache()


def _inputs(seed, S):
    return (randn(seed, 1, S, 2, 64, scale=2.0), randn(seed + 1, 1, S, 2, 64),
            randn(seed + 2, 1, S, 2, 64))


@pytest.mark.parametrize("mask,S", [("none", 500), ("decoder", 400)])
@pytest.mark.parametrize("int8,int8_pv,exp_bf16", [
    (True, True, False), (True, True, True), (True, False, True),
    (False, False, True)])
def test_plain_variants_match_jax_interpret(mosaic_exp2, mask, S, int8,
                                            int8_pv, exp_bf16):
    """500 positions leave a padded kv tile; the decoder layout has 400.
    Both take the int8 kernel in JAX (4 q blocks of 128). Tolerance per
    tensor, as on the card: within one bf16 step at the largest |JAX|
    output and 1e-3 relative RMS (readings: at most 0.25 steps and 4.1e-5:
    a p whose exp differs in its last f32 bit can round to another bf16);
    lse within 1e-5 (log2 units; read 2.9e-6). With XLA's CPU lowering of
    exp2 in place of Mosaic's the exp_bf16 cases read 1-3.5 steps,
    5.1e-3 to 1.3e-2 and 1.3e-2 to 1.4e-2, outside these limits."""
    jm, tm = _MASKS[mask]
    q, k, v = _inputs(11, S)
    fn = jax.jit(functools.partial(
        JA.flash_attention, mask_fn=jm, block_q=_BLOCK, block_kv=_BLOCK,
        interpret=True, int8_scores=int8, exp_bf16=exp_bf16,
        int8_pv=int8_pv, return_lse=True))
    out, lse = fn(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    want = torch.from_numpy(np.array(out.astype(jnp.float32)))
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    if int8:
        got, got_lse = TA.flash_int8_plain(
            qt, kt, vt, mask_fn=tm, block_kv=_BLOCK, int8_pv=int8_pv,
            exp_bf16=exp_bf16, v_block=_BLOCK)
    else:
        got, got_lse = TA.flash_exact_plain(qt, kt, vt, mask_fn=tm,
                                            block_kv=_BLOCK,
                                            exp_bf16=exp_bf16)
    steps, rel_rms = TA.kernel_error(got, want)
    assert steps <= 1.0 and rel_rms <= 1e-3, (steps, rel_rms)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=1e-5,
                               rtol=0)


def test_exp2_bf16_is_the_true_exp2_rounded():
    """The port's bf16 exp2 (the kernel's ex2 on bf16x2) is 2^x of the
    bf16 input rounded to bf16; JAX's CPU lowering differs from it."""
    x = torch.from_numpy(-np.abs(randn(3, 4096)) * 8).bfloat16()
    want = torch.from_numpy(np.exp2(x.double().numpy())).bfloat16()
    assert torch.equal(TA.exp2_bf16(x), want)
    jax_lowered = np.asarray(jax.jit(jnp.exp2)(
        jnp.asarray(x.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    assert torch.equal(_jax_exp2_bf16(x).float(),
                       torch.from_numpy(jax_lowered))
    assert not torch.equal(want.float(), torch.from_numpy(jax_lowered))


@pytest.mark.parametrize("int8", [False, True])
def test_exp2_table_stands_in_for_the_exp2(int8):
    """A table of the exp2 over all 65,536 bf16 inputs (on the card:
    attention.card_exp2_table, the kernel's own ex2) replaces the plain
    version's exp2 by a lookup: with the true exp2 tabulated, the result
    is bit for bit the plain version's."""
    bits = torch.arange(65536, dtype=torch.int32)
    x = torch.where(bits >= 32768, bits - 65536, bits).to(torch.int16)
    table = TA.exp2_bf16(x.view(torch.bfloat16))
    q, k, v = _qkv_t(200)
    plain = TA.flash_int8_plain if int8 else TA.flash_exact_plain
    want = plain(q, k, v, mask_fn=TM.causal, exp_bf16=True)
    got = plain(q, k, v, mask_fn=TM.causal, exp_bf16=True, exp2_table=table)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_v_codes_match_jax_exactly():
    """quantize_v_blocks against flash_attention's V quantization
    (attention.py:576-581) compiled by XLA, on inputs with exact ties at
    .5 and a padded last block: codes and scales bit for bit."""
    B, S, H, D, vb = 2, 300, 3, 64, 128
    v = randn(21, B, S, H, D)
    v[0, :4, 0, 0] = [127.0, 0.5, 1.5, -2.5]   # block absmax 127: halves
    Sp = -(-S // vb) * vb

    @jax.jit
    def jax_codes(x):
        vt = x.transpose(0, 2, 3, 1).reshape(B * H, D, S)
        vt = jnp.pad(vt, ((0, 0), (0, 0), (0, Sp - S)))
        blocks = vt.astype(jnp.float32).reshape(B * H, D, Sp // vb, vb)
        sv = jnp.max(jnp.abs(blocks), axis=(1, 3))
        sv = jnp.maximum(sv, 1e-30) / 127.0
        codes = jnp.round(blocks / sv[:, None, :, None]).astype(jnp.int8)
        return codes.reshape(B * H, D, Sp), sv

    want_codes, want_sv = (np.asarray(a) for a in jax_codes(
        jnp.asarray(v, jnp.bfloat16)))
    codes, sv = TA.quantize_v_blocks(torch.from_numpy(v).bfloat16(), vb)
    np.testing.assert_array_equal(codes.reshape(B * H, D, Sp).numpy(),
                                  want_codes)
    np.testing.assert_array_equal(sv.reshape(B * H, -1).numpy(), want_sv)
    np.testing.assert_array_equal(want_codes[0, 0, :4], [127, 0, 2, -2])
    assert TA.v_block_rows(17776) == 1024 and TA.v_block_rows(300) == 384
    # no padding (S a multiple of the block): still the kernel's layout
    codes, _ = TA.quantize_v_blocks(torch.from_numpy(v[:, :256]).bfloat16(),
                                    vb)
    assert codes.is_contiguous() and codes.shape == (B, H, D, 256)


def _qkv_t(S, seed=31):
    return tuple(torch.from_numpy(a).bfloat16()
                 for a in _inputs(seed, S))


def test_attention_ignores_exp_bf16(monkeypatch):
    """JAX's attention() pins exp_bf16=False (attention.py:838): the knob
    changes nothing on the dispatcher's route, int8 or exact."""
    q, k, v = _qkv_t(640)
    want_int8 = TA.attention(q, k, v, impl="pallas")
    want_exact = TA.attention(q, k, v, impl="pallas", int8_scores=False)
    monkeypatch.setenv("LANDIFF_ATTN_EXP_BF16", "1")
    assert torch.equal(TA.attention(q, k, v, impl="pallas"), want_int8)
    assert torch.equal(
        TA.attention(q, k, v, impl="pallas", int8_scores=False), want_exact)


def test_attention_takes_int8_pv_on_its_int8_route_only(monkeypatch):
    """LANDIFF_ATTN_INT8_PV=1 selects the int8_pv variant where the
    dispatcher takes the int8 kernel (640 positions: two 512-row q blocks,
    the "cached" rule holds), not on the exact route, and not under grad."""
    q, k, v = _qkv_t(640)
    monkeypatch.setenv("LANDIFF_ATTN_INT8_PV", "1")
    got = TA.attention(q, k, v, impl="pallas")
    assert torch.equal(got, TA.flash_int8_plain(q, k, v, int8_pv=True)[0])
    assert not torch.equal(got, TA.flash_int8_plain(q, k, v)[0])
    exact = TA.attention(q, k, v, impl="pallas", int8_scores=False)
    assert torch.equal(exact, TA.flash_exact_plain(q, k, v)[0])
    # one q block: not "cached", so the exact kernel, as JAX
    q1, k1, v1 = _qkv_t(300)
    assert torch.equal(TA.attention(q1, k1, v1, impl="pallas"),
                       TA.flash_exact_plain(q1, k1, v1)[0])
    qg = q.float().requires_grad_()
    out = TA.attention(qg, k.float(), v.float(), impl="pallas")
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), TA.flash_exact_plain(
        q.float(), k.float(), v.float())[0])
    assert not any(TA.LAUNCHES.values())


def test_flash_attention_reads_the_three_knobs(monkeypatch):
    """The direct entry reads LANDIFF_ATTN_INT8 (off unless set),
    LANDIFF_ATTN_EXP_BF16 and LANDIFF_ATTN_INT8_PV as JAX's flash_attention
    (:556-561); int8_pv applies only with int8 scores. CPU tensors run the
    plain versions at the kernel's tile."""
    q, k, v = _qkv_t(640)
    for knob in ("LANDIFF_ATTN_INT8", "LANDIFF_ATTN_EXP_BF16",
                 "LANDIFF_ATTN_INT8_PV"):
        monkeypatch.delenv(knob, raising=False)
    assert torch.equal(TA.flash_attention(q, k, v),
                       TA.flash_exact_plain(q, k, v)[0])
    monkeypatch.setenv("LANDIFF_ATTN_INT8_PV", "1")
    assert torch.equal(TA.flash_attention(q, k, v),
                       TA.flash_exact_plain(q, k, v)[0])
    monkeypatch.setenv("LANDIFF_ATTN_EXP_BF16", "1")
    out, lse = TA.flash_attention(q, k, v, return_lse=True)
    want = TA.flash_exact_plain(q, k, v, exp_bf16=True)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    monkeypatch.setenv("LANDIFF_ATTN_INT8", "1")
    assert torch.equal(TA.flash_attention(q, k, v), TA.flash_int8_plain(
        q, k, v, int8_pv=True, exp_bf16=True)[0])
    assert torch.equal(TA.flash_attention(q, k, v, int8_pv=False),
                       TA.flash_int8_plain(q, k, v, exp_bf16=True)[0])
    assert TA.variant_name(True, True, True) == "flash_fwd_int8_pv_exp_bf16"
    assert set(TA.LAUNCHES) == (set(TA.FWD_VARIANTS) | {"flash_bwd"}
                                | set(TA.F32_KERNELS))
    assert len(TA.FWD_VARIANTS) == 6


@pytest.mark.parametrize("kv_len", [1, 127, 128, 129, 1000, 1025, 17776,
                                    18768])
def test_v_block_holds_whole_kernel_tiles(kv_len):
    """int8_pv's V scale is per block of v_block_rows (a multiple of 128,
    JAX's at its default tile): every kernel kv tile (KERNEL_BLOCK_KV) lies
    inside one V block, as the kernel's single scale per tile and
    _flash_plain's check require."""
    v_block = TA.v_block_rows(kv_len)
    assert v_block % TA.KERNEL_BLOCK_KV == 0 and v_block % 128 == 0
    assert 128 % TA.KERNEL_BLOCK_KV == 0
    g = torch.Generator().manual_seed(kv_len)
    q, k, v = (torch.randn((1, 3, 1, 64), generator=g) for _ in range(3))
    if kv_len <= 1025:    # the plain version takes it at its default tile
        k, v = (torch.randn((1, kv_len, 1, 64), generator=g)
                for _ in range(2))
        out, _ = TA.flash_int8_plain(q, k, v, int8_pv=True)
        assert bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="inside one V block"):
        TA.flash_int8_plain(q, q, q, int8_pv=True, v_block=128,
                            block_kv=256)
