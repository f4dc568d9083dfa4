"""PyTorch port: the checking reference and the tables of the f32 int8-score
forward (csrc/flash_f32.cu flash_fwd_i8_f32_kernel), which is held on the
card to attention.int8_f64_reference.

  - The reference's codes and scales are the kernel's, made in f32: with
    one kv position its lse is that position's score, which equals f32(q8 .
    k8) * sq * sk from quantize_q_rows and quantize_k_plain on the f32
    inputs bit for bit; the quantizers give the same codes and scales from
    float64 copies as from the f32 values.
  - Its output (softmax sums and p.v in float64) against the f32 plain
    version and against JAX's flash_attention with the Pallas int8-score
    kernel in interpret mode (f32, block_q = block_kv = 64, the kernel's
    kv tile), under no mask, the causal and the video-decoder mask: within
    attention.F32_TOL["fwd"] (max |err| over the largest |ref| 1e-5,
    relative RMS 5e-6, lse 1e-5 in log2 units; readings on a CPU at most
    4.8e-7, 2.2e-7 and 1.9e-6).
  - The visibility tables at the kernel's tiles (F32_I8_BLOCK_Q x
    F32_BLOCK_KV: 128 q rows, 192 where p is bf16 or int8, x 64 kv rows)
    list every kv tile that holds a visible pair and no other, for the
    video encoder and decoder masks: the visible pairs inside the listed
    tiles are masks.visible_count, and a tile of kind 2 is visible
    throughout."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import fast_jit, randn
from _torch_port_helpers import fast_jax_compiles  # noqa: F401 (autouse)
from landiff_tpu.ops import attention as JA
from landiff_tpu.ops import masks as JM
from landiff_tpu_torch.ops import attention as TA
from landiff_tpu_torch.ops import masks as TM

torch.set_num_threads(2)   # tier-1 runs six xdist workers

# 3 x 48 + 30 + 2 x 10 = 194 positions; 200 rows: the last six see nothing
_LAYOUT = dict(num_frames=3, tokens_per_frame=48, iframe_tokens=30,
               pframe_tokens=10)
_S = 200
_MASKS = {"none": (None, None), "causal": (JM.causal, TM.causal),
          "decoder": (JM.video_decoder_mask(JM.VideoMaskLayout(**_LAYOUT)),
                      TM.video_decoder_mask(TM.VideoMaskLayout(**_LAYOUT)))}
_BLOCK = TA.F32_BLOCK_KV


def _inputs(seed, S=_S):
    return (randn(seed, 1, S, 2, 64, scale=2.0), randn(seed + 1, 1, S, 2, 64),
            randn(seed + 2, 1, S, 2, 64))


def test_checking_reference_scores_are_the_kernels():
    """One kv position: p = 1, so lse is the score, in f32 from the f32
    codes and scales; the quantizers take float64 copies to the same codes
    and scales (q, K and the int8_pv V blocks)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(31, 150))
    q[0, :4] *= 1e-3                  # rows of other magnitudes
    q[0, 4] = 0.0                     # a row of zeros: codes 0, s = 0
    k1, v1 = k[:, :1], v[:, :1]
    qscale = TA.LOG2E / 8.0           # scale 1/sqrt(64) times log2(e)
    codes, sq = TA.quantize_q_rows(q, qscale)
    k8, sk = TA.quantize_k_plain(k1)
    s = (codes.permute(0, 2, 1, 3) @ k8.float().permute(0, 2, 3, 1)
         * sq.permute(0, 2, 1, 3) * sk[None, :, None, :1])
    for int8_pv in (False, True):
        _, lse = TA.int8_f64_reference(q, k1, v1, int8_pv=int8_pv,
                                       block_kv=_BLOCK)
        assert lse.dtype == torch.float32
        assert torch.equal(lse, s[..., 0]), int8_pv
    for f32, f64 in ((TA.quantize_q_rows(q, qscale),
                      TA.quantize_q_rows(q.double(), qscale)),
                     (TA.quantize_k_plain(k), TA.quantize_k_plain(k.double())),
                     (TA.quantize_v_blocks(v, 128),
                      TA.quantize_v_blocks(v.double(), 128))):
        for a, b in zip(f32, f64):
            assert a.dtype == b.dtype and torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_int8(mask):
    jm = _MASKS[mask][0]
    args = tuple(jnp.asarray(a) for a in _inputs(33))
    fn = functools.partial(JA.flash_attention, mask_fn=jm, block_q=_BLOCK,
                           block_kv=_BLOCK, interpret=True, int8_scores=True,
                           exp_bf16=False, int8_pv=False, return_lse=True)
    return jax.tree_util.tree_map(np.asarray, fast_jit(fn, *args)(*args))


@pytest.mark.parametrize("mask", ["none", "causal", "decoder"])
def test_checking_reference_matches_plain_and_jax_interpret(mask):
    tm = _MASKS[mask][1]
    q, k, v = (torch.from_numpy(a) for a in _inputs(33))
    ref, ref_lse = TA.int8_f64_reference(q, k, v, mask_fn=tm,
                                         block_kv=_BLOCK)
    plain, plain_lse = TA.flash_int8_plain(q, k, v, mask_fn=tm,
                                           block_kv=_BLOCK)
    out, lse = _jax_int8(mask)
    tol = TA.F32_TOL["fwd"]
    for other, other_lse in ((plain, plain_lse), (torch.from_numpy(
            np.array(out)), torch.from_numpy(np.array(lse)))):
        assert other.dtype == torch.float32
        max_rel, rel_rms = TA.kernel_error_rel(other, ref)
        assert max_rel <= tol["max_rel"] and rel_rms <= tol["rel_rms"], \
            (max_rel, rel_rms)
        assert (other_lse - ref_lse).abs().max().item() <= tol["lse"]
    if mask == "decoder":             # rows past the layout see nothing
        seq = TM.VideoMaskLayout(**_LAYOUT).seq_len
        assert ref[:, seq:].abs().max().item() == 0.0


@pytest.mark.parametrize("narrow_p", [False, True])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_int8_f32_tables_cover_the_visible_pairs(kind, narrow_p):
    layout = TM.VideoMaskLayout(num_frames=3, tokens_per_frame=150,
                                iframe_tokens=70, pframe_tokens=20)
    mf = (TM.video_encoder_mask if kind == "encoder"
          else TM.video_decoder_mask)(layout)
    S = layout.seq_len + 37           # rows and columns past the layout
    bq, bkv = TA.F32_I8_BLOCK_Q[narrow_p], TA.F32_BLOCK_KV
    count, order, kinds = (t.numpy() for t in TA.visibility_tables(
        mf, S, S, "cpu", tiles=(bq, bkv)))
    idx = torch.arange(S)
    vis = mf(idx[:, None], idx[None, :]).numpy()
    listed = np.zeros_like(vis)
    for qt in range(len(count)):
        rows = slice(qt * bq, (qt + 1) * bq)
        for j in range(count[qt]):
            cols = slice(order[qt, j] * bkv, (order[qt, j] + 1) * bkv)
            listed[rows, cols] = True
            assert vis[rows, cols].any()
            if kinds[qt, j] == 2:
                assert vis[rows, cols].all()
    assert int((vis & listed).sum()) == TM.visible_count(mf, S, S)
    assert not (vis & ~listed).any()
