"""Attention (counterpart of landiff_tpu/ops/attention.py).

Layout: (batch, seq, heads, head_dim), BSHD, everywhere.

  - `mha_reference`: the dense oracle (f32 softmax, fully masked rows -> 0,
    sum floor 1e-6), what JAX's `xla` path runs.
  - `flash_fwd_exact` / `flash_fwd_int8`: the two flash forwards, each
    with an `exp_bf16` variant (p = exp2 in bf16) and the int8 one with an
    `int8_pv` variant (p.v in int8 against per-block V codes from
    `quantize_v_blocks`). On a CUDA tensor each launches its hand-written
    kernel (csrc/flash_fwd.cu; the int8 one after its K quantization
    prologue, `quantize_k`) and counts the launch in `LAUNCHES` under the
    variant's name (`variant_name`); on a CPU tensor it runs its plain
    PyTorch version (`flash_exact_plain` / `flash_int8_plain`), which
    repeats the kernel's arithmetic tile by tile.
  - `flash_bwd`: the flash backward (dq, dk, dv from the exact forward's
    out and log2 lse). CUDA tensors launch csrc/flash_bwd.cu (its
    prologue, `flash_bwd_prep`, then the main kernel) and count the
    launch in `LAUNCHES["flash_bwd"]`; CPU tensors run `flash_bwd_plain`
    (on `flash_bwd_prep_plain`).
  - `flash_attention`: the direct forward, counterpart of JAX's
    `flash_attention` (:485-604), which reads LANDIFF_ATTN_INT8,
    LANDIFF_ATTN_EXP_BF16 and LANDIFF_ATTN_INT8_PV itself.
  - `attention`: the dispatcher (`impl="auto" | "xla" | "pallas"` as in
    JAX; "pallas" names the flash route), with the JAX selection rules as
    a pure function of shape and dtype (`select_path`), so that the same
    shapes take the same numeric path in both packages. A call that is
    differentiated (grad enabled and q, k or v requires grad) goes
    through `_FlashDiff`, the counterpart of JAX's `_flash_diff`: always
    the exact forward, whatever LANDIFF_ATTN_INT8 says, and the flash
    backward. The int8 forward's lse is approximate and never reaches the
    backward. Elsewhere LANDIFF_ATTN_INT8_PV=1 selects the `int8_pv`
    variant where the int8 route is taken, and LANDIFF_ATTN_EXP_BF16 is
    ignored, as JAX's `attention` pins exp_bf16=False (:838).

The kernels replace the Pallas kernels `_flash_kernel` (:91),
`_flash_kernel_cached` (:197), `_flash_kernel_cached_i8` (:264) and
`_flash_bwd_fused_kernel` (:658) of landiff_tpu/ops/attention.py; see
csrc/flash_fwd.cu and csrc/flash_bwd.cu for their bounds on the H100 and
the design. They take bf16 and f32 inputs: f32 ones go to the f32 forms
in csrc/flash_f32.cu (the exact and int8-score forwards with their
int8_pv / exp_bf16 variants, the backward; counted under the names ending
in _f32, `F32_KERNELS`), which keep p in f32 as the JAX kernels do given
f32 refs. The exact forward and the backward take their products on the
tensor cores in three TF32 passes ("3xTF32") on split copies of their
operands, which their prologues make (`tf32_split`, `tf32_split_t`, each
with a plain version); the int8-score forward its int8 scores on the
tensor cores and p.v in 3xTF32 (int8_pv: in int8). The f32 kernels are
checked against their plain versions run in float64 (`f64_reference`,
`int8_f64_reference`). `save_flash_residuals_context` keeps
`_FlashDiff`'s out / lse across a layer checkpoint
(LANDIFF_REMAT_SAVE_ATTN).
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import threading

import numpy as np
import torch

from landiff_tpu_torch.ops import masks as masks_lib

NEG_INF = -1e30
LOG2E = 1.4426950408889634

# the forward kernel's tiles (csrc/flash_fwd.cu kFwdBQ / kFwdBKV / kD); the
# plain versions use the same kv tile so both round p at the same running
# max. The kv tile divides 128, so it lies inside one int8_pv V block
# (v_block_rows, a multiple of 128)
KERNEL_BLOCK_Q = 192
KERNEL_BLOCK_KV = 128
KERNEL_HEAD_DIM = 64
# the backward kernel's tiles (csrc/flash_bwd.cu kBQ / kBwdKV): one CTA per
# 128-row kv tile walks 64-row q tiles; its tables and the plain
# backward's default kv block follow them
BWD_BLOCK_Q = 64
BWD_BLOCK_KV = 128
# the f32 kernels' tiles (csrc/flash_f32.cu): the exact forward 128 q rows
# (kFwdBQ) x 64 kv rows (kFwdBKV); the int8-score forward F32_I8_BLOCK_Q q
# rows, by whether p is bf16 or int8 (exp_bf16 or int8_pv: 64 per consumer
# warpgroup, kI8WGs / kI8NarrowWGs; its wrapper reads them from the library
# for the tables) x 64 kv rows; the backward per 64-row kv tile its 64-row
# q tiles (kBwdBKV, kBwdBQ). Compared with the kernels on the card, the
# plain versions take the f32 forwards' kv tile (F32_BLOCK_KV), so that a p
# rounded to bf16 or int8 is rounded at the same running max.
F32_FWD_BLOCK_Q = 128
F32_I8_BLOCK_Q = {False: 128, True: 192}
F32_BLOCK_KV = 64
# JAX's default kv block (flash_attention block_kv=1024), which is also the
# int8_pv V-scale block: one scale per (b, h, block of this many rows)
JAX_BLOCK_KV = 1024

# JAX's VMEM budget for the K/V-resident ("cached") kernel (:35); only
# its selection rule is reproduced here
_KV_CACHE_VMEM_BUDGET = 9 * 1024 * 1024


def mha_reference(q, k, v, mask=None, scale=None, mask_fn=None):
    """Dense attention oracle. q, k, v: (B, S, H, D); mask: bool, True =
    visible, broadcastable to (B, H, S_q, S_kv); mask_fn: a mask spec that
    builds it, or None. fp32 softmax, output cast to q.dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask_fn is not None:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = mask_fn(qi, ki)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    if mask is not None:
        # fully-masked rows -> 0 output (flex-attention semantics)
        p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-6)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# quantization (flash_attention :298-303 and :565-570)
#
# The JAX source writes `max(|x|, 1e-30) / 127.0`; compiled by XLA, the
# division by the constant becomes a multiplication by its f32 reciprocal
# (0.00787401572), while `x / scale` stays an IEEE division. The codes
# below reproduce the compiled program bit for bit (round half to even,
# as jnp.round); the CUDA kernel does the same for q.

INV127 = float(np.float32(1.0) / np.float32(127.0))


def _f32(value: float, device) -> torch.Tensor:
    """An f32 scalar on the device (a fill, not a host copy), so products
    round as the JAX program's f32 constants do."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _absmax_scale(xf: torch.Tensor, keepdim: bool) -> torch.Tensor:
    return (xf.abs().amax(-1, keepdim=keepdim).clamp_min(1e-30)
            * _f32(INV127, xf.device))


def quantize_q_rows(q: torch.Tensor, qscale: float):
    """Per-row symmetric absmax int8 codes of q (B, S, H, D): returns
    (codes as f32 (B, S, H, D), row scales (B, S, H, 1) with the softmax
    scale and log2(e) folded in, f32 and not rounded)."""
    qf = q.float()
    sq = _absmax_scale(qf, keepdim=True)
    codes = torch.round(qf / sq)
    return codes, sq * _f32(qscale, q.device)


def quantize_k_positions(k: torch.Tensor):
    """Per-kv-position symmetric absmax int8 K over D: returns (int8
    (B, S, H, D), f32 scales (B, S, H))."""
    kf = k.float()
    sk = _absmax_scale(kf, keepdim=False)
    return torch.round(kf / sk[..., None]).to(torch.int8), sk


def quantize_k_plain(k: torch.Tensor):
    """K codes and scales as the int8 forward kernel reads them: (int8
    (B, S, H, D), f32 scales (B*H, S_pad) with S_pad = S rounded up to
    the kernel's kv tile, zeros past S). The plain version of the kernel's
    prologue (csrc/flash_fwd.cu landiff_flash_quantize_k), on
    quantize_k_positions."""
    B, S, H, _ = k.shape
    k8, sk = quantize_k_positions(k)
    pad = masks_lib.round_up(S, KERNEL_BLOCK_KV) - S
    sk = torch.nn.functional.pad(sk.permute(0, 2, 1), (0, pad))
    return k8, sk.reshape(B * H, S + pad).contiguous()


def quantize_k(k: torch.Tensor):
    """quantize_k_plain's result: on a CUDA tensor (contiguous bf16 or f32
    BSHD, head dim 64) by one launch of the int8 forward's prologue kernel
    (csrc/flash_fwd.cu, or csrc/flash_f32.cu for f32), which
    flash_fwd_int8 launches before its main kernel and counts with it; on
    a CPU tensor by the plain version."""
    if k.device.type == "cpu":
        return quantize_k_plain(k)
    from landiff_tpu_torch.ops import kernels

    _check_inputs(k, k, k)
    B, S, H, _ = k.shape
    skv_pad = masks_lib.round_up(S, KERNEL_BLOCK_KV)
    k8 = torch.empty(k.shape, dtype=torch.int8, device=k.device)
    sk = torch.empty((B * H, skv_pad), dtype=torch.float32, device=k.device)
    quantize = (kernels.flash_f32_library().landiff_flash_quantize_k_f32
                if k.dtype == torch.float32
                else kernels.flash_library().landiff_flash_quantize_k)
    with torch.cuda.device(k.device):
        rc = quantize(k.data_ptr(), k8.data_ptr(), sk.data_ptr(), B, S, H,
                      skv_pad, torch.cuda.current_stream(k.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K quantization launch failed: cudaError {rc}")
    return k8, sk


def v_block_rows(kv_len: int) -> int:
    """The int8_pv V-scale block of flash_attention at its default tile:
    min(1024, round_up(kv_len, 128)) rows (:518, :576)."""
    return min(JAX_BLOCK_KV, masks_lib.round_up(kv_len, 128))


def quantize_v_blocks(v: torch.Tensor, v_block: int):
    """Per-(b, h, V block) symmetric absmax int8 V, as flash_attention
    quantizes it for int8_pv (:573-584): kv zero-padded to a multiple of
    v_block, one scale per block of v_block rows over all of D. Returns
    (codes int8 (B, H, D, Skv_p) with kv contiguous, the layout the kernel
    reads; scales f32 (B, H, Skv_p // v_block))."""
    B, S, H, D = v.shape
    Sp = masks_lib.round_up(S, v_block)
    vt = torch.nn.functional.pad(v.float().permute(0, 2, 3, 1), (0, Sp - S))
    vb = vt.reshape(B, H, D, Sp // v_block, v_block)
    sv = (vb.abs().amax(dim=(2, 4)).clamp_min(1e-30)
          * _f32(INV127, v.device))
    codes = torch.round(vb / sv[:, :, None, :, None]).to(torch.int8)
    # contiguous: with no padding vt is a permuted view of v, whose layout
    # the elementwise ops above keep
    return codes.reshape(B, H, D, Sp).contiguous(), sv


# ---------------------------------------------------------------------------
# the 3xTF32 split (csrc/flash_f32.cu: cvt.rna.tf32.f32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to tf32 (10 mantissa bits, ties away from zero, as
    cvt.rna.tf32.f32): its low 13 bits cleared after adding half of the
    last kept one. x finite."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split_plain(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi), f32 tensors like x; x -
    hi is exact, so |x - hi - lo| <= 2^-22 |x| for normal x, and a.b =
    hi.hi + hi.lo + lo.hi to about 2^-21 |a||b|. Plain version of the
    split prologue (csrc/flash_f32.cu landiff_tf32_split)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32_split_t_plain(x: torch.Tensor, s_pad: int):
    """The split of x (B, S, H, D) transposed to (B, H, D, s_pad), zero
    where s >= S, each 8-row group of s permuted: position j holds s 2j for j <
    4, 2(j - 4) + 1 after, the order in which an accumulator's registers
    hold the columns of its 8-column groups (so the kernels take p and ds
    as wgmma A fragments as they lie). Plain version of
    csrc/flash_f32.cu landiff_tf32_split_t."""
    S = x.shape[1]
    xt = torch.nn.functional.pad(x.float().permute(0, 2, 3, 1), (0, s_pad - S))
    j = torch.arange(s_pad, device=x.device) % 8
    src = torch.arange(s_pad, device=x.device) - j + torch.where(
        j < 4, 2 * j, 2 * (j - 4) + 1)
    return tf32_split_plain(xt[..., src].contiguous())


def tf32_split(x: torch.Tensor):
    """tf32_split_plain's result: on a CUDA tensor (contiguous f32) by one
    launch of the split prologue (csrc/flash_f32.cu), which the 3xTF32
    kernels' wrappers launch before their main kernel and count with it;
    on a CPU tensor by the plain version."""
    if x.device.type == "cpu":
        return tf32_split_plain(x)
    from landiff_tpu_torch.ops import kernels

    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() % 4 \
            or x.data_ptr() % 16:
        raise ValueError("tf32_split takes a contiguous, 16-byte aligned "
                         "f32 tensor of a multiple of 4 elements")
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = kernels.flash_f32_library().landiff_tf32_split(
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tf32 split launch failed: cudaError {rc}")
    return hi, lo


def tf32_split_t(x: torch.Tensor, s_pad: int):
    """tf32_split_t_plain's result: on a CUDA tensor (contiguous f32 BSHD,
    head dim 64, s_pad a multiple of 64) by one launch of the transposing
    split prologue (csrc/flash_f32.cu); on a CPU tensor by the plain
    version."""
    if x.device.type == "cpu":
        return tf32_split_t_plain(x, s_pad)
    from landiff_tpu_torch.ops import kernels

    _check_inputs(x, x, x)
    B, S, H, D = x.shape
    if x.dtype != torch.float32 or s_pad % 64 or s_pad < S:
        raise ValueError(f"tf32_split_t takes f32 and s_pad a multiple of "
                         f"64 >= {S}, got {x.dtype}, {s_pad}")
    hi = torch.empty((B, H, D, s_pad), dtype=torch.float32, device=x.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(x.device):
        rc = kernels.flash_f32_library().landiff_tf32_split_t(
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), B, S, H, s_pad,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tf32 split_t launch failed: cudaError {rc}")
    return hi, lo


# ---------------------------------------------------------------------------
# plain versions of the kernels


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working precision: f32 for bf16 and f32 inputs,
    float64 for float64 ones (a reference for the f32 kernels, rounded to
    f32 by its caller)."""
    return torch.promote_types(x.dtype, torch.float32)


def exp2_bf16(x: torch.Tensor) -> torch.Tensor:
    """2^x of a bf16 tensor, rounded to bf16: the kernel's ex2.approx on
    bf16x2, and what the Pallas kernel's jnp.exp2 computes on a TPU, where
    Mosaic lowers it to math.exp2 (jax/_src/pallas/mosaic/lowering.py,
    _exp2_lowering_rule). XLA's own lowering, which JAX's CPU and interpret
    runs take, is exp(ln 2 * x) in the input's dtype: for bf16,
    2^(0.99750 x)."""
    return torch.exp2(x)


@functools.lru_cache(maxsize=4)
def card_exp2_table(device: str) -> torch.Tensor:
    """The exp_bf16 kernels' exp2 as the card computes it
    (ex2.approx.ftz.bf16x2, within 2^-7 relative of 2^x, so not always the
    rounding of the true value): a (65536,) bf16 table indexed by the
    input's bits, from one launch of the kernel library's probe over all
    bf16 values. Given to the plain versions as `exp2_table`, it lets a
    comparison on the card hold the rest of the variant's arithmetic
    tightly; the plain version proper keeps the true exp2."""
    from landiff_tpu_torch.ops import kernels

    dev = torch.device(device)
    idx = torch.arange(65536, dtype=torch.int32, device=dev)
    bits = torch.where(idx >= 32768, idx - 65536, idx).to(torch.int16)
    out = torch.empty_like(bits)
    with torch.cuda.device(dev):
        rc = kernels.flash_library().landiff_ex2_bf16x2(
            bits.data_ptr(), out.data_ptr(), 32768,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ex2 probe launch failed: cudaError {rc}")
    return out.view(torch.bfloat16)


def _flash_plain(q, k, v, mask_fn, scale, int8: bool, block_kv: int,
                 int8_pv: bool = False, exp_bf16: bool = False,
                 v_block: int | None = None,
                 exp2_table: torch.Tensor | None = None):
    """Online-softmax flash forward over kv tiles of `block_kv`, all q rows
    at once, in the kernels' arithmetic (log2 domain, masked scores -1e30,
    p cast to v.dtype for p.v, out = acc / max(l, 1e-30)). Tiles a row
    cannot see change nothing (their p is 0 and alpha is 1), so skipping
    them, as the kernels do, gives the same numbers.

    exp_bf16 (_softmax_tile :44-50): p = exp2(bf16(s - m_new)) in bf16, the
    tile's row sum taken in f32 and rounded to bf16 before it joins l.
    int8_pv (:338-348): p8 = round(127 p) and V in int8 per V block of
    v_block rows (default v_block_rows(Skv)); acc = acc * alpha +
    (p8 . v8) * (sv * f32(1/127)). The p8 . v8 sums are integers below
    2^24 (block_kv <= 1024), so the f32 product is exact. exp2_table (a
    card_exp2_table) replaces the bf16 exp2 by a lookup. The sums are f32
    (float64 for float64 inputs, _sum_dtype). The int8 forms' codes and
    scales (of q, K and V), their scores s = f32(q8 . k8) * sq * sk and the
    int8_pv codes p8 (of the f32 p) are f32 whatever the input dtype, as
    the kernels make them."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if int8_pv and not int8:
        raise ValueError("int8_pv needs int8 scores")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qscale = _f32(scale * LOG2E, q.device)
    dev, cdt = q.device, _sum_dtype(q)
    if int8:
        codes, sq = quantize_q_rows(q, float(scale * LOG2E))
        qq = codes.permute(0, 2, 1, 3)                  # (B, H, Sq, D)
        sq = sq.permute(0, 2, 1, 3)                     # (B, H, Sq, 1)
        k8, sk = quantize_k_positions(k)
        kk = k8.float().permute(0, 2, 3, 1)             # (B, H, D, Skv)
        sk = sk.permute(0, 2, 1)                        # (B, H, Skv)
    else:
        qq = (q.to(cdt) * qscale).to(q.dtype).to(cdt).permute(0, 2, 1, 3)
        kk = k.to(cdt).permute(0, 2, 3, 1)
    vv = v.permute(0, 2, 1, 3)                          # (B, H, Skv, D)
    if int8_pv:
        v_block = v_block_rows(Skv) if v_block is None else v_block
        if v_block % block_kv:
            raise ValueError(f"a kv tile of {block_kv} rows must lie inside "
                             f"one V block of {v_block}")
        v8, sv = quantize_v_blocks(v, v_block)
        vv = v8.to(cdt).transpose(-1, -2)               # (B, H, Skv_p, D)
        svs = sv * _f32(INV127, dev)                    # (B, H, nvb)
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=cdt, device=dev)
    l = torch.zeros((B, H, Sq, 1), dtype=cdt, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=cdt, device=dev)
    qi = torch.arange(Sq, device=dev)[:, None]
    for j0 in range(0, Skv, block_kv):
        j1 = min(j0 + block_kv, Skv)
        # integer-valued f32 operands: the int8 products and their sums
        # (|sum| <= 64 * 127^2 < 2^24) are exact in f32
        s = qq @ kk[..., j0:j1]
        if int8:
            s = s * sq * sk[:, :, None, j0:j1]
        keep = None
        if mask_fn is not None:
            keep = mask_fn(qi, torch.arange(j0, j1, device=dev)[None, :])
            s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        if exp_bf16:
            d = (s - m_new).bfloat16()
            pb = (exp2_bf16(d) if exp2_table is None else
                  exp2_table[d.view(torch.int16).long() & 0xffff])
            if keep is not None:
                pb = pb * keep.bfloat16()
            p = pb.to(cdt)
            tile_sum = p.sum(-1, keepdim=True).bfloat16().to(cdt)
        else:
            p = torch.exp2(s - m_new)
            if keep is not None:
                p = p * keep
            tile_sum = p.sum(-1, keepdim=True)
        l = l * alpha + tile_sum
        if int8_pv:
            # the codes of the f32 p, exp2 of the f32 s - m on the inputs'
            # device, as the kernels round them: from a float64 p they
            # would move at rounding edges (int8_f64_reference)
            p32 = p
            if p.dtype != torch.float32 and not exp_bf16:
                p32 = torch.exp2((s - m_new).float())
                p32 = p32 if keep is None else p32 * keep
            p8 = torch.round(p32 * 127.0).to(cdt)
            pv = p8 @ vv[:, :, j0:j1]
            acc = acc * alpha + pv * svs[:, :, j0 // v_block, None, None]
        else:
            acc = acc * alpha + (p.to(v.dtype).to(cdt)
                                 @ vv[:, :, j0:j1].to(cdt))
        m = m_new
    out = (acc / l.clamp_min(1e-30)).to(q.dtype).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log2(l.clamp_min(1e-30)),
                      NEG_INF)[..., 0]
    return out.contiguous(), lse


def flash_exact_plain(q, k, v, *, mask_fn=None, scale=None,
                      block_kv: int = KERNEL_BLOCK_KV,
                      exp_bf16: bool = False, exp2_table=None):
    """Plain version of the exact kernel (_flash_kernel / _cached):
    returns (out (B, Sq, H, D) q.dtype, lse (B, H, Sq) log2, f32; float64
    for float64 inputs)."""
    return _flash_plain(q, k, v, mask_fn, scale, False, block_kv,
                        exp_bf16=exp_bf16, exp2_table=exp2_table)


def flash_int8_plain(q, k, v, *, mask_fn=None, scale=None,
                     block_kv: int = KERNEL_BLOCK_KV, int8_pv: bool = False,
                     exp_bf16: bool = False, v_block: int | None = None,
                     exp2_table=None):
    """Plain version of the int8-score kernel (_flash_kernel_cached_i8):
    returns (out, lse) like flash_exact_plain."""
    return _flash_plain(q, k, v, mask_fn, scale, True, block_kv,
                        int8_pv=int8_pv, exp_bf16=exp_bf16, v_block=v_block,
                        exp2_table=exp2_table)


def flash_bwd_prep_plain(q, out, lse, do, *, scale=None):
    """Plain version of the backward's prologue (csrc/flash_bwd.cu
    landiff_flash_bwd_prep): returns (q' = q * scale*log2e rounded to
    q.dtype, BSHD; lse padded to (B, H, Sq_pad) with +inf past Sq, where
    p = exp2(s - lse) = 0; delta = rowsum(do * out) in f32, (B, H, Sq_pad),
    0 past Sq; the zeroed dq workspace (B, H, Sq_pad, D) f32). Sq_pad
    rounds Sq up to BWD_BLOCK_Q. float64 inputs: float64 throughout."""
    B, Sq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev, cdt = q.device, _sum_dtype(q)
    sq_pad = masks_lib.round_up(Sq, BWD_BLOCK_Q)
    qs = (q.to(cdt) * _f32(scale * LOG2E, dev)).to(q.dtype)
    lse_pad = torch.full((B, H, sq_pad), math.inf, dtype=cdt, device=dev)
    lse_pad[:, :, :Sq] = lse
    delta = torch.zeros((B, H, sq_pad), dtype=cdt, device=dev)
    delta[:, :, :Sq] = (do.to(cdt) * out.to(cdt)).sum(-1).permute(0, 2, 1)
    ws = torch.zeros((B, H, sq_pad, D), dtype=cdt, device=dev)
    return qs, lse_pad, delta, ws


def dq_from_workspace(ws, q_len: int, dtype):
    """dq (B, Sq, H, D) in `dtype` from the workspace (B, H, Sq_pad, D)
    the backward adds into: rows past Sq dropped, cast, permuted."""
    return ws[:, :, :q_len].permute(0, 2, 1, 3).to(dtype).contiguous()


def flash_bwd_plain(q, k, v, out, lse, do, *, mask_fn=None, scale=None,
                    block_q: int | None = None,
                    block_kv: int = BWD_BLOCK_KV):
    """Plain version of the backward kernel (_flash_bwd_fused_kernel),
    tile by tile in the kernel's arithmetic: q' = q * scale*log2e rounded
    to q.dtype, s = q'.k^T (masked: -1e30), p = exp2(s - lse) * keep, dp =
    do.v^T, ds = p * (dp - delta) with delta = rowsum(do * out); p and
    scale*ds rounded to q.dtype before dv += p^T.do, dk += (scale*ds)^T.q,
    dq += (scale*ds).k; every sum in f32. The roundings are per element,
    so the tiles (block_q None: all q rows at once) change only the order
    of the f32 sums (float64 for float64 inputs, _sum_dtype). q', delta
    and the padded lse come from the prologue's plain version, and dq is
    summed in its workspace, as the kernel does.
    lse: (B, H, Sq) log2, from the exact forward. Returns (dq, dk, dv) in
    the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev, dt, cdt = q.device, q.dtype, _sum_dtype(q)
    bq = Sq if block_q is None else block_q
    bhsd = lambda x: x.to(cdt).permute(0, 2, 1, 3)
    qs, lse, delta, dq = flash_bwd_prep_plain(q, out, lse, do, scale=scale)
    qs = bhsd(qs)
    qf, kf, vf, dof = bhsd(q), bhsd(k), bhsd(v), bhsd(do.to(dt))
    delta, lse = delta[..., None], lse[..., None]       # (B, H, Sq_pad, 1)
    sc = _f32(scale, dev)
    dk = torch.zeros((B, H, Skv, D), dtype=cdt, device=dev)
    dv = torch.zeros((B, H, Skv, D), dtype=cdt, device=dev)
    for j0 in range(0, Skv, block_kv):
        j = slice(j0, min(j0 + block_kv, Skv))
        kj, vj = kf[:, :, j], vf[:, :, j]
        for i0 in range(0, Sq, bq):
            i = slice(i0, min(i0 + bq, Sq))
            s = qs[:, :, i] @ kj.transpose(-1, -2)
            keep = None
            if mask_fn is not None:
                keep = mask_fn(
                    torch.arange(i.start, i.stop, device=dev)[:, None],
                    torch.arange(j.start, j.stop, device=dev)[None, :])
                # -1e30 as f32, as the forward's lse of a row that sees
                # nothing: exp2(s - lse) = 1 (then * keep) in float64 too
                s = torch.where(keep, s, float(np.float32(NEG_INF)))
            pr = torch.exp2(s - lse[:, :, i])
            if keep is not None:
                pr = pr * keep
            dp = dof[:, :, i] @ vj.transpose(-1, -2)
            dsb = ((pr * (dp - delta[:, :, i])) * sc).to(dt).to(cdt)
            pb = pr.to(dt).to(cdt)
            dv[:, :, j] += pb.transpose(-1, -2) @ dof[:, :, i]
            dk[:, :, j] += dsb.transpose(-1, -2) @ qf[:, :, i]
            dq[:, :, i] += dsb @ kj
    bshd = lambda x, like: x.permute(0, 2, 1, 3).to(like.dtype).contiguous()
    return dq_from_workspace(dq, Sq, q.dtype), bshd(dk, k), bshd(dv, v)


def kernel_error(out: torch.Tensor, ref: torch.Tensor):
    """How far a kernel's output is from its plain version's: (max |out -
    ref| in bf16 steps at the largest |ref|, the relative RMS error
    ||out - ref|| / ||ref||). The step is the spacing of bf16 numbers at
    that magnitude: 2^-9 for |ref| in [0.25, 0.5)."""
    diff = out.float() - ref.float()
    top = ref.float().abs().max().clamp_min(2.0 ** -126)
    step = torch.exp2(torch.frexp(top)[1] - 8.0)   # top = m * 2^e, m in [.5, 1)
    rel_rms = diff.norm() / ref.float().norm().clamp_min(2.0 ** -126)
    return (diff.abs().max() / step).item(), rel_rms.item()


def kernel_error_rel(out: torch.Tensor, ref: torch.Tensor):
    """An f32 kernel's distance from its plain version: (max |out - ref|
    over the largest |ref|, the relative RMS error ||out - ref|| /
    ||ref||)."""
    diff = out.double() - ref.double()
    top = ref.double().abs().max().clamp_min(2.0 ** -126)
    rel_rms = diff.norm() / ref.double().norm().clamp_min(2.0 ** -126)
    return (diff.abs().max() / top).item(), rel_rms.item()


def f64_reference(plain, *tensors, **kw):
    """`plain` (a plain version) run on float64 copies of its tensor
    arguments, each result rounded to f32: the f32 function evaluated
    about exactly, which the 3xTF32 kernels are held to within F32_TOL.
    The plain version in f32 is no such reference at the main shapes: its
    own sums err by more than those limits (PERF.md)."""
    return tuple(x.float() for x in plain(*(t.double() for t in tensors),
                                          **kw))


def int8_f64_reference(q, k, v, **kw):
    """The checking reference of the f32 int8-score kernels (keywords as
    flash_int8_plain's): the plain version on float64 copies, rounded to
    f32. Its codes and scales are the kernels' bit for bit, made in f32
    from the f32 values (quantize_q_rows, quantize_k_positions and
    quantize_v_blocks compute in f32 whatever the input dtype; the copies
    are exact), and so are its scores, f32(q8 . k8) * sq * sk in JAX's
    order; the softmax, its sums and p . v then run in float64, but for
    int8_pv's p8 = rint(127 p), taken from the f32 p = exp2(f32(s - m)) as
    JAX and the kernels take it (exp2 on the inputs' device: on the card
    its own exp2, as the kernels'). Quantizing from float64 values would
    move codes at rounding edges, a difference that is not the kernel's
    (p8 from a float64 p misses the f32 limits at the DiT shape on the
    card: PERF.md). For checks only: nothing on the path calls it."""
    return f64_reference(flash_int8_plain, q, k, v, **kw)


# The f32 kernels against their plain versions: max |err| over the largest
# |plain| output, relative RMS, lse in log2 units. A single-pass TF32
# product (10-bit mantissa, about 1e-3 relative) is far outside them. Set
# from the readings of the first f32 kernels (FFMA, whose sums ran in the
# f32 plain versions' own order), about twice them. Every f32 kernel is
# held to its plain version in float64: the exact forward and the backward
# by f64_reference, the int8-score forms by int8_f64_reference (codes and
# scores in f32, as the kernels make them).
F32_TOL = {"fwd": {"max_rel": 1e-5, "rel_rms": 5e-6, "lse": 1e-5},
           "bwd": {"max_rel": 2e-6, "rel_rms": 1e-6}}


# A tile's row sum of the bf16 p, rounded to bf16 on both sides from f32
# sums taken in another order, may round the other way: l moves by at most
# this much, relative.
TILE_SUM_REL = 2.0 ** -7
# The exp_bf16 variants against the plain version proper (the true 2^x):
# every p is off by up to the card exp2's error, and with int8_pv that
# flips codes of rint(127 p). Readings on an H100 (the cuda tests' small
# shapes and chip_smoke.py's main shapes): max |err| at most 1.5 bf16
# steps at the largest |plain| output, relative RMS error 3.7e-3 (1.4e-2
# with int8_pv). The limits are about twice the readings.
EXP2_TRUE_TOL_STEPS = 3.0
EXP2_TRUE_TOL_RMS = {False: 1e-2, True: 3e-2}   # by int8_pv


def card_exp2_error(device: str) -> tuple[float, float]:
    """e: the largest relative error of the card's bf16 exp2
    (card_exp2_table) against 2^x over every bf16 x in [-126, 0], where
    2^x is a normal number; and the share of those inputs on which it is
    not 2^x rounded to bf16."""
    table = card_exp2_table(device).double().cpu()
    bits = torch.arange(65536, dtype=torch.int32)
    x = torch.where(bits >= 32768, bits - 65536, bits).to(torch.int16) \
        .view(torch.bfloat16).double()
    sel = (x >= -126) & (x <= 0)
    true = torch.exp2(x[sel])
    rel = ((table[sel] - true).abs() / true).max().item()
    differ = (table[sel] != true.bfloat16().double()).double().mean().item()
    return rel, differ


def variant_limits(ref, v, *, int8_pv: bool, exp_bf16: bool,
                   tol_steps: float, tol_rms: float, lse_tol: float) -> dict:
    """Limits of a forward kernel against its plain version `ref` (from
    inputs with values `v`), from the caller's base limits (tol_steps bf16
    steps at the largest |ref|, relative RMS tol_rms, lse_tol in log2
    units), widened by what the variant's arithmetic moves:
      - int8_pv: a p8 = rint(127 p) that rounds the other way on one side
        (127 p within an f32 ulp of a half) moves out by at most sv, the V
        block's scale (|v8| <= 127 and l >= 1); max |err| may take two.
      - exp_bf16 is held twice. Against the plain version with the card's
        own exp2 (exp2_table=card_exp2_table), under "card": the same p on
        both sides, a tile sum that may round the other way (TILE_SUM_REL):
        two more bf16 steps and log2(1 + TILE_SUM_REL) more in lse.
        Against the plain version proper: EXP2_TRUE_TOL_STEPS and
        EXP2_TRUE_TOL_RMS from the readings, and lse within log2(1 + e)
        + log2(1 + TILE_SUM_REL) more, e the card exp2's error.
    Returns {"max_abs" (absolute), "rel_rms", "lse"}, with exp_bf16 also
    "card" (the same three), "exp2_rel_err" and "exp2_not_rounded_share"."""
    top = ref.float().abs().max().item()
    step = 2.0 ** (math.frexp(max(top, 2.0 ** -126))[1] - 8)
    base = tol_steps * step
    if int8_pv:
        base += 2 * quantize_v_blocks(
            v, v_block_rows(v.shape[1]))[1].max().item()
    if not exp_bf16:
        return {"max_abs": base, "rel_rms": tol_rms, "lse": lse_tol}
    e, differ = card_exp2_error(str(ref.device))
    tile_lse = math.log2(1 + TILE_SUM_REL)
    return {"max_abs": EXP2_TRUE_TOL_STEPS * step,
            "rel_rms": EXP2_TRUE_TOL_RMS[int8_pv],
            "lse": lse_tol + math.log2(1 + e) + tile_lse,
            "exp2_rel_err": e, "exp2_not_rounded_share": differ,
            "card": {"max_abs": base + 2 * step, "rel_rms": tol_rms,
                     "lse": lse_tol + tile_lse}}


# The f32 exact forward's exp_bf16 variant against the plain version with
# the card's exp2: its 3xTF32 scores differ from the plain version's f32
# ones in their last bits (about 1e-6), so bf16(s - m) now and then rounds
# the other way and that p moves by up to 2^-8 of 1. Readings on an H100
# at the DiT and TiTok shapes (chip_smoke.py): relative RMS error 4.5e-5
# to 6.6e-5 (the int8-score forms, whose scores are the plain version's,
# read 0 to 2.4e-6). The limit is about twice the largest reading.
F32_EXP_BF16_CARD_RMS = 1.5e-4


def f32_variant_limits(ref, v, *, int8: bool, int8_pv: bool,
                       exp_bf16: bool) -> dict:
    """variant_limits for an f32 forward variant, from the f32 limits
    (F32_TOL["fwd"]: max |err| max_rel of the largest |ref|, relative RMS,
    lse), with the exact form's exp_bf16 held against the card's exp2
    within F32_EXP_BF16_CARD_RMS."""
    tol = F32_TOL["fwd"]
    top = max(ref.float().abs().max().item(), 2.0 ** -126)
    step = 2.0 ** (math.frexp(top)[1] - 8)
    lim = variant_limits(ref, v, int8_pv=int8_pv, exp_bf16=exp_bf16,
                         tol_steps=tol["max_rel"] * top / step,
                         tol_rms=tol["rel_rms"], lse_tol=tol["lse"])
    if exp_bf16 and not int8:
        lim["card"]["rel_rms"] = max(lim["card"]["rel_rms"],
                                     F32_EXP_BF16_CARD_RMS)
    return lim


# ---------------------------------------------------------------------------
# CUDA wrappers


@functools.lru_cache(maxsize=32)
def visibility_tables(mask_fn, q_len: int, kv_len: int, device: str,
                      kv_major: bool = False, tiles: tuple | None = None):
    """(count, order, kind) int32 tables on `device` (masks.tile_tables):
    per q tile its visible kv tiles at the forwards' 192 x 128 tiles
    (KERNEL_BLOCK_Q x KERNEL_BLOCK_KV), or with kv_major per kv tile the
    q tiles that see it at the backward's 64 x 128 tiles (BWD_BLOCK_Q x
    BWD_BLOCK_KV); `tiles` (q rows, kv rows) sets other tiles (the f32
    kernels')."""
    if tiles is not None:
        bq, bkv = tiles
    else:
        bq, bkv = ((BWD_BLOCK_Q, BWD_BLOCK_KV) if kv_major
                   else (KERNEL_BLOCK_Q, KERNEL_BLOCK_KV))
    vis = masks_lib.block_visibility(mask_fn, q_len, kv_len, bq, bkv,
                                     device=device)
    tables = masks_lib.tile_tables(vis.T if kv_major else vis)
    return tuple(torch.from_numpy(a).to(device) for a in tables)


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in KERNEL_DTYPES:
            raise TypeError(
                f"the flash kernels take bfloat16 or float32, {name} is "
                f"{t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k, v must share one dtype, {name} is "
                            f"{t.dtype} and q {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous BSHD tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
    B, Sq, H, D = q.shape
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"the flash kernels take head_dim "
                         f"{KERNEL_HEAD_DIM}, got {D}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if B * H > 65535:
        raise ValueError("B * H exceeds the kernel grid")


def _mask_args(mask_fn, Sq: int, Skv: int, dev, kv_major: bool,
               tiles: tuple | None = None):
    """((count, order, kind) pointers, table width, mask descriptor) as
    the kernels take them; no tables for no mask."""
    if mask_fn is None:
        return (None, None, None), 0, (masks_lib.MASK_NONE, 0, 1, 0, 1)
    if not isinstance(mask_fn, masks_lib.MaskSpec):
        raise TypeError("the flash kernels take a MaskSpec (kernel "
                        f"descriptor) or None, got {mask_fn!r}")
    tables = visibility_tables(mask_fn, Sq, Skv, str(dev), kv_major, tiles)
    return (tuple(t.data_ptr() for t in tables), tables[1].shape[1],
            mask_fn.descriptor())


def variant_name(int8: bool, int8_pv: bool = False,
                 exp_bf16: bool = False, f32: bool = False) -> str:
    """The name a forward kernel variant is counted and reported under;
    the f32 forms' end in _f32."""
    return ("flash_fwd_int8" if int8 else "flash_fwd_exact") \
        + ("_pv" if int8_pv else "") + ("_exp_bf16" if exp_bf16 else "") \
        + ("_f32" if f32 else "")


# launches per kernel variant: each wrapper adds one where it launches
FWD_VARIANTS = tuple(variant_name(i8, pv, e) for i8, pv in
                     ((False, False), (True, False), (True, True))
                     for e in (False, True))
# the f32 forms: the exact forward, the int8 one, their int8_pv / exp_bf16
# variants, the backward
F32_VARIANTS = tuple(variant_name(i8, pv, e, f32=True) for i8, pv in
                     ((False, False), (True, False), (True, True))
                     for e in (False, True))
F32_KERNELS = F32_VARIANTS + ("flash_bwd_f32",)
LAUNCHES = dict.fromkeys(FWD_VARIANTS + ("flash_bwd",) + F32_KERNELS, 0)


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launch(q, k, v, mask_fn, scale, int8: bool, int8_pv: bool,
            exp_bf16: bool):
    from landiff_tpu_torch.ops import kernels

    _check_inputs(q, k, v)
    if q.dtype == torch.float32:
        return _launch_f32(q, k, v, mask_fn, scale, int8, int8_pv, exp_bf16)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qscale = float(np.float32(scale * LOG2E))
    dev = q.device
    tables, nk_table, desc = _mask_args(mask_fn, Sq, Skv, dev, False)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = kernels.flash_library()
    # temporaries (k8, sk) may be freed when this returns: the caching
    # allocator hands their memory only to work queued after the kernel on
    # this stream
    with torch.cuda.device(dev):
        if int8:
            k8, sk = quantize_k(k)      # (B, Skv, H, D), (B*H, Skv_pad)
            v_in, vsc, v_block, skv_p = v, None, 0, 0
            if int8_pv:
                v_block = v_block_rows(Skv)
                v_in, vsc = quantize_v_blocks(v, v_block)
                skv_p = v_in.shape[-1]
            rc = lib.landiff_flash_fwd_i8(
                q.data_ptr(), k8.data_ptr(), sk.data_ptr(), v_in.data_ptr(),
                None if vsc is None else vsc.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *tables, B, H, Sq, Skv, nk_table, qscale,
                *desc, v_block, skv_p, int(exp_bf16), stream)
        else:
            rc = lib.landiff_flash_fwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *tables, B, H, Sq, Skv, nk_table, qscale,
                *desc, int(exp_bf16), stream)
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: error {rc} (a "
                           "cudaError; 1000 + a CUresult where a TMA tensor "
                           "map could not be encoded)")
    LAUNCHES[variant_name(int8, int8_pv, exp_bf16)] += 1
    return out, lse


def _launch_f32(q, k, v, mask_fn, scale, int8: bool, int8_pv: bool,
                exp_bf16: bool):
    """The f32 forwards (csrc/flash_f32.cu): the 3xTF32 exact one after its
    split prologues (K hi / lo, V^T hi / lo), or the int8-score one after
    the f32 K quantization prologue and the V^T split (with int8_pv, on V
    codes and scales from quantize_v_blocks, as on the bf16 path)."""
    from landiff_tpu_torch.ops import kernels

    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qscale = float(np.float32(scale * LOG2E))
    dev = q.device
    lib = kernels.flash_f32_library()
    tiles = ((lib.landiff_flash_fwd_i8_f32_block_q(int(int8_pv),
                                                    int(exp_bf16)),
              F32_BLOCK_KV) if int8 else (F32_FWD_BLOCK_Q, F32_BLOCK_KV))
    tables, nk_table, desc = _mask_args(mask_fn, Sq, Skv, dev, False, tiles)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the prologues' temporaries may be freed when this returns: the
    # caching allocator hands their memory only to work queued after the
    # kernel on this stream
    with torch.cuda.device(dev):
        if int8:
            k8, sk = quantize_k(k)
            if int8_pv:   # the V codes (B, H, 64, v_pad) and block scales
                v_block = v_block_rows(Skv)
                v_hi, vsc = quantize_v_blocks(v, v_block)
                v_lo, v_pad = None, v_hi.shape[-1]
            else:         # V^T hi / lo for p.v in 3xTF32
                v_block, vsc = 0, None
                v_pad = masks_lib.round_up(Skv, F32_BLOCK_KV)
                v_hi, v_lo = tf32_split_t(v, v_pad)
            rc = lib.landiff_flash_fwd_i8_f32(
                q.data_ptr(), k8.data_ptr(), sk.data_ptr(), v_hi.data_ptr(),
                None if v_lo is None else v_lo.data_ptr(),
                None if vsc is None else vsc.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *tables, B, H, Sq, Skv, nk_table,
                sk.shape[1], v_pad, qscale, *desc, v_block, int(exp_bf16),
                stream)
        else:
            skv_pad = masks_lib.round_up(Skv, F32_BLOCK_KV)
            k_hi, k_lo = tf32_split(k)
            vt_hi, vt_lo = tf32_split_t(v, skv_pad)
            rc = lib.landiff_flash_fwd_f32(
                q.data_ptr(), k_hi.data_ptr(), k_lo.data_ptr(),
                vt_hi.data_ptr(), vt_lo.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *tables, B, H, Sq, Skv, skv_pad, nk_table,
                qscale, *desc, int(exp_bf16), stream)
    if rc != 0:
        raise RuntimeError(f"f32 flash kernel launch failed: error {rc} (a "
                           "cudaError; 1000 + a CUresult where a TMA tensor "
                           "map could not be encoded)")
    LAUNCHES[variant_name(int8, int8_pv, exp_bf16, f32=True)] += 1
    return out, lse


def flash_fwd_exact(q, k, v, *, mask_fn=None, scale=None,
                    exp_bf16: bool = False):
    """Exact flash forward: (out (B, Sq, H, D), lse (B, H, Sq) log2).
    CUDA tensors launch the kernel; CPU tensors run flash_exact_plain."""
    if q.device.type == "cpu":
        return flash_exact_plain(q, k, v, mask_fn=mask_fn, scale=scale,
                                 exp_bf16=exp_bf16)
    return _launch(q, k, v, mask_fn, scale, False, False, exp_bf16)


def flash_fwd_int8(q, k, v, *, mask_fn=None, scale=None,
                   int8_pv: bool = False, exp_bf16: bool = False):
    """int8-score flash forward: (out, lse). int8_pv: p.v in int8, V
    quantized per block of v_block_rows(Skv) rows. CUDA tensors launch the
    kernel; CPU tensors run flash_int8_plain (at the kernel's kv tile)."""
    if q.device.type == "cpu":
        return flash_int8_plain(q, k, v, mask_fn=mask_fn, scale=scale,
                                int8_pv=int8_pv, exp_bf16=exp_bf16)
    return _launch(q, k, v, mask_fn, scale, True, int8_pv, exp_bf16)


def _check_bwd_inputs(q, out, lse, do):
    B, Sq, H, _ = q.shape
    for name, t in (("out", out), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"tensor like q, got {tuple(t.shape)} {t.dtype}")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous f32 (B, H, Sq) tensor, "
                         f"got {tuple(lse.shape)} {lse.dtype}")


def _launch_bwd_prep(q, out, lse, do, scale):
    from landiff_tpu_torch.ops import kernels

    B, Sq, H, D = q.shape
    dev = q.device
    sq_pad = masks_lib.round_up(Sq, BWD_BLOCK_Q)
    lse_pad = torch.empty((B, H, sq_pad), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse_pad)
    # the f32 backward sums dq across kv tiles in float64
    ws = torch.empty((B, H, sq_pad, D), device=dev,
                     dtype=torch.float64 if q.dtype == torch.float32
                     else torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if q.dtype == torch.float32:   # q' is made in the main kernel
            qs = None
            rc = kernels.flash_f32_library().landiff_flash_bwd_prep_f32(
                out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                lse_pad.data_ptr(), delta.data_ptr(), ws.data_ptr(), B, H,
                Sq, sq_pad, stream)
        else:
            qs = torch.empty_like(q)
            rc = kernels.flash_bwd_library().landiff_flash_bwd_prep(
                q.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                qs.data_ptr(), lse_pad.data_ptr(), delta.data_ptr(),
                ws.data_ptr(), B, H, Sq, sq_pad,
                float(np.float32(scale * LOG2E)), stream)
    if rc != 0:
        raise RuntimeError(f"flash backward prologue launch failed: "
                           f"cudaError {rc}")
    return qs, lse_pad, delta, ws


def flash_bwd_prep(q, out, lse, do, *, scale=None):
    """The backward's prologue alone: (q', padded lse, delta, zeroed dq
    workspace), as flash_bwd_prep_plain returns them. CUDA tensors launch
    landiff_flash_bwd_prep (csrc/flash_bwd.cu), which flash_bwd launches
    before its main kernel and counts with it; for f32 inputs
    landiff_flash_bwd_prep_f32 (csrc/flash_f32.cu), which leaves q' to the
    main kernel (it scales the raw q tile in registers) and returns None
    in its place, with a float64 workspace. CPU tensors run the plain
    version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_bwd_prep_plain(q, out, lse, do, scale=scale)
    do = do.to(q.dtype).contiguous()
    _check_inputs(q, q, q)
    _check_bwd_inputs(q, out, lse, do)
    return _launch_bwd_prep(q, out, lse, do, scale)


def flash_bwd(q, k, v, out, lse, do, *, mask_fn=None, scale=None):
    """Flash backward: (dq, dk, dv) in the inputs' dtypes from the exact
    forward's out and log2 lse (B, H, Sq). CUDA tensors launch the
    prologue (delta, padded lse, q', zeroed dq workspace: the work
    `_flash_bwd_pallas` does outside its kernel, :799) and the main kernel
    (csrc/flash_bwd.cu, or csrc/flash_f32.cu for f32 inputs, after its
    split prologues of K and V), counted once in `LAUNCHES["flash_bwd"]`
    (`"flash_bwd_f32"`); CPU tensors run flash_bwd_plain. The kernel adds
    dq by bulk reduce-adds into the (B, H, Sq_pad, D) workspace (f32;
    float64 for f32 inputs), which dq_from_workspace casts at the end, so
    the last bits of dq may vary from run to run; dk and dv do not."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, do, mask_fn=mask_fn,
                               scale=scale)
    from landiff_tpu_torch.ops import kernels

    do = do.to(q.dtype).contiguous()
    _check_inputs(q, k, v)
    _check_bwd_inputs(q, out, lse, do)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    f32 = q.dtype == torch.float32
    tables, nq_table, desc = _mask_args(
        mask_fn, Sq, Skv, dev, True, (BWD_BLOCK_Q, F32_BLOCK_KV) if f32
        else None)
    qs, lse_pad, delta, ws = _launch_bwd_prep(q, out, lse, do, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if f32:   # the kv side split (K, V) and transposed (K^T) once
            skv_pad = masks_lib.round_up(Skv, F32_BLOCK_KV)
            k_hi, k_lo = tf32_split(k)
            v_hi, v_lo = tf32_split(v)
            kt_hi, kt_lo = tf32_split_t(k, skv_pad)
            rc = kernels.flash_f32_library().landiff_flash_bwd_f32(
                q.data_ptr(), k_hi.data_ptr(), k_lo.data_ptr(),
                v_hi.data_ptr(), v_lo.data_ptr(), kt_hi.data_ptr(),
                kt_lo.data_ptr(), do.data_ptr(), lse_pad.data_ptr(),
                delta.data_ptr(), ws.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *tables, B, H, Sq, Skv, lse_pad.shape[-1],
                skv_pad, nq_table, float(np.float32(scale * LOG2E)),
                float(np.float32(scale)), *desc, stream)
        else:
            rc = kernels.flash_bwd_library().landiff_flash_bwd(
                q.data_ptr(), qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse_pad.data_ptr(), delta.data_ptr(),
                ws.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tables, B, H,
                Sq, Skv, lse_pad.shape[-1], nq_table,
                float(np.float32(scale)), *desc, stream)
    if rc != 0:
        raise RuntimeError(f"flash backward launch failed: error {rc} "
                           "(a cudaError; 1000 + a CUresult where a TMA "
                           "tensor map could not be encoded)")
    LAUNCHES["flash_bwd_f32" if f32 else "flash_bwd"] += 1
    return dq_from_workspace(ws, Sq, q.dtype), dk, dv


# What a layer checkpoint asks of _FlashDiff.forward: nothing (mode None),
# to keep each call's (out, lse) in a list ("record"), or to hand them back
# in call order instead of launching the forward again ("replay")
_REMAT = threading.local()


@contextlib.contextmanager
def _remat_mode(mode: str, store: list):
    prev = getattr(_REMAT, "mode", None)
    _REMAT.mode = (mode, store if mode == "record" else iter(store))
    try:
        yield
    finally:
        _REMAT.mode = prev


def save_flash_residuals_context():
    """A `context_fn` for torch.utils.checkpoint (non-reentrant) that keeps
    the flash forward's out and lse across the checkpoint, JAX's
    LANDIFF_REMAT_SAVE_ATTN policy (dit.py:469: save the tensors tagged
    flash_out / flash_lse, attention.py:842-857; recompute the rest). The
    forward context records each _FlashDiff.forward's (out, lse) in call
    order; the recompute context hands them back instead of launching the
    kernel. The launches are not PyTorch operators, which is why selective
    checkpointing cannot keep them."""
    store: list = []
    return _remat_mode("record", store), _remat_mode("replay", store)


class _FlashDiff(torch.autograd.Function):
    """The differentiable flash route, counterpart of JAX's `_flash_diff`
    (:830-870): the forward is always the exact kernel, with its log2 lse
    saved; the backward is `flash_bwd`. With LANDIFF_ATTN_BWD=xla the
    backward is `flash_bwd_plain` instead, on CUDA tensors too (JAX's
    double-scan oracle `_flash_diff_bwd_xla` under the same knob): a
    choice the caller makes. Without the knob a kernel that fails to build
    or to launch raises."""

    @staticmethod
    def forward(ctx, q, k, v, mask_fn, scale):
        mode = getattr(_REMAT, "mode", None)
        if mode is not None and mode[0] == "replay":
            out, lse = (t.detach() for t in next(mode[1]))
        else:
            out, lse = flash_fwd_exact(q, k, v, mask_fn=mask_fn, scale=scale)
            if mode is not None:
                mode[1].append((out.detach(), lse))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask_fn, ctx.scale = mask_fn, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_bwd_plain
               if os.environ.get("LANDIFF_ATTN_BWD", "pallas") == "xla"
               else flash_bwd)
        dq, dk, dv = bwd(q, k, v, out, lse, do, mask_fn=ctx.mask_fn,
                         scale=ctx.scale)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# dispatcher


def _takes_int8(q_len: int, kv_len: int, head_dim: int, itemsize: int,
                int8_scores: bool) -> bool:
    """flash_attention's rule (:556-565): the int8-score kernel only where
    K/V would be resident ("cached": the pair fits the VMEM budget and
    there is more than one 512-row q block)."""
    block_q = min(512, masks_lib.round_up(q_len, 128))
    block_kv = min(1024, masks_lib.round_up(kv_len, 128))
    nq = masks_lib.round_up(q_len, block_q) // block_q
    kv_p = masks_lib.round_up(kv_len, block_kv)
    cached = (2 * head_dim * kv_p * itemsize <= _KV_CACHE_VMEM_BUDGET
              and nq > 1
              and os.environ.get("LANDIFF_ATTN_CACHED", "1") != "0")
    return int8_scores and cached


def select_path(q_len: int, kv_len: int, head_dim: int,
                itemsize: int) -> str:
    """The JAX package's choice for `attention(impl="auto")` on the TPU
    where nothing is differentiated, as a pure function of shape and
    dtype: "reference" below 2,048 query positions (attention.py:993-995);
    else "int8" where flash_attention takes the int8-score kernel
    (LANDIFF_ATTN_INT8, default on, :1002, and its "cached" rule), else
    "exact"."""
    if q_len < 2048:
        return "reference"
    int8_scores = os.environ.get("LANDIFF_ATTN_INT8", "1") == "1"
    return ("int8" if _takes_int8(q_len, kv_len, head_dim, itemsize,
                                  int8_scores) else "exact")


def _knob(name: str) -> bool:
    return os.environ.get(name) == "1"


def flash_attention(q, k, v, *, mask_fn=None, scale=None,
                    int8_scores: bool | None = None,
                    exp_bf16: bool | None = None,
                    int8_pv: bool | None = None, return_lse: bool = False):
    """The flash forward called directly, as JAX's flash_attention
    (:485-604) is by the SP ring: no autograd, and each option not given
    is read as JAX reads it (:556-561): int8_scores from LANDIFF_ATTN_INT8
    (off unless "1", unlike the dispatcher's default), exp_bf16 from
    LANDIFF_ATTN_EXP_BF16, int8_pv from LANDIFF_ATTN_INT8_PV. int8 scores
    only under the "cached" rule; int8_pv only with int8 scores. Returns
    out (B, Sq, H, D), or (out, lse (B, H, Sq) log2) with return_lse."""
    if int8_scores is None:
        int8_scores = _knob("LANDIFF_ATTN_INT8")
    if exp_bf16 is None:
        exp_bf16 = _knob("LANDIFF_ATTN_EXP_BF16")
    if int8_pv is None:
        int8_pv = _knob("LANDIFF_ATTN_INT8_PV")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _takes_int8(q.shape[1], k.shape[1], q.shape[-1], q.element_size(),
                   bool(int8_scores)):
        out, lse = flash_fwd_int8(q, k, v, mask_fn=mask_fn, scale=scale,
                                  int8_pv=bool(int8_pv),
                                  exp_bf16=bool(exp_bf16))
    else:
        out, lse = flash_fwd_exact(q, k, v, mask_fn=mask_fn, scale=scale,
                                   exp_bf16=bool(exp_bf16))
    return (out, lse) if return_lse else out


def attention(q, k, v, *, mask_fn=None, mask=None, scale=None,
              impl: str = "auto", int8_scores: bool | None = None):
    """Dispatcher, as JAX's (:979-1003). impl: "auto" (the flash route
    from 2,048 query positions, the dense reference below), "xla" (the
    dense reference) or "pallas" (the flash route; the name is JAX's).

    The flash route is differentiable: where grad is enabled and q, k or
    v requires grad it is `_FlashDiff` (exact forward, flash backward).
    Elsewhere int8_scores (default LANDIFF_ATTN_INT8, on) selects the
    int8-score forward under flash_attention's "cached" rule, in its
    int8_pv variant under LANDIFF_ATTN_INT8_PV=1; the exp_bf16 variants
    are never taken here (JAX's `_flash_diff` pins exp_bf16=False, :838)."""
    if impl == "auto":
        impl = "pallas" if q.shape[1] >= 2048 else "xla"
    if impl == "xla":
        return mha_reference(q, k, v, mask=mask, scale=scale,
                             mask_fn=mask_fn)
    if impl != "pallas":
        raise ValueError(f"impl must be auto, xla or pallas, got {impl!r}")
    if mask is not None:
        raise ValueError("the flash route takes mask_fn, not a dense mask")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashDiff.apply(q, k, v, mask_fn, scale)
    if int8_scores is None:
        int8_scores = os.environ.get("LANDIFF_ATTN_INT8", "1") == "1"
    return flash_attention(q, k, v, mask_fn=mask_fn, scale=scale,
                           int8_scores=bool(int8_scores), exp_bf16=False,
                           int8_pv=_knob("LANDIFF_ATTN_INT8_PV"))
