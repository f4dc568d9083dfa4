"""Attention (counterpart of landiff_tpu/ops/attention.py).

Layout: (batch, seq, heads, head_dim), BSHD, everywhere.

  - `mha_reference`: the dense oracle (f32 softmax, fully masked rows -> 0,
    sum floor 1e-6), what JAX's `xla` path runs.
  - `flash_fwd_exact` / `flash_fwd_int8`: the two flash forwards. On a CUDA
    tensor each launches its hand-written kernel (csrc/flash_fwd.cu) and
    counts the launch in its `launches` attribute; on a CPU tensor it runs
    its plain PyTorch version (`flash_exact_plain` / `flash_int8_plain`),
    which repeats the kernel's arithmetic tile by tile.
  - `attention`: the dispatcher, with the JAX selection rules as a pure
    function of shape and dtype (`select_path`), so that the same shapes
    take the same numeric path in both packages.

The kernels replace the Pallas kernels `_flash_kernel` (:91),
`_flash_kernel_cached` (:197) and `_flash_kernel_cached_i8` (:264) of
landiff_tpu/ops/attention.py; see csrc/flash_fwd.cu for their bounds on
the H100 and the design.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from landiff_tpu_torch.ops import masks as masks_lib

NEG_INF = -1e30
LOG2E = 1.4426950408889634

# the CUDA kernel's tiles (csrc/flash_fwd.cu kBQ / kBKV / kD); the plain
# versions use the same kv tile so both round p at the same running max
KERNEL_BLOCK_Q = 64
KERNEL_BLOCK_KV = 64
KERNEL_HEAD_DIM = 64

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


# ---------------------------------------------------------------------------
# plain versions of the kernels


def _flash_plain(q, k, v, mask_fn, scale, int8: bool, block_kv: int):
    """Online-softmax flash forward over kv tiles of `block_kv`, all q rows
    at once, in the kernels' arithmetic (log2 domain, masked scores -1e30,
    p cast to v.dtype for p.v, out = acc / max(l, 1e-30)). Tiles a row
    cannot see change nothing (their p is 0 and alpha is 1), so skipping
    them, as the kernels do, gives the same numbers."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qscale = _f32(scale * LOG2E, q.device)
    dev = q.device
    if int8:
        codes, sq = quantize_q_rows(q, float(scale * LOG2E))
        qq = codes.permute(0, 2, 1, 3)                  # (B, H, Sq, D)
        sq = sq.permute(0, 2, 1, 3)                     # (B, H, Sq, 1)
        k8, sk = quantize_k_positions(k)
        kk = k8.float().permute(0, 2, 3, 1)             # (B, H, D, Skv)
        sk = sk.permute(0, 2, 1)                        # (B, H, Skv)
    else:
        qq = (q.float() * qscale).to(q.dtype).float().permute(0, 2, 1, 3)
        kk = k.float().permute(0, 2, 3, 1)
    vv = v.permute(0, 2, 1, 3)                          # (B, H, Skv, D)
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
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
        p = torch.exp2(s - m_new)
        if keep is not None:
            p = p * keep
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vv[:, :, j0:j1].float()
        m = m_new
    out = (acc / l.clamp_min(1e-30)).to(q.dtype).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log2(l.clamp_min(1e-30)),
                      NEG_INF)[..., 0]
    return out.contiguous(), lse


def flash_exact_plain(q, k, v, *, mask_fn=None, scale=None,
                      block_kv: int = KERNEL_BLOCK_KV):
    """Plain version of the exact kernel (_flash_kernel / _cached):
    returns (out (B, Sq, H, D) q.dtype, lse (B, H, Sq) f32 log2)."""
    return _flash_plain(q, k, v, mask_fn, scale, False, block_kv)


def flash_int8_plain(q, k, v, *, mask_fn=None, scale=None,
                     block_kv: int = KERNEL_BLOCK_KV):
    """Plain version of the int8-score kernel (_flash_kernel_cached_i8,
    int8_pv off): returns (out, lse) like flash_exact_plain."""
    return _flash_plain(q, k, v, mask_fn, scale, True, block_kv)


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


# ---------------------------------------------------------------------------
# CUDA wrappers


@functools.lru_cache(maxsize=32)
def visibility_tables(mask_fn, q_len: int, kv_len: int, device: str):
    """Per-q-tile (count, order, kind) int32 tables at the kernel's tiles:
    the visible kv tiles of each q tile in ascending order and their kind
    (1 partial, 2 full)."""
    vis = masks_lib.block_visibility(mask_fn, q_len, kv_len, KERNEL_BLOCK_Q,
                                     KERNEL_BLOCK_KV, device=device)
    nq, nk = vis.shape
    count = np.zeros((nq,), np.int32)
    order = np.zeros((nq, nk), np.int32)
    kind = np.zeros((nq, nk), np.int32)
    for i in range(nq):
        ids = np.nonzero(vis[i])[0]
        count[i] = len(ids)
        order[i, :len(ids)] = ids
        kind[i, :len(ids)] = vis[i, ids]
    return tuple(torch.from_numpy(a).to(device) for a in (count, order, kind))


def _check_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash kernels take bfloat16, {name} is "
                            f"{t.dtype}")
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


def _launch(q, k, v, mask_fn, scale, int8: bool):
    from landiff_tpu_torch.ops import kernels

    _check_inputs(q, k, v)
    if mask_fn is not None and not isinstance(mask_fn, masks_lib.MaskSpec):
        raise TypeError("the flash kernels take a MaskSpec (kernel "
                        f"descriptor) or None, got {mask_fn!r}")
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qscale = float(np.float32(scale * LOG2E))
    dev = q.device
    if mask_fn is None:
        count = order = kind = None
        nk_table = 0
        desc = (masks_lib.MASK_NONE, 0, 1, 0, 1)
    else:
        count, order, kind = visibility_tables(mask_fn, Sq, Skv, str(dev))
        nk_table = order.shape[1]
        desc = mask_fn.descriptor()
    ptr = lambda t: None if t is None else t.data_ptr()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = kernels.flash_library()
    # temporaries (k8, sk) may be freed when this returns: the caching
    # allocator hands their memory only to work queued after the kernel on
    # this stream
    with torch.cuda.device(dev):
        if int8:
            k8, sk = quantize_k_positions(k)     # (B, Skv, H, D), (B, Skv, H)
            sk = sk.contiguous()
            rc = lib.landiff_flash_fwd_i8(
                q.data_ptr(), k8.data_ptr(), sk.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), ptr(count), ptr(order),
                ptr(kind), B, H, Sq, Skv, nk_table, qscale, *desc, stream)
        else:
            rc = lib.landiff_flash_fwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), ptr(count), ptr(order), ptr(kind), B, H, Sq,
                Skv, nk_table, qscale, *desc, stream)
    if rc != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError {rc}")
    return out, lse


def flash_fwd_exact(q, k, v, *, mask_fn=None, scale=None):
    """Exact flash forward: (out (B, Sq, H, D), lse (B, H, Sq) log2).
    CUDA tensors launch the kernel; CPU tensors run flash_exact_plain."""
    if q.device.type == "cpu":
        return flash_exact_plain(q, k, v, mask_fn=mask_fn, scale=scale)
    out = _launch(q, k, v, mask_fn, scale, int8=False)
    flash_fwd_exact.launches += 1
    return out


def flash_fwd_int8(q, k, v, *, mask_fn=None, scale=None):
    """int8-score flash forward: (out, lse). CUDA tensors launch the
    kernel; CPU tensors run flash_int8_plain."""
    if q.device.type == "cpu":
        return flash_int8_plain(q, k, v, mask_fn=mask_fn, scale=scale)
    out = _launch(q, k, v, mask_fn, scale, int8=True)
    flash_fwd_int8.launches += 1
    return out


flash_fwd_exact.launches = 0
flash_fwd_int8.launches = 0


def reset_launch_counts():
    flash_fwd_exact.launches = 0
    flash_fwd_int8.launches = 0


# ---------------------------------------------------------------------------
# dispatcher


def select_path(q_len: int, kv_len: int, head_dim: int,
                itemsize: int) -> str:
    """The JAX package's choice for `attention(impl="auto")` on the TPU,
    as a pure function of shape and dtype: "reference" below 2,048 query
    positions (attention.py:993-995); else "int8" where flash_attention
    takes the int8-score kernel (LANDIFF_ATTN_INT8, default on, :1002, and
    its "cached" rule, :562-565), else "exact"."""
    if q_len < 2048:
        return "reference"
    int8_scores = os.environ.get("LANDIFF_ATTN_INT8", "1") == "1"
    block_q = min(512, masks_lib.round_up(q_len, 128))
    block_kv = min(1024, masks_lib.round_up(kv_len, 128))
    nq = masks_lib.round_up(q_len, block_q) // block_q
    kv_p = masks_lib.round_up(kv_len, block_kv)
    cached = (2 * head_dim * kv_p * itemsize <= _KV_CACHE_VMEM_BUDGET
              and nq > 1
              and os.environ.get("LANDIFF_ATTN_CACHED", "1") != "0")
    return "int8" if int8_scores and cached else "exact"


def attention(q, k, v, *, mask_fn=None):
    """Dispatcher: the dense reference or a flash forward, chosen as the
    JAX package chooses (`select_path`); softmax scale 1/sqrt(D)."""
    path = select_path(q.shape[1], k.shape[1], q.shape[-1],
                       q.element_size())
    if path == "reference":
        return mha_reference(q, k, v, mask_fn=mask_fn)
    for knob in ("LANDIFF_ATTN_INT8_PV", "LANDIFF_ATTN_EXP_BF16"):
        if os.environ.get(knob) == "1":
            raise NotImplementedError(
                f"{knob}=1 selects a flash variant the port has not "
                "ported yet")
    fn = flash_fwd_int8 if path == "int8" else flash_fwd_exact
    return fn(q.contiguous(), k.contiguous(), v.contiguous(),
              mask_fn=mask_fn)[0]
