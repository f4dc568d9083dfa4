"""Structured attention masks (counterpart of landiff_tpu/ops/masks.py).

A mask spec maps index arrays (q_idx, kv_idx) -> bool by pure boolean
algebra, so the same spec evaluates on numpy arrays and on torch tensors
of any device (the plain attention path). Each spec is also a *kernel
descriptor*: `descriptor()` gives a mask kind and the layout integers,
from which the CUDA flash kernel evaluates the same algebra per score
(ops/csrc/flash_fwd.cu, mask_keep); a kernel cannot call a Python
callable.

Sequence layout (I/P-frame TiTok, blocks.py:414-976):
  [ frame patches: num_frames * tokens_per_frame
  | I-frame query tokens: iframe_tokens
  | P-frame query tokens: (num_frames-1) * pframe_tokens ]
Encoder and decoder visibility: see landiff_tpu/ops/masks.py (and
flex_attention_mask.py:150-184, :283-335). Padding rows/cols (beyond
seq_len) are fully masked.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# kinds shared with the kernel's MaskKind
MASK_NONE = 0
MASK_CAUSAL = 1
MASK_VIDEO_ENCODER = 2
MASK_VIDEO_DECODER = 3


@dataclasses.dataclass(frozen=True)
class VideoMaskLayout:
    num_frames: int
    tokens_per_frame: int
    iframe_tokens: int
    pframe_tokens: int

    @property
    def frames_end(self) -> int:
        return self.num_frames * self.tokens_per_frame

    @property
    def iq_end(self) -> int:
        return self.frames_end + self.iframe_tokens

    @property
    def seq_len(self) -> int:
        return self.iq_end + self.pframe_tokens * (self.num_frames - 1)


def _encoder(L: VideoMaskLayout, q_idx, kv_idx):
    q_frame = q_idx // L.tokens_per_frame
    kv_frame = kv_idx // L.tokens_per_frame
    p_frame = (q_idx - L.iq_end) // L.pframe_tokens + 1
    in_frames = kv_frame <= q_frame
    kv_in_iq = (kv_idx >= L.frames_end) & (kv_idx < L.iq_end)
    iq = (kv_idx < L.tokens_per_frame) | (kv_in_iq & (kv_idx <= q_idx))
    pq = (kv_idx < (p_frame + 1) * L.tokens_per_frame) | (
        (kv_idx >= L.frames_end) & (kv_idx <= q_idx))
    return (((q_idx < L.frames_end) & in_frames)
            | ((q_idx >= L.frames_end) & (q_idx < L.iq_end) & iq)
            | ((q_idx >= L.iq_end) & (q_idx < L.seq_len) & pq))


def _decoder(L: VideoMaskLayout, q_idx, kv_idx):
    q_frame = q_idx // L.tokens_per_frame
    kv_frame = kv_idx // L.tokens_per_frame
    p_frame = (q_idx - L.iq_end) // L.pframe_tokens + 1
    sees_f0_and_iq = (kv_idx < L.tokens_per_frame) | (
        (kv_idx >= L.frames_end) & (kv_idx < L.iq_end))
    pfp = (((kv_idx < L.frames_end) & (kv_frame <= q_frame))
           | ((kv_idx >= L.frames_end)
              & (kv_idx < L.iq_end + q_frame * L.pframe_tokens)))
    pq = ((kv_idx < (p_frame + 1) * L.tokens_per_frame)
          | ((kv_idx >= L.frames_end)
             & (kv_idx < L.iq_end + p_frame * L.pframe_tokens)))
    return (((q_idx < L.tokens_per_frame) & sees_f0_and_iq)
            | ((q_idx >= L.tokens_per_frame) & (q_idx < L.frames_end) & pfp)
            | ((q_idx >= L.frames_end) & (q_idx < L.iq_end)
               & sees_f0_and_iq)
            | ((q_idx >= L.iq_end) & (q_idx < L.seq_len) & pq))


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """A hashable mask spec: callable for the plain path, descriptor for
    the kernel."""

    kind: int
    layout: VideoMaskLayout | None = None

    def __call__(self, q_idx, kv_idx):
        if self.kind == MASK_CAUSAL:
            return q_idx >= kv_idx
        if self.kind == MASK_VIDEO_ENCODER:
            return _encoder(self.layout, q_idx, kv_idx)
        if self.kind == MASK_VIDEO_DECODER:
            return _decoder(self.layout, q_idx, kv_idx)
        raise ValueError(f"unknown mask kind {self.kind}")

    def descriptor(self) -> tuple[int, int, int, int, int]:
        """(kind, num_frames, tokens_per_frame, iframe_tokens,
        pframe_tokens) as the kernel reads them."""
        L = self.layout
        if L is None:
            return (self.kind, 0, 1, 0, 1)
        if L.tokens_per_frame < 1 or L.pframe_tokens < 1:
            raise ValueError(f"kernel mask layout needs positive token "
                             f"counts: {L}")
        return (self.kind, L.num_frames, L.tokens_per_frame,
                L.iframe_tokens, L.pframe_tokens)


causal = MaskSpec(MASK_CAUSAL)


def video_encoder_mask(layout: VideoMaskLayout) -> MaskSpec:
    return MaskSpec(MASK_VIDEO_ENCODER, layout)


def video_decoder_mask(layout: VideoMaskLayout) -> MaskSpec:
    return MaskSpec(MASK_VIDEO_DECODER, layout)


@dataclasses.dataclass(frozen=True)
class KvLimit:
    """A spec (or None) with kv columns >= kv_len invisible: the plain
    path's counterpart of padding to block multiples."""

    mask_fn: MaskSpec | None
    kv_len: int

    def __call__(self, q_idx, kv_idx):
        ok = kv_idx < self.kv_len
        return ok if self.mask_fn is None else (self.mask_fn(q_idx, kv_idx)
                                                & ok)


def kv_limit(mask_fn, kv_len: int) -> KvLimit:
    return KvLimit(mask_fn, kv_len)


def _dense_blocks(mask_fn, q_len, kv_len, block_q, block_kv, device):
    """(vis & valid, vis | ~valid) over the block-padded index grid."""
    nq = -(-q_len // block_q)
    nk = -(-kv_len // block_kv)
    q = torch.arange(nq * block_q, device=device)[:, None]
    kv = torch.arange(nk * block_kv, device=device)[None, :]
    valid = (q < q_len) & (kv < kv_len)
    vis = valid if mask_fn is None else (mask_fn(q, kv) & valid)
    return nq, nk, vis, vis | ~valid


def block_visibility(mask_fn, q_len: int, kv_len: int, block_q: int,
                     block_kv: int, device="cpu") -> np.ndarray:
    """Coarsen a mask spec to block granularity, as
    landiff_tpu/ops/masks.block_visibility: int8 (nq, nk) with 0 = fully
    masked (skip), 1 = partial (evaluate the mask per score), 2 = fully
    visible. The last row/column blocks may be partial in size; only their
    in-range entries count. Evaluated with torch on `device`."""
    nq, nk, vis, full = _dense_blocks(mask_fn, q_len, kv_len, block_q,
                                      block_kv, device)
    any_ = vis.reshape(nq, block_q, nk, block_kv).any(3).any(1)
    all_ = full.reshape(nq, block_q, nk, block_kv).all(3).all(1)
    out = torch.where(all_, 2, torch.where(any_, 1, 0)).to(torch.int8)
    return out.cpu().numpy()


def tile_tables(vis: np.ndarray):
    """Per-row (count, order, kind) int32 tables of a block-visibility
    matrix: the visible blocks of each row in ascending order and their
    kind (1 partial, 2 full). Of `vis` (nq, nk) they are the per-q-tile
    tables a forward kernel walks (flash_attention :537-545); of `vis.T`
    the per-kv-tile tables of the backward (_flash_bwd_call :713-724)."""
    n_rows, n_cols = vis.shape
    count = np.zeros((n_rows,), np.int32)
    order = np.zeros((n_rows, n_cols), np.int32)
    kind = np.zeros((n_rows, n_cols), np.int32)
    for r in range(n_rows):
        ids = np.nonzero(vis[r])[0]
        count[r] = len(ids)
        order[r, :len(ids)] = ids
        kind[r, :len(ids)] = vis[r, ids]
    return count, order, kind


def visible_count(mask_fn, q_len: int, kv_len: int, device="cpu") -> int:
    """Number of visible (q, kv) pairs: the work a block-sparse kernel's
    scores need."""
    if mask_fn is None:
        return q_len * kv_len
    _, _, vis, _ = _dense_blocks(mask_fn, q_len, kv_len, 1, 1, device)
    return int(vis.sum())


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m
