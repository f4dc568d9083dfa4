"""Packed-sequence utilities for training (counterpart of
landiff_tpu/ops/packing.py; reference landiff/modules/packed_seq.py
PackedSeqlens, the flash-attn varlen cu_seqlens holder). Packing is
expressed as segment ids and a mask callable over index arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PackedSeqlens:
    """cu_seqlens semantics (packed_seq.py:6-24): the cumulative sequence
    boundaries of a packed batch."""

    seqlens: tuple[int, ...]

    @property
    def cu_seqlens(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.seqlens)]).astype(np.int32)

    @property
    def total(self) -> int:
        return int(sum(self.seqlens))

    def segment_ids(self) -> np.ndarray:
        """(total,) int32 segment id per token."""
        return np.repeat(np.arange(len(self.seqlens), dtype=np.int32),
                         self.seqlens)

    def position_ids(self) -> np.ndarray:
        """(total,) position within each segment (for rope tables,
        get_freqs_cis_by_seqlens, pos_emb.py:108-123)."""
        return np.concatenate([np.arange(n) for n in self.seqlens]).astype(
            np.int32)


def packed_causal_mask(seqlens: tuple[int, ...]):
    """(q_idx, kv_idx) -> bool: causal within each packed segment, nothing
    across segments; the segment of an index is computed from the static
    boundaries, so it evaluates on numpy arrays and on tensors of any
    device. It is a mask callable for `attention.mha_reference` and the
    flash kernels' plain versions; the CUDA kernels take only the mask
    specs of ops/masks.py and raise on it."""
    bounds = tuple(int(b) for b in PackedSeqlens(seqlens).cu_seqlens[1:-1])

    def seg_of(i):
        s = i * 0
        for b in bounds:
            s = s + (i >= b) * 1
        return s

    def fn(q_idx, kv_idx):
        return (seg_of(q_idx) == seg_of(kv_idx)) & (q_idx >= kv_idx)

    return fn
