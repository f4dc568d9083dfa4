"""Text tokenization for the T5 encoder (counterpart of
landiff_tpu/pipeline/text.py).

A real tokenizer is loaded only from a local checkpoint directory that
exists (never fetched). Without one, the JAX package's deterministic
byte-level fallback is used, so runs with random weights work offline.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("landiff_tpu_torch.text")


class T5Text:
    """tokenize_padded equivalent: left padding for stage 1
    (text_encoder.py:39), max-length padding for stage 2
    (encoders/modules.py:282)."""

    def __init__(self, model_dir: str | None = None, max_length: int = 512,
                 padding_side: str = "left", vocab_size: int = 32128):
        self.max_length = max_length
        self.padding_side = padding_side
        self.vocab_size = vocab_size
        self.tokenizer = None
        if model_dir and Path(model_dir).is_dir():
            # an unreadable tokenizer directory is an error, not a fallback
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(
                model_dir, local_files_only=True)
        elif model_dir:
            logger.warning("T5 tokenizer directory %r not found; using the "
                           "byte-level fallback tokenizer", model_dir)

    def __call__(self, texts: list[str], pad_to_max: bool = False):
        """Returns (input_ids (B, L) int32, attn_mask (B, L) bool)."""
        if self.tokenizer is not None:
            enc = self.tokenizer(
                texts, max_length=self.max_length, truncation=True,
                padding="max_length" if pad_to_max else "longest",
                return_attention_mask=True)
            ids = np.asarray(enc["input_ids"], np.int32)
            mask = np.asarray(enc["attention_mask"], bool)
            if self.padding_side == "left" and not pad_to_max:
                ids, mask = _left_align_pad(ids, mask)
            return ids, mask
        return self._fallback(texts, pad_to_max)

    def _fallback(self, texts, pad_to_max):
        """Deterministic byte-hash tokenizer (offline smoke only)."""
        seqs = []
        for t in texts:
            b = t.encode()[: self.max_length - 1]
            ids = [(c * 2654435761) % (self.vocab_size - 2) + 2 for c in b]
            ids.append(1)  # eos
            seqs.append(ids)
        L = self.max_length if pad_to_max else max(len(s) for s in seqs)
        ids = np.zeros((len(seqs), L), np.int32)
        mask = np.zeros((len(seqs), L), bool)
        for i, s in enumerate(seqs):
            if self.padding_side == "left" and not pad_to_max:
                ids[i, L - len(s):] = s
                mask[i, L - len(s):] = True
            else:
                ids[i, :len(s)] = s
                mask[i, :len(s)] = True
        return ids, mask


def _left_align_pad(ids, mask):
    out_ids = np.zeros_like(ids)
    out_mask = np.zeros_like(mask)
    L = ids.shape[1]
    for i in range(ids.shape[0]):
        n = int(mask[i].sum())
        out_ids[i, L - n:] = ids[i, :n]
        out_mask[i, L - n:] = True
    return out_ids, out_mask
