"""General interleaved token / feature sequence builder (counterpart of
landiff_tpu/models/token_sequence.py; reference llm/modules/tokens.py:
7-171, Vocab and TokenSequence).

The stage-1 sampler (models/lm.py) uses precomputed schedule arrays; this
is the general host-side builder the reference exposes for building
training data: tokens, injected feature spans, loss masks, named ranges
and batch collation. Tokens and masks are numpy; features may be numpy
arrays or tensors and come out as tensors.
"""

from __future__ import annotations

import numpy as np
import torch

IGNORE_INDEX = -100   # F.cross_entropy's default (tokens.py:32-33)


class Vocab:
    """Composable vocab: named contiguous id ranges and named special ids,
    allocated in call order (tokens.py:7-26). Specials are attributes:
    ``v.EOS``."""

    def __init__(self):
        self._range: dict[str, tuple[int, int]] = {}
        self._specials: dict[str, int] = {}
        self._size = 0

    def size(self) -> int:
        return self._size

    def add_special(self, name: str):
        self._specials[name] = self._size
        self._size += 1

    def add_range(self, name: str, size: int):
        if not isinstance(size, int) or size <= 0:
            raise ValueError(f"range size must be a positive int: {size!r}")
        self._range[name] = (self._size, self._size + size)
        self._size += size

    def range(self, name: str) -> tuple[int, int]:
        return self._range[name]

    def __getattr__(self, name):
        try:
            return self.__dict__["_specials"][name]
        except KeyError:
            raise AttributeError(name) from None


class TokenSequence:
    """Raw tokens (IGNORE_INDEX where a span is features only), feature
    spans and per-position loss masks, with named ranges; `collate`
    builds [N, L] tokens, [N, L, D] features and the [N, L] loss mask
    (tokens.py:29-171)."""

    IGNORE_INDEX = IGNORE_INDEX

    def __init__(self):
        self._tokens: list[np.ndarray] = []
        self._features: list = []          # None or a (len, D) array
        self._loss_mask: list[np.ndarray] = []
        self._ranges: dict[str, tuple[int, int]] = {}
        self._length = 0

    def __len__(self) -> int:
        return self._length

    def _note_range(self, name, start):
        if name:
            assert name not in self._ranges, name
            self._ranges[name] = (start, len(self))

    @property
    def ranges(self) -> dict[str, tuple[int, int]]:
        return dict(self._ranges)

    def append_token(self, tokens, loss_mask, *, name: str | None = None):
        start = len(self)
        tokens = np.asarray(tokens)
        assert tokens.ndim == 1, tokens.shape
        assert np.issubdtype(tokens.dtype, np.integer), tokens.dtype
        if isinstance(loss_mask, (bool, np.bool_)):
            loss_mask = np.full((len(tokens),), bool(loss_mask))
        else:
            loss_mask = np.asarray(loss_mask)
            assert loss_mask.dtype == np.bool_, loss_mask.dtype
            assert len(loss_mask) == len(tokens), (len(loss_mask),
                                                   len(tokens))
        self._tokens.append(tokens.astype(np.int64))
        self._loss_mask.append(loss_mask)
        self._features.append(None)
        self._length += len(tokens)
        self._note_range(name, start)

    def append_feature(self, feature, *, name: str | None = None):
        start = len(self)
        assert feature.ndim == 2, feature.shape
        n = feature.shape[0]
        self._features.append(feature)
        self._loss_mask.append(np.zeros((n,), bool))
        self._tokens.append(np.full((n,), self.IGNORE_INDEX, np.int64))
        self._length += n
        self._note_range(name, start)

    def append_token_and_feature(self, token, feature, loss_mask, *,
                                 name: str | None = None):
        self.append_token(token, loss_mask, name=name)
        if feature is not None:
            assert len(feature) == len(self._tokens[-1])
            assert feature.ndim == 2, feature.shape
            self._features[-1] = feature

    def get_tokens(self) -> np.ndarray:
        return np.concatenate(self._tokens, axis=0)

    def get_loss_mask(self) -> np.ndarray:
        return np.concatenate(self._loss_mask, axis=0)

    def get_features(self, embedding=None) -> torch.Tensor:
        """The (L, D) features; token-only spans are looked up in
        `embedding`, a (V, D) table (tokens.py:144-154)."""
        feats = []
        for tokens, f in zip(self._tokens, self._features):
            if f is None:
                assert embedding is not None, \
                    "embedding required for token-only spans"
                table = torch.as_tensor(embedding)
                f = table[torch.as_tensor(tokens, device=table.device)]
            feats.append(torch.as_tensor(f))
        return torch.cat(feats, dim=0)

    @staticmethod
    def collate(sequences: list["TokenSequence"], embedding=None):
        """Stack sequences of one length into [N, L] tokens, [N, L, D]
        features and the [N, L] loss mask (tokens.py:156-171; as in the
        JAX package, an embedding table may be passed so that token-only
        spans need no explicit features)."""
        lengths = {len(s) for s in sequences}
        assert len(lengths) == 1, lengths
        tokens = np.stack([s.get_tokens() for s in sequences])
        features = torch.stack([s.get_features(embedding)
                                for s in sequences])
        loss_mask = np.stack([s.get_loss_mask() for s in sequences])
        return tokens, features, loss_mask
