"""Shared helpers (counterpart of landiff_tpu/utils.py, the parts stage 2
needs): run-stable seeds, parameter-tree walks and the zero-leaf fill."""

from __future__ import annotations

import hashlib

import torch


def stable_hash(key: str) -> int:
    """Run-stable hash (reference utils.py:317-324): first 20 hex digits of
    sha256, as an int. Used to derive per-prompt seeds."""
    return int(hashlib.sha256(key.encode()).hexdigest()[:20], 16)


def seed_from_text(text: str, seed: int) -> int:
    """Combined seed used by the diffusion stage (dif_infer.py:190-194)."""
    return (stable_hash(text) + seed) % (2**31)


def tree_map(fn, tree):
    """Apply fn to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def count_params(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def fill_zero_leaves(tree, generator: torch.Generator, scale: float = 0.02):
    """Replace all-zero floating tensors with small random normals (the
    counterpart of landiff_tpu/utils.py:130).

    LanDiff zero-inits its gating parameters (DiT adaLN tables, ControlNet
    zero linears, the semantic conditioner's conv_out), so a freshly
    initialised model's output does not depend on attention, the MLP or
    the control path. Fill them before any check that should see those
    paths. Draws come from `generator`, which must live on the leaves'
    device."""

    def fill(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and leaf.numel() > 0 and not bool(leaf.any())):
            noise = torch.randn(leaf.shape, generator=generator,
                                device=leaf.device, dtype=torch.float32)
            return (noise * scale).to(leaf.dtype)
        return leaf

    return tree_map(fill, tree)
