"""Weights and inputs drawn from the run's seed on the device.

A tree spec (the reference's `param_spec`) gives every leaf as (shape,
mean, std), or (shape, mean, std, every, factor): then every `every`-th
entry of the last axis is multiplied by `factor` (outlier channels).
`fill` draws all leaves of a tree in a few large calls: one normal draw
per group of leaves that share those numbers, in chunks of at most 2^30
values, scaled in place; each leaf is a view into its group's buffer. No
leaf is left zero or constant.
"""

from __future__ import annotations

import torch

CHUNK = 2 ** 30


def leaves(spec, path=()):
    """[(path, (shape, mean, std))] in a fixed order."""
    if isinstance(spec, dict):
        out = []
        for k in spec:
            out += leaves(spec[k], path + (k,))
        return out
    if isinstance(spec, list):
        out = []
        for i, v in enumerate(spec):
            out += leaves(v, path + (i,))
        return out
    return [(path, spec)]


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(spec):
    if isinstance(spec, dict):
        return {k: _skeleton(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_skeleton(v) for v in spec]
    return None


def normal(gen, n, device, dtype=torch.float32):
    """n standard normal values from `gen`, in chunks of at most CHUNK."""
    out = torch.empty(n, dtype=dtype, device=device)
    for a in range(0, n, CHUNK):
        b = min(a + CHUNK, n)
        out[a:b] = torch.randn(b - a, generator=gen, device=device,
                               dtype=dtype)
    return out


def fill(spec, gen, device, dtype=torch.float32):
    """The tree of `spec` drawn from `gen` on `device`."""
    groups = {}
    for path, leaf in leaves(spec):
        shape, mean, std = leaf[:3]
        every, factor = leaf[3:] if len(leaf) > 3 else (0, 1.0)
        key = (float(mean), float(std), int(every), float(factor),
               shape[-1] if every else 0)
        groups.setdefault(key, []).append((path, tuple(shape)))
    tree = _skeleton(spec)
    for (mean, std, every, factor, last), members in groups.items():
        sizes = []
        for _, shape in members:
            k = 1
            for s in shape:
                k *= s
            sizes.append(k)
        buf = normal(gen, sum(sizes), device, dtype)
        buf.mul_(std).add_(mean)
        if every:
            buf.view(-1, last)[:, ::every].mul_(factor)
        off = 0
        for (path, shape), k in zip(members, sizes):
            _put(tree, path, buf[off:off + k].view(shape))
            off += k
    return tree
