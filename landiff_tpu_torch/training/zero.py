"""ZeRO-style sharded optimizer state (counterpart of landiff_tpu/
training/zero.py): every large optimizer-state leaf is split over the
`data` ranks of a mesh, so N-way data parallelism costs about 1/N of the
optimizer memory per rank, while the parameters keep their
tensor-parallel layout.

JAX places the state with sharding constraints and lets GSPMD insert the
reduce-scatter / all-gather around the update. Here a rank keeps its own
slice of each such leaf (`zero_shard_opt_state`) and the update runs on
slices (training/optim.sharded_update): the gradients are all-reduced
over `data`, each rank updates its slice of the moments and of the
parameter, and the parameter slices are all-gathered.
"""

from __future__ import annotations

import torch

from landiff_tpu_torch.utils import tree_leaves, tree_map

MIN_SIZE = 2 ** 16
# the parameter-shaped trees of the trainer's optimizer states
# (optim.ClipAdamW's moments, optim.MultiSteps' accumulator)
PARAM_TREES = ("mu", "nu", "acc_grads")


def _zero_spec(shape, axis_size: int, min_size: int = MIN_SIZE):
    """The dimension to split a leaf of `shape` on (JAX zero.py:15): the
    largest that `axis_size` divides (the later of equal ones), or None
    for leaves of fewer than `min_size` elements (scalars, norms) and
    leaves with no such dimension."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    if not shape or n < min_size:
        return None
    # numpy's argsort(shape)[::-1]: the stable ascending order reversed
    order = sorted(range(len(shape)), key=lambda d: shape[d])[::-1]
    for d in order:
        if shape[d] % axis_size == 0 and shape[d] >= axis_size:
            return d
    return None


def zero_dims(params, axis_size: int, min_size: int = MIN_SIZE):
    """The split dimension of every leaf of a parameter-shaped tree."""
    if axis_size == 1:
        return tree_map(lambda x: None, params)
    return tree_map(lambda x: _zero_spec(x.shape, axis_size, min_size),
                    params)


def zero_slice(tree, dims, axis_size: int, index: int):
    """Rank `index`'s part of every leaf (its 1/axis_size along the leaf's
    split dimension, a copy of its own), the leaves without one whole."""
    def cut(x, d):
        if d is None:
            return x
        n = x.shape[d] // axis_size
        return x.narrow(d, index * n, n).clone()

    return tree_map(cut, tree, dims)


def map_param_trees(fn, opt_state):
    """fn over the parameter-shaped subtrees of an optimizer state (those
    under PARAM_TREES); counts and other entries pass through."""
    if not isinstance(opt_state, dict):
        return opt_state
    return {k: fn(v) if k in PARAM_TREES else map_param_trees(fn, v)
            for k, v in opt_state.items()}


def zero_shard_opt_state(opt_state, params, axis_size: int, index: int,
                         min_size: int = MIN_SIZE):
    """Rank `index`'s slice of a whole optimizer state of `params` over a
    data axis of `axis_size` ranks (JAX `zero_shard_opt_state`, its
    placement: here the slices of a rank are its own tensors)."""
    dims = zero_dims(params, axis_size, min_size)
    return map_param_trees(
        lambda t: zero_slice(t, dims, axis_size, index), opt_state)


def opt_state_bytes_per_device(opt_state, axis_size: int,
                               min_size: int = MIN_SIZE):
    """(bytes on one rank under ZeRO, bytes replicated) of a whole
    optimizer state (JAX `opt_state_bytes_per_device`): a split leaf
    counts 1/axis_size of its bytes. Integer counts are not tensors here
    and count nothing."""
    total = sharded = 0.0
    for x in tree_leaves(opt_state):
        if not isinstance(x, torch.Tensor):
            continue
        nbytes = x.numel() * x.element_size()
        total += nbytes
        split = _zero_spec(x.shape, axis_size, min_size) is not None
        sharded += nbytes / axis_size if split else nbytes
    return int(sharded), int(total)
