"""Stochastic-rounding bf16 parameter updates (counterpart of
landiff_tpu/training/sr.py).

Pure-bf16 master weights stall once an update is smaller than about 2^-8
of the parameter: round-to-nearest throws it away every step. Stochastic
rounding keeps the masters in bf16 and makes the rounding unbiased, so
that updates below one step accumulate in expectation.

Mechanism: add 16 uniform random low bits to the f32 bit pattern, then
truncate the mantissa to bf16's 7 explicit bits; carries propagate into
the exponent, which is "round up to the next representable" at binade
boundaries. The bits come from a `torch.Generator`, or are handed in (a
tree of integer tensors shaped like the parameters, values in [0, 2^16)),
which is how a test feeds both packages the same bits.
"""

from __future__ import annotations

import torch

from landiff_tpu_torch.utils import tree_map

_HIGH16 = -65536          # 0xFFFF0000 as int32


def stochastic_round_bf16(v: torch.Tensor, rng) -> torch.Tensor:
    """f32 tensor -> bf16 with unbiased stochastic rounding. rng: a
    torch.Generator on v's device, or the noise bits themselves."""
    v = v.float()
    if isinstance(rng, torch.Generator):
        noise = torch.randint(0, 1 << 16, v.shape, generator=rng,
                              device=v.device, dtype=torch.int32)
    else:
        noise = rng.to(device=v.device, dtype=torch.int32)
    bits = v.view(torch.int32)
    # int32 addition wraps like the uint32 addition of the JAX source.
    # NaN / Inf stay exact: noise added to an all-ones exponent could turn
    # Inf into NaN
    rounded = torch.where(torch.isfinite(v), bits + noise, bits) & _HIGH16
    return rounded.view(torch.float32).to(torch.bfloat16)


@torch.no_grad()
def apply_updates_sr(params, updates, rng):
    """apply_updates with stochastic rounding on bf16 leaves: param +
    update in f32, rounded back stochastically; other leaves get the plain
    add. rng: one torch.Generator for every leaf, or a tree of noise bits
    like params."""

    def leaf(p, u, r):
        if p.dtype != torch.bfloat16:
            return (p + u.to(p.dtype)).to(p.dtype)
        return stochastic_round_bf16(p.float() + u.float(), r)

    if isinstance(rng, torch.Generator):
        return tree_map(lambda p, u: leaf(p, u, rng), params, updates)
    return tree_map(leaf, params, updates, rng)
