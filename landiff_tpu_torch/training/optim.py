"""The trainer's optimizer: global-norm clip, AdamW, warmup-cosine
schedule and gradient accumulation, with the semantics of the optax chain
the JAX package builds (landiff_tpu/training/train.py:63-86):

    optax.chain(clip_by_global_norm(clip), adamw(schedule, weight_decay))
    wrapped in optax.MultiSteps(k) for grad_accum = k > 1

Same call contract as optax: `opt.init(params) -> state`,
`opt.update(grads, state, params) -> (updates, state)`, then
`apply_updates(params, updates)`. What differs from torch.optim.AdamW +
clip_grad_norm_, and is reproduced here:
  - the clip leaves gradients alone while norm < clip and else scales by
    clip / norm (torch: clip / (norm + 1e-6), clamped to 1);
  - the weight decay is the one passed (1e-4), times the scheduled rate;
  - the schedule starts at 0, so the first update changes nothing, and
    counts APPLIED updates;
  - MultiSteps averages k micro-batch gradients (running mean), emits zero
    updates in between, and advances the inner state only when it emits;
  - Adam's moments are kept in the parameter's dtype.
Each leaf's arithmetic runs in f32 and is rounded to the leaf's dtype
once (optax rounds after every operation in bf16); the state's tensors
are updated IN PLACE and the state's counts are Python ints.
"""

from __future__ import annotations

import math

import torch

from landiff_tpu_torch.utils import tree_leaves, tree_map


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float):
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    init_value to peak_value over warmup_steps, then a cosine to end_value
    at decay_steps, constant after."""
    cos_steps = decay_steps - warmup_steps
    alpha = end_value / peak_value if peak_value else 0.0

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32."""
    return torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(tree)))


class ClipAdamW:
    """clip_by_global_norm(clip) then adamw(schedule, weight_decay)."""

    def __init__(self, schedule, *, weight_decay: float, clip: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay, self.clip = weight_decay, clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        norm = global_norm(grads)
        # optax: untouched below the limit, else (g / norm) * clip
        factor = torch.where(norm < self.clip, torch.ones_like(norm),
                             self.clip / norm)
        count = state["count"] + 1
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        step = -self.schedule(state["count"])

        def leaf(g, mu, nu, p):
            g = g.float() * factor
            m = (1.0 - self.b1) * g + self.b1 * mu.float()
            v = (1.0 - self.b2) * g.square() + self.b2 * nu.float()
            mu.copy_(m)
            nu.copy_(v)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            u = u + self.weight_decay * p.float()
            return (u * step).to(p.dtype)

        updates = tree_map(leaf, grads, state["mu"], state["nu"], params)
        state["count"] = count
        return updates, state


class MultiSteps:
    """optax.MultiSteps(opt, every_k_schedule=k): a running mean of k
    micro-batch gradients; zero updates until the k-th, which applies the
    inner optimizer to the mean."""

    def __init__(self, opt, every_k: int):
        self.opt, self.every_k = opt, every_k

    def init(self, params):
        return {"mini_step": 0, "gradient_step": 0,
                "inner": self.opt.init(params),
                "acc_grads": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        n = state["mini_step"]
        tree_map(lambda g, acc: acc.add_((g.float() - acc.float())
                                         / (n + 1)),
                 grads, state["acc_grads"])
        emit = n == self.every_k - 1
        state["mini_step"] = (n + 1) % self.every_k
        if not emit:
            return tree_map(torch.zeros_like, params), state
        updates, state["inner"] = self.opt.update(state["acc_grads"],
                                                  state["inner"], params)
        tree_map(torch.Tensor.zero_, state["acc_grads"])
        state["gradient_step"] += 1
        return updates, state


@torch.no_grad()
def apply_updates(params, updates):
    """optax.apply_updates: p + u in the parameter's dtype."""
    return tree_map(lambda p, u: (p + u.to(p.dtype)).to(p.dtype), params,
                    updates)


def require_grad(params):
    """The tree with every leaf detached and requiring grad (a step's
    differentiated argument)."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def grad(loss: torch.Tensor, params):
    """d loss / d params as a tree like params (jax.grad's result); a leaf
    the loss does not reach gets zeros."""
    grads = iter(torch.autograd.grad(loss, tree_leaves(params),
                                     allow_unused=True))

    def leaf(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return tree_map(leaf, params)
