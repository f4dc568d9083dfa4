"""Parameter EMA, the LitEma equivalent (counterpart of
landiff_tpu/training/ema.py; reference sgm/modules/ema.py:1-88).

The state is a dict {"shadow": a tree like params of f32 tensors,
"num_updates": int}; `ema_update` updates the shadow IN PLACE and returns
the state (the optimizer's convention, training/optim.py). Semantics kept:
  - warmup: effective decay = min(decay, (1+n)/(10+n)) while
    num_updates >= 0 (ema.py:38-40); use_num_updates=False pins the decay
    (num_updates = -1);
  - update: shadow -= (1 - decay) * (shadow - param) (ema.py:42-54), in
    f32, the decay computed in f32 as the JAX function does;
  - copy_to: the shadow cast to each param's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from landiff_tpu_torch.utils import tree_map


def init_ema(params, use_num_updates: bool = True) -> dict:
    return {"shadow": tree_map(lambda p: p.detach().float().clone(), params),
            "num_updates": 0 if use_num_updates else -1}


def effective_decay(num_updates: int, decay: float) -> np.float32:
    """The warmup-limited decay of the update that makes num_updates."""
    if num_updates < 0:
        return np.float32(decay)
    warm = np.float32(1.0 + num_updates) / np.float32(10.0 + num_updates)
    return min(np.float32(decay), warm)


@torch.no_grad()
def ema_update(state: dict, params, decay: float = 0.9999) -> dict:
    """One EMA step (LitEma.forward, ema.py:35-54)."""
    n = state["num_updates"]
    n = n + 1 if n >= 0 else n
    one_minus = float(np.float32(1.0) - effective_decay(n, decay))
    tree_map(lambda s, p: s.sub_(one_minus * (s - p.float())),
             state["shadow"], params)
    state["num_updates"] = n
    return state


def copy_to(state: dict, params):
    """LitEma.copy_to: the shadow cast back to each param's dtype."""
    return tree_map(lambda s, p: s.to(p.dtype), state["shadow"], params)
