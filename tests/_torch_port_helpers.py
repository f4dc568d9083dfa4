"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_port_*).

Parameters: `stage2_params()` and `stage1_params()`, the port's own
tiny-config init with its zero leaves filled (so no check passes
vacuously on zero-init gates or the zero-init micro conditioner), handed
to JAX in the JAX package's layouts and to the port back through
`landiff_tpu_torch.bridge`. A jitted JAX init costs seconds of XLA
compile per model; the JAX forward still checks every name and shape of
the tree. Inputs come from numpy seeds and go to both packages as the
same arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from landiff_tpu_torch import bridge
from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch.pipeline import dif_infer as tdi
from landiff_tpu_torch.pipeline import llm_infer as tli
from landiff_tpu_torch.utils import fill_zero_leaves, tree_map

torch.set_num_threads(2)


@functools.lru_cache(maxsize=1)
def stage2_params():
    """(JAX tree, port tree) of the same tiny-config stage-2 parameters:
    the port's init_params with its zero leaves filled (the torch
    counterpart of landiff_tpu/utils.py:130), seed 0."""
    gen = torch.Generator().manual_seed(0)
    tparams = fill_zero_leaves(tdi.init_params(gen, tcfg.tiny_test_config()),
                               gen)
    arrays = to_jax_layout(tparams)
    return (jax.tree_util.tree_map(jnp.asarray, arrays),
            bridge.to_torch(arrays, device="cpu"))


@functools.lru_cache(maxsize=1)
def stage1_params():
    """(JAX tree, port tree) of the same tiny-config stage-1 parameters
    {"lm": {"gpt", "tok_emb", "text_proj", "null_text_embedding",
    "micro"}, "t5"}: the port's init with its zero leaves filled (the
    micro conditioner's output linear is zero-init: unfilled, the prompt
    would ignore frames and motion_score), seed 1."""
    gen = torch.Generator().manual_seed(1)
    cfg = tcfg.tiny_test_config()
    tparams = fill_zero_leaves(tli.init_params(gen, cfg.llm, cfg.t5), gen)
    arrays = to_jax_layout(tparams)
    return (jax.tree_util.tree_map(jnp.asarray, arrays),
            bridge.to_torch(arrays, device="cpu"))


def gumbel_steps(seed: int, steps: int, vocab: int) -> torch.Tensor:
    """The Gumbel noise jax.random.categorical adds at each step of the
    JAX sampler (lm.py:395): key, sub = split(key) once per step from
    PRNGKey(seed), then gumbel(sub, (V,)). Returns (steps, V)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gumbel(sub, (vocab,), jnp.float32)))
    return torch.from_numpy(np.stack(out))


def to_jax_layout(tree):
    """The inverse of the bridge: port tensors -> numpy arrays in the JAX
    package's layouts (OIHW -> HWIO, OIDHW -> (kt, kh, kw, ci, co))."""
    inv = {4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}

    def leaf(t):
        a = t.detach().cpu().numpy()
        return np.transpose(a, inv[a.ndim]) if a.ndim in inv else a

    return tree_map(leaf, tree)


def randn(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def sampler_noises(seed_key, n_steps: int, shape) -> list[torch.Tensor]:
    """The per-step SDE noise the JAX sampler draws inside its scan
    (samplers.py:142, :166): carry key -> split(key, 3) per step."""
    key = seed_key
    out = []
    for _ in range(n_steps):
        key, k_noise, _ = jax.random.split(key, 3)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(k_noise, shape, jnp.float32))))
    return out


def assert_close(got: torch.Tensor, want, *, atol: float, rtol: float):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)
