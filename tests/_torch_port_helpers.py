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


def train_dit_params(control_dtype=None):
    """(JAX trees, port trees) of the stage-2 trainer's three parameter
    sets, {"main", "control", "semantic"}, from stage2_params: zero leaves
    filled, so that a fresh control branch's zero linears do not cut every
    gradient off and the main layers' part of the backward is held to
    something. control_dtype: cast the control branch (bf16 masters)."""
    jparams, tparams = stage2_params()
    names = ("main", "control", "semantic")
    jp, tp = {k: jparams[k] for k in names}, {k: tparams[k] for k in names}
    if control_dtype is not None:
        jdt, tdt = control_dtype
        jp["control"] = jax.tree_util.tree_map(       # cast on the host
            lambda a: jnp.asarray(np.asarray(a).astype(jdt)), jp["control"])
        tp["control"] = tree_map(lambda t: t.to(tdt), tp["control"])
    return jp, tp


@functools.lru_cache(maxsize=4)
def _sr_bits(shapes):
    """key -> the 16 noise bits of every leaf, one compiled function for
    all leaves (an eager call compiles once per shape)."""
    def bits(key):
        k_sr = jax.random.fold_in(key, 0x5B)
        return [jax.random.bits(jax.random.fold_in(k_sr, i), shape,
                                jnp.uint32) & jnp.uint32(0xFFFF)
                for i, shape in enumerate(shapes)]

    return fast_jit(bits, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=8)
def _loss_draws(latents_shape, num_idx, ucg_rate):
    """key -> (idx, noise, keep) as the JAX loss draws them, compiled
    once per shape."""
    def draws(key):
        B = latents_shape[0]
        k_idx, k_noise, k_ucg = jax.random.split(key, 3)
        return (jax.random.randint(k_idx, (B,), 0, num_idx),
                jax.random.normal(k_noise, latents_shape, jnp.float32),
                jax.random.bernoulli(k_ucg, 1.0 - ucg_rate, (B,)))

    return fast_jit(draws, jax.random.PRNGKey(0))


def dit_loss_draws(key, latents_shape, num_idx: int, *, ucg_rate=0.0,
                   sr_tree=None):
    """The draws of the JAX stage-2 loss for `key`
    (diffusion_loss.py:56-66: split(key, 3) -> randint, normal,
    bernoulli) and, with sr_tree (the JAX control tree), the
    stochastic-rounding bits of apply_updates_sr (sr.py:35, :60: per leaf
    i of the flattened tree, bits(fold_in(fold_in(key, 0x5B), i)) & 0xFFFF)
    as a tree of the same structure. Returns the port's LossDraws."""
    from landiff_tpu_torch.training.diffusion_loss import LossDraws

    idx, noise, keep = _loss_draws(tuple(latents_shape), num_idx,
                                   float(ucg_rate))(key)
    idx, noise = np.array(idx), np.array(noise)
    keep = torch.from_numpy(np.array(keep)) if ucg_rate > 0.0 else None
    bits = None
    if sr_tree is not None:
        leaves, treedef = jax.tree_util.tree_flatten(sr_tree)
        raw = _sr_bits(tuple(leaf.shape for leaf in leaves))(key)

        def to_port(b):
            b = np.array(b).astype(np.int32)
            if b.ndim in bridge._PERMUTE:      # conv kernels: as the bridge
                b = np.ascontiguousarray(
                    np.transpose(b, bridge._PERMUTE[b.ndim]))
            return torch.from_numpy(b)

        bits = jax.tree_util.tree_unflatten(treedef,
                                            [to_port(b) for b in raw])
    return LossDraws(torch.from_numpy(idx).long(), torch.from_numpy(noise),
                     keep, bits)


def train_lm_params(micro_drop_probs=None):
    """(JAX tree, port tree) of the stage-1 trainer's parameters: the "lm"
    tree of stage1_params plus, for the keys of micro_drop_probs, the
    learned null embeddings "micro_null" (lm.py:610-617), from a numpy
    seed."""
    jparams, tparams = stage1_params()
    jp, tp = dict(jparams["lm"]), dict(tparams["lm"])
    freq = tcfg.tiny_test_config().llm.micro_cond_embed_dim
    nulls = {k: randn(900 + i, freq, scale=freq ** -0.5)
             for i, k in enumerate(sorted(micro_drop_probs or {}))}
    if nulls:
        jp["micro_null"] = {k: jnp.asarray(v) for k, v in nulls.items()}
        tp["micro_null"] = bridge.to_torch(nulls, device="cpu")
    return jp, tp


def lm_cond_draws(key, batch: int, micro_keys, micro_drop_probs=None):
    """The keep masks of the JAX stage-1 loss for `key`
    (lm_train.py:121-129: split(key) -> text, micro; text keep =
    uniform(k_text, (B, 1, 1)) > p is compared by the caller, so the
    uniforms are returned thresholded at the caller's probabilities;
    lm.py:197-207: one subkey per sorted micro key). Returns a function
    cfg_drop_prob -> the port's CondDraws."""
    from landiff_tpu_torch.training.lm_train import CondDraws

    k_text, k_micro = jax.random.split(key)
    u_text = np.array(jax.random.uniform(k_text, (batch, 1, 1)))[:, 0, 0]
    keys = sorted(micro_keys)
    subkeys = jax.random.split(k_micro, len(keys))
    u_micro = {k: np.array(jax.random.uniform(sk, (batch, 1)))[:, 0]
               for k, sk in zip(keys, subkeys)}
    probs = micro_drop_probs or {}

    def draws(cfg_drop_prob: float):
        return CondDraws(
            torch.from_numpy(u_text > cfg_drop_prob),
            {k: torch.from_numpy(u > probs.get(k, 0.0))
             for k, u in u_micro.items()})

    return draws


def fast_jit(fn, *args):
    """fn compiled for these arguments with XLA's backend optimizations
    off: a tiny-config train step compiles in 2.4 s instead of 9.9 s and
    runs as fast, and tier-1 has little time to spare. Returns the
    compiled callable (positional arguments of the same shapes only)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


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
