"""Compound-drift gates of the quantized DiT paths (counterpart of the JAX
package's tests/test_attention_int8_drift.py and tests/test_dit_int8_drift.py).

Each gate chains three full ControlNet DiT denoise steps
(`dit.control_warp_forward`, main + control + adaLN + residuals) with a toy
update x <- 0.9 x + 0.1 net, once on the exact path and once on a quantized
one, and bounds the drift of the end output: the correlation of the two
and the mean |difference| over the mean |exact|. The configuration is the
JAX gates' mid one: S = 8 text + 3 * 16 * 16 video = 776 positions, so
that the flash route's int8 selection rule ("cached", more than one
512-row q block) really takes the int8-score forward; hidden 64, so the
head dim is 64 with one head (the attention gates) or 32 with two (W8A8,
on the dense route, as in JAX). The zero-init gates are filled
(`utils.fill_zero_leaves`), or attention would not reach the output.

    int8 scores vs exact (flash route):    corr > 0.9995, rel < 0.02
    int8_pv vs exact (flash route):        corr > 0.999,  rel < 0.03
    W8A8 linears vs f32 weights (dense):   corr > 0.999,  rel < 0.03

At this configuration attention moves the end output little: with every
attention output replaced by zeros the end output moves by rel 2.5e-4
(the CPU, f32), so JAX's thresholds alone would pass a kernel that gives
nothing at all. The attention gates therefore also hold the drift to a
share of attention's own contribution (rel of the quantized run over rel
of the run with attention zeroed, both against the exact run): under
SHARE_LIMIT, 5 %.

`run_gate` runs one on any device and dtype: on the CPU the flash route
runs the kernels' plain versions at the kernel's kv tile, on the card the
kernels themselves. It reports the launches of each forward kernel during
the quantized run, so a caller can show that the path engaged.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from landiff_tpu_torch.config import DiTConfig
from landiff_tpu_torch.models import dit as dit_lib
from landiff_tpu_torch.ops import attention as attn_lib
from landiff_tpu_torch.utils import fill_zero_leaves, tree_map

# name: (correlation above, mean relative difference below)
GATES = {"int8": (0.9995, 0.02), "int8_pv": (0.999, 0.03),
         "w8a8": (0.999, 0.03)}
SHARE_LIMIT = 0.05
STEPS = 3


def mid_config(num_heads: int = 1) -> DiTConfig:
    """The JAX gates' mid configuration (S = 776, head dim 64 / heads)."""
    return DiTConfig(num_layers=2, hidden_size=64, num_heads=num_heads,
                     patch_size=2, in_channels=4, out_channels=4,
                     latent_frames=3, latent_height=32, latent_width=32,
                     text_dim=32, text_length=8, time_embed_dim=32,
                     adm_in_channels=16, control_layers=1)


def _setup(cfg: DiTConfig, device, dtype, seed: int = 0):
    """Parameters (zero leaves filled) and inputs, drawn from one numpy
    seed, so that every device gets the same numbers."""
    gen = torch.Generator().manual_seed(seed)
    params = dit_lib.init(gen, cfg)
    ctrl = dit_lib.init(gen, cfg, control=True)
    params = fill_zero_leaves(params, gen, scale=0.05)
    ctrl = fill_zero_leaves(ctrl, gen, scale=0.05)
    move = lambda tree: tree_map(lambda leaf: leaf.to(device), tree)
    rng = np.random.default_rng(seed)
    B = 2
    shape = (B, cfg.latent_frames, cfg.in_channels, cfg.latent_height,
             cfg.latent_width)
    x = rng.standard_normal(shape, dtype=np.float32)
    ctx = rng.standard_normal((B, cfg.text_length, cfg.text_dim),
                              dtype=np.float32)
    sem = rng.standard_normal(shape, dtype=np.float32) * 0.1
    t = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    return move(params), move(ctrl), t(x), t(ctx), t(sem)


def chained_steps(cfg, params, ctrl, x, ctx, sem, *, attn_impl,
                  dtype, env: dict[str, str], steps: int = STEPS):
    """`steps` chained control_warp_forward calls under the environment
    `env` (the attention knobs; the earlier values come back after);
    attn_impl a route of `attention` or a callable in its place."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with torch.no_grad():
            for i in range(steps):
                ts = torch.full((x.shape[0],), 999.0 - 200.0 * i,
                                dtype=torch.float32, device=x.device)
                net = dit_lib.control_warp_forward(
                    params, ctrl, x, ts, ctx, cfg, sem, attn_impl=attn_impl,
                    compute_dtype=dtype)
                x = 0.9 * x + 0.1 * net
        return x.float().cpu().numpy()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _no_attention(q, k, v):
    return torch.zeros_like(q)


def drift(exact: np.ndarray, quant: np.ndarray) -> dict:
    corr = float(np.corrcoef(exact.ravel(), quant.ravel())[0, 1])
    rel = float(np.abs(exact - quant).mean() / (np.abs(exact).mean() + 1e-9))
    return {"corr": corr, "rel": rel,
            "max_abs_diff": float(np.abs(exact - quant).max())}


_OFF = {"LANDIFF_ATTN_INT8": "0", "LANDIFF_ATTN_INT8_PV": "0"}
_ENV = {"int8": {"LANDIFF_ATTN_INT8": "1", "LANDIFF_ATTN_INT8_PV": "0"},
        "int8_pv": {"LANDIFF_ATTN_INT8": "1", "LANDIFF_ATTN_INT8_PV": "1"}}


def run_gate(name: str, device="cuda", dtype=torch.bfloat16) -> dict:
    """One gate of GATES: {"corr", "rel", "max_abs_diff", "limits",
    "passed", "launches"}, launches the forward kernels' counts
    (attention.LAUNCHES) during the quantized run; the attention gates
    also "attention_rel" (the run with attention zeroed) and
    "share_of_attention"."""
    if name not in GATES:
        raise ValueError(f"unknown gate {name!r}: {sorted(GATES)}")
    dev = torch.device(device)
    if name == "w8a8":
        cfg = mid_config(num_heads=2)
        params, ctrl, x, ctx, sem = _setup(cfg, dev, dtype)
        exact = chained_steps(cfg, params, ctrl, x, ctx, sem,
                              attn_impl="xla", dtype=dtype, env=_OFF)
        params = dit_lib.quantize_int8(params)
        ctrl = dit_lib.quantize_int8(ctrl)
        env, impl = _OFF, "xla"
    else:
        cfg = mid_config()
        params, ctrl, x, ctx, sem = _setup(cfg, dev, dtype)
        exact = chained_steps(cfg, params, ctrl, x, ctx, sem,
                              attn_impl="pallas", dtype=dtype, env=_OFF)
        env, impl = _ENV[name], "pallas"
        blind = chained_steps(cfg, params, ctrl, x, ctx, sem,
                              attn_impl=_no_attention, dtype=dtype, env=_OFF)
    before = dict(attn_lib.LAUNCHES)
    quant = chained_steps(cfg, params, ctrl, x, ctx, sem, attn_impl=impl,
                          dtype=dtype, env=env)
    launches = {k: attn_lib.LAUNCHES[k] - before[k] for k in before}
    res = drift(exact, quant)
    lo_corr, hi_rel = GATES[name]
    passed = (res["corr"] > lo_corr and res["rel"] < hi_rel
              and res["max_abs_diff"] > 0)
    limits = {"corr_above": lo_corr, "rel_below": hi_rel}
    if name != "w8a8":
        res["attention_rel"] = drift(exact, blind)["rel"]
        res["share_of_attention"] = res["rel"] / res["attention_rel"]
        limits["share_below"] = SHARE_LIMIT
        passed = passed and res["share_of_attention"] < SHARE_LIMIT
    res.update(limits=limits, passed=bool(passed),
               launches={k: v for k, v in launches.items() if v})
    return res

