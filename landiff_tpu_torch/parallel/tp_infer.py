"""Tensor- and sequence-parallel stage-2 inference (counterpart of
landiff_tpu/parallel/tp_infer.py): the DiT Megatron-sharded over the
`model` ranks of a mesh, its tokens over the `time` ranks, the CFG rows
over the `data` ranks. The mode follows the mesh (`mode`, JAX :199-203):
"tp" (Megatron heads; also a mesh of `data` alone), "sp" (time > 1,
model = 1: weights whole on every rank, W8A8 as dit.quantize_int8 makes
it, tokens sharded, attention a ring; dit.control_warp_forward_sp) and
"tpsp" (both: the head-padded tp layout within each ring position,
dit.control_warp_forward_tp with sp_group).

  - the layer weights are laid out head-major and their head axis
    zero-padded to a multiple of `model` (`prep_dit_tp`: 30 heads over
    model=4 -> 32, 8 a rank); a padded head has zero q / k / v weights
    and zero attn-out rows and adds exactly nothing;
  - qkv and mlp0 are column-parallel, attn-out and mlp1 row-parallel:
    two all-reduces a layer (models/dit.py `_layer_tp`); everything else
    (embeddings, adaLN, qk-LN, zero_linear, the final head) is whole on
    every rank;
  - W8A8 (`quantize_layer_tp`, LANDIFF_DIT_INT8) quantizes after the prep
    with per-output scales at the tp shapes: column-parallel scales are
    sharded with their columns, row-parallel ones whole;
  - the flash kernels run unchanged on each rank's local heads.

`make_tp_denoise_fn` is the per-rank closure with the contract of
engine.make_denoise_fn: every rank of the mesh runs the sampler's loop on
the same inputs, its network call sharded, the output gathered over
`data`. It has no cond_only twin (with the CFG rows on `data`, a cond row
alone would idle half the mesh), so engine.sample_latents drops an
environment LANDIFF_CFG_WINDOW with a warning and an explicit cfg_window
raises, as in JAX. engine.update_bundle_tokens makes the next long-video
segment's closure from it, sharing the sharded net (JAX's
update_tp_bundle).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from landiff_tpu_torch.config import DiTConfig, MeshConfig, SamplerConfig, \
    SemanticCondConfig, TokenizerConfig
from landiff_tpu_torch.parallel import mesh as mesh_lib

TP_AXIS = "model"

# specs of the tp-prepped layer leaves; attn_out_b / mlp1_b stay whole:
# a row-parallel bias is added once, after the all-reduce
TP_LEAF_SPECS = {
    "qkv_w": (None, None, TP_AXIS, None),      # (D, 3, H_pad, Dk)
    "qkv_b": (None, TP_AXIS, None),            # (3, H_pad, Dk)
    "attn_out_w": (TP_AXIS, None, None),       # (H_pad, Dk, D)
    "mlp0_w": (None, TP_AXIS),
    "mlp0_b": (TP_AXIS,),
    "mlp1_w": (TP_AXIS, None),
}

# W8A8 leaves: q as the raw weight, the per-output scale s as the
# weight's output dims (whole for row-parallel weights: it applies after
# the contraction and commutes with the all-reduce)
TP_INT8_SPECS = {
    ("qkv_w", "q"): (None, None, TP_AXIS, None),
    ("qkv_w", "s"): (None, TP_AXIS, None),     # (3, H_pad, Dk)
    ("attn_out_w", "q"): (TP_AXIS, None, None),
    ("attn_out_w", "s"): (),                   # (D,)
    ("mlp0_w", "q"): (None, TP_AXIS),
    ("mlp0_w", "s"): (TP_AXIS,),               # (M,)
    ("mlp1_w", "q"): (TP_AXIS, None),
    ("mlp1_w", "s"): (),                       # (D,)
}

# leading contracted axes of each quantized leaf
INT8_CONTRACT_AXES = {"qkv_w": 1, "attn_out_w": 2, "mlp0_w": 1, "mlp1_w": 1}


def int8_operand(q: torch.Tensor, n_contract: int) -> torch.Tensor:
    """The same codes with the contracted (leading) axes fastest in
    memory, so that q.reshape(in, out) is the column-major operand of
    torch._int_mm (models/dit.quantize_int8's layout). A slice of such a
    tensor along an output axis of a 4-D or a row-parallel leaf is not
    column-major any more: each shard rebuilds it with this."""
    nd = q.dim()
    order = list(range(n_contract, nd)) + list(range(n_contract))
    back = [order.index(i) for i in range(nd)]
    return q.permute(*order).contiguous().permute(*back)


def _quant_leaf(a, n_contract: int) -> dict:
    """Symmetric absmax int8 over the leading n_contract axes (tp_infer.
    py:83): s = max(max|a|, 1e-8) / 127 per output, a true division as
    the JAX prep runs eagerly; a zero-padded head quantizes to zero codes
    with the floored scale."""
    a = a.float()
    s = a.abs().amax(tuple(range(n_contract))).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(a / s), -127, 127).to(torch.int8)
    return {"q": int8_operand(q, n_contract), "s": s}


def quantize_layer_tp(p: dict) -> dict:
    return {k: (_quant_leaf(v, INT8_CONTRACT_AXES[k])
                if k in INT8_CONTRACT_AXES else v) for k, v in p.items()}


def pad_heads(n_heads: int, tp: int) -> int:
    return int(math.ceil(n_heads / tp) * tp)


def prep_layer_tp(p: dict, cfg: DiTConfig, tp: int) -> dict:
    """One layer in the head-major tp layout, the head axis zero-padded
    to a multiple of tp (tp_infer.py:112); views where nothing pads."""
    D, H, Dk = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    pad = pad_heads(H, tp) - H
    out = dict(p)
    out["qkv_w"] = F.pad(p["qkv_w"].reshape(D, 3, H, Dk), (0, 0, 0, pad)) \
        if pad else p["qkv_w"].reshape(D, 3, H, Dk)
    out["qkv_b"] = F.pad(p["qkv_b"].reshape(3, H, Dk), (0, 0, 0, pad)) \
        if pad else p["qkv_b"].reshape(3, H, Dk)
    out["attn_out_w"] = F.pad(p["attn_out_w"].reshape(H, Dk, D),
                              (0, 0, 0, 0, 0, pad)) \
        if pad else p["attn_out_w"].reshape(H, Dk, D)
    return out


def prep_dit_tp(params: dict, cfg: DiTConfig, tp: int, *,
                int8: bool = False) -> dict:
    """The DiT in the tp layout; int8: W8A8 after the prep (JAX
    dif_infer.py:65-72: never before, so the scales are the tp shapes')."""
    out = dict(params)
    layers = [prep_layer_tp(p, cfg, tp) for p in params["layers"]]
    if int8:
        layers = [quantize_layer_tp(p) for p in layers]
    out["layers"] = layers
    return out


def dit_tp_specs(prepped: dict):
    """The spec tree of a prep_dit_tp output: the layer matrices on
    `model`, everything else whole."""
    def spec(path, x):
        if "layers" in path:
            if path[-1] in ("q", "s"):
                return TP_INT8_SPECS.get((path[-2], path[-1]), ())
            return TP_LEAF_SPECS.get(path[-1], ())
        return ()

    return mesh_lib.map_with_path(spec, prepped)


def mode(mesh_cfg: MeshConfig) -> str:
    """"tpsp", "sp" or "tp" (tp_infer.py:199-203)."""
    if mesh_cfg.time > 1:
        return "tpsp" if mesh_cfg.model > 1 else "sp"
    return "tp"


def dit_shards(params: dict, cfg: DiTConfig, mesh_cfg: MeshConfig,
               devices, *, int8: bool = False, dtype=None) -> list:
    """Every rank's part of the DiT: floating leaves in `dtype` (the
    compute dtype: the forwards cast every weight to it at use, so this
    changes no result), int8 codes in the column-major operand layout,
    scales in f32. Under "sp" one whole tree (W8A8 by dit.quantize_int8,
    JAX :205-219) on devices[0], the same for every rank: rank 0 keeps it
    and each worker copies it (mesh.load), so rank 0's replica is the
    caller's tree wherever it already has the dtype. Otherwise the
    tp-prepped tree (W8A8 after the prep), rank r's part copied to
    devices[r]. A device None (mesh.shard_devices of a ProcessMesh: a
    rank of another process) gets no tree, None in its place; under "sp"
    the whole tree then goes to the first device given."""
    if mode(mesh_cfg) == "sp":
        from landiff_tpu_torch.models import dit as dit_lib

        tree = dit_lib.quantize_int8(params) if int8 else params

        def whole(path, x):
            to = x.dtype if x.dtype == torch.int8 or path[-1] == "s" \
                or dtype is None else dtype
            return x.to(home, to)

        home = next(d for d in devices if d is not None)
        one = mesh_lib.map_with_path(whole, tree)
        return [one if d is not None else None for d in devices]
    prepped = prep_dit_tp(params, cfg, mesh_cfg.model, int8=int8)
    specs = dit_tp_specs(prepped)

    def place(device):
        def leaf(path, x):
            if x.dtype == torch.int8:
                return int8_operand(x.to(device),
                                    INT8_CONTRACT_AXES[path[-2]])
            to = x.dtype if path[-1] == "s" or dtype is None else dtype
            return x.to(device, to, copy=True).contiguous()
        return leaf

    return [None if devices[r] is None else mesh_lib.map_with_path(
        place(devices[r]), mesh_lib.shard_for_rank(prepped, specs,
                                                   mesh_cfg, r))
        for r in range(mesh_cfg.num_devices)]


def _tp_net(ctx: mesh_lib.RankContext, main_params, control_params,
            dit_cfg: DiTConfig, compute_dtype, attn_impl):
    """net(x2, ts, ctx2, sem2) on this rank: of the CFG batch its data
    index takes its rows / data rows; its model and time groups run them
    through the mode's forward (control_warp_forward_tp, with the time
    group as sp_group under "tpsp"; control_warp_forward_sp under "sp");
    the data group gathers the rows back."""
    from landiff_tpu_torch.models import dit as dit_lib

    n_data, d = ctx.cfg.data, ctx.coords["data"]
    m = mode(ctx.cfg)

    def net(x2, ts, ctx2, sem2):
        rows = x2.shape[0]
        if rows % n_data:
            raise ValueError(f"{rows} CFG rows do not split over data="
                             f"{n_data}")
        sl = slice(d * rows // n_data, (d + 1) * rows // n_data)
        args = (main_params, control_params, x2[sl], ts[sl], ctx2[sl],
                dit_cfg, sem2[sl])
        kw = dict(attn_impl=attn_impl, compute_dtype=compute_dtype)
        if m == "sp":
            out = dit_lib.control_warp_forward_sp(
                *args, sp_group=ctx.time_group, **kw)
        else:
            out = dit_lib.control_warp_forward_tp(
                *args, group=ctx.model_group,
                sp_group=ctx.time_group if m == "tpsp" else None, **kw)
        return ctx.data_group.all_gather(out, dim=0)

    return net


def make_tp_denoise_fn(ctx: mesh_lib.RankContext, main_params,
                       control_params, sem_params, dit_cfg: DiTConfig,
                       sampler_cfg: SamplerConfig, tok_cfg: TokenizerConfig,
                       sem_cfg: SemanticCondConfig, context, uc_context,
                       semantic_tokens, *, compute_dtype=torch.bfloat16,
                       attn_impl="auto"):
    """This rank's denoise closure (tp_infer.py:167), any mode: main /
    control are its dit_shards trees, sem_params whole; the semantic
    feature is computed whole on every rank, the network call is
    `_tp_net`."""
    from landiff_tpu_torch.diffusion import engine

    return engine.make_denoise_fn(
        main_params, control_params, sem_params, dit_cfg, sampler_cfg,
        tok_cfg, sem_cfg, context, uc_context, semantic_tokens,
        compute_dtype=compute_dtype,
        net=_tp_net(ctx, main_params, control_params, dit_cfg,
                    compute_dtype, attn_impl))


def model_call(ctx: mesh_lib.RankContext, key: str, x2, ts, ctx2, sem2,
               dit_cfg: DiTConfig, compute_dtype=torch.bfloat16,
               attn_impl="auto"):
    """One CFG-batch network call on every rank from the DiT trees stored
    under `key` (dif_infer's stage-2 trees); the caller's rank
    (ctx.caller) returns the output, the others None."""
    st = ctx.state[key]
    x2, ts, ctx2, sem2 = mesh_lib.to_rank(ctx, [x2, ts, ctx2, sem2])
    net = _tp_net(ctx, st["main"], st["control"], dit_cfg, compute_dtype,
                  attn_impl)
    with torch.inference_mode():
        out = net(x2.to(compute_dtype), ts, ctx2, sem2)
    mesh_lib.release_cache(ctx)
    return out if ctx.caller else None


def denoise_call(ctx: mesh_lib.RankContext, key: str, cfg, context,
                 uc_context, tokens, x, step: dict,
                 compute_dtype=torch.bfloat16, attn_impl="auto"):
    """One call of the denoise closure (make_tp_denoise_fn from the
    stage-2 trees under `key`, dif_infer's) on every rank: denoise_fn(x,
    step), step the sampler's {"alpha", "timestep", "cfg_scale"}; the
    caller's rank (ctx.caller) returns the f32 prediction, the others
    None."""
    st = ctx.state[key]
    context, uc_context, tokens, x = mesh_lib.to_rank(
        ctx, [context, uc_context, tokens, x])
    with torch.inference_mode():
        fn = make_tp_denoise_fn(
            ctx, st["main"], st["control"], st["semantic"], cfg.dit,
            cfg.sampler, cfg.tokenizer, cfg.semantic_cond, context,
            uc_context, tokens, compute_dtype=compute_dtype,
            attn_impl=attn_impl)
        out = fn(x, step)
    mesh_lib.release_cache(ctx)
    return out if ctx.caller else None


def rank_report(ctx: mesh_lib.RankContext, reset: bool = False) -> dict:
    """This rank's counts since the last reset: flash launches per
    kernel, collectives per kind; its peak device memory; the bytes of
    each tree it stores, by key and component. reset: zero the counts
    and the peak instead, after reading them."""
    from landiff_tpu_torch.ops import attention

    out = {"rank": ctx.rank, "coords": ctx.coords,
           "backend": ctx.backend, "device": str(ctx.device),
           "launches": dict(attention.LAUNCHES),
           "collectives": dict(mesh_lib.COLLECTIVES),
           "param_bytes": {key: {k: mesh_lib.tree_nbytes(v)
                                 for k, v in tree.items()}
                           for key, tree in ctx.state.items()
                           if isinstance(tree, dict)}}
    if ctx.device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            ctx.device)
    if reset:
        attention.reset_launch_counts()
        mesh_lib.reset_collective_counts()
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
    return out


# ---------------------------------------------------------------------------
# stage 1 and the T5 encoders under the mesh's rules (JAX llm_infer.py:
# 75-90, dif_infer.py:73-83)


def _place(local, device):
    return mesh_lib.map_with_path(
        lambda path, x: x.to(device, copy=True).contiguous()
        if isinstance(x, torch.Tensor) else x, local)


def replicated(tree, devices) -> list:
    """A whole copy of `tree` for every rank, on its device (None for a
    device None, as dit_shards)."""
    return [None if d is None else _place(tree, d) for d in devices]


def t5_shards(params, cfg, mesh_cfg: MeshConfig, devices) -> list:
    """Every rank's part of a T5 encoder by mesh.T5_RULES; whole copies
    where the heads or the feed-forward width do not divide `model` (a
    block of leaves that do not all divide runs replicated); None for a
    device None, as dit_shards."""
    tp = mesh_cfg.model
    if tp == 1 or cfg.num_heads % tp or cfg.d_ff % tp:
        return replicated(params, devices)
    specs = mesh_lib.param_specs(params, mesh_lib.T5_RULES, mesh_cfg)
    return [None if devices[r] is None else
            _place(mesh_lib.shard_for_rank(params, specs, mesh_cfg, r),
                   devices[r]) for r in range(mesh_cfg.num_devices)]


def lm_shards(params, cfg, mesh_cfg: MeshConfig, devices) -> list:
    """Every rank's lm tree: the GPT by mesh.GPT_RULES (the head by its
    fitted rule: whole where the vocab does not divide), wqkv and its
    int8 {q, s} split per head inside each of q, k and v; everything
    else whole. Whole copies where the heads or the MLP width do not
    divide `model`. None for a device None, as dit_shards."""
    tp = mesh_cfg.model
    if tp == 1 or cfg.num_heads % tp or cfg.mlp_hidden % tp:
        return replicated(params, devices)
    specs = mesh_lib.param_specs(params, mesh_lib.GPT_RULES, mesh_cfg)
    H, Dk = cfg.num_heads, cfg.head_dim
    per_head = lambda path, spec: "wqkv" in path[-2:] and any(spec)
    # wqkv (.., 3D) viewed as (.., 3, H, Dk) and split on H
    headed = mesh_lib.map_with_path(
        lambda p, x, s: x.reshape(*x.shape[:-1], 3, H, Dk)
        if per_head(p, s) else x, params, specs)
    headed_specs = mesh_lib.map_with_path(
        lambda p, x, s: tuple(s[:-1]) + (None, s[-1], None)
        if per_head(p, s) else s, params, specs)

    def merge(path, x, spec):          # back to (.., 3 H_local Dk)
        return x.reshape(*x.shape[:-3], -1) if per_head(path, spec) else x

    out = []
    for r in range(mesh_cfg.num_devices):
        if devices[r] is None:
            out.append(None)
            continue
        local = mesh_lib.shard_for_rank(headed, headed_specs, mesh_cfg, r)
        local = mesh_lib.map_with_path(merge, local, headed_specs)
        out.append(_place(local, devices[r]))
    return out


def is_sharded(leaf, full_width: int) -> bool:
    return leaf.shape[-1] != full_width


def t5_encode(ctx: mesh_lib.RankContext, key: str, ids, mask, cfg,
              compute_dtype):
    """The T5 encoder stored under state[key]["t5"] on every rank; rank 0
    returns the features, the workers None."""
    from landiff_tpu_torch.models import t5 as t5_lib

    p = ctx.state[key]["t5"]
    q = p["blocks"][0]["attn"]["q"]
    tp = ctx.model_group if is_sharded(q, cfg.num_heads * cfg.d_kv) \
        else None
    ids, mask = mesh_lib.to_rank(ctx, [ids, mask])
    with torch.inference_mode():
        out = t5_lib.encode(p, ids, mask, cfg, compute_dtype=compute_dtype,
                            tp=tp)
    return out if ctx.caller else None
