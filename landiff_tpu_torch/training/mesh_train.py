"""The trainer on a mesh (counterpart of the mesh half of landiff_tpu/
training/train.py: `train --mesh` for dit, lm and vq).

JAX runs one SPMD program: parameters placed by the rules of parallel/
mesh.py (DIT_RULES, GPT_RULES, TITOK_RULES), the batch over `data`, the
optimizer state ZeRO-sharded over `data` (training/zero.py). Here every
rank of a `parallel.mesh.Mesh` is a process holding its own parts:

  - `Layout`: how a model's trainable tree lies on the ranks: a whole
    tree is first put in the training layout (`prep`: the DiT's
    head-major, head-padded layout of tp_infer.prep_dit_tp; the GPT's
    wqkv as (D, 3, H, Dk)), then cut by its spec tree along `model`;
    `gather` undoes both, so every state leaves the mesh in the layout
    one device uses;
  - the optimizer state of each rank's parts is cut again along `data`
    (ZeRO, zero.zero_dims) for dit and lm; vq's stays replicated, as
    JAX's (train.py:223);
  - `MeshTrainer` (the caller's handle: rank 0 of a spawned mesh,
    every process of a multihost ProcessMesh) stores each rank's state once
    (`_setup`), runs one command per step (`_step`: every rank gets the
    whole batch and the step's seed, draws the whole batch's random
    inputs as one device would and takes its rows), and gathers the state
    back (`_gather`) for a checkpoint or the caller, the same
    `step_<N>.pt` one device writes.

dit's step follows the mesh (diffusion_loss.mesh_mode): "sp" (time > 1,
model = 1, JAX's make_train_step_sp), "tp" (model > 1, the time ranks
repeating the work, as JAX's) or "dp".
"""

from __future__ import annotations

import dataclasses

import torch

from landiff_tpu_torch.parallel import mesh as mesh_lib
from landiff_tpu_torch.parallel import tp_infer
from landiff_tpu_torch.training import zero
from landiff_tpu_torch.utils import tree_map

# the vq trainer's rules: TITOK_RULES, and fc0's bias with its columns
VQ_RULES = mesh_lib.TITOK_RULES + [(r".*fc0_b$", ("model",))]


def _identity(tree):
    return tree


@dataclasses.dataclass
class Layout:
    """prep(whole tree) -> the training layout; unprep its inverse;
    specs(prepped tree) -> the spec tree (mesh axes per dimension);
    zero: whether the optimizer state is cut along `data`."""

    prep: object = _identity
    unprep: object = _identity
    specs: object = lambda tree: mesh_lib.map_with_path(lambda p, x: (),
                                                        tree)
    zero: bool = True

    def local(self, tree, ctx):
        """This rank's parts of a whole tree, its own copies on its
        device."""
        prepped = self.prep(tree)
        part = mesh_lib.shard_for_rank(prepped, self.specs(prepped), ctx.cfg,
                                       ctx.rank)
        return tree_map(lambda x: x.to(ctx.device, copy=True).contiguous(),
                        part)

    def gather(self, local, specs, ctx):
        """The whole tree (one device's layout) from every rank's parts
        (`specs` those of the prepped tree): each split dimension
        all-gathered over `model`."""
        def join(path, x, spec):
            for d, ax in enumerate(spec):
                if ax == "model":
                    x = ctx.model_group.all_gather(x.contiguous(), d)
            return x

        return self.unprep(mesh_lib.map_with_path(join, local, specs))


def _unprep_layer_tp(p: dict, cfg) -> dict:
    """tp_infer.prep_layer_tp undone: the padded heads dropped."""
    D, H = cfg.hidden_size, cfg.num_heads
    out = dict(p)
    out["qkv_w"] = p["qkv_w"][:, :, :H].reshape(D, -1)
    out["qkv_b"] = p["qkv_b"][:, :H].reshape(-1)
    out["attn_out_w"] = p["attn_out_w"][:H].reshape(-1, D)
    return out


def dit_layout(cfg, mesh_cfg) -> Layout:
    """The DiT trees' layout: under "tp" the head-major tp layout
    (tp_infer.prep_dit_tp, heads padded to a multiple of `model`: a padded
    head's weights get no gradient and stay 0), its layer matrices on
    `model` (tp_infer.dit_tp_specs); whole under "sp" and "dp"."""
    from landiff_tpu_torch.training.diffusion_loss import mesh_mode

    if mesh_mode(mesh_cfg) != "tp":
        return Layout()

    def prep(tree):
        out = dict(tree)
        out["layers"] = [tp_infer.prep_layer_tp(p, cfg.dit, mesh_cfg.model)
                         for p in tree["layers"]]
        return out

    def unprep(tree):
        out = dict(tree)
        out["layers"] = [_unprep_layer_tp(p, cfg.dit) for p in tree["layers"]]
        return out

    return Layout(prep, unprep, tp_infer.dit_tp_specs)


def lm_layout(cfg, mesh_cfg) -> Layout:
    """The stage-1 tree under GPT_RULES (fitted: a vocabulary that
    `model` does not divide keeps the head whole), wqkv as (D, 3, H, Dk)
    split on H; whole where the heads or the MLP width do not divide."""
    llm, tp = cfg.llm, mesh_cfg.model
    if tp == 1 or llm.num_heads % tp or llm.mlp_hidden % tp:
        return Layout()
    H, Dk = llm.num_heads, llm.head_dim
    headed = lambda path: path[-1] == "wqkv"

    def prep(tree):
        return mesh_lib.map_with_path(
            lambda p, x: x.reshape(x.shape[0], 3, H, Dk) if headed(p) else x,
            tree)

    def unprep(tree):
        return mesh_lib.map_with_path(
            lambda p, x: x.flatten(1) if headed(p) else x, tree)

    def specs(tree):
        flat = mesh_lib.param_specs(unprep(tree), mesh_lib.GPT_RULES,
                                    mesh_cfg)
        return mesh_lib.map_with_path(
            lambda p, s: (None, None, "model", None) if headed(p) else s,
            flat)

    return Layout(prep, unprep, specs)


def vq_layout(cfg, mesh_cfg) -> Layout:
    """The tokenizer under TITOK_RULES (and fc0_b with fc0's columns),
    its optimizer state replicated."""
    return Layout(specs=lambda tree: mesh_lib.param_specs(tree, VQ_RULES,
                                                          mesh_cfg),
                  zero=False)


LAYOUTS = {"dit": dit_layout, "lm": lm_layout, "vq": vq_layout}


def _spec_leaves(specs) -> list:
    out = []
    mesh_lib.map_with_path(lambda p, s: out.append(s), specs)
    return out


def _zero_gather(tree, dims, ctx):
    n = ctx.cfg.data
    return tree_map(lambda x, d: x if d is None or n == 1 else
                    ctx.data_group.all_gather(x.contiguous(), d), tree, dims)


# ---------------------------------------------------------------------------
# rank commands


def _sr_bits_fn(layout, ctx, like):
    """draws -> this rank's parts of the stochastic-rounding bits of the
    whole control leaves: from a generator, drawn leaf by leaf at the
    whole shapes as sr.apply_updates_sr draws them (bf16 leaves only),
    or given as a whole tree."""
    def bits(draws):
        src = draws.sr_bits
        if isinstance(src, torch.Generator):
            src = tree_map(
                lambda t: torch.randint(0, 1 << 16, t.shape, generator=src,
                                        device=src.device, dtype=torch.int32)
                if t.dtype == torch.bfloat16 else
                torch.zeros(t.shape, dtype=torch.int32, device=src.device),
                like)
        return layout.local(src, ctx)

    return bits


def _setup(ctx, key, model, cfg, opt_kw, dtype, state, frozen, step_kw,
           zero_min_size, keep_grads):
    """Store this rank's parts of the trainer's state (the one-device
    state tuple: params, opt_state, extras) and build its step."""
    from landiff_tpu_torch.training import diffusion_loss, lm_train, \
        vq_train
    from landiff_tpu_torch.training import train as train_lib

    step_kw = dict(step_kw or {})
    optimizer = train_lib.make_optimizer(**opt_kw)
    layout = LAYOUTS[model](cfg, ctx.cfg)
    params_full, opt_full = state[0], state[1]
    specs = layout.specs(layout.prep(params_full))
    params = layout.local(params_full, ctx)
    n, i = ctx.cfg.data, ctx.coords["data"]
    dims = zero.zero_dims(params, n if layout.zero else 1, zero_min_size)
    opt = zero.map_param_trees(
        lambda t: zero.zero_slice(layout.local(t, ctx), dims, n, i), opt_full)
    model_split = [any(ax == "model" for ax in s)
                   for s in _spec_leaves(specs)]
    st = {"model": model, "layout": layout, "specs": specs, "dims": dims,
          "params": params, "opt": opt, "keep": {},
          "extra": [mesh_lib.to_rank(ctx, x, copy=True) for x in state[2:]]}
    if model == "dit":
        st["main"] = layout.local(frozen["main"], ctx)
        st["sem"] = mesh_lib.to_rank(ctx, frozen["sem"], copy=True)
        sr_updates = step_kw.pop("sr_updates", False)
        like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), params_full)
        kw = dict(ctx=ctx, dims=dims, compute_dtype=dtype,
                  keep=st["keep"] if keep_grads else None,
                  sr_bits=_sr_bits_fn(layout, ctx, like) if sr_updates
                  else None, **step_kw)
        args = (optimizer, cfg.dit, cfg.sampler, cfg.tokenizer,
                cfg.semantic_cond)
        if diffusion_loss.mesh_mode(ctx.cfg) == "sp":
            step = diffusion_loss.make_train_step_sp(*args, **kw)
        else:
            step = diffusion_loss.make_train_step_mesh(
                *args, model_split=model_split, **kw)
    elif model == "lm":
        micro = {"frames": cfg.llm.frames_per_segment, "motion_score": 0.1}
        step = lm_train.make_cond_train_step_mesh(
            optimizer, cfg.llm, micro, ctx=ctx, dims=dims,
            model_split=model_split, compute_dtype=dtype, **step_kw)
    else:
        step = vq_train.make_train_step_mesh(
            optimizer, cfg.tokenizer, ctx=ctx, model_split=model_split,
            compute_dtype=dtype, **step_kw)
    st["step"] = step
    ctx.state[key] = st
    mesh_lib.release_cache(ctx)


def _rng(ctx, rng):
    """A seed -> a generator on this rank's device (the same draws on
    every rank of one device type); given draws -> on this device."""
    if isinstance(rng, int):
        return torch.Generator(device=ctx.device).manual_seed(rng)
    if isinstance(rng, torch.Tensor):
        return rng.to(ctx.device)
    if dataclasses.is_dataclass(rng):
        return dataclasses.replace(rng, **{
            f.name: mesh_lib.to_rank(ctx, getattr(rng, f.name))
            for f in dataclasses.fields(rng)})
    return rng


def _step(ctx, key, batch, rng):
    """One step of the stored trainer on this rank: batch the whole
    batch (dict of tensors), rng the step's seed or the whole batch's
    draws. Rank 0 returns the metrics (tensors on the CPU)."""
    st = ctx.state[key]
    batch = mesh_lib.to_rank(ctx, batch)
    rng = _rng(ctx, rng)
    model = st["model"]
    if model == "dit":
        st["params"], st["opt"], loss = st["step"](
            st["params"], st["opt"], st["main"], st["sem"],
            batch["latents"], batch["context"], batch["tokens"], rng)
        metrics = {"loss": loss}
    elif model == "lm":
        st["params"], st["opt"], loss = st["step"](
            st["params"], st["opt"], batch["t5_feats"], batch["codes"], rng)
        metrics = {"loss": loss}
    else:
        cb_state, first = st["extra"]
        st["params"], st["opt"], cb_state, metrics = st["step"](
            st["params"], st["opt"], cb_state, batch["features"], rng,
            first=first)
        st["extra"] = [cb_state, False]
    mesh_lib.release_cache(ctx)
    if not ctx.caller:
        return None
    return {k: v.detach().float().cpu() for k, v in metrics.items()}


def _gather(ctx, key):
    """The trainer's state in one device's layout: (params, opt_state,
    *extras) on the caller's rank (CPU tensors), None on the others."""
    st = ctx.state[key]
    layout, specs, dims = st["layout"], st["specs"], st["dims"]
    params = layout.gather(st["params"], specs, ctx)
    opt = zero.map_param_trees(
        lambda t: layout.gather(_zero_gather(t, dims, ctx), specs, ctx),
        st["opt"])
    out = None
    if ctx.caller:
        cpu = lambda tree: tree_map(
            lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x,
            tree)
        out = (cpu(params), cpu(opt), *cpu(st["extra"]))
    mesh_lib.release_cache(ctx)
    return out


def _grads(ctx, key):
    """The control gradients of the last dit step (summed over the ranks
    that split the batch or the tokens), in one device's layout, on the
    caller's rank."""
    st = ctx.state[key]
    grads = st["layout"].gather(st["keep"]["grads"], st["specs"], ctx)
    return tree_map(lambda g: g.detach().cpu(), grads) if ctx.caller \
        else None


def _local(ctx, key):
    """This rank's parameter parts (training layout, CPU) and coords."""
    st = ctx.state[key]
    return ctx.coords, tree_map(lambda x: x.detach().cpu(), st["params"])


def _drop(ctx, key):
    ctx.state.pop(key, None)
    mesh_lib.release_cache(ctx)


def _report(ctx, key):
    """This rank's bytes of parameters and of optimizer state."""
    st = ctx.state[key]
    return {"rank": ctx.rank, "coords": ctx.coords,
            "param_bytes": mesh_lib.tree_nbytes(st["params"]),
            "opt_bytes": mesh_lib.tree_nbytes(st["opt"])}


class MeshTrainer:
    """The caller's handle on a trainer stored on every rank of `mesh`:
    model "dit" | "lm" | "vq"; opt_kw: train.make_optimizer's arguments
    (each rank builds its own optimizer); state: the one-device state
    tuple train.SETUPS made (params, opt_state, extras); frozen:
    dit's {"main", "sem"} trees; step_kw: the model's mesh step options
    (fixed_frames, ucg_rate, remat, attn_impl, sr_updates for dit);
    zero_min_size: the smallest leaf whose state is split (zero.py);
    keep_grads: dit keeps each step's summed gradients for `grads`."""

    def __init__(self, mesh, model: str, cfg, opt_kw: dict, dtype, state,
                 frozen=None, step_kw=None, key: str = "train",
                 zero_min_size: int = zero.MIN_SIZE,
                 keep_grads: bool = False):
        self.mesh, self.model, self.key = mesh, model, key
        mesh.run(_setup, key, model, cfg, opt_kw, dtype, tuple(state),
                 frozen or {}, step_kw, zero_min_size, keep_grads)
        if any(torch.device(d).type == "cuda" for d in mesh.devices):
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()

    def step(self, batch, rng) -> dict:
        """One step on the whole batch; rng the step's seed (int) or the
        whole batch's draws. Returns the caller's rank's metrics."""
        return self.mesh.run(_step, self.key, batch, rng)[0]

    def state(self) -> tuple:
        """(params, opt_state, *extras) in one device's layout, on the
        CPU."""
        return self.mesh.run(_gather, self.key)[0]

    def grads(self):
        """dit: the last step's summed control gradients (one device's
        layout, CPU)."""
        return self.mesh.run(_grads, self.key)[0]

    def local_params(self) -> list:
        """Per rank: (its coords, its parameter parts in the training
        layout, CPU)."""
        return self.mesh.run(_local, self.key)

    def report(self) -> list:
        """Per rank: bytes of its parameters and of its optimizer state."""
        return self.mesh.run(_report, self.key)

    def close(self):
        """Free the state on every rank (the mesh stays up)."""
        self.mesh.run(_drop, self.key)
