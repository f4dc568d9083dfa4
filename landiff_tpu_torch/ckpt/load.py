"""Runtime checkpoint loading: a converted LanDiff checkpoint tree -> the
port's parameter trees of tensors (counterpart of
landiff_tpu/ckpt/load.py).

Checkpoint tree (ckpts/CHECKSUM.md5):
  llm/model.safetensors                      stage-1 Semantic1DLM
  tokenizer/model.safetensors                VideoVQ (TiTok + quantizer)
  diffusion/1/mp_rank_00_model_states.pt     trained control + semantic cond
  CogVideoX-2b-sat/transformer/1000/mp_rank_00_model_states.pt   base DiT
  CogVideoX-2b-sat/vae/3d-vae.pt             causal 3D VAE
  CogVideoX-2b-sat/t5-v1_1-xxl/              stage-2 T5 (HF sharded st)
Stage-1 T5 (flan-t5-xxl) and Theia are looked for in local directories
inside the tree (STAGE1_T5_DIRS, THEIA_DIRS); the reference takes them
from the hub, which the port never reaches, so where none is found the
loader raises and names the paths it looked at.

Each loader runs the port's numpy converter (ckpt/convert.py, the JAX
package's layouts), then `bridge` (HWIO -> OIHW, (kt, kh, kw, ci, co) ->
OIDHW), then puts the tensors on `device` in `dtype` (floating leaves
only, as the JAX loader's `_to_jnp`).

ControlDiffWarp load order (dit_video_concat.py:1164-1194): CogVideoX base
weights into BOTH main and control nets (strict=False), then the LanDiff
diffusion ckpt overrides the trained pieces.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import torch

from landiff_tpu_torch import bridge
from landiff_tpu_torch.ckpt import convert
from landiff_tpu_torch.config import LanDiffConfig
from landiff_tpu_torch.utils import tree_map

logger = logging.getLogger("landiff_tpu_torch.ckpt")

# where a T5 directory may sit inside the tree, per stage, in the JAX
# loaders' order of search
STAGE1_T5_DIRS = ("flan-t5-xxl", "CogVideoX-2b-sat/t5-v1_1-xxl",
                  "t5-v1_1-xxl")
STAGE2_T5_DIR = "CogVideoX-2b-sat/t5-v1_1-xxl"
# where a Theia directory in the HF layout (model.safetensors, or shards
# with model.safetensors.index.json) may sit inside the tree; the
# reference's hub id is theaiinstitute/theia-base-patch16-224-cddsv
THEIA_DIRS = ("theia-base-patch16-224-cddsv", "theia")


def _to_torch(tree, dtype, device):
    """numpy tree (the JAX layouts) -> tensors on `device`, floating
    leaves cast to `dtype`."""
    def leaf(t):
        return t.to(dtype) if t.is_floating_point() else t

    return tree_map(leaf, bridge.to_torch(tree, device=device))


def load_hf_sharded_safetensors(model_dir: str | Path) -> dict:
    """Load HF safetensors (single file or sharded with index.json) as
    mmap-backed numpy views (convert.load_safetensors_views)."""
    model_dir = Path(model_dir)
    index = model_dir / "model.safetensors.index.json"
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        out = {}
        for shard in sorted(set(weight_map.values())):
            out.update(convert.load_safetensors_views(model_dir / shard))
        return out
    return convert.load_safetensors_views(model_dir / "model.safetensors")


def load_stage1(ckpt_dir: str | Path, cfg: LanDiffConfig,
                dtype=torch.float32, device="cuda") -> dict:
    """{"lm": ..., "t5": ...}: the LM from llm/model.safetensors, T5 from
    the first of STAGE1_T5_DIRS inside the tree."""
    from landiff_tpu_torch.models import t5 as t5_lib

    ckpt_dir = Path(ckpt_dir)
    sd = convert.load_torch_file(ckpt_dir / "llm" / "model.safetensors")
    lm = convert.convert_llm(sd, cfg.llm.num_layers)
    t5_dir = next((ckpt_dir / c for c in STAGE1_T5_DIRS
                   if (ckpt_dir / c).exists()), None)
    if t5_dir is None:
        raise FileNotFoundError(
            f"no T5 weights under {ckpt_dir} (looked for "
            f"{', '.join(STAGE1_T5_DIRS)}); the reference fetches "
            "google/flan-t5-xxl from the hub, which the port does not: put "
            "a converted flan-t5-xxl directory into the tree")
    t5 = t5_lib.params_from_hf_state_dict(
        load_hf_sharded_safetensors(t5_dir), cfg.t5, dtype, device)
    return {"lm": _to_torch(lm, dtype, device), "t5": t5}


def load_tokenizer(ckpt_dir: str | Path, cfg: LanDiffConfig,
                   dtype=torch.float32, with_theia: bool = True,
                   device="cuda") -> dict:
    ckpt_dir = Path(ckpt_dir)
    sd = convert.load_torch_file(ckpt_dir / "tokenizer" / "model.safetensors")
    params = _to_torch(convert.convert_tokenizer(sd), dtype, device)
    if with_theia:
        params["theia"] = load_theia(cfg, dtype, device, ckpt_dir=ckpt_dir)
    return params


def _has_safetensors(d: Path) -> bool:
    return ((d / "model.safetensors").exists()
            or (d / "model.safetensors.index.json").exists())


def load_theia(cfg: LanDiffConfig, dtype=torch.float32, device="cuda", *,
               ckpt_dir: str | Path):
    """Theia (frozen, not in the LanDiff release) from the first of
    THEIA_DIRS inside `ckpt_dir` that holds the HF layout. The reference
    downloads theaiinstitute/theia-base-patch16-224-cddsv; the port does
    not, and raises naming the paths it looked at."""
    cands = [Path(ckpt_dir) / d for d in THEIA_DIRS]
    found = next((d for d in cands if _has_safetensors(d)), None)
    if found is None:
        raise FileNotFoundError(
            "no Theia weights (model.safetensors in the HF layout) at "
            + ", ".join(str(d) for d in cands)
            + "; the reference fetches theaiinstitute/theia-base-patch16-"
            "224-cddsv from the hub, which the port does not: put a copy "
            "of it there")
    sd = load_hf_sharded_safetensors(found)
    return _to_torch(convert.convert_theia(sd, cfg.tokenizer.theia.num_layers),
                     dtype, device)


def load_stage2(ckpt_dir: str | Path, cfg: LanDiffConfig,
                dtype=torch.float32, device="cuda") -> dict:
    ckpt_dir = Path(ckpt_dir)
    base_sd = convert.load_torch_file(
        ckpt_dir / "CogVideoX-2b-sat" / "transformer" / "1000"
        / "mp_rank_00_model_states.pt")
    base_sd = {k[6:]: v for k, v in base_sd.items() if k.startswith("model.")}

    landiff_sd = convert.load_torch_file(
        ckpt_dir / "diffusion" / "1" / "mp_rank_00_model_states.pt")
    parts = convert.split_engine_state(landiff_sd)

    # base into both nets, then LanDiff overrides (ControlDiffWarp order)
    main_sd = dict(base_sd)
    main_sd.update(parts["main"])
    control_sd = dict(base_sd)
    control_sd.update({k: v for k, v in parts["control"].items()
                       if not k.startswith("semantic_conditioner.")})

    main = convert.convert_dit(main_sd, cfg.dit.num_layers, control=False)
    control = convert.convert_dit(control_sd, cfg.dit.control_layers,
                                  control=True)
    semantic = convert.convert_semantic_cond(
        parts["semantic"], cfg.semantic_cond.num_res_blocks)
    return {
        "main": _to_torch(main, dtype, device),
        "control": _to_torch(control, dtype, device),
        "semantic": _to_torch(semantic, dtype, device),
        "vae": load_vae(ckpt_dir, cfg, dtype, device),
        "t5": load_stage2_t5(ckpt_dir, cfg, dtype, device),
    }


def load_vae(ckpt_dir: str | Path, cfg: LanDiffConfig, dtype=torch.float32,
             device="cuda"):
    """3d-vae.pt alone (Lightning state_dict; autoencoder.py:603-614)."""
    vae_sd = convert.load_torch_file(
        Path(ckpt_dir) / "CogVideoX-2b-sat" / "vae" / "3d-vae.pt")
    return _to_torch(convert.convert_vae(vae_sd, cfg.vae.num_res_blocks,
                                         len(cfg.vae.ch_mult)), dtype, device)


def load_stage2_t5(ckpt_dir: str | Path, cfg: LanDiffConfig,
                   dtype=torch.float32, device="cuda"):
    """Stage-2 local T5 dir (FrozenT5Embedder, encoders/modules.py:246-295)."""
    from landiff_tpu_torch.models import t5 as t5_lib

    t5_sd = load_hf_sharded_safetensors(Path(ckpt_dir) / STAGE2_T5_DIR)
    return t5_lib.params_from_hf_state_dict(t5_sd, cfg.t5, dtype, device)


def tokenizer_dir(ckpt_dir: str | Path) -> str | None:
    """The T5 tokenizer directory inside a checkpoint tree, searched as
    the JAX entry point does (infer_video.py:46-51), or None."""
    for cand in ("t5-v1_1-xxl", "CogVideoX-2b-sat/t5-v1_1-xxl",
                 "flan-t5-xxl"):
        if (Path(ckpt_dir) / cand).exists():
            return str(Path(ckpt_dir) / cand)
    return None

