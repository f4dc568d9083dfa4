"""A synthetic LanDiff checkpoint tree, written in the release's layout,
file names, formats and key names from the manifests (ckpt/manifests.py),
with random values from a seed: what the loaders are tested and smoke-run
against while no real checkpoint is at hand. Only the values differ from
a real tree of the same configuration.

Files (as ckpts/CHECKSUM.md5 lists them):
  llm/model.safetensors, tokenizer/model.safetensors        f32 safetensors
  CogVideoX-2b-sat/transformer/1000/mp_rank_00_model_states.pt
                                   {"module": {"model." + SAT key: tensor}}
  diffusion/1/mp_rank_00_model_states.pt   {"module": engine ckpt keys}
  CogVideoX-2b-sat/vae/3d-vae.pt           {"state_dict": VAE keys}
  CogVideoX-2b-sat/t5-v1_1-xxl/            bf16 safetensors in two shards
                                           with model.safetensors.index.json
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from landiff_tpu_torch.ckpt import convert, manifests
from landiff_tpu_torch.config import LanDiffConfig

BASE_DIT = ("CogVideoX-2b-sat/transformer/1000/"
            "mp_rank_00_model_states.pt")
ENGINE = "diffusion/1/mp_rank_00_model_states.pt"
VAE = "CogVideoX-2b-sat/vae/3d-vae.pt"
T5_DIR = "CogVideoX-2b-sat/t5-v1_1-xxl"


def random_state_dict(manifest: dict, gen: torch.Generator) -> dict:
    """Random f32 arrays of the manifest's shapes: matrices and kernels
    N(0, 1 / fan_in), 1-D weights 1 + N(0, 0.02^2), other vectors
    N(0, 0.02^2)."""
    out = {}
    for name in sorted(manifest):
        shape = tuple(manifest[name])
        x = torch.randn(shape, generator=gen)
        if len(shape) >= 2:
            x *= 1.0 / math.sqrt(max(1, int(np.prod(shape[1:]))))
        elif name.endswith("weight"):
            x = 1.0 + 0.02 * x
        else:
            x *= 0.02
        out[name] = x.numpy()
    return out


def _save_pt(path: Path, envelope: str, sd: dict) -> int:
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({envelope: {k: torch.from_numpy(v) for k, v in sd.items()}},
               str(path))
    return path.stat().st_size


def write_tree(root, cfg: LanDiffConfig, seed: int = 0) -> dict:
    """Write the tree for `cfg` under `root`. Returns {"files": {relative
    path: bytes}, "state_dicts": {relative path: the flat numpy state
    dict written there (the T5's values as its bf16 file holds them)}}."""
    root = Path(root)
    gen = torch.Generator().manual_seed(seed)
    files, sds = {}, {}

    def st(rel, sd, bf16=()):
        files[rel] = convert.save_safetensors(root / rel, sd, bf16=bf16)
        sds[rel] = sd

    st("llm/model.safetensors", random_state_dict(
        manifests.llm_safetensors(cfg.llm, t5_dim=cfg.t5.d_model), gen))
    st("tokenizer/model.safetensors", random_state_dict(
        manifests.tokenizer_safetensors(cfg.tokenizer), gen))
    base = {"model." + k: v for k, v in random_state_dict(
        manifests.dit_sat(cfg.dit), gen).items()}
    files[BASE_DIT] = _save_pt(root / BASE_DIT, "module", base)
    sds[BASE_DIT] = base
    engine_sd = random_state_dict(manifests.engine_ckpt(cfg), gen)
    files[ENGINE] = _save_pt(root / ENGINE, "module", engine_sd)
    sds[ENGINE] = engine_sd
    vae = random_state_dict(manifests.vae_state_dict(cfg.vae), gen)
    files[VAE] = _save_pt(root / VAE, "state_dict", vae)
    sds[VAE] = vae

    # the T5 in bf16, in two shards with the HF index
    t5 = random_state_dict(manifests.t5_hf_safetensors(cfg.t5), gen)
    keys = sorted(t5)
    half = len(keys) // 2
    weight_map = {}
    for i, part in enumerate((keys[:half], keys[half:])):
        shard = f"model-{i + 1:05d}-of-00002.safetensors"
        rel = f"{T5_DIR}/{shard}"
        files[rel] = convert.save_safetensors(
            root / rel, {k: t5[k] for k in part}, bf16=tuple(part))
        weight_map.update({k: shard for k in part})
    index = root / T5_DIR / "model.safetensors.index.json"
    index.write_text(json.dumps({"weight_map": weight_map}))
    files[f"{T5_DIR}/model.safetensors.index.json"] = index.stat().st_size
    # the values the bf16 files hold, as the reader widens them
    sds[T5_DIR] = {k: convert.round_to_bf16(v) for k, v in t5.items()}
    return {"files": files, "state_dicts": sds}
