"""Per-rank parameter bytes of a mesh layout (counterpart of
landiff_tpu/parallel/plan.py): each component's bytes under the placement
the port's mesh path makes, with no device and no allocation (shapes from
the port's init functions under FakeTensorMode; the stage-1 LM's from the
config, since its truncated-normal init reads values).

Placement, as the wrappers shard (parallel/tp_infer.py): under `model` >
1 the DiT in the tp layout with its heads zero-padded to a multiple of
`model` (dit_tp_specs: zero_linear whole), the T5 by T5_RULES and the LM
by GPT_RULES (whole where the heads or widths do not divide), the
semantic conditioner and the VAE whole. A `time` axis shards no weight
(JAX :60-64): under "sp" (model = 1) the DiT is whole on every rank,
under "tpsp" each rank holds its model index's tp part. Under model = 1
the T5s and the LM are not sharded and live on rank 0 alone (the figure
per rank is rank 0's). JAX's plan counts the DiT by
DIT_RULES on the unpadded shapes, which splits zero_linear that its
tp_infer keeps whole and leaves out the padded heads: its dit_control
figure is smaller by zero_linear's (1 - 1/model) share, and at a `model`
that does not divide 30 both DiT figures miss the padded heads' bytes.

Usage: python -m landiff_tpu_torch.parallel.plan --mesh model=4 [--tiny]
       python -m landiff_tpu_torch.parallel.plan --mesh data=1,model=2,time=2
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from landiff_tpu_torch.config import LanDiffConfig, MeshConfig, \
    tiny_test_config
from landiff_tpu_torch.parallel import mesh as mesh_lib
from landiff_tpu_torch.parallel import tp_infer

# the card's memory: torch.cuda.get_device_properties(0).total_memory on
# NVIDIA H100 80GB HBM3 (chip_smoke.py's tp phase prints it)
H100_HBM_BYTES = 85_017_493_504


def _rank_bytes(tree, specs, mesh_cfg: MeshConfig) -> int:
    """One rank's bytes of a tree under its spec tree."""
    sizes = mesh_lib.axis_sizes(mesh_cfg)
    out = []

    def leaf(path, x, spec):
        div = 1
        for ax in spec:
            div *= sizes[ax] if ax is not None else 1
        out.append(x.numel() * x.element_size() // div)

    mesh_lib.map_with_path(leaf, tree, specs)
    return sum(out)


def component_bytes(name: str, tree, cfg: LanDiffConfig,
                    mesh_cfg: MeshConfig) -> tuple[int, int]:
    """(total, per-rank) bytes of one component's tree as the mesh path
    places it. The total is the tree's own; per rank, a DiT counts in the
    tp layout (padded heads included)."""
    tp = mesh_cfg.model
    total = mesh_lib.tree_nbytes(tree)
    if name in ("dit_main", "dit_control") and tp > 1:
        prepped = tp_infer.prep_dit_tp(tree, cfg.dit, tp)
        return total, _rank_bytes(prepped, tp_infer.dit_tp_specs(prepped),
                                  mesh_cfg)
    if name == "t5" and tp > 1 and not (cfg.t5.num_heads % tp
                                        or cfg.t5.d_ff % tp):
        rules = mesh_lib.T5_RULES
    elif name == "lm" and tp > 1 and not (cfg.llm.num_heads % tp
                                          or cfg.llm.mlp_hidden % tp):
        rules = mesh_lib.GPT_RULES
    else:
        return total, total
    return total, _rank_bytes(tree, mesh_lib.param_specs(tree, rules,
                                                         mesh_cfg), mesh_cfg)


def _lm_shapes(cfg: LanDiffConfig, dtype) -> dict:
    """models/lm.init's tree (gpt.init's inside), as meta tensors."""
    c = cfg.llm
    D, M, V, E = c.hidden_size, c.mlp_hidden, c.vocab_size, \
        c.micro_cond_embed_dim
    m = lambda *s: torch.empty(s, dtype=dtype, device="meta")
    block = lambda: {"wqkv": m(D, 3 * D), "wo": m(D, D), "norm0": m(D),
                     "norm1": m(D), "w1": m(D, M), "w3": m(D, M),
                     "w2": m(M, D)}
    return {
        "gpt": {"blocks": [block() for _ in range(c.num_layers)],
                "ln_f": {"w": m(D), "b": m(D)}, "head": m(D, V)},
        "tok_emb": m(V, D),
        "text_proj": {"fc0_w": m(cfg.t5.d_model, D), "fc0_b": m(D),
                      "fc1_w": m(D, D), "fc1_b": m(D)},
        "null_text_embedding": m(D),
        "micro": {k: {"fc0_w": m(E, 512), "fc0_b": m(512),
                      "fc1_w": m(512, D), "fc1_b": m(D)}
                  for k in sorted(c.micro_cond_keys)},
    }


@functools.lru_cache(maxsize=4)
def component_shapes(cfg: LanDiffConfig, dtype=torch.bfloat16) -> dict:
    """Every component's parameter tree, shapes only (fake tensors, read
    and never written)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from landiff_tpu_torch.models import dit as dit_lib
    from landiff_tpu_torch.models import semantic_cond as sc_lib
    from landiff_tpu_torch.models import t5 as t5_lib
    from landiff_tpu_torch.models import vae as vae_lib

    gen = torch.Generator().manual_seed(0)
    with FakeTensorMode():
        comps = {
            "dit_main": dit_lib.init(gen, cfg.dit, dtype=dtype),
            "dit_control": dit_lib.init(gen, cfg.dit, control=True,
                                        dtype=dtype),
            "semantic_cond": sc_lib.init(gen, cfg.tokenizer,
                                         cfg.semantic_cond, dtype),
            "vae": vae_lib.init(gen, cfg.vae, dtype),
            "t5": t5_lib.init(gen, cfg.t5, dtype),
        }
    comps["lm"] = _lm_shapes(cfg, dtype)
    return comps


def plan(mesh_cfg: MeshConfig, cfg: LanDiffConfig | None = None, *,
         dtype=torch.bfloat16) -> dict:
    """Per-component (total, per-rank) parameter bytes of the inference
    layout (plan.py:59), and their sum against the H100's memory."""
    cfg = cfg or LanDiffConfig()
    out = {"mesh": dataclasses.asdict(mesh_cfg), "dtype": str(dtype),
           "components": {}, "per_chip_total_bytes": 0}
    for name, tree in component_shapes(cfg, dtype).items():
        t, c = component_bytes(name, tree, cfg, mesh_cfg)
        out["components"][name] = {"total_bytes": t, "per_chip_bytes": c}
        out["per_chip_total_bytes"] += c
    out["per_chip_total_gib"] = round(
        out["per_chip_total_bytes"] / 1024 ** 3, 3)
    out["h100_hbm_fraction"] = round(
        out["per_chip_total_bytes"] / H100_HBM_BYTES, 3)
    return out


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="data=2,model=4")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    cfg = tiny_test_config() if args.tiny else LanDiffConfig()
    p = plan(mesh_lib.parse_mesh(args.mesh), cfg,
             dtype=getattr(torch, args.dtype))
    print(json.dumps(p, indent=1))


if __name__ == "__main__":
    main()
