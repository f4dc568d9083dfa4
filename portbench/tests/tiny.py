"""A tiny configuration of the cells for the CPU tests: the structure of
landiff-2b (or cogvideox-5b's rotary positions) at small widths."""

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def config(name: str = "landiff-2b") -> dict:
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c = copy.deepcopy(c)
    c["dit"].update(num_layers=2, hidden_size=64, num_heads=4, in_channels=4,
                    out_channels=4, latent_frames=3, latent_height=8,
                    latent_width=12, text_length=8,
                    time_embed_dim=32, adm_in_channels=16, control_layers=1)
    # T5 features keep their published width: the text projection then
    # weighs the context as at full size
    c["dit"]["text_dim"] = 4096
    s = c["semantic"]
    s.update(feature_dim=32, z_channels=32, upsample_ch=16, num_res_blocks=1,
             up_out_channels=8, out_channels=4)
    s["titok"].update(width=32, num_layers=2, num_heads=2, token_size=32,
                      grid_h=4, grid_w=6, temporal_size=3,
                      iframe_latent_tokens=6, pframe_latent_tokens=2)
    s["titok"]["rope"].update(dim=16, max_time=8, max_height=4, max_width=6,
                              one_dim_max_time=64)
    s["vq"].update(codebook_size=32, dim=32, codebook_dim=4)
    c["vae"].update(ch=8, ch_mult=[1, 2], num_res_blocks=1, z_channels=4,
                    temporal_compress_level=1, norm_num_groups=4)
    c["sampler"]["num_steps"] = 6
    return c


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def cell(name: str, config_name: str, traffic_name: str) -> dict:
    return {"name": name, "config": config_name, "traffic": traffic_name,
            "chips": 1}
