"""The VAE decode's share of the card's bf16 peak: the decoder's
convolution FLOPs (every 3-D and per-frame convolution and 1x1x1
projection of the chunked decode, counted from the shapes by
torch.utils.flop_counter over the plain reference on the meta device)
over the traced window's seconds per decode times the peak."""

import functools
import json


@functools.lru_cache(maxsize=4)
def decode_flops(vae_json: str, lat_json: str) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import vae as ref_vae

    v, d = json.loads(vae_json), json.loads(lat_json)

    def meta(spec):
        if isinstance(spec, dict):
            return {k: meta(x) for k, x in spec.items()}
        if isinstance(spec, list):
            return [meta(x) for x in spec]
        return torch.empty(spec[0], device="meta")

    z = torch.empty((1, d["latent_frames"], v["z_channels"],
                     d["latent_height"], d["latent_width"]), device="meta")
    with FlopCounterMode(display=False) as fc:
        ref_vae.decode(meta(ref_vae.param_spec(v)), z, v)
    return float(fc.get_total_flops())


def read(ctx):
    if ctx.get("kind") != "vae_decode" or not ctx["units"] \
            or ctx["trace"] is None:
        return None
    cfg = ctx["config"]
    flops = decode_flops(json.dumps(cfg["vae"], sort_keys=True),
                         json.dumps(cfg["dit"], sort_keys=True))
    per = ctx["window_s"] / ctx["units"]
    return 100.0 * flops / (per * ctx["peaks"]["bf16_flops_per_s"])
