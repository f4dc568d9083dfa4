"""A configuration file's groups as the program's configuration tree."""

from __future__ import annotations


def port_config(config: dict):
    """The port's LanDiffConfig for a configuration file: its "dit",
    "sampler", "vae" and "semantic" groups; every other group keeps the
    program's defaults (they are not run by the cells here)."""
    from landiff_tpu_torch import config as C

    s = config["semantic"]
    t = dict(s["titok"])
    t["rope"] = C.Rope3DConfig(**t["rope"])
    tok = C.TokenizerConfig(titok=C.TiTokConfig(**t), vq=C.VQConfig(
        **s["vq"]), feature_dim=s["feature_dim"])
    sem = C.SemanticCondConfig(
        z_channels=s["z_channels"], upsample_ch=s["upsample_ch"],
        ch_mult=tuple(s["ch_mult"]), num_res_blocks=s["num_res_blocks"],
        up_out_channels=s["up_out_channels"],
        out_channels=s["out_channels"])
    v = dict(config["vae"])
    v["ch_mult"] = tuple(v["ch_mult"])
    return C.LanDiffConfig(dit=C.DiTConfig(**config["dit"]),
                           sampler=C.SamplerConfig(**config["sampler"]),
                           vae=C.VAEConfig(**v), semantic_cond=sem,
                           tokenizer=tok)
