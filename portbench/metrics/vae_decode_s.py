"""Seconds per VAE decode of one clip's latents to a post-processed
uint8 video: the window's seconds over the decodes it completed."""


def read(ctx):
    if ctx.get("kind") != "vae_decode" or not ctx["units"]:
        return None
    return ctx["window_s"] / ctx["units"]
