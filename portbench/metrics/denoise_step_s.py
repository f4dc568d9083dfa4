"""Seconds per stage-2 denoising step: the window's seconds over the
steps it completed (each a CFG-batch-2 model call and the update)."""


def read(ctx):
    if ctx.get("kind") != "denoise" or not ctx["units"]:
        return None
    return ctx["window_s"] / ctx["units"]
