"""Share of the traced decode window in which no kernel, copy or set ran
on the device (the union of their intervals on the profiler's
timeline)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx.get("kind") != "vae_decode" or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
