"""Milliseconds per call of the denoise closure (the CFG-batch-2 DiT call
with the semantic feature, the scalings and the DynamicCFG combination),
the mean of the harness's `dit_call` spans, which wait for the device at
both ends in a traced run."""


def read(ctx):
    d = [t1 - t0 for name, t0, t1 in ctx["spans"] if name == "dit_call"]
    return 1e3 * sum(d) / len(d) if d else None
