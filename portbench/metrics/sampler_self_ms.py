"""Milliseconds per step spent outside the model call: each completed
step's span (unit boundary to unit boundary, both waiting for the
device) minus its `dit_call` span, averaged over the window's steps. That
is the sampler's update and its bookkeeping."""


def read(ctx):
    calls = [(t0, t1) for name, t0, t1 in ctx["spans"] if name == "dit_call"]
    selfs = []
    for a, b in ctx["unit_spans"]:
        inside = sum(t1 - t0 for t0, t1 in calls if a <= t0 and t1 <= b)
        selfs.append((b - a) - inside)
    if not calls or not selfs:
        return None
    return 1e3 * sum(selfs) / len(selfs)
