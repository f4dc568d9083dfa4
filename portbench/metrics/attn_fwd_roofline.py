"""The DiT attention forward's share of its roofline: the least time of
the window's attention calls over the device time of every kernel of the
class `attn_fwd` (portbench/kernel_classes/attn_fwd: the flash forwards
and their K quantisation prologues), from the profiler's timeline.

The least time of one call counts the exact attention's work whatever
route computes it: the larger of 4 B H S^2 Dk at the bf16 peak and the
bytes of q, k, v and the output, bf16, read or written once, at the HBM
rate. A denoising step makes num_layers + control_layers calls at B = 2.
Kernels of the class outside the DiT's calls (none run in the window
today) would count against it."""


def call_least_s(d, peaks, batch: int = 2) -> float:
    H, Dk, P = d["num_heads"], d["hidden_size"] // d["num_heads"], \
        d["patch_size"]
    S = d["text_length"] + d["latent_frames"] * (
        d["latent_height"] // P) * (d["latent_width"] // P)
    flops = 4.0 * batch * H * S * S * Dk
    byts = 4.0 * batch * S * H * Dk * 2
    return max(flops / peaks["bf16_flops_per_s"],
               byts / peaks["hbm_bytes_per_s"])


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx.get("kind") != "denoise":
        return None
    busy = tr.class_seconds("attn_fwd")
    calls = sum(1 for name, _, _ in ctx["spans"] if name == "dit_call")
    if busy <= 0 or not calls:
        return None
    d = ctx["config"]["dit"]
    n = calls * (d["num_layers"] + d["control_layers"])
    return 100.0 * n * call_least_s(d, ctx["peaks"]) / busy
