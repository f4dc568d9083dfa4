"""The denoising step's share of the card's bf16 peak: the step's model
FLOPs, counted from the configuration, over the traced window's seconds
per step times the peak.

Counted: every linear as 2 x parameters x rows (the layers' four
matrices on every token of both CFG rows, the control layers' output
linears, the adaLN, time, patch, text and head linears on their own
rows), attention as 4 B H S^2 Dk. Not counted: norms, elementwise work,
the semantic conditioner (made once per request, in set-up)."""


def step_flops(d, batch: int = 2) -> float:
    D, H = d["hidden_size"], d["num_heads"]
    Dk, P, TE = D // H, d["patch_size"], d["time_embed_dim"]
    vid = (d["latent_frames"] * (d["latent_height"] // P)
           * (d["latent_width"] // P))
    S = d["text_length"] + vid
    rows = batch * S
    layer = (2 * 12 * D * D * rows            # qkv, out, mlp0, mlp1
             + 2 * TE * 12 * D * batch          # adaLN
             + 4 * batch * H * S * S * Dk)      # attention
    embed = (2 * d["in_channels"] * P * P * D * batch * vid
             + 2 * d["text_dim"] * D * batch * d["text_length"]
             + 2 * (D * TE + TE * TE) * batch)
    head = (2 * TE * 2 * D * batch
            + 2 * D * P * P * d["out_channels"] * batch * vid)
    n_main, n_ctrl = d["num_layers"], d["control_layers"]
    return ((n_main + n_ctrl) * layer + n_ctrl * 2 * D * D * rows
            + 2 * embed + head)


def read(ctx):
    if ctx.get("kind") != "denoise" or not ctx["units"] \
            or ctx["trace"] is None:
        return None
    per_step = ctx["window_s"] / ctx["units"]
    return 100.0 * step_flops(ctx["config"]["dit"]) / (
        per_step * ctx["peaks"]["bf16_flops_per_s"])
