"""PyTorch / CUDA port of landiff_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module names so each counterpart is found by
path (landiff_tpu/models/dit.py -> landiff_tpu_torch/models/dit.py). The
port imports torch, numpy and the standard library, never jax and nothing
of landiff_tpu. Public functions keep the JAX layouts (BSHD attention,
(B, T, C, H, W) latents, (B, 3, T, H, W) video). Entry points run on
"cuda" unless the caller passes device="cpu".

Ported so far: inference, prompt -> semantic tokens -> video, of one
segment or several (pipeline/infer_video.py, long_video.py), with an
optional prefix video (image to video), from random weights or a
converted checkpoint tree (ckpt/); the tokenizer's encode side, video ->
codes (Theia, TiTok encoder, VQ) and video -> VAE latents; training of
the stage-2 control branch, the stage-1 LM and the tokenizer
(training/train.py) and its data preparation (data/prepare.py). The
flash-attention forwards and backward (bf16 and f32) and the fused adaLN
modulate run as CUDA kernels (ops/csrc/) on the card and as their plain
PyTorch versions on the CPU.
"""
