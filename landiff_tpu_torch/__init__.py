"""PyTorch / CUDA port of landiff_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module names so each counterpart is found by
path (landiff_tpu/models/dit.py -> landiff_tpu_torch/models/dit.py). The
port imports torch, numpy and the standard library, never jax and nothing
of landiff_tpu. Public functions keep the JAX layouts (BSHD attention,
(B, T, C, H, W) latents, (B, 3, T, H, W) video). Entry points run on
"cuda" unless the caller passes device="cpu".

Ported so far: stage 2 of inference (prompt + semantic tokens -> video),
see pipeline/dif_infer.py. The flash-attention forwards run as CUDA
kernels (ops/csrc/flash_fwd.cu) on the card and as their plain PyTorch
versions on the CPU.
"""
