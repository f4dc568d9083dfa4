"""Parameter bridge: the JAX package's parameter trees, handed over as
numpy arrays, become the port's tensors.

Layouts are converted once here, so the port's forwards call PyTorch's
own operators without transposes:
  - 4-D conv kernels, HWIO (kh, kw, ci, co)      -> OIHW (co, ci, kh, kw)
  - 5-D conv kernels, (kt, kh, kw, ci, co)       -> OIDHW for F.conv3d
Every other array (linear weights stored (in, out) for x @ W, biases,
tables, codebooks, the int8 codes and scales of the quantized trees, which
are 2-D or 1-D, 3-D position tables and LayerNorm affines) keeps its
layout. A leaf that is a Python str, int, float or bool (a head's kind,
its static shapes and conv arguments in theia_translate) crosses
unchanged. bfloat16 arrays (the scales of gpt.quantize_int8 /
quantize_int4) cross bit for bit: numpy holds them as ml_dtypes.bfloat16,
which torch.from_numpy does not take, so their bits go over as uint16 and
are viewed as torch.bfloat16. Every 4-D or 5-D leaf of the port's trees
is a conv kernel, which is what makes the rule by rank safe. An OIHW
kernel is F.conv2d's layout everywhere but in one place: the transposed
convs of models/theia_translate.py, whose F.conv_transpose2d takes (ci,
co, kh, kw), so that module swaps the first two axes of the bridged
kernel (and does not flip it: the JAX package's flip belongs to its
lhs-dilated conv form). The 4-D and 5-D leaves:
  - stage 2: the DiT patchify (also the ControlMLPAdapter's), the
    semantic upsampler, the VAE encoder's and decoder's causal convs
    (5-D) and its down / upsample convs (4-D);
  - the tokenizer: Theia's patch embedding (P, P, 3, D); the TiTok
    encoder's 1x1 patch embedding is a (C, W) matrix, and everything
    else there (positions, register tokens, latent queries, codebook) is
    1-D or 2-D;
  - Theia's translator heads: conv and transposed-conv kernels;
  - stage 1 ({"lm": {"gpt", "tok_emb", "text_proj",
    "null_text_embedding", "micro", and for training "micro_null"},
    "t5"}) holds only vectors and (in, out) matrices and crosses
    unchanged; so do LFQ's projections.
The port's own `init` functions build the converted layouts directly.
"""

from __future__ import annotations

import numpy as np
import torch

from landiff_tpu_torch.utils import tree_map

_PERMUTE = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _convert(a, device):
    if type(a) in (str, int, float, bool):
        return a
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr.view(np.uint16)))
        return bits.view(torch.bfloat16).to(device)
    if arr.ndim in _PERMUTE and np.issubdtype(arr.dtype, np.floating):
        arr = np.transpose(arr, _PERMUTE[arr.ndim])
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy


def to_torch(tree, device="cuda"):
    """A JAX-package parameter tree (dicts / lists of arrays, anything
    numpy can read) -> the same tree of tensors on `device`, conv kernels
    in PyTorch's layouts."""
    return tree_map(lambda a: _convert(a, device), tree)
