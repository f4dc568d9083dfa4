"""Training-data preparation: raw clips -> Theia features -> semantic
codes -> .npz shards for the training driver (counterpart of
landiff_tpu/data/prepare.py).

The token-production path (reference llm/modules/tokenizer.py:90-102,
encode_codes over 13-frame segments), run offline over a clip directory:

  python -m landiff_tpu_torch.data.prepare --clips DIR --out DIR \\
      [--model vq|lm|dit] [--tiny] [--shard-size 8] [--ckpt-dir DIR] \\
      [--device cuda]

Clip formats (no ffmpeg needed):
  * <clips>/<name>.npy        (T, H, W, 3) uint8 array
  * <clips>/<name>.avi        MJPEG-AVI (the native threaded JPEG decode,
                              landiff_tpu_torch/native; PIL fallback)
  * <clips>/<name>/*.png|jpg  a directory of frames (sorted)
Captions (for --model lm / dit): <clips>/captions.json {name: caption};
for lm the caption rides along in the shard (a string array), so stage-1
training can encode it with its own T5.

Outputs (keys match training/train.py's dataset contract):
  vq:  features (N, T_seg, gh, gw, C) f32          tokenizer training
  lm:  codes (N, latent_tokens) i32, caption (N,)  stage-1 training
  dit: latents (N, T', C, H', W') f32 (VAE encode, the posterior's mode,
       scale_factor applied), context (N, text_len, text_dim) f32 (the
       frozen stage-2 T5), tokens (N, latent_tokens) i32
                                                   stage-2 ControlNet
Without --ckpt-dir the weights are random from fixed seeds; with it the
tokenizer (and Theia, ckpt/load.load_theia), the VAE and the stage-2 T5
come from the tree.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("landiff_tpu_torch.prepare")


def load_clip(path: Path) -> np.ndarray:
    """-> (T, H, W, 3) uint8."""
    if path.suffix == ".npy":
        arr = np.load(path)
    elif path.suffix == ".avi":
        from landiff_tpu_torch import video_io

        arr, _ = video_io.read_mjpeg_avi(path)  # native threaded decode
    elif path.is_dir():
        from PIL import Image

        frames = sorted(p for p in path.iterdir()
                        if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
        arr = np.stack([np.asarray(Image.open(f).convert("RGB"))
                        for f in frames])
    else:
        raise ValueError(f"unsupported clip {path}")
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"clip {path}: shape {arr.shape}, want (T, H, W, 3)")
    return arr.astype(np.uint8)


def iter_clips(root: Path):
    for p in sorted(root.iterdir()):
        if p.name == "captions.json":
            continue
        if p.suffix in (".npy", ".avi") or p.is_dir():
            yield p.stem, load_clip(p)


def segment(video: np.ndarray, seg_len: int, stride: int):
    """Full segments only (the ragged tail is dropped)."""
    T = video.shape[0]
    for off in range(0, T - seg_len + 1, stride):
        yield video[off:off + seg_len]


@torch.inference_mode()
def prepare(clips_dir: str, out_dir: str, *, model: str = "vq",
            tiny: bool = False, shard_size: int = 8,
            compute_dtype=torch.bfloat16, ckpt_dir: str | None = None,
            device="cuda"):
    from landiff_tpu_torch.config import LanDiffConfig, tiny_test_config
    from landiff_tpu_torch.data.loader import write_npz_shards
    from landiff_tpu_torch.models import vq as vq_lib

    full_cfg = tiny_test_config() if tiny else LanDiffConfig()
    cfg = full_cfg.tokenizer
    device = torch.device(device)
    if ckpt_dir is not None:
        from landiff_tpu_torch.ckpt import load as ckpt_load

        params = ckpt_load.load_tokenizer(ckpt_dir, full_cfg,
                                          dtype=compute_dtype, device=device)
    else:
        # random weights still run the whole path (Theia -> TiTok -> VQ)
        gen = torch.Generator(device=device).manual_seed(0)
        params = vq_lib.init(gen, cfg, dtype=compute_dtype)

    def feats_fn(v):
        return vq_lib.extract_features(params, v, cfg,
                                       compute_dtype=compute_dtype)

    def codes_fn(f):
        return vq_lib.encode_features_to_index(
            params, f, cfg, compute_dtype=compute_dtype)[1]

    if model == "dit":
        from landiff_tpu_torch.diffusion import engine
        from landiff_tpu_torch.models import t5 as t5_lib
        from landiff_tpu_torch.models import vae as vae_lib
        from landiff_tpu_torch.pipeline.text import T5Text

        if ckpt_dir is not None:
            vae_p = ckpt_load.load_vae(ckpt_dir, full_cfg,
                                       dtype=compute_dtype, device=device)
            t5_p = ckpt_load.load_stage2_t5(ckpt_dir, full_cfg,
                                            dtype=compute_dtype,
                                            device=device)
        else:
            vae_p = vae_lib.init(torch.Generator(device=device).manual_seed(1),
                                 full_cfg.vae, dtype=compute_dtype)
            t5_p = t5_lib.init(torch.Generator(device=device).manual_seed(2),
                               full_cfg.t5, dtype=compute_dtype)
        text = T5Text(full_cfg.t5.model_name or None,
                      max_length=full_cfg.dit.text_length,
                      padding_side="right")

        def encode_latents(seg):
            # (T, H, W, 3) uint8 -> [-1, 1] (1, 3, T, H, W) -> latents
            v = torch.from_numpy(seg).to(device).float() / 127.5 - 1.0
            return engine.encode_first_stage(
                vae_p, v.permute(3, 0, 1, 2)[None], full_cfg.vae,
                compute_dtype=compute_dtype)

        def encode_context(caption):
            ids, _ = text([caption], pad_to_max=True)
            return t5_lib.encode(t5_p, torch.from_numpy(ids).to(device),
                                 None, full_cfg.t5,
                                 compute_dtype=compute_dtype)

    captions = {}
    cap_file = Path(clips_dir) / "captions.json"
    if cap_file.exists():
        captions = json.loads(cap_file.read_text())

    rows: dict[str, list] = {}

    def add(key, value):
        rows.setdefault(key, []).append(value)

    def host(t, dtype):
        return t.float().cpu().numpy().astype(dtype)

    if model == "dit":
        # one stage-2 sample = 1 + (latent_frames - 1) * 2^lvl RGB frames
        # (49 at full size); the tokenizer sees the 2^lvl-strided subsample
        # (13 frames), so its token segment aligns 1:1 with the latent
        # frames (the conditioner decodes with forward_t = latent_frames)
        stride_t = 2 ** full_cfg.vae.temporal_compress_level
        seg_len = 1 + (full_cfg.dit.latent_frames - 1) * stride_t
        seg_stride = seg_len
    else:
        stride_t = 1
        seg_len = cfg.segment_length
        seg_stride = cfg.segment_stride

    for name, video in iter_clips(Path(clips_dir)):
        if model == "dit":
            # the frozen-T5 context depends only on the caption
            clip_ctx = host(encode_context(captions.get(name, ""))[0],
                            np.float32)
        for seg in segment(video, seg_len, seg_stride):
            tok_frames = np.ascontiguousarray(
                seg[::stride_t][:cfg.segment_length])
            feats = feats_fn(torch.from_numpy(tok_frames).to(device)[None])
            if model == "vq":
                add("features", host(feats[0], np.float32))
                continue
            codes = codes_fn(feats)                        # (1, L)
            if model == "lm":
                add("codes", host(codes[0], np.int32))
                add("caption", captions.get(name, ""))
            else:                                          # dit
                add("tokens", host(codes[0], np.int32))
                add("latents", host(encode_latents(seg)[0], np.float32))
                add("context", clip_ctx)
        logger.info("clip %s: %d frames", name, video.shape[0])

    data = {k: np.stack(v) if k != "caption" else np.asarray(v)
            for k, v in rows.items()}
    shards = write_npz_shards(data, out_dir, shard_size)
    n = len(next(iter(data.values())))
    logger.info("wrote %d segments into %d shards under %s", n,
                len(shards), out_dir)
    return shards


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clips", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", choices=("vq", "lm", "dit"), default="vq")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--shard-size", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="LanDiff checkpoint tree; omitted = random weights")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    args = ap.parse_args(argv)
    prepare(args.clips, args.out, model=args.model, tiny=args.tiny,
            shard_size=args.shard_size, ckpt_dir=args.ckpt_dir,
            device=args.device)


if __name__ == "__main__":
    main()
