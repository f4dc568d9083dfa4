"""Web demo: prompt -> video (counterpart of landiff_tpu/serving/app.py),
mirroring the reference gradio app (gradio/main.py: both wrappers built
once, per-request generation with cfg-scale / motion / seed sliders
:108-144).

Uses gradio when available; otherwise a stdlib http.server with the same
controls: GET / (the form), GET /stats (the engine's counters as JSON),
POST /generate (the video as an animated GIF in the page). Both stages
stay on the card, built once into a resident ServingEngine
(serving/scheduler.py) that coalesces concurrent stage-1 decodes into one
batched AR loop; a changed slider rebuilds it, after the old one is freed.
With `--mesh data=D,model=N,time=T` the engine's stages run over that
many ranks, tensor-parallel over `model` and sequence-parallel over
`time` (serving/scheduler.py); the server stays in rank 0.

Run: python -m landiff_tpu_torch.serving.app [--tiny] [--device cpu]
[--port 7860] [--mesh model=2 | --mesh data=1,time=2]
"""

from __future__ import annotations

import argparse
import base64
import gc
import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from landiff_tpu_torch.parallel import mesh as mesh_lib

logger = logging.getLogger("landiff_tpu_torch.serving")

_PIPELINE = {}
_LOCK = threading.Lock()


def _engine(cfg_scale: float, motion_score: float):
    """The resident ServingEngine, built once per (cfg_scale, motion_score)
    (the sliders that change stage 1's program); concurrent requests
    coalesce their stage-1 decodes inside it. Both stages at full width
    take most of the card, so the old engine is shut down and freed
    before a new one is built."""
    from landiff_tpu_torch.serving.scheduler import ServingEngine

    key = (cfg_scale, motion_score)
    with _LOCK:
        if _PIPELINE.get("engine_key") != key:
            old = _PIPELINE.pop("engine", None)
            _PIPELINE.pop("engine_key", None)
            if old is not None:
                old.shutdown()
                del old
                gc.collect()
                torch.cuda.empty_cache()    # a no-op without a card
            _PIPELINE["engine"] = ServingEngine.build(
                tiny=_PIPELINE.get("tiny", False),
                ckpt_dir=_PIPELINE.get("ckpt_dir"),
                cfg_scale=cfg_scale, motion_score=motion_score,
                max_batch=_PIPELINE.get("max_batch", 8),
                linger_s=_PIPELINE.get("linger_s", 0.05),
                mesh_spec=_PIPELINE.get("mesh_spec"),
                device=_PIPELINE.get("device", "cuda"))
            _PIPELINE["engine_key"] = key
        return _PIPELINE["engine"]


def _generate(prompt: str, cfg_scale: float, motion_score: float, seed: int):
    return _engine(cfg_scale, motion_score).generate(prompt, seed=seed)


def _video_to_gif_bytes(video: np.ndarray, fps: int = 8) -> bytes:
    """(1, 3, T, H, W) in [0, 1] -> an animated GIF, by PIL (already the
    port's image codec; the card's image has no imageio), 256 colours a
    frame by PIL's fast octree quantizer."""
    from PIL import Image

    from landiff_tpu_torch.utils import cthw_to_uint8

    frames = [Image.fromarray(f).quantize(256,
                                          method=Image.Quantize.FASTOCTREE)
              for f in cthw_to_uint8(video[0])]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True,
                   append_images=frames[1:], duration=1000.0 / fps, loop=0)
    return buf.getvalue()


_PAGE = """<!doctype html><title>LanDiff</title>
<h2>LanDiff text-to-video</h2>
<form method=post action=/generate>
Prompt: <input name=prompt size=60 value="a cat playing piano"><br>
CFG scale: <input name=cfg_scale value=7.5>
Motion: <input name=motion value=0.1>
Seed: <input name=seed value=42><br>
<button>Generate</button></form>
"""


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, ctype: str, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/stats":
            eng = _PIPELINE.get("engine")
            body = json.dumps(eng.stats() if eng is not None
                              else {"requests": 0}).encode()
            self._send(200, "application/json", body)
            return
        self._send(200, "text/html", _PAGE.encode())

    def do_POST(self):
        from urllib.parse import parse_qs

        length = int(self.headers.get("Content-Length", 0))
        q = parse_qs(self.rfile.read(length).decode())
        try:
            args = (q["prompt"][0], float(q["cfg_scale"][0]),
                    float(q["motion"][0]), int(q["seed"][0]))
        except (KeyError, ValueError) as e:
            self.send_error(400, f"bad form field: {e}")
            return
        try:
            res = _generate(*args)
            gif = _video_to_gif_bytes(res["video"])
        except Exception as e:  # the server keeps serving
            logger.exception("request failed")
            self.send_error(500, f"generation failed: {e}")
            return
        b64 = base64.b64encode(gif).decode()
        body = (_PAGE + f"<p>stage1 {res['stage1_s']:.1f}s, stage2 "
                f"{res['stage2_s']:.1f}s</p>"
                f'<img src="data:image/gif;base64,{b64}">')
        self._send(200, "text/html", body.encode())

    def log_message(self, fmt, *args):
        logger.info(fmt, *args)


def launch_gradio(port: int):
    import gradio as gr

    def fn(prompt, cfg_scale, motion, seed):
        import tempfile

        from landiff_tpu_torch.utils import save_video_tensor

        res = _generate(prompt, cfg_scale, motion, int(seed))
        out = tempfile.mkdtemp(prefix="landiff_serving_")
        return str(save_video_tensor(res["video"][0], f"{out}/video.mp4"))

    demo = gr.Interface(
        fn=fn,
        inputs=[gr.Textbox(label="Prompt"),
                gr.Slider(0, 15, value=7.5, label="CFG scale"),
                gr.Slider(0, 1, value=0.1, label="Motion score"),
                gr.Number(value=42, label="Seed")],
        outputs=gr.Video(label="Generated video"),
        title="LanDiff")
    demo.launch(server_port=port)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="LanDiff text-to-video demo server (PyTorch / CUDA port)")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--tiny", action="store_true",
                        help="tiny random-init config (no ckpts; smoke)")
    parser.add_argument("--ckpt-dir", default=None)
    parser.add_argument("--mesh", default=None,
                        help="a mesh of ranks, e.g. model=2 or "
                             "data=1,time=2 (ranks on --device)")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="stage-1 micro-batch cap (batched AR decode)")
    parser.add_argument("--batch-window-ms", type=float, default=50.0,
                        help="linger window for coalescing stage-1 requests")
    parser.add_argument("--device", default="cuda",
                        help="torch device of both stages (cuda, cpu)")
    args = parser.parse_args(argv)
    if args.mesh:           # a malformed spec fails before anything runs
        mesh_lib.parse_mesh(args.mesh)
    logging.basicConfig(level=logging.INFO)
    _PIPELINE["tiny"] = args.tiny
    _PIPELINE["ckpt_dir"] = args.ckpt_dir
    _PIPELINE["max_batch"] = args.max_batch
    _PIPELINE["linger_s"] = args.batch_window_ms / 1000.0
    _PIPELINE["device"] = args.device
    _PIPELINE["mesh_spec"] = args.mesh
    try:
        launch_gradio(args.port)
    except ImportError:
        logger.info("gradio unavailable; stdlib server on :%d", args.port)
        ThreadingHTTPServer(("0.0.0.0", args.port), _Handler).serve_forever()


if __name__ == "__main__":
    main()
