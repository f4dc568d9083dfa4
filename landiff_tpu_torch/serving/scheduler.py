"""Continuous micro-batching serving engine (counterpart of
landiff_tpu/serving/scheduler.py).

The reference serves one request at a time, swapping each model on and off
the card per request (gradio/main.py:31-92). Here both stages stay
resident. Stage 1 draws one token per decode step and reads every GPT
weight at each step, so N concurrent requests coalesce into ONE batched
decode (`ArModelInferWrapper.infer_batch` -> lm.sample_batch, 2N rows
with guidance): the weights are read once a step for all of them. In f32
each prompt's codes equal its single call's; in bf16 the batched products
round differently and the codes may part (ROADMAP §3).

Pieces:
  - `Stage1Batcher`: bounded linger-window request coalescer. Requests
    enqueue a (CodeTask, Future); a worker thread drains up to
    `max_batch` tasks after `linger_s`, runs one batched decode and
    resolves the futures.
  - `ServingEngine`: builds the pipeline once (the reference rebuilds /
    reloads per request), routes stage 1 through the batcher and runs
    stage 2 (diffusion + VAE: one request fills the card, nothing to
    coalesce) FIFO under a device lock. Per-request seconds and the batch
    sizes are exposed via `stats()`.

With a mesh (`build(mesh_spec=...)`) the wrappers run over its ranks
(parallel/mesh.py: tensor-parallel over `model`, sequence-parallel over
`time`); the engine and its threads stay in
rank 0, a stage-1 batch is one stage-1 command, a stage 2 one denoise
command, and the mesh runs one command at a time. shutdown() stops the
mesh's workers.

The worker thread and the callers' threads run device work off the main
thread; `torch.inference_mode` is thread-local, and the wrappers' own
decorators (`ArModelInferWrapper.__call__` / `infer_batch`,
`CogModelInferWrapper.__call__`) put each call under it.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from landiff_tpu_torch.pipeline import dif_infer, llm_infer

logger = logging.getLogger("landiff_tpu_torch.serving")


class Stage1Batcher:
    """Coalesce concurrent stage-1 requests into batched AR decodes.

    submit() is thread-safe and returns a Future resolving to the completed
    CodeTask. The worker drains the queue after a `linger_s` window (bounded
    by `max_batch`); a batch of 1 runs infer_batch on one prompt, so the
    latency under light load is the linger window only. A failed decode
    fails every request of its batch.
    """

    def __init__(self, llm: llm_infer.ArModelInferWrapper,
                 max_batch: int = 8, linger_s: float = 0.05):
        self.llm = llm
        self.max_batch = max_batch
        self.linger_s = linger_s
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        self.batch_sizes: list[int] = []
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, task: llm_infer.CodeTask) -> Future:
        fut: Future = Future()
        with self._submit_lock:     # no request is queued behind shutdown
            if self._closed:
                raise RuntimeError("batcher is shut down")
            self._q.put((task, fut))
        return fut

    def shutdown(self, timeout: float = 30.0):
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=timeout)

    def _loop(self):
        while True:
            head = self._q.get()
            if head is None:
                return
            if self.linger_s > 0:
                time.sleep(self.linger_s)  # let concurrent requests pile up
            batch = [head]
            while len(batch) < self.max_batch:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    self._run(batch)
                    return
                batch.append(item)
            self._run(batch)

    def _run(self, batch):
        tasks = [t for t, _ in batch]
        futs = [f for _, f in batch]
        self.batch_sizes.append(len(tasks))
        try:
            done = self.llm.infer_batch(tasks)
        except Exception as e:  # the worker keeps serving; every waiter
            logger.exception("stage-1 batch of %d failed", len(tasks))
            for f in futs:
                f.set_exception(e)
            return
        for f, task in zip(futs, done):
            f.set_result(task)


class ServingEngine:
    """Resident two-stage pipeline with stage-1 micro-batching.

    generate() is safe to call from many threads (one per HTTP request):
    stage 1 coalesces in the batcher, stage 2 serializes on the device
    lock. Videos are returned as (B, 3, T, H, W) float32 in [0, 1], the
    contract of pipeline/infer_video.generate.
    """

    def __init__(self, llm: llm_infer.ArModelInferWrapper,
                 dif: dif_infer.CogModelInferWrapper,
                 max_batch: int = 8, linger_s: float = 0.05):
        self.llm = llm
        self.dif = dif
        self.batcher = Stage1Batcher(llm, max_batch, linger_s)
        self._device_lock = threading.Lock()
        self._n_requests = 0
        self._stats_lock = threading.Lock()

    @classmethod
    def build(cls, tiny: bool = False, ckpt_dir: str | None = None,
              mesh_spec: str | None = None, cfg_scale: float = 7.5,
              motion_score: float = 0.1, num_frames: int = 13,
              max_batch: int = 8, linger_s: float = 0.05,
              seed: int = 0, device="cuda",
              require_real_tokenizer: bool | None = None) -> "ServingEngine":
        """Both stages through infer_video.build_pipeline: f32 with the
        tiny config (one tiny segment), else bf16. require_real_tokenizer
        as build_pipeline's (a checkpoint tree without tokenizer files, a
        synthetic one, passes False). mesh_spec: "data=D,model=N,time=T",
        ranks on `device` (one per GPU for cuda)."""
        from landiff_tpu_torch.config import ARSampleConfig, LanDiffConfig, \
            tiny_test_config
        from landiff_tpu_torch.pipeline.infer_video import build_pipeline

        cfg = tiny_test_config() if tiny else LanDiffConfig()
        if tiny:
            num_frames = cfg.llm.frames_per_segment
        sample_cfg = ARSampleConfig(cfg_scale=cfg_scale,
                                    motion_score=motion_score,
                                    num_frames=num_frames, seed=seed)
        dtype = torch.float32 if tiny else torch.bfloat16
        llm, dif = build_pipeline(
            cfg, sample_cfg, seed, ckpt_dir, compute_dtype=dtype,
            mesh=mesh_spec or None, device=device,
            require_real_tokenizer=require_real_tokenizer)
        return cls(llm, dif, max_batch=max_batch, linger_s=linger_s)

    def _now(self) -> float:
        if self.dif.device.type == "cuda":
            torch.cuda.synchronize(self.dif.device)
        return time.perf_counter()

    def generate(self, prompt: str, seed: int = 42, fps: int = 8) -> dict:
        """{"codes", "video", "stage1_s", "stage2_s", "stage2_phases"}:
        stage1_s from the submit to the codes (linger window and batch
        included), stage2_s from the codes to the video (the wait for the
        device lock included); host seconds, read after a device
        synchronise. stage2_phases: the stage-2 wrapper's phase seconds
        of this request."""
        t0 = time.perf_counter()
        fut = self.batcher.submit(
            llm_infer.CodeTask(save_file_name="serving.npy", prompt=prompt))
        code_task = fut.result()
        t1 = self._now()
        with self._device_lock:
            video_task = self.dif(dif_infer.VideoTask(
                save_file_name="serving.mp4", prompt=prompt, seed=seed,
                fps=fps, semantic_token=code_task.result))
            t2 = self._now()
            phases = dict(self.dif.phase_seconds)
        with self._stats_lock:
            self._n_requests += 1
        return {"codes": code_task.result, "video": video_task.result,
                "stage1_s": t1 - t0, "stage2_s": t2 - t1,
                "stage2_phases": phases}

    def stats(self) -> dict:
        sizes = list(self.batcher.batch_sizes)
        return {"requests": self._n_requests,
                "stage1_batches": len(sizes),
                "stage1_batch_sizes": sizes,
                "mean_batch": float(np.mean(sizes)) if sizes else 0.0}

    def shutdown(self):
        self.batcher.shutdown()
        if self.dif.mesh is not None:
            self.dif.mesh.close()
