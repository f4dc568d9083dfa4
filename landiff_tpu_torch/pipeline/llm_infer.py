"""Stage-1 inference wrapper: prompt -> semantic token codes (counterpart
of landiff_tpu/pipeline/llm_infer.py).

Reference: landiff/llm/llm_infer.py (ArModelInferWrapper :58-105,
ARSampleCfg :13-46, CodeTask :49-55).

Everything stays on one device. The wrapper casts the GPT blocks and the
T5 matrices to the compute dtype once, when it is built: the decode reads
every GPT weight at every one of its ~1,245 steps, and a cast at use (what
the stage-2 modules do) would read the f32 copy each time. The results are
those of casting at use. Not ported yet: the mesh (tensor-parallel) path
and the weight-only int8 / int4 decode.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from landiff_tpu_torch.config import ARSampleConfig, LLMConfig, T5Config
from landiff_tpu_torch.models import gpt as gpt_lib
from landiff_tpu_torch.models import lm as lm_lib
from landiff_tpu_torch.models import t5 as t5_lib
from landiff_tpu_torch.pipeline.text import T5Text
from landiff_tpu_torch.utils import env_flag

logger = logging.getLogger("landiff_tpu_torch.llm_infer")


@dataclass
class CodeTask:
    """Matches llm_infer.py:49-55."""

    save_file_name: str
    prompt: str
    result: np.ndarray | None = None


class ArModelInferWrapper:
    """Builds the LM from params, runs constrained AR sampling.

    Args:
      params: {"lm": lm params, "t5": t5 params}, tensors on `device`
        (random-init for smoke runs).

    After each call, `phase_seconds` holds the host seconds (synchronised
    on the device) of its phases: prompt (T5 and prompt assembly) and
    sample (prefill and the decode loop).
    """

    def __init__(self, params, llm_cfg: LLMConfig, t5_cfg: T5Config,
                 sample_cfg: ARSampleConfig | None = None,
                 tokenizer_dir: str | None = None,
                 compute_dtype=torch.bfloat16,
                 int8_decode: bool | None = None,
                 int4_decode: bool | None = None,
                 mesh=None, device="cuda"):
        if int8_decode is None:
            int8_decode = env_flag("LANDIFF_DECODE_INT8")
        if int4_decode is None:
            int4_decode = env_flag("LANDIFF_DECODE_INT4")
        if int8_decode or int4_decode:
            raise NotImplementedError(
                "weight-only int8 / int4 decode (LANDIFF_DECODE_INT8, "
                "LANDIFF_DECODE_INT4, LANDIFF_FAST) is not ported yet: "
                "ROADMAP item 8, the fast serving configuration slice")
        if mesh is not None:
            raise NotImplementedError(
                "the tensor-parallel stage 1 is not ported yet: ROADMAP "
                "item 15")
        lm_params = dict(params["lm"])
        lm_params["gpt"] = gpt_lib.cast_blocks(lm_params["gpt"],
                                               compute_dtype)
        self.params = {"lm": lm_params,
                       "t5": t5_lib.cast_matmul_weights(params["t5"],
                                                        compute_dtype)}
        self.llm_cfg = llm_cfg
        self.t5_cfg = t5_cfg
        self.sample_cfg = sample_cfg or ARSampleConfig()
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.phase_seconds: dict[str, float] = {}
        self.text = T5Text(tokenizer_dir or t5_cfg.model_name or None,
                           max_length=t5_cfg.max_length, padding_side="left")

    def encode_text(self, prompt: str):
        """T5 encode, unpadded features (conditioner.py:230-264 path)."""
        ids, mask = self.text([prompt])
        emb = t5_lib.encode(self.params["t5"],
                            torch.from_numpy(ids).to(self.device),
                            torch.from_numpy(mask).to(self.device),
                            self.t5_cfg, compute_dtype=self.compute_dtype)
        n = int(mask[0].sum())
        keep = torch.from_numpy(np.nonzero(mask[0])[0]).to(self.device)
        return emb[0, keep], n

    def _prompt_rows(self, prompt: str) -> list[torch.Tensor]:
        """[cond] or, with guidance, [cond, uncond] prompt features."""
        cfg, sc, lm_params = self.llm_cfg, self.sample_cfg, self.params["lm"]
        text_feats_raw, n_text = self.encode_text(prompt)
        text_feats = lm_lib.text_cond_features(lm_params, text_feats_raw,
                                               self.compute_dtype)
        micro = lm_lib.micro_cond_features(
            lm_params, cfg,
            {"frames": sc.num_frames, "motion_score": sc.motion_score},
            self.compute_dtype)
        rows = [lm_lib.assemble_prompt(lm_params, cfg, text_feats, micro,
                                       self.compute_dtype)]
        if sc.cfg_scale > 0 and sc.cfg_scale != 1:
            null = lm_lib.null_text_features(lm_params, n_text,
                                             self.compute_dtype)
            rows.append(lm_lib.assemble_prompt(lm_params, cfg, null, micro,
                                               self.compute_dtype))
        return rows

    def _mark(self, name: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.phase_seconds[name] = t1 - t0
        return t1

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.sample_cfg.seed)

    @torch.inference_mode()
    def __call__(self, task: CodeTask, gumbel=None) -> CodeTask:
        """gumbel: optional (steps, V) Gumbel noise replacing the seeded
        draws (lm.sample)."""
        cfg, sc = self.llm_cfg, self.sample_cfg
        t0 = time.perf_counter()
        rows = torch.stack(self._prompt_rows(task.prompt))
        sched = lm_lib.build_schedule(cfg, rows.shape[1], sc.num_frames)
        t0 = self._mark("prompt", t0)
        codes = lm_lib.sample(
            self.params["lm"], cfg, sched, rows, sc,
            generator=self._generator() if gumbel is None else None,
            gumbel=gumbel, compute_dtype=self.compute_dtype)
        self._mark("sample", t0)
        logger.info("sampled %d semantic tokens for %r", len(codes),
                    task.prompt[:60])
        return dataclasses.replace(task, result=codes)

    @torch.inference_mode()
    def infer_batch(self, tasks: list[CodeTask], prefix_multiple: int = 16,
                    gumbel=None) -> list[CodeTask]:
        """Decode N prompts in ONE batched AR loop (lm.sample_batch).

        Batching N prompts amortizes the per-step reads of the GPT weights
        N-fold. Prompts are right-aligned to the batch's prefix, rounded up
        to `prefix_multiple` (padded slots are masked out); each prompt
        keeps its own stream of draws from the wrapper's seed, as the
        single-prompt path. gumbel: optional (N, steps, V) noise replacing
        the seeded draws."""
        if not tasks:
            return tasks
        cfg, sc = self.llm_cfg, self.sample_cfg
        t0 = time.perf_counter()
        rows, lens = [], []
        for task in tasks:
            prompt_rows = self._prompt_rows(task.prompt)
            lens.append(prompt_rows[0].shape[0])
            rows.extend(prompt_rows)
        rows_per = len(rows) // len(tasks)
        prefix = -(-max(lens) // prefix_multiple) * prefix_multiple
        pad = np.repeat(prefix - np.asarray(lens, np.int64), rows_per)
        stacked = torch.stack([
            torch.nn.functional.pad(r, (0, 0, prefix - r.shape[0], 0))
            for r in rows])
        sched = lm_lib.build_schedule(cfg, prefix, sc.num_frames)
        t0 = self._mark("prompt", t0)
        codes = lm_lib.sample_batch(
            self.params["lm"], cfg, sched, stacked, pad, sc,
            generators=([self._generator() for _ in tasks]
                        if gumbel is None else None),
            gumbel=gumbel, compute_dtype=self.compute_dtype)
        self._mark("sample", t0)
        logger.info("sampled %d prompts in one batched decode "
                    "(prefix %d, rows %d)", len(tasks), prefix, len(rows))
        return [dataclasses.replace(task, result=c)
                for task, c in zip(tasks, codes)]


def init_params(gen: torch.Generator, llm_cfg: LLMConfig, t5_cfg: T5Config,
                dtype=torch.float32):
    """Random stage-1 parameters built on the generator's device."""
    return {
        "lm": lm_lib.init(gen, llm_cfg, t5_dim=t5_cfg.d_model, dtype=dtype),
        "t5": t5_lib.init(gen, t5_cfg, dtype),
    }
