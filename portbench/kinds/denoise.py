"""Stage-2 denoising steps: the window drives `engine.sample_latents` over
the closure of `engine.make_denoise_fn`, pass after pass of the
configuration's schedule, each pass from fresh latents and step noises
drawn from the seed. A unit is one step: one CFG-batch-2 model call of
the closure and the sampler's update.

Set-up builds the DiT's main and control trees and the semantic
conditioner (weights from the seed), the T5 context and the stage-1 codes
(inputs from the seed), makes the closure (which computes the semantic
feature) and runs `warm_steps` steps. The control run
(portbench/control.py, never the benchmark's runs) switches on both of
the program's own int8 paths: the W8A8 trees and LANDIFF_ATTN_INT8_PV.

The check draws one completed step from the seed, among those whose
DynamicCFG scale g is MIN_CFG or more, and recomputes it with the plain
reference from the program's state at that step (the latents it was
given and the previous step's prediction): the semantic feature from the
codes and the CFG-combined prediction. The program's next latents are
solved, with the reference's coefficients and that step's noise, for the
prediction that the update turned into them, so that one number covers
the model, the combination and the update. Compared: `guide_rel`, that
implied prediction's RMS error against the reference's prediction, over
the RMS of the guidance term g (x_c - x_u) of the reference's two rows.
The program's error lies mostly along the guidance, and grows with how
far a seed's two rows lie apart; over the guidance's size it reads alike
from seed to seed and step to step (PERF.md, "How correct is decided").
A step that leaves out the unconditional row reads (g - 1) / g, so at g
of 2 or more it reads 0.5 or more; near g = 1 the row weighs nothing and
the fault would pass.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.core.harness import seeds
from portbench.core.portcfg import port_config
from portbench.core.weights import fill
from portbench.core.window import Closed, Window
from portbench.reference import dit as ref_dit
from portbench.reference import sampler as ref_sampler
from portbench.reference import semantic as ref_sem
from portbench.reference.common import exact_f32

# the least DynamicCFG scale of a step the check may draw (docstring)
MIN_CFG = 2.0


class Runner:
    def __init__(self, run):
        self.run = run
        self.d = run.config["dit"]
        self.s = run.config["sampler"]
        self.pc = port_config(run.config)
        self.seed_w, self.seed_in, self.seed_noise, self.seed_pick = \
            seeds(run.seed, 4)
        self.records = []

    # -- set-up ------------------------------------------------------------

    def setup(self):
        import torch

        from landiff_tpu_torch.diffusion import engine
        from landiff_tpu_torch.models import dit as dit_lib

        dev, d, sem = self.run.device, self.d, self.run.config["semantic"]
        mark = self.run.mark
        mark("import")
        gen = torch.Generator(dev).manual_seed(self.seed_w)
        self.main = fill(ref_dit.param_spec(d), gen, dev)
        self.control = fill(ref_dit.param_spec(d, control=True), gen, dev)
        self.sem_params = fill(ref_sem.param_spec(sem), gen, dev)
        gi = torch.Generator(dev).manual_seed(self.seed_in)
        self.context = torch.randn((1, d["text_length"], d["text_dim"]),
                                   generator=gi, device=dev)
        t = sem["titok"]
        n_codes = t["iframe_latent_tokens"] + (t["temporal_size"] - 1) \
            * t["pframe_latent_tokens"]
        self.codes = torch.randint(0, sem["vq"]["codebook_size"],
                                   (1, n_codes), generator=gi, device=dev)
        main, control = self.main, self.control
        if self.run.control:
            # the control: the program's own int8 paths, W8A8 linears and
            # int8 p.v in the flash forward, both switched on
            os.environ["LANDIFF_ATTN_INT8_PV"] = "1"
            main = dit_lib.quantize_int8(main)
            control = dit_lib.quantize_int8(control)
        pc = self.pc
        mark("weights")
        with torch.inference_mode():
            self.fn = engine.make_denoise_fn(
                main, control, self.sem_params, pc.dit, pc.sampler,
                pc.tokenizer, pc.semantic_cond, self.context,
                torch.zeros_like(self.context), self.codes,
                compute_dtype=torch.bfloat16)
        mark("closure")
        warm = Window(1e9, dev, traced=False,
                      max_units=int(self.run.traffic.get("warm_steps", 2)))
        warm.start()
        try:
            self.drive(warm)
        except Closed:
            pass
        mark("warm")
        self.records = []

    def _noise(self, p: int):
        import torch
        d, dev = self.d, self.run.device
        g = torch.Generator(dev).manual_seed(self.seed_noise + p)
        shape = (1, d["latent_frames"], d["in_channels"],
                 d["latent_height"], d["latent_width"])
        init = torch.randn(shape, generator=g, device=dev)
        steps = torch.randn((self.s["num_steps"],) + shape, generator=g,
                            device=dev)
        return init, steps

    # -- the window ----------------------------------------------------------

    def drive(self, window):
        import torch

        from landiff_tpu_torch.diffusion import engine

        pc, dev = self.pc, self.run.device
        p = 0
        while True:
            init, noises = self._noise(p)
            recs = []
            self.records.append(recs)

            def fn(x, step, recs=recs, noises=noises):
                i = len(recs)
                if recs:
                    recs[-1]["x_next"] = x
                window.begin_unit()
                recs.append({"i": i, "x": x, "noise": noises[i],
                             "old_d": recs[-1]["den"] if recs else None})
                with window.span("dit_call"):
                    out = self.fn(x, step)
                recs[-1]["den"] = out
                return out

            with torch.inference_mode():
                out = engine.sample_latents(
                    fn, pc.sampler, pc.dit,
                    generator=torch.Generator(dev).manual_seed(0),
                    init_noise=init, step_noise=noises)
            recs[-1]["x_next"] = out
            p += 1

    # -- after the window ----------------------------------------------------

    def release(self):
        """Keep the step the check recomputes; free the program's state."""
        sched = ref_sampler.schedule(self.s)
        done = [r for recs in self.records for r in recs
                if "den" in r and "x_next" in r
                and sched[r["i"]]["cfg_scale"] >= MIN_CFG]
        rng = np.random.default_rng(self.seed_pick)
        self.pick = done[int(rng.integers(len(done)))] if done else None
        self.records = []
        self.fn = None
        if self.run.control:
            os.environ.pop("LANDIFF_ATTN_INT8_PV", None)

    def check(self, limits):
        import torch

        r = self.pick
        if r is None:
            return [("guide_rel", None, limits["guide_rel"])]
        d, s, i = self.d, self.s, r["i"]
        sem = self.run.config["semantic"]
        with exact_f32(), torch.no_grad():
            feat = ref_sem.semantic_feature(self.sem_params, self.codes, sem,
                                            d["latent_frames"])
            den, den_u, den_c = ref_sampler.denoised(
                self.main, self.control, feat, r["x"].float(), self.context,
                d, s, i, rows=True)
            del feat
            old = r["old_d"] if r["old_d"] is not None else \
                torch.zeros_like(den)
            implied = ref_sampler.implied_prediction(
                r["x"].float().double(), r["x_next"].double(),
                old.double(), r["noise"].double(), s, i)
        rms = lambda t: t.double().square().mean().sqrt()
        err = rms(implied - den.double())
        g = ref_sampler.schedule(s)[i]["cfg_scale"]
        guide = g * rms(den_c - den_u)
        self.detail = {
            "step": i, "cfg_scale": g,
            "rows_apart": float(rms(den_c - den_u) / rms(den_u)),
            "raw_rel": float(err / rms(den)),
            # what guide_rel reads where only the conditional row is run
            "cond_row_only": float(rms(den_c - den) / guide)}
        return [("guide_rel", float(err / guide), limits["guide_rel"])]
