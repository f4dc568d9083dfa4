"""VAE decodes: the window runs `engine.decode_first_stage` back to back,
each on latents (1, T, z, H', W') from a pool drawn from the seed, and
post-processes each video to uint8 on the device as the stage-2 wrapper
does. A unit is one decode and its post-processing.

Set-up builds the decoder's tree (weights from the seed), draws the pool
and decodes `warm_decodes` times. The check draws one decode of the
window from the seed and decodes its latents with the plain reference
(`vae_rel`: the post-processed video's RMS error over its RMS). The
control run puts the reference, computed with fp8 (e4m3) operands, in the
program's place: the program has no lower-precision decode of its own.
"""

from __future__ import annotations

import numpy as np

from portbench.core.harness import seeds
from portbench.core.portcfg import port_config
from portbench.core.weights import fill
from portbench.core.window import Closed, Window
from portbench.reference import vae as ref_vae
from portbench.reference.common import exact_f32, rel_rms


class Runner:
    def __init__(self, run):
        self.run = run
        self.v = run.config["vae"]
        self.lat = run.config["dit"]
        self.pc = port_config(run.config)
        self.seed_w, self.seed_in, self.seed_pick = seeds(run.seed, 3)
        self.outs = []

    def setup(self):
        import torch

        dev = self.run.device
        self.run.mark("import")
        gen = torch.Generator(dev).manual_seed(self.seed_w)
        self.params = {"decoder": fill(ref_vae.param_spec(self.v), gen, dev)}
        d = self.lat
        gi = torch.Generator(dev).manual_seed(self.seed_in)
        n = int(self.run.traffic.get("latent_pool", 4))
        # latents as the sampler leaves them: about unit variance after
        # the VAE's scale factor
        self.pool = torch.randn(
            (n, 1, d["latent_frames"], self.v["z_channels"],
             d["latent_height"], d["latent_width"]), generator=gi,
            device=dev) * self.v["scale_factor"]
        self.run.mark("weights")
        warm = Window(1e9, dev, traced=False,
                      max_units=int(self.run.traffic.get("warm_decodes", 1)))
        warm.start()
        try:
            self.drive(warm)
        except Closed:
            pass
        self.run.mark("warm")
        self.outs = []

    def _decode(self, z):
        import torch

        from landiff_tpu_torch.diffusion import engine

        if self.run.control:
            with exact_f32(), torch.no_grad():
                video = ref_vae.decode(self.params["decoder"], z, self.v,
                                       fp8=True)
        else:
            with torch.inference_mode():
                video = engine.decode_first_stage(
                    self.params, z, self.pc.vae,
                    compute_dtype=torch.bfloat16)
        return engine.video_to_uint8(engine.post_process_video(video))

    def drive(self, window):
        k = 0
        while True:
            window.begin_unit()
            z = self.pool[k % len(self.pool)]
            with window.span("vae_decode"):
                self.outs.append((k % len(self.pool), self._decode(z)))
            k += 1

    def release(self):
        done = self.outs[:self.run.window.units]
        rng = np.random.default_rng(self.seed_pick)
        self.pick = done[int(rng.integers(len(done)))] if done else None
        self.outs = []

    def check(self, limits):
        import torch

        if self.pick is None:
            return [("vae_rel", None, limits["vae_rel"])]
        k, out = self.pick
        with exact_f32(), torch.no_grad():
            ref = ref_vae.post_process(
                ref_vae.decode(self.params["decoder"], self.pool[k], self.v))
        return [("vae_rel", rel_rms(out.float() / 255.0, ref),
                 limits["vae_rel"])]
