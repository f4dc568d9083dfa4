"""The plain reference against the program's plain path (float32 on the
CPU) at a tiny configuration: the DiT with its control branch (sincos and
rotary positions), the semantic conditioner, the chunked VAE decode and
the sampler's schedule and update."""

import dataclasses

import pytest
import torch

from portbench.core.portcfg import port_config
from portbench.core.weights import fill
from portbench.reference import dit as ref_dit
from portbench.reference import sampler as ref_sampler
from portbench.reference import semantic as ref_sem
from portbench.reference import vae as ref_vae
from portbench.tests import tiny


def rel(a, b):
    return float((a.double() - b.double()).square().mean().sqrt()
                 / b.double().square().mean().sqrt())


@pytest.mark.parametrize("name", ["landiff-2b", "cogvideox-5b"])
def test_dit_matches_the_program(name):
    from landiff_tpu_torch.models import dit as dit_lib
    c = tiny.config(name)
    d = c["dit"]
    g = torch.Generator().manual_seed(0)
    main = fill(ref_dit.param_spec(d), g, "cpu")
    ctl = fill(ref_dit.param_spec(d, control=True), g, "cpu")
    x = torch.randn(2, 3, 4, 8, 12, generator=g)
    ctx = torch.randn(2, 8, d["text_dim"], generator=g)
    sem = torch.randn(2, 3, 4, 8, 12, generator=g)
    ts = torch.tensor([999.0, 250.0])
    with torch.no_grad():
        ref = ref_dit.control_warp_forward(main, ctl, x, ts, ctx, d, sem)
        out = dit_lib.control_warp_forward(
            main, ctl, x, ts, ctx, port_config(c).dit, sem,
            compute_dtype=torch.float32)
    assert rel(out, ref) < 1e-5


def test_semantic_feature_matches_the_program():
    from landiff_tpu_torch.models import semantic_cond as sc_lib
    c = tiny.config()
    pc = port_config(c)
    g = torch.Generator().manual_seed(1)
    params = fill(ref_sem.param_spec(c["semantic"]), g, "cpu")
    codes = torch.randint(0, 32, (1, 6 + 2 * 2), generator=g)
    with torch.no_grad():
        ref = ref_sem.semantic_feature(params, codes, c["semantic"], 3)
        out = sc_lib.semantic_feature_from_tokens(
            params, codes, pc.tokenizer, pc.semantic_cond, forward_t=3,
            compute_dtype=torch.float32)
    assert out.shape == ref.shape == (1, 3, 4, 8, 12)
    assert rel(out, ref) < 1e-5


def test_chunked_vae_decode_matches_the_program():
    from landiff_tpu_torch.diffusion import engine
    c = tiny.config()
    c["dit"]["latent_frames"] = 6          # three chunks: 3, 2, 1
    g = torch.Generator().manual_seed(2)
    params = {"decoder": fill(ref_vae.param_spec(c["vae"]), g, "cpu")}
    z = torch.randn(1, 6, 4, 8, 12, generator=g)
    with torch.no_grad():
        ref = ref_vae.decode(params["decoder"], z, c["vae"])
        out = engine.decode_first_stage(params, z, port_config(c).vae,
                                        compute_dtype=torch.float32)
    assert out.shape == ref.shape
    assert rel(out, ref) < 1e-5
    # fp8 operands (the decode's control) move it well past float32's
    with torch.no_grad():
        low = ref_vae.decode(params["decoder"], z, c["vae"], fp8=True)
    assert rel(low, ref) > 1e-3


def test_schedule_and_update_match_the_program():
    from landiff_tpu_torch.diffusion import samplers
    c = tiny.config()
    s = dict(c["sampler"], num_steps=50)
    steps = samplers.step_dicts(dataclasses.replace(
        port_config(c).sampler, num_steps=50))
    for i, (mine, theirs) in enumerate(zip(ref_sampler.schedule(s), steps)):
        assert mine["timestep"] == theirs["timestep"]
        assert mine["cfg_scale"] == pytest.approx(theirs["cfg_scale"],
                                                  rel=1e-6)
        assert mine["alpha"] == pytest.approx(theirs["alpha"], abs=1e-7)
    # the program's sampler with a fake model against the reference's
    # updates, step by step, and the update solved back for its input
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn(1, 3, 4, 8, 12, generator=g)
    noises = torch.randn(50, 1, 3, 4, 8, 12, generator=g)
    seen = []

    def fake(x, step):
        den = torch.tanh(x) * 0.5 + 0.1 * step["idx"] / 50
        seen.append((x, den))
        return den

    out = samplers.vpsde_dpmpp2m_sample(
        fake, x0, dataclasses.replace(port_config(c).sampler, num_steps=50),
        noises=noises)
    xs = [x for x, _ in seen] + [out]
    for i, (x, den) in enumerate(seen):
        old = seen[i - 1][1] if i else torch.zeros_like(den)
        nxt = ref_sampler.update(x, den, old, noises[i], s, i)
        scale = float((xs[i + 1] - x).abs().max()) + 1e-6
        assert float((nxt - xs[i + 1]).abs().max()) < 1e-5 * max(scale, 1)
        back = ref_sampler.implied_prediction(
            x.double(), xs[i + 1].double(), old.double(),
            noises[i].double(), s, i)
        assert float((back - den.double()).abs().max()) < 1e-4
