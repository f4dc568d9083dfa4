"""A run of a cell on the CPU, at a tiny configuration, with the timed
path broken underneath: `correct` comes out false for every fault the
cell can have, with the cell's own limits. The run skips only the look
for a card. A cell on one chip has no exchange between chips to leave
out.

The control of each cell is read at the cell's own size on the card
(portbench/control.py; test_portbench_cuda.py); here its mechanics: the
denoising control runs the program's W8A8 trees with int8 p.v switched
on, and the decode's control (the reference with fp8 operands in the
program's place) fails even at this size."""

import json
import time

import pytest
import torch

from portbench.core import harness
from portbench.tests import tiny

DENOISE = ("landiff-2b.denoise", "landiff-2b", "denoise-50")
DECODE = ("landiff-2b.vae-decode", "landiff-2b", "vae-decode")


def run(cell, control=False, seed=2 ** 31 + 11, max_units=2):
    name, conf, traffic = cell
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    config = tiny.config(conf)
    if cell is DECODE:
        # three chunks (3, 2, 1 latent frames), so that the causal
        # frames carry from chunk to chunk
        config["dit"]["latent_frames"] = 6
    res, numbers = harness.run_cell(
        tiny.cell(name, conf, traffic), config,
        tiny.traffic(traffic), bench, seed, 60.0, False, "cpu",
        time.perf_counter(), control=control, max_units=max_units)
    return res


@pytest.fixture(autouse=True)
def text_weighted(monkeypatch):
    """The tiny DiT's text stream weighing as at the cells' size. There
    the two CFG rows' predictions lie 13-37 % of a row apart (the check's
    `rows_apart` on an H100); in this tiny DiT 1-2 %, so that its own
    bf16 error, over the guidance term that `guide_rel` divides by, reads
    0.5 or more. Scaling the text positions' LayerNorm outputs (adaLN
    scale chunks 7 and 10) by 31 brings the rows 23-44 % apart."""
    from portbench.core import weights
    orig = weights.fill

    def fill(spec, gen, device, dtype=torch.float32):
        tree = orig(spec, gen, device, dtype)
        for layer in tree.get("layers", []):
            if "adaln_b" in layer:
                b = layer["adaln_b"].view(12, -1)
                b[7].add_(30.0)
                b[10].add_(30.0)
        return tree
    monkeypatch.setattr(weights, "fill", fill)


def test_sound_runs_are_correct():
    assert run(DENOISE)["correct"]
    assert run(DECODE)["correct"]


def _unchanged_state(denoise_fn, x, cfg, **kw):
    """A sampler whose steps call the model and return the state as it
    was."""
    from landiff_tpu_torch.diffusion import samplers
    for step in samplers.step_dicts(cfg):
        denoise_fn(x, step)
    return x


def _half_batch(orig):
    """The CFG batch's first half (the unconditional row) left out: the
    conditional row's output stands for both."""
    def net(main, control, x, ts, ctx, cfg, sem, **kw):
        B = x.shape[0] // 2
        out = orig(main, control, x[B:], ts[B:], ctx[B:], cfg, sem[B:], **kw)
        return torch.cat([out, out])
    return net


def _altered(orig):
    """The prediction of the first latent frame negated where the model
    produces it."""
    def net(*args, **kw):
        out = orig(*args, **kw).clone()
        out[:, 0] = -out[:, 0]
        return out
    return net


@pytest.mark.parametrize("fault,max_units", [
    ("state_unchanged", 2), ("half_batch", 2), ("answer_altered", 2),
    # the whole tiny schedule, whose steps 2 and 4 have DynamicCFG scales
    # 1.0 and 1.13, where a dropped row weighs nothing: the check draws
    # from steps 0, 1, 3 and 5 alone
    ("half_batch", 6)])
def test_denoise_faults_are_caught(monkeypatch, fault, max_units):
    from landiff_tpu_torch.diffusion import samplers
    from landiff_tpu_torch.models import dit
    if fault == "state_unchanged":
        monkeypatch.setattr(samplers, "vpsde_dpmpp2m_sample",
                            _unchanged_state)
    elif fault == "half_batch":
        monkeypatch.setattr(dit, "control_warp_forward",
                            _half_batch(dit.control_warp_forward))
    else:
        monkeypatch.setattr(dit, "control_warp_forward",
                            _altered(dit.control_warp_forward))
    res = run(DENOISE, max_units=max_units)
    assert not res["correct"], res["checks"]


def test_the_check_draws_only_steps_that_guidance_weighs():
    """A step whose DynamicCFG scale is under 2 is never drawn, so that
    a dropped unconditional row reads (g - 1) / g >= 0.5 on every run."""
    from portbench.reference import sampler as ref_sampler
    config = tiny.config("landiff-2b")
    sched = ref_sampler.schedule(config["sampler"])
    kind = harness.load_module(harness.BENCH / "kinds" / "denoise.py",
                               "portbench_kind_denoise")
    drawn = set()
    for k in range(40):
        r = harness.Run(tiny.cell(*DENOISE), config,
                        tiny.traffic("denoise-50"), 2 ** 33 + k, 1.0,
                        False, "cpu")
        runner = kind.Runner(r)
        runner.records = [[{"i": i, "den": 0, "x_next": 0}
                           for i in range(len(sched))]]
        runner.release()
        drawn.add(runner.pick["i"])
    assert drawn == {i for i, st in enumerate(sched)
                     if st["cfg_scale"] >= kind.MIN_CFG} == {0, 1, 3, 5}


def _no_cache(orig):
    """Each chunk decoded without the previous chunk's causal frames."""
    def decode(params, z, cfg, *, cache=None, stream=False, **kw):
        return orig(params, z, cfg, cache=None, stream=stream, **kw)
    return decode


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_decode_faults_are_caught(monkeypatch, fault):
    from landiff_tpu_torch.diffusion import engine
    from landiff_tpu_torch.models import vae
    if fault == "state_unchanged":
        monkeypatch.setattr(vae, "decode", _no_cache(vae.decode))
    else:
        orig = engine.post_process_video

        def post(video):
            out = orig(video).clone()
            out[:, :, 0] = 1.0 - out[:, :, 0]
            return out
        monkeypatch.setattr(engine, "post_process_video", post)
    res = run(DECODE)
    assert not res["correct"], res["checks"]


def test_the_decode_control_fails():
    assert not run(DECODE, control=True)["correct"]


def test_the_denoise_control_runs_the_programs_int8_paths(monkeypatch):
    from landiff_tpu_torch.models import dit
    import os
    seen = {}
    orig = dit._w8a8_matmul

    def spy(x, q, s):
        seen["w8a8"] = seen.get("w8a8", 0) + 1
        seen["int8_pv"] = os.environ.get("LANDIFF_ATTN_INT8_PV")
        return orig(x, q, s)
    monkeypatch.setattr(dit, "_w8a8_matmul", spy)
    res = run(DENOISE, control=True)
    assert seen["w8a8"] > 0 and seen["int8_pv"] == "1"
    assert os.environ.get("LANDIFF_ATTN_INT8_PV") is None
    assert res["checks"]["guide_rel"]["value"] > 0
