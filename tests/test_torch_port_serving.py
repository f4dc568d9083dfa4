"""PyTorch port: the serving engine (serving/scheduler.py), its HTTP
server (serving/app.py), LANDIFF_OFFLOAD on the stage-2 wrapper and the
profiler trace (observability.py), at the tiny config in f32 on the CPU.

The engine is held to the port's own entry points (infer_batch,
infer_video.generate), which tests/test_torch_port_e2e.py and
tests/test_torch_port_pipeline.py hold to the JAX package; this file runs
no JAX program. On the CPU the offload has no device memory to free: what
is held here is where it runs (after the denoise, before the decode), that
the trees come back for the next request and that it changes no bit of a
video; tests/test_torch_port_cuda.py holds the freed bytes on the card."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from landiff_tpu_torch import config as tcfg
from landiff_tpu_torch import observability
from landiff_tpu_torch.diffusion import engine as tengine
from landiff_tpu_torch.pipeline import dif_infer as tdi
from landiff_tpu_torch.pipeline import infer_video as tiv
from landiff_tpu_torch.pipeline import llm_infer as tli
from landiff_tpu_torch.serving import app
from landiff_tpu_torch.serving import scheduler
from landiff_tpu_torch.utils import fill_zero_leaves, tree_leaves

torch.set_num_threads(2)   # tier-1 runs six xdist workers

TC = tcfg.tiny_test_config()
PROMPTS = ["a cat playing piano", "a dog surfing", "northern lights"]
JOIN_S = 120.0
# straight to the local server, whatever proxy the environment names
_OPEN = urllib.request.build_opener(urllib.request.ProxyHandler({})).open


@pytest.fixture(scope="module")
def engine():
    eng = scheduler.ServingEngine.build(tiny=True, device="cpu",
                                        linger_s=1.0)
    yield eng
    eng.shutdown()


def _dif_wrapper():
    gen = torch.Generator().manual_seed(2)
    params = fill_zero_leaves(tdi.init_params(gen, TC), gen)
    return tdi.CogModelInferWrapper(params, TC, compute_dtype=torch.float32,
                                    device="cpu")


def _video_task(seed=3):
    codes = np.random.default_rng(seed).integers(
        0, TC.tokenizer.vq.codebook_size, TC.tokenizer.titok.latent_tokens)
    return tdi.VideoTask("x.mp4", "a red panda", seed, semantic_token=codes)


def _threads(fn, args):
    """Run fn(arg) for each arg in its own thread, all at once; returns
    {arg: result} and raises the first error."""
    out, errs = {}, []

    def run(a):
        try:
            out[a] = fn(a)
        except Exception as e:  # surfaced in the test's thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(a,)) for a in args]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    if errs:
        raise errs[0]
    return out


def test_batcher_coalesces_and_matches_infer_batch(engine):
    """Three concurrent submits make one batched decode; each prompt's
    codes are those of infer_batch and of its single call (f32)."""
    llm = engine.llm
    tasks = [tli.CodeTask("b.npy", p) for p in PROMPTS]
    want = llm.infer_batch(tasks)
    batcher = scheduler.Stage1Batcher(llm, max_batch=8, linger_s=1.0)
    try:
        futs = [batcher.submit(t) for t in tasks]
        got = [f.result(timeout=JOIN_S) for f in futs]
    finally:
        batcher.shutdown()
    assert batcher.batch_sizes == [3]
    for g, w, t in zip(got, want, tasks):
        np.testing.assert_array_equal(g.result, w.result)
        np.testing.assert_array_equal(g.result, llm(t).result)
    with pytest.raises(RuntimeError, match="shut down"):
        batcher.submit(tasks[0])


def test_batcher_propagates_errors():
    """A failed decode fails every request of its batch, and the worker
    goes on serving the next one."""
    class Boom(Exception):
        pass

    class FlakyLLM:
        calls = 0

        def infer_batch(self, tasks):
            FlakyLLM.calls += 1
            if FlakyLLM.calls == 1:
                raise Boom("decode failed")
            return [tli.CodeTask(t.save_file_name, t.prompt,
                                 result=np.arange(3)) for t in tasks]

    batcher = scheduler.Stage1Batcher(FlakyLLM(), max_batch=4, linger_s=0.2)
    try:
        futs = [batcher.submit(tli.CodeTask("x", p)) for p in ("a", "b")]
        for f in futs:
            with pytest.raises(Boom):
                f.result(timeout=JOIN_S)
        ok = batcher.submit(tli.CodeTask("x", "c")).result(timeout=JOIN_S)
        np.testing.assert_array_equal(ok.result, np.arange(3))
    finally:
        batcher.shutdown()
    assert not batcher._worker.is_alive()


def test_serving_engine_concurrent_requests(engine):
    """build(tiny=True, device="cpu") answers three concurrent requests in
    one stage-1 batch; each answer is infer_video.generate's for the same
    prompt and seeds (the codes and the video to the bit)."""
    before = engine.stats()
    out = _threads(lambda p: engine.generate(p, seed=5), PROMPTS)
    stats = engine.stats()
    assert stats["requests"] == before["requests"] + 3
    assert stats["stage1_batch_sizes"][before["stage1_batches"]:] == [3]
    for p in PROMPTS:
        res = out[p]
        assert res["stage1_s"] > 0 and res["stage2_s"] > 0
        assert set(res["stage2_phases"]) == {"t5", "semantic", "denoise",
                                             "vae"}
        want = tiv.generate(engine.llm, engine.dif, p, seed=5)
        np.testing.assert_array_equal(res["codes"], want["codes"])
        np.testing.assert_array_equal(res["video"], want["video"])
        assert res["video"].shape == want["video"].shape
    assert not np.array_equal(out[PROMPTS[0]]["codes"],
                              out[PROMPTS[1]]["codes"])


def _serve():
    server = ThreadingHTTPServer(("127.0.0.1", 0), app._Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def test_http_handler_get_stats_and_post(engine, monkeypatch):
    """GET / gives the form, GET /stats the engine's counters, POST
    /generate the page with the request's video as a GIF of its frames;
    a bad form field is a 400."""
    monkeypatch.setattr(app, "_PIPELINE", {"engine": engine,
                                           "engine_key": (7.5, 0.1)})
    server, thread, url = _serve()
    try:
        with _OPEN(url + "/", timeout=JOIN_S) as r:
            assert r.status == 200 and b"<form" in r.read()
        form = "prompt=a+red+panda&cfg_scale=7.5&motion=0.1&seed=4"
        with _OPEN(url + "/generate", data=form.encode(),
                                    timeout=JOIN_S) as r:
            assert r.status == 200
            page = r.read().decode()
        with _OPEN(url + "/stats", timeout=JOIN_S) as r:
            stats = json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError) as bad:
            _OPEN(url + "/generate", data=b"prompt=x",
                                   timeout=JOIN_S)
        assert bad.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=JOIN_S)
    assert stats == engine.stats() and stats["requests"] >= 1
    from PIL import Image

    gif = base64.b64decode(page.split("data:image/gif;base64,")[1]
                           .split('"')[0])
    img = Image.open(io.BytesIO(gif))
    want = tiv.generate(engine.llm, engine.dif, "a red panda", seed=4)
    _, _, T, H, W = want["video"].shape
    assert img.format == "GIF" and img.n_frames == T and img.size == (W, H)


def test_changed_slider_rebuilds_engine(monkeypatch):
    """_engine builds once per (cfg_scale, motion); a changed slider shuts
    the old engine down and drops it before the new one is built."""
    events = []

    class Fake:
        def __init__(self, n):
            self.n = n

        def shutdown(self):
            events.append(("shutdown", self.n))

    def build(**kw):
        events.append(("build", kw["cfg_scale"], kw["motion_score"],
                       kw["device"]))
        assert "engine" not in app._PIPELINE   # the old one is dropped
        return Fake(len(events))

    monkeypatch.setattr(app, "_PIPELINE", {"tiny": True, "device": "cpu"})
    monkeypatch.setattr(scheduler.ServingEngine, "build",
                        staticmethod(build))
    first = app._engine(7.5, 0.1)
    assert app._engine(7.5, 0.1) is first
    second = app._engine(5.0, 0.1)
    assert second is not first and app._PIPELINE["engine"] is second
    assert events == [("build", 7.5, 0.1, "cpu"), ("shutdown", first.n),
                      ("build", 5.0, 0.1, "cpu")]


def test_trace_writes_a_chrome_trace_with_the_scope(tmp_path):
    with observability.trace(str(tmp_path / "tr"), device="cpu") as d:
        with observability.named_scope("serving_request"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert d == str(tmp_path / "tr")
    (path,) = (tmp_path / "tr").glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "serving_request" in names and "aten::mm" in names


def test_offload_runs_after_the_denoise_and_keeps_the_video(monkeypatch):
    """With LANDIFF_OFFLOAD=1 the wrapper offloads after sample_latents
    and before decode_first_stage; the next request restages the trees
    and gives the video of a run without the knob, bit for bit."""
    w = _dif_wrapper()
    want = w(_video_task())
    order = []

    def spy(name, fn):
        def call(*a, **kw):
            order.append(name)
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(tengine, "sample_latents",
                        spy("sample", tengine.sample_latents))
    monkeypatch.setattr(tengine, "decode_first_stage",
                        spy("decode", tengine.decode_first_stage))
    monkeypatch.setattr(w, "offload_diffusion_params",
                        spy("offload", w.offload_diffusion_params))
    monkeypatch.setattr(w, "restage_diffusion_params",
                        spy("restage", w.restage_diffusion_params))
    monkeypatch.setenv("LANDIFF_OFFLOAD", "1")
    first = w(_video_task())
    assert order == ["sample", "offload", "decode"] and w.offloaded
    assert "offload" in w.phase_seconds
    second = w(_video_task())
    assert order[3:] == ["restage", "sample", "offload", "decode"]
    assert "restage" in w.phase_seconds
    for got in (first, second):
        np.testing.assert_array_equal(got.result, want.result)
        np.testing.assert_array_equal(got.latent, want.latent)
    monkeypatch.delenv("LANDIFF_OFFLOAD")
    order.clear()
    np.testing.assert_array_equal(w(_video_task()).result, want.result)
    assert order == ["restage", "sample", "decode"] and not w.offloaded


def test_offload_diffusion_params_moves_to_host():
    """offload_diffusion_params leaves main / control / semantic on the
    host with their dtypes and containers (a subtree held elsewhere sees
    the moved leaves), the VAE and T5 where they were; restaging is
    idempotent and the wrapper still works afterwards."""
    w = _dif_wrapper()
    main, vae = w.params["main"], w.params["vae"]
    dtypes = [t.dtype for t in tree_leaves(main)]
    w.offload_diffusion_params()
    assert w.offloaded and w.params["main"] is main
    for k in ("main", "control", "semantic"):
        assert all(t.device.type == "cpu" for t in tree_leaves(w.params[k]))
    assert [t.dtype for t in tree_leaves(main)] == dtypes
    assert w.params["vae"] is vae
    w.restage_diffusion_params()
    w.restage_diffusion_params()
    assert not w.offloaded and w.params["main"] is main
    w.offload_diffusion_params()
    task = w(_video_task())
    assert task.result is not None and np.isfinite(task.result).all()
    assert not w.offloaded
