"""Unified training CLI (counterpart of landiff_tpu/training/train.py),
one entry point for the trainable components:

  python -m landiff_tpu_torch.training.train --model dit --data DIR --steps 1000
  python -m landiff_tpu_torch.training.train --model lm  --data DIR ...
  python -m landiff_tpu_torch.training.train --model vq  --data DIR ...

  --model dit : stage-2 ControlNet branch (freeze_dit semantics,
                dit_video_concat.py:1190-1193) via
                training/diffusion_loss.make_train_step
  --model lm  : stage-1 GPT teacher forcing (lm_model.py:188-227) via
                training/lm_train.make_cond_train_step
  --model vq  : semantic tokenizer VQ (video_titok_vq.py:279-375) via
                training/vq_train.make_train_step (EMA codebook, k-means
                init from the first batch)

One process on one device (`--device`, default cuda), or a mesh
(`--mesh data=D,model=N,time=T`, training/mesh_train.py; its ranks on
`--device`'s type: one per GPU for cuda, all on the CPU for cpu): dit
takes the sequence-parallel step with time > 1 and model = 1, else the
tensor-parallel one (the time ranks repeating the work); lm and vq
their tensor-parallel steps; dit's and lm's optimizer state is split
over `data` (ZeRO). Checkpoint / resume through training/checkpoint.py
(a mesh's state gathered to rank 0 into the file one device writes, so
either resumes the other), metrics as JSONL (observability.MetricsLogger).
Sequences of 2,048 positions or more go through the flash kernels, which
take bfloat16 (--bf16) and float32 (the default; the f32 kernels of
ops/csrc/flash_f32.cu, slower).

Dataset format (data/loader.ShardedNpzDataset, directories of .npz shards):
  dit: latents (N,T,C,H,W) f32, context (N,text_len,text_dim) f32,
       tokens (N,num_semantic) i32
  lm : t5_feats (N,n_text,t5_dim) f32, codes (N,num_visual) i32
  vq : features (N,T,h,w,C) f32   (Theia feature maps)

`--synth N` writes a synthetic dataset of N samples first (random tensors
with the production keys and shapes at the active config scale): the
smoke path of the tests, and a dry run of the whole loop.

Random draws: the step's generator is seeded from (seed, step index), so
a resumed run draws what an uninterrupted one would at the same step.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

from landiff_tpu_torch.config import LanDiffConfig, tiny_test_config
from landiff_tpu_torch.data import loader as data_lib
from landiff_tpu_torch.observability import MetricsLogger
from landiff_tpu_torch.training import checkpoint as ckpt_lib
from landiff_tpu_torch.training import diffusion_loss, lm_train, \
    mesh_train, optim, vq_train
from landiff_tpu_torch.utils import tree_leaves

logger = logging.getLogger("landiff_tpu_torch.train")


def parse_mesh(spec: str | None) -> dict[str, int]:
    """"data=2,model=4" -> {"data": 2, "model": 4}; None -> {}."""
    if not spec:
        return {}
    return {k.strip(): int(v) for k, v in
            (part.split("=") for part in spec.split(","))}


def make_optimizer(lr: float, steps: int, *, warmup: int = 100,
                   weight_decay: float = 1e-4, clip: float = 1.0,
                   grad_accum: int = 1):
    """AdamW + global-norm clip + warmup-cosine; `grad_accum` k > 1 wraps
    the chain in MultiSteps: k micro-batch gradients are averaged and
    applied as ONE update every k-th step (the steps between emit zero
    updates), and the schedule counts APPLIED updates (steps // k). See
    training/optim.py for what this reproduces of optax."""
    if grad_accum > 1:
        steps = max(1, steps // grad_accum)
    wu = min(warmup, max(1, steps // 10))
    sched = optim.warmup_cosine_decay_schedule(
        0.0, lr, wu, max(steps, wu + 1), lr * 0.1)
    opt = optim.ClipAdamW(sched, weight_decay=weight_decay, clip=clip)
    if grad_accum > 1:
        opt = optim.MultiSteps(opt, every_k=grad_accum)
    return opt


# ---------------------------------------------------------------------------
# synthetic datasets (production keys/shapes at the active config scale)


def synthesize(model: str, cfg: LanDiffConfig, n: int, out_dir: str,
               seed: int = 0, shard_size: int = 8):
    rng = np.random.default_rng(seed)
    d, t = cfg.dit, cfg.tokenizer
    if model == "dit":
        n_sem = t.titok.iframe_latent_tokens + \
            (t.titok.temporal_size - 1) * t.titok.pframe_latent_tokens
        data = {
            "latents": rng.standard_normal(
                (n, d.latent_frames, d.in_channels, d.latent_height,
                 d.latent_width), np.float32),
            "context": rng.standard_normal(
                (n, d.text_length, d.text_dim), np.float32),
            "tokens": rng.integers(0, t.vq.codebook_size,
                                   (n, n_sem), dtype=np.int32),
        }
    elif model == "lm":
        l = cfg.llm
        sched = _lm_schedule(cfg)
        data = {
            "t5_feats": rng.standard_normal((n, 8, cfg.t5.d_model),
                                            np.float32),
            "codes": rng.integers(0, l.codebook_size,
                                  (n, sched.num_visual), dtype=np.int32),
        }
    elif model == "vq":
        data = {
            "features": rng.standard_normal(
                (n, t.titok.temporal_size, t.titok.grid_h, t.titok.grid_w,
                 t.feature_dim), np.float32),
        }
    else:
        raise ValueError(model)
    return data_lib.write_npz_shards(data, out_dir, shard_size)


def _lm_schedule(cfg: LanDiffConfig):
    from landiff_tpu_torch.models import lm as lm_lib

    # prefix: BOS + 2 micro + n_text + SOI (lm_model.py:188-204)
    return lm_lib.build_schedule(cfg.llm, 1 + 2 + 8 + 1,
                                 cfg.llm.frames_per_segment)


# ---------------------------------------------------------------------------
# per-model setup: (init_state, run, frozen trees) triples


def _setup_dit(cfg: LanDiffConfig, optimizer, device, dtype):
    from landiff_tpu_torch.models import dit as dit_lib
    from landiff_tpu_torch.models import semantic_cond as sc_lib

    gen = torch.Generator(device=device).manual_seed(0)
    main_p = dit_lib.init(gen, cfg.dit, dtype=dtype)
    ctrl_p = dit_lib.init(gen, cfg.dit, control=True, dtype=dtype)
    sem_p = sc_lib.init(gen, cfg.tokenizer, cfg.semantic_cond, dtype=dtype)
    opt_state = optimizer.init(ctrl_p)
    step = diffusion_loss.make_train_step(
        optimizer, cfg.dit, cfg.sampler, cfg.tokenizer, cfg.semantic_cond,
        compute_dtype=dtype)

    def run(state, batch, gen):
        ctrl_p, opt_state = state
        ctrl_p, opt_state, loss = step(
            ctrl_p, opt_state, main_p, sem_p, batch["latents"],
            batch["context"], batch["tokens"], gen)
        return (ctrl_p, opt_state), {"loss": loss}

    return (ctrl_p, opt_state), run, {"main": main_p, "sem": sem_p}


def _setup_lm(cfg: LanDiffConfig, optimizer, device, dtype,
              cfg_drop_prob: float = 0.1,
              micro_drop_probs: dict | None = None):
    """Stage-1 step with the conditioners INSIDE the gradient (text proj,
    micro MLPs, token embeddings, null embeddings) and CFG conditioning
    dropout (TextCond cfg_drop_prob=0.1 per llm_cfg.py:60-62; optional
    per-key micro drop)."""
    from landiff_tpu_torch.models import lm as lm_lib

    gen = torch.Generator(device=device).manual_seed(0)
    params = lm_lib.init(gen, cfg.llm, t5_dim=cfg.t5.d_model, dtype=dtype,
                         micro_drop_probs=micro_drop_probs)
    opt_state = optimizer.init(params)
    micro = {"frames": cfg.llm.frames_per_segment, "motion_score": 0.1}
    step = lm_train.make_cond_train_step(
        optimizer, cfg.llm, micro, cfg_drop_prob=cfg_drop_prob,
        micro_drop_probs=micro_drop_probs, compute_dtype=dtype)

    def run(state, batch, gen):
        params, opt_state = state
        params, opt_state, loss = step(params, opt_state, batch["t5_feats"],
                                       batch["codes"], gen)
        return (params, opt_state), {"loss": loss}

    return (params, opt_state), run, {}


def _setup_vq(cfg: LanDiffConfig, optimizer, device, dtype):
    """The tokenizer step in `dtype`; the parameters stay f32 and, on the
    first batch, the codebook is k-means-initialised from that batch's
    projected latents (vq_train.kmeans_input: the encoder half of the
    loss in f32)."""
    from landiff_tpu_torch.models import vq as vq_lib

    gen = torch.Generator(device=device).manual_seed(0)
    params = vq_lib.init(gen, cfg.tokenizer, with_theia=False)
    opt_state = optimizer.init(params)
    cb_state = vq_train.init_codebook_state(cfg.tokenizer, device)
    step = vq_train.make_train_step(optimizer, cfg.tokenizer,
                                    compute_dtype=dtype)

    def run(state, batch, gen):
        params, opt_state, cb_state, first = state
        feats = batch["features"]
        if first:
            zin = vq_train.kmeans_input(params, feats, cfg.tokenizer)
            params = dict(params)
            params["quant"] = dict(params["quant"])
            params["quant"]["codebook"] = vq_train.kmeans_init_codebook(
                zin, cfg.tokenizer.vq.codebook_size, gen)
        params, opt_state, cb_state, metrics = step(params, opt_state,
                                                    cb_state, feats, gen)
        return (params, opt_state, cb_state, False), metrics

    return (params, opt_state, cb_state, True), run, {}


SETUPS = {"dit": _setup_dit, "lm": _setup_lm, "vq": _setup_vq}


# ---------------------------------------------------------------------------


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s generator, mixed from the pair."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`: seeded from the pair, not advanced
    from step to step, so a resumed run draws what an uninterrupted one
    would at the same step (a mesh's ranks each seed their own from
    step_seed)."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def _train_mesh(mesh_spec, device):
    """(the mesh, whether train made it) for `mesh_spec`: a Mesh or a
    ProcessMesh as given; a spec of more than one device made on
    `device`'s type; None for no spec or a mesh of one device (the
    one-device run)."""
    from landiff_tpu_torch.parallel import mesh as mesh_lib

    if isinstance(mesh_spec, (mesh_lib.Mesh, mesh_lib.ProcessMesh)):
        return mesh_spec, False
    if not mesh_spec or all(n == 1 for n in parse_mesh(mesh_spec).values()):
        return None, False
    return mesh_lib.as_mesh(mesh_spec, device), True


def train(model: str, data_dir: str, *, steps: int = 100,
          batch_size: int = 2, lr: float = 1e-4, mesh_spec: str | None = None,
          ckpt_dir: str | None = None, save_every: int = 500,
          log_every: int = 10, metrics_path: str | None = None,
          resume: bool = False, tiny: bool = False, seed: int = 0,
          dtype=torch.float32, grad_accum: int = 1, device="cuda"):
    """Train `model` for `steps` steps on the data in data_dir. mesh_spec:
    None (one device), a spec string ("data=2,model=2"), a
    parallel.mesh.Mesh or a ProcessMesh (multihost.global_mesh: every
    launched process calls train alike, and rank 0's alone writes the
    checkpoints and the metrics file); the caller keeps a mesh it gave
    (a mesh made from a spec is closed at the end). Returns (state, last
    metrics): the state in one device's layout."""
    cfg = tiny_test_config() if tiny else LanDiffConfig()
    device = torch.device(device)
    mesh, own_mesh = _train_mesh(mesh_spec, device)
    opt_kw = {"lr": lr, "steps": steps, "grad_accum": grad_accum}
    optimizer = make_optimizer(**opt_kw)
    state, run, frozen = SETUPS[model](cfg, optimizer, device, dtype)
    logger.info("device %s, mesh %s, %d params leaves", device,
                mesh and mesh.cfg, len(tree_leaves(state[0])))

    start = 0
    if resume and ckpt_dir and Path(ckpt_dir).exists():
        try:
            # the FULL state tuple round-trips
            template = {"params": state[0], "opt_state": state[1],
                        "extra": {"rest": list(state[2:])}}
            start, restored = ckpt_lib.restore_checkpoint(ckpt_dir,
                                                          template=template)
            state = (restored["params"], restored["opt_state"],
                     *restored["extra"]["rest"])
            # `start` counts completed steps; the loop index i is 0-based,
            # so resuming after saved step N continues at i = N (step N+1)
        except FileNotFoundError:
            pass

    trainer = None
    if mesh is not None:
        # every rank takes its parts of the state; the one-device trees
        # and step are let go here
        trainer = mesh_train.MeshTrainer(mesh, model, cfg, opt_kw, dtype,
                                         state, frozen)
        del state, frozen
        state = None

        def run(state, batch, gen):
            return None, trainer.step(batch, gen)

    ds = data_lib.ShardedNpzDataset(data_dir, batch_size, seed=seed)
    writes = mesh is None or mesh.ctx.rank == 0
    metrics = MetricsLogger(metrics_path if writes else None)

    def host_batches():
        epoch = 0
        while True:
            yield from ds.iter_epoch(epoch)
            epoch += 1

    hb = host_batches()
    # resume determinism: replay the data stream to the checkpoint cursor
    # (batches are seeded-shuffled, so skipping `start` host batches lands
    # exactly where the interrupted run was)
    for _ in range(start):
        next(hb)
    it = data_lib.prefetch_to_device(hb, device=device)
    t0 = time.time()
    last = {}
    for i in range(start, steps):
        rng = step_seed(seed, i) if trainer else \
            step_generator(seed, i, device)
        state, last = run(state, next(it), rng)
        if (i + 1) % log_every == 0 or i + 1 == steps:
            row = {k: float(v) for k, v in last.items()}   # waits for the device
            dt = (time.time() - t0) / max(1, i + 1 - start)
            metrics.log(i + 1, sec_per_step=dt, **row)
            logger.info("step %d %s (%.3f s/step)", i + 1, row, dt)
        if ckpt_dir and ((i + 1) % save_every == 0 or i + 1 == steps):
            # every rank takes part in gathering the state
            full = trainer.state() if trainer else state
            if writes:
                ckpt_lib.save_checkpoint(ckpt_dir, i + 1, *_split(full))
    if trainer is not None:
        state = trainer.state()
        trainer.close()
        if own_mesh:
            mesh.close()
    return state, last


def _split(state):
    """(params, opt_state, extra) of a state tuple for save_checkpoint."""
    return state[0], state[1], {"rest": list(state[2:])}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(SETUPS), required=True)
    ap.add_argument("--data", required=True, help=".npz shard dir")
    ap.add_argument("--synth", type=int, default=0,
                    help="write N synthetic samples to --data first")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--mesh", default=None,
                    help="e.g. data=2,model=4 or data=1,time=2 (ranks on "
                         "--device's type: a GPU each, or all on the CPU)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics", default=None, help="JSONL path")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batches per optimizer update "
                         "(DeepSpeed gradient_accumulation_steps)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    args = ap.parse_args(argv)

    cfg = tiny_test_config() if args.tiny else LanDiffConfig()
    if args.synth:
        synthesize(args.model, cfg, args.synth, args.data, seed=args.seed)
    train(args.model, args.data, steps=args.steps,
          batch_size=args.batch_size, lr=args.lr, mesh_spec=args.mesh,
          ckpt_dir=args.ckpt_dir, save_every=args.save_every,
          log_every=args.log_every, metrics_path=args.metrics,
          resume=args.resume, tiny=args.tiny, seed=args.seed,
          dtype=torch.bfloat16 if args.bf16 else torch.float32,
          grad_accum=args.grad_accum, device=args.device)


if __name__ == "__main__":
    main()
