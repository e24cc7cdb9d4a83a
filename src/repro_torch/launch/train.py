"""Training launcher (counterpart of ``repro.launch.train``) on one
device or on the production mesh: token pipeline -> train step
(``launch.steps``: the loss through kernel 9 and its backward kernel on
the card, remat per layer when the config asks) -> AdamW -> checkpoint.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 30 --batch 4 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 50

It runs on the CUDA card unless given ``--device cpu``.  ``--arch``
takes any of the ten archs of ``repro_torch.configs`` (attention,
Mamba-2 or hybrid layers).  The weights are drawn from a seeded
``torch.Generator`` (not ``jax.random``'s draws).
A frontend arch (internvl2-1b, musicgen-medium) trains on ``seq - F``
tokens after F = ``frontend_tokens`` embeddings, drawn for step i from
``torch.Generator(device).manual_seed(1000 + i)`` as the reference
draws them from ``PRNGKey(1000 + i)``.

``--mesh`` (``train(use_mesh=True)``) runs on ``make_production_mesh()``
under ``make_rules("train", mesh)``: the caller starts one process a card
with the default process group initialised (256 ranks; another world
raises ``ValueError`` naming its size), every rank draws the same
weights and batches, and each keeps its shards (``param_shardings``).
The weights are drawn leaf by leaf, a stacked leaf one repeat at a time,
and each draw gives up all but the rank's chunk at once
(``init_params(..., rules=)``): beside its shards a card holds at most
one repeat of one leaf whole, in fp32 (4.2 GB: one of dbrx-132b's 40
``w_down`` repeats, [16, 10752, 6144]; its whole leaf is 84.6 GB in
bf16, more than a card).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import steps as step_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import init_params, param_count
from repro_torch.models.transformer import model_specs
from repro_torch.training import checkpoint
from repro_torch.training import optimizer as opt
from repro_torch.utils import resolve_device


def setup(cfg: ModelConfig, steps: int, batch: int, seq: int, device,
          num_microbatches: int = 1, seed: int = 0, rules=None):
    """``(params, opt_state, batches, step_fn)`` of a run: weights from
    ``torch.Generator(device).manual_seed(seed)``, AdamW at lr 1e-3 with
    a tenth of ``steps`` of warmup, the first ``min(steps, 8)`` batches
    of the Markov token pipeline on ``device`` (the pipeline is pure in
    (config, step), so cycling them stays honest) and the train step.
    A frontend arch's batches hold ``seq - F`` tokens and labels; step
    i's embeddings come from ``step_batch``.  Under ``rules`` with a mesh
    the parameters and the AdamW state are placed on its placements."""
    rules = make_rules("none") if rules is None else rules
    params = init_params(model_specs(cfg),
                         torch.Generator(device=device).manual_seed(seed),
                         rules=rules)
    opt_cfg = opt.AdamWConfig(lr=1e-3, total_steps=steps,
                              warmup_steps=max(steps // 10, 1))
    state = opt.init_state(params)
    tp = TokenPipeline(TokenPipelineConfig(cfg.vocab_size, seq, batch))
    f = frontend_len(cfg)
    batches = [{k: v[:, :seq - f].to(device) for k, v in tp.batch(i).items()}
               for i in range(min(steps, 8))]
    step_fn = step_lib.make_train_step(cfg, rules, opt_cfg,
                                       num_microbatches)
    return params, state, batches, step_fn


def frontend_len(cfg: ModelConfig) -> int:
    return cfg.frontend_tokens if cfg.frontend else 0


def step_batch(cfg: ModelConfig, batches: list[dict], i: int) -> dict:
    """Step i's batch: the cycled token batch, and for a frontend arch
    its embeddings [B, F, d_model] = 0.02 x normal (fp32) drawn on the
    batch's device from ``torch.Generator(device).manual_seed(1000 +
    i)``."""
    b = batches[i % len(batches)]
    f = frontend_len(cfg)
    if not f:
        return b
    toks = b["tokens"]
    gen = torch.Generator(device=toks.device).manual_seed(1000 + i)
    return dict(b, embeds=0.02 * torch.randn(
        (toks.shape[0], f, cfg.d_model), generator=gen, device=toks.device,
        dtype=torch.float32))


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: str | None = None, use_mesh: bool = False,
          log_every: int = 10, device=None) -> np.ndarray:
    """Train ``arch`` (``.reduced()`` with ``smoke``) for ``steps`` steps
    on ``device`` (the card unless the caller names another); returns the
    per-step NLL losses.  ``use_mesh`` runs on the production mesh (the
    default process group must hold its 256 ranks)."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    rules = make_rules("none")
    if use_mesh:
        from repro_torch.launch.mesh import make_production_mesh
        rules = make_rules("train", make_production_mesh(
            device_type=device.type))
    print(f"arch={cfg.name} params={param_count(model_specs(cfg)) / 1e6:.1f}M"
          f" layers={cfg.num_layers} d={cfg.d_model} device={device}")
    params, state, batches, step_fn = setup(cfg, steps, batch, seq, device,
                                            rules=rules)
    losses = []
    t0 = time.time()
    for i in range(steps):
        params, state, metrics = step_fn(params, state,
                                         step_batch(cfg, batches, i))
        losses.append(float(metrics["nll"]))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    if ckpt_dir:
        d = checkpoint.save(ckpt_dir, steps, {"params": params})
        print("checkpoint ->", d)
    return np.asarray(losses)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", action="store_true",
                    help="the production mesh: one process a card, 256 "
                         "ranks in the default process group")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: the CUDA card)")
    args = ap.parse_args()
    losses = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                   args.ckpt_dir, args.mesh, device=args.device)
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
          f"delta={losses[0] - losses[-1]:+.4f}")


if __name__ == "__main__":
    main()
