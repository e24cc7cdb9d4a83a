"""Golden attention on an LLM KV cache (the port's counterpart of
``examples/golden_decode.py``).

Builds a llama3.2-3b model (full width by default, ``--reduced`` for
the example's 4-layer, d_model 256 variant) with random weights from
``--seed``, prefills a random ``--seq``-token cache, decodes the next
token with full attention and with golden attention over a sweep of
golden block counts, and prints the agreement of the next-token
distributions (KL(full || golden), top-1 match) beside the share of
the cache each reads.  The last section drives the kernel layer
directly: ``ops.select_golden_blocks`` + ``ops.golden_attention_decode``
on the layer-0 cache with a query drawn from a generator, against the
op's plain version.

On the card the prefill's attention layers run the hand-written flash
attention kernel and the ops section the golden attention kernel;
``--device cpu`` runs their plain versions.

  PYTHONPATH=src python -m repro_torch.launch.golden_decode [--reduced] \
      [--device cpu] [--seed 0] [--seq 4096] [--batch 2]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import init_params
from repro_torch.utils import resolve_device

SWEEP_DIVISORS = (1, 2, 4, 8, 16)    # kb = nb / d, the example's sweep
OPS_DIVISOR = 8                      # the ops section's kb = max(1, nb / 8)
QUERY_SEED = 3                       # the ops section's query


def example_config(reduced: bool = False) -> ModelConfig:
    """llama3.2-3b (or the example's reduced variant) with the example's
    golden block size of 64."""
    cfg = get_config("llama3.2-3b")
    if reduced:
        cfg = cfg.reduced(num_layers=4, d_model=256, d_ff=512, vocab=1024)
    return dataclasses.replace(cfg, golden_block_size=64)


def draw_params(cfg: ModelConfig, seed: int, device) -> dict:
    """Random weights from a ``torch.Generator`` on ``device``."""
    device = torch.device(device)
    return init_params(T.model_specs(cfg),
                       torch.Generator(device=device).manual_seed(seed),
                       device)


def draw_tokens(cfg: ModelConfig, batch: int, seq_len: int, seed: int
                ) -> torch.Tensor:
    """[batch, seq_len] int64 tokens from a CPU generator (the same on
    every device)."""
    return torch.randint(0, cfg.vocab_size, (batch, seq_len),
                         generator=torch.Generator().manual_seed(seed + 1))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kl_top1(lg_full: torch.Tensor, lg_g: torch.Tensor) -> tuple[float, float]:
    """Mean KL(full || golden) of the next-token distributions and the
    top-1 agreement, over the padded vocab as the reference computes
    them."""
    p_full = torch.softmax(lg_full.float(), -1)
    logp_g = torch.log_softmax(lg_g.float(), -1)
    kl = (p_full * (torch.log(p_full + 1e-20) - logp_g)).sum(-1).mean()
    top1 = (lg_g.argmax(-1) == lg_full.argmax(-1)).float().mean()
    return float(kl), float(top1)


def run(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> dict:
    """Prefill ``tokens`` [B, S], decode the last token with full and
    golden attention at kb = nb / d for each d of SWEEP_DIVISORS, then
    the ops section.  Every tensor lives on ``tokens``' device.  Returns the
    logits, the sweep's rows, the ops section's blocks and outputs, and
    the prefill and full decode walls (host clock, synchronized)."""
    device = tokens.device
    b, s = tokens.shape
    _sync(device)
    t0 = time.perf_counter()
    lg_prefill, cache = T.prefill(cfg, params, tokens)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    # Every call below writes its own key and value at pos into the shared
    # cache before reading it, and the cache holds no summaries, so each
    # sees the reference's cache (see transformer.decode_step).
    pos, tok = s - 1, tokens[:, -1]
    t0 = time.perf_counter()
    lg_full, _ = T.decode_step(
        dataclasses.replace(cfg, attn_kind_decode="full",
                            golden_cached_summaries=False),
        params, cache, tok, pos)
    _sync(device)
    decode_s = time.perf_counter() - t0
    nb = s // cfg.golden_block_size
    rows, golden = [], {}
    for d in SWEEP_DIVISORS:
        kb = nb // d
        cfg_g = dataclasses.replace(cfg, attn_kind_decode="golden",
                                    golden_blocks=kb,
                                    golden_cached_summaries=False)
        golden[kb], _ = T.decode_step(cfg_g, params, cache, tok, pos)
        kl, top1 = kl_top1(lg_full, golden[kb])
        rows.append(dict(kb=kb, coverage=kb / nb, kl=kl, top1=top1))

    bs = cfg.golden_block_size
    kc, vc = cache["l0"]["k"][0], cache["l0"]["v"][0]      # [B, Hkv, S, dh]
    qh = torch.randn((b, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                      cfg.hdim),
                     generator=torch.Generator().manual_seed(QUERY_SEED)
                     ).to(device)
    blk, valid = ops.select_golden_blocks(qh, kc,
                                          num_blocks=max(1, nb // OPS_DIVISOR),
                                          block_size=bs)
    out = ops.golden_attention_decode(qh, kc, vc, blk, valid, block_size=bs)
    plain = ref.golden_attention_decode_ref(qh, kc, vc, blk, valid, bs)
    return dict(prefill_logits=lg_prefill, full_logits=lg_full,
                golden_logits=golden, rows=rows, nb=nb, block_idx=blk,
                ops_out=out, ops_err=float((out.float() - plain.float())
                                           .abs().max()),
                prefill_s=prefill_s, decode_s=decode_s)


def print_report(cfg: ModelConfig, res: dict, device: torch.device) -> None:
    print(f"\n{'k blocks':>9s} {'coverage':>9s} {'KL(full||gold)':>15s} "
          f"{'top1 match':>11s} {'cache read':>11s}")
    for r in res["rows"]:
        print(f"{r['kb']:9d} {r['coverage']:9.1%} {r['kl']:15.5f} "
              f"{r['top1']:11.0%} {r['coverage']:10.1%}+summaries")
    nb = res["nb"]
    print(f"\nops-layer golden_attention_decode on {device.type}, "
          f"{max(1, nb // OPS_DIVISOR)}/{nb} blocks: op vs plain version "
          f"max|delta| = {res['ops_err']:.2e}")
    print(f"prefill {res['prefill_s'] * 1e3:.1f} ms, full decode step "
          f"{res['decode_s'] * 1e3:.1f} ms (host clock, {cfg.num_layers} "
          f"layers)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the example's reduced config (4 layers, d_model "
                         "256, d_ff 512, vocab 1024)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = example_config(args.reduced)
    params = draw_params(cfg, args.seed, device)
    tokens = draw_tokens(cfg, args.batch, args.seq, args.seed).to(device)
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, on {device}; "
          f"prefilling a {args.seq}-token cache, batch {args.batch}...")
    res = run(cfg, params, tokens)
    print_report(cfg, res, device)
    return res


if __name__ == "__main__":
    main()
