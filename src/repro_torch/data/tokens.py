"""Deterministic synthetic token pipeline for LLM training (counterpart
of ``repro.data.tokens``).

A seeded mixture of order-1 Markov chains over the vocabulary plus copy
spans: enough structure that a small model's loss visibly falls within a
few hundred steps, fully reproducible, zero files.  The tables and the
walk are numpy, drawn as the reference draws them; the tables' float32
softmax is torch's, which differs from JAX's in the last bit of many
entries, so a draw within rounding of a bucket edge could pick the next
token.  The tests pin the batches equal to the reference's at named
configurations.  ``TokenPipeline.batch`` returns int64 CPU tensors (the
reference int32 arrays); the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_chains: int = 8
    copy_prob: float = 0.15
    seed: int = 0


class TokenPipeline:
    """Stateless-per-step token source: batch(step) is pure in (cfg, step)."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab_size, 4096)  # transition table over a head-vocab
        self._v = v
        # sparse-ish row-stochastic transition tables, one per chain
        self.tables = []
        for _ in range(cfg.num_chains):
            logits = rng.gumbel(size=(v, 32))
            cols = rng.integers(0, v, (v, 32))
            probs = torch.softmax(torch.from_numpy(logits).float(), -1)
            self.tables.append((cols, probs.numpy()))

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        b, s, v = cfg.global_batch, cfg.seq_len, self._v
        chain = rng.integers(0, cfg.num_chains, b)
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, b)
        for i in range(b):
            cols, probs = self.tables[chain[i]]
            cur = toks[i, 0]
            u = rng.random(s)
            for j in range(1, s + 1):
                p = probs[cur]
                cur = cols[cur, np.searchsorted(np.cumsum(p), u[j - 1])]
                toks[i, j] = cur
        # splice copy spans (long-range structure)
        n_copy = int(cfg.copy_prob * b)
        for i in range(n_copy):
            span = rng.integers(8, min(64, s // 4))
            src = rng.integers(0, s - 2 * span)
            dst = rng.integers(src + span, s - span)
            toks[i, dst:dst + span] = toks[i, src:src + span]
        toks = torch.from_numpy(toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def fast_batch(cfg: TokenPipelineConfig, step: int,
               device=None) -> dict[str, torch.Tensor]:
    """Uniform tokens drawn on ``device`` (the CPU by default) from a
    ``torch.Generator`` seeded by ``(seed << 20) ^ step``: the shapes and
    the one-position shift of the reference's ``fast_batch``, not its
    ``jax.random`` draws."""
    device = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=device).manual_seed((cfg.seed << 20) ^ step)
    toks = torch.randint(0, cfg.vocab_size,
                         (cfg.global_batch, cfg.seq_len + 1),
                         generator=gen, device=device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
