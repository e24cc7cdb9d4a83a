"""The model inputs of the four assigned shapes (counterpart of
``repro.launch.inputs``): ``SHAPES``, ``concrete_inputs`` and
``input_specs``.  Decode shapes feed ``decode_step`` (one new token
against a seq_len KV cache, and a Mamba layer's conv and SSM states);
train and prefill feed full-sequence steps.  ``input_specs`` gives the
dry run's inputs: DTensors on the rules' placements that allocate
nothing.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.module import abstract_tensor
from repro_torch.models.transformer import abstract_cache, zero_cache
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def concrete_inputs(cfg: ModelConfig, shape: InputShape,
                    generator: torch.Generator | None = None,
                    device=None) -> dict:
    """Inputs of ``shape`` on ``device`` (the card unless the caller names
    another): uniform tokens from ``generator`` (seed 0 by default; its
    draws are not ``jax.random``'s) with next-token labels for train,
    tokens for prefill, and a zero cache, zero tokens and the last
    position for decode.  A frontend arch's F = ``frontend_tokens``
    positions of a train or prefill sequence are its embeddings: tokens
    [B, S - F] and ``embeds`` [B, F, d_model] = 0.02 x normal (fp32),
    drawn from the same generator after the tokens."""
    device = resolve_device(device)
    b, s = shape.global_batch, shape.seq_len
    f = cfg.frontend_tokens if cfg.frontend else 0
    if shape.kind in ("train", "prefill"):
        gen = generator or torch.Generator().manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (b, s - f), generator=gen,
                             device=gen.device).to(device)
        out = {"tokens": toks}
        if shape.kind == "train":
            out["labels"] = torch.roll(toks, -1, dims=1)
        if f:
            out["embeds"] = (0.02 * torch.randn(
                (b, f, cfg.d_model), generator=gen, device=gen.device,
                dtype=torch.float32)).to(device)
        return out
    if shape.kind == "decode":
        return {"cache": zero_cache(cfg, b, s, device),
                "token": torch.zeros((b,), dtype=torch.int64, device=device),
                "pos": torch.full((), s - 1, dtype=torch.int64,
                                  device=device)}
    raise ValueError(shape.kind)


def input_specs(cfg: ModelConfig, shape: InputShape, rules,
                device=None) -> dict:
    """The abstract inputs of the step of this (arch, shape) under
    ``rules`` (a mesh): tokens and labels [B, S - F] int64 on ("batch",
    "seq"), a frontend's embeds [B, F, d] fp32 on ("batch", "seq",
    "act_embed"); for decode the cache (``abstract_cache``), the token
    [B] on ("batch",) and the position S - 1 (an int).  Fake tensors
    under an active ``FakeTensorMode`` (on ``device``), else meta."""
    b, s = shape.global_batch, shape.seq_len
    f = cfg.frontend_tokens if cfg.frontend else 0

    def tok(shp, axes=("batch", "seq")):
        return abstract_tensor(shp, axes, torch.int64, rules, device)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": tok((b, s - f))}
        if shape.kind == "train":
            out["labels"] = tok((b, s - f))
        if f:
            out["embeds"] = abstract_tensor((b, f, cfg.d_model),
                                            ("batch", "seq", "act_embed"),
                                            torch.float32, rules, device)
        return out
    if shape.kind == "decode":
        return {"cache": abstract_cache(cfg, b, s, rules, device),
                "token": tok((b,), ("batch",)), "pos": s - 1}
    raise ValueError(shape.kind)
