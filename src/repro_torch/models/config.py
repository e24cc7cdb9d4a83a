"""Architecture configuration for the model zoo.

A copy of ``repro.models.config.ModelConfig`` (the port imports nothing
of the JAX package), with ``param_dtype`` giving a ``torch.dtype``, so
that config files copy across unchanged.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | ssm | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512
    moe_every: int = 0             # 0 = no MoE; 1 = every layer; 2 = alternate
    moe_offset: int = 0
    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # mixer pattern within one repeating period ("A"=attention, "M"=mamba)
    pattern: tuple[str, ...] = ("A",)
    # the reference's flash-attention tile sizes: checked, and otherwise
    # only the order of the sums
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    # decode attention: "full" or "golden" (top-k block-sparse)
    attn_kind_decode: str = "full"
    golden_blocks: int = 64
    golden_block_size: int = 128
    # keep block summaries in the KV cache, updated at append time
    golden_cached_summaries: bool = False
    # modality frontend stub
    frontend: str | None = None    # None | "vision" | "audio"
    frontend_tokens: int = 0
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    remat: bool = True
    scan_layers: bool = True
    # citation for the exact config (public pool provenance)
    source: str = ""

    def __post_init__(self):
        if self.num_layers % len(self.pattern):
            raise ValueError(f"{self.name}: num_layers {self.num_layers} is "
                             f"not a multiple of the pattern {self.pattern}")
        if self.moe_every and len(self.pattern) != 1 and \
                len(self.pattern) % self.moe_every:
            raise ValueError(f"{self.name}: moe_every {self.moe_every} does "
                             f"not divide the pattern {self.pattern}")

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 512 (the reference's
        layout: the embedding and the logits span it)."""
        return -(-self.vocab_size // 512) * 512

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def repeats(self) -> int:
        return self.num_layers // self.period

    @property
    def param_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.dtype]

    def mixer_kind(self, i: int) -> str:
        return self.pattern[i]

    def mlp_kind(self, i: int) -> str:
        if self.d_ff == 0:
            return "none"          # pure mixer stack (e.g. Mamba-2)
        if self.moe_every and (i % self.moe_every == self.moe_offset
                               % self.moe_every):
            return "moe"
        return "dense"

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                d_ff: int = 512, num_experts: int | None = None,
                vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family (<=4 experts, d_model<=512)."""
        period = min(len(self.pattern), num_layers)
        pat = self.pattern[:period]
        nl = max(num_layers // period * period, period)
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        ne = (min(self.num_experts, 4) if num_experts is None else num_experts) \
            if self.num_experts else 0
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=nl, d_model=d_model,
            num_heads=0 if self.num_heads == 0 else heads,
            num_kv_heads=0 if self.num_kv_heads == 0 else kv,
            head_dim=d_model // heads,
            d_ff=0 if self.d_ff == 0 else d_ff,    # keep pure-mixer family
            vocab_size=vocab, pattern=pat,
            num_experts=ne, experts_per_token=min(self.experts_per_token, 2),
            moe_group_size=64, ssm_head_dim=32 if self.ssm_state else 64,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            frontend_tokens=min(self.frontend_tokens, 16),
            golden_blocks=4, golden_block_size=16,
            dtype="float32", remat=False)
