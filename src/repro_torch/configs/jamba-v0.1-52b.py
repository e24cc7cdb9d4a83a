"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
on alternate layers [arXiv:2403.19887].

Adaptation note, the reference's: Jamba's Mamba-1 mixers are implemented
as Mamba-2 SSD blocks (the chunked form, same interface); state size 128
per the SSD parameterization rather than Mamba-1's 16.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    # 1 attention per 8 layers (1:7 Mamba:attention interleave)
    pattern=("M", "M", "M", "A", "M", "M", "M", "M"),
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    rope_theta=0.0,              # Jamba uses no positional encoding
    attn_kind_decode="golden",
    golden_blocks=64,
    golden_block_size=128,
    source="arXiv:2403.19887 (Jamba v0.1)",
)
