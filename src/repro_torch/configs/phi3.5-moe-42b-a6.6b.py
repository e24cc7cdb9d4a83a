"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2, GQA kv=8
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    moe_every=1,
    rope_theta=1e4,
    attn_kind_decode="golden",
    golden_blocks=64,
    golden_block_size=128,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
