"""dbrx-132b [moe] — 16 experts top-4 fine-grained, GQA kv=8
[hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
    moe_every=1,
    rope_theta=5e5,
    attn_kind_decode="golden",
    golden_blocks=64,
    golden_block_size=128,
    source="hf:databricks/dbrx-base",
)
