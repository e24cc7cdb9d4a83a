"""starcoder2-3b [dense] — GQA kv=2, RoPE [arXiv:2402.19173]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    qkv_bias=True,
    rope_theta=1e4,
    attn_kind_decode="golden",
    golden_blocks=64,
    golden_block_size=128,
    source="arXiv:2402.19173 (StarCoder2-3B)",
)
