"""qwen2.5-32b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    attn_kind_decode="golden",   # paper-derived block-sparse decode
    golden_blocks=64,
    golden_block_size=128,
    source="hf:Qwen/Qwen2.5-0.5B (family scaling per assignment)",
)
