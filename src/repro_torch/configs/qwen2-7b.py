"""qwen2-7b [dense] — GQA kv=4, QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    attn_kind_decode="golden",
    golden_blocks=64,
    golden_block_size=128,
    source="arXiv:2407.10671 (Qwen2-7B)",
)
