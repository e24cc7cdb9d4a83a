"""llama3.2-3b [dense] — small llama3, GQA kv=8 [hf:meta-llama/Llama-3.2-1B family]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    arch_type="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
    attn_kind_decode="golden",
    golden_blocks=64,
    golden_block_size=128,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B (family scaling per assignment)",
)
