"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].

Transformer backbone only; the EnCodec conv codec + text conditioner is a
stub, as in the reference: ``launch.inputs.concrete_inputs`` and
``launch.train`` draw the conditioning frame embeddings from a seed.
kv = heads = 24 (MHA).  The reference's adaptation, kept:
MusicGen's sinusoidal positions are replaced with RoPE.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    rope_theta=1e4,
    frontend="audio",
    frontend_tokens=512,         # conditioning frames prepended
    attn_kind_decode="golden",
    golden_blocks=64,
    golden_block_size=128,
    source="arXiv:2306.05284 (MusicGen-medium)",
)
