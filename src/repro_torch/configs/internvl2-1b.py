"""internvl2-1b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

This config is the LANGUAGE backbone; the InternViT vision encoder +
projector is a stub, as in the reference: ``launch.inputs.concrete_inputs``
and ``launch.train`` draw the patch embeddings [B, frontend_tokens,
d_model] from a seed.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=False,
    rope_theta=1e6,
    frontend="vision",
    frontend_tokens=1024,        # ViT patch embeddings prepended
    attn_kind_decode="golden",
    golden_blocks=64,
    golden_block_size=128,
    source="arXiv:2404.16821 (InternVL2-1B; Qwen2-0.5B-style LM backbone)",
)
