"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060].  Pure mixer stack: d_ff = 0 (no MLP blocks).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,                 # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    pattern=("M",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,             # d_inner = 5120 -> 80 SSD heads
    ssm_conv=4,
    rope_theta=0.0,
    source="arXiv:2405.21060 (Mamba-2 2.7B)",
)
