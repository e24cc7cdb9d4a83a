"""Model FLOPs of a step (counterpart of ``model_flops`` in
``repro.distributed.hlo_analysis``).  The reference's cost, memory and
collective parsing of compiled HLO waits for ``launch/dryrun.py``
(ROADMAP Queue 1); the train phase of ``chip_smoke.py`` reports a step's
share of the card's bf16 peak with this count.
"""
from __future__ import annotations


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N_active D (train) / 2 N_active D (inference).

    N_active excludes the embedding gather but includes the LM head; MoE
    layers count experts_per_token / num_experts of their expert params.
    ``cfg`` needs the config fields the count reads (any family's), and
    ``shape`` ``kind``, ``global_batch`` and ``seq_len``."""
    d, ff, n_layers = cfg.d_model, cfg.d_ff, cfg.num_layers
    n_attn = 0
    n_mlp_dense = 3 * d * ff
    n_moe_active = (3 * d * ff * cfg.experts_per_token
                    if cfg.num_experts else 0)
    if cfg.num_heads:
        hd = cfg.hdim
        n_attn = d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
    n_mamba = 0
    if cfg.ssm_state:
        di = cfg.ssm_expand * d
        n_mamba = d * (2 * di + 2 * cfg.ssm_state + di // cfg.ssm_head_dim) \
            + di * d
    n = 0
    for i in range(n_layers):
        li = i % cfg.period
        n += n_attn if cfg.mixer_kind(li) == "A" else n_mamba
        n += {"dense": n_mlp_dense, "moe": n_moe_active,
              "none": 0}[cfg.mlp_kind(li)]
    n += d * cfg.vocab_size                      # LM head
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token / seq
