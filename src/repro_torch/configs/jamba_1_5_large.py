"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave with
MoE (16 experts, top-2) on alternating layers.  72 layers scan as 9
super-blocks of 8 (1 attn + 7 mamba).  [arXiv:2403.19887]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    rope_theta=1_000_000.0,
    source="arXiv:2403.19887 (Jamba-1.5-Large)",
)
