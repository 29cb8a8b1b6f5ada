"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088 (Mixtral 8x22B)",
)
