"""qwen2-1.5b [dense] — GQA (kv=2), QKV bias.  [arXiv:2407.10671]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671 (Qwen2-1.5B)",
)
