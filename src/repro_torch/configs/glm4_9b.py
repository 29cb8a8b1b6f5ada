"""glm4-9b [dense] — RoPE, GQA (kv=2).  [hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=151552,
    rope_theta=10_000.0,
    source="hf:THUDM/glm-4-9b",
)
