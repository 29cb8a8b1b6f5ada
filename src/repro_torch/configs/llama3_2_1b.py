"""llama3.2-1b [dense] — small llama3.  [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=128256,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-1B",
)

# Sliding-window VARIANT used only for the long_500k shape (the assigned
# dense arch has full attention; this demonstrates the dense carve-in
# allowed by the assignment for sub-quadratic long-context decode).
CONFIG_SWA = CONFIG.replace(name="llama3.2-1b-swa8k", sliding_window=8192)
