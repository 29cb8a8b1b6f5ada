"""llava-next-mistral-7b [vlm] — Mistral-7B backbone, anyres tiling.

Vision frontend (ViT/SigLIP + projector) is a STUB per the assignment
carve-out: input_specs provides 2880 projected patch embeddings
(anyres 672x672 budget).  [hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    n_patches=2880,
    rope_theta=1_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
