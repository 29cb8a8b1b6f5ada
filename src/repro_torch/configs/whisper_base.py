"""whisper-base [audio] — encoder-decoder; conv/mel frontend is a STUB
per the assignment carve-out: input_specs provides 1500 frame
embeddings.  Decoder shapes beyond the real 448-token cap are exercised
synthetically by the generic cache machinery.  [arXiv:2212.04356]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,          # decoder layers
    encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    rope_theta=10_000.0,
    source="arXiv:2212.04356 (whisper-base: 6+6 layers, d=512)",
)
