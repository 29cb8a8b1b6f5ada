"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality).
Pure Mamba2 blocks (no FFN; expand=2 inside the mixer).
[arXiv:2405.21060]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,        # attention-free; unused
    head_dim=64,
    d_ff=0,
    no_ffn=True,
    vocab=50280,
    attn_period=0,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    source="arXiv:2405.21060 (Mamba2-2.7B)",
)
