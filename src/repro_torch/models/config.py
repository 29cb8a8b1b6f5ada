"""Model configuration covering all assigned architecture families.

One ``ModelConfig`` describes dense, MoE, SSM (Mamba2/SSD), hybrid
(Jamba), encoder-decoder (Whisper) and VLM (LLaVA) backbones. Layer
heterogeneity (Jamba's 1:7 attention:mamba interleave with alternating
MoE) is expressed via periodic *layer kinds*.

A copy of ``repro.models.config`` with ``dtype`` a ``torch.dtype``
(bf16 by default, fp32 in ``reduced()``). ``remat`` and ``cast_grads``
act in the train step (``models/model.py``); the knobs that only the
reference's XLA path reads (``scan_unroll``, ``moe_local_dispatch``,
``shard_attn_seq``) stay as fields so a config means the same in both
packages, and the port's Python loop over layers ignores them. ``use_pallas``
means what it means in the reference: attention goes through the
``flash_attention`` kernel (on a CUDA tensor the hand-written kernel,
on a CPU tensor its plain version).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int = 0  # 0 -> = n_heads (MHA)
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    moe_period: int = 1  # MoE on layers where idx % moe_period == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- attention pattern ---
    sliding_window: int = 0  # 0 = full attention
    attn_period: int = 1  # attention layer when idx % attn_period == attn_offset
    attn_offset: int = 0  # remaining layers are Mamba (hybrid / pure SSM)
    no_ffn: bool = False  # pure-SSM blocks (Mamba2) have no separate FFN
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500  # stub conv-frontend output frames
    # --- VLM ---
    n_patches: int = 0  # stub vision-frontend patch embeddings
    # --- bookkeeping ---
    family: str = "dense"  # dense|moe|ssm|hybrid|vlm|audio
    source: str = ""  # citation for the assigned config
    dtype: Any = torch.bfloat16
    # --- runtime knobs (perf levers) ---
    remat: str = "none"  # none|dots|full
    use_pallas: bool = False
    scan_unroll: bool = False  # unroll layer scans (dry-run cost probes)
    # beyond-paper perf levers (EXPERIMENTS.md §Perf):
    cast_grads: bool = False  # cast trunk activation grads to cfg.dtype
    moe_local_dispatch: bool = False  # per-row MoE dispatch (no cross-shard gather)
    attn_block_skip: bool = False  # skip fully-masked KV blocks in blocked attn
    shard_attn_seq: bool = False  # context-parallel attention: shard q-seq over
    # the model axis when head count doesn't divide it (q-heads replicated)
    max_decode_len: int = 32768

    def __post_init__(self):
        if self.n_kv_heads == 0:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ----- derived structure -----
    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def mixer_kinds(self) -> List[str]:
        """Per-layer sequence-mixer kind ('attn' or 'mamba')."""
        if self.family == "ssm":
            return ["mamba"] * self.n_layers
        kinds = []
        for i in range(self.n_layers):
            if self.attn_period > 1:
                kinds.append("attn" if i % self.attn_period == self.attn_offset else "mamba")
            else:
                kinds.append("attn")
        return kinds

    def ffn_kinds(self) -> List[str]:
        if self.no_ffn:
            return ["none"] * self.n_layers
        if self.n_experts == 0:
            return ["mlp"] * self.n_layers
        return [
            "moe" if i % self.moe_period == self.moe_offset else "mlp"
            for i in range(self.n_layers)
        ]

    def period(self) -> int:
        """Smallest p such that (mixer, ffn) kinds repeat with period p."""
        mixer, ffn = self.mixer_kinds(), self.ffn_kinds()
        pattern = list(zip(mixer, ffn))
        for p in range(1, self.n_layers + 1):
            if self.n_layers % p == 0 and all(
                pattern[i] == pattern[i % p] for i in range(self.n_layers)
            ):
                return p
        return self.n_layers

    def sublayer_kinds(self) -> List[Tuple[str, str]]:
        p = self.period()
        return list(zip(self.mixer_kinds()[:p], self.ffn_kinds()[:p]))

    @property
    def n_superblocks(self) -> int:
        return self.n_layers // self.period()

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant of the same family (CPU-runnable)."""
        p = self.period()
        small: dict = dict(
            n_layers=min(2 * p, self.n_layers),
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=max(min(self.n_kv_heads, 2), 1),
            head_dim=32,
            d_ff=min(self.d_ff, 256),
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 24) if self.encoder_layers else self.encoder_seq,
            n_patches=min(self.n_patches, 16),
            ssm_state=min(self.ssm_state, 32),
            ssm_head_dim=min(self.ssm_head_dim, 32) if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=16,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            max_decode_len=64,
            dtype=torch.float32,
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return self.replace(**small)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embedding + blocks + head)."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.head_dim
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    if cfg.qkv_bias:
        attn += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    mlp = 3 * d * f
    moe = cfg.n_experts * 3 * d * f + d * cfg.n_experts if cfg.n_experts else 0
    di, N = cfg.d_inner, cfg.ssm_state
    G = 1
    conv_dim = di + 2 * G * N
    mamba = (
        d * (2 * di + 2 * G * N + cfg.ssm_n_heads)
        + cfg.ssm_conv * conv_dim
        + 3 * cfg.ssm_n_heads  # A, D, dt_bias
        + di  # gated norm
        + di * d
    ) if cfg.ssm_state else 0
    total = 2 * V * d  # embed + head
    for (mixer, ffn) in zip(cfg.mixer_kinds(), cfg.ffn_kinds()):
        total += d  # pre-mixer norm
        total += attn if mixer == "attn" else mamba
        if ffn != "none":
            total += d  # pre-ffn norm
            total += moe if ffn == "moe" else mlp
    if cfg.is_encdec:
        enc_block = 2 * d + attn + mlp
        total += cfg.encoder_layers * enc_block + d
        total += cfg.n_layers * (d + attn)  # decoder cross-attn + norm
    total += d  # final norm
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Params active per token (MoE uses top_k of n_experts)."""
    if cfg.n_experts == 0:
        return param_count(cfg)
    dense_moe = cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    active_moe = cfg.top_k * 3 * cfg.d_model * cfg.d_ff
    n_moe_layers = sum(1 for k in cfg.ffn_kinds() if k == "moe")
    return param_count(cfg) - n_moe_layers * (dense_moe - active_moe)
