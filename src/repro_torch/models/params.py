"""Parameter specs and initialisation of the LM.

One spec tree, named as the reference's (``repro/models/params.py``),
drives the port's parameter module: ``init_params`` fills it with seeded
draws, ``convert.lm_params_from_arrays`` with a reference parameter tree.
The module is a tree of ``nn.Module``s whose attribute names are the
reference's keys (``params.blocks[i].mixer.wq``), so the layer functions
read the same names in both packages.

One layout differs: the reference stacks each sub-layer kind's blocks on
a leading ``n_superblocks`` axis for ``lax.scan``; the port keeps one
entry per layer (``blocks[i]``, of kind ``sublayer_kinds()[i % period]``)
and loops over them.

Serving builds frozen parameters (``requires_grad=False``); training
builds them with ``trainable=True`` and reads them as a tree through
``param_tree``, the form the optimizers (``repro_torch.optim``) take.
Only the dense attention + SwiGLU family builds; the MoE, Mamba,
cross-attention (audio) and patch-prefix (VLM) specs raise until their
ROADMAP items land.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.utils.device import resolve_device

# families that need modules the port does not have yet
_UNPORTED_FAMILIES = {
    "moe": "the MoE FFN (repro/models/layers.py::moe)",
    "ssm": "the Mamba2 mixer (repro/models/ssm.py)",
    "hybrid": "the Mamba2 mixer and the MoE FFN",
    "vlm": "the patch-embedding prefix",
    "audio": "the encoder and cross-attention",
}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: Any  # float std | "zeros" | "ones"
    dtype: torch.dtype


def check_buildable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port cannot run yet."""
    if cfg.family in _UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family needs {_UNPORTED_FAMILIES[cfg.family]}, "
            "not ported yet (ROADMAP queue 1 item 13)")
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def _attn_specs(cfg: ModelConfig) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    out_std = 1.0 / np.sqrt(H * hd) / np.sqrt(2.0 * cfg.n_layers)
    specs = {
        "wq": ParamSpec((d, H, hd), 1 / np.sqrt(d), dt),
        "wk": ParamSpec((d, K, hd), 1 / np.sqrt(d), dt),
        "wv": ParamSpec((d, K, hd), 1 / np.sqrt(d), dt),
        "wo": ParamSpec((H, hd, d), out_std, dt),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((H, hd), "zeros", dt)
        specs["bk"] = ParamSpec((K, hd), "zeros", dt)
        specs["bv"] = ParamSpec((K, hd), "zeros", dt)
    return specs


def _mlp_specs(cfg: ModelConfig) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    out_std = 1.0 / np.sqrt(f) / np.sqrt(2.0 * cfg.n_layers)
    return {
        "wg": ParamSpec((d, f), 1 / np.sqrt(d), dt),
        "wu": ParamSpec((d, f), 1 / np.sqrt(d), dt),
        "wd": ParamSpec((f, d), out_std, dt),
    }


def _norm(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), "ones", torch.float32)


def _sublayer_specs(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    if mixer != "attn" or ffn not in ("mlp", "none"):
        raise NotImplementedError(f"{cfg.name}: sub-layer ({mixer}, {ffn}) not ported yet "
                                  "(ROADMAP queue 1 item 13)")
    specs = {"norm1": _norm(cfg), "mixer": _attn_specs(cfg)}
    if ffn != "none":
        specs["norm2"] = _norm(cfg)
        specs["ffn"] = _mlp_specs(cfg)
    return specs


def model_specs(cfg: ModelConfig) -> dict:
    """The spec tree: embed, one entry per layer under ``blocks``,
    final_norm, lm_head."""
    check_buildable(cfg)
    kinds = cfg.sublayer_kinds()
    d, V = cfg.d_model, cfg.vocab
    return {
        "embed": ParamSpec((V, d), 0.02, cfg.dtype),
        "blocks": [_sublayer_specs(cfg, *kinds[i % len(kinds)]) for i in range(cfg.n_layers)],
        "final_norm": _norm(cfg),
        "lm_head": ParamSpec((d, V), 1 / np.sqrt(d), cfg.dtype),
    }


class ParamNode(nn.Module):
    """One dict of the parameter tree: its keys are attributes, each a
    parameter, a ``ParamNode`` or an ``nn.ModuleList``."""


def materialize(specs, leaf: Callable[[tuple, ParamSpec], torch.Tensor], path=(),
                trainable: bool = False) -> nn.Module:
    """Build the module tree of ``specs``; ``leaf(path, spec)`` gives each
    parameter's tensor (``path`` is the tuple of keys and list indices).
    The parameters require grad when ``trainable``."""
    if isinstance(specs, list):
        return nn.ModuleList([materialize(s, leaf, path + (i,), trainable)
                              for i, s in enumerate(specs)])
    node = ParamNode()
    for key, spec in specs.items():
        if isinstance(spec, ParamSpec):
            t = leaf(path + (key,), spec)
            if tuple(t.shape) != spec.shape or t.dtype != spec.dtype:
                raise ValueError(f"{'/'.join(map(str, path + (key,)))}: want {spec.shape} "
                                 f"{spec.dtype}, got {tuple(t.shape)} {t.dtype}")
            node.register_parameter(key, nn.Parameter(t, requires_grad=trainable))
        else:
            node.add_module(key, materialize(spec, leaf, path + (key,), trainable))
    return node


def param_tree(params: nn.Module):
    """The parameters of a module built by ``materialize`` as a tree of
    dicts (a ``ParamNode``'s keys) and lists (a ``ModuleList``) whose
    leaves are the module's own ``nn.Parameter``s, not copies."""
    if isinstance(params, nn.ModuleList):
        return [param_tree(m) for m in params]
    tree = dict(params.named_parameters(recurse=False))
    tree.update((key, param_tree(m)) for key, m in params.named_children())
    return tree


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                trainable: bool = False) -> nn.Module:
    """Seeded parameters on ``device``: ``normal * std``, zeros or ones as
    the specs say, drawn in fp32 from a ``torch.Generator`` on that
    device seeded with ``seed`` and cast to the spec's dtype; frozen for
    serving, requiring grad when ``trainable``. The draws
    are not the reference's (``jax.random`` differs); carry reference
    parameters across with ``convert.lm_params_from_arrays``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def leaf(_path, spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
        draw = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=dev)
        return draw.mul_(float(spec.init)).to(spec.dtype)

    return materialize(model_specs(cfg), leaf, trainable=trainable)
