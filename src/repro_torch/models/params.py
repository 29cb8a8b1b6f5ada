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
and loops over them. So each spec's logical axes (``logical_axes``, the
names ``sharding.rules`` maps onto a mesh) are the reference's without
its leading ``"layers"`` entry, which maps to no mesh axis.
``abstract_params`` gives the tree as ``meta`` tensors of the specs'
shapes and dtypes, which allocate nothing (the dry-run's parameters).

Serving builds frozen parameters (``requires_grad=False``); training
builds them with ``trainable=True`` and reads them as a tree through
``param_tree``, the form the optimizers (``repro_torch.optim``) take.
Every family of the reference builds: every (mixer, ffn) sub-layer of
``("attn" | "mamba") x ("mlp" | "moe" | "none")``; the VLM's layers are
the dense family's (its patch prefix has no parameters here: the vision
frontend is a stub that hands the model projected patch embeddings), and
the audio family's decoder layers add ``norm_x`` and the cross-attention
``xattn``, with the encoder's ``pos``, one ``(attn, mlp)`` sub-layer per
encoder layer under ``blocks`` and its final ``norm`` in ``encoder``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.utils.device import resolve_device

_PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# a normal leaf is drawn in blocks of at most this many fp32 bytes along
# its first axis (jamba's (16, 8192, 24576) experts: 12.9 GB in one draw)
_DRAW_BLOCK_BYTES = 1 << 31


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # a logical axis name per dim (sharding.rules)
    init: Any  # float std | "zeros" | "ones" | "a_log" | "dt_bias"
    dtype: torch.dtype


def check_buildable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the reference does not have."""
    if cfg.family not in _PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def _attn_specs(cfg: ModelConfig) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    out_std = 1.0 / np.sqrt(H * hd) / np.sqrt(2.0 * cfg.n_layers)
    specs = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim"), 1 / np.sqrt(d), dt),
        "wk": ParamSpec((d, K, hd), ("embed", "kv_heads", "head_dim"), 1 / np.sqrt(d), dt),
        "wv": ParamSpec((d, K, hd), ("embed", "kv_heads", "head_dim"), 1 / np.sqrt(d), dt),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed"), out_std, dt),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), "zeros", dt)
        specs["bk"] = ParamSpec((K, hd), ("kv_heads", "head_dim"), "zeros", dt)
        specs["bv"] = ParamSpec((K, hd), ("kv_heads", "head_dim"), "zeros", dt)
    return specs


def _mlp_specs(cfg: ModelConfig) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    out_std = 1.0 / np.sqrt(f) / np.sqrt(2.0 * cfg.n_layers)
    return {
        "wg": ParamSpec((d, f), ("embed", "mlp"), 1 / np.sqrt(d), dt),
        "wu": ParamSpec((d, f), ("embed", "mlp"), 1 / np.sqrt(d), dt),
        "wd": ParamSpec((f, d), ("mlp", "embed"), out_std, dt),
    }


def _moe_specs(cfg: ModelConfig) -> dict:
    d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.dtype
    out_std = 1.0 / np.sqrt(f) / np.sqrt(2.0 * cfg.n_layers)
    return {
        "router": ParamSpec((d, E), ("embed", "experts"), 1 / np.sqrt(d), torch.float32),
        "wg": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"), 1 / np.sqrt(d), dt),
        "wu": ParamSpec((E, d, f), ("experts", "embed", "expert_mlp"), 1 / np.sqrt(d), dt),
        "wd": ParamSpec((E, f, d), ("experts", "expert_mlp", "embed"), out_std, dt),
    }


def _mamba_specs(cfg: ModelConfig) -> dict:
    """Mamba2 block: in_proj -> [z | xBC | dt], depthwise conv on xBC,
    SSD mixer, gated RMSNorm, out_proj. One B/C group."""
    d, dt = cfg.d_model, cfg.dtype
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    conv_dim = di + 2 * N
    out_std = 1.0 / np.sqrt(di) / np.sqrt(2.0 * cfg.n_layers)
    return {
        "in_z": ParamSpec((d, di), ("embed", "ssm_inner"), 1 / np.sqrt(d), dt),
        "in_x": ParamSpec((d, di), ("embed", "ssm_inner"), 1 / np.sqrt(d), dt),
        "in_b": ParamSpec((d, N), ("embed", "ssm_state"), 1 / np.sqrt(d), dt),
        "in_c": ParamSpec((d, N), ("embed", "ssm_state"), 1 / np.sqrt(d), dt),
        "in_dt": ParamSpec((d, H), ("embed", "ssm_heads"), 1 / np.sqrt(d), dt),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), ("conv", "ssm_inner"),
                            1 / np.sqrt(cfg.ssm_conv), dt),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), "zeros", dt),
        "a_log": ParamSpec((H,), ("ssm_heads",), "a_log", torch.float32),
        "d_skip": ParamSpec((H,), ("ssm_heads",), "ones", torch.float32),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), "dt_bias", torch.float32),
        "norm": ParamSpec((di,), ("ssm_inner",), "ones", torch.float32),
        "out": ParamSpec((di, d), ("ssm_inner", "embed"), out_std, dt),
    }


def _norm(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), ("norm",), "ones", torch.float32)


def _sublayer_specs(cfg: ModelConfig, mixer: str, ffn: str, cross: bool = False) -> dict:
    if mixer not in ("attn", "mamba") or ffn not in ("mlp", "moe", "none"):
        raise ValueError(f"{cfg.name}: unknown sub-layer ({mixer}, {ffn})")
    specs = {"norm1": _norm(cfg),
             "mixer": _attn_specs(cfg) if mixer == "attn" else _mamba_specs(cfg)}
    if cross:   # the encoder-decoder's cross-attention
        specs["norm_x"] = _norm(cfg)
        specs["xattn"] = _attn_specs(cfg)
    if ffn != "none":
        specs["norm2"] = _norm(cfg)
        specs["ffn"] = _moe_specs(cfg) if ffn == "moe" else _mlp_specs(cfg)
    return specs


def model_specs(cfg: ModelConfig) -> dict:
    """The spec tree: embed, one entry per layer under ``blocks``,
    final_norm, lm_head, and for an encoder-decoder the ``encoder``
    (``pos``, one entry per encoder layer under ``blocks``, ``norm``)."""
    check_buildable(cfg)
    kinds = cfg.sublayer_kinds()
    d, V = cfg.d_model, cfg.vocab
    cross = cfg.is_encdec
    specs = {
        # "vocab_in", not "vocab": the input table can be replicated
        # apart from the lm_head (the dry-run's --replicate-embed)
        "embed": ParamSpec((V, d), ("vocab_in", "embed"), 0.02, cfg.dtype),
        "blocks": [_sublayer_specs(cfg, *kinds[i % len(kinds)], cross=cross)
                   for i in range(cfg.n_layers)],
        "final_norm": _norm(cfg),
        "lm_head": ParamSpec((d, V), ("embed", "vocab"), 1 / np.sqrt(d), cfg.dtype),
    }
    if cross:
        specs["encoder"] = {
            "pos": ParamSpec((cfg.encoder_seq, d), ("seq", "embed"), 0.02, cfg.dtype),
            "blocks": [_sublayer_specs(cfg, "attn", "mlp") for _ in range(cfg.encoder_layers)],
            "norm": _norm(cfg),
        }
    return specs


def _map_specs(fn, specs):
    if isinstance(specs, list):
        return [_map_specs(fn, s) for s in specs]
    if isinstance(specs, dict):
        return {key: _map_specs(fn, s) for key, s in specs.items()}
    return fn(specs)


def logical_axes(cfg: ModelConfig):
    """The spec tree with each leaf's logical axis tuple."""
    return _map_specs(lambda s: s.logical, model_specs(cfg))


def abstract_params(cfg: ModelConfig):
    """The spec tree with each leaf a ``meta`` tensor of its shape and
    dtype: no storage, so a full-size model costs nothing."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                      model_specs(cfg))


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


def _put(module: nn.Module, tree) -> None:
    if isinstance(module, nn.ModuleList):
        for m, sub in zip(module, tree):
            _put(m, sub)
        return
    for key, sub in tree.items():
        if isinstance(sub, (dict, list)):
            _put(getattr(module, key), sub)
        else:
            module._parameters[key] = nn.Parameter(sub, requires_grad=sub.requires_grad)


def distribute_params(params: nn.Module, cfg: ModelConfig, mesh, rules) -> nn.Module:
    """``params`` with each parameter replaced, in place, by a ``DTensor``
    parameter on the LM mesh, placed by its logical axes
    (``sharding.rules.distribute``: each rank keeps its own shard of the
    tensor it holds whole). Returns ``params``."""
    from repro_torch.sharding.rules import distribute

    _put(params, distribute(param_tree(params), mesh, logical_axes(cfg), rules))
    return params


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                trainable: bool = False) -> nn.Module:
    """Seeded parameters on ``device``: ``normal * std``, zeros or ones as
    the specs say, drawn in fp32 from a ``torch.Generator`` on that
    device seeded with ``seed`` and cast to the spec's dtype (in blocks of
    at most 2 GiB of fp32 along its first axis, so the fp32 copy of
    jamba's experts never exists whole); Mamba's ``a_log`` is
    log U(1, 16) and ``dt_bias`` log(expm1(U(1e-3, 1e-1))), the
    reference's inits. Frozen for serving, requiring grad when
    ``trainable``. The draws are not the reference's (``jax.random``
    differs); carry reference parameters across with
    ``convert.lm_params_from_arrays``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
        return u.mul_(hi - lo).add_(lo)

    def leaf(_path, spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
        if spec.init == "a_log":
            return uniform(spec.shape, 1.0, 16.0).log_().to(spec.dtype)
        if spec.init == "dt_bias":
            return uniform(spec.shape, 1e-3, 1e-1).expm1_().log_().to(spec.dtype)
        std = float(spec.init)
        out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
        rows = max(1, _DRAW_BLOCK_BYTES // (4 * math.prod(spec.shape[1:])))
        for lo in range(0, spec.shape[0], rows):
            block = out[lo:lo + rows]
            draw = torch.randn(block.shape, generator=gen, dtype=torch.float32, device=dev)
            block.copy_(draw.mul_(std))
        return out

    return materialize(model_specs(cfg), leaf, trainable=trainable)
