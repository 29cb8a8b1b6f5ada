"""Proxy-data registry: named, seedable sources of unlabeled features.

Port of ``repro.distill.proxy`` (numpy only, so every source draws
bit-identically to the reference's from the same generator). A source
is a registered function from a ``ProxyContext`` to an ``(n, d)`` float32
feature array; all randomness flows from the context's generator, which
the protocol derives from its own distillation stream
(``solvers.distill_rng``).

Registered sources:

  validation  pooled device validation features (the paper's protocol)
  public      seeded subsample of pooled device TRAIN features, a
              stand-in for a public unlabeled corpus
  gaussian    Gaussian mixture: one component per device (mean = the
              device's validation-feature mean), shared diagonal
              covariance from the pooled validation features
  scenario    not ported yet: it redraws from ``sim/scenarios.py``
              (ROADMAP queue 1 item 9)

The streamed population's lazy ``split_counts`` / ``fetch_split`` hooks
wait for the streamed tier (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ProxyContext:
    """Everything a proxy source may draw on."""

    n: int                                  # requested proxy size
    rng: np.random.Generator                # the distillation stream
    devices: Optional[Sequence] = None      # DeviceOutcomes (protocol)
    dim: Optional[int] = None               # feature dim, if no devices
    params: Mapping = dataclasses.field(default_factory=dict)

    def param(self, key: str, default):
        return self.params.get(key, default)


ProxyFn = Callable[[ProxyContext], np.ndarray]
PROXIES: Dict[str, ProxyFn] = {}


def register_proxy(name: str) -> Callable[[ProxyFn], ProxyFn]:
    def deco(fn: ProxyFn) -> ProxyFn:
        if name in PROXIES:
            raise ValueError(f"proxy source {name!r} already registered")
        PROXIES[name] = fn
        return fn
    return deco


def make_proxy(
    name: str,
    *,
    n: int,
    rng: np.random.Generator,
    devices: Optional[Sequence] = None,
    dim: Optional[int] = None,
    **params,
) -> np.ndarray:
    if name not in PROXIES:
        raise KeyError(f"unknown proxy source {name!r}; options {sorted(PROXIES)}")
    ctx = ProxyContext(n=n, rng=rng, devices=devices, dim=dim, params=params)
    out = np.asarray(PROXIES[name](ctx), np.float32)
    if out.ndim != 2:
        raise ValueError(f"proxy source {name!r} returned shape {out.shape}")
    return out


def _subsample(xs: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    if len(xs) > n:
        xs = xs[rng.choice(len(xs), n, replace=False)]
    return xs


def _pooled(devices: Sequence, split: str) -> np.ndarray:
    if not devices:
        raise ValueError("proxy source needs device outcomes")
    return np.concatenate([d.splits[split].x for d in devices])


@register_proxy("validation")
def validation_pool(ctx: ProxyContext) -> np.ndarray:
    """Paper protocol: unlabeled features pooled from device validation
    splits (only features are used — labels never leave devices)."""
    return _subsample(_pooled(ctx.devices, "val"), ctx.n, ctx.rng)


@register_proxy("public")
def public_pool(ctx: ProxyContext) -> np.ndarray:
    """Server-held public pool: seeded subsample of pooled train
    features — a stand-in for a public unlabeled corpus drawn from the
    same population distribution."""
    return _subsample(_pooled(ctx.devices, "train"), ctx.n, ctx.rng)


@register_proxy("gaussian")
def gaussian_mixture(ctx: ProxyContext) -> np.ndarray:
    """Gaussian-mixture synthetic proxy: one component per device (mean
    = device validation-feature mean) with a shared diagonal covariance
    from the pooled validation features; the server needs only moments,
    never raw device rows."""
    if not ctx.devices:
        raise ValueError("gaussian proxy needs device outcomes")
    means = np.stack([
        d.splits["val"].x.mean(axis=0) for d in ctx.devices if d.splits["val"].n > 0
    ])
    pooled = _pooled(ctx.devices, "val")
    std = pooled.std(axis=0) + 1e-6
    comp = ctx.rng.integers(0, len(means), size=ctx.n)
    noise = ctx.rng.normal(0.0, 1.0, size=(ctx.n, pooled.shape[1]))
    return (means[comp] + std[None, :] * noise).astype(np.float32)


@register_proxy("scenario")
def scenario_resample(ctx: ProxyContext) -> np.ndarray:
    """Per-scenario sampler: not ported yet (it needs ``sim/scenarios.py``)."""
    raise NotImplementedError(
        "proxy source 'scenario' is not ported yet (ROADMAP queue 1 item 9: "
        "it redraws from sim/scenarios.py)")
