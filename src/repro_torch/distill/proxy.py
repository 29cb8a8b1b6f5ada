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
  scenario    per-scenario sampler: redraw fresh unlabeled features
              from a registered ``repro_torch.sim`` scenario generator
              with a derived seed (params: scenario, n_devices,
              mean_samples, dim + the scenario's own params)

Materialised rounds hand a source every device outcome; the streamed
population round hands it the lazy ``split_counts`` / ``fetch_split``
pair instead (``ProxyContext``), and the pool sources draw the same
rows from it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ProxyContext:
    """Everything a proxy source may draw on.

    Materialized rounds hand the source ``devices`` (every outcome in
    memory). Streamed rounds instead hand it the LAZY pair:
    ``split_counts[split]`` — per-device row counts in device order, a
    few bytes per device — and ``fetch_split(split, positions)``, which
    regenerates just the named devices' feature rows. Pool-subsampling
    sources draw the same subsample indices either way, then fetch only
    the devices those indices land in.
    """

    n: int                                  # requested proxy size
    rng: np.random.Generator                # the distillation stream
    devices: Optional[Sequence] = None      # DeviceOutcomes (sim/protocol)
    dim: Optional[int] = None               # feature dim, if no devices
    params: Mapping = dataclasses.field(default_factory=dict)
    # streamed-population hooks (see class docstring)
    split_counts: Optional[Mapping[str, np.ndarray]] = None
    fetch_split: Optional[Callable[[str, Sequence[int]], Mapping[int, np.ndarray]]] = None

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


def list_proxies() -> Dict[str, str]:
    """name -> first docstring line, for --help style listings."""
    return {
        name: ((fn.__doc__ or "").strip().splitlines() or ["(undocumented)"])[0]
        for name, fn in sorted(PROXIES.items())
    }


def make_proxy(
    name: str,
    *,
    n: int,
    rng: np.random.Generator,
    devices: Optional[Sequence] = None,
    dim: Optional[int] = None,
    split_counts: Optional[Mapping[str, np.ndarray]] = None,
    fetch_split: Optional[Callable[[str, Sequence[int]], Mapping[int, np.ndarray]]] = None,
    **params,
) -> np.ndarray:
    if name not in PROXIES:
        raise KeyError(f"unknown proxy source {name!r}; options {sorted(PROXIES)}")
    ctx = ProxyContext(n=n, rng=rng, devices=devices, dim=dim, params=params,
                       split_counts=split_counts, fetch_split=fetch_split)
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


def _lazy_pool_subsample(ctx: ProxyContext, split: str) -> np.ndarray:
    """The streamed twin of ``_subsample(_pooled(...))``: draw the SAME
    subsample indices over the virtual concatenated pool (identical rng
    consumption), locate them with a cumulative-count searchsorted, and
    fetch only the devices they land in. Bitwise-equal to the
    materialized path (tests/test_stream.py pins it)."""
    counts = np.asarray(ctx.split_counts[split], np.int64)
    cum = np.concatenate([np.zeros(1, np.int64), np.cumsum(counts)])
    total = int(cum[-1])
    if total == 0:
        raise ValueError(f"proxy pool for split {split!r} is empty")
    if total > ctx.n:
        idx = ctx.rng.choice(total, ctx.n, replace=False)
    else:
        idx = np.arange(total)
    pos = np.searchsorted(cum, idx, side="right") - 1   # device position
    row = idx - cum[pos]                                # row within device
    uniq = [int(p) for p in np.unique(pos)]
    fetched = ctx.fetch_split(split, uniq)
    out = np.empty((len(idx), fetched[uniq[0]].shape[1]), np.float32)
    for p in uniq:
        m = pos == p
        out[m] = fetched[p][row[m]]
    return out


# ----------------------------------------------------------------------
# registered sources
# ----------------------------------------------------------------------

@register_proxy("validation")
def validation_pool(ctx: ProxyContext) -> np.ndarray:
    """Paper protocol: unlabeled features pooled from device validation
    splits (only features are used — labels never leave devices)."""
    if ctx.devices is None and ctx.fetch_split is not None:
        return _lazy_pool_subsample(ctx, "val")
    return _subsample(_pooled(ctx.devices, "val"), ctx.n, ctx.rng)


@register_proxy("public")
def public_pool(ctx: ProxyContext) -> np.ndarray:
    """Server-held public pool: seeded subsample of pooled train
    features — a stand-in for a public unlabeled corpus drawn from the
    same population distribution."""
    if ctx.devices is None and ctx.fetch_split is not None:
        return _lazy_pool_subsample(ctx, "train")
    return _subsample(_pooled(ctx.devices, "train"), ctx.n, ctx.rng)


@register_proxy("gaussian")
def gaussian_mixture(ctx: ProxyContext) -> np.ndarray:
    """Gaussian-mixture synthetic proxy: one component per device (mean
    = device validation-feature mean) with a shared diagonal covariance
    from the pooled validation features; the server needs only moments,
    never raw device rows."""
    if ctx.devices is None and ctx.fetch_split is not None:
        raise ValueError(
            "gaussian proxy needs per-device moments over the whole "
            "population and cannot run from a stream; use the "
            "validation/public/scenario sources with engine='streamed'"
        )
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
    """Per-scenario sampler: redraw fresh unlabeled features from a
    registered sim scenario's generative process under a derived seed
    (params: scenario, plus the scenario's own params)."""
    from repro_torch.sim.scenarios import make_federation  # deferred: sim <-> distill

    name = str(ctx.param("scenario", ""))
    if not name:
        raise ValueError("scenario proxy needs params['scenario']")
    passthrough = {
        k: v for k, v in ctx.params.items()
        if k not in ("scenario", "n_devices", "mean_samples", "dim")
    }
    mean_samples = int(ctx.param("mean_samples", 80))
    n_devices = int(ctx.param("n_devices", max(-(-ctx.n // mean_samples), 2)))
    fed = make_federation(
        name,
        n_devices=n_devices,
        seed=int(ctx.rng.integers(0, 2**31 - 1)),
        mean_samples=mean_samples,
        dim=int(ctx.param("dim", ctx.dim or 16)),
        **passthrough,
    )
    xs = np.concatenate([dev.x for dev in fed.dataset.devices])
    return _subsample(xs, ctx.n, ctx.rng)
