"""Scenario registry: named, seedable federation STREAMS.

Conclusions about one-shot selection/ensembling flip under population
size, heterogeneity regime, and client availability (Amato et al.,
2505.02426; Allouah et al., 2411.07182) — so the simulation engine
treats the federation itself as a first-class, sweepable axis. A
scenario is a registered function from a `ScenarioSpec` to a
`DeviceStream`: device *i* is generated ON DEMAND from its own
`derive_device_seed(spec.seed, i)` substream, never from a
population-length array, so

  * peak host memory to describe a federation is O(1) in population
    size — a 10^6-device federation is a spec, not an allocation;
  * device *i* is bitwise-identical whether the federation is streamed
    in chunks, resumed mid-population, or fully materialized
    (`DeviceStream.materialize()` IS the `Federation` constructor, so
    the equality is structural, not coincidental — pinned by
    tests/test_stream.py);
  * device *i*'s data is independent of `n_devices`: growing the
    population appends devices without disturbing existing ones.

Registered scenarios (each a distinct heterogeneity mechanism):

  iid             every device samples the shared concept uniformly
  dirichlet       per-device Dirichlet label skew (param: alpha)
  quantity_skew   long-tailed lognormal device sizes (param: sigma)
  feature_shift   per-device affine covariate shift (params: shift,
                  scale_jitter)
  temporal_drift  concept means drift across the device index — late
                  devices see a moved distribution (param: drift)
  availability    wraps any base scenario with a lazy participation
                  mask + straggler dropout derived per-device from a
                  `ChannelStream` (params: base, fraction,
                  straggler_frac)

All randomness flows from `spec.seed`; two specs with equal fields
produce identical federations. Register new scenarios with
`@register_scenario("name")` — the population runner and the
``scenario`` proxy source pick them up by name.

Port of ``repro.sim.scenarios``, copied line for line: every sampler is
host numpy drawn in the reference's order, so device i of a port
federation is device i of the reference's, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np

from repro_torch.comm.channel import ChannelModel, ChannelStream, make_channel_stream
from repro_torch.data.federated import DeviceData, FederatedDataset
from repro_torch.utils.seeds import derive_device_seed, stream_rng


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A fully seedable description of one simulated federation."""

    name: str
    n_devices: int = 64
    mean_samples: int = 80      # mean local dataset size
    dim: int = 16
    seed: int = 0
    min_samples: int = 40       # ensemble-eligibility threshold
    params: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def param(self, key: str, default):
        return self.params.get(key, default)


@dataclasses.dataclass
class DeviceStream:
    """A federation as a function of the device index.

    `gen(i)` regenerates device *i* from scratch on every call (pure in
    *i* given the spec) — the stream holds no per-device state, so peak
    memory is whatever the CALLER retains. `available_fn(i)` is the
    lazy participation mask (None means everyone participates);
    `channel`, when present, prices device uploads in seconds.
    """

    spec: ScenarioSpec
    gen: Callable[[int], DeviceData]
    available_fn: Optional[Callable[[int], bool]] = None
    channel: Optional[ChannelStream] = None

    @property
    def n_devices(self) -> int:
        return self.spec.n_devices

    @property
    def min_samples(self) -> int:
        return self.spec.min_samples

    @property
    def dim(self) -> int:
        return self.spec.dim

    def device(self, device_id: int) -> DeviceData:
        if not 0 <= device_id < self.n_devices:
            raise IndexError(
                f"device {device_id} outside population of {self.n_devices}"
            )
        return self.gen(device_id)

    def available(self, device_id: int) -> bool:
        return self.available_fn is None or bool(self.available_fn(device_id))

    def count_available(self) -> int:
        """Participant headcount by scanning the lazy mask — O(1) memory
        (instant when there is no mask)."""
        if self.available_fn is None:
            return self.n_devices
        return sum(1 for i in range(self.n_devices) if self.available_fn(i))

    def materialize(self) -> "Federation":
        """Realize the whole population as arrays. This is THE
        `Federation` constructor — every materialized device is the
        same `gen(i)` call a streaming consumer would make, so
        streamed == materialized holds bitwise by construction."""
        devices = [self.gen(i) for i in range(self.n_devices)]
        available = np.fromiter(
            (self.available(i) for i in range(self.n_devices)),
            dtype=bool, count=self.n_devices,
        )
        channel = (self.channel.materialize(self.n_devices)
                   if self.channel is not None else None)
        return Federation(
            dataset=FederatedDataset(
                name=f"sim:{self.spec.name}", devices=devices,
                min_samples=self.spec.min_samples, dim=self.spec.dim,
            ),
            available=available, spec=self.spec, channel=channel,
        )


@dataclasses.dataclass
class Federation:
    """A fully materialized federation: data + who shows up + (for
    channel-aware scenarios) how fast their uplinks are."""

    dataset: FederatedDataset
    available: np.ndarray  # (n_devices,) bool participation mask
    spec: ScenarioSpec
    channel: Optional[ChannelModel] = None  # prices uploads in seconds

    @property
    def n_available(self) -> int:
        return int(self.available.sum())


ScenarioFn = Callable[[ScenarioSpec], DeviceStream]
SCENARIOS: Dict[str, ScenarioFn] = {}


def register_scenario(name: str) -> Callable[[ScenarioFn], ScenarioFn]:
    def deco(fn: ScenarioFn) -> ScenarioFn:
        if name in SCENARIOS:
            raise ValueError(f"scenario {name!r} already registered")
        SCENARIOS[name] = fn
        return fn
    return deco


def list_scenarios() -> Dict[str, str]:
    """name -> first docstring line, for --help style listings."""
    return {
        name: ((fn.__doc__ or "").strip().splitlines() or ["(undocumented)"])[0]
        for name, fn in sorted(SCENARIOS.items())
    }


def _spec(name, n_devices, seed, mean_samples, dim, min_samples, params):
    return ScenarioSpec(
        name=name, n_devices=n_devices, mean_samples=mean_samples, dim=dim,
        seed=seed, min_samples=min_samples, params=params,
    )


def device_stream(
    name: str,
    n_devices: int = 64,
    seed: int = 0,
    mean_samples: int = 80,
    dim: int = 16,
    min_samples: int = 40,
    **params,
) -> DeviceStream:
    """The lazy federation: devices on demand, O(1) host memory."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; options: {sorted(SCENARIOS)}")
    return SCENARIOS[name](
        _spec(name, n_devices, seed, mean_samples, dim, min_samples, params)
    )


def make_federation(
    name: str,
    n_devices: int = 64,
    seed: int = 0,
    mean_samples: int = 80,
    dim: int = 16,
    min_samples: int = 40,
    **params,
) -> Federation:
    """The materialized federation: `device_stream(...).materialize()`."""
    return device_stream(
        name, n_devices=n_devices, seed=seed, mean_samples=mean_samples,
        dim=dim, min_samples=min_samples, **params,
    ).materialize()


# ----------------------------------------------------------------------
# shared concept + vectorized per-device sampler
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Concept:
    """The population-shared two-class Gaussian mixture, as arrays
    indexable by (class, cluster) for vectorized sampling."""

    means: np.ndarray   # (2, n_clusters, dim); row 0 = +1, row 1 = -1
    scales: np.ndarray  # (2, n_clusters)

    @property
    def n_clusters(self) -> int:
        return self.means.shape[1]


def _concept_arrays(rng, dim, n_clusters=4, sep=2.2) -> _Concept:
    """Same mixture family as ``data.federated._gaussian_concept`` —
    separated anisotropic clusters per class — but returned as stacked
    arrays so per-device sampling vectorizes."""
    off = sep / np.sqrt(dim)
    pos_means = rng.normal(0, 1, size=(n_clusters, dim)) + off
    neg_means = rng.normal(0, 1, size=(n_clusters, dim)) - off
    pos_scales = 0.6 + 0.8 * rng.random(n_clusters)
    neg_scales = 0.6 + 0.8 * rng.random(n_clusters)
    return _Concept(
        means=np.stack([pos_means, neg_means]),
        scales=np.stack([pos_scales, neg_scales]),
    )


def _sample_concept(concept, drng, n, pos_frac, offset, noise):
    """Draw one device's local dataset in a handful of array ops (the
    per-sample Python loop in ``_gaussian_concept`` is fine for
    thousands of devices; streaming to 10^6 needs this)."""
    y = np.where(drng.random(n) < pos_frac, 1.0, -1.0)
    k = drng.integers(concept.n_clusters, size=n)
    cls = (y < 0).astype(np.intp)  # 0 = +1 clusters, 1 = -1 clusters
    x = concept.means[cls, k] + concept.scales[cls, k, None] * drng.normal(
        0, 1, size=(n, concept.means.shape[-1])
    )
    x = (x + offset).astype(np.float32)
    flip = drng.random(n) < noise
    y = np.where(flip, -y, y).astype(np.float32)
    return x, y


def _device_rng(spec: ScenarioSpec, device_id: int):
    return np.random.default_rng(derive_device_seed(spec.seed, device_id))


def _stream(spec, gen, available_fn=None, channel=None) -> DeviceStream:
    return DeviceStream(spec=spec, gen=gen, available_fn=available_fn,
                        channel=channel)


# ----------------------------------------------------------------------
# registered scenarios
# ----------------------------------------------------------------------

@register_scenario("iid")
def iid(spec: ScenarioSpec) -> DeviceStream:
    """IID control: every device samples the shared concept uniformly."""
    concept = _concept_arrays(np.random.default_rng(spec.seed), spec.dim)
    zero = np.zeros(spec.dim, np.float32)

    def gen(i: int) -> DeviceData:
        x, y = _sample_concept(concept, _device_rng(spec, i),
                               spec.mean_samples, 0.5, zero, noise=0.04)
        return DeviceData(x=x, y=y)

    return _stream(spec, gen)


@register_scenario("dirichlet")
def dirichlet(spec: ScenarioSpec) -> DeviceStream:
    """Label skew: per-device Dirichlet label mix (alpha, default 0.3).

    Each device draws its positive-class share from Beta(alpha, alpha)
    — the two-class Dirichlet marginal — so small alpha concentrates
    devices near single-label extremes while device *i*'s mix never
    depends on the rest of the population."""
    concept = _concept_arrays(np.random.default_rng(spec.seed), spec.dim)
    alpha = float(spec.param("alpha", 0.3))
    zero = np.zeros(spec.dim, np.float32)

    def gen(i: int) -> DeviceData:
        drng = _device_rng(spec, i)
        pos_frac = float(drng.beta(alpha, alpha))
        x, y = _sample_concept(concept, drng, spec.mean_samples,
                               pos_frac, zero, noise=0.04)
        return DeviceData(x=x, y=y)

    return _stream(spec, gen)


@register_scenario("quantity_skew")
def quantity_skew(spec: ScenarioSpec) -> DeviceStream:
    """Quantity skew: long-tailed lognormal device sizes, IID content
    (sigma, default 1.2, controls the tail).

    Sizes are drawn per device and normalized analytically (the
    lognormal mean correction exp(-sigma^2/2) keeps the EXPECTED size
    at mean_samples) rather than by dividing through the population's
    realized total — so device *i*'s size is independent of every
    other device, a streaming requirement."""
    concept = _concept_arrays(np.random.default_rng(spec.seed), spec.dim)
    sigma = float(spec.param("sigma", 1.2))
    mean_norm = float(np.exp(-0.5 * sigma * sigma))
    zero = np.zeros(spec.dim, np.float32)

    def gen(i: int) -> DeviceData:
        drng = _device_rng(spec, i)
        n = max(int(round(drng.lognormal(mean=0.0, sigma=sigma)
                          * spec.mean_samples * mean_norm)), 4)
        x, y = _sample_concept(concept, drng, n, 0.5, zero, noise=0.04)
        return DeviceData(x=x, y=y)

    return _stream(spec, gen)


@register_scenario("feature_shift")
def feature_shift(spec: ScenarioSpec) -> DeviceStream:
    """Covariate shift: per-device affine transform of IID features
    (shift, default 1.0; scale_jitter, default 0.3)."""
    concept = _concept_arrays(np.random.default_rng(spec.seed), spec.dim)
    shift = float(spec.param("shift", 1.0))
    jitter = float(spec.param("scale_jitter", 0.3))
    zero = np.zeros(spec.dim, np.float32)

    def gen(i: int) -> DeviceData:
        drng = _device_rng(spec, i)
        offset = shift * drng.normal(0, 1, spec.dim).astype(np.float32)
        scale = (1.0 + jitter * drng.uniform(-1, 1, spec.dim)).astype(np.float32)
        x, y = _sample_concept(concept, drng, spec.mean_samples,
                               0.5, zero, noise=0.04)
        return DeviceData(x=x * scale + offset, y=y)

    return _stream(spec, gen)


@register_scenario("temporal_drift")
def temporal_drift(spec: ScenarioSpec) -> DeviceStream:
    """Concept drift: device t's class means move drift * t/(m-1) along
    a fixed direction — late joiners see a shifted world (drift,
    default 2.0)."""
    drift = float(spec.param("drift", 2.0))
    rng = np.random.default_rng(spec.seed)
    concept = _concept_arrays(rng, spec.dim)
    direction = rng.normal(0, 1, spec.dim).astype(np.float32)
    direction /= np.linalg.norm(direction)
    denom = max(spec.n_devices - 1, 1)

    def gen(t: int) -> DeviceData:
        offset = (drift * t / denom) * direction
        x, y = _sample_concept(concept, _device_rng(spec, t),
                               spec.mean_samples, 0.5, offset, noise=0.04)
        return DeviceData(x=x, y=y)

    return _stream(spec, gen)


@register_scenario("availability")
def availability(spec: ScenarioSpec) -> DeviceStream:
    """Client availability: wraps a base scenario (base, default
    'dirichlet') with a physical uplink channel — Bernoulli drops
    (fraction, default 0.7, is the share NOT dropped) plus stragglers
    (straggler_frac, default 0.1): the slowest devices, whose upload of
    a nominal fp32 payload misses the round deadline. Membership and
    round latency come from the same lazy ``repro_torch.comm.ChannelStream``
    — device *i*'s drop/straggler fate derives from its own device
    seed, with no population-length mask array — so a one-shot round
    here costs time-to-aggregate, not just headcount (mean_bandwidth,
    default 128 KiB/s; bandwidth_sigma, default 1.0)."""
    base_name = str(spec.param("base", "dirichlet"))
    if base_name == "availability":
        raise ValueError("availability cannot wrap itself")
    fraction = float(spec.param("fraction", 0.7))
    straggler = float(spec.param("straggler_frac", 0.1))
    base_params = {
        k: v for k, v in spec.params.items()
        if k not in ("base", "fraction", "straggler_frac",
                     "mean_bandwidth", "bandwidth_sigma")
    }
    base = device_stream(
        base_name, n_devices=spec.n_devices, seed=spec.seed,
        mean_samples=spec.mean_samples, dim=spec.dim,
        min_samples=spec.min_samples, **base_params,
    )
    # a nominal fp32 upload (mean-sized device) calibrates the deadline
    nominal_bytes = spec.mean_samples * spec.dim * 4
    channel = make_channel_stream(
        seed=spec.seed + 2,
        mean_bandwidth=float(spec.param("mean_bandwidth", 128 * 1024.0)),
        sigma=float(spec.param("bandwidth_sigma", 1.0)),
        drop_frac=1.0 - fraction,
        nominal_bytes=nominal_bytes, straggler_frac=straggler,
    )

    def participates(i: int) -> bool:
        return base.available(i) and channel.participates(i, nominal_bytes)

    # Degenerate draw: keep at least one participant. The scan
    # early-exits at the first participant (expected O(1) probes); only
    # an all-dropped draw walks the whole population — and then one
    # forced device, chosen without reference to the draws, joins.
    if not any(participates(i) for i in range(spec.n_devices)):
        forced = int(stream_rng(spec.seed, "forced-device")
                     .integers(spec.n_devices))
        available_fn = lambda i: i == forced or participates(i)  # noqa: E731
    else:
        available_fn = participates

    return _stream(spec, base.gen, available_fn=available_fn, channel=channel)
