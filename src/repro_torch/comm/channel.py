"""Per-device uplink channel model: bandwidth, drops, deadlines.

The one-shot round is only "one round" if every selected upload lands
before the server aggregates — so availability is not just membership,
it is bandwidth against a deadline. A channel assigns each device a
lognormal uplink bandwidth plus a drop mask (devices that never reach
the server), and prices any payload in SECONDS:

    upload_seconds(i, nbytes)   one device's upload time
    straggler_mask(nbytes)      who misses the round deadline at that
                                payload size — codec choice changes who
                                straggles, not just who pays
    time_to_aggregate(sizes)    the server-side round latency: the
                                slowest selected upload

Two representations share one per-device derivation:

  * ``ChannelStream`` is LAZY: device i's (bandwidth, dropped) pair is
    derived on demand from ``derive_device_seed(seed, i)`` — O(1) state
    regardless of fleet size, so million-device federations never hold
    a population-length bandwidth or mask array. The round deadline is
    the ANALYTIC lognormal upload-time quantile (no fleet scan).
  * ``ChannelModel`` is the materialized fleet (arrays), produced by
    ``ChannelStream.materialize`` — bitwise the same per-device values,
    for populations small enough to hold.

``sim/scenarios.py``'s availability scenario builds its participation
mask FROM a channel stream (drops + stragglers at a nominal fp32
payload), so federation membership and round latency come from one
physical model, in O(1) memory per device probed.

Port of ``repro.comm.channel``, copied line for line: it is numpy on the
host, and the draw order is part of the result, so device i's
bandwidth and drop are the reference's bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np

from repro_torch.utils.seeds import derive_device_seed


def _norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation,
    |rel err| < 1.2e-9 — no scipy dependency). Used to place the round
    deadline at an analytic lognormal quantile instead of scanning a
    materialized fleet."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {p}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


@dataclasses.dataclass(frozen=True)
class ChannelStream:
    """Lazy per-device channel: device i's draws come from its own
    ``derive_device_seed(seed, i)`` stream — never from a fleet-length
    array — so the values are independent of fleet size, probe order,
    and how many devices are ever probed (pinned by the snapshot test
    in tests/test_stream.py)."""

    seed: int
    mean_bandwidth: float = 128 * 1024.0
    sigma: float = 1.0
    drop_frac: float = 0.0
    deadline_s: float = float("inf")

    def device_draws(self, device_id: int) -> tuple:
        """(bandwidth bytes/s, dropped) for one device, on demand."""
        g = np.random.default_rng(derive_device_seed(self.seed, device_id))
        bw = max(self.mean_bandwidth * g.lognormal(mean=0.0, sigma=self.sigma), 1.0)
        dropped = bool(g.random() < self.drop_frac)
        return float(bw), dropped

    def bandwidth_of(self, device_id: int) -> float:
        return self.device_draws(device_id)[0]

    def dropped_of(self, device_id: int) -> bool:
        return self.device_draws(device_id)[1]

    def upload_seconds(self, device_id: int, nbytes: int) -> float:
        return float(nbytes) / self.bandwidth_of(device_id)

    def participates(self, device_id: int, nbytes: int) -> bool:
        """Not dropped AND the payload lands before the deadline."""
        bw, dropped = self.device_draws(device_id)
        return (not dropped) and (float(nbytes) / bw) <= self.deadline_s

    def time_to_aggregate(self, sizes: Mapping[int, int]) -> float:
        """Round latency: the slowest selected upload (uploads are
        concurrent — devices do not share the pipe)."""
        if not sizes:
            return 0.0
        return max(self.upload_seconds(i, n) for i, n in sizes.items())

    def materialize(self, n_devices: int) -> "ChannelModel":
        """The same per-device draws as fleet arrays."""
        bw = np.empty(n_devices, np.float64)
        dropped = np.zeros(n_devices, bool)
        for i in range(n_devices):
            bw[i], dropped[i] = self.device_draws(i)
        return ChannelModel(bandwidth=bw, dropped=dropped,
                           deadline_s=self.deadline_s)


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    bandwidth: np.ndarray   # (n_devices,) uplink bytes/second
    dropped: np.ndarray     # (n_devices,) bool: offline, never reports
    deadline_s: float       # single-round upload deadline (inf: none)

    @property
    def n_devices(self) -> int:
        return len(self.bandwidth)

    def upload_seconds(self, device_id: int, nbytes: int) -> float:
        return float(nbytes) / float(self.bandwidth[device_id])

    def straggler_mask(self, nbytes: int) -> np.ndarray:
        """Devices whose upload of an ``nbytes`` payload misses the
        deadline. A smaller codec literally rescues devices."""
        return (float(nbytes) / self.bandwidth) > self.deadline_s

    def participation(self, nbytes: int) -> np.ndarray:
        return ~self.dropped & ~self.straggler_mask(nbytes)

    def time_to_aggregate(self, sizes: Mapping[int, int]) -> float:
        """Round latency: the server waits for its slowest selected
        upload (uploads are concurrent — devices do not share the pipe)."""
        if not sizes:
            return 0.0
        return max(self.upload_seconds(i, n) for i, n in sizes.items())


def calibrated_deadline(
    mean_bandwidth: float,
    sigma: float,
    nominal_bytes: int,
    straggler_frac: float,
) -> float:
    """Deadline such that (in distribution) a ``straggler_frac`` share
    of the fleet misses it uploading ``nominal_bytes``.

    Upload time is ``nominal / (mean_bw * LogNormal(0, sigma))`` — its
    (1 - frac) quantile is analytic, so the calibration needs no fleet
    scan and is independent of population size. (The bandwidth floor at
    1 byte/s perturbs only the extreme sub-floor tail.)
    """
    if straggler_frac <= 0.0:
        return float("inf")
    return float(nominal_bytes) / mean_bandwidth * math.exp(
        sigma * _norm_ppf(1.0 - straggler_frac)
    )


def make_channel_stream(
    seed: int = 0,
    mean_bandwidth: float = 128 * 1024.0,
    sigma: float = 1.0,
    drop_frac: float = 0.0,
    deadline_s: Optional[float] = None,
    nominal_bytes: Optional[int] = None,
    straggler_frac: float = 0.0,
) -> ChannelStream:
    """Seeded lazy lognormal uplink fleet.

    The deadline can be given directly (``deadline_s``) or calibrated
    analytically: with ``nominal_bytes`` set, it sits at the lognormal
    upload-time quantile where a ``straggler_frac`` share of the fleet
    (in distribution) misses it for that payload size.
    """
    if deadline_s is None:
        if nominal_bytes is not None and straggler_frac > 0.0:
            deadline_s = calibrated_deadline(
                mean_bandwidth, sigma, nominal_bytes, straggler_frac
            )
        else:
            deadline_s = float("inf")
    return ChannelStream(
        seed=seed, mean_bandwidth=mean_bandwidth, sigma=sigma,
        drop_frac=drop_frac, deadline_s=float(deadline_s),
    )


def make_channel(
    n_devices: int,
    seed: int = 0,
    mean_bandwidth: float = 128 * 1024.0,
    sigma: float = 1.0,
    drop_frac: float = 0.0,
    deadline_s: Optional[float] = None,
    nominal_bytes: Optional[int] = None,
    straggler_frac: float = 0.0,
) -> ChannelModel:
    """Materialized fleet: ``make_channel_stream(...).materialize(n)``.

    Kept for populations small enough to hold arrays; per-device values
    are bitwise-identical to the lazy stream's."""
    return make_channel_stream(
        seed=seed, mean_bandwidth=mean_bandwidth, sigma=sigma,
        drop_frac=drop_frac, deadline_s=deadline_s,
        nominal_bytes=nominal_bytes, straggler_frac=straggler_frac,
    ).materialize(n_devices)
