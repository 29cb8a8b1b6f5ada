"""Synthetic federated datasets statistically matched to the paper's Table 1.

Real EMNIST / Sent140 / Gleam are not available offline; we generate
federated binary-classification data whose *device statistics* match the
published table:

    EMNIST   406,048 samples, 3,462 devices, per-device 10..460
    Sent140  161,966 samples, 4,000 devices, per-device 21..345
    Gleam      2,469 samples,    38 devices, per-device 33..99

Each generator produces genuinely non-IID device distributions so that
the paper's phenomena are reproducible: local models vary in quality,
ensembles capture global structure, and the pooled "ideal" upper-bounds
everything.

Generative story (shared): a global binary concept (two anisotropic
Gaussian mixtures in R^d for EMNIST/Gleam; sparse bag-of-words topic
mixtures for Sent140) plus per-device nuisance transforms — class
imbalance drawn from a Beta, a device-specific affine shift ("writer
style" / "user vocabulary" / "wearer placement"), and label noise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.utils.seeds import derive_device_seed, derive_stream_seed


@dataclasses.dataclass
class DeviceData:
    """One device's local dataset (features x labels in {-1,+1})."""

    x: np.ndarray  # (n, d) float32
    y: np.ndarray  # (n,) float32 in {-1, +1}

    @property
    def n(self) -> int:
        return len(self.y)


@dataclasses.dataclass
class FederatedDataset:
    name: str
    devices: List[DeviceData]
    min_samples: int  # paper's ensemble-eligibility threshold
    dim: int

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def total_samples(self) -> int:
        return sum(d.n for d in self.devices)

    def eligible(self) -> List[int]:
        """Indices of devices meeting the paper's min-sample threshold."""
        return [i for i, d in enumerate(self.devices) if d.n >= self.min_samples]


def _device_sizes(rng, n_devices, lo, hi, total) -> np.ndarray:
    """Per-device sample counts in [lo, hi] summing approximately to total.

    Paper's device counts are long-tailed; we draw from a truncated
    log-normal and rescale.
    """
    raw = rng.lognormal(mean=0.0, sigma=0.9, size=n_devices)
    sizes = lo + (raw / raw.max()) * (hi - lo)
    sizes = sizes * (total / sizes.sum())
    sizes = np.clip(np.round(sizes), lo, hi).astype(int)
    return sizes


def _gaussian_concept(rng, dim, n_clusters=4, sep=2.2):
    """Two-class mixture of Gaussians; returns a sampler(rng, n, imb, shift)."""
    means = {
        +1: rng.normal(0, 1, size=(n_clusters, dim)) + sep / np.sqrt(dim),
        -1: rng.normal(0, 1, size=(n_clusters, dim)) - sep / np.sqrt(dim),
    }
    scales = {c: 0.6 + 0.8 * rng.random(n_clusters) for c in (+1, -1)}

    def sample(drng, n, pos_frac, shift, noise):
        y = np.where(drng.random(n) < pos_frac, 1.0, -1.0)
        x = np.empty((n, dim), np.float32)
        for i in range(n):
            c = int(y[i])
            k = drng.integers(n_clusters)
            x[i] = means[c][k] + scales[c][k] * drng.normal(0, 1, dim)
        x += shift  # device nuisance
        flip = drng.random(n) < noise
        y = np.where(flip, -y, y)
        return x.astype(np.float32), y.astype(np.float32)

    return sample


def _make_gaussian_federated(
    name, seed, n_devices, lo, hi, total, dim, min_samples, noise=0.05, shift_scale=0.35
) -> FederatedDataset:
    rng = np.random.default_rng(seed)
    concept = _gaussian_concept(rng, dim)
    sizes = _device_sizes(rng, n_devices, lo, hi, total)
    devices = []
    for t in range(n_devices):
        drng = np.random.default_rng(derive_device_seed(seed, t))
        pos_frac = float(np.clip(drng.beta(2.5, 2.5), 0.05, 0.95))
        shift = shift_scale * drng.normal(0, 1, dim).astype(np.float32)
        x, y = concept(drng, int(sizes[t]), pos_frac, shift, noise)
        devices.append(DeviceData(x=x, y=y))
    return FederatedDataset(name=name, devices=devices, min_samples=min_samples, dim=dim)


def make_emnist_like(seed: int = 0, scale: float = 1.0, dim: int = 32) -> FederatedDataset:
    """EMNIST-like: 3,462 writers, 10..460 samples each, binary case task."""
    n_dev = max(int(3462 * scale), 8)
    total = int(406048 * scale)
    return _make_gaussian_federated(
        "emnist", seed + 1, n_dev, 10, 460, total, dim, min_samples=60, noise=0.04
    )


def make_gleam_like(seed: int = 0, scale: float = 1.0, dim: int = 24) -> FederatedDataset:
    """Gleam-like: 38 wearers, 33..99 samples, eat-vs-other sensor task."""
    n_dev = max(int(38 * scale), 6)
    total = int(2469 * scale)
    return _make_gaussian_federated(
        "gleam", seed + 2, n_dev, 33, 99, total, dim, min_samples=30, noise=0.08, shift_scale=0.5
    )


def make_sent140_like(seed: int = 0, scale: float = 1.0, dim: int = 64) -> FederatedDataset:
    """Sent140-like: 4,000 users, 21..345 tweets, sparse BoW sentiment.

    Features are sparse nonnegative topic-count vectors: a shared
    sentiment direction plus user-specific vocabulary preferences.
    """
    seed += 3
    rng = np.random.default_rng(seed)
    n_dev = max(int(4000 * scale), 8)
    total = int(161966 * scale)
    sizes = _device_sizes(rng, n_dev, 21, 345, total)
    # global sentiment-bearing word weights
    pos_words = rng.random(dim) < 0.25
    neg_words = (rng.random(dim) < 0.25) & ~pos_words
    devices = []
    for t in range(n_dev):
        drng = np.random.default_rng(derive_device_seed(seed, t))
        n = int(sizes[t])
        user_vocab = drng.dirichlet(0.3 * np.ones(dim))  # user word preferences
        pos_frac = float(np.clip(drng.beta(2.0, 2.0), 0.05, 0.95))
        y = np.where(drng.random(n) < pos_frac, 1.0, -1.0)
        base = drng.poisson(lam=3.0 * user_vocab[None, :] * dim / 3.0, size=(n, dim))
        sentiment = np.where(
            y[:, None] > 0, pos_words[None, :], neg_words[None, :]
        ) * drng.poisson(2.0, size=(n, dim))
        x = (base + sentiment).astype(np.float32)
        x = x / np.maximum(x.sum(axis=1, keepdims=True), 1.0)  # tf-normalize
        flip = drng.random(n) < 0.06
        y = np.where(flip, -y, y).astype(np.float32)
        devices.append(DeviceData(x=x, y=y))
    return FederatedDataset(name="sent140", devices=devices, min_samples=30, dim=dim)


def make_cohort_dataset(
    seed: int = 0, n_cohorts: int = 3, n_devices: int = 45, dim: int = 16,
    lo: int = 40, hi: int = 120,
) -> FederatedDataset:
    """Federated data with LATENT COHORT structure (paper future-work 1):
    cohorts share input geometry but DISAGREE on label semantics (odd
    cohorts flip the concept). A single global ensemble therefore mixes
    contradicting teachers, while per-cohort ensembles do not. Device i
    belongs to cohort i % n_cohorts (ground truth for tests).
    """
    rng = np.random.default_rng(derive_stream_seed(seed, "cohort-concept"))
    concept = _gaussian_concept(rng, dim, sep=2.5)
    sizes = _device_sizes(rng, n_devices, lo, hi, n_devices * (lo + hi) // 2)
    devices = []
    for t in range(n_devices):
        drng = np.random.default_rng(derive_device_seed(seed, t))
        cohort = t % n_cohorts
        pos_frac = float(np.clip(drng.beta(3.0, 3.0), 0.2, 0.8))
        shift = 0.2 * drng.normal(0, 1, dim).astype(np.float32)
        x, y = concept(drng, int(sizes[t]), pos_frac, shift, noise=0.05)
        if cohort % 2 == 1:  # flipped label semantics for odd cohorts
            y = -y
        devices.append(DeviceData(x=x, y=y))
    return FederatedDataset(name="cohort", devices=devices, min_samples=30, dim=dim)


DATASETS: Dict[str, Callable[..., FederatedDataset]] = {
    "emnist": make_emnist_like,
    "sent140": make_sent140_like,
    "gleam": make_gleam_like,
}


def make_dataset(name: str, seed: int = 0, scale: float = 1.0) -> FederatedDataset:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(DATASETS)}")
    return DATASETS[name](seed=seed, scale=scale)
