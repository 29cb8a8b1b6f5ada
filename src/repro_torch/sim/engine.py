"""Device-parallel local training engine: the loop and bucketed tiers.

Port of ``repro.sim.engine``'s materialised tiers:

  mode="loop"      sequential per-device oracle: one Gram, one SDCA
                   solve, one scoring pass per device
  mode="bucketed"  whole cohorts per batched pass on one card

The bucketed tier fits whole cohorts of devices at once:

  1. every device's data is split 50/40/10 with its own derived seed
     (``derive_device_seed``: the same streams as the reference);
  2. data-deficient / single-class devices fall back to constant
     classifiers (no device work);
  3. trainable devices are grouped by their SDCA pad bucket (64-row
     multiples, the bucket ``train_svm`` uses), groups are capped by
     ``GRAM_ELEM_BUDGET`` and padded to a power of two of devices;
  4. per group, one ``batched_rbf_gram`` launch builds every Gram, one
     ``sdca`` launch solves every dual, and two more batched Gram
     launches score every device's val and test splits.

All padding, seeds, gammas and coefficient arithmetic are host numpy,
byte for byte the reference's; only the Gram, the solve and the score
contraction run on ``device``. Padded Gram rows/cols are masked to zero
and padded labels are +1, as in ``train_svm``, so per-device results
match the loop tier to float-accumulation noise (the bar is 1e-4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.core.selection import DeviceReport
from repro_torch.core.svm import (
    SDCA_BUCKET,
    ConstantModel,
    SVMModel,
    default_gamma,
    train_svm,
)
from repro_torch.data.federated import DeviceData, FederatedDataset
from repro_torch.data.partition import derive_device_seed, split_train_test_val
from repro_torch.kernels import ops as kops
from repro_torch.obs.registry import default_registry
from repro_torch.obs.trace import current_tracer, stopwatch
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.metrics import roc_auc

log = get_logger("sim.engine")

QUERY_PAD = 8             # val/test query rows pad to multiples of this
GRAM_ELEM_BUDGET = 2**25  # max fp32 elements of one batched (g, b, b) Gram


@dataclasses.dataclass
class DeviceOutcome:
    """Everything the protocol needs from one device's local phase."""

    device_id: int
    splits: Dict[str, DeviceData]
    model: object  # SVMModel | ConstantModel
    report: DeviceReport
    val_scores: np.ndarray          # own model on own val split
    local_test_scores: np.ndarray   # own model on own test split

    @property
    def local_test_auc(self) -> float:
        return roc_auc(self.splits["test"].y, self.local_test_scores)


@dataclasses.dataclass
class GroupUpdate:
    """One streamed unit of progress: a trained bucket (or loop chunk)."""

    bucket: int                     # SDCA pad size (0 for fallback devices)
    outcomes: List[DeviceOutcome]
    seconds: float
    done: int                       # devices finished so far (cumulative)
    total: int                      # devices this run will train

    @property
    def mean_val_auc(self) -> float:
        return float(np.mean([o.report.val_auc for o in self.outcomes]))


@dataclasses.dataclass
class PopulationResult:
    outcomes: List[DeviceOutcome]   # sorted by device_id
    seconds: float
    groups: List[GroupUpdate]

    @property
    def reports(self) -> List[DeviceReport]:
        return [o.report for o in self.outcomes]

    @property
    def mean_local_auc(self) -> float:
        return float(np.mean([o.local_test_auc for o in self.outcomes]))


def _split_device(dev_id: int, dev: DeviceData, seed: int) -> Dict[str, DeviceData]:
    return split_train_test_val(dev, seed=derive_device_seed(seed, dev_id))


def _constant_outcome(dev_id: int, splits: Dict[str, DeviceData]) -> DeviceOutcome:
    """Paper's local baseline for data-deficient devices."""
    model = ConstantModel(float(np.mean(splits["train"].y)))
    report = DeviceReport(dev_id, splits["train"].n, 0.5, eligible=False)
    return DeviceOutcome(
        dev_id, splits, model, report,
        val_scores=model.predict(splits["val"].x),
        local_test_scores=model.predict(splits["test"].x),
    )


def train_device(
    dev_id: int, dev: DeviceData, min_samples: int, lam: float, seed: int,
    epochs: int = 20, device="cuda",
) -> DeviceOutcome:
    """Sequential oracle: one device end-to-end."""
    splits = _split_device(dev_id, dev, seed)
    tr, va = splits["train"], splits["val"]
    if dev.n < min_samples or len(np.unique(tr.y)) < 2:
        return _constant_outcome(dev_id, splits)
    model = train_svm(tr.x, tr.y, lam=lam, epochs=epochs, device=device)
    val_scores = model.predict(va.x)
    report = DeviceReport(dev_id, tr.n, roc_auc(va.y, val_scores), eligible=True)
    return DeviceOutcome(
        dev_id, splits, model, report,
        val_scores=val_scores,
        local_test_scores=model.predict(splits["test"].x),
    )


# ----------------------------------------------------------------------
# bucketed (device-parallel) path
# ----------------------------------------------------------------------

def _fit_group(xp, yp, n_real, gammas, lam: float, epochs: int) -> torch.Tensor:
    """One batched Gram + one batched SDCA for a bucket of devices.

    xp: (g, b, d) zero-padded train features; yp: (g, b) labels padded
    with +1; n_real: (g,) int32 real counts; gammas: (g,). Returns
    alpha (g, b) with padded coordinates zero."""
    K = kops.batched_rbf_gram(xp, xp, gammas)
    valid = torch.arange(xp.shape[1], device=xp.device)[None, :] < n_real[:, None]
    K = K * (valid[:, :, None] & valid[:, None, :])  # zero pad rows/cols
    return kops.sdca(K, yp, n_real, lam, epochs)


def _score_group(xq, sup, coef, gammas) -> torch.Tensor:
    """Batched decision scores: (g, q, d) queries against (g, b, d)
    supports. Zero-padded supports contribute nothing via zero coefs;
    padded query rows are sliced off by the caller."""
    Kq = kops.batched_rbf_gram(xq, sup, gammas)  # (g, q, b)
    return torch.einsum("gqb,gb->gq", Kq, coef)


def _pad_pow2(n: int, lo: int = 8) -> int:
    return max(lo, 1 << (n - 1).bit_length())


def _train_bucket_group(
    members: List[tuple], bucket: int, lam: float, epochs: int,
    device: torch.device, pad_floor: int = 8,
) -> List[DeviceOutcome]:
    """members: [(dev_id, splits)] sharing one SDCA bucket size. Packing
    is host numpy, as in the reference; the group pads to a power of two
    of devices (at least ``pad_floor``)."""
    g_real = len(members)
    g = _pad_pow2(g_real, lo=pad_floor)
    trains = [sp["train"] for _, sp in members]
    n_real = np.zeros(g, np.int32)
    n_real[:g_real] = [t.n for t in trains]
    # full-precision gammas for the stored models (train_svm keeps the
    # float64 heuristic); the kernels see float32 either way
    gamma_list = [default_gamma(t.x) for t in trains]
    gammas = np.ones(g, np.float32)
    gammas[:g_real] = gamma_list
    xp = np.zeros((g, bucket, trains[0].x.shape[1]), np.float32)
    yp = np.ones((g, bucket), np.float32)  # +1 padding, as in train_svm
    for i, t in enumerate(trains):
        xp[i, : t.n] = t.x
        yp[i, : t.n] = t.y

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    xp_d, gammas_d = dev(xp), dev(gammas)
    alpha = _fit_group(xp_d, dev(yp), dev(n_real), gammas_d, lam, epochs).cpu().numpy()
    # coef = alpha * y / (lam * n); zero-label padding zeroes padded coefs
    y0 = np.where(np.arange(bucket)[None, :] < n_real[:, None], yp, 0.0)
    coef = alpha * y0 / (lam * np.maximum(n_real, 1)[:, None])
    coef_d = dev(coef.astype(np.float32))

    scores: Dict[str, np.ndarray] = {}
    for split in ("val", "test"):
        qs = [sp[split].x for _, sp in members]
        q = -(-max(len(a) for a in qs) // QUERY_PAD) * QUERY_PAD
        xq = np.zeros((g, q, xp.shape[2]), np.float32)
        for i, a in enumerate(qs):
            xq[i, : len(a)] = a
        scores[split] = _score_group(dev(xq), xp_d, coef_d, gammas_d).cpu().numpy()

    outcomes = []
    for i, (dev_id, splits) in enumerate(members):
        tr, va, te = splits["train"], splits["val"], splits["test"]
        model = SVMModel(
            support_x=tr.x.astype(np.float32),
            coef=coef[i, : tr.n].astype(np.float32),
            gamma=gamma_list[i],
            device=str(device),
        )
        val_scores = scores["val"][i, : va.n]
        report = DeviceReport(dev_id, tr.n, roc_auc(va.y, val_scores), eligible=True)
        outcomes.append(DeviceOutcome(
            dev_id, splits, model, report,
            val_scores=val_scores,
            local_test_scores=scores["test"][i, : te.n],
        ))
    return outcomes


def _classify_device(dev_id, dev, min_samples, seed=0):
    """Shared per-device triage: split, then constant-fallback or the
    (bucket, splits) pair the SDCA path will train."""
    splits = _split_device(dev_id, dev, seed)
    tr = splits["train"]
    if dev.n < min_samples or len(np.unique(tr.y)) < 2:
        return None, _constant_outcome(dev_id, splits)
    bucket = max(-(-tr.n // SDCA_BUCKET) * SDCA_BUCKET, SDCA_BUCKET)
    return bucket, splits


def _bucket_group_caps(bucket: int, group_cap: int) -> int:
    """Power-of-two group size under the Gram memory budget."""
    cap = max(1, min(group_cap, GRAM_ELEM_BUDGET // (bucket * bucket)))
    return 1 << (cap.bit_length() - 1)


def _train_buckets(by_bucket, lam, epochs, group_cap, device):
    """Yield (bucket, outcomes, seconds) for every bucket group; each
    group is one ``cat="engine"`` span, closed before the yield."""
    tracer = current_tracer()
    reg = default_registry()
    for bucket in sorted(by_bucket):
        members = by_bucket[bucket]
        cap = _bucket_group_caps(bucket, group_cap)
        for lo in range(0, len(members), cap):
            elapsed = stopwatch()
            with tracer.span("engine.group", cat="engine", bucket=bucket,
                             members=len(members[lo : lo + cap]), cap=cap):
                outs = _train_bucket_group(
                    members[lo : lo + cap], bucket, lam, epochs, device,
                    pad_floor=min(8, cap),
                )
            secs = elapsed()
            reg.counter("engine.groups").inc()
            reg.counter("engine.devices_trained").inc(len(outs))
            reg.histogram("engine.group_seconds").observe(secs)
            yield bucket, outs, secs


def iter_population(
    dataset: FederatedDataset,
    *,
    lam: float = 0.01,
    seed: int = 0,
    min_samples: Optional[int] = None,
    mode: str = "bucketed",
    epochs: int = 20,
    group_cap: int = 256,
    device="cuda",
) -> Iterator[GroupUpdate]:
    """Train a device population, streaming one GroupUpdate per batch."""
    if mode in ("sharded", "streamed"):
        raise NotImplementedError(
            f"engine mode {mode!r} is not ported yet (ROADMAP queue 1, "
            f"item {15 if mode == 'sharded' else 9})")
    if mode not in ("bucketed", "loop"):
        raise ValueError(f"unknown engine mode {mode!r}")
    dev = resolve_device(device)
    min_samples = dataset.min_samples if min_samples is None else min_samples
    ids = list(range(dataset.n_devices))
    total = len(ids)
    done = 0

    if mode == "loop":
        chunk = 32
        for lo in range(0, total, chunk):
            elapsed = stopwatch()
            outs = [
                train_device(i, dataset.devices[i], min_samples, lam, seed, epochs,
                             device=dev)
                for i in ids[lo : lo + chunk]
            ]
            done += len(outs)
            yield GroupUpdate(0, outs, elapsed(), done, total)
        return

    elapsed = stopwatch()
    fallback: List[DeviceOutcome] = []
    by_bucket: Dict[int, List[tuple]] = {}
    for i in ids:
        bucket, payload = _classify_device(i, dataset.devices[i], min_samples, seed=seed)
        if bucket is None:
            fallback.append(payload)
        else:
            by_bucket.setdefault(bucket, []).append((i, payload))
    if fallback:
        done += len(fallback)
        yield GroupUpdate(0, fallback, elapsed(), done, total)

    for bucket, outs, secs in _train_buckets(by_bucket, lam, epochs, group_cap, dev):
        done += len(outs)
        yield GroupUpdate(bucket, outs, secs, done, total)


def train_population(
    dataset: FederatedDataset, on_update=None, **kw
) -> PopulationResult:
    """Drain ``iter_population`` into a result sorted by device id,
    invoking ``on_update(GroupUpdate)`` after each streamed group."""
    elapsed = stopwatch()
    groups = []
    for update in iter_population(dataset, **kw):
        groups.append(update)
        if on_update is not None:
            on_update(update)
    outcomes = sorted(
        (o for g in groups for o in g.outcomes), key=lambda o: o.device_id
    )
    seconds = elapsed()
    log.info(
        "trained %d devices in %d groups (%.2fs, mode=%s)",
        len(outcomes), len(groups), seconds, kw.get("mode", "bucketed"),
    )
    return PopulationResult(outcomes, seconds, groups)
