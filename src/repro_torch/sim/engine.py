"""Device-parallel local training engine: the loop, bucketed, sharded
and streamed tiers.

Port of ``repro.sim.engine``:

  mode="loop"      sequential per-device oracle: one Gram, one SDCA
                   solve, one scoring pass per device
  mode="bucketed"  whole cohorts per batched pass on one card
  mode="sharded"   the bucketed passes laid out over the sim mesh
                   (``launch.mesh.make_sim_mesh``: the ranks of a
                   ``torch.distributed`` world), data-parallel over the
                   group axis, one gather a pass
  mode="streamed"  the bucketed passes over BOUNDED CHUNKS of a lazy
                   ``DeviceStream``: devices are generated, trained and
                   released chunk by chunk, so peak host memory is
                   O(chunk_devices), not O(population)

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

The streamed tier runs the same classification, bucketing, padding and
fit/score math as the bucketed tier; only the group COMPOSITION differs
(chunk-local buckets instead of population-wide ones). A device's
numbers must not depend on its group: each kernel's output depends on
its own rows alone (the Gram's tile plan, SDCA's per-device solve), and
the score contraction ``_row_dot`` sums in an order fixed by the bucket
alone, where a batched matrix product's order may follow g and q. So
the streamed tier is bitwise the bucketed tier, on the card and on the
CPU. ``train_selected`` regenerates only a chosen id set through the
same math: the server-side rebuild of the k selected models after a
streamed selection pass.

The sharded tier runs the bucketed tier's host code on every rank of the
world, byte for byte (seeds, bucketing, padding; the group axis also pads
to at least the mesh size), and swaps each fit and score pass for its
``ShardCtx`` twin: mesh rank r runs ``_fit_group`` / ``_score_group`` on
its contiguous ``g / n_shards`` groups on its own device, and one
all-gather a pass hands every rank the whole group's alphas or scores.
Group composition is all that changes, so the sharded tier is bitwise the
bucketed tier at every shard count, as the streamed tier is.
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
from repro_torch.launch.mesh import make_sim_mesh, mesh_chips
from repro_torch.obs.registry import default_registry
from repro_torch.obs.trace import current_tracer, stopwatch
from repro_torch.sharding.rules import group_shard_specs
from repro_torch.sim.scenarios import DeviceStream, ScenarioSpec
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


def _row_dot(kq: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """sum_b kq[g, q, b] * coef[g, b] -> (g, q), in an order fixed by b
    alone: the products, then the two halves of the columns added
    elementwise until one is left (an odd column out is added to the
    first). Every step is one IEEE operation an element, so the result
    is the same bits for any g and q, on the card and on the CPU; a
    batched matrix product (the reference's einsum) may pick its
    reduction order from the shapes."""
    t = kq * coef[:, None, :]
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        head = t[..., :h] + t[..., h:2 * h]
        if t.shape[-1] % 2:
            head[..., :1] += t[..., 2 * h:]
        t = head
    return t[..., 0]


def _score_group(xq, sup, coef, gammas) -> torch.Tensor:
    """Batched decision scores: (g, q, d) queries against (g, b, d)
    supports. Zero-padded supports contribute nothing via zero coefs;
    padded query rows are sliced off by the caller."""
    Kq = kops.batched_rbf_gram(xq, sup, gammas)  # (g, q, b)
    return _row_dot(Kq, coef)


# ----------------------------------------------------------------------
# sharded (mesh-parallel) dispatch
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh-parallel dispatch for one engine run: ``_fit_group`` and
    ``_score_group`` split over the sim mesh's ``devices`` axis on the
    leading group dim, by ``sharding.rules.group_shard_specs``.

    Every group member's SDCA problem is independent, so laying groups
    out along the mesh is pure data parallelism: each mesh rank fits and
    scores its slice of the group on its own device, and the only
    collective is the gather of the results (no reduction crosses
    ranks before selection). Ranks outside the mesh train nothing and
    receive the gathered arrays."""

    mesh: object   # launch.mesh.SimMesh
    epochs: int

    @property
    def n_shards(self) -> int:
        return mesh_chips(self.mesh)

    def fit(self, xp, yp, n_real, gammas, lam: float) -> np.ndarray:
        """alpha (g, b) of ``_fit_group`` on host arrays."""
        return self._run(lambda *a: _fit_group(*a, self.epochs), (xp, yp, n_real, gammas, lam),
                         group_shard_specs(self.mesh, (3, 2, 1, 1, 0)), yp.shape)

    def score(self, xq, sup, coef, gammas) -> np.ndarray:
        """Scores (g, q) of ``_score_group`` on host arrays."""
        return self._run(_score_group, (xq, sup, coef, gammas),
                         group_shard_specs(self.mesh, (3, 3, 2, 1)), xq.shape[:2])

    def _run(self, fn, args, specs, shape) -> np.ndarray:
        """``fn`` on this rank's rows of the group-sharded ``args``, then
        the gather. Its ``engine.gather`` span holds the gather and the
        copy to the host, which waits for the rank's kernels too."""
        mesh = self.mesh
        part = None
        if mesh.rank is not None:
            rows = shape[0] // self.n_shards
            lo = mesh.rank * rows
            part = fn(*(torch.from_numpy(a[lo : lo + rows]).to(mesh.device) if spec else a
                        for a, spec in zip(args, specs)))
        with current_tracer().span("engine.gather", cat="engine", shards=self.n_shards,
                                   rows=int(shape[0])):
            return mesh.gather(part, tuple(shape)).cpu().numpy()


def make_shard_ctx(shards: Optional[int] = None, epochs: int = 20,
                   device="cuda") -> ShardCtx:
    """The sharded dispatch context on ``launch.mesh.make_sim_mesh``'s
    mesh (``shards`` caps it; default the whole world; cached there)."""
    return ShardCtx(make_sim_mesh(shards, device), epochs)


def _pad_pow2(n: int, lo: int = 8) -> int:
    return max(lo, 1 << (n - 1).bit_length())


def _train_bucket_group(
    members: List[tuple], bucket: int, lam: float, epochs: int,
    device: torch.device, pad_floor: int = 8, shard: Optional[ShardCtx] = None,
) -> List[DeviceOutcome]:
    """members: [(dev_id, splits)] sharing one SDCA bucket size. Packing
    is host numpy, as in the reference; the group pads to a power of two
    of devices (at least ``pad_floor``). With a ``shard`` context the
    group also pads to at least the mesh size (a power of two) and the
    fit and scoring passes run mesh-parallel."""
    if shard is not None:
        pad_floor = max(pad_floor, shard.n_shards)
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

    if shard is None:
        xp_d, gammas_d = dev(xp), dev(gammas)
        alpha = _fit_group(xp_d, dev(yp), dev(n_real), gammas_d, lam, epochs).cpu().numpy()
    else:
        alpha = shard.fit(xp, yp, n_real, gammas, lam)
    # coef = alpha * y / (lam * n); zero-label padding zeroes padded coefs
    y0 = np.where(np.arange(bucket)[None, :] < n_real[:, None], yp, 0.0)
    coef = alpha * y0 / (lam * np.maximum(n_real, 1)[:, None])
    coef32 = coef.astype(np.float32)
    coef_d = dev(coef32) if shard is None else None

    scores: Dict[str, np.ndarray] = {}
    for split in ("val", "test"):
        qs = [sp[split].x for _, sp in members]
        q = -(-max(len(a) for a in qs) // QUERY_PAD) * QUERY_PAD
        xq = np.zeros((g, q, xp.shape[2]), np.float32)
        for i, a in enumerate(qs):
            xq[i, : len(a)] = a
        if shard is None:
            scores[split] = _score_group(dev(xq), xp_d, coef_d, gammas_d).cpu().numpy()
        else:
            scores[split] = shard.score(xq, xp, coef32, gammas)

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


def _bucket_group_caps(bucket: int, group_cap: int, shard: Optional[ShardCtx] = None) -> int:
    """Power-of-two group size under the Gram memory budget. The budget
    is a device's: a sharded run holds 1/n_shards of each group on each
    device, so its groups grow n_shards x larger (fewer passes)."""
    budget = GRAM_ELEM_BUDGET * (shard.n_shards if shard else 1)
    cap = max(1, min(group_cap, budget // (bucket * bucket)))
    return 1 << (cap.bit_length() - 1)


def _train_buckets(by_bucket, lam, epochs, group_cap, device, shard=None):
    """Yield (bucket, outcomes, seconds) for every bucket group; each
    group is one ``cat="engine"`` span, closed before the yield."""
    tracer = current_tracer()
    reg = default_registry()
    for bucket in sorted(by_bucket):
        members = by_bucket[bucket]
        cap = _bucket_group_caps(bucket, group_cap, shard)
        for lo in range(0, len(members), cap):
            elapsed = stopwatch()
            with tracer.span("engine.group", cat="engine", bucket=bucket,
                             members=len(members[lo : lo + cap]), cap=cap):
                outs = _train_bucket_group(
                    members[lo : lo + cap], bucket, lam, epochs, device,
                    pad_floor=min(8, cap), shard=shard,
                )
            secs = elapsed()
            reg.counter("engine.groups").inc()
            reg.counter("engine.devices_trained").inc(len(outs))
            reg.histogram("engine.group_seconds").observe(secs)
            yield bucket, outs, secs


def iter_population(
    dataset,
    *,
    lam: float = 0.01,
    seed: int = 0,
    min_samples: Optional[int] = None,
    mode: str = "bucketed",
    epochs: int = 20,
    group_cap: int = 256,
    available: Optional[np.ndarray] = None,
    shards: Optional[int] = None,
    chunk_devices: int = 1024,
    device="cuda",
) -> Iterator[GroupUpdate]:
    """Train a device population, streaming one GroupUpdate per batch.

    ``dataset`` is a materialised ``FederatedDataset`` or a lazy
    ``scenarios.DeviceStream``. Passing a stream to a materialising mode
    realises it first; passing a dataset to the streamed mode wraps it
    (the streamed tier then bounds the card's batches, but host memory
    is already O(population)).

    ``available`` (optional bool mask, len n_devices) drops absent
    devices entirely — they neither train nor report. A stream's own
    lazy availability mask composes with it (logical AND).

    ``mode="sharded"`` runs the bucketed passes mesh-parallel over the
    ranks of the ``torch.distributed`` world (``shards`` caps how many;
    default all, see ``make_shard_ctx``). Every rank calls this with the
    same arguments and gets every update; bucketing, seeds and padding
    are the bucketed tier's, and so is every result, bit for bit.

    ``mode="streamed"`` generates, trains and releases devices in
    ``chunk_devices``-sized chunks: peak host memory is O(chunk), and
    per-device results equal the bucketed tier's. Pass ``shards`` to run
    each chunk's passes mesh-parallel as well.
    """
    if mode not in ("bucketed", "loop", "sharded", "streamed"):
        raise ValueError(f"unknown engine mode {mode!r}")
    dev = resolve_device(device)

    if mode == "streamed":
        stream = dataset if isinstance(dataset, DeviceStream) else _dataset_as_stream(dataset)
        yield from _iter_streamed(
            stream, lam=lam, seed=seed,
            min_samples=stream.min_samples if min_samples is None else min_samples,
            epochs=epochs, group_cap=group_cap, available=available,
            shards=shards, chunk_devices=chunk_devices, device=dev,
        )
        return

    if isinstance(dataset, DeviceStream):
        fed = dataset.materialize()
        mask = np.asarray(fed.available)
        if available is not None:
            mask = mask & np.asarray(available, bool)
        dataset, available = fed.dataset, mask

    shard = make_shard_ctx(shards, epochs, dev) if mode == "sharded" else None
    min_samples = dataset.min_samples if min_samples is None else min_samples
    ids = [
        i for i in range(dataset.n_devices)
        if available is None or bool(available[i])
    ]
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

    for bucket, outs, secs in _train_buckets(by_bucket, lam, epochs, group_cap, dev, shard):
        done += len(outs)
        yield GroupUpdate(bucket, outs, secs, done, total)


def _dataset_as_stream(dataset: FederatedDataset) -> DeviceStream:
    """View a materialised dataset through the stream interface."""
    spec = ScenarioSpec(
        name=dataset.name, n_devices=dataset.n_devices,
        dim=dataset.dim, min_samples=dataset.min_samples,
    )
    return DeviceStream(spec=spec, gen=lambda i: dataset.devices[i])


def _iter_streamed(
    stream: DeviceStream, *, lam, seed, min_samples, epochs, group_cap, available,
    shards, chunk_devices, device,
) -> Iterator[GroupUpdate]:
    if chunk_devices < 1:
        raise ValueError(f"chunk_devices must be >= 1, got {chunk_devices}")
    shard = make_shard_ctx(shards, epochs, device) if shards is not None else None

    def admitted(i: int) -> bool:
        if available is not None and not bool(available[i]):
            return False
        return stream.available(i)

    if available is None:
        total = stream.count_available()
    else:
        total = sum(1 for i in range(stream.n_devices) if admitted(i))
    done = 0

    tracer = current_tracer()
    reg = default_registry()
    for lo in range(0, stream.n_devices, chunk_devices):
        hi = min(lo + chunk_devices, stream.n_devices)
        with tracer.span("engine.chunk", cat="engine", lo=lo, hi=hi):
            elapsed = stopwatch()
            fallback: List[DeviceOutcome] = []
            by_bucket: Dict[int, List[tuple]] = {}
            for i in range(lo, hi):
                if not admitted(i):
                    continue
                bucket, payload = _classify_device(i, stream.device(i),
                                                   min_samples, seed=seed)
                if bucket is None:
                    fallback.append(payload)
                else:
                    by_bucket.setdefault(bucket, []).append((i, payload))
            if fallback:
                done += len(fallback)
                yield GroupUpdate(0, fallback, elapsed(), done, total)
            for bucket, outs, secs in _train_buckets(by_bucket, lam, epochs,
                                                     group_cap, device, shard):
                done += len(outs)
                yield GroupUpdate(bucket, outs, secs, done, total)
        reg.counter("engine.chunks").inc()
        # the chunk's devices die with these locals on the next pass —
        # nothing population-sized is ever retained here


def train_selected(
    stream: DeviceStream,
    ids,
    *,
    lam: float = 0.01,
    seed: int = 0,
    min_samples: Optional[int] = None,
    epochs: int = 20,
    group_cap: int = 256,
    shards: Optional[int] = None,
    device="cuda",
) -> Dict[int, DeviceOutcome]:
    """Regenerate and train ONLY the given device ids from a stream.

    The server-side rebuild after a streamed selection pass: with k
    winners out of a 10^6-device population, this touches k devices
    instead of re-streaming everyone. Same classification, bucketing
    and fit/score math as every other tier, so the outcomes equal what
    the full pass produced for those ids (group-composition invariance
    again). With ``shards`` the passes run mesh-parallel.
    """
    dev = resolve_device(device)
    min_samples = stream.min_samples if min_samples is None else min_samples
    shard = make_shard_ctx(shards, epochs, dev) if shards is not None else None
    out: Dict[int, DeviceOutcome] = {}
    by_bucket: Dict[int, List[tuple]] = {}
    for i in sorted(set(int(i) for i in ids)):
        bucket, payload = _classify_device(i, stream.device(i), min_samples,
                                           seed=seed)
        if bucket is None:
            out[payload.device_id] = payload
        else:
            by_bucket.setdefault(bucket, []).append((i, payload))
    for _, outs, _ in _train_buckets(by_bucket, lam, epochs, group_cap, dev, shard):
        for o in outs:
            out[o.device_id] = o
    return out


def train_population(
    dataset, on_update=None, **kw
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
