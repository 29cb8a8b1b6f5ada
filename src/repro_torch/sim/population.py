"""Population runner: scenario -> engine -> selection -> ensemble eval.

Port of ``repro.sim.population``. ``run_protocol`` (core/protocol.py) is
the faithful paper round — every ensemble evaluated on every device. At
population scale that evaluation dominates, so this runner is the
scalable counterpart: it trains the whole population through the
device-parallel engine (streaming progress via ``on_update``), runs the
paper's selection strategies on the cheap scalar reports, and evaluates
the selected ensembles on a seeded, capped subsample of device test
splits through the fused scoring kernel. ``PopulationConfig.distill``
plugs in ``repro_torch.distill``: the best selected ensemble is
distilled into one compact student, downloaded through its own wire
codec onto the ledger, and reported under ``ensemble_auc["distilled"]``.

    from repro_torch.sim import PopulationConfig, run_population
    report = run_population(PopulationConfig(
        scenario="dirichlet", n_devices=512, ks=(10, 50)))

Everything runs on ``device`` (default the card; ``"cpu"`` runs the
kernels' plain versions). Host arithmetic — seeds, selection, budget
packing, channel latency, the ledger — is the reference's, so ``comm``,
the picked ids, the headcounts and ``time_to_aggregate`` equal the
reference's exactly. Every aggregator of ``repro_torch.agg`` runs on
every tier: its extras ride the wire beside each cell's uploads, priced
at ``len(encode())`` on the materialised paths and at the equal shape
price ``agg_extra_wire_nbytes`` on the streamed one.
``engine="sharded"`` trains over the ranks of a ``torch.distributed``
world (``mesh_shards`` caps the mesh) with the bucketed round's results,
bit for bit; every rank runs the whole round and returns the report.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.agg import build_cell, get_aggregator
from repro_torch.comm.exchange import ModelExchange, StreamExchange
from repro_torch.comm.ledger import CommLedger
from repro_torch.comm.wire import agg_extra_wire_nbytes
from repro_torch.core.selection import ReportColumns
from repro_torch.distill import DistillConfig, distill_round
from repro_torch.obs.trace import current_tracer, stopwatch
from repro_torch.sim.engine import (
    DeviceOutcome,
    GroupUpdate,
    _dataset_as_stream,
    _split_device,
    iter_population,
    train_population,
    train_selected,
)
from repro_torch.sim.scenarios import DeviceStream, Federation, device_stream, make_federation
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.metrics import streaming_grouped_auc
from repro_torch.utils.seeds import stream_rng

log = get_logger("sim.population")


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    scenario: str = "dirichlet"
    n_devices: int = 256
    seed: int = 0
    mean_samples: int = 80
    dim: int = 16
    min_samples: int = 40
    scenario_params: Mapping = dataclasses.field(default_factory=dict)
    # training
    lam: float = 0.01
    engine: str = "bucketed"        # "bucketed" | "sharded" | "loop" | "streamed"
    mesh_shards: Optional[int] = None  # sim mesh size cap (None = the whole world)
    chunk_devices: int = 1024       # streamed engine: devices resident at once
    # selection + evaluation
    ks: Sequence[int] = (10,)
    strategies: Sequence[str] = ("cv", "data", "random")
    eval_device_cap: int = 128      # devices subsampled for ensemble eval
    eval_chunk: int = 8192
    # communication (repro_torch.comm)
    codec: str = "fp32"             # wire codec for model uploads
    budget_bytes: Optional[int] = None  # per-selection upload byte cap
    # server aggregation strategy (repro_torch.agg registry spec)
    aggregator: str = "mean"
    # server-side distillation (repro_torch.distill); None disables
    distill: Optional[DistillConfig] = None


@dataclasses.dataclass
class PopulationReport:
    scenario: str
    n_devices: int
    n_available: int
    n_eligible: int
    mean_local_auc: float
    mean_val_auc: float
    ensemble_auc: Dict[str, Dict[int, float]]  # strategy -> k -> mean AUC
    train_seconds: float
    devices_per_second: float
    eval_devices: int
    codec: str = "fp32"
    budget_bytes: Optional[int] = None
    comm: Dict[str, float] = dataclasses.field(default_factory=dict)
    # strategy -> k -> server round latency (slowest selected upload);
    # populated only when the federation carries a channel
    time_to_aggregate: Dict[str, Dict[int, float]] = dataclasses.field(default_factory=dict)
    ledger: Optional[CommLedger] = None
    # the distilled student as devices decode it, and its download codec
    student: Optional[object] = None
    student_codec: Optional[str] = None
    # which aggregator combined the members, and the best cell's server
    # scorer (what the round deploys when there is no distilled student)
    aggregator: str = "mean"
    server_scorer: Optional[object] = None

    @property
    def best(self) -> Dict[str, float]:
        """Best AUC per SELECTION strategy (the distilled student is
        reported under ``ensemble_auc["distilled"]`` but is not one)."""
        return {s: max(v.values()) for s, v in self.ensemble_auc.items()
                if v and s != "distilled"}


def _mean_auc(predict_fn, triples, chunk: int) -> float:
    """Stream (device id, test x, test y) triples through merge-able
    per-device AUC accumulators: ``round.score`` spans each block's
    scoring (host packing, copies and the kernel), ``round.auc`` the
    per-device AUCs."""
    tracer = current_tracer()

    def scored(x):
        with tracer.span("round.score", cat="round", rows=len(x)):
            return predict_fn(x)

    ga = streaming_grouped_auc(scored, triples, chunk=chunk)
    with tracer.span("round.auc", cat="round"):
        return ga.mean()


def _scenario_defaults(cfg: PopulationConfig) -> dict:
    """The ``scenario`` proxy source's defaults: THIS federation's
    generating process."""
    if cfg.distill.proxy != "scenario":
        return {}
    return {"scenario": cfg.scenario, "mean_samples": cfg.mean_samples,
            **dict(cfg.scenario_params)}


def run_population(
    cfg: PopulationConfig,
    federation: Optional[Union[Federation, DeviceStream]] = None,
    on_update: Optional[Callable[[GroupUpdate], None]] = None,
    device="cuda",
) -> PopulationReport:
    """Simulate one one-shot round at population scale on ``device``.

    Pass a prebuilt ``federation`` (a materialised ``Federation`` or a
    lazy ``DeviceStream`` — either works with any engine) to reuse data
    across engine modes; otherwise the scenario registry builds it from
    the config.

    ``engine="streamed"`` runs the fixed-host-memory round: devices are
    generated, trained and released in ``chunk_devices``-sized chunks,
    the server folds their scalar reports into ``ReportColumns``, and
    only the devices a selection actually picks are regenerated for
    upload and ensembling (``_run_streamed``). Its report equals the
    materialised round's in every field.

    ``engine="sharded"``, and ``engine="streamed"`` with ``mesh_shards``,
    train over the sim mesh (``sim.engine.make_shard_ctx``); every rank
    of the world calls this with the same config.
    """
    agg = get_aggregator(cfg.aggregator)
    dev = resolve_device(device)
    if cfg.engine == "streamed":
        if federation is None:
            stream = device_stream(
                cfg.scenario, n_devices=cfg.n_devices, seed=cfg.seed,
                mean_samples=cfg.mean_samples, dim=cfg.dim,
                min_samples=cfg.min_samples, **dict(cfg.scenario_params),
            )
        elif isinstance(federation, DeviceStream):
            stream = federation
        else:
            stream = _federation_as_stream(federation)
        return _run_streamed(cfg, stream, agg, dev, on_update)

    if isinstance(federation, DeviceStream):
        federation = federation.materialize()
    if federation is None:
        federation = make_federation(
            cfg.scenario, n_devices=cfg.n_devices, seed=cfg.seed,
            mean_samples=cfg.mean_samples, dim=cfg.dim,
            min_samples=cfg.min_samples, **dict(cfg.scenario_params),
        )
    ds = federation.dataset

    tracer = current_tracer()
    with tracer.span("round.train", cat="round", engine=cfg.engine,
                     devices=ds.n_devices):
        pop = train_population(
            ds, on_update=on_update, lam=cfg.lam, seed=cfg.seed,
            mode=cfg.engine, available=federation.available,
            shards=cfg.mesh_shards, device=dev,
        )
    outcomes, train_s = pop.outcomes, pop.seconds

    reports = pop.reports
    eligible = [r for r in reports if r.eligible]
    by_id = {o.device_id: o for o in outcomes}

    # --- communication: wire codec + typed byte ledger; only devices
    # that showed up report metadata ---
    with tracer.span("round.encode", cat="round", codec=cfg.codec):
        ex = ModelExchange({o.device_id: o.model for o in outcomes}, reports,
                           codec=cfg.codec, budget_bytes=cfg.budget_bytes,
                           device=dev)
    ledger = CommLedger()
    ex.record_metadata(ledger)

    # seeded, capped subsample of devices for ensemble evaluation
    rng = stream_rng(cfg.seed, "eval-subsample")
    eval_ids = [o.device_id for o in outcomes]
    if len(eval_ids) > cfg.eval_device_cap:
        eval_ids = sorted(rng.choice(eval_ids, cfg.eval_device_cap, replace=False))

    def mean_auc(predict_fn) -> float:
        return _mean_auc(
            predict_fn,
            ((i, by_id[i].splits["test"].x, by_id[i].splits["test"].y)
             for i in eval_ids),
            cfg.eval_chunk,
        )

    # aggregator extras are computed from the by-id outcomes and recorded
    # per cell next to the uploads
    def outcomes_for(want):
        return by_id

    ensemble_auc: Dict[str, Dict[int, float]] = {}
    cell_scorers: Dict[tuple, object] = {}
    time_to_aggregate: Dict[str, Dict[int, float]] = {}
    for strat in cfg.strategies:
        ensemble_auc[strat] = {}
        time_to_aggregate[strat] = {}
        with tracer.span("round.select", cat="round", strategy=strat):
            for k in cfg.ks:
                ids = ex.pick(strat, k, cfg.seed)
                if not ids:
                    continue
                ex.record_uploads(ledger, ids, f"upload_{strat}_k{k}")
                scorer = build_cell(agg, ex, ids, outcomes_for, ledger,
                                    f"agg_extra_{strat}_k{k}", cfg.seed)
                cell_scorers[(strat, k)] = scorer
                ensemble_auc[strat][k] = mean_auc(
                    partial(scorer.predict, chunk=cfg.eval_chunk)
                )
                if federation.channel is not None:
                    time_to_aggregate[strat][k] = (
                        federation.channel.time_to_aggregate(
                            {i: len(ex.upload(i)) for i in ids}
                        )
                    )
        log.info("%s/%s: %s", ds.name, strat, ensemble_auc[strat])

    # --- server-side distillation of the best selected ensemble ---
    student = None
    student_codec = None
    best_cells = {
        (s, k): auc for s, v in ensemble_auc.items() for k, auc in v.items()
    }
    if cfg.distill is not None and cfg.distill.proxy_size > 0 and best_cells:
        best_strat, best_k = max(best_cells, key=best_cells.get)
        teacher = cell_scorers[(best_strat, best_k)]
        dr = distill_round(teacher.predict, outcomes, cfg.distill, cfg.seed,
                           ex.codec, ledger, dim=cfg.dim,
                           default_proxy_params=_scenario_defaults(cfg), device=dev)
        student, student_codec = dr.student, dr.codec
        ensemble_auc["distilled"] = {
            best_k: mean_auc(partial(student.predict, chunk=cfg.eval_chunk))
        }
        log.info("%s/distilled (solver=%s, proxy=%s, codec=%s): %s",
                 ds.name, cfg.distill.solver, cfg.distill.proxy,
                 student_codec, ensemble_auc["distilled"])

    server_scorer = None
    if best_cells:
        bs, bk = max(best_cells, key=best_cells.get)
        server_scorer = cell_scorers.get((bs, bk))

    return PopulationReport(
        scenario=cfg.scenario,
        n_devices=ds.n_devices,
        n_available=federation.n_available,
        n_eligible=len(eligible),
        mean_local_auc=pop.mean_local_auc,
        mean_val_auc=float(np.mean([r.val_auc for r in reports])) if reports else 0.5,
        ensemble_auc=ensemble_auc,
        train_seconds=train_s,
        devices_per_second=len(outcomes) / max(train_s, 1e-9),
        eval_devices=len(eval_ids),
        codec=ex.codec,
        budget_bytes=cfg.budget_bytes,
        comm=ledger.summary(),
        time_to_aggregate=(
            time_to_aggregate if federation.channel is not None else {}
        ),
        ledger=ledger,
        student=student,
        student_codec=student_codec,
        aggregator=agg.spec,
        server_scorer=server_scorer,
    )


def _federation_as_stream(fed: Federation) -> DeviceStream:
    """View a materialised federation through the stream interface: the
    dataset serves devices by index, the availability mask becomes the
    per-device predicate, and the channel rides along for round-latency
    pricing (``ChannelModel`` and ``ChannelStream`` share
    ``time_to_aggregate``)."""
    avail = np.asarray(fed.available, bool)
    return dataclasses.replace(
        _dataset_as_stream(fed.dataset),
        available_fn=lambda i: bool(avail[i]),
        channel=fed.channel,
    )


def _run_streamed(
    cfg: PopulationConfig,
    stream: DeviceStream,
    agg,
    device,
    on_update: Optional[Callable[[GroupUpdate], None]] = None,
) -> PopulationReport:
    """The one-shot round with O(chunk) peak host memory.

    Pass 1 streams the whole population through the engine in bounded
    chunks, folding each device down to a few scalars (id, split
    counts, val AUC, eligibility, local test AUC) the moment it is
    trained — models and data die with their chunk. Everything after —
    selection, budget packing, ensemble eval, channel latency,
    distillation — runs off those columns plus on-demand regeneration
    of the O(k + eval_cap) devices actually touched
    (``engine.train_selected`` for models, ``_split_device`` for eval
    splits, the lazy proxy hooks for distillation). Every reported
    number matches the materialised round exactly.
    """
    ids_l: list = []
    n_train_l: list = []
    val_auc_l: list = []
    elig_l: list = []
    n_val_l: list = []
    local_auc_l: list = []

    tracer = current_tracer()
    elapsed = stopwatch()
    with tracer.span("round.train", cat="round", engine="streamed",
                     devices=stream.n_devices,
                     chunk_devices=cfg.chunk_devices):
        for update in iter_population(
            stream, lam=cfg.lam, seed=cfg.seed, mode="streamed",
            shards=cfg.mesh_shards, chunk_devices=cfg.chunk_devices, device=device,
        ):
            for o in update.outcomes:
                r = o.report
                ids_l.append(r.device_id)
                n_train_l.append(r.n_train)
                val_auc_l.append(r.val_auc)
                elig_l.append(r.eligible)
                n_val_l.append(o.splits["val"].n)
                local_auc_l.append(o.local_test_auc)
            if on_update is not None:
                on_update(update)
    train_s = elapsed()

    # outcomes arrive fallback-first within each chunk; id order (the
    # materialised round's canonical order) is restored here so every
    # downstream mean/sort/draw consumes identical sequences
    ids_a = np.asarray(ids_l, np.int64)
    order = np.argsort(ids_a)
    cols = ReportColumns(
        ids=ids_a[order],
        n_train=np.asarray(n_train_l, np.int64)[order],
        val_auc=np.asarray(val_auc_l, np.float64)[order],
        eligible=np.asarray(elig_l, bool)[order],
    )
    n_val = np.asarray(n_val_l, np.int64)[order]
    local_auc = np.asarray(local_auc_l, np.float64)[order]
    name = f"sim:{stream.spec.name}"
    log.info("streamed %d devices in %.2fs (chunk=%d)",
             len(cols), train_s, cfg.chunk_devices)

    # regeneration cache shared by the model provider and the extras: a
    # selected device is rebuilt once (train_selected) and its full
    # outcome reused for its upload and its aggregator extra
    regen: Dict[int, DeviceOutcome] = {}

    def _regenerate(want: Sequence[int]) -> None:
        missing = [int(i) for i in want if int(i) not in regen]
        if missing:
            regen.update(train_selected(stream, missing, lam=cfg.lam, seed=cfg.seed,
                                        shards=cfg.mesh_shards, device=device))

    def provider(want: Sequence[int]) -> Dict[int, object]:
        _regenerate(want)
        return {int(i): regen[int(i)].model for i in want}

    def outcomes_for(want: Sequence[int]) -> Dict[int, DeviceOutcome]:
        _regenerate(want)
        return regen

    with tracer.span("round.encode", cat="round", codec=cfg.codec):
        ex = StreamExchange(cols, provider, dim=stream.dim, codec=cfg.codec,
                            budget_bytes=cfg.budget_bytes, device=device)
    ledger = CommLedger(compact=True)
    ex.record_metadata(ledger)

    # extras are ledgered at the SHAPE price over the scalar columns,
    # equal to len(encode()), so this ledger equals the materialised one
    def extra_nbytes(device_id: int) -> int:
        p = int(np.searchsorted(cols.ids, device_id))
        shapes = agg.extra_shapes(int(cols.n_train[p]), int(n_val[p]), stream.dim)
        return agg_extra_wire_nbytes(shapes, ex.codec)

    # seeded, capped eval subsample — the same draw as the materialised
    # round; only these <= eval_device_cap devices' splits are rebuilt
    rng = stream_rng(cfg.seed, "eval-subsample")
    eval_ids = [int(i) for i in cols.ids]
    if len(eval_ids) > cfg.eval_device_cap:
        eval_ids = sorted(rng.choice(eval_ids, cfg.eval_device_cap, replace=False))
    eval_splits = {
        int(i): _split_device(int(i), stream.device(int(i)), cfg.seed)
        for i in eval_ids
    }

    def mean_auc(predict_fn) -> float:
        return _mean_auc(
            predict_fn,
            ((i, eval_splits[int(i)]["test"].x, eval_splits[int(i)]["test"].y)
             for i in eval_ids),
            cfg.eval_chunk,
        )

    channel = stream.channel
    ensemble_auc: Dict[str, Dict[int, float]] = {}
    cell_scorers: Dict[tuple, object] = {}
    time_to_aggregate: Dict[str, Dict[int, float]] = {}
    for strat in cfg.strategies:
        ensemble_auc[strat] = {}
        time_to_aggregate[strat] = {}
        with tracer.span("round.select", cat="round", strategy=strat):
            for k in cfg.ks:
                ids = ex.pick(strat, k, cfg.seed)
                if not ids:
                    continue
                ex.record_uploads(ledger, ids, f"upload_{strat}_k{k}")
                scorer = build_cell(agg, ex, ids, outcomes_for, ledger,
                                    f"agg_extra_{strat}_k{k}", cfg.seed,
                                    extra_nbytes=extra_nbytes)
                cell_scorers[(strat, k)] = scorer
                ensemble_auc[strat][k] = mean_auc(
                    partial(scorer.predict, chunk=cfg.eval_chunk)
                )
                if channel is not None:
                    time_to_aggregate[strat][k] = channel.time_to_aggregate(
                        {i: len(ex.upload(i)) for i in ids}
                    )
        log.info("%s/%s: %s", name, strat, ensemble_auc[strat])

    student = None
    student_codec = None
    best_cells = {
        (s, k): auc for s, v in ensemble_auc.items() for k, auc in v.items()
    }
    if cfg.distill is not None and cfg.distill.proxy_size > 0 and best_cells:
        best_strat, best_k = max(best_cells, key=best_cells.get)
        teacher = cell_scorers[(best_strat, best_k)]

        # lazy proxy hooks: per-device split row counts in id order +
        # on-demand row fetch (see distill.proxy.ProxyContext)
        split_counts = {"train": cols.n_train, "val": n_val}

        def fetch_split(split: str, positions: Sequence[int]) -> Dict[int, np.ndarray]:
            want = {int(p): int(cols.ids[int(p)]) for p in positions}
            rebuilt = {
                i: _split_device(i, stream.device(i), cfg.seed)
                for i in sorted(set(want.values()))
            }
            return {p: rebuilt[i][split].x for p, i in want.items()}

        dr = distill_round(teacher.predict, None, cfg.distill, cfg.seed,
                           ex.codec, ledger, dim=cfg.dim,
                           default_proxy_params=_scenario_defaults(cfg),
                           split_counts=split_counts, fetch_split=fetch_split,
                           device=device)
        student, student_codec = dr.student, dr.codec
        ensemble_auc["distilled"] = {
            best_k: mean_auc(partial(student.predict, chunk=cfg.eval_chunk))
        }
        log.info("%s/distilled (solver=%s, proxy=%s, codec=%s): %s",
                 name, cfg.distill.solver, cfg.distill.proxy,
                 student_codec, ensemble_auc["distilled"])

    server_scorer = None
    if best_cells:
        bs, bk = max(best_cells, key=best_cells.get)
        server_scorer = cell_scorers.get((bs, bk))

    return PopulationReport(
        scenario=cfg.scenario,
        n_devices=stream.n_devices,
        n_available=len(cols),
        n_eligible=int(cols.eligible.sum()),
        mean_local_auc=float(np.mean(local_auc)) if len(cols) else 0.5,
        mean_val_auc=float(np.mean(cols.val_auc)) if len(cols) else 0.5,
        ensemble_auc=ensemble_auc,
        train_seconds=train_s,
        devices_per_second=len(cols) / max(train_s, 1e-9),
        eval_devices=len(eval_ids),
        codec=ex.codec,
        budget_bytes=cfg.budget_bytes,
        comm=ledger.summary(),
        time_to_aggregate=time_to_aggregate if channel is not None else {},
        ledger=ledger,
        student=student,
        student_codec=student_codec,
        aggregator=agg.spec,
        server_scorer=server_scorer,
    )
