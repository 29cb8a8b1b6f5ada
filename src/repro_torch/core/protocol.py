"""One-shot federated learning protocol simulation (the paper, end to end).

Port of ``repro.core.protocol.run_protocol`` with distillation off:
  1. every device splits its data 50/40/10 (train/test/val);
  2. devices train local RBF-SVMs to completion (data-deficient devices
     fall back to constant classifiers — the paper's local baseline);
  3. devices report scalar metadata (n_train, val AUC);
  4. the server selects k models per strategy (cv / data / random) and
     receives them — the SINGLE round of communication;
  5. ensembles are evaluated on every device's test split (mean AUC).

Communication is accounted on a ``CommLedger`` at exact fp32 wire
sizes; ensembles are evaluated on the DECODED models. Evaluation
streams every device's test split through the fused ``ensemble_score``
kernel in ``eval_chunk``-row blocks, folding scores into per-device AUC
accumulators.

Everything runs on ``device`` (default the card; ``"cpu"`` runs the
kernels' plain versions). Options outside the ported slice raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.agg import build_cell, get_aggregator
from repro_torch.comm.exchange import ModelExchange
from repro_torch.comm.ledger import CommLedger
from repro_torch.core.ensemble import Ensemble
from repro_torch.core.svm import train_svm
from repro_torch.data.federated import DeviceData, FederatedDataset
from repro_torch.data.partition import pool_devices
from repro_torch.obs.trace import current_tracer
from repro_torch.sim.engine import train_population
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.metrics import roc_auc, streaming_grouped_auc

log = get_logger("protocol")


@dataclasses.dataclass
class ProtocolResult:
    dataset: str
    local_mean_auc: float
    ideal_mean_auc: float
    ensemble_auc: Dict[str, Dict[int, float]]  # strategy -> k -> mean AUC
    full_ensemble_auc: float
    best: Dict[str, float]  # strategy -> best-k mean AUC
    comm_bytes: Dict[str, float]  # ledger per-tag byte totals
    per_device: Dict[str, np.ndarray]
    ledger: Optional[CommLedger] = None
    codec: str = "fp32"
    aggregator: str = "mean"
    # the best cell's server scorer (what the round deploys)
    server_scorer: Optional[object] = None

    def relative_gain_over_local(self) -> float:
        b = max(self.best.values())
        return (b - self.local_mean_auc) / max(self.local_mean_auc, 1e-9)

    def fraction_of_ideal(self) -> float:
        return max(self.best.values()) / max(self.ideal_mean_auc, 1e-9)


def _mean_auc_over_devices(devices: Sequence, scores_fn, chunk: int = 8192) -> tuple:
    """scores_fn(X_block) -> scores for one (b, d) query block, streamed
    over every device's test split into per-device AUC accumulators.

    Two spans split the pass: ``round.score`` around each block's scoring
    (host packing, copies and the kernel, ending in the copy back) and
    ``round.auc`` around the per-device AUC computation; the rest of the
    pass is the host's block assembly and accumulator updates."""
    tracer = current_tracer()

    def scored(x):
        with tracer.span("round.score", cat="round", rows=len(x)):
            return scores_fn(x)

    ga = streaming_grouped_auc(
        scored,
        ((d.device_id, d.splits["test"].x, d.splits["test"].y) for d in devices),
        chunk=chunk,
    )
    with tracer.span("round.auc", cat="round", devices=len(devices)):
        per = ga.compute()
    aucs = np.array([per[d.device_id] for d in devices])
    return float(np.mean(aucs)), aucs


def _check_slice(engine, codec, budget_bytes, distill, distill_proxy) -> None:
    if engine in ("sharded", "streamed"):
        item = 15 if engine == "sharded" else 9
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet (ROADMAP queue 1 item {item})")
    if engine not in ("bucketed", "loop"):
        raise ValueError(f"unknown engine mode {engine!r}")
    if codec != "fp32":
        raise NotImplementedError(
            f"codec={codec!r} is not ported yet (ROADMAP queue 1 item 8)")
    if budget_bytes is not None:
        raise NotImplementedError(
            "budget_bytes is not ported yet (ROADMAP queue 1 item 8)")
    if distill is not None or distill_proxy > 0:
        raise NotImplementedError(
            "distillation is not ported yet (ROADMAP queue 1 item 7)")


def run_protocol(
    dataset: FederatedDataset,
    ks: Sequence[int] = (1, 10, 50, 100),
    strategies: Sequence[str] = ("cv", "data", "random"),
    lam: float = 0.01,
    seed: int = 0,
    ideal_cap: int = 2000,
    random_trials: int = 5,
    distill_proxy: int = 0,
    eval_chunk: int = 8192,
    engine: str = "bucketed",
    codec: str = "fp32",
    budget_bytes: Optional[int] = None,
    distill: Optional[object] = None,
    aggregator: str = "mean",
    device="cuda",
) -> ProtocolResult:
    _check_slice(engine, codec, budget_bytes, distill, distill_proxy)
    agg = get_aggregator(aggregator)
    dev = resolve_device(device)

    tracer = current_tracer()
    m = dataset.n_devices
    with tracer.span("round.train", cat="round", devices=m, engine=engine):
        devices = train_population(dataset, lam=lam, seed=seed, mode=engine,
                                   device=dev).outcomes
    reports = [d.report for d in devices]
    eligible_ids = [r.device_id for r in reports if r.eligible]

    # --- the wire: priced uploads, decoded models, metadata on ledger ---
    with tracer.span("round.encode", cat="round", codec=codec):
        ex = ModelExchange({d.device_id: d.model for d in devices}, reports,
                           codec=codec, device=dev)
    log.info("trained %d local models (%s, engine=%s, codec=%s)",
             m, dataset.name, engine, ex.codec)
    ledger = CommLedger()
    ex.record_metadata(ledger)

    # --- local baseline (paper Fig. 1 "local") ---
    local_aucs = [
        roc_auc(d.splits["test"].y, d.local_test_scores) for d in devices
    ]
    local_mean = float(np.mean(local_aucs))

    # --- unattainable ideal: pooled-data SVM (subsampled for tractability) ---
    with tracer.span("round.ideal", cat="round", cap=ideal_cap):
        pooled = pool_devices([d.splits["train"] for d in devices])
        rng = np.random.default_rng(seed)
        if len(pooled.y) > ideal_cap:
            idx = rng.choice(len(pooled.y), ideal_cap, replace=False)
            pooled = DeviceData(pooled.x[idx], pooled.y[idx])
        ideal_model = train_svm(pooled.x, pooled.y, lam=lam, device=dev)
        ideal_mean, ideal_aucs = _mean_auc_over_devices(
            devices, ideal_model.predict)

    # --- aggregated cells per strategy and k (DECODED models) ---
    ensemble_auc: Dict[str, Dict[int, float]] = {}
    cell_scorers: Dict[tuple, object] = {}
    for strat in strategies:
        ensemble_auc[strat] = {}
        with tracer.span("round.select", cat="round", strategy=strat):
            for k in ks:
                if strat == "random":
                    trials = []
                    for t in range(random_trials):
                        tids = ex.pick("random", k, seed + 17 * t)
                        if not tids:
                            continue
                        scorer = build_cell(agg, ex, tids, seed)
                        auc, _ = _mean_auc_over_devices(
                            devices, partial(scorer.predict, chunk=eval_chunk), eval_chunk)
                        trials.append(auc)
                    if trials:
                        ensemble_auc[strat][k] = float(np.mean(trials))
                    ids = ex.pick("random", k, seed)
                    if ids:
                        cell_scorers[(strat, k)] = build_cell(agg, ex, ids, seed)
                else:
                    ids = ex.pick(strat, k, seed)
                    if not ids:
                        continue
                    scorer = build_cell(agg, ex, ids, seed)
                    cell_scorers[(strat, k)] = scorer
                    auc, _ = _mean_auc_over_devices(
                        devices, partial(scorer.predict, chunk=eval_chunk), eval_chunk)
                    ensemble_auc[strat][k] = auc
                ex.record_uploads(ledger, ids, f"upload_{strat}_k{k}")
        log.info("%s/%s: %s", dataset.name, strat, ensemble_auc[strat])

    # --- full ensemble of all eligible devices ---
    with tracer.span("round.eval", cat="round", ensemble=len(eligible_ids)):
        full_ens = Ensemble([ex.received(i) for i in eligible_ids])
        full_auc, full_aucs = _mean_auc_over_devices(
            devices, partial(full_ens.predict, chunk=eval_chunk), eval_chunk)
    ex.record_uploads(ledger, eligible_ids, "upload_full")

    best = {s: max(v.values()) for s, v in ensemble_auc.items() if v}
    per_device = {
        "local": np.array(local_aucs),
        "ideal": ideal_aucs,
        "full_ensemble": full_aucs,
    }
    server_scorer = None
    if best:
        bs = max(best, key=best.get)
        bk = max(ensemble_auc[bs], key=ensemble_auc[bs].get)
        server_scorer = cell_scorers.get((bs, bk))

    return ProtocolResult(
        dataset=dataset.name,
        local_mean_auc=local_mean,
        ideal_mean_auc=ideal_mean,
        ensemble_auc=ensemble_auc,
        full_ensemble_auc=full_auc,
        best=best,
        comm_bytes=ledger.as_dict(),
        per_device=per_device,
        ledger=ledger,
        codec=ex.codec,
        aggregator=agg.spec,
        server_scorer=server_scorer,
    )
