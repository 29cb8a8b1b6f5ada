"""Cohort-personalized one-shot FL — the paper's future-work item (1):

    "identifying 'cohorts' of devices with similar local data
     distributions (e.g. devices from the same geographic region), which
     would allow us to learn ensembles that we could personalize for
     each device."

Port of ``repro.core.cohorts``. The server embeds every uploaded local
model by its prediction vector on a small shared probe set (each
member's ``predict``, on its device); k-means over the embeddings (host
numpy, as the reference's) yields cohorts; each device is served the
ensemble of its own cohort. Still ONE round: probes are server-side, no
extra device communication.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.ensemble import Ensemble
from repro_torch.utils.metrics import roc_auc


def prediction_embeddings(models: Sequence, probe_x: np.ndarray) -> np.ndarray:
    """(m, l) matrix of model scores on the shared probe set."""
    embs = np.stack([np.asarray(m.predict(probe_x), np.float32) for m in models])
    # scale-normalize so clustering sees decision geometry, not margins
    norms = np.linalg.norm(embs, axis=1, keepdims=True)
    return embs / np.maximum(norms, 1e-8)


def kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    """Plain k-means; returns labels (n,)."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=min(k, len(x)), replace=False)]
    labels = np.zeros(len(x), int)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new_labels = d.argmin(1)
        if (new_labels == labels).all():
            break
        labels = new_labels
        for c in range(len(centers)):
            mask = labels == c
            if mask.any():
                centers[c] = x[mask].mean(0)
    return labels


@dataclasses.dataclass
class CohortResult:
    labels: np.ndarray  # device -> cohort
    cohort_auc: float  # mean AUC, each device served its cohort ensemble
    global_auc: float  # mean AUC, one global ensemble for everyone
    per_device_cohort: np.ndarray
    per_device_global: np.ndarray


def run_cohort_protocol(
    device_states,  # List[sim.engine.DeviceOutcome] with trained models
    n_cohorts: int,
    probe_x: np.ndarray,
    seed: int = 0,
) -> CohortResult:
    eligible = [d for d in device_states if d.report.eligible]
    models = [d.model for d in eligible]
    embs = prediction_embeddings(models, probe_x)
    labels_eligible = kmeans(embs, n_cohorts, seed=seed)
    ensembles: Dict[int, Ensemble] = {}
    for c in range(n_cohorts):
        members = [m for m, l in zip(models, labels_eligible) if l == c]
        if members:
            ensembles[c] = Ensemble(members)
    global_ens = Ensemble(models)

    # assign EVERY device (incl. ineligible) to its nearest cohort by the
    # same probe embedding of its local (possibly constant) model
    all_embs = prediction_embeddings([d.model for d in device_states], probe_x)
    centers = np.stack([
        embs[labels_eligible == c].mean(0) if (labels_eligible == c).any() else np.zeros(embs.shape[1])
        for c in range(n_cohorts)
    ])
    all_labels = ((all_embs[:, None, :] - centers[None]) ** 2).sum(-1).argmin(1)

    coh_aucs, glob_aucs = [], []
    for d, c in zip(device_states, all_labels):
        te = d.splits["test"]
        ens = ensembles.get(int(c), global_ens)
        coh_aucs.append(roc_auc(te.y, ens.predict(te.x)))
        glob_aucs.append(roc_auc(te.y, global_ens.predict(te.x)))
    return CohortResult(
        labels=all_labels,
        cohort_auc=float(np.mean(coh_aucs)),
        global_auc=float(np.mean(glob_aucs)),
        per_device_cohort=np.array(coh_aucs),
        per_device_global=np.array(glob_aucs),
    )
