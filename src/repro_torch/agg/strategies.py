"""The built-in aggregator zoo: mean / fisher / reweight / feature_stats.

Port of ``repro.agg.strategies``. Each strategy documents (a) its
device-side extra and what it costs on the wire, and (b) how the server
turns members + extras into a scorer. Extras are host numpy arithmetic on
the device's own splits and scores, as in the reference; the server's
scoring (reweight's per-member pool scores, the weighted ensembles, the
linear scorers) runs on the members' or the round's device. Degenerate
inputs (empty validation pools, all-zero Fisher masses, single-class
statistics) fall back to the paper's plain mean — never NaN.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.agg.base import Aggregator, WeightedEnsemble, aggregator
from repro_torch.comm.wire import AggExtra
from repro_torch.core.averaging import LinearSVM, normalize_weights
from repro_torch.core.ensemble import Ensemble
from repro_torch.utils.metrics import roc_auc
from repro_torch.utils.seeds import stream_rng


def _uniform(k: int) -> np.ndarray:
    return np.full(k, 1.0 / k, np.float64)


def _sigmoid(s: np.ndarray) -> np.ndarray:
    s = np.asarray(s, np.float64)
    out = np.empty_like(s)
    pos = s >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-s[pos]))
    e = np.exp(s[~pos])
    out[~pos] = e / (1.0 + e)
    return out


@aggregator("mean")
class MeanAggregator(Aggregator):
    """The paper's server: F_k(x) = mean_t f_t(x), the plain ``Ensemble``
    of the decoded members. No extras."""

    def build(self, members: Sequence, extras: Sequence, seed: int, device="cuda"):
        return Ensemble(list(members))


def fisher_fuse_linear(
    models: Sequence[LinearSVM],
    fishers: Sequence[np.ndarray],
    eps: float = 1e-12,
) -> LinearSVM:
    """Diagonal-Fisher parameter fusion for homogeneous linear models:
    per coordinate ``w[j] = sum_i F_i[j] w_i[j] / sum_i F_i[j]``, the
    unweighted mean on coordinates with no Fisher mass; the bias fuses
    by scalar Fisher mass (all-zero masses -> uniform). The fused model
    scores on the first member's device."""
    F = np.stack([np.asarray(f, np.float64) for f in fishers])
    W = np.stack([np.asarray(m.w, np.float64) for m in models])
    if F.shape != W.shape:
        raise ValueError(f"fisher/weight shape mismatch: {F.shape} vs {W.shape}")
    denom = F.sum(axis=0)
    fused = np.where(denom > eps, (F * W).sum(axis=0) / np.maximum(denom, eps),
                     W.mean(axis=0))
    try:
        mb = normalize_weights(F.sum(axis=1), len(models))
    except ValueError:
        mb = _uniform(len(models))
    b = float(mb @ np.asarray([m.b for m in models], np.float64))
    return LinearSVM(w=fused.astype(np.float32), b=b, device=models[0].device)


@aggregator("fisher")
class FisherAggregator(Aggregator):
    """FedFisher-style fusion weighted by empirical diagonal Fisher.

    Extra: ``fisher`` (d,) — F = sum_v p_v (1 - p_v) x_v^2 over the
    device's validation split, p_v = sigmoid(f(x_v)). d floats a member.

    Server: homogeneous ``LinearSVM`` members fuse per coordinate
    (``fisher_fuse_linear``); kernel or mixed members combine in score
    space, each weighted by its total Fisher mass on the simplex. All-zero
    masses fall back to uniform == mean.
    """

    needs_extra = True

    def device_extra(self, outcome, seed: int) -> AggExtra:
        val = outcome.splits["val"]
        p = _sigmoid(outcome.val_scores)
        curv = p * (1.0 - p)                      # (n_v,)
        x = np.asarray(val.x, np.float64)
        fisher = (curv[:, None] * x * x).sum(axis=0)  # (d,)
        return AggExtra({"fisher": fisher.astype(np.float32)})

    def extra_shapes(self, n_train: int, n_val: int, dim: int) -> Dict[str, Tuple[int, ...]]:
        return {"fisher": (dim,)}

    def build(self, members: Sequence, extras: Sequence, seed: int, device="cuda"):
        fishers = [np.asarray(e.arrays["fisher"], np.float64) for e in extras]
        if members and all(isinstance(m, LinearSVM) for m in members):
            return fisher_fuse_linear(list(members), fishers)
        masses = np.asarray([f.sum() for f in fishers], np.float64)
        try:
            w = normalize_weights(masses, len(members))
        except ValueError:
            w = _uniform(len(members))
        return WeightedEnsemble(list(members), w)


@aggregator("reweight")
class ReweightAggregator(Aggregator):
    """Validation-driven member re-weighting on the simplex (Allouah et
    al. 2024): selection still picks WHICH k members upload; this
    strategy re-weights them by how they score on a small pooled
    validation set.

    Extra: up to ``MAX_ROWS`` seeded validation rows a member — ``vx``
    (n_c, d) + ``vy`` (n_c,) — drawn via ``utils.seeds`` streams.

    Server: pools the rows, scores every decoded member on the pool (one
    ``predict`` each, on the member's device), and sets weights =
    softmax(T * (auc_i - max auc)); ``"reweight:T"`` selects T (default
    20). A degenerate pool (empty or single-class) or equal AUCs yields
    uniform weights, which ``WeightedEnsemble`` short-circuits to the
    bitwise mean.
    """

    needs_extra = True
    has_param = True
    MAX_ROWS = 32

    @property
    def temperature(self) -> float:
        return 20.0 if self.param is None else float(self.param)

    def device_extra(self, outcome, seed: int) -> AggExtra:
        val = outcome.splits["val"]
        n = int(val.n)
        take = min(n, self.MAX_ROWS)
        if n > take:
            rng = stream_rng(seed, "agg-reweight", outcome.device_id)
            idx = np.sort(rng.choice(n, take, replace=False))
        else:
            idx = np.arange(n)
        return AggExtra({
            "vx": np.asarray(val.x, np.float32)[idx],
            "vy": np.asarray(val.y, np.float32)[idx],
        })

    def extra_shapes(self, n_train: int, n_val: int, dim: int) -> Dict[str, Tuple[int, ...]]:
        n_c = min(int(n_val), self.MAX_ROWS)
        return {"vx": (n_c, dim), "vy": (n_c,)}

    def build(self, members: Sequence, extras: Sequence, seed: int, device="cuda"):
        k = len(members)
        pool_x = np.concatenate([np.asarray(e.arrays["vx"], np.float32) for e in extras])
        pool_y = np.concatenate([np.asarray(e.arrays["vy"], np.float32) for e in extras])
        if len(pool_y) == 0 or len(np.unique(pool_y > 0)) < 2:
            return WeightedEnsemble(list(members), _uniform(k))
        aucs = np.asarray(
            [roc_auc(pool_y, m.predict(pool_x)) for m in members], np.float64
        )
        z = np.exp(self.temperature * (aucs - aucs.max()))
        return WeightedEnsemble(list(members), z / z.sum())


@aggregator("feature_stats")
class FeatureStatsAggregator(Aggregator):
    """Global feature-statistics aggregation (Guan et al. 2025 flavour):
    devices upload per-class feature moments; the server pools them into
    global class statistics and fits a closed-form diagonal-LDA linear
    scorer, on ``device`` — no model upload is consulted.

    Extra a member: ``count`` (2,), ``fsum`` (2, d), ``fsq`` (2, d) —
    per-class row count, feature sums and squared-feature sums over the
    device's train split (class 0 = y <= 0, class 1 = y > 0).

    Server: w = (mu+ - mu-) / (pooled_var + eps), b = -w . (mu+ + mu-) / 2,
    a ``LinearSVM``. A missing class yields the zero scorer (AUC 0.5).
    """

    needs_extra = True
    EPS = 1e-6

    def device_extra(self, outcome, seed: int) -> AggExtra:
        tr = outcome.splits["train"]
        x = np.asarray(tr.x, np.float64)
        y = np.asarray(tr.y)
        d = x.shape[1]
        count = np.zeros(2, np.float64)
        fsum = np.zeros((2, d), np.float64)
        fsq = np.zeros((2, d), np.float64)
        for c, mask in enumerate((y <= 0, y > 0)):
            count[c] = float(mask.sum())
            fsum[c] = x[mask].sum(axis=0)
            fsq[c] = (x[mask] ** 2).sum(axis=0)
        return AggExtra({
            "count": count.astype(np.float32),
            "fsum": fsum.astype(np.float32),
            "fsq": fsq.astype(np.float32),
        })

    def extra_shapes(self, n_train: int, n_val: int, dim: int) -> Dict[str, Tuple[int, ...]]:
        return {"count": (2,), "fsum": (2, dim), "fsq": (2, dim)}

    def build(self, members: Sequence, extras: Sequence, seed: int, device="cuda"):
        count = np.sum([np.asarray(e.arrays["count"], np.float64) for e in extras], axis=0)
        fsum = np.sum([np.asarray(e.arrays["fsum"], np.float64) for e in extras], axis=0)
        fsq = np.sum([np.asarray(e.arrays["fsq"], np.float64) for e in extras], axis=0)
        d = fsum.shape[1]
        if count.min() < 1.0:
            return LinearSVM(w=np.zeros(d, np.float32), b=0.0, device=str(device))
        mu = fsum / count[:, None]                       # (2, d)
        var = np.maximum(fsq / count[:, None] - mu ** 2, 0.0)
        pooled = (count[:, None] * var).sum(axis=0) / count.sum()
        w = (mu[1] - mu[0]) / (pooled + self.EPS)
        b = -0.5 * float(w @ (mu[1] + mu[0]))
        return LinearSVM(w=w.astype(np.float32), b=b, device=str(device))
