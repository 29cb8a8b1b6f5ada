"""Evaluation metrics.

The paper evaluates with ROC-AUC ("mean AUC across devices"). We
implement AUC via the Mann-Whitney U rank statistic, which is exact and
O(n log n); ties handled with midranks (matches sklearn.roc_auc_score).

Population-scale evaluation goes through the STREAMING accumulators
(`StreamingAUC` / `GroupedAUC` / `streaming_grouped_auc`): query
features are consumed one chunk at a time (the concatenated (N, d)
test matrix never materializes) and scores fold into merge-able
per-group partial states, so eval composes across micro-batches,
engine shards, and processes. Partial-state size: exact mode (the
default) retains the streamed scores/labels as rank-statistic state —
O(total samples) scalars, but never the (ensembles x samples) score
matrix and never more than one chunk of features; ``bins=B`` mode is
genuinely fixed-memory (O(B) histograms) at a bounded, documented
accuracy cost. The protocol round (`core.protocol`) routes through
these.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def _midranks(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), dtype=np.float64)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def roc_auc(labels, scores) -> float:
    """ROC-AUC of binary ``labels`` (in {0,1} or {-1,+1}) given real scores.

    Degenerate devices (single-class labels) return 0.5, matching the
    convention used for the paper's constant classifiers.
    """
    labels = np.asarray(labels).astype(np.float64).ravel()
    scores = np.asarray(scores).astype(np.float64).ravel()
    labels = (labels > 0).astype(np.float64)  # {-1,+1} -> {0,1}
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    ranks = _midranks(scores)
    u = ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


# ----------------------------------------------------------------------
# streaming / merge-able evaluation state
# ----------------------------------------------------------------------

class StreamingAUC:
    """Merge-able ROC-AUC accumulator.

    Exact mode (default): partial state is the running (scores, labels)
    multiset — O(1) work per update, O(n) state — and ``compute()`` is
    the midrank Mann-Whitney statistic of the union. Because AUC is a
    rank statistic, the result is EXACTLY ``roc_auc`` of the
    concatenated batch no matter how updates were split, permuted, or
    merged across accumulators (the property the tests pin to 1e-9).

    Fixed-memory mode (``bins=B``): per-class histograms over a fixed
    score ``lo..hi`` grid — O(B) state regardless of stream length,
    out-of-range scores clip into the edge bins. Scores sharing a bin
    are treated as midrank ties, so the approximation error is bounded
    by half the cross-class pair mass that collides in a bin (exact in
    the no-collision limit). Merging requires identical binning.
    """

    __slots__ = ("bins", "lo", "hi", "_scores", "_labels", "_hist")

    def __init__(self, bins: Optional[int] = None,
                 score_range: Tuple[float, float] = (-4.0, 4.0)):
        self.bins = bins
        self.lo, self.hi = float(score_range[0]), float(score_range[1])
        if bins is None:
            self._scores: list = []
            self._labels: list = []
            self._hist = None
        else:
            assert bins >= 2 and self.hi > self.lo
            self._hist = np.zeros((2, bins), np.int64)  # [neg, pos] counts

    @property
    def count(self) -> int:
        if self.bins is None:
            return int(sum(len(a) for a in self._labels))
        return int(self._hist.sum())

    def update(self, labels, scores) -> "StreamingAUC":
        labels = (np.asarray(labels).astype(np.float64).ravel() > 0)
        scores = np.asarray(scores).astype(np.float64).ravel()
        assert labels.shape == scores.shape, (labels.shape, scores.shape)
        if self.bins is None:
            self._scores.append(scores)
            self._labels.append(labels)
        else:
            idx = np.clip(
                ((scores - self.lo) / (self.hi - self.lo) * self.bins).astype(int),
                0, self.bins - 1,
            )
            for cls in (0, 1):
                self._hist[cls] += np.bincount(
                    idx[labels == bool(cls)], minlength=self.bins
                )
        return self

    def merge(self, other: "StreamingAUC") -> "StreamingAUC":
        """Fold another accumulator's partial state into this one."""
        if self.bins != other.bins or (
            self.bins is not None and (self.lo, self.hi) != (other.lo, other.hi)
        ):
            raise ValueError("cannot merge accumulators with different binning")
        if self.bins is None:
            self._scores.extend(other._scores)
            self._labels.extend(other._labels)
        else:
            self._hist += other._hist
        return self

    def compute(self) -> float:
        """AUC of everything streamed so far (0.5 when degenerate)."""
        if self.bins is None:
            if not self._labels:
                return 0.5
            return roc_auc(np.concatenate(self._labels),
                           np.concatenate(self._scores))
        neg, pos = self._hist[0].astype(np.float64), self._hist[1].astype(np.float64)
        n_pos, n_neg = pos.sum(), neg.sum()
        if n_pos == 0 or n_neg == 0:
            return 0.5
        neg_below = np.cumsum(neg) - neg  # negatives strictly below each bin
        u = float(np.sum(pos * (neg_below + 0.5 * neg)))  # in-bin = midrank tie
        return u / (n_pos * n_neg)


class GroupedAUC:
    """Mean-of-per-group AUC accumulator (the paper's headline metric).

    One ``StreamingAUC`` per group key; partial states merge group-wise,
    so per-device evaluation composes across engine shards, micro-
    batches, and processes without ever holding more than one chunk of
    scores.
    """

    def __init__(self, bins: Optional[int] = None,
                 score_range: Tuple[float, float] = (-4.0, 4.0)):
        self._bins = bins
        self._range = score_range
        self.groups: Dict[object, StreamingAUC] = {}

    def update(self, group, labels, scores) -> "GroupedAUC":
        acc = self.groups.get(group)
        if acc is None:
            acc = self.groups[group] = StreamingAUC(self._bins, self._range)
        acc.update(labels, scores)
        return self

    def merge(self, other: "GroupedAUC") -> "GroupedAUC":
        """Fold ``other``'s partial states into this accumulator.

        States are COPIED in, never aliased: ``other`` may keep
        accumulating after the barrier without corrupting the merge."""
        for key, acc in other.groups.items():
            mine = self.groups.get(key)
            if mine is None:
                mine = self.groups[key] = StreamingAUC(acc.bins,
                                                       (acc.lo, acc.hi))
            mine.merge(acc)
        return self

    def compute(self) -> Dict[object, float]:
        """group -> AUC, in first-seen group order."""
        return {key: acc.compute() for key, acc in self.groups.items()}

    def mean(self) -> float:
        if not self.groups:
            return 0.5
        return float(np.mean(list(self.compute().values())))


def _pad_pow2_rows(x: np.ndarray, lo: int = 8) -> np.ndarray:
    """Pad query rows to the next power of two (same compile-shape
    policy as ``core.ensemble.chunked_bucket_predict`` — kept local to
    avoid a metrics -> ensemble import cycle)."""
    b = len(x)
    bp = max(lo, 1 << (b - 1).bit_length())
    return np.pad(x, ((0, bp - b), (0, 0))) if bp != b else x


def streaming_grouped_auc(
    score_fn,
    groups: Iterable[Tuple[object, np.ndarray, np.ndarray]],
    *,
    chunk: int = 8192,
    acc: Optional[GroupedAUC] = None,
) -> GroupedAUC:
    """Drive ``score_fn`` over (group, x, y) triples in fixed-size query
    chunks, folding scores straight into a ``GroupedAUC``.

    ``score_fn`` takes ONE (b, d) fp32 block and returns (b,) scores —
    the ``EnsembleScorer`` / ``StackedEnsemble.score`` contract. Rows
    from consecutive groups are packed into exactly ``chunk``-sized
    blocks (the final partial block pads to a power of two), so kernel
    utilization matches the materializing path it replaces while peak
    host memory stays O(chunk), independent of population size.
    """
    acc = GroupedAUC() if acc is None else acc
    parts: list = []   # feature slices (views) of the block being built
    segs: list = []    # (group, label-slice) per part
    filled = 0

    def flush() -> None:
        nonlocal parts, segs, filled
        if not filled:
            return
        x = np.concatenate(parts).astype(np.float32, copy=False)
        scores = np.asarray(score_fn(_pad_pow2_rows(x)))[: len(x)]
        off = 0
        for group, y in segs:
            acc.update(group, y, scores[off : off + len(y)])
            off += len(y)
        parts, segs, filled = [], [], 0

    for group, x, y in groups:
        x = np.asarray(x)
        y = np.asarray(y)
        assert len(x) == len(y)
        if len(x) == 0:
            acc.update(group, y, np.zeros(0, np.float32))
            continue
        # walk the group in slices that top up exact chunk-row blocks;
        # every row is copied exactly once (into the block concat) no
        # matter how large one group is relative to the chunk
        off = 0
        while off < len(x):
            take = min(chunk - filled, len(x) - off)
            parts.append(x[off : off + take])
            segs.append((group, y[off : off + take]))
            filled += take
            off += take
            if filled == chunk:
                flush()
    flush()
    return acc



def accuracy(labels, scores) -> float:
    labels = np.asarray(labels).ravel()
    preds = np.sign(np.asarray(scores).ravel())
    preds = np.where(preds == 0, 1, preds)
    labels = np.where(labels > 0, 1, -1)
    return float((preds == labels).mean())


def binary_cross_entropy(labels, logits) -> torch.Tensor:
    """Mean BCE in fp32 as a 0-d tensor; labels in {-1,+1} or {0,1}."""
    logits = torch.as_tensor(logits).float()
    labels01 = (torch.as_tensor(labels, device=logits.device) > 0).float()
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels01 + torch.log1p(torch.exp(-torch.abs(logits)))
    )
