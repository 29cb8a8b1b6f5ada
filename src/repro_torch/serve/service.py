"""EnsembleScorer — the SVM-ensemble scoring service.

Port of ``repro.serve.service``. Bridges the data plane (a packed
``StackedEnsemble`` and the fused ``ensemble_score`` kernel, see
``repro_torch.core.ensemble``) to the control plane
(``MicroBatchScheduler``): packing happens ONCE at construction, on the
scorer's device, and each scheduler batch costs exactly one scorer call
at a bucket shape. On a CUDA device that call launches
``csrc/ensemble_score.cu`` (fp32 supports) or its int8 loader
(``ensemble_score_q8``); on the CPU it runs their plain versions.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from repro_torch.core.ensemble import Ensemble, StackedEnsemble
from repro_torch.core.svm import SVMModel
from repro_torch.serve.scheduler import MicroBatchScheduler, ServeConfig
from repro_torch.utils.device import resolve_device
from repro_torch.utils.metrics import GroupedAUC, streaming_grouped_auc


def _packed_device(packed):
    return next(iter(packed.buffers())).device


def _pack(ensemble, device):
    """Normalize any servable model form to a packed stacked ensemble on
    ``device`` (a resolved ``torch.device``)."""
    from repro_torch.agg import WeightedEnsemble
    from repro_torch.comm.wire import QuantizedStackedEnsemble, QuantizedSVM
    from repro_torch.core.averaging import LinearSVM, StackedLinear

    if isinstance(ensemble, (StackedEnsemble, QuantizedStackedEnsemble, StackedLinear)):
        if _packed_device(ensemble) != device:
            raise ValueError(f"a {type(ensemble).__name__} packed on "
                             f"{_packed_device(ensemble)} cannot serve on {device}")
        return ensemble
    if isinstance(ensemble, SVMModel):
        return StackedEnsemble.from_members([ensemble], device=device)
    if isinstance(ensemble, QuantizedSVM):
        return QuantizedStackedEnsemble.from_members([ensemble], device=device)
    if isinstance(ensemble, LinearSVM):
        # linear aggregates (feature_stats / fused fisher) serve through
        # the packed linear mirror of StackedEnsemble
        return StackedLinear.from_model(ensemble, device=device)
    if isinstance(ensemble, WeightedEnsemble):
        # weighted aggregates serve as their coef-scaled plain ensemble
        return _pack(ensemble.as_ensemble(), device)
    if isinstance(ensemble, Ensemble):
        if ensemble.members and all(
            isinstance(m, QuantizedSVM) for m in ensemble.members
        ):
            return QuantizedStackedEnsemble.from_members(ensemble.members, device=device)
        return StackedEnsemble.from_members(ensemble.members, device=device)
    raise TypeError(f"cannot serve {type(ensemble).__name__}")


class EnsembleScorer:
    """score_fn adapter over a packed ensemble (or single student).

    Accepts an ``Ensemble`` (packed here, once), an already-packed
    ``StackedEnsemble`` / ``QuantizedStackedEnsemble`` / ``StackedLinear``
    on ``device``, a ``WeightedEnsemble`` or a single model — an
    ``SVMModel``, an int8-wire ``QuantizedSVM`` (e.g. the distilled
    student off ``ProtocolResult.student``) or a ``LinearSVM`` — which
    serves as a k=1 ensemble through the same fused kernels. Instances
    are callable with a (b, d) numpy batch and return (b,) fp32 numpy
    mean member scores, the ``MicroBatchScheduler`` score_fn contract.
    ``device`` defaults to the card.
    """

    def __init__(self, ensemble, device="cuda"):
        self.device = resolve_device(device)
        self.stacked = _pack(ensemble, self.device)

    @property
    def k(self) -> int:
        return self.stacked.k

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        # the packed forms copy a numpy batch into a fresh (so aligned)
        # tensor on their device; the scores come back to the host
        return self.stacked.score(batch).cpu().numpy()

    def scheduler(self, config: ServeConfig = ServeConfig()) -> MicroBatchScheduler:
        """A micro-batching scheduler serving this ensemble."""
        return MicroBatchScheduler(self, config)

    def evaluate(
        self,
        groups: Iterable[Tuple[object, np.ndarray, np.ndarray]],
        *,
        chunk: int = 4096,
        acc: GroupedAUC = None,
    ) -> GroupedAUC:
        """Streaming per-group AUC over (group, x, y) triples.

        Rows from consecutive groups pack into ``chunk``-sized scorer
        calls, and scores fold straight into merge-able ``StreamingAUC``
        states — no (groups x samples) score matrix. Pass ``acc`` to keep
        folding into an existing accumulator.
        """
        return streaming_grouped_auc(self, groups, chunk=chunk, acc=acc)
