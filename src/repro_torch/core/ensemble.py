"""Ensembles of local models (Section 3): F_k(x) = mean_t f_t(x).

Port of ``repro.core.ensemble``. Two representations:
  * ``Ensemble`` — heterogeneous member list (SVMs, constants). SVM-only
    ensembles are packed once into a ``StackedEnsemble`` and scored with
    the fused ``ensemble_score`` kernel; all-``QuantizedSVM`` ensembles
    (int8 wire payloads) pack once into a ``QuantizedStackedEnsemble``
    and score with ``ensemble_score_q8``; mixed ensembles take the
    per-member mean.
  * ``StackedEnsemble`` — an ``nn.Module`` whose registered buffers are
    the padded member arrays stacked on a leading member axis: supports
    ``sup`` (k, n_max, d), dual coefs ``coef`` (k, n_max), bandwidths
    ``gammas`` (k,), all on the scoring device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.svm import SVMModel
from repro_torch.kernels import ops as kops
from repro_torch.utils.device import resolve_device


def chunked_bucket_predict(score_fn, x: np.ndarray, chunk: int) -> np.ndarray:
    """Chunked evaluation over a host array of queries.

    Each chunk is zero-padded up to a power-of-two bucket before
    ``score_fn`` (host arithmetic kept verbatim from the reference, so
    both packages score the same padded blocks); ``score_fn`` returns a
    tensor, copied back to the host per chunk.
    """
    if len(x) == 0:
        return np.zeros(0, np.float32)
    x = np.asarray(x, np.float32)
    outs = []
    for start in range(0, len(x), chunk):
        xq = x[start : start + chunk]
        b = len(xq)
        bp = max(8, 1 << (b - 1).bit_length())  # next power of two
        if bp != b:
            xq = np.pad(xq, ((0, bp - b), (0, 0)))
        outs.append(score_fn(xq).cpu().numpy()[:b])
    return np.concatenate(outs)


class StackedEnsemble(nn.Module):
    """Packed homogeneous ensemble: the fused scoring representation."""

    def __init__(self, sup: torch.Tensor, coef: torch.Tensor, gammas: torch.Tensor):
        super().__init__()
        self.register_buffer("sup", sup)        # (k, n_max, d) zero-padded supports
        self.register_buffer("coef", coef)      # (k, n_max) zero-padded dual coefs
        self.register_buffer("gammas", gammas)  # (k,) per-member bandwidths

    @property
    def k(self) -> int:
        return self.sup.shape[0]

    @property
    def n_max(self) -> int:
        return self.sup.shape[1]

    @property
    def d(self) -> int:
        return self.sup.shape[2]

    @classmethod
    def from_members(cls, members: Sequence[SVMModel], device=None) -> "StackedEnsemble":
        """Pack on the host (as the reference does), then move to
        ``device`` (default: the first member's)."""
        if not members:
            raise ValueError("empty ensemble")
        for m in members:
            if not isinstance(m, SVMModel):
                raise TypeError(
                    f"StackedEnsemble requires SVMModel members, got {type(m).__name__}; "
                    "use ensemble_predict_mean for mixed ensembles"
                )
        dev = resolve_device(members[0].device if device is None else device)
        n_max = max(len(m.coef) for m in members)
        d = members[0].support_x.shape[1]
        k = len(members)
        sup = np.zeros((k, n_max, d), np.float32)
        coef = np.zeros((k, n_max), np.float32)
        gammas = np.zeros((k,), np.float32)
        for i, m in enumerate(members):
            n = len(m.coef)
            sup[i, :n] = m.support_x
            coef[i, :n] = m.coef
            gammas[i] = m.gamma
        return cls(torch.from_numpy(sup).to(dev), torch.from_numpy(coef).to(dev),
                   torch.from_numpy(gammas).to(dev))

    def forward(self, x) -> torch.Tensor:
        """Fused mean member score for one query block. x: (b, d) -> (b,)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return kops.ensemble_score(x.to(self.sup.device), self.sup, self.coef, self.gammas)

    def score(self, x) -> torch.Tensor:
        return self(x)

    def predict(self, x: np.ndarray, chunk: int = 4096) -> np.ndarray:
        """Chunked scoring with power-of-two bucket padding."""
        return chunked_bucket_predict(self.score, x, chunk)


@dataclasses.dataclass
class Ensemble:
    members: List[SVMModel]
    _stacked: Optional[StackedEnsemble] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    _qstacked: Optional[nn.Module] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    @property
    def k(self) -> int:
        return len(self.members)

    @property
    def nbytes(self) -> int:
        # repro: allow[wire-cost-honesty] reason=sums member in-memory footprints, not a wire price
        return sum(m.nbytes for m in self.members)

    def stacked(self) -> StackedEnsemble:
        """Pack once, reuse for every later predict (members are
        treated as immutable trained models)."""
        if self._stacked is None:
            self._stacked = StackedEnsemble.from_members(self.members)
        return self._stacked

    def predict(self, x: np.ndarray, chunk: int = 4096) -> np.ndarray:
        """Mean of member decision scores: the fused kernel for all-SVM
        and all-``QuantizedSVM`` ensembles, the per-member mean otherwise
        (e.g. ConstantModel baselines)."""
        if not self.members:
            raise ValueError("empty ensemble")
        if any(not isinstance(m, SVMModel) for m in self.members):
            # deferred: comm.wire imports this module
            from repro_torch.comm.wire import QuantizedStackedEnsemble, QuantizedSVM

            if all(isinstance(m, QuantizedSVM) for m in self.members):
                if self._qstacked is None:
                    self._qstacked = QuantizedStackedEnsemble.from_members(self.members)
                return self._qstacked.predict(x, chunk=chunk)
            return ensemble_predict_mean(self.members, x)
        return self.stacked().predict(x, chunk=chunk)


def ensemble_predict_mean(members: Sequence, x: np.ndarray) -> np.ndarray:
    """Plain mean over member.predict (handles ConstantModel members)."""
    return np.mean([m.predict(x) for m in members], axis=0)
