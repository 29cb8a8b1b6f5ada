"""RBF-kernel dual SVM — the paper's local model (Section 3, Eq. 2).

Port of ``repro.core.svm``. Each device solves the dual of the
hinge-loss ERM problem with an RBF kernel by cyclic SDCA; the local
model is ``f(x) = sum_j coef_j k(x_j, x)`` with
``coef = alpha * y / (lam * n)``.

The Gram (``kernels.ops.rbf_gram``) and the solve (``kernels.ops.sdca``)
run on the model's device; the bandwidth heuristic and the coefficient
arithmetic stay on the host in numpy, exactly as in the reference, so
both packages derive the same float64 gamma and the same coefficients
from the same alphas.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.utils.device import resolve_device


# SDCA problems are padded to multiples of this; the engine buckets
# devices by the same quantum so its batched solves match train_svm's.
SDCA_BUCKET = 64


def default_gamma(x: np.ndarray) -> float:
    """sklearn-style 'scale' heuristic: 1 / (d * var), on the host."""
    v = float(np.var(x))
    return 1.0 / (x.shape[1] * max(v, 1e-8))


@dataclasses.dataclass
class SVMModel:
    """A trained local model: support vectors + dual coefficients, held
    as host arrays; ``device`` is where ``predict`` scores them."""

    support_x: np.ndarray  # (n, d)
    coef: np.ndarray  # (n,)  = alpha * y / (lam * n)
    gamma: float
    device: str = dataclasses.field(default="cuda", compare=False)

    def predict(self, x: np.ndarray, chunk: int = 8192) -> np.ndarray:
        """Decision scores via the fused k=1 ``ensemble_score`` kernel,
        packed transiently (protocol models predict a handful of times)."""
        from repro_torch.core.ensemble import StackedEnsemble

        return StackedEnsemble.from_members([self]).predict(x, chunk=chunk)

    @property
    def nbytes(self) -> int:
        # repro: allow[wire-cost-honesty] reason=in-memory model footprint property, not a wire price
        return self.support_x.nbytes + self.coef.nbytes + 8


@dataclasses.dataclass
class ConstantModel:
    """Paper baseline for data-deficient devices: constant classifier."""

    value: float

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.full(len(x), self.value, np.float32)

    @property
    def nbytes(self) -> int:
        return 8


def train_svm(
    x: np.ndarray,
    y: np.ndarray,
    lam: float = 0.01,
    gamma: Optional[float] = None,
    epochs: int = 20,
    device="cuda",
) -> SVMModel:
    """Fit one RBF-SVM: the Gram and SDCA on ``device``, padded to a
    64-row bucket with zero Gram rows/cols and +1 labels."""
    dev = resolve_device(device)
    if gamma is None:
        gamma = default_gamma(x)
    n = len(y)
    bucket = max(-(-n // SDCA_BUCKET) * SDCA_BUCKET, SDCA_BUCKET)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    K = kops.rbf_gram(xt, xt, gamma)
    Kp = torch.zeros((1, bucket, bucket), dtype=torch.float32, device=dev)
    Kp[0, :n, :n] = K
    yp = torch.ones((1, bucket), dtype=torch.float32, device=dev)
    yp[0, :n] = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
    n_real = torch.tensor([n], dtype=torch.int32, device=dev)
    alpha = kops.sdca(Kp, yp, n_real, lam, epochs)[0, :n].cpu().numpy()
    coef = alpha * np.asarray(y, np.float32) / (lam * n)
    return SVMModel(support_x=np.asarray(x, np.float32), coef=coef.astype(np.float32),
                    gamma=gamma, device=str(dev))

