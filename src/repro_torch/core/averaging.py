"""One-shot parameter averaging — the related-work baseline [8].

Port of ``repro.core.averaging``. The paper argues naive averaging (a)
degrades for m > sqrt(N) devices and (b) is ill-defined for kernel SVMs
(disparate dual variable sets) or heterogeneous deep nets. Both halves:

  * ``average_params`` — valid averaging for homogeneous parameter trees
    (``utils.trees``: dicts, lists and tuples of arrays or tensors); it
    refuses mismatched trees with the reference's ``ValueError``s, which
    IS the paper's infeasibility argument made executable.
  * ``LinearSVM`` + ``train_linear_svm`` — the primal linear model for
    which one-shot averaging [Zhang et al. 2012] is classically defined.

``train_linear_svm`` is the reference's Pegasos fit: the same padded
bucket, the same float32 step arithmetic and the same sample indices,
drawn from JAX's Threefry stream by ``utils.threefry`` on the host, all
``epochs * bucket`` of them before the loop. The loop itself runs as
torch operations on the caller's device. A linear model scores as
``x @ w + b``, a plain product on its device (TF32 off there).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.ensemble import chunked_bucket_predict
from repro_torch.utils.device import resolve_device
from repro_torch.utils.threefry import pegasos_indices
from repro_torch.utils.trees import leaf_shape, tree_leaves, tree_map, tree_structure

# Pegasos problems are padded to a multiple of this many rows, as the
# reference pads them (its index draw spans the padded step count)
PEGASOS_BUCKET = 64


def normalize_weights(weights: Sequence[float], n: Optional[int] = None) -> np.ndarray:
    """Validate member weights and project them onto the simplex.

    Weights must be finite and non-negative, and their sum must be
    bounded away from zero: a negative weight silently flips a member's
    contribution, and a zero/near-zero sum turns the normalizing divide
    into NaN/inf trees. ``fisher`` aggregation feeds empirical Fisher
    masses through here, where all-zero masses are a real input (empty
    validation splits), so the rejection is a ``ValueError`` callers
    can catch and map to a uniform fallback.
    """
    w = np.asarray(weights, np.float64)
    if w.ndim != 1 or (n is not None and len(w) != n):
        raise ValueError(
            f"expected {n if n is not None else 'a 1-D vector of'} weights, "
            f"got shape {w.shape}"
        )
    if len(w) == 0:
        raise ValueError("no weights to normalize")
    if not np.all(np.isfinite(w)):
        raise ValueError(f"weights must be finite, got {w}")
    if np.any(w < 0):
        raise ValueError(f"weights must be non-negative, got {w}")
    s = float(w.sum())
    if s <= 1e-30:
        raise ValueError(
            f"weight sum {s} is zero/near-zero; cannot normalize (all "
            "members carry no weight)"
        )
    return w / s


def _scaled(x, s: float):
    """``x * s`` under the leaf's own library's promotion, as the
    reference's ``x * w_i`` is: a numpy leaf times a float64 weight
    promotes to float64 there too; a tensor leaf stays in its float type,
    as a JAX float32 leaf does with x64 off."""
    if isinstance(x, torch.Tensor):
        return x * float(s)
    return x * s


def average_params(trees: Sequence, weights: Optional[Sequence[float]] = None):
    """Weighted average of homogeneous parameter trees (FedAvg-style
    one-shot). Weights go through ``normalize_weights``: negative weights
    and zero/near-zero weight sums raise instead of producing
    sign-flipped or NaN parameter trees."""
    if not trees:
        raise ValueError("no models to average")
    structures = {tree_structure(t) for t in trees}
    if len(structures) != 1:
        raise ValueError(
            "parameter averaging requires identical model structures; got "
            f"{len(structures)} distinct treedefs (the paper's infeasibility "
            "case for kernel SVMs / heterogeneous nets)"
        )
    shapes = [tuple(leaf_shape(x) for x in tree_leaves(t)) for t in trees]
    if len(set(shapes)) != 1:
        raise ValueError("parameter averaging requires identical leaf shapes")
    if weights is None:
        weights = [1.0 / len(trees)] * len(trees)
    w = normalize_weights(weights, len(trees))
    out = tree_map(lambda x: _scaled(x, w[0]), trees[0])
    for wi, t in zip(w[1:], trees[1:]):
        out = tree_map(lambda a, b, wi=wi: a + _scaled(b, wi), out, t)
    return out


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


@dataclasses.dataclass
class LinearSVM:
    """A primal linear scorer ``w . x + b``: host weights, scored on
    ``device``."""

    w: np.ndarray  # (d,)
    b: float
    device: str = dataclasses.field(default="cuda", compare=False)

    def predict(self, x: np.ndarray, chunk: Optional[int] = None) -> np.ndarray:
        """Decision scores ``x @ w + b`` on the model's device. ``chunk``
        is accepted (and ignored) so linear scorers are drop-in for the
        chunked ensemble predict signature."""
        dev = resolve_device(self.device)
        return (_tensor(x, dev) @ _tensor(self.w, dev) + self.b).cpu().numpy()

    @property
    def nbytes(self) -> int:
        # repro: allow[wire-cost-honesty] reason=in-memory model footprint property, not a wire price
        return self.w.nbytes + 8


class StackedLinear(nn.Module):
    """Packed serve form of a ``LinearSVM`` — the linear mirror of
    ``core.ensemble.StackedEnsemble`` with the same ``score``/``k``/``d``
    surface: ``w`` (d,) a registered buffer on the scoring device."""

    def __init__(self, w: torch.Tensor, b: float):
        super().__init__()
        self.register_buffer("w", w)
        self.b = float(b)

    @classmethod
    def from_model(cls, model: LinearSVM, device=None) -> "StackedLinear":
        dev = resolve_device(model.device if device is None else device)
        return cls(_tensor(model.w, dev), model.b)

    @property
    def k(self) -> int:
        return 1

    @property
    def n_max(self) -> int:
        return 1

    @property
    def d(self) -> int:
        return int(self.w.shape[0])

    def forward(self, x) -> torch.Tensor:
        """Member score for one query block. x: (b, d) -> (b,)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return x.to(self.w.device) @ self.w + self.b

    def score(self, x) -> torch.Tensor:
        return self(x)

    def predict(self, x: np.ndarray, chunk: int = 4096) -> np.ndarray:
        return chunked_bucket_predict(self.score, x, chunk)


def _pegasos(x: torch.Tensor, y: torch.Tensor, idx: np.ndarray, lam: float):
    """Pegasos primal SGD for the linear hinge SVM over the sample
    indices ``idx``, one per step; float32 throughout, each operation in
    the reference step's order."""
    dev = x.device
    lam_t = torch.tensor(lam, dtype=torch.float32, device=dev)
    t = torch.arange(len(idx), dtype=torch.float32, device=dev)
    eta = 1.0 / (lam_t * (t + 1.0))
    eta_b = eta * 0.01
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    w = torch.zeros(x.shape[1], dtype=torch.float32, device=dev)
    b = zero
    for s, i in enumerate(idx.tolist()):
        xi, yi = x[i], y[i]
        step = torch.where(yi * (torch.dot(xi, w) + b) < 1.0, yi, zero)
        w = w - eta[s] * (lam_t * w - step * xi)
        b = b - eta_b[s] * -step
    return w, b


def train_linear_svm(x: np.ndarray, y: np.ndarray, lam: float = 0.01, epochs: int = 5,
                     seed: int = 0, device="cuda") -> LinearSVM:
    """The reference's Pegasos fit on ``device``: rows padded to a
    64-row bucket (padding labelled +1, never drawn), ``epochs * bucket``
    steps."""
    dev = resolve_device(device)
    n = len(y)
    bucket = max(-(-n // PEGASOS_BUCKET) * PEGASOS_BUCKET, PEGASOS_BUCKET)
    xp = np.zeros((bucket, x.shape[1]), np.float32)
    xp[:n] = x
    yp = np.ones(bucket, np.float32)
    yp[:n] = y
    idx = pegasos_indices(seed, epochs * bucket, n)
    w, b = _pegasos(_tensor(xp, dev), _tensor(yp, dev), idx, lam)
    return LinearSVM(w=w.cpu().numpy(), b=float(b), device=str(dev))


def one_shot_average_linear(models: Sequence[LinearSVM],
                            weights: Optional[Sequence[float]] = None) -> LinearSVM:
    """The weighted parameter average of linear models, in float32 (the
    reference averages them as float32 JAX arrays)."""
    trees = [{"w": torch.from_numpy(np.array(m.w, np.float32)),
              "b": torch.tensor(m.b, dtype=torch.float32)} for m in models]
    avg = average_params(trees, weights)
    return LinearSVM(w=avg["w"].numpy(), b=float(avg["b"]), device=models[0].device)
