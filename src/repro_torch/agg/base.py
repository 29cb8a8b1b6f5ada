"""Registered server-side aggregation strategies (the aggregator zoo).

Port of ``repro.agg.base``. The paper's server combines the k selected
device models with a plain mean of member scores; the zoo adds
strategies that weigh or fuse them (FedFisher; Allouah et al. 2024;
Guan et al. 2025). Strategies register by name:

    @aggregator("fisher")
    class FisherAggregator(Aggregator): ...

    get_aggregator("reweight:10").build(members, extras, seed)

An ``Aggregator`` plays both sides of the round:

  * device side — ``device_extra(outcome, seed)`` produces the optional
    side payload (Fisher diagonal, validation columns, feature moments)
    as a ``comm.wire.AggExtra`` of host arrays. Extras are wire messages:
    encoded through the round's codec, priced at exactly
    ``len(encode())`` on the ledger under ``kind="agg_extra"`` and
    DECODED before the server uses them, so lossy codecs pay their AUC
    cost on extras as they do on models.
  * server side — ``build(members, extras, seed, device)`` turns the
    decoded members and extras into the server scorer (anything with
    ``predict(x, chunk=...)``); a scorer the strategy makes itself (a
    fused or closed-form ``LinearSVM``) scores on ``device``.

``extra_shapes(n_train, n_val, dim)`` is the shape half of the ledger
contract: the streamed round prices extras from scalar columns via
``wire.agg_extra_wire_nbytes`` without regenerating device state.

``mean`` is bitwise the plain ``Ensemble``; ``WeightedEnsemble`` with
uniform weights short-circuits to it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.comm.wire import QuantizedSVM
from repro_torch.core.averaging import normalize_weights
from repro_torch.core.ensemble import Ensemble
from repro_torch.core.svm import ConstantModel, SVMModel

AGGREGATOR_REGISTRY: Dict[str, Type["Aggregator"]] = {}


def aggregator(name: str):
    """Class decorator registering an ``Aggregator`` under ``name``.

    Registration order is the benchmark sweep order (like ``CODECS``).
    """

    def deco(cls: Type["Aggregator"]) -> Type["Aggregator"]:
        if name in AGGREGATOR_REGISTRY:
            raise ValueError(f"duplicate aggregator {name!r}")
        cls.name = name
        AGGREGATOR_REGISTRY[name] = cls
        return cls

    return deco


class Aggregator:
    """One entry of the aggregator registry (see module docstring).

    ``param`` is the strategy's single optional knob (the reweight
    softmax temperature; unused elsewhere), selected via the
    ``"name:param"`` spec syntax shared with the codec registry.
    """

    name = "base"
    needs_extra = False   # does the strategy ship a side payload?
    has_param = False     # does "name:param" mean anything?

    def __init__(self, param: Optional[float] = None):
        if param is not None and not self.has_param:
            raise ValueError(f"aggregator {self.name!r} takes no parameter")
        self.param = param

    @property
    def spec(self) -> str:
        """Round-trippable name (``get_aggregator(a.spec)`` rebuilds it)."""
        if self.param is not None:
            return f"{self.name}:{self.param:g}"
        return self.name

    # --- device side ---------------------------------------------------
    def device_extra(self, outcome, seed: int):
        """Side payload for one device (a ``wire.AggExtra``), or None.

        ``outcome`` is the device's ``sim.engine.DeviceOutcome``; any
        randomness derives from ``(seed, outcome.device_id)`` via
        ``utils.seeds``, so extras are identical on every engine tier.
        """
        return None

    def extra_shapes(
        self, n_train: int, n_val: int, dim: int
    ) -> Optional[Dict[str, Tuple[int, ...]]]:
        """Array shapes of ``device_extra`` from scalar columns alone."""
        return None

    # --- server side ----------------------------------------------------
    def build(self, members: Sequence, extras: Sequence, seed: int, device="cuda"):
        """Decoded members + decoded extras -> server scorer."""
        raise NotImplementedError


def get_aggregator(spec) -> Aggregator:
    """Resolve ``"mean"`` / ``"reweight:10"`` / an Aggregator instance."""
    if isinstance(spec, Aggregator):
        return spec
    name, _, param = str(spec).partition(":")
    if name not in AGGREGATOR_REGISTRY:
        raise KeyError(
            f"unknown aggregator {spec!r}; options {sorted(AGGREGATOR_REGISTRY)}"
        )
    cls = AGGREGATOR_REGISTRY[name]
    return cls(float(param)) if param else cls()


def _scale_member(m, factor: float):
    """Member whose scores are ``factor *`` the original's (its host
    ``coef`` scaled in float32) — the fused mean kernels then compute the
    weighted sum without a new kernel."""
    f = np.float32(factor)
    if isinstance(m, (SVMModel, QuantizedSVM)):
        return dataclasses.replace(m, coef=np.asarray(m.coef) * f)
    if isinstance(m, ConstantModel):
        return ConstantModel(value=float(m.value) * float(f))
    raise TypeError(f"cannot weight member of type {type(m).__name__}")


@dataclasses.dataclass
class WeightedEnsemble:
    """Convex member combination: score(x) = sum_i weights[i] f_i(x).

    Uniform weights delegate to the plain ``Ensemble`` (bitwise the
    paper's mean — ``k * (1/k)`` is not exactly 1.0 in IEEE floats, so
    the degenerate case short-circuits instead of scaling). Non-uniform
    weights scale each member's dual coefficients by ``k * w_i`` and
    reuse the fused MEAN kernels (``ensemble_score``, or
    ``ensemble_score_q8`` for int8 members): mean_i(k w_i f_i) = sum w_i f_i.
    The packed ensemble is built once and kept, so repeated predicts do
    not re-pack or re-upload the stacked supports.
    """

    members: List
    weights: np.ndarray  # (k,) on the simplex
    _ens: Optional[Ensemble] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def __post_init__(self):
        self.weights = normalize_weights(self.weights, len(self.members))

    @property
    def k(self) -> int:
        return len(self.members)

    @property
    def uniform(self) -> bool:
        return bool(np.all(self.weights == self.weights[0]))

    def as_ensemble(self) -> Ensemble:
        """The equivalent plain ``Ensemble`` (uniform: the members as
        given; weighted: coef-scaled members) — the wire form, so a
        weighted scorer encodes like any mean ensemble."""
        if self._ens is None:
            if self.uniform:
                self._ens = Ensemble(list(self.members))
            else:
                k = len(self.members)
                self._ens = Ensemble(
                    [_scale_member(m, k * float(w))
                     for m, w in zip(self.members, self.weights)]
                )
        return self._ens

    def predict(self, x: np.ndarray, chunk: int = 4096) -> np.ndarray:
        return self.as_ensemble().predict(x, chunk=chunk)
