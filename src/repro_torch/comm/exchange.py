"""Round plumbing: cached encode/decode and budget-aware picks.

Port of ``repro.comm.exchange``. ``ModelExchange``: price each candidate
model on the wire once, select under the optional byte budget, hold the
DECODED models for evaluation, and put every message on the ledger at
its exact encoded size.

``StreamExchange`` is its streaming twin: no model mapping exists up
front — selection runs over ``ReportColumns`` scalars, candidate
uploads are priced from SHAPE (``wire.svm_wire_nbytes``), and only the
devices a pick actually selects are regenerated (through a provider
callback, ``sim.engine.train_selected`` in ``sim.population``) and
encoded. Byte totals, picked ids and decoded models are those of a
materialised ``ModelExchange`` over the same population.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.comm.budget import budgeted_select, pack_ranked
from repro_torch.comm.ledger import CommLedger
from repro_torch.comm.wire import (
    _COUNT,
    _HEADER,
    REPORT_NBYTES,
    decode,
    encode,
    get_codec,
    svm_wire_nbytes,
)
from repro_torch.core.selection import (
    DeviceReport,
    ReportColumns,
    select,
    select_from_columns,
)


class ModelExchange:
    """One round's client->server model traffic, priced and cached.

    ``models`` maps device_id -> trained local model; ``reports`` are
    the pre-round scalars. Each model is encoded at most once (the blob
    is both the byte cost and the decode source); decoded SVMs score on
    ``device``. With ``budget_bytes`` set, picks are the greedy knapsack
    of ``comm.budget`` over the exact encoded sizes.
    """

    def __init__(
        self,
        models: Mapping[int, object],
        reports: Sequence[DeviceReport],
        codec: str = "fp32",
        budget_bytes: Optional[int] = None,
        device="cuda",
    ):
        self.models = models
        self.reports = list(reports)
        self.codec = get_codec(codec).spec
        self.budget_bytes = budget_bytes
        self.device = device
        self._eligible = [r.device_id for r in self.reports if r.eligible]
        self._enc: Dict[int, bytes] = {}
        self._dec: Dict[int, object] = {}

    def upload(self, device_id: int) -> bytes:
        """The exact bytes this device would put on the wire (cached)."""
        if device_id not in self._enc:
            self._enc[device_id] = encode(self.models[device_id], self.codec)
        return self._enc[device_id]

    def received(self, device_id: int):
        """What the server holds after decode."""
        if device_id not in self._dec:
            self._dec[device_id] = decode(self.upload(device_id), device=self.device)
        return self._dec[device_id]

    def pick(self, strategy: str, k: int, seed: int = 0) -> List[int]:
        """Strategy selection, knapsack-packed when a budget is set."""
        kw = {"seed": seed} if strategy == "random" else {}
        if self.budget_bytes is None:
            return select(strategy, self.reports, k, **kw)
        sizes = {i: len(self.upload(i)) for i in self._eligible}
        return budgeted_select(
            strategy, self.reports, k, sizes, self.budget_bytes, **kw
        ).ids

    def record_metadata(self, ledger: CommLedger) -> None:
        """The pre-round DeviceReport exchange, one event per reporter."""
        for r in self.reports:
            ledger.record("up", "metadata", len(encode(r)),
                          device_id=r.device_id, tag="metadata_upload")

    def record_uploads(self, ledger: CommLedger, ids: Sequence[int], tag: str) -> None:
        for i in ids:
            ledger.record("up", "model_upload", len(self.upload(i)),
                          device_id=i, codec=self.codec, tag=tag)

    def ensemble_nbytes(self, ids: Sequence[int]) -> int:
        """Exact ``len(encode(Ensemble(...), codec))`` composed from the
        cached member blobs: ensemble header + count + length-prefixed
        members."""
        return (
            _HEADER.size + _COUNT.size
            + sum(_COUNT.size + len(self.upload(i)) for i in ids)
        )


class StreamExchange:
    """One round's model traffic when the population is a STREAM.

    ``columns`` are the pre-round scalars for every reporting device
    (the only population-sized server state, a few bytes per device);
    ``provider(ids)`` regenerates the named devices' trained models on
    demand — only selected devices are ever rebuilt, encoded, or
    decoded, so memory follows k, not the population. Decoded SVMs
    score on ``device``.

    Budget packing prices every ELIGIBLE candidate from its shape via
    ``svm_wire_nbytes(n_train, dim, codec)`` — exactly
    ``len(encode(model, codec))``, since eligible devices carry SVM
    payloads whose support count IS ``n_train`` — without encoding
    anyone. Picks, byte totals and decoded models match a materialised
    ``ModelExchange`` over the same population.
    """

    def __init__(
        self,
        columns: ReportColumns,
        provider: Callable[[Sequence[int]], Mapping[int, object]],
        dim: int,
        codec: str = "fp32",
        budget_bytes: Optional[int] = None,
        device="cuda",
    ):
        self.columns = columns
        self.provider = provider
        self.dim = int(dim)
        self.codec = get_codec(codec).spec
        self.budget_bytes = budget_bytes
        self.device = device
        self._models: Dict[int, object] = {}
        self._enc: Dict[int, bytes] = {}
        self._dec: Dict[int, object] = {}

    def fetch(self, ids: Sequence[int]) -> None:
        """Ensure models for ``ids`` are held (one provider call for
        the ids not yet regenerated)."""
        missing = [int(i) for i in ids if int(i) not in self._models]
        if missing:
            self._models.update(self.provider(missing))

    def model(self, device_id: int):
        self.fetch([device_id])
        return self._models[int(device_id)]

    def upload(self, device_id: int) -> bytes:
        """The exact bytes this device would put on the wire (cached)."""
        if device_id not in self._enc:
            self._enc[device_id] = encode(self.model(device_id), self.codec)
        return self._enc[device_id]

    def received(self, device_id: int):
        if device_id not in self._dec:
            self._dec[device_id] = decode(self.upload(device_id), device=self.device)
        return self._dec[device_id]

    def upload_nbytes(self, device_id: int) -> int:
        """Shape-priced upload size — no model, no encode."""
        p = int(np.searchsorted(self.columns.ids, device_id))
        return svm_wire_nbytes(int(self.columns.n_train[p]), self.dim, self.codec)

    def pick(self, strategy: str, k: int, seed: int = 0) -> List[int]:
        """Strategy selection over columns, knapsack-packed when a
        budget is set (sizes from shape, never from encoding)."""
        kw = {"seed": seed} if strategy == "random" else {}
        if self.budget_bytes is None:
            return select_from_columns(strategy, self.columns, k, **kw)
        ranked = select_from_columns(strategy, self.columns,
                                     len(self.columns), **kw)
        n_by_id = dict(zip(
            (int(i) for i in self.columns.ids),
            (int(n) for n in self.columns.n_train),
        ))
        sizes = {
            i: svm_wire_nbytes(n_by_id[i], self.dim, self.codec)
            for i in ranked
        }
        return pack_ranked(ranked, k, sizes, self.budget_bytes).ids

    def record_metadata(self, ledger: CommLedger) -> None:
        """The pre-round DeviceReport exchange — every report is the
        same 18 wire bytes, so the whole population folds into one
        batch record."""
        ledger.record_batch("up", "metadata", REPORT_NBYTES,
                            len(self.columns), tag="metadata_upload")

    def record_uploads(self, ledger: CommLedger, ids: Sequence[int], tag: str) -> None:
        for i in ids:
            ledger.record("up", "model_upload", len(self.upload(i)),
                          device_id=i, codec=self.codec, tag=tag)
