"""Round plumbing: cached encode/decode and picks.

Port of ``repro.comm.exchange.ModelExchange`` without a byte budget
(budgeted selection is not ported yet): price each candidate model on
the wire once, select, hold the DECODED models for evaluation, and put
every message on the ledger at its exact encoded size.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

from repro_torch.comm.ledger import CommLedger
from repro_torch.comm.wire import decode, encode, get_codec
from repro_torch.core.selection import DeviceReport, select


class ModelExchange:
    """One round's client->server model traffic, priced and cached.

    ``models`` maps device_id -> trained local model; ``reports`` are
    the pre-round scalars. Each model is encoded at most once (the blob
    is both the byte cost and the decode source); decoded SVMs score on
    ``device``.
    """

    def __init__(
        self,
        models: Mapping[int, object],
        reports: Sequence[DeviceReport],
        codec: str = "fp32",
        device="cuda",
    ):
        self.models = models
        self.reports = list(reports)
        self.codec = get_codec(codec).spec
        self.device = device
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
        """Strategy selection."""
        kw = {"seed": seed} if strategy == "random" else {}
        return select(strategy, self.reports, k, **kw)

    def record_metadata(self, ledger: CommLedger) -> None:
        """The pre-round DeviceReport exchange, one event per reporter."""
        for r in self.reports:
            ledger.record("up", "metadata", len(encode(r)),
                          device_id=r.device_id, tag="metadata_upload")

    def record_uploads(self, ledger: CommLedger, ids: Sequence[int], tag: str) -> None:
        for i in ids:
            ledger.record("up", "model_upload", len(self.upload(i)),
                          device_id=i, codec=self.codec, tag=tag)
