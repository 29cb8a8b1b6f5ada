"""Typed byte ledger for the one-shot round.

Port of ``repro.comm.ledger`` (its event-list representation; the
compact mode serves the streamed round, not ported yet). Every protocol
message — the pre-round ``DeviceReport`` metadata exchange and each
selected model upload — is one ``CommEvent`` with its exact wire-encoded
size (``len(repro_torch.comm.wire.encode(...))``).

Event kinds:

    metadata           device -> server scalar DeviceReport (pre-round)
    model_upload       device -> server selected local model (THE round)
    agg_extra          device -> server aggregator side payload
    ensemble_download  server -> consumer full selected ensemble
    student_download   server -> consumer distilled student

Tags group events into named quantities (``upload_cv_k10``,
``metadata_upload``, ...); ``as_dict()`` sums per tag and is
``ProtocolResult.comm_bytes``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

from repro_torch.obs.trace import current_tracer

DIRECTIONS = ("up", "down")
KINDS = ("metadata", "model_upload", "agg_extra", "ensemble_download", "student_download")


@dataclasses.dataclass(frozen=True)
class CommEvent:
    """One protocol message, exactly as costed on the wire."""

    direction: str                  # "up" (device->server) | "down"
    kind: str                       # one of KINDS
    nbytes: int                     # exact encoded size
    device_id: Optional[int] = None
    codec: Optional[str] = None     # wire codec spec, if a model payload
    tag: str = ""                   # named quantity this event belongs to


class CommLedger:
    """Append-only record of protocol messages with typed queries."""

    def __init__(self) -> None:
        self.events: List[CommEvent] = []

    def record(
        self,
        direction: str,
        kind: str,
        nbytes: int,
        *,
        device_id: Optional[int] = None,
        codec: Optional[str] = None,
        tag: str = "",
    ) -> CommEvent:
        if direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {DIRECTIONS}, got {direction!r}")
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError(f"nbytes must be >= 0, got {nbytes}")
        ev = CommEvent(direction, kind, nbytes, device_id=device_id, codec=codec, tag=tag)
        self.events.append(ev)
        tracer = current_tracer()
        if tracer.enabled:
            tracer.instant(f"comm.{kind}", cat="comm", direction=direction,
                           nbytes=nbytes, tag=tag)
        return ev

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[CommEvent]:
        return iter(self.events)

    def filter(
        self,
        direction: Optional[str] = None,
        kind: Optional[str] = None,
        tag: Optional[str] = None,
    ) -> List[CommEvent]:
        return [
            e for e in self.events
            if (direction is None or e.direction == direction)
            and (kind is None or e.kind == kind)
            and (tag is None or e.tag == tag)
        ]

    def total(
        self,
        direction: Optional[str] = None,
        kind: Optional[str] = None,
        tag: Optional[str] = None,
    ) -> int:
        """Exact byte total over the matching events."""
        return sum(e.nbytes for e in self.filter(direction, kind, tag))  # repro: allow[wire-cost-honesty] reason=CommEvent.nbytes is the priced wire size, as in repro/comm/ledger.py

    def as_dict(self) -> Dict[str, float]:
        """tag -> byte total (the ``comm_bytes`` mapping)."""
        out: Dict[str, float] = {}
        for e in self.events:
            key = e.tag or e.kind
            out[key] = out.get(key, 0.0) + float(e.nbytes)  # repro: allow[wire-cost-honesty] reason=CommEvent.nbytes is the priced wire size, as in repro/comm/ledger.py
        return out

    def summary(self) -> Dict[str, float]:
        """Per-tag totals plus roll-ups (the reference's summary keys)."""
        out = self.as_dict()
        out["total_up"] = float(self.total(direction="up"))
        out["total_down"] = float(self.total(direction="down"))
        out["total_metadata"] = float(self.total(kind="metadata"))
        out["total_student_down"] = float(self.total(kind="student_download"))
        out["total_agg_extra"] = float(self.total(kind="agg_extra"))
        return out
