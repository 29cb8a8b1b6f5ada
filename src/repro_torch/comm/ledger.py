"""Typed byte ledger for the one-shot round.

Port of ``repro.comm.ledger``. Every protocol message — the pre-round
``DeviceReport`` metadata exchange, each selected model upload, the
distilled-student download — is one ``CommEvent`` with its exact
wire-encoded size (``len(repro_torch.comm.wire.encode(...))``).

Event kinds:

    metadata           device -> server scalar DeviceReport (pre-round)
    model_upload       device -> server selected local model (THE round)
    agg_extra          device -> server aggregator side payload
    ensemble_download  server -> consumer full selected ensemble
    student_download   server -> consumer distilled student

Tags group events into named quantities (``upload_cv_k10``,
``metadata_upload``, ...); ``as_dict()`` sums per tag and is
``ProtocolResult.comm_bytes``.

A ``CommLedger(compact=True)`` keeps only per-(direction, kind, tag,
codec) counts and byte totals instead of the event list — fixed host
memory however many messages are recorded, which is what the streamed
population round needs (10^6 metadata events would otherwise dominate
its O(chunk) memory). ``record``/``record_batch``, ``total``,
``as_dict``, ``summary`` and ``len`` behave identically in both
representations; only per-event queries (``filter``, iteration) need
the full event list, and raise in compact mode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

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
    """Append-only record of protocol messages with typed queries.

    ``compact=True`` folds every record into per-(direction, kind, tag,
    codec) aggregates instead of storing events — O(distinct tags)
    memory for any message count. Totals and summaries are identical to
    the event-list representation; ``filter``/iteration are the only
    queries that need the events and raise in compact mode.
    """

    def __init__(self, compact: bool = False) -> None:
        self.compact = bool(compact)
        self.events: List[CommEvent] = []
        # (direction, kind, tag, codec) -> [message count, byte total]
        self._agg: Dict[Tuple, List[int]] = {}
        self._count = 0

    @staticmethod
    def _validate(direction: str, kind: str, nbytes: int) -> int:
        if direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {DIRECTIONS}, got {direction!r}")
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError(f"nbytes must be >= 0, got {nbytes}")
        return nbytes

    def _fold(self, direction, kind, tag, codec, count, nbytes) -> None:
        slot = self._agg.setdefault((direction, kind, tag, codec), [0, 0])
        slot[0] += count
        slot[1] += nbytes
        self._count += count

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
        nbytes = self._validate(direction, kind, nbytes)
        ev = CommEvent(direction, kind, nbytes, device_id=device_id, codec=codec, tag=tag)
        if self.compact:
            self._fold(direction, kind, tag, codec, 1, nbytes)
        else:
            self.events.append(ev)
        tracer = current_tracer()
        if tracer.enabled:
            tracer.instant(f"comm.{kind}", cat="comm", direction=direction,
                           nbytes=nbytes, tag=tag)
        return ev

    def record_batch(
        self,
        direction: str,
        kind: str,
        nbytes_each: int,
        count: int,
        *,
        codec: Optional[str] = None,
        tag: str = "",
    ) -> None:
        """``count`` same-size messages in one call — the streamed
        round's metadata exchange records its whole population this way
        (one fold instead of 10^6 event objects). Equivalent to
        ``count`` individual ``record`` calls in every total."""
        nbytes_each = self._validate(direction, kind, nbytes_each)
        count = int(count)
        if count < 0:
            raise ValueError(f"count must be >= 0, got {count}")
        if self.compact:
            self._fold(direction, kind, tag, codec, count, count * nbytes_each)
        else:
            self.events.extend(
                CommEvent(direction, kind, nbytes_each, codec=codec, tag=tag)
                for _ in range(count)
            )
        tracer = current_tracer()
        if tracer.enabled:
            # one instant per batch, not per message — the streamed
            # round's 10^6-device metadata exchange stays one event
            tracer.instant(f"comm.{kind}", cat="comm", direction=direction,
                           nbytes=count * nbytes_each, count=count, tag=tag)

    def __len__(self) -> int:
        return self._count if self.compact else len(self.events)

    def __iter__(self) -> Iterator[CommEvent]:
        if self.compact:
            raise RuntimeError(
                "compact ledger keeps aggregates, not events; use "
                "total()/as_dict()/summary()"
            )
        return iter(self.events)

    def filter(
        self,
        direction: Optional[str] = None,
        kind: Optional[str] = None,
        tag: Optional[str] = None,
    ) -> List[CommEvent]:
        if self.compact:
            raise RuntimeError(
                "compact ledger keeps aggregates, not events; use "
                "total()/as_dict()/summary()"
            )
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
        if self.compact:
            return sum(
                nbytes for (d, k, t, _), (_, nbytes) in self._agg.items()
                if (direction is None or d == direction)
                and (kind is None or k == kind)
                and (tag is None or t == tag)
            )
        return sum(e.nbytes for e in self.filter(direction, kind, tag))  # repro: allow[wire-cost-honesty] reason=CommEvent.nbytes is the priced wire size, as in repro/comm/ledger.py

    def as_dict(self) -> Dict[str, float]:
        """tag -> byte total (the legacy ``comm_bytes`` mapping)."""
        out: Dict[str, float] = {}
        if self.compact:
            for (_, kind, tag, _), (_, nbytes) in self._agg.items():
                key = tag or kind
                out[key] = out.get(key, 0.0) + float(nbytes)
            return out
        for e in self.events:
            key = e.tag or e.kind
            out[key] = out.get(key, 0.0) + float(e.nbytes)  # repro: allow[wire-cost-honesty] reason=CommEvent.nbytes is the priced wire size, as in repro/comm/ledger.py
        return out

    def summary(self) -> Dict[str, float]:
        """Per-tag totals plus roll-ups (the fed_run JSON block).

        NOTE: experiment runners record every (strategy, k) cell they
        sweep, so the ``total_*`` roll-ups cover the whole sweep — the
        cost of ONE deployed round is a per-tag quantity (e.g.
        ``metadata_upload`` + ``upload_cv_k10``), not ``total_up``."""
        out = self.as_dict()
        out["total_up"] = float(self.total(direction="up"))
        out["total_down"] = float(self.total(direction="down"))
        out["total_metadata"] = float(self.total(kind="metadata"))
        # the distilled-student downlink (repro.distill) — kept as its
        # own roll-up so bytes-vs-AUC frontiers can price the compact
        # student against the full ensemble download directly
        out["total_student_down"] = float(self.total(kind="student_download"))
        # aggregator side payloads (repro.agg) — their own roll-up so
        # the agg_bench AUC-per-byte frontier can separate what a
        # strategy costs BEYOND the model uploads it shares with mean
        out["total_agg_extra"] = float(self.total(kind="agg_extra"))
        return out
