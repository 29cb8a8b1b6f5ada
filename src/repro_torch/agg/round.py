"""One aggregation cell: extras on the wire, ledger honesty, server build.

Port of ``repro.agg.round``. ``build_cell`` is the single place where
aggregator side payloads touch the round, shared by ``run_protocol`` and
both ``run_population`` paths so the accounting cannot drift between
engines:

    device extra -> wire.encode(codec) -> ledger (kind="agg_extra")
                 -> wire.decode -> Aggregator.build(members, extras)

The server always consumes the DECODED extras. The recorded byte count
is ``len(encode())`` on the materialised path and the
``agg_extra_wire_nbytes`` shape price on the streamed path (pass
``extra_nbytes``); the two are equal, which keeps streamed and
materialised ledgers bitwise-identical.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

from repro_torch.agg.base import Aggregator
from repro_torch.comm.ledger import CommLedger
from repro_torch.comm.wire import decode, encode


def build_cell(
    agg: Aggregator,
    ex,
    ids: Sequence[int],
    outcomes_for: Callable[[Sequence[int]], Mapping[int, object]],
    ledger: Optional[CommLedger],
    tag: str,
    seed: int,
    *,
    record: bool = True,
    extra_nbytes: Optional[Callable[[int], int]] = None,
):
    """Build one (strategy, k) cell's server scorer on ``ex.device``.

    ``ex`` is the round's ``ModelExchange``/``StreamExchange`` (decoded
    members + codec); ``outcomes_for(ids)`` returns the
    ``DeviceOutcome`` mapping extras are computed from (the by-id dict
    on materialised paths, the regeneration cache on the streamed
    path). ``record=False`` skips ledger events for re-builds of cells
    whose extras were already recorded (random trials, the distill
    teacher). ``extra_nbytes(device_id)`` overrides the recorded price
    with the streamed shape price.
    """
    members = [ex.received(i) for i in ids]
    if not agg.needs_extra or not ids:
        return agg.build(members, [None] * len(members), seed, device=ex.device)
    outs = outcomes_for(ids)
    extras = []
    for i in ids:
        blob = encode(agg.device_extra(outs[i], seed), ex.codec)
        if record and ledger is not None:
            nbytes = len(blob) if extra_nbytes is None else extra_nbytes(i)
            ledger.record("up", "agg_extra", nbytes, device_id=i,
                          codec=ex.codec, tag=tag)
        extras.append(decode(blob, device=ex.device))
    return agg.build(members, extras, seed, device=ex.device)
