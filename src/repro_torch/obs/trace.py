"""Span-based tracing to Chrome trace-event JSON (Perfetto-viewable).

A host-only copy of ``repro.obs.trace``: the round and engine spans
(``round.*``, ``engine.group``), the ledger's ``comm.*`` instants and
the fleet's ``fleet.execute`` / ``fleet.shed`` events exist in the port
under the same names, so one trace reader serves both packages, and
``to_json`` serialises equal events to the reference's bytes. Spans
time the host: every round phase ends in a device-to-host copy of its
scores, so a phase's span covers its device work too.

One ``Tracer`` collects events for one run and exports the standard
Chrome trace-event format (``{"traceEvents": [...]}``):

  * nested spans — ``with tracer.span("round.train", cat="round")``
    emits a begin/end ("B"/"E") pair;
  * complete events — ``tracer.complete(name, ts_us, dur_us)`` for
    spans whose duration is known up front (the fleet's simulated batch
    services);
  * instants — ``tracer.instant(name)`` for point events (every
    ``CommLedger`` record mirrors here).

Two clock sources: ``wall_clock()`` (the default) for spans that
measure the host, and ``sim_clock(SimClock)``, the fleet's simulated
milliseconds: a fleet trace reads no wall clock anywhere, so it is
byte-reproducible from the traffic seed (it equals the committed
``benchmarks/fleet_trace_baseline.json``).

With no tracer installed, ``current_tracer()`` returns ``NULL_TRACER``
whose ``enabled`` is False and whose ``span`` hands back one reusable
no-op context manager. Install a real tracer for a region with::

    tracer = Tracer()
    with use_tracer(tracer):
        run_protocol(dataset)
    tracer.export("out.json")

Attributes are typed: span/instant ``**attrs`` accept str, bool, int,
and float (numpy scalars are coerced); anything else raises at record
time.
"""
from __future__ import annotations

import contextlib
import functools
import json
import time
from typing import Callable, Dict, Iterator, List, Optional

from repro_torch.utils.logging import get_logger, kv

log = get_logger("obs")

SCHEMA = "repro.obs/v1"


def wall_clock() -> Callable[[], float]:
    """Microseconds of wall time since this clock was created."""
    t0 = time.perf_counter()  # repro: allow[wall-clock-ban] reason=the port's obs layer owns its clock reads, as repro/obs does
    return lambda: (time.perf_counter() - t0) * 1e6  # repro: allow[wall-clock-ban] reason=the port's obs layer owns its clock reads, as repro/obs does


def stopwatch() -> Callable[[], float]:
    """Elapsed wall-clock SECONDS since creation (the duration
    primitive for engine code, which reads no clock itself)."""
    t0 = time.perf_counter()  # repro: allow[wall-clock-ban] reason=the port's obs layer owns its clock reads, as repro/obs does
    return lambda: time.perf_counter() - t0  # repro: allow[wall-clock-ban] reason=the port's obs layer owns its clock reads, as repro/obs does


def sim_clock(clock) -> Callable[[], float]:
    """Microseconds of *simulated* time read off a ``fleet.SimClock``
    (or anything with ``now_ms``) — no wall-clock reads, so traces
    built on it are byte-reproducible from the run's seed."""
    return lambda: clock.now_ms * 1000.0


def _coerce_attr(name: str, key: str, val):
    if isinstance(val, (str, bool, int, float)):
        return val
    # numpy scalars (np.int64 counts, np.float64 times) quack like this
    item = getattr(val, "item", None)
    if item is not None:
        val = item()
        if isinstance(val, (str, bool, int, float)):
            return val
    raise TypeError(
        f"span {name!r} attribute {key}={val!r} is not a typed attribute "
        "(str | bool | int | float)"
    )


class _NullSpan:
    """The reusable no-op context manager the null tracer hands out."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Does nothing, as fast as possible. ``enabled`` is the one-check
    gate instrumented hot paths use before building attributes."""

    enabled = False

    def span(self, name: str, cat: str = "app", **attrs):
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "app", ts_us: Optional[float] = None, **attrs):
        return None

    def complete(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "app", **attrs):
        return None

    def export(self, path: str) -> bool:
        return False


NULL_TRACER = NullTracer()


class Tracer:
    """Collects Chrome trace events for one run.

    ``clock`` is a zero-arg callable returning the current timestamp in
    microseconds (``wall_clock()`` by default, ``sim_clock(...)`` for
    simulated time). ``pid`` namespaces the events: merged traces
    (``merge``) keep each source on its own process track, named by
    ``process_name``'s metadata ("M") event.
    """

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 pid: int = 1, tid: int = 1,
                 process_name: Optional[str] = None):
        self.clock = clock if clock is not None else wall_clock()
        self.pid = int(pid)
        self.tid = int(tid)
        self.events: List[Dict] = []
        if process_name is not None:
            self.events.append({
                "ph": "M", "name": "process_name", "pid": self.pid,
                "tid": self.tid, "ts": 0.0, "args": {"name": process_name},
            })

    def _event(self, ph: str, name: str, cat: str, ts: float, attrs: dict,
               **extra) -> None:
        args = {k: _coerce_attr(name, k, v) for k, v in attrs.items()}
        ev = {"ph": ph, "name": name, "cat": cat, "ts": float(ts),
              "pid": self.pid, "tid": self.tid, "args": args}
        ev.update(extra)
        self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "app", **attrs) -> Iterator[None]:
        """Begin/end pair; nests with the ``with`` stack."""
        self._event("B", name, cat, self.clock(), attrs)
        try:
            yield
        finally:
            self._event("E", name, cat, self.clock(), {})

    def instant(self, name: str, cat: str = "app",
                ts_us: Optional[float] = None, **attrs) -> None:
        """Point event (scope "t" = thread-local in the viewer)."""
        ts = self.clock() if ts_us is None else ts_us
        self._event("i", name, cat, ts, attrs, s="t")

    def complete(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "app", **attrs) -> None:
        """One "X" event whose duration is known up front — the fleet's
        simulated batch services land here with explicit timestamps."""
        self._event("X", name, cat, ts_us, attrs, dur=float(dur_us))

    def merge(self, other: "Tracer") -> None:
        """Append another tracer's events (they keep their own pid —
        give sub-tracers a distinct one)."""
        self.events.extend(other.events)

    def span_seconds(self) -> Dict[str, float]:
        """name -> summed wall seconds of its closed B/E spans."""
        out: Dict[str, float] = {}
        stack: List[Dict] = []
        for ev in self.events:
            if ev["ph"] == "B":
                stack.append(ev)
            elif ev["ph"] == "E":
                begin = stack.pop()
                dur = (ev["ts"] - begin["ts"]) / 1e6
                out[begin["name"]] = out.get(begin["name"], 0.0) + dur
        return out

    def to_json(self) -> str:
        """Deterministic serialization (sorted keys)."""
        payload = {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": {"schema": SCHEMA},
        }
        return json.dumps(payload, sort_keys=True, separators=(",", ":"))

    def export(self, path: str) -> bool:
        """Write the trace JSON; failures are logged rather than raised
        — a full disk must not kill the run whose trace it recorded."""
        try:
            with open(path, "w") as f:
                f.write(self.to_json())
                f.write("\n")
            return True
        except OSError as e:
            log.warning("%s", kv(event="trace_write_failed", path=path,
                                 error=str(e)))
            return False


# ----------------------------------------------------------------------
# the installed tracer: one module-level slot, null by default
# ----------------------------------------------------------------------

_CURRENT: object = NULL_TRACER


def current_tracer():
    """The installed tracer (``NULL_TRACER`` unless ``use_tracer`` is
    active). Hot paths check ``.enabled`` before building attrs."""
    return _CURRENT


@contextlib.contextmanager
def use_tracer(tracer) -> Iterator[object]:
    """Install ``tracer`` as the current tracer for the region."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer
    try:
        yield tracer
    finally:
        _CURRENT = prev


def traced(name: Optional[str] = None, cat: str = "app") -> Callable:
    """Decorator form: span the whole call on the current tracer."""
    def deco(fn):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t = _CURRENT
            if not t.enabled:
                return fn(*args, **kwargs)
            with t.span(span_name, cat=cat):
                return fn(*args, **kwargs)
        return wrapper
    return deco
