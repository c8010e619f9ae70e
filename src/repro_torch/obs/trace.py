"""Tracing half of the observability layer: nestable spans.

Dependency-free (stdlib only). A :class:`Tracer` records *spans* — named
wall-clock intervals with structured attributes — as the service stack runs:
``service.sweep → backend.run_rows`` plus ``store.get / store.put``. Spans
nest by call structure (Chrome's trace model infers nesting from B/E event
order per thread), so an exported trace shows exactly where a query's
wall-clock went.

Export targets:

* **Chrome-trace / Perfetto JSON** (:meth:`Tracer.write`,
  :func:`chrome_trace_doc`): load the file in ``ui.perfetto.dev`` or
  ``chrome://tracing``. Host spans live on pid ``HOST_PID`` ("service (wall
  time)"); the log engine (``repro_torch.core.gantt.to_chrome_events``) emits a
  *simulated-time* track group on its own pid, so one file can carry both
  timelines side by side.
* **Human summary** (:meth:`Tracer.summary`): a per-span-name table of
  count / total / mean / max milliseconds.

Enabling: tracing is OFF by default — the module-level :func:`span` hits a
shared no-op null span (no timestamps taken, no events stored). Turn it on with the ``REPRO_WS_TRACE=path.json`` environment
variable (trace written at process exit), or scoped via::

    with obs.trace_to("query.json") as tr:
        svc.query(...)
    print(tr.summary())

Instrumentation never changes what is computed — stored artifacts are
byte-identical with tracing on or off (tested).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Union

#: Set to a file path to enable tracing process-wide; the Chrome-trace JSON
#: is written there at interpreter exit.
TRACE_ENV = "REPRO_WS_TRACE"

#: Chrome-trace process id of the host (wall-time) track group. Simulated
#: timelines (``repro_torch.core.gantt``) use their own pid so Perfetto renders
#: them as a separate track group.
HOST_PID = 1
HOST_PROCESS_NAME = "service (wall time)"


class _NullSpan:
    """Shared do-nothing span: the entire cost of a disabled trace point."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every span is the shared no-op instance."""

    enabled = False

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN


class _Span:
    """One live span of a real :class:`Tracer` (context manager).

    Attributes passed to ``span()`` ride on the Chrome ``B`` event;
    late attributes added via :meth:`set` (values only known at the end,
    e.g. cache hit/miss, wasted_frac) ride on the matching ``E`` event —
    Perfetto merges both into the span's args.
    """

    __slots__ = ("_tracer", "name", "_attrs", "_late")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self._attrs = attrs
        self._late: dict = {}

    def set(self, **attrs) -> "_Span":
        self._late.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self._tracer._emit("B", self.name, self._attrs)
        return self

    def __exit__(self, *exc):
        self._tracer._emit("E", self.name, self._late)
        return False


class Tracer:
    """Collects spans and exports them as Chrome-trace JSON + a summary.

    Thread-safe: each thread gets its own Chrome ``tid`` (dense ints in
    order of first appearance), so B/E pairs keep stack discipline per
    thread. Timestamps are microseconds since tracer construction
    (``perf_counter_ns`` based, hence monotonic).
    """

    enabled = True

    def __init__(self, path: Union[None, str, os.PathLike] = None):
        self.path = None if path is None else Path(path)
        self._t0 = time.perf_counter_ns()
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._events)

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _emit(self, ph: str, name: str, args: dict):
        ev = {
            "ph": ph,
            "name": name,
            "cat": "service",
            "pid": HOST_PID,
            "tid": self._tid(),
            "ts": round((time.perf_counter_ns() - self._t0) / 1e3, 3),
        }
        if args:
            ev["args"] = dict(args)
        self._events.append(ev)

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def clear(self):
        self._events = []

    # -- export -------------------------------------------------------------

    def events(self) -> List[dict]:
        """Raw recorded B/E events (copies; chronological order)."""
        return [dict(e) for e in self._events]

    def chrome_events(self) -> List[dict]:
        """Recorded events plus the host track group's metadata events."""
        meta = [{"ph": "M", "name": "process_name", "pid": HOST_PID,
                 "tid": 0, "args": {"name": HOST_PROCESS_NAME}}]
        for ident, tid in sorted(self._tids.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name", "pid": HOST_PID,
                         "tid": tid, "args": {"name": f"host-{tid}"}})
        return meta + self.events()

    def trace_doc(self, *extra_event_lists) -> dict:
        """Full Chrome-trace document; ``extra_event_lists`` append other
        track groups (e.g. a simulated-time Gantt from ``core/gantt``)."""
        return chrome_trace_doc(self.chrome_events(), *extra_event_lists)

    def write(self, path: Union[None, str, os.PathLike] = None,
              *extra_event_lists) -> Path:
        """Write the Chrome-trace JSON to ``path`` (default: the tracer's
        configured path). Returns the written path."""
        out = Path(path) if path is not None else self.path
        if out is None:
            raise ValueError("Tracer has no path; pass write(path=...)")
        out.parent.mkdir(parents=True, exist_ok=True)
        doc = self.trace_doc(*extra_event_lists)
        out.write_text(json.dumps(doc, indent=1))
        return out

    # -- human summary ------------------------------------------------------

    def durations_ms(self) -> Dict[str, List[float]]:
        """Matched span durations in ms, keyed by span name (B/E pairing by
        per-thread stack discipline)."""
        stacks: Dict[int, list] = {}
        out: Dict[str, List[float]] = {}
        for ev in self._events:
            stack = stacks.setdefault(ev["tid"], [])
            if ev["ph"] == "B":
                stack.append((ev["name"], ev["ts"]))
            elif ev["ph"] == "E" and stack:
                name, ts0 = stack.pop()
                out.setdefault(name, []).append((ev["ts"] - ts0) / 1e3)
        return out

    def summary(self) -> str:
        """Per-span-name table: count, total/mean/max milliseconds."""
        durs = self.durations_ms()
        rows = sorted(((sum(v), name, v) for name, v in durs.items()),
                      reverse=True)
        lines = [f"{'span':<24s} {'count':>6s} {'total_ms':>10s} "
                 f"{'mean_ms':>9s} {'max_ms':>9s}"]
        for total, name, v in rows:
            lines.append(f"{name:<24s} {len(v):>6d} {total:>10.2f} "
                         f"{total / len(v):>9.3f} {max(v):>9.3f}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Chrome-trace document helpers (shared with core/gantt's simulated tracks).
# ---------------------------------------------------------------------------

def chrome_trace_doc(*event_lists) -> dict:
    """Merge event lists into one Chrome-trace JSON document. Metadata
    events lead; timed events are stable-sorted by (pid, tid, ts), which
    preserves B-before-E order at equal timestamps within a thread."""
    meta, timed = [], []
    for events in event_lists:
        for ev in events:
            (meta if ev.get("ph") == "M" else timed).append(ev)
    timed.sort(key=lambda e: (e.get("pid", 0), e.get("tid", 0),
                              e.get("ts", 0.0)))
    return {"traceEvents": meta + timed, "displayTimeUnit": "ms"}


def write_chrome_trace(path: Union[str, os.PathLike],
                       *event_lists) -> Path:
    """Write merged event lists as a Chrome-trace JSON file."""
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(chrome_trace_doc(*event_lists), indent=1))
    return out


# ---------------------------------------------------------------------------
# The active tracer (process-global; NullTracer unless enabled).
# ---------------------------------------------------------------------------

_active: Union[Tracer, NullTracer] = NullTracer()


def get_tracer() -> Union[Tracer, NullTracer]:
    return _active


def set_tracer(tracer: Union[None, Tracer, NullTracer]):
    """Install ``tracer`` as the process's active tracer (None disables).
    Returns the previous tracer."""
    global _active
    prev = _active
    _active = tracer if tracer is not None else NullTracer()
    return prev


def enabled() -> bool:
    return _active.enabled


def span(name: str, **attrs):
    """Open a span on the active tracer (the one call instrumented code
    makes; a shared no-op when tracing is disabled)."""
    return _active.span(name, **attrs)


@contextmanager
def trace_to(path: Union[None, str, os.PathLike] = None):
    """Scoped tracing: install a fresh :class:`Tracer` for the block, yield
    it, restore the previous tracer after; when ``path`` is given the
    Chrome-trace JSON is written on exit."""
    tracer = Tracer(path)
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
        if tracer.path is not None:
            tracer.write()


def _install_from_env():
    path = os.environ.get(TRACE_ENV, "").strip()
    if not path:
        return
    tracer = Tracer(path)
    set_tracer(tracer)
    atexit.register(lambda: tracer.write() if len(tracer) else None)


_install_from_env()
