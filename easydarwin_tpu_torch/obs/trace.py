"""Low-overhead span tracer → Chrome trace-event JSON.

Records complete spans (``"ph": "X"``) into a bounded ring buffer;
``dump()`` renders the ring as a ``{"traceEvents": [...]}`` document
that chrome://tracing and Perfetto load directly.  The admin API serves
it at ``/api/v1/admin?command=trace``.

Recording one span costs two ``perf_counter_ns`` reads plus one locked
deque append of a tuple — cheap enough to leave permanently on around
the engine pass and the native egress call.  JSON rendering happens only
at dump time.

Correlation: callers thread a session's ``trace_id`` through span args
(``TRACER.end(..., trace_id=sid)``); the per-session flight recorder
(``obs.flight``) and Perfetto queries select one session's spans across
the RTSP handler → engine pass → native egress hops by that key.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager

#: default ring capacity (spans); one engine pass records ~2 spans, so
#: 4096 holds the last ~30 s of a busy 64-pass/s pump
DEFAULT_CAPACITY = 4096


class SpanTracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring: deque = deque(maxlen=capacity)
        self._pid = os.getpid()
        #: ns origin so ts starts near 0 in the viewer
        self._epoch_ns = time.perf_counter_ns()
        self.dropped_hint = 0          # appends past capacity
        #: serializes the len-check/append/dropped_hint triple — the
        #: engine pump, asyncio handlers and native callers all record
        #: concurrently, and an unlocked += is a lost-update race
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------
    def begin(self) -> int:
        """Start timestamp for a span the caller will ``end()``."""
        return time.perf_counter_ns()

    def _record(self, name: str, cat: str, t0_ns: int, dur_ns: int,
                args: dict | None) -> None:
        rec = (name, cat, t0_ns, dur_ns, threading.get_ident(),
               args or None)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped_hint += 1
            self._ring.append(rec)

    def end(self, name: str, t0_ns: int, cat: str = "relay",
            **args) -> None:
        """Record [t0_ns, now] as one complete span."""
        now = time.perf_counter_ns()
        self._record(name, cat, t0_ns, now - t0_ns, args)

    def add(self, name: str, t0_ns: int, dur_ns: int, cat: str = "relay",
            **args) -> None:
        """Record a span whose duration the caller already measured."""
        self._record(name, cat, t0_ns, dur_ns, args)

    @contextmanager
    def span(self, name: str, cat: str = "relay", **args):
        t0 = time.perf_counter_ns()
        try:
            yield
        except BaseException as e:
            # the exception path records too, tagged with the error class
            # so a Perfetto query can select failed spans
            args["error"] = type(e).__name__
            raise
        finally:
            self.end(name, t0, cat, **args)

    # -- read side ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    def records(self) -> list[tuple]:
        """Raw (name, cat, t0_ns, dur_ns, tid, args) snapshot, oldest
        first — the flight recorder's span-correlation source."""
        with self._lock:
            return list(self._ring)

    def names(self) -> set:
        return {rec[0] for rec in self.records()}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped_hint = 0

    def dump(self) -> dict:
        """Chrome trace-event format: ts/dur in MICROseconds."""
        events = []
        for name, cat, t0, dur, tid, args in self.records():
            ev = {"name": name, "cat": cat, "ph": "X",
                  "ts": (t0 - self._epoch_ns) / 1000.0,
                  "dur": dur / 1000.0, "pid": self._pid, "tid": tid}
            if args:
                ev["args"] = args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}


#: process-wide tracer every instrumented layer records into
TRACER = SpanTracer()
