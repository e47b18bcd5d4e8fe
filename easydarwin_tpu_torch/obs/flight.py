"""Per-session flight recorder — the crash black box.

Every RTSP session registers a small ring here (its last ~256 structured
events, fed synchronously by the ``obs.events`` sink).  On *abnormal*
teardown — timeout sweep, uncaught exception, hard protocol error — the
ring plus the session's span summaries (every ``SpanTracer`` record
whose args carry the session's ``trace_id``) is frozen into a
self-contained JSON document: written to ``dump_dir`` (best-effort),
kept in a bounded in-memory map for live retrieval, and counted in
``flight_dumps_total``.  A clean teardown discards the ring — flight
recorders describe crashes, not history.

Retrieval: ``GET /api/v1/admin?command=flight&session=<id>`` and
``GET /api/v1/sessions/<id>/trace`` both resolve through
``FlightRecorder.lookup`` — a live session answers with its current ring
(no dump side effects), an ended one with its stored dump.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque

from .events import EVENTS, NODE
from .trace import TRACER

#: events kept per live session (the ~256-event black-box window)
RING_CAPACITY = 256
#: completed dumps kept in memory for retrieval
MAX_DUMPS = 64


class _Box:
    __slots__ = ("ring", "trace_id", "meta", "created")

    def __init__(self, trace_id: str | None, meta: dict):
        self.ring: deque = deque(maxlen=RING_CAPACITY)
        self.trace_id = trace_id
        self.meta = meta
        self.created = time.time()


class FlightRecorder:
    def __init__(self, dump_dir: str | None = None):
        self.dump_dir = dump_dir or os.path.join(
            tempfile.gettempdir(), "edtpu_flight")
        self._lock = threading.Lock()
        self._live: dict[str, _Box] = {}
        self.dumps: "OrderedDict[str, dict]" = OrderedDict()

    # -- session lifecycle -------------------------------------------
    def register(self, session_id: str, *, trace_id: str | None = None,
                 **meta) -> None:
        with self._lock:
            if session_id not in self._live:
                self._live[session_id] = _Box(trace_id, meta)

    def discard(self, session_id: str) -> None:
        """Clean teardown: forget the ring, keep nothing."""
        with self._lock:
            self._live.pop(session_id, None)

    # -- event sink (registered on obs.events.EVENTS) ----------------
    def on_event(self, rec: dict) -> None:
        sid = rec.get("session")
        if sid is None:
            return
        with self._lock:
            box = self._live.get(sid)
            if box is not None:
                box.ring.append(rec)

    # -- span correlation --------------------------------------------
    @staticmethod
    def _span_summaries(trace_id: str | None, limit: int = 256) -> list[dict]:
        """Chrome-trace-style summaries of every ring span stamped with
        this session's trace id (newest ``limit``)."""
        if not trace_id:
            return []
        out = []
        for name, cat, t0, dur, tid, args in TRACER.records():
            if args and args.get("trace_id") == trace_id:
                s = {"name": name, "cat": cat, "ts_us": t0 / 1000.0,
                     "dur_us": dur / 1000.0, "tid": tid}
                extra = {k: v for k, v in args.items() if k != "trace_id"}
                if extra:
                    s["args"] = extra
                out.append(s)
        return out[-limit:]

    # -- dumping ------------------------------------------------------
    def _doc(self, session_id: str, box: _Box, reason: str | None,
             events: list | None = None) -> dict:
        """``events`` must be a snapshot taken under ``self._lock`` when
        the box is still live (on_event appends concurrently; iterating
        the deque unlocked raises 'deque mutated during iteration')."""
        return {
            "session": session_id,
            "trace": box.trace_id,
            "reason": reason,
            "ts": round(time.time(), 6),
            # node identity + fencing token: a cluster soak
            # collects dumps from N nodes into one place — without
            # these, two nodes' dumps for one migrated session are
            # indistinguishable
            "node_id": NODE["id"],
            "fence": NODE["fence"],
            "meta": box.meta,
            "events": list(box.ring) if events is None else events,
            "spans": self._span_summaries(box.trace_id),
        }

    def dump(self, session_id: str, *, reason: str,
             keep_live: bool = False) -> dict | None:
        """Freeze a session's black box.  Returns the document (None for
        an unregistered session).

        ``keep_live=False`` (abnormal teardown): the box is removed —
        the session is gone.  ``keep_live=True`` (SLO quality flagging):
        the dump is a SNAPSHOT and the live box stays registered, so the
        recorder keeps recording and a later genuine crash still gets
        its own dump — flagging must never disable the black box it
        flags."""
        from . import families
        with self._lock:
            if keep_live:
                box = self._live.get(session_id)
                events = list(box.ring) if box is not None else None
            else:
                box = self._live.pop(session_id, None)
                events = None
            # migration dedupe guard: during a live migration
            # the SAME session id can be flagged on two nodes (the dying
            # owner's sweep and the adopter's SLO flag race each other);
            # a dump already held under a NEWER-or-equal fence from a
            # DIFFERENT node is the authoritative black box — a second
            # document would just shadow it in every by-session lookup.
            # Scope: this guards the SHARED-recorder topology (multiple
            # in-process servers — the e2e/test shape — or a merged
            # collection the operator loads back); separate processes
            # never collide in memory, and their on-disk dumps are
            # disambiguated by the node id in the filename instead.
            prior = self.dumps.get(session_id)
            if (box is not None and prior is not None
                    and prior.get("node_id") not in (None, NODE["id"])
                    and int(prior.get("fence") or 0)
                    >= int(NODE["fence"] or 0)):
                families.FLIGHT_DUMPS_DEDUPED.inc()
                return prior
        if box is None:
            return None
        doc = self._doc(session_id, box, reason, events)
        path = None
        node_tag = f"{NODE['id']}_" if NODE["id"] else ""
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            # node id + timestamp in the name: a cluster soak's shared
            # collection directory never collides two nodes' dumps for
            # one migrated session
            path = os.path.join(
                self.dump_dir,
                f"flight_{node_tag}{session_id}_{int(time.time())}.json")
            # compact, one write: this runs on the event loop during
            # teardown (timeout sweeps dump several sessions per pass),
            # so the file must cost one small sequential write, not a
            # pretty-printed stream of tiny ones
            blob = json.dumps(doc, separators=(",", ":"), default=str)
            with open(path, "w", encoding="utf-8") as f:
                f.write(blob)
        except OSError:
            path = None                 # a full disk must not kill teardown
        doc["file"] = path
        with self._lock:
            self.dumps[session_id] = doc
            while len(self.dumps) > MAX_DUMPS:
                self.dumps.popitem(last=False)
        families.FLIGHT_DUMPS.inc()
        EVENTS.emit("flight.dump", level="warn", session_id=session_id,
                    stream=box.meta.get("path"), trace_id=box.trace_id,
                    reason=reason, file=path)
        return doc

    def dump_path(self, path: str, *, reason: str) -> list[str]:
        """Freeze every live session on stream ``path`` (the SLO
        watchdog's abnormal-QUALITY flagging — the sessions are alive
        and misbehaving, not torn down).  Returns the session ids
        dumped; [] when nothing live matches."""
        with self._lock:
            sids = [sid for sid, box in self._live.items()
                    if box.meta.get("path") == path]
        return [sid for sid in sids
                if self.dump(sid, reason=reason,
                             keep_live=True) is not None]

    # -- retrieval ----------------------------------------------------
    def lookup(self, session_id: str) -> dict | None:
        """Live ring (no side effects) or stored dump; None = unknown."""
        with self._lock:
            box = self._live.get(session_id)
            if box is None:
                return self.dumps.get(session_id)
            events = list(box.ring)     # snapshot while appends are held
        return {**self._doc(session_id, box, None, events), "live": True}

    def live_sessions(self) -> list[str]:
        with self._lock:
            return sorted(self._live)

    def clear(self) -> None:
        with self._lock:
            self._live.clear()
            self.dumps.clear()


#: process-wide recorder; every emitted event with a session lands here
FLIGHT = FlightRecorder()
EVENTS.add_sink(FLIGHT.on_event)
