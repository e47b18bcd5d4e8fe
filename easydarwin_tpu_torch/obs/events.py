"""Bounded, thread-safe structured event log (JSON-lines records).

The reference EasyDarwin's operational story for "why did this session
die" was grep-the-error-log; aggregate counters cannot answer it
either.  This module is the middle layer: every lifecycle transition —
RTSP state machine steps, relay session/stream membership, broadcast
source binds, pull-relay EOFs, reliable-UDP give-ups, cluster RPCs —
emits one structured record carrying the correlation envelope
(``session``/``stream``/``trace``) plus event-specific fields.

Records are plain dicts appended to a bounded ring (oldest evicted,
evictions counted in ``events_dropped_total``); rendering to JSON lines
happens only at read time.  Registered sinks (the per-session flight
recorder, ``obs.flight``) see every record synchronously, so a session's
black box is complete at the moment it dies.

Event names are ``layer.action`` (dotted snake_case); every name and its
REQUIRED free-form fields are declared in ``SCHEMA`` below, which
``tools/metrics_lint.py`` lints (naming convention, reserved envelope
keys) and cross-checks against every ``emit("...")`` call site in the
source tree.  Emitting an undeclared event or omitting a required field
is tolerated at runtime (observability must never take the server down)
but counted in ``events_invalid_total`` and flagged ``"invalid": true``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

#: envelope keys an event's free-form fields may never shadow.
#: ``seq`` is the per-process monotonic record number (the NDJSON
#: cursor a federating scraper pages with ``since=`` and uses to COUNT
#: gaps instead of silently missing drops); ``node_id`` is the serving
#: node's cluster identity (set once via :func:`set_node`) so a cluster
#: soak's merged event streams stay attributable per node.
RESERVED_KEYS = frozenset(("ts", "level", "event", "session", "stream",
                           "trace", "invalid", "seq", "node_id"))

#: process-wide node identity stamped onto every event record and
#: flight dump: ``id`` = the cluster node id (ServerConfig.server_id),
#: ``fence`` = the node's current lease fencing token (0 = no lease).
#: Like REGISTRY/TRACER/FLIGHT this is process-global — only a server
#: actually STARTING claims it (app.start), and the cluster service
#: refreshes the fence each heartbeat.
NODE: dict = {"id": None, "fence": 0}


def set_node(node_id: str | None, fence: int | None = None) -> None:
    """Claim the process's node identity (and optionally its current
    lease fencing token) for event/flight attribution."""
    if node_id is not None:
        NODE["id"] = str(node_id)
    if fence is not None:
        NODE["fence"] = int(fence)

LEVELS = ("debug", "info", "warn", "error")

#: default ring capacity (records); lifecycle events are rare relative to
#: packets — 4096 holds hours of a busy server's session churn
DEFAULT_CAPACITY = 4096

#: event name -> REQUIRED free-form field names (the envelope —
#: session/stream/trace — is always optional).  tools/metrics_lint.py
#: validates this table and the call sites against it.
SCHEMA: dict[str, tuple[str, ...]] = {
    # RTSP state machine (server/rtsp.py)
    "rtsp.announce": ("status",),
    "rtsp.setup": ("status", "track", "mode"),
    "rtsp.play": ("status",),
    "rtsp.record": ("status",),
    "rtsp.pause": ("status",),
    "rtsp.teardown": ("status",),
    "rtsp.error": ("method", "status"),
    "rtsp.exception": ("error",),
    "rtsp.close": ("reason",),
    # relay session / stream lifecycle (relay/session.py, relay/stream.py)
    "session.create": ("path", "streams"),
    "session.remove": ("path",),
    "stream.output_add": ("track", "outputs"),
    "stream.output_remove": ("track", "outputs"),
    # broadcast sources (relay/source.py)
    "source.open": ("path",),
    "source.close": ("path",),
    # pull relays (relay/pull.py)
    "pull.start": ("url",),
    "pull.eof": ("url",),
    "pull.stop": ("url", "packets"),
    # reliable-UDP retransmit path (relay/reliable.py)
    "reliable.expired": ("expired", "resent"),
    # cluster RPCs (cluster/cms.py)
    "cms.rpc": ("msg_type",),
    "cms.register": ("serial",),
    "cms.push_stream": ("serial", "url"),
    # lapsed-keepalive device reaping (cluster/cms.py)
    "cms.device_offline": ("serial",),
    # cluster robustness tier (cluster/presence.py, placement.py,
    # pull.py, service.py): leases + fencing, placement moves, the pull
    # retry/breaker envelope, and checkpoint-driven migration.  All
    # latched per transition, never per tick.
    "cluster.lease_acquire": ("node", "token"),
    "cluster.lease_lost": ("node",),
    "cluster.fence_rejected": ("node", "key"),
    "cluster.placement_move": ("owner", "prev"),
    "cluster.pull_retry": ("url", "attempt"),
    "cluster.breaker_open": ("url", "failures"),
    "cluster.breaker_close": ("url",),
    "cluster.migrate": ("from_node", "outputs"),
    "cluster.drain": ("node", "streams"),
    # load-aware control plane: a rebalance is the planned
    # drain of one hot stream to a named target; a refuse is one new
    # SETUP answered 453/305 at the admission gate
    "cluster.rebalance": ("target",),
    "cluster.refuse": ("action",),
    # egress backend probe ladder (server/app.py + relay/fanout.py):
    # ONE latched event per rung drop — backend = the rung
    # fallen from, fallback = the rung landed on, reason = the probe /
    # runtime errno that forced it (never per send, never a hard_error)
    "egress.backend_fallback": ("backend", "fallback", "reason"),
    # flight recorder (obs/flight.py)
    "flight.dump": ("reason",),
    # SLO watchdog (obs/slo.py): one per burn-window rising edge (latched,
    # never per tick) / falling edge
    "slo.violation": ("slo", "burn"),
    "slo.recover": ("slo",),
    # resilience subsystem (easydarwin_tpu/resilience/)
    # fault.injected is rate-limited to one per site per second with the
    # accumulated count — never per packet
    "fault.injected": ("site", "count"),
    # ladder transitions are latched per rung change, never per tick;
    # soak --chaos pairs degrades with recovers per stream
    "ladder.degrade": ("rung", "from_rung", "reason"),
    "ladder.recover": ("rung", "from_rung"),
    "ladder.shed": ("outputs",),
    # checkpoint lifecycle (resilience/checkpoint.py)
    "ckpt.save": ("sessions",),
    "ckpt.restore": ("sessions", "outputs"),
    # interleaved-TCP checkpoint parity: a parked kind=tcp
    # record was adopted by a re-connecting player / aged out unclaimed
    "ckpt.tcp_reattach": ("track",),
    "ckpt.tcp_orphan": ("reason",),
    # lossy-WAN reliability tier (relay/fec.py): the oracle-
    # mismatch latch is one event per stream (the stream serves host
    # parity from then on); the RTX budget give-up is latched per
    # output's FIRST exhaustion, never per NACKed seq
    "fec.host_fallback": ("mismatches",),
    "rtx.giveup": ("giveups",),
    # a fully-remote asset bootstrapped from a peer's meta/index docs
    # (the /api/v1/dvrmeta sync)
    "dvr.bootstrap": ("tracks",),
    # DVR / time-shift subsystem (dvr/): arm/finalize are per
    # asset lifecycle; catchup is latched once per joining track; a
    # retention-evicted window under an active cursor is NOT an event
    # (the eviction counter covers it — it is normal horizon movement)
    "dvr.arm": ("path", "tracks"),
    "dvr.finalize": ("path", "windows"),
    "dvr.catchup": ("track", "join_id"),
    # erasure-coded storage tier (storage/): store is per
    # finalized asset (one event carrying the shard fan-out); a
    # reconstruct event fires per stripe SOLVE (a rare degraded read),
    # never per direct shard read; repair is per repair-tick batch;
    # scrub_error and solve_singular are per detected corruption /
    # unsolvable read — loud by design, any occurrence is a bug or a
    # real loss beyond the parity budget.  The device/oracle parity
    # divergence latch reuses fec.host_fallback semantics.
    "storage.store": ("asset", "shards"),
    "storage.reconstruct": ("asset", "missing"),
    "storage.repair": ("asset", "shards"),
    "storage.scrub_error": ("asset", "shard"),
    "storage.solve_singular": ("asset", "missing"),
    "storage.host_fallback": ("mismatches",),
    # recording crash safety (vod/record.py): a leftover <file>.tmp
    # found at boot means a recorder died mid-write — the orphan is
    # reported, never silently deleted or served
    "record.orphan": ("file",),
    # fleet federation (cluster/service.py): a peer whose
    # lease died while its Fleet:{node} rollup still lives flips to
    # stale (latched per transition, never per tick); coming back flips
    # it live again.  The aggregate endpoint marks such rollups
    # ``stale`` so dashboards show last-known state, never fresh lies.
    "fleet.node_stale": ("node",),
    "fleet.node_live": ("node",),
    # audience observatory (obs/audience.py): one latched
    # event per stall-storm rising edge — k-of-n subscribers of one
    # stream entered stall inside the storm window; ``blamed`` carries
    # the wake ledger's current top wait class so the viewer-facing
    # symptom names the server-side cause.  Never per subscriber,
    # never per tick.
    "audience.stall_storm": ("stalled", "subscribers", "blamed"),
}


class EventLog:
    """Bounded ring of structured event records + fan-out to sinks."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._sinks: list = []
        self.dropped = 0
        #: last assigned per-process sequence number (record envelope
        #: ``seq`` — assigned under the ring lock, so ring order and seq
        #: order agree and a ``since=`` cursor slices correctly)
        self.seq = 0

    # -- wiring ------------------------------------------------------
    def add_sink(self, fn) -> None:
        """Register ``fn(record: dict)`` called synchronously per emit
        (the flight recorder registers here).  A raising sink is
        swallowed and counted (``events_sink_failures_total``), never
        removed — one transient MemoryError must not silently disable
        the flight recorder forever."""
        self._sinks.append(fn)

    # -- write side --------------------------------------------------
    def emit(self, event: str, *, level: str = "info",
             session_id: str | None = None, stream: str | None = None,
             trace_id: str | None = None, **fields) -> dict:
        """Record one structured event; returns the record."""
        from . import families
        rec: dict = {"ts": round(time.time(), 6), "level": level,
                     "event": event}
        if session_id is not None:
            rec["session"] = session_id
        if stream is not None:
            rec["stream"] = stream
        if trace_id is not None:
            rec["trace"] = trace_id
        required = SCHEMA.get(event)
        if (required is None or level not in LEVELS
                or not set(required) <= fields.keys()
                or not RESERVED_KEYS.isdisjoint(fields)):
            rec["invalid"] = True
            families.EVENTS_INVALID.inc()
        for k in RESERVED_KEYS:
            fields.pop(k, None)         # envelope keys stay authoritative
        rec.update(fields)
        if NODE["id"] is not None:
            rec["node_id"] = NODE["id"]
        with self._lock:
            self.seq += 1
            rec["seq"] = self.seq
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
                families.EVENTS_DROPPED.inc()
            self._ring.append(rec)
        families.EVENTS_EMITTED.inc(level=level if level in LEVELS
                                    else "error")
        for sink in tuple(self._sinks):
            try:
                sink(rec)
            except Exception:
                families.EVENTS_SINK_FAILURES.inc()
        return rec

    # -- read side ---------------------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    def tail(self, n: int | None = None,
             since: int | None = None) -> list[dict]:
        """Newest-last snapshot of the last ``n`` records (all if None;
        n <= 0 is empty — recs[-0:] would be the whole ring).  ``since``
        keeps only records with ``seq > since`` — the NDJSON cursor: a
        scraper pages with the last seq it saw, and a jump in seq
        numbers (or ``self.dropped`` growing) tells it exactly how many
        records the bounded ring evicted before it came back.

        With a cursor the page is the OLDEST ``n`` matching records —
        a scraper more than ``n`` behind advances through everything
        still in the ring instead of skipping to the newest page and
        miscounting the skipped middle as drops.  Without a cursor the
        call is a tail (newest ``n``), as before."""
        with self._lock:
            recs = list(self._ring)
        if since is not None:
            recs = [r for r in recs if r.get("seq", 0) > since]
        if n is None:
            return recs
        if n <= 0:
            return []
        return recs[:n] if since is not None else recs[-n:]

    def dump_lines(self, n: int | None = None,
                   since: int | None = None) -> list[str]:
        """JSON-lines rendering (one compact JSON object per record)."""
        return [json.dumps(r, separators=(",", ":"), default=str)
                for r in self.tail(n, since)]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0


#: process-wide event log every instrumented layer emits into
EVENTS = EventLog()
