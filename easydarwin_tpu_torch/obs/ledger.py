"""Wake-loop ledger — causal latency attribution for the pump.

The phase profiler answers "how long did the device pass take";
nothing answers "why did a packet wait 8 seconds before ANY pass looked
at it".  Every unit of work the single shared pump wake loop runs — the
live relay pass, megabatch bucket dispatch/harvest, the VOD pacer fill,
the DVR spill tick, HLS requant AU admission, FEC parity windows, the
checkpoint write, the cluster service tick — competes for the same
event-loop thread, so one class's service time IS every other class's
queueing delay.  The ledger makes that visible:

* every unit is tagged with a work class from the CLOSED vocabulary
  :data:`WORK_CLASSES` (tools/metrics_lint.py rejects strays);
* per wake it records **enqueue→start wait** (wake-request stamp to the
  moment the class's unit actually ran), **self service time** (nested
  classes subtracted, so per-class figures sum to the wake duration
  instead of double-counting — the same conservation discipline as the
  profiler's phase-sum invariant), and **deferred/shed counts**;
* each wake becomes one bounded ring record carrying the worst unit's
  ``trace_id`` per class (the critical-path correlation: an
  ingest→wire p99 sample decomposes into wait-vs-service per class for
  the wake that relayed it);
* the rollup feeds ``pump_wait_seconds{work_class}`` /
  ``pump_service_seconds{work_class}`` /
  ``pump_deferred_total{work_class}`` — ONE observation per class per
  wake, never per packet.

**Cost discipline** (the profiler's contract, preserved): with
``EDTPU_PROFILE=0`` every entry point early-returns after one attribute
check and :meth:`unit_start` returns ``None`` — no clock reads, no
allocation, no serialization on the hot path.  Enabled, the cost is a
handful of ``monotonic_ns`` reads and one small dict merge per class
per wake (bounded by ``len(WORK_CLASSES)``, not by traffic).

The cluster service tick runs as its OWN coroutine, not inside
``_reflect_all`` — :meth:`record` therefore tolerates having no open
wake (the unit lands in a standalone ring record) and folds into the
current wake when one is open (it stole that wake's thread time either
way).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

import numpy as np

from .metrics import TIME_BUCKETS, bucket_quantile

#: the closed work-class vocabulary (the ``work_class`` label of the
#: pump families; metrics_lint pins it).  One class per unit the pump
#: runs:
#:
#: ==============  ======================================================
#: class           the unit
#: ==============  ======================================================
#: live_relay      the per-stream reflect/step pass over live sessions
#: megabatch       scheduler harvest (begin_wake) + stage/dispatch
#:                 (end_wake) of the coalesced device pass
#: vod_fill        VOD group pacer ring fill (vod/session.py tick)
#: dvr_spill       DVR window spill tick (dvr/service.py tick)
#: hls_requant     HLS requant ladder AU admission (parse + pool submit)
#: fec_parity      FEC parity-window emission (relay/fec.py tick)
#: checkpoint      session checkpoint maybe_write (1 Hz maintenance)
#: cluster_tick    cluster service tick, with Redis roundtrip
#:                 sub-accounting (count + latency per tick)
#: ==============  ======================================================
WORK_CLASSES = ("live_relay", "megabatch", "vod_fill", "dvr_spill",
                "hls_requant", "fec_parity", "checkpoint", "cluster_tick")

#: the classes whose units put RTP on the wire — the only consumers of
#: ``note_queue_age`` (nested fec/requant units closing between a send
#: and the enclosing relay unit's end must not steal the attribution)
_WIRE_CLASSES = ("live_relay", "megabatch")

#: ring record field indices for the per-class stat list
_WAIT, _SVC, _COUNT, _DEFER = 0, 1, 2, 3


class _ClassStat:
    """Rolling per-class aggregate over every record that left the ring
    window — keeps bucket counts so snapshot p99s cover the process
    lifetime, not just the ring."""

    __slots__ = ("wait_counts", "svc_counts", "wait_total", "svc_total",
                 "count", "wakes", "deferred", "wait_max_ns", "max_trace")

    def __init__(self):
        n = len(TIME_BUCKETS) + 1
        self.wait_counts = np.zeros(n, np.int64)
        self.svc_counts = np.zeros(n, np.int64)
        self.wait_total = 0
        self.svc_total = 0
        self.count = 0
        self.wakes = 0
        self.deferred = 0
        self.wait_max_ns = 0
        self.max_trace = None


class WorkLedger:
    """Per-wake work accounting for the pump loop.

    Families default to the process registry's (obs.families); tests
    inject private ones exactly like :class:`PhaseProfiler`.
    """

    RING = 512

    def __init__(self, *, wait_hist=None, service_hist=None,
                 deferred_counter=None, clock_ns=time.perf_counter_ns,
                 ring: int = RING):
        # perf_counter_ns: the SAME clock app.py's _wake() stamps the
        # enqueue time with — waits are cross-call deltas, so the wake
        # stamp and the ledger clock must share an epoch
        self.enabled = os.environ.get("EDTPU_PROFILE", "1") != "0"
        self._clock = clock_ns
        if wait_hist is None or service_hist is None \
                or deferred_counter is None:
            from . import families
            wait_hist = wait_hist or families.PUMP_WAIT_SECONDS
            service_hist = service_hist or families.PUMP_SERVICE_SECONDS
            deferred_counter = deferred_counter \
                or families.PUMP_DEFERRED_TOTAL
        self._wait_hist = wait_hist
        self._svc_hist = service_hist
        self._deferred = deferred_counter
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=ring)
        self._stats: dict[str, _ClassStat] = {}
        self._open: dict | None = None
        self._enqueue_ns = 0
        #: total child service accumulated since the wake opened —
        #: unit_start snapshots it, unit_end subtracts the delta, so a
        #: parent class never re-counts time a nested class already
        #: claimed (fec_parity and hls_requant run INSIDE live_relay)
        self._nested_acc = 0
        #: deferrals noted while no wake was open (fold into the next)
        self._pending_defer: dict[str, int] = {}
        #: oldest delivered-item age noted since the current unit began
        #: (note_queue_age) — consumed by the next unit_end, where it
        #: widens that unit's wait to the true queue delay of its input
        self._pending_age_ns = 0
        #: how many wire samples that age covers — the same count the
        #: egress path feeds RELAY_INGEST_TO_WIRE, so the ledger's wait
        #: mass and the measured latency distribution share a unit
        self._pending_age_items = 0
        self.wakes = 0
        self.last_wake_ms = 0.0
        self.last_top_class = ""

    # -- write side (the pump) --------------------------------------------

    def begin_wake(self, wake_ns: int | None = None) -> None:
        """Open a wake record.  ``wake_ns`` is the ``perf_counter_ns``
        stamp ingest set when it first requested this wake (app.py
        ``_wake``) — the enqueue time every unit's wait is measured
        from; ``None`` (a timer-driven wake) anchors at the wake start,
        so waits then read as pure in-wake queueing.  An unclosed
        previous record is finalized first (direct ``_reflect_all``
        callers never leak an open record)."""
        if not self.enabled:
            return
        if self._open is not None:
            self.end_wake()
        now = self._clock()
        self._enqueue_ns = wake_ns if wake_ns is not None else now
        self._nested_acc = 0
        self._pending_age_ns = 0
        self._pending_age_items = 0
        self._open = {"t0": now, "dur_ns": 0, "classes": {},
                      "redis_ops": 0, "redis_ns": 0}

    def unit_start(self):
        """Stamp a unit's start; returns the opaque token ``unit_end``
        needs, or ``None`` when disabled (``unit_end(None, ...)`` is a
        no-op, so call sites need no branches of their own)."""
        if not self.enabled:
            return None
        return (self._clock(), self._nested_acc)

    def unit_end(self, token, work_class: str, *, items: int = 1,
                 trace_id=None, wait_ns: int | None = None) -> None:
        """Close a unit: service = elapsed minus any nested class's
        service recorded since ``token``; wait defaults to start minus
        the wake's enqueue stamp (``wait_ns`` overrides for units that
        know their own schedule, e.g. the cluster tick's due time)."""
        if token is None:
            return
        now = self._clock()
        t0, nested0 = token
        svc = (now - t0) - (self._nested_acc - nested0)
        if svc < 0:
            svc = 0
        # a nested parent subtracts this unit's FULL elapsed (its own
        # children are already inside _nested_acc, so adding self svc
        # telescopes to total elapsed)
        self._nested_acc += svc
        if wait_ns is None:
            wait_ns = t0 - self._enqueue_ns if self._open is not None else 0
        if wait_ns < 0:
            wait_ns = 0
        # the delivering unit's TRUE queue delay is the age of the
        # oldest item it put on the wire this pass (note_queue_age) —
        # a catch-up/backlog burst makes that seconds while the
        # wake-to-start wait stays milliseconds; the wait histogram
        # must carry the figure the ingest→wire p99 will show, or the
        # blame table can never conserve against it.  Only the classes
        # that actually put RTP on the wire consume the note — a
        # nested fec/requant unit closing between the send and the
        # enclosing relay unit's end must not steal the attribution.
        if work_class in _WIRE_CLASSES:
            if self._pending_age_ns > wait_ns:
                wait_ns = self._pending_age_ns
            # the weight must be the WIRE sample count, not the session
            # count the caller passes — a catch-up wake draining 700
            # queued packets is 700 late deliveries in the measured
            # ingest→wire distribution, and the ledger's item-weighted
            # wait mass has to match it or the blame table under-counts
            # backlog by orders of magnitude
            if self._pending_age_items > items:
                items = self._pending_age_items
            self._pending_age_ns = 0
            self._pending_age_items = 0
        self._merge(work_class, wait_ns, svc, items, trace_id)

    def record(self, work_class: str, *, wait_ns: int = 0,
               service_ns: int = 0, items: int = 1, trace_id=None,
               redis_ops: int = 0, redis_ns: int = 0) -> None:
        """Explicitly account a unit measured by its owner (the cluster
        tick coroutine).  With no wake open the unit becomes its own
        ring record — the pump was idle, but the event-loop thread was
        still occupied and a later wake may have queued behind it."""
        if not self.enabled:
            return
        standalone = self._open is None
        if standalone:
            now = self._clock()
            self._open = {"t0": now - service_ns, "dur_ns": 0,
                          "classes": {}, "redis_ops": 0, "redis_ns": 0}
        self._merge(work_class, wait_ns, service_ns, items, trace_id)
        self._open["redis_ops"] += redis_ops
        self._open["redis_ns"] += redis_ns
        self._nested_acc += service_ns
        if standalone:
            self.end_wake(count_wake=False)

    def note_queue_age(self, age_s: float, n: int = 1) -> None:
        """Note the oldest ingest→wire age delivered by the unit in
        flight (called from the egress paths with the max of the same
        per-packet latency array they feed RELAY_INGEST_TO_WIRE, and
        ``n`` = that array's length, i.e. the number of wire samples).
        The next wire-class ``unit_end`` consumes the age as a wait
        floor and ``n`` as the item weight — attributing the residence
        to the class that finally drained it, with the same mass the
        measured latency distribution carries."""
        if not self.enabled or self._open is None:
            return
        ns = int(age_s * 1e9)
        if ns > self._pending_age_ns:
            self._pending_age_ns = ns
        self._pending_age_items += n

    def defer(self, work_class: str, n: int = 1) -> None:
        """Count units a class shed/deferred instead of servicing."""
        if not self.enabled:
            return
        if self._open is not None:
            st = self._open["classes"].get(work_class)
            if st is None:
                st = self._open["classes"][work_class] = [0, 0, 0, 0, None]
            st[_DEFER] += n
        else:
            self._pending_defer[work_class] = \
                self._pending_defer.get(work_class, 0) + n

    def _merge(self, work_class: str, wait_ns: int, svc_ns: int,
               items: int, trace_id) -> None:
        if self._open is None:
            return
        st = self._open["classes"].get(work_class)
        if st is None:
            self._open["classes"][work_class] = [wait_ns, svc_ns, items,
                                                 0, trace_id]
            return
        if wait_ns > st[_WAIT]:
            st[_WAIT] = wait_ns
            if trace_id is not None:
                st[4] = trace_id
        elif st[4] is None and trace_id is not None:
            st[4] = trace_id
        st[_SVC] += svc_ns
        st[_COUNT] += items

    def end_wake(self, *, count_wake: bool = True) -> None:
        """Finalize the open record: fold pending deferrals, feed the
        metric families (one observation per class), push to the ring,
        refresh the status summary."""
        rec = self._open
        if not self.enabled or rec is None:
            return
        self._open = None
        now = self._clock()
        rec["dur_ns"] = max(now - rec["t0"], 0)
        for cls, n in self._pending_defer.items():
            st = rec["classes"].get(cls)
            if st is None:
                st = rec["classes"][cls] = [0, 0, 0, 0, None]
            st[_DEFER] += n
        self._pending_defer.clear()
        top_cls, top_wait = "", -1
        with self._lock:
            for cls, st in rec["classes"].items():
                wait_s = st[_WAIT] / 1e9
                svc_s = st[_SVC] / 1e9
                # the wait observation is ITEM-weighted: a backlog
                # burst that drains 500 queued packets at 8 s of age
                # is 500 late deliveries, not one late wake — weighting
                # by items makes the wait distribution match the
                # per-item ingest→wire latency the operator actually
                # measures (the conservation invariant depends on it).
                # Service stays per-unit: it is a property of the pass.
                w = st[_COUNT] if st[_COUNT] > 0 else 1
                self._wait_hist.observe(wait_s, n=w, work_class=cls)
                self._svc_hist.observe(svc_s, work_class=cls)
                if st[_DEFER]:
                    self._deferred.inc(st[_DEFER], work_class=cls)
                agg = self._stats.get(cls)
                if agg is None:
                    agg = self._stats[cls] = _ClassStat()
                agg.wait_counts[np.searchsorted(TIME_BUCKETS, wait_s)] += w
                agg.svc_counts[np.searchsorted(TIME_BUCKETS, svc_s)] += 1
                agg.wakes += 1
                agg.wait_total += st[_WAIT] * w
                agg.svc_total += st[_SVC]
                agg.count += st[_COUNT]
                agg.deferred += st[_DEFER]
                if st[_WAIT] > agg.wait_max_ns:
                    agg.wait_max_ns = st[_WAIT]
                    agg.max_trace = st[4]
                if st[_WAIT] > top_wait:
                    top_cls, top_wait = cls, st[_WAIT]
            self._ring.append(rec)
            if count_wake:
                self.wakes += 1
                self.last_wake_ms = rec["dur_ns"] / 1e6
                self.last_top_class = top_cls

    # -- read side ---------------------------------------------------------

    def snapshot(self) -> dict:
        """The live ledger document (``GET /api/v1/ledger``, admin
        ``command=blame`` feeds through ``blame_doc``): per-class
        lifetime aggregates (bucket-ladder p50/p99, totals, deferred,
        worst wait + its trace), wake counts, and the Redis
        sub-accounting rollup."""
        with self._lock:
            ring = list(self._ring)
            stats = {cls: (agg.wait_counts.copy(), agg.svc_counts.copy(),
                           agg.wait_total, agg.svc_total, agg.count,
                           agg.deferred, agg.wait_max_ns, agg.max_trace,
                           agg.wakes)
                     for cls, agg in self._stats.items()}
            wakes = self.wakes
            last_ms = self.last_wake_ms
            last_top = self.last_top_class
        classes = {}
        for cls, (wc, sc, wt, st_, cnt, dfr, wmax, trace,
                  wakes_) in stats.items():
            n_wait = int(wc.sum())       # item-weighted wait mass
            n_svc = int(sc.sum())
            classes[cls] = {
                "count": cnt,
                "wakes": wakes_,
                "wait_p50_ms": round(float(bucket_quantile(
                    wc, n_wait, TIME_BUCKETS, 0.50)) * 1e3, 3),
                "wait_p99_ms": round(float(bucket_quantile(
                    wc, n_wait, TIME_BUCKETS, 0.99)) * 1e3, 3),
                "wait_max_ms": round(wmax / 1e6, 3),
                "wait_mean_ms": round(wt / max(n_wait, 1) / 1e6, 3),
                "service_p99_ms": round(float(bucket_quantile(
                    sc, n_svc, TIME_BUCKETS, 0.99)) * 1e3, 3),
                "service_mean_ms": round(st_ / max(n_svc, 1) / 1e6, 3),
                "service_total_ms": round(st_ / 1e6, 3),
                "deferred": dfr,
                "worst_trace_id": trace,
            }
        redis_ops = sum(r["redis_ops"] for r in ring)
        redis_ns = sum(r["redis_ns"] for r in ring)
        ticks = sum(1 for r in ring if "cluster_tick" in r["classes"])
        wake_durs = np.array([r["dur_ns"] for r in ring], np.float64)
        return {
            "enabled": self.enabled,
            "wakes": wakes,
            "ring_len": len(ring),
            "last_wake_ms": round(last_ms, 3),
            "top_wait_class": last_top,
            "wake_dur_p99_ms": round(float(
                np.percentile(wake_durs, 99)) / 1e6, 3) if len(ring) else 0.0,
            "classes": classes,
            "redis": {
                "ticks_in_ring": ticks,
                "roundtrips": redis_ops,
                "roundtrips_per_tick": round(redis_ops / max(ticks, 1), 2),
                "latency_ms_mean": round(
                    redis_ns / max(redis_ops, 1) / 1e6, 3),
            },
        }

    def top_offenders(self, n: int = 5) -> list[dict]:
        """Top-N classes by wait p99 — the soak post-mortem table."""
        snap = self.snapshot()
        rows = [{"work_class": cls, **doc}
                for cls, doc in snap["classes"].items()]
        rows.sort(key=lambda r: r["wait_p99_ms"], reverse=True)
        return rows[:n]

    def reset(self) -> None:
        """Drop every record and aggregate (tests)."""
        with self._lock:
            self._ring.clear()
            self._stats.clear()
            self._open = None
            self._pending_defer.clear()
            self.wakes = 0
            self.last_wake_ms = 0.0
            self.last_top_class = ""


def blame_doc(snapshot: dict, *, measured_p99_ms: float | None = None,
              baseline_p50_ms: float = 0.0) -> dict:
    """Rank a ledger snapshot into the "why is p99 high" table.

    ``measured_p99_ms`` is the externally measured mixed ingest→wire
    p99 the decomposition must account for (bench's conservation
    check); ``baseline_p50_ms`` is the healthy-path floor (scheduled
    hold + nominal service — the p50 of the same latency family), so
    attribution explains the EXCESS over baseline, not the baseline
    itself.

    attributed p99 = baseline + the relay-bearing critical path: the
    worst class's queueing delay plus the service of the classes a
    relayed packet's bytes actually traverse (live_relay + megabatch).
    Per-class rows carry each class's own wait p99 — a class's wait is
    the other classes' service, which is exactly the blame being
    assigned.
    """
    classes = snapshot.get("classes", {})
    rows = [{"work_class": cls, **doc} for cls, doc in classes.items()]
    rows.sort(key=lambda r: (r.get("wait_p99_ms", 0.0),
                             r.get("service_p99_ms", 0.0)), reverse=True)
    top = rows[0]["work_class"] if rows else ""
    worst_wait = float(max((r.get("wait_p99_ms", 0.0) for r in rows),
                           default=0.0))
    relay_svc = float(sum(classes.get(c, {}).get("service_p99_ms", 0.0)
                          for c in ("live_relay", "megabatch")))
    attributed = baseline_p50_ms + worst_wait + relay_svc
    doc = {
        "top_offender": top,
        "baseline_p50_ms": round(baseline_p50_ms, 3),
        "worst_wait_p99_ms": round(worst_wait, 3),
        "relay_service_p99_ms": round(relay_svc, 3),
        "attributed_p99_ms": round(attributed, 3),
        "rows": [{
            "work_class": r["work_class"],
            "wait_p50_ms": r.get("wait_p50_ms", 0.0),
            "wait_p99_ms": r.get("wait_p99_ms", 0.0),
            "wait_max_ms": r.get("wait_max_ms", 0.0),
            "service_p99_ms": r.get("service_p99_ms", 0.0),
            "count": r.get("count", 0),
            "deferred": r.get("deferred", 0),
        } for r in rows],
        "suspects": suspect_flags(snapshot),
    }
    if measured_p99_ms is not None:
        doc["measured_p99_ms"] = round(measured_p99_ms, 3)
        doc["conservation"] = round(
            attributed / measured_p99_ms, 4) if measured_p99_ms > 0 else 1.0
    return doc


def suspect_flags(snapshot: dict) -> list[str]:
    """Cross-node suspect heuristics over ONE node's snapshot — the
    item-5 scaling-efficiency suspect list.  Multi-node correlation
    (the same flag raised on every node) is blame_report's job."""
    out = []
    rd = snapshot.get("redis", {})
    if rd.get("roundtrips_per_tick", 0) > 8:
        out.append("redis_roundtrips: %.1f roundtrips per cluster tick "
                   "(batch or cache the control-plane reads)"
                   % rd["roundtrips_per_tick"])
    if rd.get("latency_ms_mean", 0) > 5.0:
        out.append("redis_latency: %.1f ms mean roundtrip (control plane "
                   "is paying WAN/contended-broker prices)"
                   % rd["latency_ms_mean"])
    cls = snapshot.get("classes", {})
    ct = cls.get("cluster_tick", {})
    lr = cls.get("live_relay", {})
    if ct and lr and ct.get("service_p99_ms", 0.0) \
            > max(lr.get("service_p99_ms", 0.0), 1.0):
        out.append("auxiliary_ticks: cluster_tick service p99 %.1f ms "
                   "exceeds the live relay pass itself (every node pays "
                   "this on the shared loop)" % ct["service_p99_ms"])
    for c in ("checkpoint", "dvr_spill"):
        d = cls.get(c, {})
        if d.get("service_p99_ms", 0.0) > 50.0:
            out.append(f"{c}: service p99 {d['service_p99_ms']:.1f} ms "
                       "on the pump thread (move it off the wake loop)")
    return out


#: process-wide ledger the pump feeds (enabled unless EDTPU_PROFILE=0)
LEDGER = WorkLedger()
