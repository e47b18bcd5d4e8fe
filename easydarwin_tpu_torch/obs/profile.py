"""Always-on phase profiler: ingest→wire latency ATTRIBUTION.

The relay measures its end-to-end ingest→wire latency and correlates
it per session; this module answers the next operator question
— *where does the time go*.  Every relay pass is decomposed into named
phases (the closed ``PHASES`` vocabulary below), each observed into
``relay_phase_seconds{engine,phase}``, so a single PromQL ratio shows
whether a p99 regression lives in H2D staging, the fused device step,
the D2H param fetch, the native sendmmsg scatter, RTCP/QoS work, or
plain wake→pass queueing delay — the same stage decomposition the
reference server's own ``Doc/`` epoll/relay optimization notes were
driven by, but continuous and overhead-bounded instead of ad-hoc.

Components:

* **Phase recording** — ``PROFILER.observe()`` for a single bracket the
  caller timed, ``account_pass()`` for a whole pass's merged phase
  dict.  A pass costs a handful of ``perf_counter_ns`` reads plus one
  ``Histogram.observe`` per touched phase (never per packet);
  ``tests/test_profile.py`` bounds the steady-state overhead at 5% of a
  pass.  ``EDTPU_PROFILE=0`` disables everything (the methods
  early-return), but the default is ON — attribution you have to enable
  after the incident is attribution you don't have.
* **Phase-sum invariant** — a pass recorded with ``check=True`` asserts
  Σ(phases) ≈ bracketing total within tolerance; disagreement means the
  instrumentation brackets different work than the pass timer (the
  drift the old ``relay_pipeline`` timing had, where the device
  block-until-ready leaked into whoever touched the result next) and
  counts into ``profile_phase_drift_total``.
* **Per-session attribution** — engines report wire bytes, phase time
  and per-packet latencies per session path into a bounded LRU map;
  ``snapshot()`` ranks the top sessions by wire bytes and by p99
  latency contribution.  Served live at ``admin command=top`` and
  ``GET /api/v1/profile``.
* **Compile capture** — the first build and load of the kernel
  library notes its wall time under each kernel's name
  (``ops.kernel_lib.library``), so a latency spike at t=0 is
  attributable to the build, not the wire.
* **pprof export** — ``build_pprof()`` folds the existing span ring
  into a gzipped pprof ``Profile`` proto (samples = span count + wall
  ns, stacks = span name under its category), served at
  ``GET /debug/profile`` for ``go tool pprof`` / speedscope / pprof.me
  flamegraphs with zero extra runtime cost — the ring is already there.
"""

from __future__ import annotations

import gzip
import os
import threading
import time
from collections import OrderedDict

import numpy as np

from . import families
from .metrics import TIME_BUCKETS, bucket_quantile
from .trace import TRACER

#: the CLOSED phase vocabulary (tools/metrics_lint.py rejects children of
#: relay_phase_seconds outside this set).  ``stage_gather`` is the
#: megabatch scheduler's host gather of ring slices into the contiguous
#: upload buffer; ``h2d_overlap`` is the fetch wait on a stacked result
#: that was NOT yet ready at harvest — the un-hidden remainder of
#: transfer+compute (a ready result's fetch files under plain ``d2h``),
#: so any weight here means double-buffering stopped hiding the device
#: ``egress_io_uring`` is the same wire-scatter bracket as
#: ``egress_native``, filed under its own phase when the io_uring
#: backend serves the pass — the backend-labelled attribution that lets
#: a dashboard compare per-pass egress cost across backends directly
#: ``cache_fill`` is the VOD segment cache's window pack (packetize +
#: classify + staging-row pre-pack, vod/cache.py) — filed under the
#: ``vod`` engine so a dashboard can see what hot-asset admission costs
#: ``spill`` is the DVR recorder's window snapshot+append (dvr/spill.py:
#: ring rows → spill file + index update) — filed under the ``dvr``
#: engine, so what continuous recording costs the pump is attributable
PHASES = ("wake_to_pass", "h2d", "device_step", "d2h", "egress_native",
          "egress_io_uring", "rtcp_qos", "stage_gather", "h2d_overlap",
          "cache_fill", "spill")
#: engines that record phases: the native sendmmsg fast path, the
#: [S,P,12] batch-header path, the scalar oracle, the model
#: pipeline, the pump loop (wake→pass only), the cross-stream megabatch
#: scheduler, the VOD pacer/cache tier, the DVR spill/time-shift tier
#: and test harnesses
ENGINES = ("native", "batch", "scalar", "pipeline", "pump", "megabatch",
           "vod", "dvr", "test")

#: sessions tracked for top-N attribution (LRU beyond this)
MAX_SESSIONS = 256
#: Σ(phases) vs pass-total tolerance for checked passes
DRIFT_TOLERANCE = 0.10
#: absolute slack under which drift is noise, not signal: sub-ms passes
#: have µs-scale unphased tails, and a scheduler preemption landing in
#: that tail is wall-clock noise, not instrumentation drift.  The drift
#: counter is an AGGREGATE signal — judge its rate, not single passes
DRIFT_SLACK_NS = 200_000


class _SessionStat:
    __slots__ = ("wire_bytes", "passes", "phase_ns", "lat_counts",
                 "lat_sum", "lat_count", "last_seen")

    def __init__(self):
        self.wire_bytes = 0
        self.passes = 0
        self.phase_ns: dict[str, int] = {}
        #: per-session latency histogram on the shared TIME_BUCKETS
        #: ladder (one int array, filled by vectorized bincount)
        self.lat_counts = np.zeros(len(TIME_BUCKETS) + 1, dtype=np.int64)
        self.lat_sum = 0.0
        self.lat_count = 0
        self.last_seen = 0.0

    def quantile(self, q: float) -> float:
        return bucket_quantile(self.lat_counts, self.lat_count,
                               TIME_BUCKETS, q)


class PhaseProfiler:
    """Low-overhead per-pass phase recorder + per-session attribution.

    The process-wide instance is ``PROFILER``; tests build private ones
    against private histogram families freely.
    """

    def __init__(self, hist=None, drift_counter=None,
                 max_sessions: int = MAX_SESSIONS):
        self.enabled = os.environ.get("EDTPU_PROFILE", "1") != "0"
        self._hist = hist if hist is not None \
            else families.RELAY_PHASE_SECONDS
        self._drift = drift_counter if drift_counter is not None \
            else families.PROFILE_PHASE_DRIFT
        self._bounds = np.asarray(TIME_BUCKETS)
        self._lock = threading.Lock()
        self._sessions: "OrderedDict[str, _SessionStat]" = OrderedDict()
        self._max_sessions = max_sessions
        self.drift_checks = 0
        self.drift_violations = 0
        self.last_drift: dict | None = None
        #: name → {"compile_s": …, "cost": {...}} (first-trace capture)
        self.compiles: dict[str, dict] = {}

    # -- hot path ----------------------------------------------------------
    def observe(self, phase: str, engine: str, dur_ns: int) -> None:
        """Observe a duration the caller already measured."""
        if self.enabled and dur_ns >= 0:
            self._hist.observe(dur_ns / 1e9, engine=engine, phase=phase)

    def account_pass(self, engine: str, total_ns: int,
                     phases: dict[str, int], *, path: str | None = None,
                     wire_bytes: int = 0, check: bool = False,
                     count_pass: bool = True,
                     tolerance: float = DRIFT_TOLERANCE) -> None:
        """Record one pass: observe every non-zero phase, optionally
        enforce the Σ(phases) ≈ total invariant, and attribute wire
        bytes / phase time to the session ``path``.  A mixed pass that
        reports per-engine slices calls this once per engine with the
        same path and ``count_pass=False`` on all but the first, so the
        session's phase_ns sees every slice while passes/wire_bytes
        count the pass exactly once."""
        if not self.enabled:
            return
        for ph, ns in phases.items():
            if ns > 0:
                self._hist.observe(ns / 1e9, engine=engine, phase=ph)
        if check:
            self.drift_checks += 1
            s = sum(phases.values())
            if abs(total_ns - s) > max(tolerance * total_ns,
                                       DRIFT_SLACK_NS):
                self.drift_violations += 1
                self._drift.inc()
                self.last_drift = {"engine": engine,
                                   "total_ns": int(total_ns),
                                   "phase_sum_ns": int(s)}
        if path is not None:
            with self._lock:
                st = self._session(path)
                if count_pass:
                    st.wire_bytes += wire_bytes
                    st.passes += 1
                for ph, ns in phases.items():
                    if ns > 0:
                        st.phase_ns[ph] = st.phase_ns.get(ph, 0) + ns

    def account_latency(self, path: str | None, values_s) -> None:
        """Fold one pass's delivered-packet latencies (seconds, array)
        into the session's attribution histogram — one searchsorted +
        bincount per PASS, mirroring ``Histogram.observe_many``."""
        if not self.enabled or path is None:
            return
        values = np.asarray(values_s, dtype=np.float64).ravel()
        if values.size == 0:
            return
        idx = np.searchsorted(self._bounds, values, side="left")
        binned = np.bincount(idx, minlength=len(self._bounds) + 1)
        with self._lock:
            st = self._session(path)
            st.lat_counts += binned
            st.lat_sum += float(values.sum())
            st.lat_count += int(values.size)

    def _session(self, path: str) -> _SessionStat:
        """Caller holds ``self._lock``."""
        st = self._sessions.get(path)
        if st is None:
            st = self._sessions[path] = _SessionStat()
            while len(self._sessions) > self._max_sessions:
                self._sessions.popitem(last=False)
        else:
            self._sessions.move_to_end(path)
        st.last_seen = time.time()
        return st

    # -- compile capture ---------------------------------------------------
    def note_compile(self, name: str, compile_s: float,
                     cost: dict | None = None) -> None:
        """First-build capture: build and load wall time (+ an optional
        cost document) for one kernel."""
        if name not in self.compiles:
            self.compiles[name] = {"compile_s": round(compile_s, 6),
                                   **({"cost": cost} if cost else {})}

    # -- read side ---------------------------------------------------------
    def top_offender(self, max_age_s: float = 120.0) -> str | None:
        """Session path with the worst attributed p99 latency among
        RECENTLY active sessions (the SLO watchdog's flight-flagging
        target); None when nothing recent is tracked.  The recency
        filter matters: attribution counts are all-time cumulative, and
        without it a spike at boot would outrank the session actually
        burning the budget an hour later."""
        cutoff = time.time() - max_age_s
        best_path, best_p99 = None, -1.0
        with self._lock:
            items = list(self._sessions.items())
        for path, st in items:
            if st.lat_count == 0 or st.last_seen < cutoff:
                continue
            p99 = st.quantile(0.99)
            if p99 > best_p99:
                best_path, best_p99 = path, p99
        return best_path

    def snapshot(self, top_n: int = 5) -> dict:
        """The live ``command=top`` / ``GET /api/v1/profile`` document:
        per-phase summaries (by engine) + top sessions by wire bytes and
        by p99 latency contribution + drift/compile notes."""
        phases: dict[str, dict] = {}
        # dict() snapshot: a concurrent pass may add a label child
        for key, st in sorted(dict(self._hist._states).items()):
            engine, phase = key
            d = phases.setdefault(phase, {})
            d[engine] = {
                "count": st.count,
                "mean_ms": round(st.sum / st.count * 1e3, 4)
                if st.count else 0.0,
                "p50_ms": round(
                    self._hist._child_quantile(st, 0.5) * 1e3, 4),
                "p99_ms": round(
                    self._hist._child_quantile(st, 0.99) * 1e3, 4),
            }
        with self._lock:
            items = list(self._sessions.items())
        rows = []
        for path, st in items:
            rows.append({
                "path": path,
                "wire_bytes": st.wire_bytes,
                "passes": st.passes,
                "packets": st.lat_count,
                "p50_ms": round(st.quantile(0.5) * 1e3, 4),
                "p99_ms": round(st.quantile(0.99) * 1e3, 4),
                "phase_ms": {ph: round(ns / 1e6, 4)
                             for ph, ns in sorted(st.phase_ns.items())},
            })
        by_bytes = sorted(rows, key=lambda r: r["wire_bytes"],
                          reverse=True)[:top_n]
        by_p99 = sorted((r for r in rows if r["packets"]),
                        key=lambda r: r["p99_ms"], reverse=True)[:top_n]
        return {
            "enabled": self.enabled,
            "phases": phases,
            "top_by_bytes": by_bytes,
            "top_by_p99": by_p99,
            "drift": {"checks": self.drift_checks,
                      "violations": self.drift_violations,
                      "last": self.last_drift},
            "compiles": self.compiles,
        }

    def clear(self) -> None:
        with self._lock:
            self._sessions.clear()
        self.drift_checks = self.drift_violations = 0
        self.last_drift = None
        self.compiles.clear()


#: process-wide profiler every instrumented engine records into
PROFILER = PhaseProfiler()


# ---------------------------------------------------------------- pprof
# Minimal hand-rolled encoder for the pprof Profile proto
# (github.com/google/pprof/proto/profile.proto) — protobuf wire format is
# just tag-varints, and the dependency-free registry discipline applies
# here too.  Field numbers below are from profile.proto.

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _msg(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _packed(num: int, values) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return _msg(num, payload)


def _int(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def build_pprof(tracer=None, *, period_ns: int = 1) -> bytes:
    """Fold the span ring into a gzipped pprof ``Profile``.

    Stacks are ``category / span-name`` (leaf first, as pprof wants);
    sample values are [span count, total wall nanoseconds].  Aggregation
    happens here at request time — recording stays as cheap as the span
    ring itself.
    """
    records = (tracer or TRACER).records()
    # aggregate: (cat, name) → [count, ns]
    agg: dict[tuple[str, str], list[int]] = {}
    for name, cat, _t0, dur, _tid, _args in records:
        cell = agg.get((cat, name))
        if cell is None:
            agg[(cat, name)] = [1, int(dur)]
        else:
            cell[0] += 1
            cell[1] += int(dur)

    strings: list[str] = [""]           # string_table[0] must be ""
    sidx: dict[str, int] = {"": 0}

    def s(v: str) -> int:
        i = sidx.get(v)
        if i is None:
            i = sidx[v] = len(strings)
            strings.append(v)
        return i

    functions: dict[str, int] = {}      # name → function id
    fun_msgs: list[bytes] = []
    locations: dict[str, int] = {}      # name → location id
    loc_msgs: list[bytes] = []

    def loc(name: str) -> int:
        lid = locations.get(name)
        if lid is not None:
            return lid
        fid = functions.get(name)
        if fid is None:
            fid = functions[name] = len(fun_msgs) + 1
            fun_msgs.append(_int(1, fid) + _int(2, s(name))
                            + _int(3, s(name)))
        lid = locations[name] = len(loc_msgs) + 1
        loc_msgs.append(_int(1, lid) + _msg(4, _int(1, fid)))
        return lid

    samples: list[bytes] = []
    for (cat, name), (count, ns) in sorted(agg.items()):
        ids = [loc(name), loc(f"cat:{cat}")]       # leaf first
        samples.append(_packed(1, ids) + _packed(2, [count, ns]))

    out = bytearray()
    # sample_type: [(samples, count), (time, nanoseconds)]
    out += _msg(1, _int(1, s("samples")) + _int(2, s("count")))
    out += _msg(1, _int(1, s("time")) + _int(2, s("nanoseconds")))
    # period_type (wall nanoseconds) BEFORE the string table serializes —
    # an intern after emission would silently vanish from the profile
    period_type = _msg(11, _int(1, s("wall")) + _int(2, s("nanoseconds")))
    for m in samples:
        out += _msg(2, m)
    for m in loc_msgs:
        out += _msg(4, m)
    for m in fun_msgs:
        out += _msg(5, m)
    for v in strings:
        out += _msg(6, v.encode("utf-8"))
    out += _int(9, time.time_ns())                 # time_nanos
    if records:
        span = max(r[2] + r[3] for r in records) - min(r[2] for r in records)
        out += _int(10, max(int(span), 0))         # duration_nanos
    out += period_type
    out += _int(12, period_ns)
    return gzip.compress(bytes(out), mtime=0)


def phase_snapshot(hist=None) -> dict:
    """Cumulative (count, sum) per (engine, phase) child — take one
    before a measurement section and pass it to ``phase_breakdown`` as
    ``since`` to report only that section's passes (histograms are
    process-cumulative; without the delta a bench section would inherit
    every earlier section's passes)."""
    h = hist if hist is not None else families.RELAY_PHASE_SECONDS
    return {k: (st.count, st.sum) for k, st in dict(h._states).items()}


def phase_breakdown(hist=None, since: dict | None = None) -> dict:
    """Aggregate ``relay_phase_seconds`` over engines → one row per
    phase — ``bench.py``'s JSON-line export and the bench_gate input.
    ``since``: a ``phase_snapshot()`` baseline to difference against."""
    h = hist if hist is not None else families.RELAY_PHASE_SECONDS
    since = since or {}
    out: dict[str, dict] = {}
    for key, st in sorted(dict(h._states).items()):
        base_c, base_s = since.get(key, (0, 0.0))
        count, total = st.count - base_c, st.sum - base_s
        if count <= 0:
            continue
        row = out.setdefault(key[1], {"count": 0, "sum_s": 0.0})
        row["count"] += count
        row["sum_s"] += total
    for phase, row in out.items():
        row["mean_ms"] = round(row["sum_s"] / row["count"] * 1e3, 4) \
            if row["count"] else 0.0
        row["sum_s"] = round(row["sum_s"], 6)
    return out
