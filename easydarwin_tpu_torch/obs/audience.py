"""Audience observatory: columnar per-subscriber QoE.

Every delivery surface in the engine accounts *server* work; this
module accounts what each **viewer** experienced.  The store is
structure-of-arrays: one int/float numpy column per field, stream-major
(each stream's subscribers live in their own contiguous block), updated
ONLY by vectorized array passes hooked into the four real egress sites
(``relay/stream.py`` ``reflect``, ``relay/fanout.py`` ``_udp_scatter``
/ ``_tcp_scatter`` / ``_batch_header_step``) plus the RTX/FEC credit
paths — never a per-subscriber Python loop on the hot path.  The same
layout + the oracle tests in ``tests/test_audience.py`` are the
template ROADMAP item 2's full columnar-state refactor builds on.

Columns (per stream block, row = one subscriber):

* ``delivered`` / ``dbytes`` — packets / wire bytes that reached this
  subscriber's socket (OK writes only; a WOULD_BLOCK holds the row).
* ``drops`` — packets this subscriber never received, inferred from the
  absolute-ring-id gap between consecutive delivery passes at egress
  (covers thinning, runt skips, backlog sheds and eviction jumps —
  every deliberate or forced hole in the viewer's packet sequence).
* ``late`` — deliveries whose ingest→wire latency exceeded the
  freshness SLO (``slo_latency_objective_ms`` by default).
* ``rtx`` / ``fec`` — retransmissions sent to / parity recoveries
  credited to this subscriber (relay/fec.py).
* ``stall_eps`` / ``stalled_ns`` / ``stall_since_ns`` — stall episodes
  (inter-delivery gap beyond the stall threshold), accumulated frozen
  time, and the in-progress stall's entry stamp (0 = not stalled).
* ``join_ns`` / ``join_ts`` / ``last_wire_ns`` — monotonic join stamp,
  wall-clock join time, newest delivery stamp.

QoE (closed formula, documented in ARCHITECTURE.md):

    delivery = delivered / (delivered + drops)          (1 if no data)
    fresh    = 1 - late / delivered                     (1 if no data)
    stall_pen= clip(1 - stalled_s / watch_s, 0, 1)
    qoe      = clip(delivery * fresh * stall_pen, 0, 1)

A stall STORM is k-of-n subscribers of one stream entering stall
inside the storm window: latched once per rising edge as an
``audience.stall_storm`` event carrying the stream's trace id and the
wake ledger's currently blamed work class, so "the viewers froze"
points at the cause, not just the symptom.

``EDTPU_PROFILE=0`` turns the whole store into a no-op (the egress
hooks reduce to one attribute check per pass); the paired-median
enabled-vs-disabled overhead bound lives in tests/test_audience.py.
"""

from __future__ import annotations

import math
import os
import threading
import time
import weakref

import numpy as np

#: closed tier vocabulary — MUST stay in sync with obs.fleet.FLEET_TIERS
#: (tools/metrics_lint.py lint_audience enforces the sync); hls viewers
#: are HTTP pulls with no RelayOutput, so the column store never
#: populates that tier — the vocabulary still reserves it so fleet and
#: audience dashboards share one axis.
AUDIENCE_TIERS = ("live", "pull", "vod", "dvr", "hls")
#: closed QoE band vocabulary for ``audience_subscribers{tier,band}``
BANDS = ("poor", "fair", "good")
#: band edges: qoe < .5 = poor, < .85 = fair, else good (np.digitize)
BAND_EDGES = (0.5, 0.85)
#: audience_qoe_score histogram bounds — the score is bounded [0, 1]
QOE_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6,
               0.7, 0.8, 0.9, 0.95, 1.0)

#: columns every stream block carries (the SoA template; the oracle
#: test and the columnar-state refactor both key on this tuple)
COLUMNS = ("active", "tier_idx", "join_ns", "join_ts", "delivered",
           "dbytes", "drops", "late", "rtx", "fec", "stall_eps",
           "stalled_ns", "stall_since_ns", "last_wire_ns", "last_pid")

_COL_DTYPES = {"active": np.bool_, "tier_idx": np.int8,
               "join_ts": np.float64}


class _StreamAudience:
    """One stream's subscriber columns (stream-major SoA block)."""

    __slots__ = ("path", "track", "trace_id", "stream_ref", "cap",
                 "free", "n_active", "sess", "storm_active", "storms",
                 "last_storm", "_reported_ns") + COLUMNS

    def __init__(self, path: str, track, trace_id, stream_ref,
                 cap: int = 8):
        self.path = path
        self.track = track
        self.trace_id = trace_id
        self.stream_ref = stream_ref       # weakref | None (tests)
        self.cap = cap
        self.free: list[int] = []
        self.n_active = 0
        self.sess: list[str] = [""] * cap  # control-plane only
        self.storm_active = False
        self.storms = 0
        self.last_storm: dict = {}
        #: stall seconds already pushed into the counter family, per tier
        self._reported_ns = np.zeros(len(AUDIENCE_TIERS), np.int64)
        for c in COLUMNS:
            setattr(self, c, np.zeros(cap, _COL_DTYPES.get(c, np.int64)))
        self.last_pid.fill(-1)

    def __deepcopy__(self, memo):
        # blocks are observability state owned by the global store, and
        # they hold a weakref (unpicklable): a deep-copied stream (the
        # differential oracle tests clone whole streams) shares the
        # original's block instead of forking the columns
        return self

    def __copy__(self):
        return self

    def _grow(self) -> None:
        new = self.cap * 2
        for c in COLUMNS:
            col = getattr(self, c)
            g = np.zeros(new, col.dtype)
            g[:self.cap] = col
            setattr(self, c, g)
        self.last_pid[self.cap:] = -1
        self.sess.extend([""] * (new - self.cap))
        self.cap = new

    def alloc(self, tier_idx: int, session_id: str, now_ns: int) -> int:
        if self.free:
            row = self.free.pop()
        else:
            row = self.n_active
            while row < self.cap and self.active[row]:
                row += 1
            if row >= self.cap:
                self._grow()
        # fresh row: zero every column, then stamp the join
        for c in COLUMNS:
            getattr(self, c)[row] = 0
        self.active[row] = True
        self.tier_idx[row] = tier_idx
        self.join_ns[row] = now_ns
        self.join_ts[row] = time.time()
        self.last_pid[row] = -1
        self.sess[row] = session_id
        self.n_active += 1
        return row

    def release(self, row: int) -> None:
        if 0 <= row < self.cap and self.active[row]:
            self.active[row] = False
            self.sess[row] = ""
            self.free.append(row)
            self.n_active -= 1

    def nbytes(self) -> int:
        return int(sum(getattr(self, c).nbytes for c in COLUMNS))


def _env_ms(name: str, default_ms: float) -> float:
    try:
        return float(os.environ.get(name, default_ms))
    except ValueError:
        return default_ms


class AudienceStore:
    """Process-wide columnar per-subscriber QoE store.

    All mutation entry points are vectorized: ``note_pass`` takes
    per-output aggregate arrays assembled inside the egress sites'
    EXISTING accounting loops and applies them in one fancy-indexed
    column pass; ``tick`` (1 Hz, the pump maintenance block) derives
    stalls/QoE/storms with array math over whole blocks.  ``families``
    is injectable for tests (the WorkLedger pattern)."""

    def __init__(self, families=None):
        self.enabled = os.environ.get("EDTPU_PROFILE", "1") != "0"
        self._lock = threading.Lock()
        self._blocks: dict[tuple, _StreamAudience] = {}
        self._fams = families
        #: a delivery later than this is "late" (freshness SLO); default
        #: rides the SLO watchdog's latency objective
        self.fresh_slo_s = _env_ms("EDTPU_AUDIENCE_FRESH_MS", 0.0) / 1e3
        if self.fresh_slo_s <= 0:
            try:
                from .slo import SloConfig
                self.fresh_slo_s = SloConfig().latency_objective_ms / 1e3
            except Exception:
                self.fresh_slo_s = 0.05
        #: inter-delivery gap beyond this = the viewer is frozen
        self.stall_gap_s = _env_ms("EDTPU_AUDIENCE_STALL_GAP_MS",
                                   2000.0) / 1e3
        #: storm: >= max(min_k, ceil(frac*n)) subscribers of ONE stream
        #: entering stall inside the window
        self.storm_window_s = _env_ms("EDTPU_AUDIENCE_STORM_WINDOW_MS",
                                      10_000.0) / 1e3
        self.storm_min_k = 3
        self.storm_frac = 0.5
        self.ticks = 0

    # -- families (lazy, injectable) ----------------------------------
    def _families(self):
        if self._fams is None:
            from . import families as f
            self._fams = {"qoe": f.AUDIENCE_QOE_SCORE,
                          "stall": f.AUDIENCE_STALL_SECONDS,
                          "subs": f.AUDIENCE_SUBSCRIBERS,
                          "storms": f.AUDIENCE_STALL_STORMS}
        return self._fams

    # -- registration (control plane) ---------------------------------
    def register(self, stream, output, tier: str | None = None) -> int:
        """Bind ``output`` to a row in its stream's block.  Called from
        ``RelayStream.add_output`` — control plane, never per packet."""
        if not self.enabled:
            return -1
        tier = tier or getattr(stream, "audience_tier", None) or "live"
        if tier not in AUDIENCE_TIERS:
            tier = "live"
        path = stream.session_path or "-"
        key = (path, stream.info.track_id)
        with self._lock:
            blk = self._blocks.get(key)
            if blk is None or blk.stream_ref is not None \
                    and blk.stream_ref() is not stream:
                blk = _StreamAudience(path, stream.info.track_id,
                                      stream.trace_id,
                                      weakref.ref(stream))
                self._blocks[key] = blk
            blk.trace_id = stream.trace_id
            row = blk.alloc(AUDIENCE_TIERS.index(tier),
                            str(getattr(output, "session_id", None)
                                or ""),
                            time.perf_counter_ns())
        output.audience_block = blk
        output.audience_row = row
        stream.audience = blk
        return row

    def unregister(self, output) -> None:
        """Free the subscriber's row (leave, teardown, PAUSE detach —
        a paused/parted viewer accrues NO stall time: no row, no gap)."""
        blk = getattr(output, "audience_block", None)
        row = getattr(output, "audience_row", -1)
        if blk is None or row < 0:
            return
        with self._lock:
            blk.release(row)
        output.audience_block = None
        output.audience_row = -1

    # -- the vectorized hot-path pass ---------------------------------
    def note_pass(self, blk, rows, pkts, byts, first_pid, last_pid,
                  lat_s, wire_ns: int) -> None:
        """One egress pass for one stream: per-output aggregate arrays
        (row index, delivered count, delivered bytes, first/last
        delivered absolute ring id) plus the pass's per-packet
        ingest→wire latencies in row-major order.  Pure column math —
        the ONLY per-subscriber state writes on the data path."""
        if not self.enabled or blk is None:
            return
        r = np.asarray(rows, np.int64)
        if r.size == 0:
            return
        p = np.asarray(pkts, np.int64)
        b = np.asarray(byts, np.int64)
        fp = np.asarray(first_pid, np.int64)
        lp = np.asarray(last_pid, np.int64)
        with self._lock:
            if r.max() >= blk.cap:         # row freed + block swapped
                keep = r < blk.cap
                if not keep.any():
                    return
                r, p, b, fp, lp = r[keep], p[keep], b[keep], \
                    fp[keep], lp[keep]
            blk.delivered[r] += p
            blk.dbytes[r] += b
            # drops: every absolute ring id in (prev last-delivered,
            # this pass's last-delivered] that was NOT delivered — the
            # seq-gap inference covers inter-pass holes (sheds,
            # eviction jumps) AND intra-pass holes (thinning, runts)
            prev = blk.last_pid[r]
            base = np.where(prev >= 0, prev, fp - 1)
            gap = (lp - base) - p
            blk.drops[r] += np.maximum(gap, 0)
            blk.last_pid[r] = lp
            # late deliveries past the freshness SLO (per packet)
            if lat_s is not None and len(lat_s):
                lv = np.asarray(lat_s)
                if lv.size == int(p.sum()):
                    pkt_rows = np.repeat(r, p)
                    np.add.at(blk.late, pkt_rows[lv > self.fresh_slo_s],
                              1)
            # stall bookkeeping: close in-progress stalls; count whole
            # gap episodes that started AND ended between ticks
            prev_w = blk.last_wire_ns[r]
            since = blk.stall_since_ns[r]
            gap_ns = int(self.stall_gap_s * 1e9)
            ended = since > 0
            add_ns = np.where(ended, wire_ns - since, 0)
            jumped = (~ended) & (prev_w > 0) \
                & ((wire_ns - prev_w) > gap_ns)
            add_ns = add_ns + np.where(
                jumped, wire_ns - prev_w - gap_ns, 0)
            blk.stalled_ns[r] += np.maximum(add_ns, 0)
            blk.stall_eps[r] += jumped.astype(np.int64)
            blk.stall_since_ns[r] = 0
            blk.last_wire_ns[r] = wire_ns

    def note_credit(self, output, rtx: int = 0, fec: int = 0) -> None:
        """RTX/FEC repair credited to one subscriber (cold control
        paths: NACK replay, receiver-side parity solve)."""
        if not self.enabled:
            return
        blk = getattr(output, "audience_block", None)
        row = getattr(output, "audience_row", -1)
        if blk is None or row < 0 or row >= blk.cap:
            return
        with self._lock:
            if rtx:
                blk.rtx[row] += rtx
            if fec:
                blk.fec[row] += fec

    # -- QoE math ------------------------------------------------------
    def _scores(self, blk, rows, now_ns: int) -> np.ndarray:
        d = blk.delivered[rows].astype(np.float64)
        denom = d + blk.drops[rows]
        delivery = np.where(denom > 0, d / np.maximum(denom, 1.0), 1.0)
        fresh = np.where(
            d > 0, 1.0 - blk.late[rows] / np.maximum(d, 1.0), 1.0)
        watch = np.maximum((now_ns - blk.join_ns[rows]) / 1e9, 1e-3)
        st = blk.stalled_ns[rows].astype(np.float64)
        since = blk.stall_since_ns[rows]
        st = st + np.where(since > 0, now_ns - since, 0)
        pen = np.clip(1.0 - (st / 1e9) / watch, 0.0, 1.0)
        return np.clip(delivery * fresh * pen, 0.0, 1.0)

    def _stalled_ns_now(self, blk, rows, now_ns: int) -> np.ndarray:
        since = blk.stall_since_ns[rows]
        return blk.stalled_ns[rows] + np.where(
            since > 0, now_ns - since, 0)

    # -- 1 Hz maintenance ---------------------------------------------
    def tick(self, now_ns: int | None = None) -> None:
        """Derive stalls/QoE/storms and feed the metric families — the
        pump's 1 Hz maintenance block, array math per stream block."""
        if not self.enabled:
            return
        if now_ns is None:
            now_ns = time.perf_counter_ns()
        fams = self._families()
        gap_ns = int(self.stall_gap_s * 1e9)
        win_ns = int(self.storm_window_s * 1e9)
        n_tiers = len(AUDIENCE_TIERS)
        subs = np.zeros((n_tiers, len(BANDS)), np.int64)
        with self._lock:
            self.ticks += 1
            dead = [k for k, blk in self._blocks.items()
                    if blk.n_active == 0
                    or (blk.stream_ref is not None
                        and blk.stream_ref() is None)]
            for k in dead:
                del self._blocks[k]
            for blk in self._blocks.values():
                rows = np.flatnonzero(blk.active)
                if rows.size == 0:
                    continue
                # stall entry: delivery gap crossed the threshold
                lw = blk.last_wire_ns[rows]
                ent = rows[(blk.stall_since_ns[rows] == 0) & (lw > 0)
                           & ((now_ns - lw) > gap_ns)]
                if ent.size:
                    blk.stall_since_ns[ent] = blk.last_wire_ns[ent] \
                        + gap_ns
                    blk.stall_eps[ent] += 1
                # stall seconds -> counter family (delta per tier)
                cur = self._stalled_ns_now(blk, rows, now_ns)
                tot = np.bincount(blk.tier_idx[rows], weights=cur,
                                  minlength=n_tiers).astype(np.int64)
                delta = tot - blk._reported_ns
                for t in np.flatnonzero(delta > 0):
                    fams["stall"].inc(float(delta[t]) / 1e9,
                                      tier=AUDIENCE_TIERS[t])
                np.maximum(blk._reported_ns, tot, out=blk._reported_ns)
                # QoE distribution + band census
                q = self._scores(blk, rows, now_ns)
                band = np.digitize(q, BAND_EDGES)
                ti = blk.tier_idx[rows]
                for t in np.unique(ti):
                    sel = ti == t
                    fams["qoe"].observe_many(q[sel],
                                             tier=AUDIENCE_TIERS[t])
                    subs[t] += np.bincount(band[sel],
                                           minlength=len(BANDS))
                # storm detection (latched per rising edge)
                since = blk.stall_since_ns[rows]
                stalled_now = int((since > 0).sum())
                recent = int(((since > 0)
                              & (since >= now_ns - win_ns)).sum())
                thresh = max(self.storm_min_k,
                             math.ceil(self.storm_frac * rows.size))
                if recent >= thresh and not blk.storm_active:
                    blk.storm_active = True
                    blk.storms += 1
                    fams["storms"].inc()
                    try:
                        from .events import EVENTS
                        from .ledger import LEDGER
                        blamed = LEDGER.last_top_class or ""
                        blk.last_storm = {
                            "ts": time.time(), "stalled": recent,
                            "subscribers": int(rows.size),
                            "blamed": blamed}
                        EVENTS.emit(
                            "audience.stall_storm", level="warn",
                            stream=blk.path, trace_id=blk.trace_id,
                            stalled=recent,
                            subscribers=int(rows.size), blamed=blamed)
                    except Exception:
                        pass
                elif blk.storm_active \
                        and stalled_now < max(1, thresh // 2):
                    blk.storm_active = False
        for t, tier in enumerate(AUDIENCE_TIERS):
            for bidx, bname in enumerate(BANDS):
                fams["subs"].set(float(subs[t, bidx]),
                                 tier=tier, band=bname)

    # -- read side -----------------------------------------------------
    def rollup(self, now_ns: int | None = None) -> dict:
        """Compact aggregate for the fleet rollup / StatusMonitor."""
        if now_ns is None:
            now_ns = time.perf_counter_ns()
        with self._lock:
            qs, stalled, storms, nb, n = [], 0, 0, 0, 0
            for blk in self._blocks.values():
                rows = np.flatnonzero(blk.active)
                if rows.size:
                    qs.append(self._scores(blk, rows, now_ns))
                    stalled += int((blk.stall_since_ns[rows] > 0).sum())
                n += blk.n_active
                storms += blk.storms
                nb += blk.nbytes()
        allq = np.concatenate(qs) if qs else np.zeros(0)
        return {
            "subscribers": n,
            "qoe_p50": round(float(np.percentile(allq, 50)), 4)
            if allq.size else None,
            "qoe_p10": round(float(np.percentile(allq, 10)), 4)
            if allq.size else None,
            "stalled_now": stalled,
            "stall_storms": storms,
            "columns_bytes_per_subscriber":
                round(nb / n, 1) if n else 0.0,
        }

    def snapshot(self, worst_n: int = 5,
                 now_ns: int | None = None) -> dict:
        """Full drill-down doc (``GET /api/v1/audience`` /
        ``command=audience``): per-stream rollup + worst-N subscribers."""
        if now_ns is None:
            now_ns = time.perf_counter_ns()
        streams = []
        with self._lock:
            allq = []
            total_bytes = 0
            total_subs = 0
            for blk in self._blocks.values():
                rows = np.flatnonzero(blk.active)
                total_bytes += blk.nbytes()
                total_subs += blk.n_active
                if rows.size == 0:
                    continue
                q = self._scores(blk, rows, now_ns)
                allq.append(q)
                st_s = self._stalled_ns_now(blk, rows, now_ns) / 1e9
                order = np.argsort(q)[:max(worst_n, 0)]
                worst = [{
                    "session": blk.sess[int(rows[i])],
                    "tier": AUDIENCE_TIERS[int(blk.tier_idx[rows[i]])],
                    "qoe": round(float(q[i]), 4),
                    "delivered": int(blk.delivered[rows[i]]),
                    "drops": int(blk.drops[rows[i]]),
                    "late": int(blk.late[rows[i]]),
                    "rtx": int(blk.rtx[rows[i]]),
                    "fec": int(blk.fec[rows[i]]),
                    "stall_episodes": int(blk.stall_eps[rows[i]]),
                    "stalled_s": round(float(st_s[i]), 3),
                } for i in order]
                streams.append({
                    "path": blk.path,
                    "track": blk.track,
                    "trace_id": blk.trace_id,
                    "subscribers": int(rows.size),
                    "qoe_p50": round(float(np.percentile(q, 50)), 4),
                    "qoe_p10": round(float(np.percentile(q, 10)), 4),
                    "delivered": int(blk.delivered[rows].sum()),
                    "bytes": int(blk.dbytes[rows].sum()),
                    "drops": int(blk.drops[rows].sum()),
                    "late": int(blk.late[rows].sum()),
                    "rtx": int(blk.rtx[rows].sum()),
                    "fec": int(blk.fec[rows].sum()),
                    "stall_episodes": int(blk.stall_eps[rows].sum()),
                    "stalled_s": round(float(st_s.sum()), 3),
                    "stalled_now": int(
                        (blk.stall_since_ns[rows] > 0).sum()),
                    "storm_active": blk.storm_active,
                    "storms": blk.storms,
                    "last_storm": blk.last_storm or None,
                    "worst": worst,
                })
        flat = np.concatenate(allq) if allq else np.zeros(0)
        return {
            "enabled": self.enabled,
            "subscribers": total_subs,
            "streams": streams,
            "qoe_p50": round(float(np.percentile(flat, 50)), 4)
            if flat.size else None,
            "qoe_p10": round(float(np.percentile(flat, 10)), 4)
            if flat.size else None,
            "stall_storms": sum(s["storms"] for s in streams),
            "columns_bytes": total_bytes,
            "columns_bytes_per_subscriber":
                round(total_bytes / total_subs, 1) if total_subs else 0.0,
            "fresh_slo_ms": round(self.fresh_slo_s * 1e3, 1),
            "stall_gap_ms": round(self.stall_gap_s * 1e3, 1),
        }

    def reset(self) -> None:
        with self._lock:
            self._blocks.clear()
            self.ticks = 0


def suspect_flags(doc: dict) -> list[str]:
    """Audience-side suspect lines for the blame report: stall storms
    and a collapsed QoE p10 name VIEWER impact alongside the ledger's
    cause.  ``doc`` is an audience rollup or snapshot."""
    out: list[str] = []
    if not isinstance(doc, dict):
        return out
    storms = doc.get("stall_storms") or 0
    if storms:
        out.append(
            f"audience: {storms} stall storm(s) latched — k-of-n "
            "subscribers of one stream froze together; see "
            "audience.stall_storm events for the blamed work class")
    p10 = doc.get("qoe_p10")
    if isinstance(p10, (int, float)) and p10 < 0.5:
        out.append(
            f"audience: QoE p10 {p10:.2f} below the 0.5 floor — the "
            "worst decile of viewers is degraded (drops, staleness or "
            "stalls); correlate with the ledger's top offender")
    stalled = doc.get("stalled_now") or 0
    subs = doc.get("subscribers") or 0
    if subs and stalled and stalled * 2 >= subs:
        out.append(
            f"audience: {stalled}/{subs} subscribers stalled right "
            "now — delivery is frozen for at least half the audience")
    return out


#: module singleton — the egress sites and the REST layer share it
AUDIENCE = AudienceStore()

__all__ = ["AUDIENCE", "AudienceStore", "AUDIENCE_TIERS", "BANDS",
           "BAND_EDGES", "QOE_BUCKETS", "COLUMNS", "suspect_flags"]
