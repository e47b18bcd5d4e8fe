"""Time-shift sessions: pause and rewind on live streams, and replay of
spilled assets.

A copy of the reference's ``dvr/timeshift.py``.  The catch-up joins and
the live session count are counters in the ``counters`` dict a
``DvrManager`` hands in, and its ``obs`` sites are the reference's: a
catch-up join counts ``dvr_catchup_joins_total`` and emits
``dvr.catchup``, the pacer's block fills count ``vod_packets_total``
(``hot``), and ``dvr_timeshift_sessions`` follows the live sessions of
the process.

A ``TimeShiftSession`` is a citizen of the shared VOD pacer
(``VodPacerGroup.adopt``): each subscriber-track gets its own
``StagedPacketRing``-backed ``VodStream`` that the pacer block-fills from
spilled windows (rows kept verbatim from the live ring, the source's
seq/ts/ssrc header bytes intact) while the live head keeps relaying to
everyone else.  The pump hands these streams to the megabatch like any
other (one ``ed_relay_window`` launch a wake on the card), and the
subscriber's latched affine rewrite (ssrc, seq and ts rebase) turns them
into the wire bytes a live subscriber with the same rewrite got for the
same ids.

The live ring is the hot tail and the spill file the cold tail of one
absolute-id space: a window still inside the ring is sliced out of it;
an older one loads through ``SegmentCache.get_packed`` (a spill-file
copy, LRU'd and eligible for the card like any VOD window).  Catch-up:
when the replay clock reaches the real one and the backlog has drained
to the player, the output re-attaches to the live stream with
``bookmark = cursor``, keeping its SSRC and a contiguous seq.

Finalized assets replay through the same class with no live stream: the
session is done when the spilled range has been delivered.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import obs
from ..obs import EVENTS
from ..relay.stream import StreamSettings
from ..vod.cache import CachedWindow, StagedPacketRing
from ..vod.session import VodStream
from .spill import SpilledTrack, WindowRows, snapshot_window

#: ring slots a time-shift subscriber track (the VOD pacer's sizing: the
#: lookahead's depth, not a live burst absorber)
SHIFT_RING_CAPACITY = 1024
#: the streams of time-shift sessions carry this ``audience_tier``
DVR_TIER = "dvr"


def new_counters() -> dict:
    """The counters a set of time-shift sessions shares: catch-up joins,
    id hops over unspilled ranges, and the sessions not yet retired."""
    return {"catchup_joins": 0, "gaps": 0, "timeshift_sessions": 0}


class _ShiftTrack:
    """One subscriber-track of a time-shift session: the spill- and
    ring-fed paced ring and the catch-up join."""

    def __init__(self, sess: "TimeShiftSession", track_id: int,
                 spilled: SpilledTrack, out, settings: StreamSettings,
                 start_id: int, live_stream=None):
        self.track_id = track_id
        self.spilled = spilled
        self.out = out
        self.live_stream = live_stream
        self.k = spilled.k
        self.cursor = int(start_id)
        if settings.ring_capacity > SHIFT_RING_CAPACITY:
            settings = dataclasses.replace(
                settings, ring_capacity=SHIFT_RING_CAPACITY)
        ring = StagedPacketRing(
            settings.ring_capacity,
            is_video=spilled.info.media_type == "video",
            codec=spilled.info.codec or None)
        self.stream = VodStream(spilled.info, settings, ring)
        self.stream.session_path = sess.path
        self.stream.audience_tier = DVR_TIER
        # the output's rewrite is kept: a live subscriber keeps its
        # latched base (seq/ts continuity through the shift and back); a
        # fresh one latches from the first replayed packet
        out.bookmark = 0                 # shift ring ids start at 0
        self.stream.add_output(out)
        self.window: CachedWindow | None = None   # pinned cold window
        self.window_idx = -1
        self.joined = False
        self.done = spilled.win_lo is None and live_stream is None
        self.released = False
        self.gaps = 0                    # id hops over unspilled ranges
        self.last_arr = None             # newest served original arrival

    def _room(self) -> int:
        ring = self.stream.rtp_ring
        bm = self.out.bookmark
        base = ring.tail if bm is None else max(min(bm, ring.head),
                                                ring.tail)
        return ring.capacity - (ring.head - base) - 8

    def _delivered(self) -> bool:
        ring = self.stream.rtp_ring
        bm = self.out.bookmark
        return bm is not None and bm >= ring.head

    def _load_cold(self, win: int):
        rows = self.spilled.read_window(win)
        if rows is None:
            return None
        return CachedWindow.from_packed(
            None, rows.id_lo, rows.data, rows.length, rows.flags,
            rows.ts, seq=rows.seq, arrival=rows.arrival,
            restored=rows.restored)

    def _rows_for(self, sess: "TimeShiftSession",
                  win: int) -> WindowRows | None:
        """Window ``win`` as parallel arrays: the live ring's hot tail
        (ids still in the ring, sliced in place) or the cold spill
        through the segment cache."""
        lr = (self.live_stream.rtp_ring
              if self.live_stream is not None else None)
        if lr is not None and win * self.k >= lr.tail:
            hi = min((win + 1) * self.k, lr.head)
            if hi <= win * self.k:
                return None
            return snapshot_window(lr, win * self.k, hi)
        if self.window is not None and self.window_idx == win:
            w = self.window
        else:
            if self.window is not None:
                sess.pacer.cache.unpin(self.window)
                self.window = None
            w = sess.pacer.cache.get_packed(
                sess.asset_key, self.track_id, win, self._load_cold)
            if w is None:
                return None
            self.window = sess.pacer.cache.pin(w)
            self.window_idx = win
        if w.arrival is None:
            return None                  # not a spilled window
        return WindowRows(w.lo, w.data, w.length, w.flags, w.ts,
                          w.seq if w.seq is not None
                          else np.zeros(len(w.length), np.int32),
                          w.arrival)

    def _next_available(self, cur: int) -> int | None:
        """The next absolute id >= ``cur`` backed by data: the first
        indexed spill window past it, else the live ring's tail."""
        cand = None
        for win in sorted(self.spilled.windows):
            rec = self.spilled.windows[win]
            if rec["id_lo"] + rec["n"] > cur:
                cand = max(rec["id_lo"], cur)
                break
        if cand is None and self.live_stream is not None:
            lr = self.live_stream.rtp_ring
            if lr.head > cur:
                cand = max(lr.tail, cur)
        return cand

    def _gap(self, sess: "TimeShiftSession") -> None:
        self.gaps += 1
        sess.counters["gaps"] += 1

    def fill(self, sess: "TimeShiftSession", now_ms: int,
             horizon_ms: float) -> None:
        while not self.joined and not self.done:
            lr = (self.live_stream.rtp_ring
                  if self.live_stream is not None else None)
            if lr is not None and self._delivered() \
                    and self._caught_up(sess, lr):
                # the replay clock has caught the real clock and the
                # backlog has drained to the player: rejoin live (under
                # continuous ingest the cursor never equals a moving
                # head, so the join is schedule-based)
                self._maybe_join(sess)
                return
            if self._room() < 96:
                return                   # wait for the player to drain
            end_id = lr.head if lr is not None else self.spilled_end()
            if self.cursor >= end_id:
                if lr is None:
                    self.done = self._delivered()
                return
            if (lr is not None and self.cursor >= lr.tail
                    and not sess.anchor_pending):
                # hot tail: peek the cursor packet's due time before
                # snapshotting the window, or a cursor pacing slower
                # than the wakes would copy up to k rows every wake
                arr0 = float(lr.arrival[lr.slot(self.cursor)])
                if (sess.t0_ms + (arr0 - sess.anchor_arr) / sess.speed
                        > horizon_ms):
                    return
            rows = self._rows_for(sess, self.cursor // self.k)
            if rows is None or self.cursor >= rows.id_lo + rows.n:
                if rows is None and self.spilled.fetch_pending:
                    return               # a fetch or restore in flight:
                    #                      hold, the window lands later
                nxt = self._next_available(
                    max(self.cursor,
                        (self.cursor // self.k + 1) * self.k))
                if nxt is None or nxt <= self.cursor:
                    return               # nothing to serve yet
                self._gap(sess)
                self.cursor = nxt
                continue
            if self.cursor < rows.id_lo:
                # a tail-clamped window (its snapshot started above the
                # grid line): snap forward first, or rows from rel 0
                # would be served again as fresh out-seqs
                self._gap(sess)
                self.cursor = rows.id_lo
            rel_lo = self.cursor - rows.id_lo
            if sess.anchor_pending:
                # a resume whose pause-point arrival was unresolvable:
                # anchor on the first packet served, so replay starts now
                sess.anchor_arr = float(rows.arrival[rel_lo])
                sess.anchor_pending = False
            dues = (sess.t0_ms
                    + (rows.arrival[rel_lo:] - sess.anchor_arr)
                    / sess.speed)
            n_due = int(np.searchsorted(dues, horizon_ms, side="right"))
            n_due = min(n_due, rows.n - rel_lo, self._room())
            if n_due <= 0:
                return
            sel = slice(rel_lo, rel_lo + n_due)
            ring = self.stream.rtp_ring
            ring.push_block(rows.data[sel], rows.length[sel],
                            dues[:n_due].astype(np.int64), rows.flags[sel],
                            rows.seq[sel], rows.ts[sel])
            self.cursor += n_due
            self.last_arr = int(rows.arrival[rel_lo + n_due - 1])
            obs.VOD_PACKETS.inc(n_due, path="hot")
            sess.pacer.hot_pkts += n_due

    def _caught_up(self, sess: "TimeShiftSession", lr) -> bool:
        """True when replaying the cursor packet happens no later than
        live delivery would: ``due(cursor) <= arrival(cursor)``.  A
        Speed > 1 catch-up crosses this point; a 1× shift never does and
        stays shifted."""
        if self.cursor >= lr.head:
            return True
        if self.cursor < lr.tail:
            return False                 # still deep in the cold tail
        arr = float(lr.arrival[lr.slot(self.cursor)])
        due = sess.t0_ms + (arr - sess.anchor_arr) / sess.speed
        return due <= arr + 1.0

    def _maybe_join(self, sess: "TimeShiftSession") -> None:
        """Once the backlog has drained to the player, re-attach to the
        live stream with ``bookmark = cursor``: ids and the rewrite are
        continuous across the join, so the player sees one SSRC and a
        contiguous seq."""
        if not self._delivered():
            return
        live = self.live_stream
        self.stream.remove_output(self.out)
        if self.cursor < live.rtp_ring.tail:
            # the ring evicted past the cursor while it stalled: rejoin
            # at the tail, a seq jump counted as a gap
            self._gap(sess)
            self.cursor = live.rtp_ring.tail
        self.out.bookmark = self.cursor
        live.add_output(self.out)
        self.joined = True
        sess.counters["catchup_joins"] += 1
        obs.DVR_CATCHUP_JOINS.inc()
        EVENTS.emit("dvr.catchup", stream=sess.path,
                    trace_id=self.stream.trace_id,
                    track=self.track_id, join_id=self.cursor)

    def release(self, pacer) -> None:
        if self.released:
            return
        self.released = True
        if self.window is not None:
            pacer.cache.unpin(self.window)
            self.window = None
        if not self.joined:
            self.stream.remove_output(self.out)
        pacer.engine_drop(self.stream)

    def spilled_end(self) -> int:
        hi = self.spilled.win_hi
        if hi is None:
            return 0
        rec = self.spilled.windows[hi]
        return rec["id_lo"] + rec["n"]

    def position_arr(self) -> int | None:
        """Original arrival ms of the newest packet served."""
        return self.last_arr


class TimeShiftSession:
    """A pause, rewind or replay session under the shared VOD pacer, with
    the surface of ``PacedVodSession`` that the pacer's tick and retire
    use."""

    ts_scale = 1.0

    def __init__(self, pacer, asset, outputs: dict[int, object], *,
                 live_session=None, start_npt: float | None = None,
                 start_ids: dict[int, int] | None = None,
                 speed: float = 1.0, path: str = "",
                 now_ms: int | None = None,
                 counters: dict | None = None):
        """``asset`` is a ``DvrAsset`` (a ``SpilledTrack`` a track and
        ``asset_key``); ``start_ids`` (absolute ids a track: the resume
        of a PAUSE) wins over ``start_npt`` (a seek: the video track
        snaps to a keyframe, the others align on its arrival time)."""
        self.pacer = pacer
        self.asset = asset
        self.asset_key = asset.asset_key
        self.file = asset                # pacer.retire closes this
        self.speed = max(speed, 0.01)
        self.path = path or asset.path
        self.done = False
        self.stopped = False
        self.frames_thinned = 0
        self.start_npt = start_npt or 0.0
        self.counters = counters if counters is not None else new_counters()
        t = int(time.monotonic() * 1000) if now_ms is None else now_ms
        self.t0_ms = float(t)
        self._pkts_base = {id(o): o.packets_sent
                           for o in outputs.values()}
        self.tracks: list[_ShiftTrack] = []
        cursors: dict[int, int] = {}
        anchor = None
        video_tid = None
        for tid, sp in asset.tracks.items():
            if tid in outputs and sp.info.media_type == "video":
                video_tid = tid
                break
        if start_ids:
            cursors = {tid: int(i) for tid, i in start_ids.items()}
            if video_tid in cursors:
                anchor = self._arrival_of(asset.tracks[video_tid],
                                          cursors[video_tid],
                                          live_session)
        else:
            if video_tid is not None:
                sp = asset.tracks[video_tid]
                vid = sp.seek_id(self.start_npt, keyframe=True)
                cursors[video_tid] = vid
                anchor = self._arrival_of(sp, vid, live_session)
        #: a PAUSE resume whose anchor packet is unresolvable (evicted
        #: window, audio only) anchors on the first row served, never on
        #: the recording start (that would push every due time out by
        #: the elapsed recording)
        self.anchor_pending = bool(start_ids) and anchor is None
        if anchor is None:
            bases = [sp.base_arrival_ms
                     for sp in asset.tracks.values()
                     if sp.base_arrival_ms is not None]
            anchor = ((min(bases) if bases else 0)
                      + self.start_npt * 1000.0)
        self.anchor_arr = float(anchor)
        for tid, out in outputs.items():
            sp = asset.tracks.get(tid)
            if sp is None:
                continue
            if tid not in cursors:
                cursors[tid] = self._seek_arrival(sp, self.anchor_arr)
            live_stream = (live_session.streams.get(tid)
                           if live_session is not None else None)
            self.tracks.append(_ShiftTrack(
                self, tid, sp, out, pacer.settings, cursors[tid],
                live_stream=live_stream))
        self.counters["timeshift_sessions"] += 1
        self._gauge(+1)

    #: time-shift sessions alive in the process (the gauge's value)
    _live = 0

    @classmethod
    def _gauge(cls, d: int) -> None:
        cls._live = max(cls._live + d, 0)
        obs.DVR_TIMESHIFT_SESSIONS.set(cls._live)

    def on_retire(self) -> None:
        self.counters["timeshift_sessions"] -= 1
        self._gauge(-1)

    @staticmethod
    def _seek_arrival(sp: SpilledTrack, arr_ms: float) -> int:
        """Exact arrival-time seek on a track that is not the anchor
        (audio enters at the video keyframe's instant)."""
        base = sp.base_arrival_ms
        if base is None:
            return 0
        return sp.seek_id(max(arr_ms - base, 0.0) / 1000.0,
                          keyframe=False)

    @staticmethod
    def _arrival_of(sp: SpilledTrack, pkt_id: int,
                    live_session) -> float | None:
        """Original arrival ms of one absolute id: its spill window if
        indexed, else the live ring."""
        rows = sp.read_window(pkt_id // sp.k)
        if rows is not None and rows.id_lo <= pkt_id < rows.id_lo + rows.n:
            return float(rows.arrival[pkt_id - rows.id_lo])
        if live_session is not None:
            st = live_session.streams.get(sp.info.track_id)
            if st is not None and st.rtp_ring.valid(pkt_id):
                return float(st.rtp_ring.arrival[
                    st.rtp_ring.slot(pkt_id)])
        return None

    @property
    def packets_sent(self) -> int:
        return sum(tr.out.packets_sent
                   - self._pkts_base.get(id(tr.out), 0)
                   for tr in self.tracks)

    @property
    def catchup_pending(self) -> bool:
        return any(not tr.joined and tr.live_stream is not None
                   for tr in self.tracks)

    def position_npt(self) -> float:
        """Seconds past the recording start of the newest packet
        served."""
        arrs = [tr.position_arr() for tr in self.tracks
                if tr.position_arr() is not None]
        bases = [sp.base_arrival_ms
                 for sp in self.asset.tracks.values()
                 if sp.base_arrival_ms is not None]
        if not arrs or not bases:
            return self.start_npt
        return max(max(arrs) - min(bases), 0) / 1000.0

    def cursor_ids(self) -> dict[int, int]:
        """Absolute fill cursor a track."""
        return {tr.track_id: tr.cursor for tr in self.tracks}

    def pause_ids(self) -> dict[int, int]:
        """Resume cursors a track for a PAUSE on this session: the next
        absolute id the player has not received (the fill cursor less
        the shift ring's filled-but-unsent backlog).  A joined track's
        live bookmark is already that id."""
        out: dict[int, int] = {}
        for tr in self.tracks:
            if tr.joined:
                bm = tr.out.bookmark
                out[tr.track_id] = (int(bm) if bm is not None
                                    else tr.cursor)
            else:
                ring = tr.stream.rtp_ring
                bm = tr.out.bookmark
                base = (ring.tail if bm is None
                        else max(min(bm, ring.head), ring.tail))
                out[tr.track_id] = max(tr.cursor - (ring.head - base), 0)
        return out

    def tick(self, now_ms: int) -> None:
        if self.stopped or self.done:
            return
        horizon = now_ms + self.pacer.lookahead_ms
        done = True
        for tr in self.tracks:
            tr.fill(self, now_ms, horizon)
            if not (tr.joined or tr.done):
                done = False
        self.done = done

    def start(self) -> None:             # the FileSession surface
        pass

    def stop(self) -> None:
        self.pacer.retire(self)


__all__ = ["TimeShiftSession", "SHIFT_RING_CAPACITY", "DVR_TIER",
           "new_counters"]
