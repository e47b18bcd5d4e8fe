"""Paced VOD sessions and the VOD service hook of the RTSP server.

Two serving paths:

* ``FileSession`` — the cold path: one asyncio task per playing client
  with ``QTSSFileModule``'s ``SendPackets`` pull-pace-sleep structure;
  WouldBlock from an output retries the same packet on the next wake
  (bookmark semantics).  It serves Scale (compressed timestamps) and
  meta-info sessions, and every session when the cache is off.
* ``PacedVodSession`` + ``VodPacerGroup`` — the hot path: each
  subscriber-track is a ``RelayStream`` whose ring the shared group pacer
  fills from the segment cache (``vod/cache.py``) in block copies, with
  each packet's due time stamped into the ring's ``arrival`` clock, so
  the live engines' eligibility gate IS the pacer.  The pump steps these
  streams through the same ``FanoutEngine`` and megabatch scheduler as
  live relay: the per-subscriber seq/ts/ssrc rewrite rides the affine
  params, oracle-checked at install.  A cache miss streams through the
  cold per-sample mmap path into the same ring while a background fill
  packs the window.

A join is primed on the card (``VodPacerGroup._prime_joined``): the
joins' card-resident cache windows are stacked on the device and run
through the scheduler's ``megabatch_window_steps`` call (one
``ed_relay_window`` launch for every shape group), each segment installed
through the scheduler's host-oracle check.  An upload or launch error raises out of the pacer's
``tick``; only an oracle mismatch leaves a join to the scheduler's own
prime, and it counts in ``prime_failures``.

Observability (``obs``): the pacer's ring fills count
``vod_packets_total`` by path (``hot`` from the cache, ``cold`` from the
per-sample path), and ``vod_sessions`` follows the paced sessions.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import time
from collections import deque

import numpy as np
import torch

from .. import obs
from ..models.relay_pipeline import scatter_affine_segments
from ..ops.fanout import STATE_COLS, pack_output_state
from ..ops.staging import pow2
from ..protocol import rtcp, rtp
from ..protocol import sdp as sdp_mod
from ..protocol.rtp_meta import FRAME_KEY, FRAME_P
from ..protocol.sdp import StreamInfo
from ..relay.fanout import params_key
from ..relay.output import RelayOutput, WriteResult
from ..relay.quality import ThinningFilter
from ..relay.ring import PacketFlags
from ..relay.stream import RelayStream, StreamSettings
from ..utils.paths import under_root
from .cache import VOD_MTU, SegmentCache, StagedPacketRing, tracks_by_no
from .mp4 import Mp4Error, Mp4File, open_shared
from .packetizer import (RTP_CLOCK_VIDEO, AacPacketizer, H264Packetizer,
                         sdp_for_file)

#: per-subscriber-track ring depth on the hot path: sized for the fill
#: lookahead (hundreds of ms), not the live relay's 4096-slot burst
#: absorber; 1024 slots x 2060 B keeps a subscriber's ring near 2 MB
VOD_RING_CAPACITY = 1024
#: SR origination cadence of the cold path (``RTPStream`` sends one per
#: RR interval), seconds
SR_INTERVAL_SEC = 5.0
#: the CNAME of the cold path's SRs
SR_CNAME = "easydarwin-tpu"


def seek_index(track, npt: float) -> int:
    """The sample a PLAY at ``npt`` seconds starts from: the sync sample
    at or before the first sample at or after ``npt``."""
    if npt <= 0 or track.n_samples == 0:
        return 0
    target = int(npt * track.info.timescale)
    i = int(np.searchsorted(track.dts, target))
    i = min(i, track.n_samples - 1)
    return track.sync_sample_at_or_before(i)


class FileSession:
    """One playing client of one file: per-track packetizers + pacing."""

    def __init__(self, file: Mp4File, outputs: dict[int, RelayOutput],
                 *, start_npt: float = 0.0, speed: float = 1.0,
                 ts_scale: float = 1.0):
        self.file = file
        self.outputs = outputs
        self.speed = max(speed, 0.01)
        #: Scale: RTP timestamps are divided by this, so the media clock
        #: advances ``ts_scale``x per wall second (RFC 2326 §12.34)
        self.ts_scale = max(ts_scale, 0.01)
        self._cursors: dict[int, int] = {}        # track_id -> sample index
        self._packetizers: dict[int, object] = {}
        #: the send loop pops from the front once per packet
        self._pending: dict[int, deque[bytes]] = {}
        self._pending_npt: dict[int, float] = {}
        self._task: asyncio.Task | None = None
        self.packets_sent = 0
        #: frames shed by quality adaptation: RR loss / NADU feedback
        #: raises the output's level and the pacer consults it per sample
        #: (a whole frame dropped, never a tail of packets)
        self.frames_thinned = 0
        self.done = False
        for track_no, tr in tracks_by_no(file).items():
            out = outputs.get(track_no)
            if out is None:
                continue
            cls = H264Packetizer if tr.info.handler == "vide" \
                else AacPacketizer
            self._packetizers[track_no] = cls(
                tr, ssrc=out.rewrite.ssrc,
                seq_start=out.rewrite.out_seq_start)
            self._cursors[track_no] = seek_index(tr, start_npt)
            self._pending[track_no] = deque()
        self.start_npt = start_npt
        #: x-RTP-Meta-Info context: per-track running packet number and
        #: the current sample's (frame type, file position)
        self._meta_pn: dict[int, int] = {}
        self._pending_meta: dict[int, tuple[int | None, int]] = {}
        #: per track: (rtp ts of the newest sent packet, wall time sent)
        self._sr_ref: dict[int, tuple[int, float]] = {}
        self._last_sr: dict[int, float] = {}
        self._sr_pkts: dict[int, int] = {}
        self._sr_octets: dict[int, int] = {}

    # -- pull-pace loop ----------------------------------------------------
    def _track_of(self, track_id: int):
        return self._packetizers[track_id].track

    def _next_due(self) -> tuple[int | None, float]:
        """(track_id, npt seconds) of the earliest unsent sample."""
        best, best_t = None, float("inf")
        for tid, cur in self._cursors.items():
            tr = self._track_of(tid)
            if self._pending[tid]:
                t = self._pending_npt.get(tid, 0.0)
                if t < best_t:
                    best, best_t = tid, t
                continue
            if cur >= tr.n_samples:
                continue
            t = tr.sample_time_sec(cur)
            if t < best_t:
                best, best_t = tid, t
        return best, best_t

    def _clock_rate(self, tid: int) -> int:
        p = self._packetizers[tid]
        if isinstance(p, AacPacketizer):
            tr = p.track
            return tr.info.sample_rate or tr.info.timescale or 90000
        return RTP_CLOCK_VIDEO

    def _maybe_send_srs(self, now: float) -> None:
        """An SR + SDES per track every ``SR_INTERVAL_SEC``: NTP = now, RTP
        = the media timestamp playing at now (the last sent ts
        extrapolated at the track clock, honouring Speed and Scale)."""
        for tid, (last_ts, last_wall) in list(self._sr_ref.items()):
            if now - self._last_sr.get(tid, 0.0) < SR_INTERVAL_SEC:
                continue
            self._last_sr[tid] = now
            out = self.outputs[tid]
            rate = self._clock_rate(tid)
            rtp_now = int(last_ts + (now - last_wall) * rate
                          * self.speed / self.ts_scale) & 0xFFFFFFFF
            out.send_bytes(rtcp.build_server_compound(
                out.rewrite.ssrc, SR_CNAME, unix_time=time.time(),
                rtp_ts=rtp_now, packet_count=self._sr_pkts.get(tid, 0),
                octet_count=self._sr_octets.get(tid, 0)), is_rtcp=True)

    def _load_sample(self, tid: int, npt: float) -> bool:
        """Packetize the track's next sample into its pending queue, or
        shed it (thinning).  Returns False when the sample was shed."""
        tr = self._track_of(tid)
        cur = self._cursors[tid]
        out0 = self.outputs[tid]
        is_video = tr.info.handler == "vide"
        if is_video and not out0.thinning.passthrough():
            flags = (PacketFlags.VIDEO | PacketFlags.FRAME_FIRST
                     | (PacketFlags.KEYFRAME_FIRST
                        if bool(tr.sync[cur]) else 0))
            if not out0.thinning.admit(flags):
                self._cursors[tid] = cur + 1
                self.frames_thinned += 1
                return False
        data = self.file.read_sample(tr, cur)
        ftype = (FRAME_KEY if bool(tr.sync[cur]) else FRAME_P) \
            if is_video else None
        self._pending_meta[tid] = (ftype, int(tr.offsets[cur]))
        pkts = self._packetizers[tid].packetize_sample(data, cur)
        if self.ts_scale != 1.0:
            pkts = [rtp.rewrite_header(
                p, timestamp=int(rtp.peek_timestamp(p)
                                 / self.ts_scale) & 0xFFFFFFFF)
                for p in pkts]
        self._pending[tid] = deque(pkts)
        self._pending_npt[tid] = npt
        self._cursors[tid] = cur + 1
        return True

    async def run(self) -> None:
        t0 = time.monotonic() - self.start_npt / self.speed
        while True:
            self._maybe_send_srs(time.monotonic())
            for o in self.outputs.values():
                tick = getattr(o, "tick", None)
                if tick is not None:      # reliable-UDP resend sweep
                    tick()
            tid, npt = self._next_due()
            if tid is None:
                self.done = True
                return
            delay = t0 + npt / self.speed - time.monotonic()
            if delay > 0:
                await asyncio.sleep(min(delay, 0.5))
                continue
            if not self._pending[tid] and not self._load_sample(tid, npt):
                continue
            out = self.outputs[tid]
            q = self._pending[tid]
            last_sent = None
            while q:
                wire = q[0]
                if out.meta_field_ids is not None:
                    ftype, fpos = self._pending_meta.get(tid, (None, 0))
                    wire = out.wrap_meta(
                        wire[:12], wire[12:], frame_type=ftype,
                        packet_number=self._meta_pn.get(tid, 0),
                        packet_position=fpos)
                res = out.send_bytes(wire, is_rtcp=False)
                if res is WriteResult.WOULD_BLOCK:
                    await asyncio.sleep(0.02)      # bookmark: retry same pkt
                    break
                pkt = q.popleft()
                if res is WriteResult.OK:
                    out.packets_sent += 1
                    self.packets_sent += 1
                    self._meta_pn[tid] = self._meta_pn.get(tid, 0) + 1
                    last_sent = pkt
                    self._sr_pkts[tid] = self._sr_pkts.get(tid, 0) + 1
                    self._sr_octets[tid] = (self._sr_octets.get(tid, 0)
                                            + max(len(pkt) - 12, 0))
                elif res is WriteResult.ERROR:
                    self.done = True
                    return
            if last_sent is not None:   # once per sample, not per packet
                self._sr_ref[tid] = (rtp.peek_timestamp(last_sent),
                                     time.monotonic())

    def start(self) -> None:
        self._task = asyncio.create_task(self.run(), name="vod-session")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


class VodService:
    """Path → file resolution and SDP (the file module's route and
    describe roles).  Paths map under ``movie_folder``; a '.sdp' suffix is
    dropped and '.mp4', '.mov', '.m4v' are tried."""

    def __init__(self, movie_folder: str):
        self.movie_folder = movie_folder

    def resolve(self, path: str) -> str | None:
        rel = path.lstrip("/")
        if rel.endswith(".sdp"):
            rel = rel[:-4]
        cand = os.path.normpath(os.path.join(self.movie_folder, rel))
        for p in (cand, cand + ".mp4", cand + ".mov", cand + ".m4v"):
            # commonpath over realpaths: refuses .. traversal, sibling
            # directories sharing the prefix string and symlinks leaving
            # the root
            if os.path.isfile(p) and under_root(self.movie_folder, p):
                return p
        return None

    def open(self, path: str) -> Mp4File | None:
        fp = self.resolve(path)
        if fp is None:
            return None
        try:
            return open_shared(fp)
        except (Mp4Error, OSError):
            return None

    def describe(self, path: str) -> str | None:
        f = self.open(path)
        if f is None:
            return None
        try:
            return sdp_mod.build(sdp_for_file(f,
                                              name=os.path.basename(path)))
        finally:
            f.close()


# ======================================================================
# Hot path: cache-fed relay streams under a shared group pacer
# ======================================================================

class _VodEngineThinning(ThinningFilter):
    """The engine's view of a pacer-served output's thinning.

    The pacer already sheds frames at fill time (the cold path's
    per-sample rule), so the engine treats the output as passthrough (the
    native rungs stay open while the subscriber is thinned) and never
    filters again.  RTCP feedback keeps flowing: the shared ``controller``
    is the one the pacer's fill filter reads."""

    def passthrough(self) -> bool:
        return True

    def admit(self, flags: int) -> bool:
        return True


class VodStream(RelayStream):
    """A paced VOD subscriber-track as a relay stream: live relay's ring,
    buckets, RTCP and bookmarks, fed by the group pacer instead of an
    ingest, so the pump, the engines and the megabatch scheduler serve
    both alike."""

    def __init__(self, info: StreamInfo, settings: StreamSettings,
                 ring: StagedPacketRing):
        super().__init__(info, settings, rtp_ring=ring)


class _PacedTrack:
    """Per-(session, track) pacer state: cursor, seq runner, the thinning
    fill filter, the pinned current cache window and the cold-miss
    packetizer."""

    def __init__(self, sess: "PacedVodSession", track_no: int, track,
                 out: RelayOutput, settings: StreamSettings,
                 start_npt: float):
        self.track_no = track_no
        self.track = track
        self.out = out
        self.is_video = track.info.handler == "vide"
        if self.is_video:
            info = StreamInfo(media_type="video", payload_type=96,
                              payload_name="H264/90000", codec="H264",
                              clock_rate=RTP_CLOCK_VIDEO, track_id=track_no)
            self.packetizer = H264Packetizer(track, ssrc=0, seq_start=0,
                                             mtu=VOD_MTU)
        else:
            clock = (track.info.sample_rate or track.info.timescale
                     or 90000)
            info = StreamInfo(media_type="audio", payload_type=97,
                              payload_name=f"MPEG4-GENERIC/{clock}",
                              codec="MPEG4-GENERIC", clock_rate=clock,
                              track_id=track_no)
            self.packetizer = AacPacketizer(track, ssrc=0, seq_start=0)
        self.cursor = seek_index(track, start_npt)
        ring = StagedPacketRing(settings.ring_capacity,
                                is_video=self.is_video,
                                codec="H264" if self.is_video else None)
        self.stream = VodStream(info, settings, ring)
        self.stream.session_path = sess.path
        # thinning split: the engine sees passthrough, the pacer thins at
        # fill with the cold path's per-sample rule; both views share the
        # output's quality controller (RR/NADU feedback)
        self.orig_thinning = out.thinning
        out.thinning = _VodEngineThinning(
            controller=self.orig_thinning.controller)
        self.fill_filter = ThinningFilter(
            controller=self.orig_thinning.controller)
        # fresh serving state: the seq/ts rebase latches from the first
        # packet this session pushes (a re-PLAY restarts at out_seq_start,
        # as the cold path's fresh packetizer does)
        out.bookmark = 0
        out.rewrite.base_src_seq = -1
        out.rewrite.base_src_ts = -1
        self.seq_next = out.rewrite.out_seq_start & 0xFFFF
        self.ts_anchored = False
        self.samples_done = track.n_samples == 0
        self.window = None               # pinned current CachedWindow
        self.window_idx = -1
        self.released = False
        self.stream.add_output(out)

    # ------------------------------------------------------------- windows
    def _window_for(self, sess: "PacedVodSession", win_idx: int):
        c = sess.pacer.cache
        if self.window is not None:
            if self.window_idx == win_idx:
                return self.window
            c.unpin(self.window)
            self.window = None
        w = c.get(sess.file, self.track_no, self.track, win_idx)
        if w is not None:
            self.window = c.pin(w)
            self.window_idx = win_idx
        return w

    def _sample_flags(self, i: int) -> int:
        return (PacketFlags.VIDEO | PacketFlags.FRAME_FIRST
                | (PacketFlags.KEYFRAME_FIRST
                   if bool(self.track.sync[i]) else 0))

    def _anchor_ts(self, ts: int) -> None:
        # identity timestamp map: the rebase origin the engine latches from
        # the first pushed packet maps to itself, so wire timestamps equal
        # the cold packetizer's media timestamps
        if not self.ts_anchored:
            self.out.rewrite.out_ts_start = int(ts) & 0xFFFFFFFF
            self.ts_anchored = True

    def _room(self) -> int:
        ring = self.stream.rtp_ring
        bm = self.out.bookmark
        base = ring.tail if bm is None else max(min(bm, ring.head),
                                                ring.tail)
        return ring.capacity - (ring.head - base) - 8

    # ---------------------------------------------------------------- fill
    def fill(self, sess: "PacedVodSession", horizon_ms: float) -> None:
        track = self.track
        missed: set[int] = set()         # one cache lookup per window
        while not self.samples_done:     # per tick, hit or miss
            if sess.due_ms(track.sample_time_sec(self.cursor)) \
                    > horizon_ms:
                return
            if self._room() < 96:
                return                   # wait for the player to drain
            win_idx = sess.pacer.cache.window_of(self.cursor)
            w = (self.window if self.window is not None
                 and self.window_idx == win_idx else None)
            if w is None and win_idx not in missed:
                w = self._window_for(sess, win_idx)
                if w is None:
                    missed.add(win_idx)
            if w is not None:
                progressed = self._fill_hot(sess, w, horizon_ms)
            else:
                progressed = self._fill_cold(sess, horizon_ms)
            if not progressed:
                return
            if self.cursor >= track.n_samples:
                self.samples_done = True

    def _fill_hot(self, sess, w, horizon_ms: float) -> bool:
        """Block fill from a packed window: one fancy-index copy for the
        whole due span (and a per-sample walk only while thinning)."""
        ring = self.stream.rtp_ring
        room = self._room()
        lo_rel = self.cursor - w.lo
        dues = sess.t0_ms + w.sample_npt * (1000.0 / sess.speed)
        hi_rel = int(np.searchsorted(dues, horizon_ms, side="right"))
        hi_rel = min(max(hi_rel, lo_rel + 1), w.hi - w.lo)
        thinning = self.is_video and not self.fill_filter.passthrough()
        sel: list[tuple[int, int]] = []
        n_total = 0
        thinned = 0
        end_rel = lo_rel
        for s in range(lo_rel, hi_rel):
            p0, p1 = int(w.pkt_base[s]), int(w.pkt_base[s + 1])
            if p1 - p0 > ring.capacity - 8:
                # a sample larger than the whole ring can never be
                # block-served: drop it rather than stall the session
                end_rel = s + 1
                continue
            if n_total + (p1 - p0) > room:
                break
            if thinning and not ThinningFilter.admit(
                    self.fill_filter, self._sample_flags(w.lo + s)):
                end_rel = s + 1
                thinned += 1
                continue
            end_rel = s + 1
            if p1 > p0:
                if sel and sel[-1][1] == p0:
                    sel[-1] = (sel[-1][0], p1)   # extend a contiguous run
                else:
                    sel.append((p0, p1))
                n_total += p1 - p0
        if end_rel == lo_rel:
            return False                 # the first due sample did not fit
        if n_total:
            idx = np.concatenate([np.arange(a, b) for a, b in sel])
            self._anchor_ts(int(w.ts[idx[0]]))
            seqs = (self.seq_next + np.arange(n_total)) & 0xFFFF
            due_ms = sess.t0_ms + w.npt[idx] * (1000.0 / sess.speed)
            ring.push_block(w.data[idx], w.length[idx],
                            due_ms.astype(np.int64), w.flags[idx], seqs,
                            w.ts[idx])
            self.seq_next = int((self.seq_next + n_total) & 0xFFFF)
            obs.VOD_PACKETS.inc(n_total, path="hot")
            sess.pacer.hot_pkts += n_total
        sess.frames_thinned += thinned
        self.cursor = w.lo + end_rel
        return True

    def _fill_cold(self, sess, horizon_ms: float,
                   max_samples: int = 16) -> bool:
        """Cache-miss path: per-sample mmap read + packetize into the SAME
        ring; the subscriber keeps streaming at cold-path cost while the
        background fill packs the window."""
        track = self.track
        ring = self.stream.rtp_ring
        progressed = False
        for _ in range(max_samples):
            if self.cursor >= track.n_samples:
                break
            i = self.cursor
            due = sess.due_ms(track.sample_time_sec(i))
            if due > horizon_ms:
                break
            if self.is_video and not self.fill_filter.passthrough() \
                    and not ThinningFilter.admit(
                        self.fill_filter, self._sample_flags(i)):
                self.cursor += 1
                sess.frames_thinned += 1
                progressed = True
                continue
            data = sess.file.read_sample(track, i)
            self.packetizer.state.seq = self.seq_next & 0xFFFF
            pkts = self.packetizer.packetize_sample(data, i)
            if len(pkts) > ring.capacity - 8:
                self.cursor += 1         # ring-sized sample: drop, never
                continue                 # stall (see _fill_hot)
            if len(pkts) > self._room():
                break
            if pkts:
                self._anchor_ts(rtp.peek_timestamp(pkts[0]))
            for p in pkts:
                ring.push(p, int(due))
            self.seq_next = (self.seq_next + len(pkts)) & 0xFFFF
            self.cursor += 1
            if pkts:
                obs.VOD_PACKETS.inc(len(pkts), path="cold")
            sess.pacer.cold_pkts += len(pkts)
            progressed = True
        return progressed

    # ------------------------------------------------------------- retire
    def drained(self) -> bool:
        ring = self.stream.rtp_ring
        if ring.head == 0:
            return self.samples_done
        bm = self.out.bookmark
        return self.samples_done and bm is not None and bm >= ring.head

    def release(self, pacer: "VodPacerGroup") -> None:
        if self.released:
            return
        self.released = True
        pacer.cache.unpin(self.window)
        self.window = None
        self.out.thinning = self.orig_thinning
        self.stream.remove_output(self.out)
        pacer.engine_drop(self.stream)


class PacedVodSession:
    """One playing client under the group pacer: the hot counterpart of
    ``FileSession`` with the same control surface (``speed``, ``stop``,
    ``done``, ``packets_sent``, ``frames_thinned``)."""

    ts_scale = 1.0                       # Scale sessions stay cold

    def __init__(self, pacer: "VodPacerGroup", file: Mp4File,
                 outputs: dict[int, RelayOutput], *,
                 start_npt: float = 0.0, speed: float = 1.0,
                 path: str = "", now_ms: int | None = None):
        self.pacer = pacer
        self.file = open_shared(file.path)   # its own ref for fill reads
        self.speed = max(speed, 0.01)
        self.start_npt = start_npt
        self.path = path or os.path.basename(file.path)
        self.done = False
        self.stopped = False
        self.frames_thinned = 0
        t = int(time.monotonic() * 1000) if now_ms is None else now_ms
        self.t0_ms = t - start_npt * 1000.0 / self.speed
        self._pkts_base = {id(o): o.packets_sent
                           for o in outputs.values()}
        self.tracks: list[_PacedTrack] = []
        by_no = tracks_by_no(self.file)
        for track_no, out in outputs.items():
            tr = by_no.get(track_no)
            if tr is not None:
                self.tracks.append(_PacedTrack(self, track_no, tr, out,
                                               pacer.settings, start_npt))
        pacer.cache.note_open(self.file)

    def due_ms(self, npt_sec: float) -> float:
        return self.t0_ms + npt_sec * 1000.0 / self.speed

    @property
    def packets_sent(self) -> int:
        return sum(tr.out.packets_sent - self._pkts_base.get(id(tr.out), 0)
                   for tr in self.tracks)

    def tick(self, now_ms: int) -> None:
        if self.stopped or self.done:
            return
        horizon = now_ms + self.pacer.lookahead_ms
        done = True
        for tr in self.tracks:
            tr.fill(self, horizon)
            if not tr.drained():
                done = False
        self.done = done

    def start(self) -> None:            # FileSession's API: the pacer
        pass                            # drives, nothing to spawn

    def stop(self) -> None:
        self.pacer.retire(self)


class VodPacerGroup:
    """The shared group pacer: owns every hot VOD session, fills their
    rings once per pump wake and hands ``(stream, engine)`` pairs back to
    the pump, so VOD subscribers ride the live serving path, megabatch
    scheduler included.

    ``engine_for(stream)`` makes or finds a stream's ``FanoutEngine``,
    ``engine_drop(stream)`` forgets it and ``scheduler()`` returns the
    ``MegabatchScheduler`` whose host-oracle check every device-primed
    segment goes through (None: no device prime)."""

    def __init__(self, cache: SegmentCache, *, engine_for=None,
                 engine_drop=None, scheduler=None,
                 settings: StreamSettings | None = None,
                 lookahead_ms: int = 500, device_prime: bool = True):
        st = settings or StreamSettings()
        if st.ring_capacity > VOD_RING_CAPACITY:
            st = dataclasses.replace(st, ring_capacity=VOD_RING_CAPACITY)
        self.cache = cache
        self.settings = st
        self.engine_for = engine_for
        self.engine_drop = engine_drop or (lambda _s: None)
        self.scheduler = scheduler or (lambda: None)
        self.lookahead_ms = lookahead_ms
        self.device_prime = device_prime
        self.sessions: list[PacedVodSession] = []
        self._unprimed: list[tuple[PacedVodSession, _PacedTrack]] = []
        self._last_prune_ms = 0
        self.hot_pkts = 0
        self.cold_pkts = 0
        #: joins whose affine segment the device prime installed, and
        #: primed joins whose segment disagreed with the host oracle
        self.device_primes = 0
        self.prime_failures = 0
        #: device prime calls, and their host ns split: stacking the
        #: resident windows (and the state upload), the window pass with
        #: its readback, and the oracle check + install
        self.prime_calls = 0
        self.prime_stack_ns = 0
        self.prime_launch_ns = 0
        self.prime_oracle_ns = 0

    # ------------------------------------------------------------ sessions
    def open(self, file: Mp4File, outputs: dict[int, RelayOutput], *,
             start_npt: float = 0.0, speed: float = 1.0, path: str = "",
             now_ms: int | None = None) -> PacedVodSession:
        sess = PacedVodSession(self, file, outputs, start_npt=start_npt,
                               speed=speed, path=path, now_ms=now_ms)
        self.sessions.append(sess)
        self._unprimed.extend((sess, tr) for tr in sess.tracks)
        obs.VOD_SESSIONS.set(len(self.sessions))
        return sess

    def adopt(self, sess):
        """Register a paced session built elsewhere (the DVR tier's
        ``TimeShiftSession``) under this pacer's tick and retire.  It
        offers what ``tick`` and ``retire`` use: ``tick(now_ms)``,
        ``done``, ``stopped``, ``tracks`` (each with ``stream`` and
        ``release``), ``file.close()`` and an optional ``on_retire``."""
        self.sessions.append(sess)
        obs.VOD_SESSIONS.set(len(self.sessions))
        return sess

    def retire(self, sess: PacedVodSession) -> None:
        if sess in self.sessions:
            self.sessions.remove(sess)
        if self._unprimed:
            self._unprimed = [(s, t) for s, t in self._unprimed
                              if s is not sess]
        for tr in sess.tracks:
            tr.release(self)
        if not sess.stopped:
            sess.stopped = True
            sess.file.close()
            # inside the guard: a connection's stop() of a session the
            # pacer already retired must not call the hook twice
            cb = getattr(sess, "on_retire", None)
            if cb is not None:
                cb()
        obs.VOD_SESSIONS.set(len(self.sessions))

    # ---------------------------------------------------------------- tick
    def tick(self, now_ms: int) -> list:
        """Fill every session's rings up to the lookahead horizon and
        return the ``(stream, engine)`` pairs the pump steps this wake.
        Finished sessions retire here (their last packet was delivered:
        ``drained`` reads the bookmarks)."""
        pairs = []
        for sess in list(self.sessions):
            sess.tick(now_ms)
            if sess.done:
                self.retire(sess)
                continue
            for tr in sess.tracks:
                eng = (self.engine_for(tr.stream)
                       if self.engine_for is not None else None)
                pairs.append((tr.stream, eng))
        if self._unprimed:
            self._prime_joined()
        if now_ms - self._last_prune_ms >= 1000:
            self._last_prune_ms = now_ms
            for sess in self.sessions:
                for tr in sess.tracks:
                    tr.stream.prune(now_ms)
        return pairs

    # --------------------------------------------------- device-side prime
    def _prime_joined(self) -> None:
        """Affine prime of the joins since the last tick from the cache's
        card-resident windows: the windows of one padded row count are
        stacked on the device (zero rows for the pow2 batch are made
        there too), and every group runs as one bucket of ONE
        ``megabatch_window_steps`` call (one ``ed_relay_window`` launch on
        the card; a window wider than one launch takes runs in pieces).
        Each segment goes through the scheduler's ``_install_segment``
        oracle check; a mismatch leaves the join to the scheduler's own
        prime in the same wake and counts in ``prime_failures``."""
        pending, self._unprimed = self._unprimed, []
        sched = self.scheduler()
        if sched is None or not self.device_prime \
                or self.engine_for is None:
            return
        device = self.cache.device
        t0 = time.perf_counter_ns()
        groups: dict[int, list] = {}
        for sess, tr in pending:
            if sess.stopped or sess.done or tr.window is None:
                continue
            eng = self.engine_for(tr.stream)
            fast = eng.fast_outputs(tr.stream)
            if not fast:
                continue                 # batch-rung output: no affine set
            key = params_key(fast)
            mb = eng.megabatch_params
            if key == eng._params_key or (mb is not None
                                          and mb[0] == key):
                continue
            rows = tr.window.device_rows(device)
            groups.setdefault(int(rows.shape[0]), []).append(
                (eng, fast, key, rows))
        if not groups:
            return
        order, inputs = [], []
        for _pad, items in sorted(groups.items()):
            b_pad = pow2(len(items), 1)
            s_pad = pow2(max(len(f) for _e, f, _k, _r in items), 8)
            state = np.zeros((b_pad, s_pad, STATE_COLS), np.uint32)
            for i, (_e, fast, _k, _r) in enumerate(items):
                state[i, :len(fast)] = pack_output_state(fast)
            stack = torch.stack([r for _e, _f, _k, r in items])
            if b_pad > len(items):       # pow2 rows: zeros made on device
                stack = torch.cat([stack, torch.zeros(
                    (b_pad - len(items),) + tuple(stack.shape[1:]),
                    dtype=torch.uint8, device=device)])
            order.append(items)
            inputs.append((stack, torch.from_numpy(state).to(device)))
        t1 = time.perf_counter_ns()
        results = [r.cpu().numpy() for r in sched._window_steps(inputs)]
        t2 = time.perf_counter_ns()
        for items, res in zip(order, results):
            segs = scatter_affine_segments(
                res, [len(f) for _e, f, _k, _r in items])
            for (eng, _fast, key, _r), seg in zip(items, segs):
                if sched._install_segment(eng, key, seg):
                    self.device_primes += 1
                else:
                    self.prime_failures += 1
        t3 = time.perf_counter_ns()
        self.prime_calls += 1
        self.prime_stack_ns += t1 - t0
        self.prime_launch_ns += t2 - t1
        self.prime_oracle_ns += t3 - t2

    # ---------------------------------------------------------------- misc
    def stats(self) -> dict:
        calls = max(self.prime_calls, 1)
        return {
            "sessions": len(self.sessions),
            "hot_pkts": self.hot_pkts,
            "cold_pkts": self.cold_pkts,
            "device_primes": self.device_primes,
            "prime_failures": self.prime_failures,
            "prime_calls": self.prime_calls,
            "prime_stack_ms_per_call": self.prime_stack_ns / calls / 1e6,
            "prime_launch_ms_per_call": self.prime_launch_ns / calls / 1e6,
            "prime_oracle_ms_per_call": self.prime_oracle_ns / calls / 1e6,
            "cache": self.cache.stats(),
        }

    def close(self) -> None:
        """Retire every session.  The cache is not closed here: whoever
        built it owns it."""
        for sess in list(self.sessions):
            self.retire(sess)


__all__ = ["FileSession", "VodService", "VodStream", "PacedVodSession",
           "VodPacerGroup", "seek_index", "VOD_RING_CAPACITY"]
