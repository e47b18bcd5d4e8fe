"""Card-resident VOD segment cache.

Serving a file one sample at a time off an mmap and packetizing it per
client (``FileSession``) is O(samples × subscribers) host work.  Here a
hot asset is packetized ONCE: per ``(asset, track, window)`` the cache
packs a run of samples into the fixed-slot layout the live relay rings
use —

* ``data``/``length``   packet bytes in ``SLOT_SIZE`` slots (a subscriber
  ring fill is one fancy-index row copy),
* per-packet ``flags``/``ts``/``sample`` metadata, classified once at
  pack time with the ingest rules ``PacketRing.push`` applies, so the
  engine sees the same flags either way,
* ``staged``            the fused ``ops.staging`` rows (prefix ∥ le32
  length, pow2-padded), packed once, and
* ``device_rows()``     a copy of those rows on the cache's device,
  uploaded once per window and shared by every subscriber on it: a hot
  join's affine prime stacks resident windows on the card (no H2D of
  rows).

Packets are canonical: seq starts at 0 per window and ssrc is 0.  The
pacer restamps seq per subscriber at ring-fill time (thinned samples
must not consume sequence numbers, as on the cold packetizer) and the
per-subscriber ssrc/ts mapping rides the megabatch scheduler's affine
rewrite, oracle-checked at install.

DVR spill windows enter the same LRU through ``get_packed``: their rows
were packed at record time (``CachedWindow.from_packed``, with the
source seq and relay arrival a packet), so a time-shift or ``.dvr``
replay never repacks (``pack_window.calls`` stays put).

Entries live in an LRU whose byte budget covers the host arrays and the
card copies; windows a pacer cursor is serving are pinned (refcounted)
and never evicted.  ``snapshot``/``restore`` checkpoint which windows
were hot (metadata only), so a restart re-packs the working set in the
background on each asset's first open.

Observability (``obs``, at the reference's places): hits and misses
count ``vod_cache_hits_total``/``_misses_total``, evictions
``vod_cache_evictions_total``, the budgeted bytes set ``vod_cache_bytes``;
a fill is one profiler pass of the ``cache_fill`` phase (engine ``vod``
for a pack, ``dvr`` for a spill window), and a window's card copy counts
in ``tpu_h2d_bytes_total``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import obs, resolve_device
from ..obs import PROFILER
from ..ops import staging
from ..protocol import nalu, rtp
from ..relay.ring import SLOT_SIZE, PacketFlags, PacketRing
from .mp4 import Mp4File, Track
from .packetizer import AacPacketizer, H264Packetizer

#: packetizer MTU — the cold ``FileSession`` path's default, so hot and
#: cold fragment identically
VOD_MTU = 1400


class WindowUnpackable(ValueError):
    """A sample packetized into something a ring slot cannot hold (a giant
    un-fragmented AU): the asset is served cold, never truncated."""


def tracks_by_no(file: Mp4File) -> dict[int, Track]:
    """track_no → Track under the numbering ``sdp_for_file`` and
    ``FileSession`` use (video first, then audio)."""
    out: dict[int, Track] = {}
    n = 0
    for tr in (file.video_track(), file.audio_track()):
        if tr is not None:
            n += 1
            out[n] = tr
    return out


def _classify(pkt: bytes, is_video: bool) -> int:
    """Ingest classification of one canonical packet: the rules
    ``PacketRing.classify_slot`` applies to H.264/audio RTP."""
    f = 0
    if is_video:
        f |= PacketFlags.VIDEO
        if nalu.is_keyframe_first_packet(pkt):
            f |= PacketFlags.KEYFRAME_FIRST
        if nalu.is_frame_first_packet(pkt):
            f |= PacketFlags.FRAME_FIRST
    if nalu.is_frame_last_packet(pkt):
        f |= PacketFlags.FRAME_LAST
    return f


class StagedPacketRing(PacketRing):
    """A ``PacketRing`` that keeps its fused staging rows current, so
    ``ops.staging.gather_window`` over it is a plain row copy.  The VOD
    subscriber rings, whose rows arrive pre-packed from the cache (hot) or
    in per-sample pushes (a cold miss)."""

    def __init__(self, capacity: int, **kw):
        super().__init__(capacity, **kw)
        self.staged = np.zeros((capacity, staging.ROW_STRIDE), np.uint8)

    def push(self, packet: bytes, arrival_ms: int, *,
             is_rtcp: bool = False) -> int:
        pid = super().push(packet, arrival_ms, is_rtcp=is_rtcp)
        if pid >= 0:
            s = self.slot(pid)
            staging.pack_rows(self.data[s:s + 1], self.length[s:s + 1],
                              self.staged[s:s + 1])
        return pid

    def push_block(self, data, length, arrival_ms, flags, seq,
                   timestamp) -> int:
        first = super().push_block(data, length, arrival_ms, flags, seq,
                                   timestamp)
        n = len(length)
        if n:
            slots = np.arange(first, first + n) % self.capacity
            self.staged[slots] = staging.pack_rows(self.data[slots],
                                                   self.length[slots])
        return first


class CachedWindow:
    """One packed ``(asset, track, window)`` entry."""

    __slots__ = ("key", "lo", "hi", "data", "length", "flags", "ts",
                 "sample", "npt", "pkt_base", "sample_npt", "seq",
                 "arrival", "restored", "staged", "pins", "hits",
                 "_device", "_on_device", "device_uploads", "nbytes")

    def __init__(self, key, lo, hi, pkts, samples, npts, tss, is_video,
                 sample_npts):
        self.key = key
        self.lo, self.hi = lo, hi
        n = len(pkts)
        self.data = np.zeros((n, SLOT_SIZE), np.uint8)
        self.length = np.zeros(n, np.int32)
        self.flags = np.zeros(n, np.int32)
        self.ts = np.asarray(tss, np.int64)
        self.sample = np.asarray(samples, np.int32)
        self.npt = np.asarray(npts, np.float64)       # per packet
        for i, p in enumerate(pkts):
            if len(p) > SLOT_SIZE:
                raise WindowUnpackable(
                    f"packet {len(p)}B exceeds the {SLOT_SIZE}B slot")
            self.data[i, :len(p)] = np.frombuffer(p, np.uint8)
            self.length[i] = len(p)
            self.flags[i] = _classify(p, is_video)
        #: packets of sample ``lo+k`` live at rows
        #: [pkt_base[k], pkt_base[k+1])
        base = np.zeros(hi - lo + 1, np.int64)
        np.add.at(base, self.sample - lo + 1, 1)
        self.pkt_base = np.cumsum(base)
        #: per-sample npt from the sample table, so packet-less samples
        #: still carry their decode time (due-time pacing reads this)
        self.sample_npt = np.asarray(sample_npts, np.float64)
        #: per-packet source seq and relay-arrival ms: a DVR spill
        #: window's (``from_packed``) only; canonical MP4 windows have None
        self.seq = None
        self.arrival = None
        self._finish_init()

    def _finish_init(self) -> None:
        # pow2 rows, so stacked windows fall into few shape groups
        pad = staging.pow2(max(len(self.length), 1), 16)
        self.staged = staging.pack_rows(
            self.data, self.length,
            np.zeros((pad, staging.ROW_STRIDE), np.uint8))
        #: True when the rows came back through an erasure reconstruct
        self.restored = False
        self.pins = 0
        self.hits = 0
        self._device = None
        #: the cache's hook that counts the card copy into the budget
        self._on_device = None
        self.device_uploads = 0
        self.nbytes = (self.data.nbytes + self.staged.nbytes
                       + self.length.nbytes + self.flags.nbytes
                       + self.ts.nbytes + self.npt.nbytes
                       + self.sample.nbytes + self.pkt_base.nbytes
                       + self.sample_npt.nbytes)

    @classmethod
    def from_packed(cls, key, id_lo: int, data, length, flags, ts, *,
                    seq=None, arrival=None,
                    restored: bool = False) -> "CachedWindow":
        """A window from rows already in the fixed-slot packed format (a
        DVR spill window, ``dvr/spill.py``): no packetizer and no
        classification; the parallel arrays are adopted as they are and
        only the staging rows (a copy) are derived.  ``lo``/``hi``/
        ``sample`` are absolute packet ids (the live ring's id space),
        not MP4 sample indices."""
        n = len(length)
        w = object.__new__(cls)
        w.key = key
        w.lo, w.hi = id_lo, id_lo + n
        w.data = np.ascontiguousarray(data, np.uint8)
        w.length = np.ascontiguousarray(length, np.int32)
        w.flags = np.ascontiguousarray(flags, np.int32)
        w.ts = np.ascontiguousarray(ts, np.int64)
        w.sample = np.arange(id_lo, id_lo + n, dtype=np.int32)
        w.npt = np.zeros(n, np.float64)
        w.pkt_base = np.arange(n + 1, dtype=np.int64)
        w.sample_npt = np.zeros(n, np.float64)
        w.seq = (np.ascontiguousarray(seq, np.int32)
                 if seq is not None else None)
        w.arrival = (np.ascontiguousarray(arrival, np.int64)
                     if arrival is not None else None)
        w._finish_init()
        w.restored = bool(restored)
        if w.seq is not None:
            w.nbytes += w.seq.nbytes
        if w.arrival is not None:
            w.nbytes += w.arrival.nbytes
        return w

    @property
    def n_pkts(self) -> int:
        return len(self.length)

    def device_rows(self, device: torch.device) -> torch.Tensor:
        """The staged rows on ``device`` (its cache's): uploaded ONCE per
        window, then shared by every subscriber whose prime stacks this
        window.  An upload error raises (a CUDA error is never turned
        into a quiet host result)."""
        if self._device is None:
            self._device = staging.upload(torch.from_numpy(self.staged),
                                          device)
            self.device_uploads += 1
            obs.TPU_H2D_BYTES.inc(self.staged.nbytes)
            if self._on_device is not None:
                self._on_device(self.staged.nbytes)
        return self._device

    def drop_device(self) -> None:
        self._device = None


def pack_window(file: Mp4File, track: Track, lo: int, hi: int,
                key=None) -> CachedWindow:
    """Packetize samples ``[lo, hi)`` of ``track`` into one canonical
    window with the packetizer classes the cold path uses (fresh, seq from
    0, ssrc 0), so fragmentation, markers and parameter sets are those of
    a ``FileSession`` serving the same samples.  ``pack_window.calls``
    counts the calls: a spilled DVR asset opens with none (its windows
    enter the cache through ``CachedWindow.from_packed``)."""
    pack_window.calls += 1
    is_video = track.info.handler == "vide"
    if is_video:
        pk = H264Packetizer(track, ssrc=0, seq_start=0, mtu=VOD_MTU)
    else:
        pk = AacPacketizer(track, ssrc=0, seq_start=0)
    scale = max(track.info.timescale, 1)
    pkts: list[bytes] = []
    samples: list[int] = []
    npts: list[float] = []
    tss: list[int] = []
    for i in range(lo, hi):
        sample = file.read_sample(track, i)
        npt = float(track.dts[i]) / scale
        for p in pk.packetize_sample(sample, i):
            pkts.append(p)
            samples.append(i)
            npts.append(npt)
            tss.append(rtp.peek_timestamp(p))
    return CachedWindow(key, lo, hi, pkts, samples, npts, tss, is_video,
                        track.dts[lo:hi].astype(np.float64) / scale)


pack_window.calls = 0


def _asset_id(file: Mp4File) -> tuple:
    return (file.path, file.stat_key)


class SegmentCache:
    """Byte-budgeted LRU of packed windows with pinning, background fill,
    card residency and checkpointable metadata.  ``device`` is where
    ``CachedWindow.device_rows`` puts a window's rows (default ``"cuda"``,
    which raises without a card)."""

    SNAPSHOT_VERSION = 1

    def __init__(self, *, budget_bytes: int = 256 << 20,
                 window_samples: int = 64,
                 device: str | torch.device = "cuda"):
        self.budget_bytes = budget_bytes
        self.window_samples = max(int(window_samples), 1)
        self.device = resolve_device(device)
        self._lru: OrderedDict[tuple, CachedWindow] = OrderedDict()
        self._lock = threading.Lock()
        self._filling: set[tuple] = set()
        self._unpackable: set[tuple] = set()     # asset ids served cold
        #: checkpoint re-warm wishlist: (path, stat) → {(track, win)}
        self._want: dict[tuple, set] = {}
        self._pool = None
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.fills = 0
        self.fill_errors = 0
        #: packed fills whose rows came back through an erasure
        #: reconstruct (the storage tier)
        self.restored_fills = 0
        self._closed = False

    # ---------------------------------------------------------------- keys
    def window_of(self, sample: int) -> int:
        return sample // self.window_samples

    def window_span(self, track: Track, win: int) -> tuple[int, int]:
        lo = win * self.window_samples
        return lo, min(lo + self.window_samples, track.n_samples)

    # -------------------------------------------------------------- lookup
    def get(self, file: Mp4File, track_no: int, track: Track, win: int,
            *, background_fill: bool = True) -> CachedWindow | None:
        """The packed window, or None (a miss: the caller streams cold).
        A miss schedules a background fill so the NEXT pass over this
        window is hot; first-byte latency never waits on a pack."""
        aid = _asset_id(file)
        key = (aid, track_no, win)
        with self._lock:
            w = self._lru.get(key)
            if w is not None:
                self._lru.move_to_end(key)
                w.hits += 1
                self.hits += 1
                obs.VOD_CACHE_HITS.inc()
                return w
            self.misses += 1
            obs.VOD_CACHE_MISSES.inc()
            if aid in self._unpackable or self._closed:
                return None
            schedule = background_fill and key not in self._filling
            if schedule:
                self._filling.add(key)
        if schedule:
            self._executor().submit(self._fill_job, file, track_no,
                                    track, win, key)
        return None

    def get_packed(self, asset_id: tuple, track_no: int, win: int,
                   loader) -> CachedWindow | None:
        """The DVR open path: the same LRU, pinning, byte budget and card
        residency as ``get``, but a miss is filled inline by
        ``loader(win) -> CachedWindow | None`` (a spill-file read and
        ``CachedWindow.from_packed``) instead of ``pack_window``.  A
        loader that raises counts in ``fill_errors`` and the window is a
        miss."""
        key = (asset_id, track_no, int(win))
        with self._lock:
            w = self._lru.get(key)
            if w is not None:
                self._lru.move_to_end(key)
                w.hits += 1
                self.hits += 1
                obs.VOD_CACHE_HITS.inc()
                return w
            self.misses += 1
            obs.VOD_CACHE_MISSES.inc()
            if self._closed or key in self._filling:
                return None
            self._filling.add(key)
        t0 = time.perf_counter_ns()
        try:
            w = loader(key[2])
        except Exception:
            self.fill_errors += 1
            w = None
        finally:
            with self._lock:
                self._filling.discard(key)
        if w is None:
            return None
        w.key = key
        dur = time.perf_counter_ns() - t0
        PROFILER.account_pass("dvr", dur, {"cache_fill": dur})
        with self._lock:
            cur = self._lru.get(key)
            if cur is not None:
                return cur
            self._lru[key] = w
            w._on_device = (lambda n, k=key:
                            self._account_device_bytes(k, n))
            self.bytes += w.nbytes
            self.fills += 1
            if w.restored:
                self.restored_fills += 1
            self._evict_over_budget(keep=key)
            obs.VOD_CACHE_BYTES.set(self.bytes)
        return w

    def fill_now(self, file: Mp4File, track_no: int, track: Track,
                 win: int) -> CachedWindow | None:
        """Synchronous pack (warm-up)."""
        key = (_asset_id(file), track_no, win)
        with self._lock:
            w = self._lru.get(key)
            if w is not None:
                return w
            self._filling.add(key)
        return self._fill_job(file, track_no, track, win, key)

    def warm_asset(self, file: Mp4File) -> int:
        """Pack every window of every track."""
        n = 0
        for tno, tr in tracks_by_no(file).items():
            for win in range(self.window_of(max(tr.n_samples - 1, 0)) + 1):
                if self.fill_now(file, tno, tr, win) is not None:
                    n += 1
        return n

    # ---------------------------------------------------------------- fill
    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                1, thread_name_prefix="vod-cache-fill")
        return self._pool

    def _fill_job(self, file, track_no, track, win,
                  key) -> CachedWindow | None:
        t0 = time.perf_counter_ns()
        try:
            lo, hi = self.window_span(track, win)
            if lo >= hi:
                return None
            w = pack_window(file, track, lo, hi, key=key)
        except WindowUnpackable:
            with self._lock:
                self._unpackable.add(key[0])
            return None
        except (OSError, ValueError, IndexError):
            # racing teardown (the mapping closed mid-read) or a corrupt
            # sample table: the subscriber keeps streaming cold
            self.fill_errors += 1
            return None
        finally:
            with self._lock:
                self._filling.discard(key)
        dur = time.perf_counter_ns() - t0
        PROFILER.account_pass("vod", dur, {"cache_fill": dur})
        with self._lock:
            cur = self._lru.get(key)
            if cur is not None:
                return cur
            self._lru[key] = w
            w._on_device = (lambda n, k=key:
                            self._account_device_bytes(k, n))
            self.bytes += w.nbytes
            self.fills += 1
            self._evict_over_budget(keep=key)
            obs.VOD_CACHE_BYTES.set(self.bytes)
        return w

    def _account_device_bytes(self, key, n: int) -> None:
        """A window's card copy landed: fold it into the byte budget.  An
        orphan (evicted, still held by a pacer) is not counted; it dies
        with the window object."""
        with self._lock:
            if key not in self._lru:
                return
            self.bytes += n
            self._evict_over_budget(keep=key)
            obs.VOD_CACHE_BYTES.set(self.bytes)

    def _evict_over_budget(self, keep=None) -> None:
        # caller holds the lock.  Pinned windows and the just-inserted
        # ``keep`` entry are skipped: budget pressure can overshoot by the
        # pinned set, never corrupt a live fill, and a budget smaller than
        # one window must not thrash every pack it just paid for.
        if self.bytes <= self.budget_bytes:
            return
        for key in list(self._lru):
            if self.bytes <= self.budget_bytes:
                break
            w = self._lru[key]
            if w.pins > 0 or key == keep:
                continue
            del self._lru[key]
            self.bytes -= w.nbytes
            if w._device is not None:    # the accounted card copy too
                self.bytes -= w.staged.nbytes
            w.drop_device()
            self.evictions += 1
            obs.VOD_CACHE_EVICTIONS.inc()

    # ----------------------------------------------------------- pin/unpin
    def pin(self, w: CachedWindow) -> CachedWindow:
        with self._lock:
            w.pins += 1
        return w

    def unpin(self, w: CachedWindow | None) -> None:
        if w is None:
            return
        with self._lock:
            w.pins = max(w.pins - 1, 0)
            if w.pins == 0:
                self._evict_over_budget()
            obs.VOD_CACHE_BYTES.set(self.bytes)

    # ------------------------------------------------- checkpoint metadata
    def snapshot(self) -> dict:
        """Which windows are hot (plain ints and strings), not their
        bytes: a restore re-packs in the background."""
        with self._lock:
            wins = [{
                "path": key[0][0], "size": key[0][1][0],
                "mtime_ns": key[0][1][1], "track": key[1],
                "win": key[2], "hits": w.hits,
            } for key, w in self._lru.items()]
        return {"version": self.SNAPSHOT_VERSION, "windows": wins}

    def restore(self, meta: dict) -> int:
        """Adopt a snapshot's wishlist: windows of assets that still stat
        the same are packed in the background the next time the asset is
        opened (``note_open``)."""
        if not isinstance(meta, dict) \
                or meta.get("version") != self.SNAPSHOT_VERSION:
            return 0
        n = 0
        with self._lock:
            for rec in meta.get("windows", ()):
                try:
                    aid = (rec["path"],
                           (int(rec["size"]), int(rec["mtime_ns"])))
                    self._want.setdefault(aid, set()).add(
                        (int(rec["track"]), int(rec["win"])))
                    n += 1
                except (KeyError, TypeError, ValueError):
                    continue
        return n

    def note_open(self, file: Mp4File) -> int:
        """First open of an asset: schedule the background fills of its
        restored windows."""
        aid = _asset_id(file)
        with self._lock:
            want = self._want.pop(aid, None)
        if not want:
            return 0
        tracks = tracks_by_no(file)
        n = 0
        for track_no, win in sorted(want):
            tr = tracks.get(track_no)
            if tr is None or win > self.window_of(
                    max(tr.n_samples - 1, 0)):
                continue
            self.get(file, track_no, tr, win)    # miss → background fill
            n += 1
        return n

    # ---------------------------------------------------------------- misc
    def stats(self) -> dict:
        with self._lock:
            wins = list(self._lru.values())
            return {
                "windows": len(wins), "bytes": self.bytes,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "fills": self.fills,
                "fill_errors": self.fill_errors,
                "restored_fills": self.restored_fills,
                "device_uploads": sum(w.device_uploads for w in wins),
                "device_bytes": sum(w.staged.nbytes for w in wins
                                    if w._device is not None),
                "pinned": sum(1 for w in wins if w.pins),
            }

    def close(self) -> None:
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        with self._lock:
            for w in self._lru.values():
                w.drop_device()
            self._lru.clear()
            self.bytes = 0
            obs.VOD_CACHE_BYTES.set(0)


__all__ = ["SegmentCache", "CachedWindow", "StagedPacketRing",
           "pack_window", "tracks_by_no", "WindowUnpackable", "VOD_MTU"]
