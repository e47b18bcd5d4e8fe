"""DVR window spill: live ring windows → an on-disk packed-window store.

A copy of the reference's ``dvr/spill.py``, with its ``obs`` sites: each
spilled window counts ``dvr_windows_spilled_total`` and is one profiler
pass of the ``spill`` phase (engine ``dvr``), each window the retention
drops ``dvr_retention_evictions_total``.  Completed
ring windows (the absolute-id grid ``[w·k, (w+1)·k)``) are snapshot in
the fixed-slot packed format the segment cache serves (``CachedWindow``'s
parallel arrays: payload bytes + length/flags/ts/seq/arrival a packet)
and appended to a per-(asset, track) spill file with an index record per
window, so a re-open is a memcpy and never a repack.

Layout per ``<dvr_root>/<path>/track<id>/``:

* ``spill.bin``   append-only window blobs (magic ∥ u32 n ∥ int32
  length[n] ∥ int32 flags[n] ∥ int32 seq[n] ∥ int64 ts[n] ∥ int64
  arrival_ms[n] ∥ payload bytes, tightly packed)
* ``index.json``  atomic tmp+rename per update: window → file offset,
  byte count, crc32, packet count, ts/arrival ranges, keyframe rel ids,
  plus the track's ``StreamInfo``, the recording generation and a
  ``complete`` flag set at finalize.

Retention is a per-track byte + duration budget: the oldest windows leave
the index first (``evictions``); when dead bytes exceed live bytes (and
``compact_floor_bytes``) the bin file is compacted (live blobs copied,
tmp+rename).  The index is the source of truth: a crash between a blob
append and its index write loses only that window.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib

import numpy as np

from .. import obs
from ..obs import PROFILER
from ..protocol.sdp import StreamInfo
from ..relay.ring import SLOT_SIZE, PacketFlags

BLOB_MAGIC = b"EDWN"
INDEX_VERSION = 1
#: blob header: magic ∥ u32 packet count
_META = struct.Struct("<4sI")


class SpillError(RuntimeError):
    """A spill file or index that cannot be read (corrupt, version
    skew)."""


class WindowRows:
    """One window's packets as the fixed-slot parallel arrays: the
    exchange format between the live ring, the spill file and the segment
    cache.  ``id_lo`` is the absolute ring id of row 0, so the live ring
    is the hot tail and the spill the cold tail of one id space."""

    __slots__ = ("id_lo", "data", "length", "flags", "ts", "seq",
                 "arrival", "restored")

    def __init__(self, id_lo: int, data, length, flags, ts, seq,
                 arrival):
        self.id_lo = id_lo
        #: True when these rows were erasure-reconstructed from shards
        #: rather than read from a spill file
        self.restored = False
        self.data = data                # [n, SLOT_SIZE] uint8
        self.length = length            # int32 [n]
        self.flags = flags              # int32 [n]
        self.ts = ts                    # int64 [n]
        self.seq = seq                  # int32 [n]
        self.arrival = arrival          # int64 [n], relay arrival ms

    @property
    def n(self) -> int:
        return len(self.length)

    def keyframe_rels(self) -> list[int]:
        return [int(i) for i in
                np.nonzero(self.flags & PacketFlags.KEYFRAME_FIRST)[0]]


def snapshot_window(ring, lo: int, hi: int) -> WindowRows:
    """Copy ring ids ``[lo, hi)`` out as a ``WindowRows``: one
    fancy-index pass per parallel array."""
    lo = max(lo, ring.tail)
    hi = min(hi, ring.head)
    idx = (np.arange(lo, hi) % ring.capacity).astype(np.int64)
    return WindowRows(
        lo, ring.data[idx].copy(), ring.length[idx].copy(),
        ring.flags[idx].copy(), ring.timestamp[idx].copy(),
        ring.seq[idx].copy(), ring.arrival[idx].copy())


def encode_blob(rows: WindowRows) -> bytes:
    """Tightly packed window blob: metadata arrays + concatenated payload
    bytes (no slot padding on disk)."""
    n = rows.n
    out = bytearray(_META.pack(BLOB_MAGIC, n))
    out += rows.length.astype("<i4").tobytes()
    out += rows.flags.astype("<i4").tobytes()
    out += rows.seq.astype("<i4").tobytes()
    out += rows.ts.astype("<i8").tobytes()
    out += rows.arrival.astype("<i8").tobytes()
    for i in range(n):
        out += rows.data[i, :int(rows.length[i])].tobytes()
    return bytes(out)


def decode_blob(blob: bytes, id_lo: int) -> WindowRows:
    """Inverse of ``encode_blob``: a memcpy scatter back into fixed-slot
    rows (no packetizer, no classification)."""
    magic, n = _META.unpack_from(blob, 0)
    if magic != BLOB_MAGIC:
        raise SpillError("bad window blob magic")
    off = _META.size
    length = np.frombuffer(blob, "<i4", n, off).astype(np.int32)
    off += 4 * n
    flags = np.frombuffer(blob, "<i4", n, off).astype(np.int32)
    off += 4 * n
    seq = np.frombuffer(blob, "<i4", n, off).astype(np.int32)
    off += 4 * n
    ts = np.frombuffer(blob, "<i8", n, off).astype(np.int64)
    off += 8 * n
    arrival = np.frombuffer(blob, "<i8", n, off).astype(np.int64)
    off += 8 * n
    data = np.zeros((n, SLOT_SIZE), np.uint8)
    for i in range(n):
        ln = int(length[i])
        if off + ln > len(blob):
            raise SpillError("truncated window blob")
        data[i, :ln] = np.frombuffer(blob, np.uint8, ln, off)
        off += ln
    return WindowRows(id_lo, data, length, flags, ts, seq, arrival)


def _info_to_meta(info: StreamInfo) -> dict:
    return {"media_type": info.media_type,
            "payload_type": info.payload_type,
            "payload_name": info.payload_name, "codec": info.codec,
            "clock_rate": info.clock_rate, "track_id": info.track_id,
            "fmtp": info.fmtp}


def _meta_to_info(meta: dict) -> StreamInfo:
    return StreamInfo(
        media_type=meta.get("media_type", "video"),
        payload_type=int(meta.get("payload_type", 96)),
        payload_name=meta.get("payload_name", ""),
        codec=meta.get("codec", ""),
        clock_rate=int(meta.get("clock_rate", 90000)),
        track_id=int(meta.get("track_id", 1)),
        fmtp=meta.get("fmtp", ""))


class SpillWriter:
    """Append-only per-track spill file + atomically updated index."""

    def __init__(self, dir_path: str, info: StreamInfo, *,
                 window_pkts: int, retention_bytes: int = 64 << 20,
                 retention_sec: float = 300.0,
                 compact_floor_bytes: int = 1 << 20, gen: int = 0):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self.bin_path = os.path.join(dir_path, "spill.bin")
        self.index_path = os.path.join(dir_path, "index.json")
        self.k = int(window_pkts)
        self.retention_bytes = int(retention_bytes)
        self.retention_sec = float(retention_sec)
        #: dead bytes below this never trigger a copy
        self.compact_floor_bytes = int(compact_floor_bytes)
        self.info = info
        #: recording generation: a reader of the previous generation
        #: must not adopt this index on reload
        self.gen = int(gen)
        self.windows: list[dict] = []
        self.live_bytes = 0
        self.dead_bytes = 0
        self.evictions = 0
        self.compactions = 0
        self.complete = False
        # a writer always starts a fresh asset: truncate (the previous
        # asset's blobs would be a dead prefix no budget reclaims)
        self._f = open(self.bin_path, "wb")

    def append_window(self, win: int, rows: WindowRows) -> dict:
        blob = encode_blob(rows)
        off = self._f.tell()
        self._f.write(blob)
        self._f.flush()
        rec = {"win": int(win), "off": off, "nbytes": len(blob),
               "crc": zlib.crc32(blob) & 0xFFFFFFFF,
               "n": rows.n, "id_lo": int(rows.id_lo),
               "ts_lo": int(rows.ts[0]) if rows.n else 0,
               "ts_hi": int(rows.ts[-1]) if rows.n else 0,
               "arr_lo": int(rows.arrival[0]) if rows.n else 0,
               "arr_hi": int(rows.arrival[-1]) if rows.n else 0,
               "kf": rows.keyframe_rels()}
        self.windows.append(rec)
        self.live_bytes += len(blob)
        self._retain()
        self._write_index()
        return rec

    def _retain(self) -> None:
        """Oldest-first retention by bytes and duration; compaction when
        the dead prefix outweighs the live tail."""
        if not self.windows:
            return
        newest_arr = self.windows[-1]["arr_hi"]
        horizon = newest_arr - self.retention_sec * 1000.0
        while len(self.windows) > 1 and (
                self.live_bytes > self.retention_bytes
                or self.windows[0]["arr_hi"] < horizon):
            rec = self.windows.pop(0)
            self.live_bytes -= rec["nbytes"]
            self.dead_bytes += rec["nbytes"]
            self.evictions += 1
            obs.DVR_RETENTION_EVICTIONS.inc()
        if self.dead_bytes > max(self.live_bytes,
                                 self.compact_floor_bytes):
            self._compact()

    def _compact(self) -> None:
        """Rewrite the bin file with only the live windows (tmp+rename),
        rebuilding the index records' offsets."""
        tmp = self.bin_path + ".tmp"
        self._f.flush()
        with open(self.bin_path, "rb") as src, open(tmp, "wb") as dst:
            for rec in self.windows:
                src.seek(rec["off"])
                rec["off"] = dst.tell()
                dst.write(src.read(rec["nbytes"]))
        self._f.close()
        os.replace(tmp, self.bin_path)
        self._f = open(self.bin_path, "ab")
        self.dead_bytes = 0
        self.compactions += 1
        self._write_index()

    def _doc(self) -> dict:
        return {"version": INDEX_VERSION, "k": self.k,
                "complete": self.complete, "gen": self.gen,
                "media": _info_to_meta(self.info),
                "windows": self.windows}

    def _write_index(self) -> None:
        tmp = self.index_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(self._doc(), fh, separators=(",", ":"))
        os.replace(tmp, self.index_path)

    def finalize(self) -> int:
        """Mark the asset complete (the windows are already in the
        serving format).  Returns the live window count."""
        self.complete = True
        self._write_index()
        self._f.close()
        return len(self.windows)

    def close(self) -> None:
        self._f.close()


class SpilledTrack:
    """Read side of one track's spill directory.  A window's read chain
    is the local file, then ``fetch`` (a peer's spill blob: bytes, ``b""``
    while in flight, or None), then ``restore`` (the storage tier's
    reconstruct, same protocol).  ``restore`` is asked whenever the fetch
    brought no blob, a pending fetch included: a peer that answers slowly
    or not at all does not hold the cursor while the store's reconstruct
    has the window."""

    def __init__(self, dir_path: str, *, fetch=None, restore=None):
        self.dir = dir_path
        self.bin_path = os.path.join(dir_path, "spill.bin")
        self.index_path = os.path.join(dir_path, "index.json")
        self.fetch = fetch
        self.restore = restore
        #: latched by read_window: the last miss had a fetch or restore
        #: in flight, so the caller holds its cursor and retries
        self.fetch_pending = False
        #: windows whose on-disk bytes failed the index crc32
        self.crc_errors = 0
        #: the asset was re-recorded under this reader (the generation
        #: changed on reload): local windows are gone
        self.superseded = False
        self.gen: int | None = None
        self.reload()

    def reload(self) -> None:
        try:
            with open(self.index_path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            raise SpillError(f"unreadable index {self.index_path}: {e}")
        if doc.get("version") != INDEX_VERSION:
            raise SpillError(f"index version {doc.get('version')}")
        gen = int(doc.get("gen", 0))
        if self.gen is not None and gen != self.gen:
            # a re-arm truncated spill.bin and restarted the window grid
            # in a new ring id space: the old asset is gone
            self.superseded = True
            self.windows = {}
            return
        self.gen = gen
        self.k = int(doc["k"])
        self.complete = bool(doc.get("complete"))
        self.info = _meta_to_info(doc.get("media", {}))
        self.windows = {int(r["win"]): r for r in doc.get("windows", ())}

    @property
    def win_lo(self) -> int | None:
        return min(self.windows) if self.windows else None

    @property
    def win_hi(self) -> int | None:
        return max(self.windows) if self.windows else None

    @property
    def base_arrival_ms(self) -> int | None:
        w = self.win_lo
        return self.windows[w]["arr_lo"] if w is not None else None

    def duration_sec(self) -> float:
        if not self.windows:
            return 0.0
        lo, hi = self.win_lo, self.win_hi
        return max(self.windows[hi]["arr_hi"]
                   - self.windows[lo]["arr_lo"], 0) / 1000.0

    def window_blob(self, win: int) -> bytes | None:
        """Raw blob bytes of one indexed window, verified against the
        index's crc32: a truncated or compacted-under-us read is a local
        miss (None, counted in ``crc_errors``).  An index record without
        ``crc`` reads unverified."""
        rec = self.windows.get(int(win))
        if rec is None:
            return None
        try:
            with open(self.bin_path, "rb") as fh:
                fh.seek(rec["off"])
                blob = fh.read(rec["nbytes"])
        except OSError:
            return None                  # spill bytes gone: a local miss
        crc = rec.get("crc")
        if crc is not None and (zlib.crc32(blob) & 0xFFFFFFFF) != int(crc):
            self.crc_errors += 1
            return None
        return blob

    @staticmethod
    def _decode(blob: bytes, id_lo: int) -> WindowRows | None:
        """A blob that does not decode (truncated or compacted under the
        reader, or a malformed fetched blob) is a miss, as in the
        reference."""
        try:
            return decode_blob(blob, id_lo)
        except (SpillError, struct.error, ValueError):
            return None

    def read_window(self, win: int) -> WindowRows | None:
        """Window ``win``'s rows: local spill file first, then the fetch
        hook, then the restore hook (also while the fetch is pending).  A
        local miss re-reads the index once (an armed asset's writer keeps
        appending after this reader opened).  A hook answering ``b""``
        latches ``fetch_pending``."""
        self.fetch_pending = False
        rec = self.windows.get(int(win))
        if rec is None:
            try:
                self.reload()
            except SpillError:
                pass
            rec = self.windows.get(int(win))
        if rec is not None:
            blob = self.window_blob(win)
            if blob:
                rows = self._decode(blob, rec["id_lo"])
                if rows is not None:
                    return rows
        if self.fetch is not None:
            blob = self.fetch(int(win))
            if blob:
                return self._decode(blob, int(win) * self.k)
            if blob == b"":
                self.fetch_pending = True
        if self.restore is not None:
            blob = self.restore(int(win))
            if blob:
                rows = self._decode(blob, int(win) * self.k)
                if rows is not None:
                    rows.restored = True
                return rows
            if blob == b"":
                self.fetch_pending = True
        return None

    def seek_id(self, npt_sec: float, *, keyframe: bool = True) -> int:
        """Absolute packet id for ``npt`` seconds past the recording
        start, snapped back to the start of the keyframe-first run at or
        before it (``keyframe=False``: exact).  One window read at most:
        the snap works off the index's ``kf`` rel ids."""
        base = self.base_arrival_ms
        if base is None:
            return 0
        target = base + max(npt_sec, 0.0) * 1000.0
        wins = sorted(self.windows)
        cand = wins[0]
        for w in wins:
            if self.windows[w]["arr_lo"] <= target:
                cand = w
            else:
                break
        rec = self.windows[cand]
        rows = self.read_window(cand)
        if rows is None or rows.n == 0:
            exact = rec["id_lo"]
        else:
            rel = int(np.searchsorted(rows.arrival, target,
                                      side="right"))
            exact = rows.id_lo + min(max(rel - 1, 0), rows.n - 1)
        if not keyframe:
            return exact
        for w in reversed([x for x in wins if x <= cand]):
            r = self.windows[w]
            kfset = set(r.get("kf", ()))
            kfs = sorted(k for k in kfset if r["id_lo"] + k <= exact)
            if kfs:
                # SPS, PPS and IDR are each keyframe-first: snap to the
                # start of the run, so a replay starts with the
                # parameter sets like a live late joiner
                k = kfs[-1]
                while k - 1 in kfset:
                    k -= 1
                return r["id_lo"] + k
        return exact

    def close(self) -> None:
        pass


class WindowSpiller:
    """Rides the relay tick for one (stream, writer) pair: each time the
    ring head crosses a ``[w·k, (w+1)·k)`` boundary the completed window
    is snapshot and appended.  When nothing completed a tick is one
    integer compare."""

    def __init__(self, stream, writer: SpillWriter):
        self.stream = stream
        self.writer = writer
        self.k = writer.k
        # the first full window at or after arm time
        self.next_win = (stream.rtp_ring.head + self.k - 1) // self.k
        self.skipped = 0                 # windows lost to ring eviction
        self.spilled = 0
        #: host ns spent snapshotting and appending windows
        self.spill_ns = 0

    def tick(self, now_ms: int, *, max_windows: int = 8) -> int:
        ring = self.stream.rtp_ring
        k = self.k
        done = 0
        while (self.next_win + 1) * k <= ring.head \
                and done < max_windows:
            w = self.next_win
            self.next_win += 1
            if w * k < ring.tail:
                # the ring evicted the window before the pump reached it
                self.skipped += 1
                continue
            t0 = time.perf_counter_ns()
            rows = snapshot_window(ring, w * k, (w + 1) * k)
            self.writer.append_window(w, rows)
            self.spilled += 1
            done += 1
            obs.DVR_WINDOWS_SPILLED.inc()
            dur = time.perf_counter_ns() - t0
            self.spill_ns += dur
            PROFILER.account_pass("dvr", dur, {"spill": dur},
                                  path=self.stream.session_path)
        return done


__all__ = ["SpillWriter", "SpilledTrack", "WindowSpiller", "WindowRows",
           "snapshot_window", "encode_blob", "decode_blob", "SpillError",
           "INDEX_VERSION"]
