"""MP4/MOV box parser with sample-table walkers.

Covers the box set the reference's ``QTFileLib`` implements as ``QTAtom_*``
classes (stco/stsc/stsd/stss/stsz/stts/tkhd/mdhd/mvhd + co64/ctts/hdlr),
re-designed as flat numpy sample tables instead of per-atom object trees:
one pass builds, per track, arrays of (file offset, size, dts, ctts offset,
sync flag) — the natural layout both for the paced sender and for future
batch staging to the device.

Also parses hint tracks ('hint' handler, 'rtp ' sample description) so
pre-hinted files stream via their own packetization instructions, like
``QTHintTrack``.
"""

from __future__ import annotations

import io
import struct
import mmap
import os
import threading
from dataclasses import dataclass, field

import numpy as np

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts",
               b"udta", b"dinf", b"tref"}


_SHARED_LOCK = threading.Lock()
_DETACHED = object()                   # replaced-on-disk, still-referenced
_SHARED: "dict[str, Mp4File]" = {}     # path -> parsed instance (refs>=0)
_SHARED_IDLE_KEEP = 8                  # parsed files kept warm at 0 refs


def open_shared(path: str) -> "Mp4File":
    """Refcounted shared instance per (path, mtime, size): concurrent
    players of one file share the parse and the mapping; a replaced
    file (changed stat) gets a fresh instance while old readers keep
    their old mapping until release."""
    st = os.stat(path)
    key = (st.st_size, st.st_mtime_ns)
    with _SHARED_LOCK:
        f = _SHARED.get(path)
        if f is not None and f.stat_key == key:
            f._refs += 1
            return f
    fresh = Mp4File(path)              # parse outside the lock
    fresh._shared_key = path
    with _SHARED_LOCK:
        cur = _SHARED.get(path)
        if cur is not None and cur.stat_key == key:
            cur._refs += 1             # raced: adopt the winner
            fresh._shared_key = None
            fresh._close_now()
            return cur
        if cur is not None and cur._refs == 0:
            cur._shared_key = None
            cur._close_now()           # stale, unreferenced: evict now
        elif cur is not None:
            # stale but in use: detach from the by-path table, but KEEP
            # refcounted closing (a bare _shared_key=None would make the
            # FIRST holder's close() unmap under the others' reads)
            cur._shared_key = _DETACHED
        _SHARED[path] = fresh
        fresh._refs = 1
        return fresh


class Mp4Error(ValueError):
    pass


@dataclass
class Box:
    kind: bytes
    start: int           # offset of the box header in the file
    size: int            # total size incl. header
    header: int          # header length (8 or 16)
    children: list["Box"] = field(default_factory=list)

    @property
    def body(self) -> tuple[int, int]:
        return self.start + self.header, self.size - self.header

    def find(self, *path: bytes) -> "Box | None":
        cur: Box | None = self
        for kind in path:
            cur = next((c for c in cur.children if c.kind == kind), None)
            if cur is None:
                return None
        return cur

    def find_all(self, kind: bytes) -> list["Box"]:
        return [c for c in self.children if c.kind == kind]


def _scan(f: io.BufferedReader, start: int, end: int) -> list[Box]:
    boxes = []
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        size, kind = struct.unpack(">I4s", hdr)
        header = 8
        if size == 1:
            big = f.read(8)
            size = struct.unpack(">Q", big)[0]
            header = 16
        elif size == 0:
            size = end - pos
        if size < header or pos + size > end:
            break
        box = Box(kind, pos, size, header)
        if kind in _CONTAINERS:
            box.children = _scan(f, pos + header, pos + size)
        boxes.append(box)
        pos += size
    return boxes


@dataclass
class TrackInfo:
    track_id: int = 0
    handler: str = ""            # vide / soun / hint
    timescale: int = 90000
    duration: int = 0
    codec: str = ""              # avc1 / mp4a / ...
    width: int = 0
    height: int = 0
    channels: int = 0
    sample_rate: int = 0
    # codec config
    sps: list[bytes] = field(default_factory=list)
    pps: list[bytes] = field(default_factory=list)
    nal_length_size: int = 4
    audio_config: bytes = b""    # AudioSpecificConfig from esds
    # hint-track linkage
    hint_for: int = 0            # referenced media track id (tref/hint)
    rtp_timescale: int = 0


class Track:
    """One media track: info + flat sample tables."""

    def __init__(self, info: TrackInfo):
        self.info = info
        self.offsets = np.zeros(0, dtype=np.int64)
        self.sizes = np.zeros(0, dtype=np.int64)
        self.dts = np.zeros(0, dtype=np.int64)
        self.ctts = np.zeros(0, dtype=np.int64)
        self.sync = np.zeros(0, dtype=bool)

    @property
    def n_samples(self) -> int:
        return len(self.sizes)

    def duration_sec(self) -> float:
        ts = self.info.timescale or 1
        if self.info.duration:
            return self.info.duration / ts
        if len(self.dts):
            return float(self.dts[-1]) / ts
        return 0.0

    def sample_time_sec(self, i: int) -> float:
        return float(self.dts[i]) / (self.info.timescale or 1)

    def sync_sample_at_or_before(self, i: int) -> int:
        if not self.sync.any():
            return i
        idx = np.nonzero(self.sync[:i + 1])[0]
        return int(idx[-1]) if len(idx) else 0


class Mp4File:
    """Parsed movie + mmap-backed sample reader.

    The reference keeps an FD cache because hundreds of concurrent VOD
    readers hammer buffered file IO (``OSFileSource.cpp:634``); here the
    sample data path is a shared read-only ``mmap`` instead — sample
    reads are stateless slices (no per-reader seek cursor, no per-reader
    buffer), and the parse-time file object is closed right after
    mapping, so N concurrent players of one file cost ONE parse, ONE
    mapping and ONE descriptor (the mapping's own dup).
    ``open_shared``/``close`` refcount one parsed instance per
    (path, mtime, size) — the FD-cache role, modernized."""

    def __init__(self, path: str):
        self.path = path
        self._refs = 0                 # managed by open_shared/close
        self._shared_key = None
        self._f = open(path, "rb")
        try:
            st = os.fstat(self._f.fileno())
            self.stat_key = (st.st_size, st.st_mtime_ns)
            size = st.st_size
            if size == 0:
                raise Mp4Error("empty file")
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            self.boxes = _scan(self._f, 0, size)
            moov = next((b for b in self.boxes if b.kind == b"moov"),
                        None)
            if moov is None:
                raise Mp4Error("no moov box")
            self.timescale, self.duration = self._parse_mvhd(moov)
            self.tracks: list[Track] = []
            for trak in moov.find_all(b"trak"):
                t = self._parse_trak(trak)
                if t is not None:
                    self.tracks.append(t)
        finally:
            self._f.close()            # the mapping keeps the pages alive
            self._f = None

    def close(self):
        # branch on _shared_key ONLY under the lock: open_shared may be
        # detaching this instance concurrently, and an unlocked read
        # could route a detached (replaced-but-referenced) instance down
        # the by-path release path, leaking its mapping forever
        with _SHARED_LOCK:
            key = self._shared_key
            if key is not None:
                self._refs -= 1
                if self._refs > 0:
                    return
                if key is not _DETACHED:
                    # still the by-path entry: keep a few warm for
                    # reopen bursts; evict beyond the cap
                    idle = [p for p, v in _SHARED.items()
                            if v._refs == 0]
                    while len(idle) > _SHARED_IDLE_KEEP:
                        victim = idle.pop(0)
                        v = _SHARED.pop(victim)
                        v._shared_key = None
                        v._close_now()
                    return
                self._shared_key = None   # detached, last holder: unmap
        self._close_now()

    def _close_now(self):
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    # -- readers -----------------------------------------------------------
    def _read_at(self, off: int, n: int) -> bytes:
        if self._f is not None:        # during parse
            self._f.seek(off)
            return self._f.read(n)
        return bytes(self._mm[off:off + n])

    def _full(self, box: Box) -> bytes:
        off, n = box.body
        return self._read_at(off, n)

    def read_sample(self, track: Track, i: int) -> bytes:
        return self._read_at(int(track.offsets[i]), int(track.sizes[i]))

    # -- top-level parses --------------------------------------------------
    def _parse_mvhd(self, moov: Box) -> tuple[int, int]:
        mvhd = moov.find(b"mvhd")
        if mvhd is None:
            return 90000, 0
        b = self._full(mvhd)
        version = b[0]
        if version == 1:
            ts, dur = struct.unpack_from(">IQ", b, 20)
        else:
            ts, dur = struct.unpack_from(">II", b, 12)
        return ts, dur

    def _parse_trak(self, trak: Box) -> Track | None:
        info = TrackInfo()
        tkhd = trak.find(b"tkhd")
        if tkhd is not None:
            b = self._full(tkhd)
            version = b[0]
            info.track_id = struct.unpack_from(
                ">I", b, 20 if version == 1 else 12)[0]
        mdia = trak.find(b"mdia")
        if mdia is None:
            return None
        mdhd = mdia.find(b"mdhd")
        if mdhd is not None:
            b = self._full(mdhd)
            if b[0] == 1:
                info.timescale, info.duration = struct.unpack_from(">IQ", b, 20)
            else:
                info.timescale, info.duration = struct.unpack_from(">II", b, 12)
        hdlr = mdia.find(b"hdlr")
        if hdlr is not None:
            b = self._full(hdlr)
            info.handler = b[8:12].decode("latin-1")
        stbl = mdia.find(b"minf", b"stbl")
        if stbl is None:
            return None
        self._parse_stsd(stbl, info)
        # hint reference
        tref = trak.find(b"tref")
        if tref is not None:
            hint = tref.find(b"hint")
            if hint is not None:
                refs = self._full(hint)
                if len(refs) >= 4:
                    info.hint_for = struct.unpack_from(">I", refs, 0)[0]
        track = Track(info)
        self._build_sample_tables(stbl, track)
        return track

    # -- stsd (codec config) ----------------------------------------------
    def _parse_stsd(self, stbl: Box, info: TrackInfo) -> None:
        stsd = stbl.find(b"stsd")
        if stsd is None:
            return
        b = self._full(stsd)
        n = struct.unpack_from(">I", b, 4)[0]
        off = 8
        for _ in range(n):
            if off + 8 > len(b):
                break
            esize, kind = struct.unpack_from(">I4s", b, off)
            info.codec = kind.decode("latin-1").strip()
            entry = b[off + 8:off + esize]
            if kind == b"avc1" and len(entry) >= 78:
                info.width, info.height = struct.unpack_from(">HH", entry, 24)
                self._parse_avcc(entry[78:], info)
            elif kind == b"mp4a" and len(entry) >= 28:
                info.channels = struct.unpack_from(">H", entry, 16)[0]
                info.sample_rate = struct.unpack_from(">I", entry, 24)[0] >> 16
                self._parse_esds(entry[28:], info)
            elif kind == b"rtp ":
                # hint sample entry: u32 hinttrackversion/highestcompat,
                # then maxpacketsize, then additionaldata boxes (tims = rtp
                # timescale)
                if len(entry) >= 16:
                    pos = 12
                    while pos + 8 <= len(entry):
                        bs, bk = struct.unpack_from(">I4s", entry, pos)
                        if bk == b"tims" and bs >= 12:
                            info.rtp_timescale = struct.unpack_from(
                                ">I", entry, pos + 8)[0]
                        if bs < 8:
                            break
                        pos += bs
            off += max(esize, 8)

    @staticmethod
    def _parse_avcc_bytes(data: bytes, info: TrackInfo) -> None:
        if len(data) < 7:
            return
        info.nal_length_size = (data[4] & 0x03) + 1
        n_sps = data[5] & 0x1F
        pos = 6
        for _ in range(n_sps):
            if pos + 2 > len(data):
                return
            ln = struct.unpack_from(">H", data, pos)[0]
            pos += 2
            info.sps.append(data[pos:pos + ln])
            pos += ln
        if pos >= len(data):
            return
        n_pps = data[pos]
        pos += 1
        for _ in range(n_pps):
            if pos + 2 > len(data):
                return
            ln = struct.unpack_from(">H", data, pos)[0]
            pos += 2
            info.pps.append(data[pos:pos + ln])
            pos += ln

    def _parse_avcc(self, extensions: bytes, info: TrackInfo) -> None:
        pos = 0
        while pos + 8 <= len(extensions):
            size, kind = struct.unpack_from(">I4s", extensions, pos)
            if size < 8:
                break
            if kind == b"avcC":
                self._parse_avcc_bytes(extensions[pos + 8:pos + size], info)
                return
            pos += size

    def _parse_esds(self, extensions: bytes, info: TrackInfo) -> None:
        pos = 0
        while pos + 8 <= len(extensions):
            size, kind = struct.unpack_from(">I4s", extensions, pos)
            if size < 8:
                break
            if kind == b"esds":
                body = extensions[pos + 12:pos + size]   # skip version/flags
                info.audio_config = self._find_decoder_specific(body)
                return
            pos += size

    @staticmethod
    def _find_decoder_specific(body: bytes) -> bytes:
        """Walk the ES descriptor tree for tag 0x05 (DecoderSpecificInfo)."""
        def read_len(b, p):
            ln = 0
            while p < len(b):
                c = b[p]
                p += 1
                ln = (ln << 7) | (c & 0x7F)
                if not c & 0x80:
                    break
            return ln, p

        p = 0
        stack = [(body, 0)]
        while stack:
            b, p = stack.pop()
            while p < len(b):
                tag = b[p]
                ln, q = read_len(b, p + 1)
                payload = b[q:q + ln]
                if tag == 0x05:
                    return payload
                if tag == 0x03:       # ES_Descriptor: skip ES_ID+flags
                    stack.append((payload, 3))
                elif tag == 0x04:     # DecoderConfig: skip 13 fixed bytes
                    stack.append((payload, 13))
                p = q + ln
        return b""

    # -- sample tables -----------------------------------------------------
    def _build_sample_tables(self, stbl: Box, track: Track) -> None:
        def table(kind: bytes) -> bytes | None:
            box = stbl.find(kind)
            return self._full(box) if box else None

        stsz = table(b"stsz")
        if stsz is None:
            return
        uniform, count = struct.unpack_from(">II", stsz, 4)
        if uniform:
            sizes = np.full(count, uniform, dtype=np.int64)
        else:
            sizes = np.frombuffer(stsz, dtype=">u4", count=count,
                                  offset=12).astype(np.int64)
        # chunk offsets
        stco = table(b"stco")
        co64 = table(b"co64")
        if stco is not None:
            n_chunks = struct.unpack_from(">I", stco, 4)[0]
            chunk_off = np.frombuffer(stco, dtype=">u4", count=n_chunks,
                                      offset=8).astype(np.int64)
        elif co64 is not None:
            n_chunks = struct.unpack_from(">I", co64, 4)[0]
            chunk_off = np.frombuffer(co64, dtype=">u8", count=n_chunks,
                                      offset=8).astype(np.int64)
        else:
            return
        # sample→chunk map
        stsc = table(b"stsc")
        offsets = np.zeros(count, dtype=np.int64)
        if stsc is not None:
            n_ent = struct.unpack_from(">I", stsc, 4)[0]
            ent = np.frombuffer(stsc, dtype=">u4", count=n_ent * 3,
                                offset=8).reshape(n_ent, 3).astype(np.int64)
            s = 0
            for e in range(n_ent):
                first_chunk = ent[e, 0] - 1
                per_chunk = ent[e, 1]
                last_chunk = (ent[e + 1, 0] - 1 if e + 1 < n_ent
                              else len(chunk_off))
                for c in range(first_chunk, last_chunk):
                    if s >= count:
                        break
                    off = chunk_off[c]
                    for _ in range(per_chunk):
                        if s >= count:
                            break
                        offsets[s] = off
                        off += sizes[s]
                        s += 1
        # decode timestamps
        stts = table(b"stts")
        dts = np.zeros(count, dtype=np.int64)
        if stts is not None:
            n_ent = struct.unpack_from(">I", stts, 4)[0]
            ent = np.frombuffer(stts, dtype=">u4", count=n_ent * 2,
                                offset=8).reshape(n_ent, 2).astype(np.int64)
            t = 0
            s = 0
            for e in range(n_ent):
                for _ in range(int(ent[e, 0])):
                    if s >= count:
                        break
                    dts[s] = t
                    t += int(ent[e, 1])
                    s += 1
        # composition offsets
        ctts = table(b"ctts")
        cts = np.zeros(count, dtype=np.int64)
        if ctts is not None:
            n_ent = struct.unpack_from(">I", ctts, 4)[0]
            ent = np.frombuffer(ctts, dtype=">i4", count=n_ent * 2,
                                offset=8).reshape(n_ent, 2).astype(np.int64)
            s = 0
            for e in range(n_ent):
                for _ in range(int(ent[e, 0])):
                    if s >= count:
                        break
                    cts[s] = int(ent[e, 1])
                    s += 1
        # sync samples
        stss = table(b"stss")
        sync = np.ones(count, dtype=bool)
        if stss is not None:
            sync[:] = False
            n_ent = struct.unpack_from(">I", stss, 4)[0]
            idx = np.frombuffer(stss, dtype=">u4", count=n_ent,
                                offset=8).astype(np.int64) - 1
            sync[idx[idx < count]] = True
        track.offsets, track.sizes = offsets, sizes
        track.dts, track.ctts, track.sync = dts, cts, sync

    # -- convenience -------------------------------------------------------
    def video_track(self) -> Track | None:
        return next((t for t in self.tracks if t.info.handler == "vide"), None)

    def audio_track(self) -> Track | None:
        return next((t for t in self.tracks if t.info.handler == "soun"), None)

    def hint_tracks(self) -> list[Track]:
        return [t for t in self.tracks if t.info.handler == "hint"]
