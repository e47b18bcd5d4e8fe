"""Minimal MP4 muxer — recording backend + test-fixture generator.

Reference parity: ``RtspRecordModule``'s ``EasyMP4Writer`` (custom MP4
boxer, ``EasyMP4Writer.cpp``), without the libav dependency: H.264 (AVCC
samples) + AAC tracks, ftyp/mdat/moov with full sample tables.  Round-trips
through ``vod.mp4.Mp4File`` (tested), which also makes it the fixture
factory for the VOD test pyramid.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


def box(kind: bytes, *payloads: bytes) -> bytes:
    body = b"".join(payloads)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def full_box(kind: bytes, version: int, flags: int, *payloads: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *payloads)


@dataclass
class _WTrack:
    track_id: int
    handler: bytes               # b"vide" / b"soun"
    timescale: int
    codec_entry: bytes           # complete stsd sample entry
    width: int = 0
    height: int = 0
    sizes: list[int] = field(default_factory=list)
    durations: list[int] = field(default_factory=list)
    offsets: list[int] = field(default_factory=list)
    sync: list[bool] = field(default_factory=list)

    @property
    def duration(self) -> int:
        return sum(self.durations)


class Mp4Writer:
    def __init__(self, path: str, movie_timescale: int = 1000):
        self.path = path
        self.movie_timescale = movie_timescale
        self._f = open(path, "wb")
        self._f.write(box(b"ftyp", b"isom", struct.pack(">I", 512),
                          b"isomiso2avc1mp41"))
        self._mdat_start = self._f.tell()
        self._f.write(struct.pack(">I4s", 8, b"mdat"))
        self.tracks: list[_WTrack] = []
        self._closed = False

    # -- track setup -------------------------------------------------------
    def add_h264_track(self, sps: bytes, pps: bytes, width: int, height: int,
                       timescale: int = 90000) -> int:
        avcc = box(b"avcC",
                   bytes((1, sps[1] if len(sps) > 1 else 66,
                          sps[2] if len(sps) > 2 else 0,
                          sps[3] if len(sps) > 3 else 30,
                          0xFF, 0xE1)),
                   struct.pack(">H", len(sps)), sps,
                   bytes((1,)), struct.pack(">H", len(pps)), pps)
        entry = struct.pack(">I4s", 86 + len(avcc), b"avc1") + \
            bytes(6) + struct.pack(">H", 1) + bytes(16) + \
            struct.pack(">HH", width, height) + \
            struct.pack(">II", 0x00480000, 0x00480000) + bytes(4) + \
            struct.pack(">H", 1) + bytes(32) + \
            struct.pack(">Hh", 0x18, -1) + avcc
        t = _WTrack(len(self.tracks) + 1, b"vide", timescale, entry,
                    width, height)
        self.tracks.append(t)
        return len(self.tracks) - 1

    def add_aac_track(self, audio_config: bytes, sample_rate: int,
                      channels: int) -> int:
        dsi = bytes((0x05, len(audio_config))) + audio_config
        dcd = bytes((0x04, 13 + len(dsi), 0x40, 0x15)) + bytes(11) + dsi
        es = bytes((0x03, 3 + len(dcd))) + struct.pack(">HB", 1, 0) + dcd
        esds = full_box(b"esds", 0, 0, es)
        entry = struct.pack(">I4s", 36 + len(esds), b"mp4a") + \
            bytes(6) + struct.pack(">H", 1) + bytes(8) + \
            struct.pack(">HHI", channels, 16, 0) + \
            struct.pack(">I", sample_rate << 16) + esds
        t = _WTrack(len(self.tracks) + 1, b"soun", sample_rate, entry)
        self.tracks.append(t)
        return len(self.tracks) - 1

    # -- samples -----------------------------------------------------------
    def write_sample(self, track_index: int, data: bytes, duration: int,
                     sync: bool = True) -> None:
        t = self.tracks[track_index]
        t.offsets.append(self._f.tell())
        t.sizes.append(len(data))
        t.durations.append(duration)
        t.sync.append(sync)
        self._f.write(data)

    # -- finalize ----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        end = self._f.tell()
        # patch mdat size
        self._f.seek(self._mdat_start)
        self._f.write(struct.pack(">I", end - self._mdat_start))
        self._f.seek(end)
        self._f.write(self._moov())
        self._f.close()

    def _moov(self) -> bytes:
        movie_dur = 0
        for t in self.tracks:
            if t.timescale:
                movie_dur = max(movie_dur, t.duration * self.movie_timescale
                                // t.timescale)
        mvhd = full_box(b"mvhd", 0, 0, struct.pack(
            ">IIII", 0, 0, self.movie_timescale, movie_dur),
            struct.pack(">IH", 0x00010000, 0x0100), bytes(10),
            struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                        0x40000000),
            bytes(24), struct.pack(">I", len(self.tracks) + 1))
        traks = b"".join(self._trak(t) for t in self.tracks if t.sizes)
        return box(b"moov", mvhd, traks)

    def _trak(self, t: _WTrack) -> bytes:
        tkhd = full_box(b"tkhd", 0, 7, struct.pack(
            ">IIIII", 0, 0, t.track_id, 0,
            t.duration * self.movie_timescale // max(t.timescale, 1)),
            bytes(8), struct.pack(">hhhH", 0, 0, 0, 0x0100 if t.handler ==
                                  b"soun" else 0), bytes(2),
            struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                        0x40000000),
            struct.pack(">II", t.width << 16, t.height << 16))
        mdhd = full_box(b"mdhd", 0, 0, struct.pack(
            ">IIII", 0, 0, t.timescale, t.duration),
            struct.pack(">HH", 0x55C4, 0))
        hdlr = full_box(b"hdlr", 0, 0, bytes(4), t.handler, bytes(12),
                        b"easydarwin-tpu\x00")
        # sample tables
        stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1), t.codec_entry)
        # stts: run-length encode durations
        runs = []
        for d in t.durations:
            if runs and runs[-1][1] == d:
                runs[-1][0] += 1
            else:
                runs.append([1, d])
        stts = full_box(b"stts", 0, 0, struct.pack(">I", len(runs)),
                        b"".join(struct.pack(">II", c, d) for c, d in runs))
        # one chunk per sample keeps stsc/stco trivially correct
        stsc = full_box(b"stsc", 0, 0, struct.pack(">I", 1),
                        struct.pack(">III", 1, 1, 1))
        stsz = full_box(b"stsz", 0, 0, struct.pack(">II", 0, len(t.sizes)),
                        b"".join(struct.pack(">I", s) for s in t.sizes))
        stco = full_box(b"stco", 0, 0, struct.pack(">I", len(t.offsets)),
                        b"".join(struct.pack(">I", o) for o in t.offsets))
        boxes = [stsd, stts, stsc, stsz, stco]
        if not all(t.sync):
            idx = [i + 1 for i, s in enumerate(t.sync) if s]
            boxes.append(full_box(b"stss", 0, 0, struct.pack(">I", len(idx)),
                                  b"".join(struct.pack(">I", i) for i in idx)))
        stbl = box(b"stbl", *boxes)
        url = full_box(b"url ", 0, 1)
        dinf = box(b"dinf", full_box(b"dref", 0, 0,
                                     struct.pack(">I", 1), url))
        smhd = full_box(b"smhd", 0, 0, bytes(4))
        vmhd = full_box(b"vmhd", 0, 1, bytes(8))
        minf = box(b"minf", vmhd if t.handler == b"vide" else smhd, dinf, stbl)
        mdia = box(b"mdia", mdhd, hdlr, minf)
        return box(b"trak", tkhd, mdia)
