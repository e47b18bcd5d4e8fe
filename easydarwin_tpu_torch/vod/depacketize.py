"""RTP → H.264 access units (the packetizer's inverse).

Feeds the recorder (RtspRecordModule flow) and, later, the transcode/HLS
paths.  Handles single NAL units, STAP-A aggregation, and FU-A fragments
(RFC 6184); groups NALs into access units on RTP timestamp change or
marker, and captures SPS/PPS out-of-band for the AVCC config record.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..protocol import nalu, rtp


@dataclass
class AccessUnit:
    timestamp: int                       # RTP timestamp (90 kHz)
    nals: list[bytes] = field(default_factory=list)

    @property
    def is_idr(self) -> bool:
        return any((n[0] & 0x1F) == 5 for n in self.nals if n)

    def to_avcc(self, length_size: int = 4) -> bytes:
        out = bytearray()
        for n in self.nals:
            out += len(n).to_bytes(length_size, "big") + n
        return bytes(out)


class H264Depacketizer:
    """Push RTP packets (in seq order), pop completed access units."""

    def __init__(self):
        self.sps: bytes | None = None
        self.pps: bytes | None = None
        self._current: AccessUnit | None = None
        self._fu_buf: bytearray | None = None
        self._fu_type = 0
        self._done: list[AccessUnit] = []
        self.packets = 0
        self.malformed = 0

    def push(self, packet: bytes) -> None:
        try:
            p = rtp.RtpPacket.parse(packet)
        except rtp.RtpError:
            self.malformed += 1
            return
        self.packets += 1
        if not p.payload:
            return
        if self._current is not None and p.timestamp != self._current.timestamp:
            self._finish()
        if self._current is None:
            self._current = AccessUnit(p.timestamp)
        t = p.payload[0] & 0x1F
        if 1 <= t <= 23:
            self._add_nal(p.payload)
        elif t == nalu.NAL_STAP_A:
            pos = 1
            while pos + 2 <= len(p.payload):
                ln = int.from_bytes(p.payload[pos:pos + 2], "big")
                pos += 2
                if ln == 0 or pos + ln > len(p.payload):
                    self.malformed += 1
                    break
                self._add_nal(p.payload[pos:pos + ln])
                pos += ln
        elif t == nalu.NAL_FU_A and len(p.payload) >= 2:
            ind, hdr = p.payload[0], p.payload[1]
            start, end = hdr & 0x80, hdr & 0x40
            if start:
                self._fu_type = (ind & 0xE0) | (hdr & 0x1F)
                self._fu_buf = bytearray((self._fu_type,))
            if self._fu_buf is not None:
                self._fu_buf += p.payload[2:]
                if end:
                    self._add_nal(bytes(self._fu_buf))
                    self._fu_buf = None
            else:
                self.malformed += 1         # mid-fragment without start
        else:
            self.malformed += 1
        if p.marker:
            self._finish()

    def _add_nal(self, nal: bytes) -> None:
        if not nal:
            return
        t = nal[0] & 0x1F
        if t == nalu.NAL_SPS:
            self.sps = nal
            return                          # config, not sample data
        if t == nalu.NAL_PPS:
            self.pps = nal
            return
        self._current.nals.append(nal)

    def _finish(self) -> None:
        if self._current is not None and self._current.nals:
            self._done.append(self._current)
        self._current = None
        self._fu_buf = None

    def pop_units(self) -> list[AccessUnit]:
        out, self._done = self._done, []
        return out

    def flush(self) -> list[AccessUnit]:
        self._finish()
        return self.pop_units()
