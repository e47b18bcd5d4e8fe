"""RTP packet build and header peeks (RFC 3550 §5.1) — the scalar oracle.

The reflector treats packets as opaque byte slots of at most 2060 bytes and
reads seq/timestamp/SSRC at fixed offsets; the keyframe classifier computes
the header size as ``12 + 4*CC`` ignoring the extension bit.  The device
kernels compute the same fields for a whole window at once; the functions
here are what they are checked against.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

FIXED_HEADER_LEN = 12
RTP_VERSION = 2


class RtpError(ValueError):
    pass


@dataclass
class RtpPacket:
    """An RTP packet to build (no padding, no header extension), or one
    parsed from the wire (``parse`` strips the extension and padding)."""

    payload_type: int
    seq: int
    timestamp: int
    ssrc: int
    marker: bool = False
    csrcs: tuple[int, ...] = ()
    payload: bytes = b""

    def to_bytes(self) -> bytes:
        b0 = (2 << 6) | len(self.csrcs)
        b1 = (0x80 if self.marker else 0) | (self.payload_type & 0x7F)
        out = bytearray(struct.pack(
            "!BBHII", b0, b1, self.seq & 0xFFFF,
            self.timestamp & 0xFFFFFFFF, self.ssrc & 0xFFFFFFFF))
        for c in self.csrcs:
            out += struct.pack("!I", c & 0xFFFFFFFF)
        out += self.payload
        return bytes(out)

    @classmethod
    def parse(cls, data: bytes) -> "RtpPacket":
        if len(data) < FIXED_HEADER_LEN:
            raise RtpError(f"short RTP packet: {len(data)} bytes")
        b0, b1, seq, ts, ssrc = struct.unpack_from("!BBHII", data)
        if b0 >> 6 != RTP_VERSION:
            raise RtpError(f"bad RTP version {b0 >> 6}")
        cc = b0 & 0x0F
        off = FIXED_HEADER_LEN + 4 * cc
        if len(data) < off:
            raise RtpError("truncated CSRC list")
        csrcs = struct.unpack_from(f"!{cc}I", data, FIXED_HEADER_LEN) if cc else ()
        if b0 & 0x10:
            if len(data) < off + 4:
                raise RtpError("truncated extension header")
            _profile, words = struct.unpack_from("!HH", data, off)
            if len(data) < off + 4 + 4 * words:
                raise RtpError("truncated extension data")
            off += 4 + 4 * words
        payload = data[off:]
        if b0 & 0x20:
            if not payload or payload[-1] == 0 or payload[-1] > len(payload):
                raise RtpError("bad padding")
            payload = payload[:-payload[-1]]
        return cls(payload_type=b1 & 0x7F, seq=seq, timestamp=ts, ssrc=ssrc,
                   marker=bool(b1 & 0x80), csrcs=tuple(csrcs),
                   payload=payload)


def header_size_cc_only(data: bytes) -> int:
    """Header size as the reflector computes it: ``12 + 4*CC``, extension
    bit deliberately ignored."""
    return FIXED_HEADER_LEN + 4 * (data[0] & 0x0F)


def peek_seq(data: bytes) -> int:
    return struct.unpack_from("!H", data, 2)[0]


def peek_timestamp(data: bytes) -> int:
    return struct.unpack_from("!I", data, 4)[0]


def peek_ssrc(data: bytes) -> int:
    return struct.unpack_from("!I", data, 8)[0]


def rewrite_header(data: bytes, *, seq: int | None = None,
                   timestamp: int | None = None,
                   ssrc: int | None = None) -> bytes:
    """Return ``data`` with seq/timestamp/SSRC overwritten — the scalar
    oracle for the batched affine rewrite."""
    out = bytearray(data)
    if seq is not None:
        struct.pack_into("!H", out, 2, seq & 0xFFFF)
    if timestamp is not None:
        struct.pack_into("!I", out, 4, timestamp & 0xFFFFFFFF)
    if ssrc is not None:
        struct.pack_into("!I", out, 8, ssrc & 0xFFFFFFFF)
    return bytes(out)


def seq_delta(a: int, b: int) -> int:
    """Signed distance a-b in 16-bit sequence space (RFC 3550 A.1 style)."""
    d = (a - b) & 0xFFFF
    return d - 0x10000 if d >= 0x8000 else d
