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


@dataclass
class RtpPacket:
    """An RTP packet to build (no padding, no header extension)."""

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
