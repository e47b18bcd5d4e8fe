"""RTP/JPEG (RFC 2435) — MJPEG camera streams.

Every JPEG frame is independently decodable, so a packet with **fragment
offset 0 is a keyframe-first packet** and the relay fast-start logic works
unchanged for MJPEG.

This module is the codec kit around that: RFC 2435 header parse/build, a
packetizer (JPEG scan → RTP fragments) and a depacketizer that
reconstructs a decodable JFIF file from fragments using the RFC's
Appendix A standard quantization/Huffman tables.  The transcode ladder
(``models.mjpeg_ladder``) depacketizes, re-encodes and re-packetizes with
it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from . import rtp


class MjpegError(ValueError):
    pass


# -- RFC 2435 section 3.1: main JPEG header (8 bytes) -----------------------

@dataclass
class JpegHeader:
    type_specific: int = 0
    fragment_offset: int = 0          # 24-bit byte offset into the scan
    type: int = 1                     # 0=4:2:2, 1=4:2:0 (+64 w/ restarts)
    q: int = 255                      # 1..99 scale, 100..127 reserved, >=128 in-band tables
    width: int = 0                    # pixels (wire carries /8)
    height: int = 0
    restart_interval: int = 0         # present when 64 <= type <= 127
    qtables: bytes = b""              # in-band tables (q >= 128, offset 0)
    precision: int = 0

    @property
    def is_frame_start(self) -> bool:
        return self.fragment_offset == 0


def parse_payload(payload: bytes) -> tuple[JpegHeader, bytes]:
    """RTP payload → (header, scan fragment bytes)."""
    if len(payload) < 8:
        raise MjpegError("RTP/JPEG payload shorter than main header")
    h = JpegHeader()
    h.type_specific = payload[0]
    h.fragment_offset = int.from_bytes(payload[1:4], "big")
    h.type = payload[4]
    h.q = payload[5]
    h.width = payload[6] * 8
    h.height = payload[7] * 8
    off = 8
    if 64 <= h.type <= 127:
        if len(payload) < off + 4:
            raise MjpegError("truncated restart marker header")
        h.restart_interval = struct.unpack_from("!H", payload, off)[0]
        off += 4
    if h.q >= 128 and h.fragment_offset == 0:
        if len(payload) < off + 4:
            raise MjpegError("truncated quantization table header")
        _mbz, h.precision, qlen = struct.unpack_from("!BBH", payload, off)
        off += 4
        if len(payload) < off + qlen:
            raise MjpegError("truncated quantization tables")
        h.qtables = payload[off:off + qlen]
        off += qlen
    return h, payload[off:]


def build_payload(header: JpegHeader, fragment: bytes) -> bytes:
    out = bytes([header.type_specific]) + \
        header.fragment_offset.to_bytes(3, "big") + \
        bytes([header.type, header.q, header.width // 8, header.height // 8])
    if 64 <= header.type <= 127:
        out += struct.pack("!HH", header.restart_interval, 0xFFFF)
    if header.q >= 128 and header.fragment_offset == 0:
        out += struct.pack("!BBH", 0, header.precision, len(header.qtables))
        out += header.qtables
    return out + fragment


def is_frame_first_packet(packet: bytes) -> bool:
    """Fragment offset 0 ⇒ start of a JPEG frame ⇒ (M)JPEG "keyframe".

    Mirrored on the device by ``ops.parse.parse_packets(codec="mjpeg")``."""
    if len(packet) < 12:
        return False
    hs = rtp.header_size_cc_only(packet)
    payload = packet[hs:]
    return len(payload) >= 8 and payload[1:4] == b"\x00\x00\x00"


# -- packetizer --------------------------------------------------------------

def packetize_jpeg(scan: bytes, *, width: int, height: int, seq: int,
                   timestamp: int, ssrc: int, type_: int = 1, q: int = 255,
                   qtables: bytes = b"", payload_type: int = 26,
                   mtu: int = 1400) -> list[bytes]:
    """JPEG entropy-coded scan → RTP packets (marker on the last).

    ``scan`` is the data between SOS and EOI; ``qtables`` (when ``q >=
    128``) rides in-band in the first fragment per RFC 2435 §3.1.8."""
    if width % 8 or height % 8 or width > 2040 or height > 2040:
        raise MjpegError("RFC 2435 dimensions must be multiples of 8, <=2040")
    pkts = []
    off = 0
    first_seq = seq
    while off < len(scan) or not pkts:
        hdr = JpegHeader(fragment_offset=off, type=type_, q=q, width=width,
                         height=height,
                         qtables=qtables if off == 0 else b"")
        head_len = len(build_payload(hdr, b""))
        room = max(mtu - 12 - head_len, 1)
        frag = scan[off:off + room]
        off += len(frag)
        last = off >= len(scan)
        pkts.append(rtp.RtpPacket(
            payload_type=payload_type, seq=(first_seq + len(pkts)) & 0xFFFF,
            timestamp=timestamp & 0xFFFFFFFF, ssrc=ssrc, marker=last,
            payload=build_payload(hdr, frag)).to_bytes())
        if last:
            break
    return pkts


# -- RFC 2435 Appendix A: standard tables & JFIF header synthesis ------------

_LUMA_Q = bytes([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = bytes([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])

_DC_CODELENS = bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0])
_DC_SYMBOLS = bytes(range(12))
# Standard chroma tables (RFC 2435 Appendix B / T.81 Annex K tables K.4/K.6).
# Real RTP/JPEG senders (libjpeg, ffmpeg, cameras) code Cb/Cr with these, not
# the luma set — decoders must select per component.
_DC_CHROMA_CODELENS = bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
_DC_CHROMA_SYMBOLS = bytes(range(12))
_AC_CHROMA_CODELENS = bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])
_AC_CHROMA_SYMBOLS = bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])
_AC_CODELENS = bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D])
_AC_SYMBOLS = bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])


def make_qtables(q: int) -> bytes:
    """Scale the Appendix A base tables by Q (1..99) → 128 bytes
    (luma ∥ chroma)."""
    q = max(1, min(q, 99))
    factor = 5000 // q if q < 50 else 200 - q * 2
    out = bytearray()
    for base in (_LUMA_Q, _CHROMA_Q):
        for v in base:
            out.append(max(1, min((v * factor + 50) // 100, 255)))
    return bytes(out)


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack("!H", len(body) + 2) + body


def make_jfif_headers(header: JpegHeader, qtables: bytes) -> bytes:
    """SOI→SOS JFIF prefix per Appendix A ``MakeHeaders`` (standard
    Huffman tables; sampling from the RTP/JPEG type)."""
    if not qtables:
        qtables = make_qtables(header.q if 1 <= header.q <= 99 else 99)
    elif len(qtables) < 128:
        qtables = (qtables + qtables)[:128]   # one in-band table: reuse for chroma
    out = bytearray(b"\xff\xd8")                       # SOI
    out += _marker(0xDB, b"\x00" + qtables[:64])       # DQT luma
    out += _marker(0xDB, b"\x01" + qtables[64:128])    # DQT chroma
    if 64 <= header.type <= 127 and header.restart_interval:
        out += _marker(0xDD, struct.pack("!H", header.restart_interval))
    samp = 0x22 if (header.type & 0x3F) == 1 else 0x21   # 4:2:0 vs 4:2:2
    out += _marker(0xC0, struct.pack(                  # SOF0, 3 components
        "!BHHB", 8, header.height, header.width, 3) +
        bytes([1, samp, 0, 2, 0x11, 1, 3, 0x11, 1]))
    out += _marker(0xC4, b"\x00" + _DC_CODELENS + _DC_SYMBOLS)   # DHT DC luma
    out += _marker(0xC4, b"\x10" + _AC_CODELENS + _AC_SYMBOLS)   # DHT AC luma
    out += _marker(0xC4, b"\x01" + _DC_CHROMA_CODELENS + _DC_CHROMA_SYMBOLS)
    out += _marker(0xC4, b"\x11" + _AC_CHROMA_CODELENS + _AC_CHROMA_SYMBOLS)
    out += _marker(0xDA, b"\x03" +                     # SOS
                   bytes([1, 0x00, 2, 0x11, 3, 0x11]) + b"\x00\x3f\x00")
    return bytes(out)


# -- depacketizer ------------------------------------------------------------

@dataclass
class _Frame:
    timestamp: int
    header: JpegHeader | None = None
    parts: list[tuple[int, bytes]] = field(default_factory=list)
    have_marker: bool = False


class JpegDepacketizer:
    """Reassemble RTP/JPEG fragments into decodable JFIF frames.

    ``push(packet)`` returns complete JPEG file bytes when the packet
    carries the frame's marker bit and all fragments are present, else
    ``None``.  Incomplete frames are dropped when a newer timestamp
    arrives (cameras are lossy; MJPEG has no inter-frame dependencies)."""

    def __init__(self):
        self._cur: _Frame | None = None
        self.frames_out = 0
        self.frames_dropped = 0

    def push(self, packet: bytes) -> bytes | None:
        parts = self.push_parts(packet)
        if parts is None:
            return None
        header, scan, _ts = parts
        jfif = make_jfif_headers(header, header.qtables)
        if not scan.endswith(b"\xff\xd9"):
            scan += b"\xff\xd9"            # EOI
        return jfif + scan

    def push_parts(self, packet: bytes
                   ) -> tuple[JpegHeader, bytes, int] | None:
        """Like push() but returns (header, raw scan, rtp timestamp) —
        the transcode ladder wants the entropy-coded scan, not a JFIF
        container."""
        pkt = rtp.RtpPacket.parse(packet)
        header, frag = parse_payload(pkt.payload)
        if self._cur is None or pkt.timestamp != self._cur.timestamp:
            if self._cur is not None:
                self.frames_dropped += 1
            self._cur = _Frame(pkt.timestamp)
        f = self._cur
        if header.fragment_offset == 0:
            f.header = header
        f.parts.append((header.fragment_offset, frag))
        if pkt.marker:
            f.have_marker = True
        if not f.have_marker or f.header is None:
            return None
        f.parts.sort()
        scan = bytearray()
        for off, part in f.parts:
            if off != len(scan):
                self.frames_dropped += 1    # gap: fragment lost
                self._cur = None
                return None
            scan += part
        self._cur = None
        self.frames_out += 1
        return f.header, bytes(scan), f.timestamp
