"""x-RTP-Meta-Info packet format (DSS legacy, RTPMetaInfoLib parity).

Reference: ``RTPMetaInfoLib/RTPMetaInfoPacket.{h,cpp}`` — meta-info packets
are RTP packets whose payload is a TLV field list appended after the 12-byte
RTP header; the real media payload rides in the ``md`` field.  Two field
encodings exist on the wire:

* uncompressed: 2-byte ASCII field name (be) + 2-byte length (be) + data
* compressed:   1 byte ``0x80 | field_id`` + 1-byte length + data, where the
  id→field mapping was negotiated in the ``x-RTP-Meta-Info`` RTSP header
  (``ConstructFieldIDArrayFromHeader``, RTPMetaInfoPacket.cpp:72-113)

Fields (RTPMetaInfoPacket.h:44-56, length validators cpp:50-59):

====  =====================  =====
name  meaning                bytes
====  =====================  =====
pp    packet position        8
tt    transmit time (ms)     8
ft    frame type             2
pn    packet number          8
sq    original seq number    2
md    media payload          any
====  =====================  =====
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

#: field order matches the reference's FieldIndex enum
FIELDS = ("pp", "tt", "ft", "pn", "sq", "md")

#: required wire lengths; 0 = variable (RTPMetaInfoPacket.cpp:50-59)
FIELD_LENGTHS = {"pp": 8, "tt": 8, "ft": 2, "pn": 8, "sq": 2, "md": 0}

#: frame type field values (RTPMetaInfoPacket.h:84-90)
FRAME_UNKNOWN, FRAME_KEY, FRAME_B, FRAME_P = 0, 1, 2, 3

#: "no compressed id assigned; sent uncompressed" (kUncompressed)
UNCOMPRESSED = -1


def parse_header(value: str) -> dict[str, int]:
    """``x-RTP-Meta-Info`` RTSP header → {field: compressed_id}.

    Header grammar is ``name[=id];name[=id];...`` (e.g. ``tt;ft=1;sq=2;md=3``);
    a field without ``=id`` is sent uncompressed (UNCOMPRESSED sentinel).
    Unknown names are dropped, like the reference's kIllegalField filter."""
    out: dict[str, int] = {}
    for part in value.split(";"):
        part = part.strip()
        if len(part) < 2:
            continue
        name, _, idstr = part.partition("=")
        name = name.strip().lower()
        if name not in FIELDS:
            continue
        if idstr.strip():
            try:
                out[name] = int(idstr)
            except ValueError:
                continue
        else:
            out[name] = UNCOMPRESSED
    return out


def build_header(fields: dict[str, int]) -> str:
    """{field: compressed_id} → ``x-RTP-Meta-Info`` header value."""
    parts = []
    for name in FIELDS:                      # canonical field order
        if name not in fields:
            continue
        fid = fields[name]
        parts.append(name if fid == UNCOMPRESSED else f"{name}={fid}")
    return ";".join(parts)


@dataclass
class MetaInfo:
    """Parsed x-RTP-Meta-Info packet (RTPMetaInfoPacket member parity)."""

    packet_position: int | None = None       # pp
    transmit_time: int | None = None         # tt
    frame_type: int | None = None            # ft
    packet_number: int | None = None         # pn
    seq: int | None = None                   # sq
    media: bytes | None = None               # md
    media_offset: int = 0                    # offset of md data in the packet

    _BY_FIELD = {"pp": "packet_position", "tt": "transmit_time",
                 "ft": "frame_type", "pn": "packet_number", "sq": "seq"}


def parse_packet(data: bytes,
                 field_ids: dict[str, int] | None = None) -> MetaInfo | None:
    """Parse a meta-info packet (after its 12-byte RTP header).

    ``field_ids`` is the negotiated {field: id} map (compressed fields need
    it; pure-uncompressed packets don't).  Returns None on malformed input —
    the reference's false return (``ParsePacket``, cpp:116-222)."""
    if len(data) < 12:
        return None
    id_to_field = {}
    if field_ids:
        id_to_field = {fid: name for name, fid in field_ids.items()
                       if fid >= 0}
    info = MetaInfo()
    pos = 12
    end = len(data)
    while pos + 2 <= end:                     # a field header fits (even a
        first = data[pos]                     # trailing zero-length one)
        if first & 0x80:                      # compressed: id + 1-byte len
            name = id_to_field.get(first & 0x7F)
            flen = data[pos + 1]
            pos += 2
        else:                                 # uncompressed: name16 + len16
            if pos + 4 > end:
                break
            try:
                name = data[pos:pos + 2].decode("ascii").lower()
            except UnicodeDecodeError:
                name = None
            if name not in FIELDS:
                name = None
            flen = struct.unpack_from(">H", data, pos + 2)[0]
            pos += 4
        if name is not None:
            want = FIELD_LENGTHS[name]
            if want and flen != want:
                return None                   # wrong field length: corrupt
        if pos + flen > end:
            return None
        if name == "md":
            info.media = data[pos:pos + flen]
            info.media_offset = pos
        elif name is not None:
            val = int.from_bytes(data[pos:pos + flen], "big")
            setattr(info, MetaInfo._BY_FIELD[name], val)
        pos += flen
    return info


def build_packet(rtp_header: bytes, *, media: bytes,
                 field_ids: dict[str, int] | None = None,
                 packet_position: int | None = None,
                 transmit_time: int | None = None,
                 frame_type: int | None = None,
                 packet_number: int | None = None,
                 seq: int | None = None) -> bytes:
    """Construct a meta-info packet: RTP header + TLV fields (md last).

    Fields with a non-negative id in ``field_ids`` use the compressed
    encoding; everything else goes uncompressed."""
    if len(rtp_header) < 12:
        raise ValueError("need a full 12-byte RTP header")
    field_ids = field_ids or {}

    def tlv(name: str, payload: bytes) -> bytes:
        # md can never be compressed — its payload exceeds a 1-byte length
        # (reference asserts kUncompressed for kMediaDataField,
        # QTHintTrack.cpp:1363, and patches a 16-bit length at :1472)
        fid = UNCOMPRESSED if name == "md" else field_ids.get(name,
                                                              UNCOMPRESSED)
        if fid >= 0:
            if len(payload) > 0xFF:
                raise ValueError(f"{name}: compressed field too long")
            return bytes([0x80 | fid, len(payload)]) + payload
        return name.encode("ascii") + struct.pack(">H", len(payload)) + payload

    out = bytearray(rtp_header[:12])
    for name, val, size in (("pp", packet_position, 8),
                            ("tt", transmit_time, 8),
                            ("ft", frame_type, 2),
                            ("pn", packet_number, 8),
                            ("sq", seq, 2)):
        if val is not None:
            out += tlv(name, int(val).to_bytes(size, "big"))
    out += tlv("md", media)
    return bytes(out)


def strip_to_rtp(data: bytes,
                 field_ids: dict[str, int] | None = None) -> bytes | None:
    """Meta-info packet → plain RTP packet (header ∥ media payload).

    The reference's ``MakeRTPPacket`` (cpp:226-241) does this in place by
    sliding the header down to the media data; an immutable copy is the
    Python idiom for the same operation."""
    info = parse_packet(data, field_ids)
    if info is None or info.media is None:
        return None
    return data[:12] + info.media
