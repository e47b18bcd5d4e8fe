"""RFC 2435 (JPEG over RTP) frame-start classification — the one predicate
the packet ring's ingest classifier needs for MJPEG streams."""

from __future__ import annotations

from . import rtp


def is_frame_first_packet(packet: bytes) -> bool:
    """Fragment offset 0 ⇒ start of a JPEG frame ⇒ (M)JPEG "keyframe".

    Mirrored on the device by ``ops.parse.parse_packets(codec="mjpeg")``."""
    if len(packet) < 12:
        return False
    hs = rtp.header_size_cc_only(packet)
    payload = packet[hs:]
    return len(payload) >= 8 and payload[1:4] == b"\x00\x00\x00"
