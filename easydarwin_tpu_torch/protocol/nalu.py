"""H.264 RTP payload classification (RFC 6184) — the keyframe index oracle.

* ``is_keyframe_first_packet``: the (possibly aggregated/fragmented)
  leading NAL unit is IDR(5), SPS(7) or PPS(8); header size ``12 + 4*CC``,
  packet ≥ 20 bytes, FU-A/B only with the start bit set.
* ``is_frame_first_packet``: any leading single/aggregation NAL, or a FU
  fragment with the start bit.
* ``is_frame_last_packet``: the RTP marker bit.

The vectorized equivalent is ``ops.parse.parse_packets`` and, on the card,
the ``parse_row`` device function of ``csrc/relay_kernels.cu``.

``packetize_h264`` is the RFC 6184 packetizer (single NAL or FU-A) the VOD
tier's file packetizer (``vod.packetizer``) runs per NAL unit.
"""

from __future__ import annotations

from . import rtp

NAL_IDR = 5
NAL_SPS = 7
NAL_PPS = 8
NAL_STAP_A = 24
NAL_STAP_B = 25
NAL_MTAP16 = 26
NAL_MTAP24 = 27
NAL_FU_A = 28
NAL_FU_B = 29

#: minimum packet length the reflector requires before classifying
_MIN_CLASSIFY_LEN = 20

#: offset (past the RTP header) of the first aggregated NAL header byte
_AGG_INNER_OFFSET = {NAL_STAP_A: 3, NAL_STAP_B: 5, NAL_MTAP16: 8, NAL_MTAP24: 9}

KEYFRAME_NAL_TYPES = frozenset({NAL_IDR, NAL_SPS, NAL_PPS})


def effective_nal_type(packet: bytes) -> int | None:
    """The NAL type the classifier ends up testing, or None.

    Aggregation packets resolve to their first contained NAL; FU-A/B to the
    fragmented NAL only when the start bit is set (a non-start fragment
    keeps type 28/29, which is never a keyframe type)."""
    if len(packet) < _MIN_CLASSIFY_LEN:
        return None
    hs = rtp.header_size_cc_only(packet)
    if len(packet) <= hs:
        return None
    t = packet[hs] & 0x1F
    if t in _AGG_INNER_OFFSET:
        off = _AGG_INNER_OFFSET[t]
        if len(packet) > hs + off:
            t = packet[hs + off] & 0x1F
    elif t in (NAL_FU_A, NAL_FU_B):
        if len(packet) > hs + 1 and packet[hs + 1] & 0x80:
            t = packet[hs + 1] & 0x1F
    return t


def is_keyframe_first_packet(packet: bytes) -> bool:
    """True iff this RTP packet starts an H.264 keyframe (IDR/SPS/PPS)."""
    return effective_nal_type(packet) in KEYFRAME_NAL_TYPES


def is_frame_first_packet(packet: bytes) -> bool:
    """True iff this packet begins a (any) frame."""
    if len(packet) < _MIN_CLASSIFY_LEN:
        return False
    hs = rtp.header_size_cc_only(packet)
    if len(packet) <= hs:
        return False
    t = packet[hs] & 0x1F
    if 1 <= t <= 27:  # single NAL or aggregation packet
        return True
    if t in (NAL_FU_A, NAL_FU_B):
        return len(packet) > hs + 1 and bool(packet[hs + 1] & 0x80)
    return False


def is_frame_last_packet(packet: bytes) -> bool:
    """True iff the RTP marker bit is set (and the packet is ≥ 20 bytes)."""
    return len(packet) >= _MIN_CLASSIFY_LEN and bool(packet[1] & 0x80)


def packetize_h264(nal: bytes, *, seq: int, timestamp: int, ssrc: int,
                   payload_type: int = 96, mtu: int = 1400,
                   marker_on_last: bool = True) -> list[bytes]:
    """Packetize one NAL unit into RTP packets: one single-NAL packet when
    it fits ``mtu``, else FU-A fragments of ``mtu - 2`` payload bytes."""
    if len(nal) <= mtu:
        return [rtp.RtpPacket(
            payload_type=payload_type, seq=seq, timestamp=timestamp,
            ssrc=ssrc, marker=marker_on_last, payload=nal).to_bytes()]
    pkts: list[bytes] = []
    fu_indicator = (nal[0] & 0x60) | NAL_FU_A
    ntype = nal[0] & 0x1F
    body = memoryview(nal)[1:]
    step = mtu - 2
    for off in range(0, len(body), step):
        last = off + step >= len(body)
        fu_header = ntype | (0x80 if off == 0 else 0) | (0x40 if last else 0)
        pkts.append(rtp.RtpPacket(
            payload_type=payload_type, seq=seq, timestamp=timestamp,
            ssrc=ssrc, marker=marker_on_last and last,
            payload=bytes((fu_indicator, fu_header))
            + bytes(body[off:off + step])).to_bytes())
        seq = (seq + 1) & 0xFFFF
    return pkts
