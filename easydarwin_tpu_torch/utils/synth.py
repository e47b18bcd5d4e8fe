"""Synthetic RTP traffic from an explicit ``numpy.random.Generator``.

``random_packet`` is the parse fuzz corpus: every H.264 NAL shape the
classifier resolves (single NAL, STAP-A/B, MTAP16/24, FU-A/B with and
without the start bit), 0-15 CSRCs, random marker bits, and one packet in
eight truncated to garbage.  ``h264_packet`` and ``paced_gop`` make the
well-formed paced stream a pusher sends.
"""

from __future__ import annotations

import numpy as np

from ..protocol import rtp

_AGG_OFFSET = {24: 3, 25: 5, 26: 8, 27: 9}


def _bytes(rng: np.random.Generator, n: int) -> bytes:
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _u32(rng: np.random.Generator) -> int:
    return int(rng.integers(0, 1 << 32, dtype=np.uint64))


def random_packet(rng: np.random.Generator) -> bytes:
    """One fuzzed RTP/H.264 packet (or a truncated one)."""
    kind = int(rng.integers(8))
    cc = int(rng.choice([0, 0, 0, 1, 2, 15]))
    csrcs = tuple(_u32(rng) for _ in range(cc))
    ntype = int(rng.choice([1, 5, 6, 7, 8, 9, 24, 25, 26, 27, 28, 29]))
    inner = int(rng.choice([1, 5, 7]))
    if ntype in (28, 29):
        start = 0x80 if rng.random() < 0.5 else 0
        payload = bytes(((3 << 5) | ntype, start | inner))
    elif ntype in _AGG_OFFSET:
        payload = (bytes(((3 << 5) | ntype,)) + _bytes(rng, _AGG_OFFSET[ntype] - 1)
                   + bytes(((3 << 5) | inner,)))
    else:
        payload = bytes(((3 << 5) | ntype,))
    payload += _bytes(rng, int(rng.integers(0, 40)))
    pkt = rtp.RtpPacket(
        payload_type=int(rng.choice([96, 97, 26, 33])),
        seq=int(rng.integers(0, 1 << 16)), timestamp=_u32(rng),
        ssrc=_u32(rng), marker=bool(rng.random() < 0.3),
        csrcs=csrcs, payload=payload).to_bytes()
    if kind == 0:                          # truncated garbage
        pkt = pkt[:int(rng.integers(4, max(5, len(pkt))))]
    return pkt


def stage(packets: list[bytes], width: int = 96):
    """[P, width] uint8 prefixes + [P] int32 lengths of ``packets``."""
    pre = np.zeros((len(packets), width), dtype=np.uint8)
    ln = np.zeros(len(packets), dtype=np.int32)
    for i, pkt in enumerate(packets):
        w = min(len(pkt), width)
        pre[i, :w] = np.frombuffer(pkt[:w], dtype=np.uint8)
        ln[i] = len(pkt)
    return pre, ln


def h264_packet(seq: int, ts: int, nal_type: int, *, ssrc: int,
                body: bytes, marker: bool = False) -> bytes:
    """A single-NAL H.264 RTP packet with payload ``nal header ∥ body``."""
    return rtp.RtpPacket(payload_type=96, seq=seq & 0xFFFF,
                         timestamp=ts & 0xFFFFFFFF, ssrc=ssrc, marker=marker,
                         payload=bytes(((3 << 5) | nal_type,)) + body
                         ).to_bytes()


def fu_a_packet(seq: int, ts: int, nal_type: int, *, ssrc: int,
                body: bytes, start: bool, end: bool) -> bytes:
    """One FU-A fragment (RFC 6184 §5.8) of a NAL of ``nal_type``; the
    marker is set on the last fragment."""
    fu = (0x80 if start else 0) | (0x40 if end else 0) | nal_type
    return rtp.RtpPacket(payload_type=96, seq=seq & 0xFFFF,
                         timestamp=ts & 0xFFFFFFFF, ssrc=ssrc, marker=end,
                         payload=bytes(((3 << 5) | 28, fu)) + body
                         ).to_bytes()


def paced_gop(rng: np.random.Generator, *, seq0: int, ts0: int, ssrc: int,
              frames: int, packets_per_frame: int, frame_ticks: int = 3000,
              body_len=(40, 400), fu_a: bool = False) -> list[bytes]:
    """One GOP of a paced stream: an IDR frame, then P frames; marker on
    each frame's last packet.  Each packet is a NAL of its own, or with
    ``fu_a`` each frame is one NAL in ``packets_per_frame`` FU-A
    fragments (so only a frame's first packet starts a frame).  Returns
    the packets in send order."""
    out = []
    seq, ts = seq0, ts0
    for f in range(frames):
        nal = 5 if f == 0 else 1
        for k in range(packets_per_frame):
            body = _bytes(rng, int(rng.integers(*body_len)))
            last = k == packets_per_frame - 1
            out.append(fu_a_packet(seq, ts, nal, ssrc=ssrc, body=body,
                                   start=k == 0, end=last) if fu_a else
                       h264_packet(seq, ts, nal, ssrc=ssrc, body=body,
                                   marker=last))
            seq += 1
        ts += frame_ticks
    return out


def aac_packet(rng: np.random.Generator, seq: int, ts: int, *, ssrc: int,
               size=(200, 400)) -> bytes:
    """One RFC 3640 AAC-hbr packet of ``size`` bytes in all: one AU
    header (13-bit size, 3-bit index) and a random access unit."""
    au = int(rng.integers(*size)) - 16
    return rtp.RtpPacket(payload_type=97, seq=seq & 0xFFFF,
                         timestamp=ts & 0xFFFFFFFF, ssrc=ssrc, marker=True,
                         payload=b"\x00\x10" + (au << 3).to_bytes(2, "big")
                         + _bytes(rng, au)).to_bytes()
