"""Batched RTP parse + H.264/MJPEG classification — the plain PyTorch version.

Fixed-shape, branch-free equivalent of the scalar oracle in
``protocol.rtp`` / ``protocol.nalu``, over a whole packet window at once.
It is the plain version of kernel K1 (``ops.parse_kernel``) and of the
parse fused into ``ed_relay_window``.

Inputs are ``[P, W]`` uint8 byte *prefixes* plus ``[P]`` total lengths; W
must be ≥ ``PARSE_PREFIX`` (96): the deepest legal peek is CC=15 CSRCs +
the MTAP24 inner-NAL offset = byte 81, and ``_byte_at`` clamps
out-of-range columns, so a narrower buffer would classify from the wrong
byte instead of failing.  Arithmetic runs in int64 (torch has no uint32
add/shift on the CPU); results leave with the reference's dtypes: ``seq``
int32, ``timestamp``/``ssrc`` uint32, ``payload_start``/``nal_type``
int32, the flags bool.
"""

from __future__ import annotations

import torch

#: bytes of each packet staged to the device for parsing: 12 (fixed
#: header) + 60 (max CSRC) + 10 (deepest aggregation peek, MTAP24 offset 9)
#: → 96 covers the worst legal case with headroom.
PARSE_PREFIX = 96

_KEYFRAME_TYPES = (5, 7, 8)
#: aggregation-type → inner-NAL peek offset
_AGG_OFFSETS = ((24, 3), (25, 5), (26, 8), (27, 9))
_MIN_CLASSIFY_LEN = 20

#: the nine fields every parse returns, in a fixed order
FIELDS = ("seq", "timestamp", "ssrc", "marker", "payload_start", "nal_type",
          "keyframe_first", "frame_first", "frame_last")


def normalize_codec(codec: str) -> str:
    """Map SDP / user codec spellings onto the two classifier families.

    "H264"/"AVC" → "h264"; "JPEG"/"MJPEG" (RFC 2435) → "mjpeg".  Unknown
    names raise — falling through to the NALU walk would mis-classify every
    packet of a non-H.264 stream."""
    c = codec.strip().lower()
    if c in ("h264", "avc", "avc1", ""):
        return "h264"
    if c in ("mjpeg", "jpeg", "mjpg"):
        return "mjpeg"
    raise ValueError(f"unsupported video codec for device classify: {codec!r}")


def u32_from_i64(v: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2³² → uint32 with the same bits.  Goes
    through int32 and a bit view, so no uint32 arithmetic or conversion
    kernel is needed on either device."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(
        torch.int32).view(torch.uint32)


def i64_from_u32(v: torch.Tensor) -> torch.Tensor:
    """uint32 → int64 in [0, 2³²) (other integer dtypes are widened)."""
    if v.dtype == torch.uint32:
        return v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return v.to(torch.int64)


def check_prefix(prefix: torch.Tensor) -> None:
    if prefix.dim() != 2 or prefix.shape[1] < PARSE_PREFIX:
        raise ValueError(f"prefix must be [P, W>={PARSE_PREFIX}], got "
                         f"{tuple(prefix.shape)}")


def _byte_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: [P, W] int64, idx: [P] → x[p, idx[p]] with clamping."""
    idx = idx.clamp(0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _fixed_header_fields(x: torch.Tensor):
    """(cc, hs, seq, ts, ssrc, marker) in int64 — the one place that knows
    the wire byte offsets."""
    cc = x[:, 0] & 0x0F
    hs = 12 + 4 * cc
    seq = (x[:, 2] << 8) | x[:, 3]
    ts = (x[:, 4] << 24) | (x[:, 5] << 16) | (x[:, 6] << 8) | x[:, 7]
    ssrc = (x[:, 8] << 24) | (x[:, 9] << 16) | (x[:, 10] << 8) | x[:, 11]
    marker = (x[:, 1] & 0x80) != 0
    return cc, hs, seq, ts, ssrc, marker


def _fields(seq, ts, ssrc, marker, hs, eff, kf, ff, fl) -> dict:
    return {
        "seq": seq.to(torch.int32),
        "timestamp": u32_from_i64(ts),
        "ssrc": u32_from_i64(ssrc),
        "marker": marker,
        "payload_start": hs.to(torch.int32),
        "nal_type": eff.to(torch.int32),
        "keyframe_first": kf,
        "frame_first": ff,
        "frame_last": fl,
    }


def parse_packets(prefix: torch.Tensor, length: torch.Tensor,
                  is_video: bool = True, codec: str = "h264"
                  ) -> dict[str, torch.Tensor]:
    """Parse a ``[P, W]`` uint8 prefix batch into nine ``[P]`` fields:
    ``seq``, ``timestamp``, ``ssrc``, ``marker``, ``payload_start``
    (12+4·CC, extension-blind), ``nal_type`` (effective type after the
    aggregation/FU resolution, −1 when not classifiable),
    ``keyframe_first``, ``frame_first``, ``frame_last``.

    ``codec`` selects the classifier: "h264" walks NALU types; "mjpeg"
    (RFC 2435) marks fragment-offset-0 packets keyframe-first."""
    check_prefix(prefix)
    if normalize_codec(codec) == "mjpeg":
        return _parse_packets_mjpeg(prefix, length, is_video)
    x = prefix.to(torch.int64)
    length = length.to(torch.int64)
    _cc, hs, seq, ts, ssrc, marker = _fixed_header_fields(x)

    classifiable = (length >= _MIN_CLASSIFY_LEN) & (length > hs)
    nal0 = _byte_at(x, hs) & 0x1F

    eff = nal0
    for agg_type, off in _AGG_OFFSETS:
        inner = _byte_at(x, hs + off) & 0x1F
        eff = torch.where((nal0 == agg_type) & (length > hs + off), inner, eff)
    fu_hdr = _byte_at(x, hs + 1)
    is_fu = (nal0 == 28) | (nal0 == 29)
    fu_start = is_fu & (length > hs + 1) & ((fu_hdr & 0x80) != 0)
    eff = torch.where(fu_start, fu_hdr & 0x1F, eff)
    eff = torch.where(classifiable, eff, torch.full_like(eff, -1))

    kf = torch.zeros_like(classifiable)
    for t in _KEYFRAME_TYPES:
        kf |= eff == t
    if not is_video:
        kf = torch.zeros_like(kf)

    frame_first = classifiable & (((nal0 >= 1) & (nal0 <= 27)) | fu_start)
    frame_last = (length >= _MIN_CLASSIFY_LEN) & marker
    return _fields(seq, ts, ssrc, marker, hs, eff, kf & classifiable,
                   frame_first, frame_last)


def _parse_packets_mjpeg(prefix: torch.Tensor, length: torch.Tensor,
                         is_video: bool) -> dict[str, torch.Tensor]:
    """RFC 2435 classification: frame start ⇔ 24-bit fragment offset 0.

    The offset lives at payload bytes 1-3; every frame start is a keyframe
    because JPEG frames are independently decodable.  No kernel computes
    this: on the card it stays these torch ops."""
    x = prefix.to(torch.int64)
    length = length.to(torch.int64)
    _cc, hs, seq, ts, ssrc, marker = _fixed_header_fields(x)
    classifiable = length >= hs + 8           # full RFC 2435 main header
    frag_off = ((_byte_at(x, hs + 1) << 16) | (_byte_at(x, hs + 2) << 8)
                | _byte_at(x, hs + 3))
    frame_first = classifiable & (frag_off == 0)
    kf = frame_first if is_video else torch.zeros_like(frame_first)
    return _fields(seq, ts, ssrc, marker, hs, torch.full_like(seq, -1), kf,
                   frame_first, classifiable & marker)
