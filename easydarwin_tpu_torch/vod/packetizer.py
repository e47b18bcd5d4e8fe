"""Sample → RTP packetization + SDP generation for VOD.

Reference parity: ``QTFileLib``'s hint-track packetizer (``QTHintTrack.cpp``
— hint samples carried packetization instructions) and the SDP the
reference's ``DoDescribe`` emits (``QTSSFileModule.cpp:606``).  Modern files
are rarely hinted, so the primary path self-packetizes: H.264 AVCC →
RFC 6184 (single NAL / FU-A, SPS/PPS re-injected before each IDR), AAC →
RFC 3640 mpeg4-generic.  Pre-hinted files use ``HintInterpreter``, which
executes the 'rtp ' constructor programs like ``QTHintTrack``.
"""

from __future__ import annotations

import base64
import struct
from dataclasses import dataclass

from ..protocol import nalu, rtp, sdp
from .mp4 import Mp4File, Track

RTP_CLOCK_VIDEO = 90000


def split_avcc(sample: bytes, nal_length_size: int = 4) -> list[bytes]:
    """Split an AVCC sample (length-prefixed) into NAL units."""
    out = []
    pos = 0
    n = len(sample)
    while pos + nal_length_size <= n:
        ln = int.from_bytes(sample[pos:pos + nal_length_size], "big")
        pos += nal_length_size
        if ln <= 0 or pos + ln > n:
            break
        out.append(sample[pos:pos + ln])
        pos += ln
    return out


@dataclass
class PacketizerState:
    seq: int = 1
    ssrc: int = 0
    payload_type: int = 96


class H264Packetizer:
    """One client's H.264 track packetizer (RFC 6184, mode 1)."""

    def __init__(self, track: Track, *, ssrc: int, seq_start: int = 1,
                 payload_type: int = 96, mtu: int = 1400):
        self.track = track
        self.state = PacketizerState(seq=seq_start, ssrc=ssrc,
                                     payload_type=payload_type)
        self.mtu = mtu

    def rtp_timestamp(self, i: int) -> int:
        info = self.track.info
        t = int(self.track.dts[i]) + int(self.track.ctts[i])
        return int(t * RTP_CLOCK_VIDEO // max(info.timescale, 1)) & 0xFFFFFFFF

    def packetize_sample(self, data: bytes, i: int) -> list[bytes]:
        info = self.track.info
        ts = self.rtp_timestamp(i)
        nals = split_avcc(data, info.nal_length_size)
        if bool(self.track.sync[i]):
            nals = list(info.sps) + list(info.pps) + nals
        pkts: list[bytes] = []
        for k, nal in enumerate(nals):
            last_nal = k == len(nals) - 1
            sub = nalu.packetize_h264(
                nal, seq=self.state.seq, timestamp=ts,
                ssrc=self.state.ssrc, payload_type=self.state.payload_type,
                mtu=self.mtu, marker_on_last=last_nal)
            self.state.seq = (self.state.seq + len(sub)) & 0xFFFF
            pkts.extend(sub)
        return pkts


class AacPacketizer:
    """RFC 3640 mpeg4-generic: one AU per packet, 13/3-bit AU header."""

    def __init__(self, track: Track, *, ssrc: int, seq_start: int = 1,
                 payload_type: int = 97):
        self.track = track
        self.state = PacketizerState(seq=seq_start, ssrc=ssrc,
                                     payload_type=payload_type)

    def rtp_timestamp(self, i: int) -> int:
        return int(self.track.dts[i]) & 0xFFFFFFFF   # clock == sample rate

    def packetize_sample(self, data: bytes, i: int) -> list[bytes]:
        au_header = struct.pack(">HH", 16, (len(data) << 3) & 0xFFFF)
        pkt = rtp.RtpPacket(
            payload_type=self.state.payload_type, seq=self.state.seq,
            timestamp=self.rtp_timestamp(i), ssrc=self.state.ssrc,
            marker=True, payload=au_header + data).to_bytes()
        self.state.seq = (self.state.seq + 1) & 0xFFFF
        return [pkt]


class HintInterpreter:
    """Executes hint-sample constructor programs ('rtp ' tracks).

    Hint sample layout (QTHintTrack's input): u16 packet count, u16
    reserved, then per packet: i32 relative-time, u16 rtp-header-bits,
    u16 seq, u16 flags, u16 constructor count, then 16-byte constructors:
    type 0 noop / 1 immediate / 2 sample-range / 3 sample-description.
    """

    def __init__(self, file: Mp4File, hint_track: Track, media_track: Track,
                 *, ssrc: int, payload_type: int = 96):
        self.file = file
        self.hint = hint_track
        self.media = media_track
        self.ssrc = ssrc
        self.payload_type = payload_type

    def packetize_sample(self, i: int) -> list[bytes]:
        data = self.file.read_sample(self.hint, i)
        if len(data) < 4:
            return []
        n_pkts = struct.unpack_from(">H", data, 0)[0]
        pos = 4
        out = []
        for _ in range(n_pkts):
            if pos + 12 > len(data):
                break
            _rel, hdr_bits, seq, _flags, n_cons = struct.unpack_from(
                ">iHHHH", data, pos)
            pos += 12
            payload = bytearray()
            for _c in range(n_cons):
                if pos + 16 > len(data):
                    break
                ctype = data[pos]
                if ctype == 1:      # immediate
                    ln = data[pos + 1]
                    payload += data[pos + 2:pos + 2 + min(ln, 14)]
                elif ctype == 2:    # sample range from the media track
                    _tref = data[pos + 1]
                    ln, samplenum, off = struct.unpack_from(">HII", data,
                                                            pos + 2)
                    if 1 <= samplenum <= self.media.n_samples:
                        sample = self.file.read_sample(self.media,
                                                       samplenum - 1)
                        payload += sample[off:off + ln]
                pos += 16
            ts_scale = self.hint.info.rtp_timescale or RTP_CLOCK_VIDEO
            ts = int(int(self.hint.dts[i]) * ts_scale
                     // max(self.hint.info.timescale, 1))
            out.append(rtp.RtpPacket(
                payload_type=self.payload_type, seq=seq,
                timestamp=ts & 0xFFFFFFFF, ssrc=self.ssrc,
                marker=bool(hdr_bits & 0x0080),
                payload=bytes(payload)).to_bytes())
        return out


def sdp_for_file(f: Mp4File, *, name: str = "") -> sdp.SessionDescription:
    """Build the DESCRIBE answer for a file (QTSSFileModule::DoDescribe)."""
    sd = sdp.SessionDescription(session_name=name or "vod")
    track_no = 0
    v = f.video_track()
    if v is not None and v.info.codec == "avc1":
        track_no += 1
        info = sdp.StreamInfo(media_type="video", payload_type=96,
                              payload_name="H264/90000", codec="H264",
                              clock_rate=RTP_CLOCK_VIDEO, track_id=track_no)
        fmtp = "96 packetization-mode=1"
        if v.info.sps:
            plid = v.info.sps[0][1:4].hex().upper() if len(v.info.sps[0]) >= 4 \
                else "42001F"
            props = ",".join(base64.b64encode(x).decode()
                             for x in (v.info.sps + v.info.pps))
            fmtp += f";profile-level-id={plid};sprop-parameter-sets={props}"
        info.fmtp = fmtp
        sd.streams.append(info)
    a = f.audio_track()
    if a is not None and a.info.codec == "mp4a":
        track_no += 1
        rate = a.info.sample_rate or a.info.timescale
        ch = a.info.channels or 2
        info = sdp.StreamInfo(media_type="audio", payload_type=97,
                              payload_name=f"MPEG4-GENERIC/{rate}/{ch}",
                              codec="MPEG4-GENERIC", clock_rate=rate,
                              track_id=track_no)
        cfg = a.info.audio_config.hex().upper() or "1190"
        info.fmtp = (f"97 streamtype=5;profile-level-id=1;mode=AAC-hbr;"
                     f"sizelength=13;indexlength=3;indexdeltalength=3;"
                     f"config={cfg}")
        sd.streams.append(info)
    rng = max((t.duration_sec() for t in f.tracks), default=0.0)
    if rng:
        sd.attributes["range"] = f"npt=0-{rng:.3f}"
    return sd
