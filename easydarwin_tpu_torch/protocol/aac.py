"""AAC over RTP (RFC 3640 mpeg4-generic, AAC-hbr mode).

The relay forwards audio opaquely; the HLS muxer needs access-unit
boundaries and the AudioSpecificConfig to build an fMP4 ``mp4a`` track
(``hls/segmenter.py``), and the test pushers need the inverse
(``packetize_aac_hbr``).

AAC-hbr framing: 16-bit AU-headers-length (in BITS), then per-AU headers
of ``sizelength`` + ``indexlength``/``indexdeltalength`` bits, then the
AU payloads back to back.  One AU may instead span several packets
(fragmentation); interleaving (non-zero AU-index) is out of scope and
dropped.  A copy of the reference's ``protocol/aac.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

AAC_SAMPLES_PER_FRAME = 1024


def parse_fmtp(fmtp: str) -> dict[str, str]:
    """``"97 sizelength=13; indexlength=3; config=1190"`` → dict."""
    out: dict[str, str] = {}
    body = fmtp.split(" ", 1)[1] if " " in fmtp else fmtp
    for part in body.split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip().lower()] = v.strip()
    return out


@dataclass
class AacConfig:
    """What the muxer needs from the SDP's fmtp + rtpmap."""

    sample_rate: int = 48000
    channels: int = 2
    asc: bytes = b""                 # AudioSpecificConfig (config=HEX)
    sizelength: int = 13
    indexlength: int = 3
    indexdeltalength: int = 3

    @classmethod
    def from_sdp(cls, fmtp: str, clock_rate: int,
                 channels: int = 2) -> "AacConfig":
        p = parse_fmtp(fmtp)
        asc = b""
        if "config" in p:
            try:
                asc = bytes.fromhex(p["config"])
            except ValueError:
                asc = b""
        cfg = cls(sample_rate=clock_rate or 48000, channels=channels,
                  asc=asc,
                  sizelength=int(p.get("sizelength", 13) or 13),
                  indexlength=int(p.get("indexlength", 3) or 3),
                  indexdeltalength=int(p.get("indexdeltalength", 3) or 3))
        if asc and len(asc) >= 2:
            # trust the AudioSpecificConfig over the rtpmap when present
            freq_idx = ((asc[0] & 0x07) << 1) | (asc[1] >> 7)
            rates = (96000, 88200, 64000, 48000, 44100, 32000, 24000,
                     22050, 16000, 12000, 11025, 8000, 7350)
            if freq_idx < len(rates):
                cfg.sample_rate = rates[freq_idx]
            cfg.channels = (asc[1] >> 3) & 0x0F or channels
        return cfg

    def default_asc(self) -> bytes:
        """AAC-LC AudioSpecificConfig synthesized from rate/channels
        (used when the SDP carries no config=)."""
        rates = (96000, 88200, 64000, 48000, 44100, 32000, 24000,
                 22050, 16000, 12000, 11025, 8000, 7350)
        idx = rates.index(self.sample_rate) if self.sample_rate in rates \
            else 3
        v = (2 << 11) | (idx << 7) | ((self.channels & 0x0F) << 3)
        return bytes(((v >> 8) & 0xFF, v & 0xFF))


def packetize_aac_hbr(au: bytes, *, seq: int, timestamp: int, ssrc: int,
                      payload_type: int = 97, marker: bool = True,
                      cfg: AacConfig | None = None) -> bytes:
    """One AAC AU → one RTP packet (hbr, single AU — the common shape)."""
    import struct
    cfg = cfg or AacConfig()
    hdr_bits = cfg.sizelength + cfg.indexlength
    au_hdr = (len(au) << cfg.indexlength) & ((1 << hdr_bits) - 1)
    nbytes = (hdr_bits + 7) // 8
    payload = struct.pack(">H", hdr_bits) \
        + au_hdr.to_bytes(nbytes, "big") + au
    b1 = (0x80 if marker else 0) | (payload_type & 0x7F)
    return struct.pack("!BBHII", 0x80, b1, seq & 0xFFFF,
                       timestamp & 0xFFFFFFFF, ssrc) + payload


class AacDepacketizer:
    """RTP payloads → (au_bytes, rtp_timestamp) pairs.

    The RTP clock for mpeg4-generic IS the sample rate, so timestamps
    are already in sample units; AUs after the first in one packet
    advance by 1024 samples each (AAC frame length)."""

    def __init__(self, cfg: AacConfig | None = None):
        self.cfg = cfg or AacConfig()
        self._frag: bytearray | None = None
        self._frag_ts = 0
        self._frag_need = 0
        self._last_seq: int | None = None
        self.errors = 0

    def push(self, rtp_packet: bytes) -> list[tuple[bytes, int]]:
        if len(rtp_packet) < 12:
            self.errors += 1
            return []
        seq = int.from_bytes(rtp_packet[2:4], "big")
        if self._frag is not None and self._last_seq is not None \
                and seq != ((self._last_seq + 1) & 0xFFFF):
            # a lost fragment-tail must not swallow the next AU into the
            # stale fragment (corrupt audio at a stale timestamp)
            self._frag = None
            self.errors += 1
        self._last_seq = seq
        ts = int.from_bytes(rtp_packet[4:8], "big")
        marker = bool(rtp_packet[1] & 0x80)
        p = rtp_packet[12:]
        cfg = self.cfg
        if len(p) < 2:
            self.errors += 1
            return []
        hdr_bits_total = (p[0] << 8) | p[1]
        hdr_bits = cfg.sizelength + cfg.indexlength
        if hdr_bits <= 0 or hdr_bits_total < hdr_bits:
            # a zero/short AU-headers-length (or a malicious fmtp with
            # sizelength=0) would make us parse media bytes as a header
            # — and a garbage size can wedge the fragment state into
            # eating subsequent valid AUs
            self.errors += 1
            return []
        n_aus = hdr_bits_total // hdr_bits
        hdr_bytes = (hdr_bits_total + 7) // 8
        if len(p) < 2 + hdr_bytes:
            self.errors += 1
            return []
        sizes = []
        bitpos = 16
        raw = p
        for i in range(n_aus):
            size = 0
            for _ in range(cfg.sizelength):
                size = (size << 1) | ((raw[bitpos >> 3] >>
                                      (7 - (bitpos & 7))) & 1)
                bitpos += 1
            idx = 0
            il = cfg.indexlength if i == 0 else cfg.indexdeltalength
            for _ in range(il):
                idx = (idx << 1) | ((raw[bitpos >> 3] >>
                                    (7 - (bitpos & 7))) & 1)
                bitpos += 1
            if idx != 0:                 # interleaving: out of scope
                self.errors += 1
                return []
            sizes.append(size)
        data = p[2 + hdr_bytes:]
        out: list[tuple[bytes, int]] = []
        if self._frag is not None:
            # continuation of a fragmented AU: hbr repeats the AU header
            take = min(len(data), self._frag_need - len(self._frag))
            self._frag += data[:take]
            if len(self._frag) >= self._frag_need and marker:
                out.append((bytes(self._frag), self._frag_ts))
                self._frag = None
            elif len(self._frag) >= self._frag_need:
                self._frag = None        # desync: drop silently
                self.errors += 1
            return out
        if n_aus == 1 and sizes[0] > len(data):
            # fragmented AU: accumulate until the marker closes it
            self._frag = bytearray(data)
            self._frag_ts = ts
            self._frag_need = sizes[0]
            return []
        off = 0
        for i, size in enumerate(sizes):
            if off + size > len(data):
                self.errors += 1
                break
            out.append((data[off:off + size],
                        (ts + i * AAC_SAMPLES_PER_FRAME) & 0xFFFFFFFF))
            off += size
        return out
