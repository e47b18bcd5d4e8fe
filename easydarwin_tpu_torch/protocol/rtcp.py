"""RTCP parse/build (RFC 3550 §6): SR, RR, SDES, BYE, APP, the 3GPP NADU
APP packet and the RFC 4585 generic NACK.

A copy of the reference's ``protocol/rtcp.py`` (``RTCPUtilitiesLib``
parity: RR parse, SR+SDES+BYE generation, the "qtak" APP ack, NADU) with
the relay's SR rewrite (``RTPSessionOutput.cpp:403-460``), which patches
the SSRC of relayed compounds so each receiver sees its own output's
source.  The relay acts on RR and NADU; NACK and APP are parsed so the
server can count them.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

SR, RR, SDES, BYE, APP = 200, 201, 202, 203, 204
#: RFC 4585 transport-layer feedback (RTPFB); the count bits carry FMT
RTPFB = 205
FMT_GENERIC_NACK = 1

NTP_EPOCH_DELTA = 2208988800  # seconds between 1900 (NTP) and 1970 (Unix)


class RtcpError(ValueError):
    pass


@dataclass
class ReportBlock:
    ssrc: int
    fraction_lost: int
    cumulative_lost: int
    highest_seq: int
    jitter: int
    lsr: int
    dlsr: int

    def to_bytes(self) -> bytes:
        # RFC 3550 §6.4.1: cumulative_lost is a SIGNED 24-bit quantity —
        # duplicate packets make received > expected, driving it
        # negative, and it must round-trip as such.  Clamp to the signed
        # range (the RFC's own rule) rather than letting a wild value
        # alias into another report's fraction byte.
        lost = max(-0x800000, min(self.cumulative_lost, 0x7FFFFF)) \
            & 0xFFFFFF
        return struct.pack("!IIIIII", self.ssrc,
                           ((self.fraction_lost & 0xFF) << 24) | lost,
                           self.highest_seq, self.jitter, self.lsr, self.dlsr)

    @classmethod
    def parse(cls, data: bytes, off: int) -> "ReportBlock":
        ssrc, frac_lost, hseq, jit, lsr, dlsr = struct.unpack_from(
            "!IIIIII", data, off)
        # sign-extend the 24-bit field: an unsigned read would report a
        # duplicate-heavy receiver (-1 on the wire) as ~16.7M lost and
        # poison every loss-driven controller downstream
        cum = frac_lost & 0xFFFFFF
        if cum >= 0x800000:
            cum -= 0x1000000
        return cls(ssrc, frac_lost >> 24, cum, hseq, jit, lsr, dlsr)


@dataclass
class SenderReport:
    ssrc: int
    ntp_ts: int          # 64-bit NTP timestamp
    rtp_ts: int
    packet_count: int
    octet_count: int
    reports: list[ReportBlock] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        body = struct.pack("!IQIII", self.ssrc, self.ntp_ts & (2**64 - 1),
                           self.rtp_ts & 0xFFFFFFFF, self.packet_count,
                           self.octet_count)
        for rb in self.reports:
            body += rb.to_bytes()
        return _hdr(SR, len(self.reports), len(body)) + body


@dataclass
class ReceiverReport:
    ssrc: int
    reports: list[ReportBlock] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        body = struct.pack("!I", self.ssrc)
        for rb in self.reports:
            body += rb.to_bytes()
        return _hdr(RR, len(self.reports), len(body)) + body


@dataclass
class SdesChunk:
    ssrc: int
    cname: str = ""

    def to_bytes(self) -> bytes:
        name = self.cname.encode()
        body = (struct.pack("!I", self.ssrc) + bytes((1, len(name))) + name
                + b"\x00")
        pad = (-len(body)) % 4
        return body + b"\x00" * pad


@dataclass
class Sdes:
    chunks: list[SdesChunk] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        body = b"".join(c.to_bytes() for c in self.chunks)
        return _hdr(SDES, len(self.chunks), len(body)) + body


@dataclass
class Bye:
    ssrcs: list[int] = field(default_factory=list)
    reason: str = ""

    def to_bytes(self) -> bytes:
        body = b"".join(struct.pack("!I", s) for s in self.ssrcs)
        if self.reason:
            r = self.reason.encode()
            body += bytes((len(r),)) + r
            body += b"\x00" * ((-len(body)) % 4)
        return _hdr(BYE, len(self.ssrcs), len(body)) + body


@dataclass
class App:
    ssrc: int
    name: str            # 4 chars, e.g. "qtak" (ack), "qtsn"/"PSS0" (NADU)
    subtype: int = 0
    data: bytes = b""

    def to_bytes(self) -> bytes:
        body = (struct.pack("!I", self.ssrc)
                + self.name.encode()[:4].ljust(4) + self.data)
        return _hdr(APP, self.subtype, len(body)) + body


@dataclass
class NaduBlock:
    """One per-source block of a 3GPP TS 26.234 NADU APP packet
    (``RTCPAPPNADUPacket.cpp``): receiver buffer feedback driving the
    reference's rate adaptation alongside thinning."""

    ssrc: int
    playout_delay_ms: int = 0xFFFF    # 0xFFFF = not known
    nsn: int = 0                      # next RTP seq to decode
    nun: int = 0                      # next ADU to decode (5 bits)
    free_buffer_64b: int = 0          # free buffer space, 64-byte units

    def to_bytes(self) -> bytes:
        return struct.pack("!IHHBBH", self.ssrc,
                           self.playout_delay_ms & 0xFFFF, self.nsn & 0xFFFF,
                           0, self.nun & 0x1F, self.free_buffer_64b & 0xFFFF)

    @classmethod
    def parse(cls, body: bytes, off: int) -> "NaduBlock":
        ssrc, delay, nsn, _rsvd, nun, fbs = struct.unpack_from(
            "!IHHBBH", body, off)
        return cls(ssrc, delay, nsn, nun & 0x1F, fbs)


@dataclass
class Nadu:
    """NADU APP packet: name "PSS0", one 12-byte block per observed SSRC."""

    ssrc: int                         # sender of the feedback
    blocks: list[NaduBlock] = field(default_factory=list)

    NAME = "PSS0"

    def to_bytes(self) -> bytes:
        return App(self.ssrc, self.NAME, subtype=0,
                   data=b"".join(b.to_bytes() for b in self.blocks)).to_bytes()

    @classmethod
    def from_app(cls, app: "App") -> "Nadu | None":
        if app.name != cls.NAME or len(app.data) % 12:
            return None
        return cls(app.ssrc, [NaduBlock.parse(app.data, i)
                              for i in range(0, len(app.data), 12)])


@dataclass
class GenericNack:
    """RFC 4585 §6.2.1 transport-layer generic NACK: the receiver's
    list of lost MEDIA seqs, each FCI a (PID, BLP) pair — PID the first
    lost seq, BLP a bitmask of the 16 following seqs also lost."""

    sender_ssrc: int
    media_ssrc: int
    pairs: list[tuple[int, int]] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        body = struct.pack("!II", self.sender_ssrc & 0xFFFFFFFF,
                           self.media_ssrc & 0xFFFFFFFF)
        for pid, blp in self.pairs:
            body += struct.pack("!HH", pid & 0xFFFF, blp & 0xFFFF)
        return _hdr(RTPFB, FMT_GENERIC_NACK, len(body)) + body

    def lost_seqs(self) -> list[int]:
        out: list[int] = []
        for pid, blp in self.pairs:
            out.append(pid & 0xFFFF)
            for bit in range(16):
                if blp & (1 << bit):
                    out.append((pid + 1 + bit) & 0xFFFF)
        return out

    @classmethod
    def from_seqs(cls, sender_ssrc: int, media_ssrc: int,
                  seqs) -> "GenericNack":
        """Pack lost seqs into minimal (PID, BLP) FCI pairs."""
        pairs: list[tuple[int, int]] = []
        for s in sorted({s & 0xFFFF for s in seqs}):
            if pairs:
                pid, blp = pairs[-1]
                d = (s - pid) & 0xFFFF
                if 1 <= d <= 16:
                    pairs[-1] = (pid, blp | (1 << (d - 1)))
                    continue
            pairs.append((s, 0))
        return cls(sender_ssrc, media_ssrc, pairs)


def _hdr(ptype: int, count: int, body_len: int) -> bytes:
    if body_len % 4:
        raise RtcpError("RTCP body must be 32-bit aligned")
    return struct.pack("!BBH", 0x80 | (count & 0x1F), ptype, body_len // 4)


def parse_compound(data: bytes) -> list[object]:
    """Parse a compound RTCP datagram into typed packets (an unknown type
    becomes a raw ``App``)."""
    out: list[object] = []
    off = 0
    while off + 4 <= len(data):
        b0, ptype, words = struct.unpack_from("!BBH", data, off)
        if b0 >> 6 != 2:
            raise RtcpError(f"bad RTCP version at offset {off}")
        count = b0 & 0x1F
        end = off + 4 + words * 4
        if end > len(data):
            raise RtcpError("truncated RTCP packet")
        body = data[off + 4:end]
        if ptype == SR and len(body) >= 24:
            ssrc, ntp, rtp_ts, pc, oc = struct.unpack_from("!IQIII", body)
            sr = SenderReport(ssrc, ntp, rtp_ts, pc, oc)
            sr.reports = [ReportBlock.parse(body, 24 + i * 24)
                          for i in range(count)
                          if 24 + (i + 1) * 24 <= len(body)]
            out.append(sr)
        elif ptype == RR and len(body) >= 4:
            ssrc = struct.unpack_from("!I", body)[0]
            rr = ReceiverReport(ssrc)
            rr.reports = [ReportBlock.parse(body, 4 + i * 24)
                          for i in range(count)
                          if 4 + (i + 1) * 24 <= len(body)]
            out.append(rr)
        elif ptype == BYE:
            ssrcs = [struct.unpack_from("!I", body, i * 4)[0]
                     for i in range(count) if (i + 1) * 4 <= len(body)]
            bye = Bye(ssrcs)
            roff = count * 4
            if roff < len(body):
                rlen = body[roff]
                bye.reason = body[roff + 1:roff + 1 + rlen].decode(
                    "utf-8", "replace")
            out.append(bye)
        elif ptype == RTPFB and count == FMT_GENERIC_NACK \
                and len(body) >= 8 and (len(body) - 8) % 4 == 0:
            sender, media = struct.unpack_from("!II", body)
            nack = GenericNack(sender, media)
            nack.pairs = [struct.unpack_from("!HH", body, 8 + i * 4)
                          for i in range((len(body) - 8) // 4)]
            out.append(nack)
        elif ptype == APP and len(body) >= 8:
            ssrc = struct.unpack_from("!I", body)[0]
            app = App(ssrc, body[4:8].decode("ascii", "replace"),
                      subtype=count, data=body[8:])
            out.append(Nadu.from_app(app) or app)
        elif ptype == SDES:
            sd = Sdes()
            coff = 0
            for _ in range(count):
                if coff + 4 > len(body):
                    break
                ssrc = struct.unpack_from("!I", body, coff)[0]
                coff += 4
                cname = ""
                while coff < len(body) and body[coff] != 0:
                    item = body[coff]
                    ilen = body[coff + 1] if coff + 1 < len(body) else 0
                    val = body[coff + 2:coff + 2 + ilen]
                    if item == 1:
                        cname = val.decode("utf-8", "replace")
                    coff += 2 + ilen
                coff += 1                      # the terminating null
                coff += (-coff) % 4            # chunk padding
                sd.chunks.append(SdesChunk(ssrc, cname))
            out.append(sd)
        else:
            out.append(App(0, "????", subtype=count, data=body))
        off = end
    return out


def ntp_now(unix_time: float) -> int:
    """Unix seconds (float) → 64-bit NTP timestamp."""
    sec = int(unix_time) + NTP_EPOCH_DELTA
    frac = int((unix_time % 1.0) * (1 << 32)) & 0xFFFFFFFF
    return (sec << 32) | frac


def ntp_middle32(ntp_ts: int) -> int:
    """The LSR field: middle 32 bits of a 64-bit NTP timestamp."""
    return (ntp_ts >> 16) & 0xFFFFFFFF


def build_server_compound(ssrc: int, cname: str, *, unix_time: float,
                          rtp_ts: int, packet_count: int,
                          octet_count: int, bye: bool = False) -> bytes:
    """SR + SDES(CNAME) [+ BYE]: what ``RTCPSRPacket`` emits each RR interval
    (``RTPStream.cpp:1300`` SR generation, 5 s cadence)."""
    out = SenderReport(ssrc, ntp_now(unix_time), rtp_ts, packet_count,
                       octet_count).to_bytes()
    out += Sdes([SdesChunk(ssrc, cname)]).to_bytes()
    if bye:
        out += Bye([ssrc]).to_bytes()
    return out


def _walk_compound(data):
    """Yield ``(offset, ptype, words)`` for each top-level packet of a
    compound — the one header walk all the rewrite helpers share."""
    off = 0
    while off + 8 <= len(data):
        b0, ptype, words = struct.unpack_from("!BBH", data, off)
        if b0 >> 6 != 2:
            return
        yield off, ptype, words
        off += 4 + words * 4


def compound_has_sr(data: bytes) -> bool:
    """Cheap top-level scan: does this compound carry a sender report?"""
    return any(ptype == SR for _off, ptype, _w in _walk_compound(data))


def rebase_compound(data: bytes, new_ssrc: int, *, unix_time: float,
                    rtp_ts_now: int, packet_count: int | None = None,
                    octet_count: int | None = None) -> bytes:
    """Relay a pusher's RTCP compound onto one output's timeline.

    The reference's ``RTPSessionOutput::RewriteRTCP``
    (``RTPSessionOutput.cpp:403-460``): every top-level SSRC becomes the
    output's, and each SR additionally gets its NTP timestamp set to NOW
    and its RTP timestamp set to the *output-timeline* RTP time
    corresponding to now (the caller maps it through ``RewriteState``: the
    source-timeline pair would be wrong for every client using it for A/V
    sync).  ``packet_count``/``octet_count``
    replace the SR's sender stats with the output's own (the reference
    doubles the pusher's counts in place, a hack we do not mirror)."""
    out = bytearray(data)
    for off, ptype, words in _walk_compound(out):
        # only when the packet actually has a leading SSRC word (a BYE
        # with count=0 or an empty SDES is 4 bytes)
        if ptype in (SR, RR, SDES, BYE, APP) and words >= 1:
            struct.pack_into("!I", out, off + 4, new_ssrc & 0xFFFFFFFF)
        if ptype == SR and words >= 6:
            struct.pack_into("!Q", out, off + 8,
                             ntp_now(unix_time) & (2**64 - 1))
            struct.pack_into("!I", out, off + 16, rtp_ts_now & 0xFFFFFFFF)
            if packet_count is not None:
                struct.pack_into("!I", out, off + 20,
                                 packet_count & 0xFFFFFFFF)
            if octet_count is not None:
                struct.pack_into("!I", out, off + 24,
                                 octet_count & 0xFFFFFFFF)
    return bytes(out)


def rewrite_compound_ssrc(data: bytes, new_ssrc: int) -> bytes:
    """Rewrite every top-level sender/source SSRC in a compound to
    ``new_ssrc`` — the relay's SR rewrite (``RTPSessionOutput.cpp:403-460``),
    applied so late-joined receivers see the per-output SSRC rather than the
    pusher's."""
    out = bytearray(data)
    for off, ptype, words in _walk_compound(out):
        # only when the packet actually has a leading SSRC word (a BYE with
        # count=0 or an empty SDES is 4 bytes; off+4 would be the NEXT
        # packet's header)
        if ptype in (SR, RR, SDES, BYE, APP) and words >= 1:
            struct.pack_into("!I", out, off + 4, new_ssrc & 0xFFFFFFFF)
    return bytes(out)
