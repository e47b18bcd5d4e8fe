"""Subscriber sinks.

An output is one subscriber's view of one relayed track.  It owns a
**bookmark** (the absolute ring id of the next packet it needs; WouldBlock
replay is "don't advance") and its **rewrite state** (SSRC, seq and
timestamp rebase), which the device pass consumes as one row of the
``[S, 6]`` state matrix.  It also owns its receiver's feedback: a
``ThinningFilter`` whose level the player's RRs and NADU blocks move, and
the x-RTP-Meta-Info fields its SETUP negotiated (``meta_field_ids``; None
for plain RTP), which wrap every RTP packet it sends.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass

from ..protocol import rtcp, rtp, rtp_meta
from .quality import ThinningFilter


class WriteResult(enum.Enum):
    OK = 0
    WOULD_BLOCK = 1
    ERROR = 2


@dataclass
class RewriteState:
    """Per-output header-rewrite parameters."""

    ssrc: int = 0
    #: first source seq/ts seen by this output (rebase origin; −1 = unlatched)
    base_src_seq: int = -1
    base_src_ts: int = -1
    #: output-side origins (what base_src maps to)
    out_seq_start: int = 0
    out_ts_start: int = 0

    def map_seq(self, src_seq: int) -> int:
        return (src_seq - self.base_src_seq + self.out_seq_start) & 0xFFFF

    def map_ts(self, src_ts: int) -> int:
        return (src_ts - self.base_src_ts + self.out_ts_start) & 0xFFFFFFFF


class RelayOutput:
    """One subscriber × one track.  Subclasses implement ``send_bytes``.

    The fan-out engine's native rungs read four hooks, whose defaults keep
    an output on the Python send loop: ``native_addr`` (the ``(ip, port)``
    a UDP output's datagrams go to through the server's shared egress
    socket), ``stream_fd`` (the raw stream socket of an interleaved
    output), ``engine_writable()`` (raw writes to that socket cannot
    overtake buffered bytes) and ``push_tail()`` (queue a torn packet's
    remaining bytes behind the socket's own buffer); ``records_sends``
    keeps an output off every rung but the batch-header rung.  A UDP
    output may carry ``fec``, its FEC tier state (``relay.fec.
    FecOutputState``), which ``RelayStream.add_output`` registers."""

    native_addr: tuple[str, int] | None = None
    stream_fd: int = -1
    #: True for an output that must see every datagram it sends (reliable
    #: UDP's resend window): the engine serves it on the batch-header rung
    records_sends: bool = False

    def engine_writable(self) -> bool:
        return False

    def push_tail(self, data: bytes) -> bool:
        return False

    def __init__(self, *, ssrc: int = 0, out_seq_start: int = 1,
                 out_ts_start: int = 0):
        self.bookmark: int | None = None      # next ring id; None = not primed
        self.rewrite = RewriteState(ssrc=ssrc, out_seq_start=out_seq_start,
                                    out_ts_start=out_ts_start)
        self.thinning = ThinningFilter()
        #: negotiated x-RTP-Meta-Info {field: compressed id}; None = plain
        self.meta_field_ids: dict[str, int] | None = None
        #: the FEC tier's state (``relay.fec.FecOutputState``), or None
        self.fec = None
        self.packets_sent = 0
        self.bytes_sent = 0
        #: RTP payload octets only (no 12-byte header, no meta-info wrap):
        #: the RFC 3550 sender octet count the SRs report
        self.payload_octets = 0
        self.stalls = 0
        #: the relay clock's ms of the last SR this output was sent
        #: (relayed or originated; 0 = never): the SR cadence
        self.last_sr_ms = 0

    def on_receiver_report(self, fraction_lost: float) -> int:
        """An RR block's loss fraction (0..1) → the new quality level."""
        return self.thinning.controller.on_receiver_report(fraction_lost)

    def on_nadu(self, playout_delay_ms: int, free_buffer_64b: int) -> int:
        """A NADU block's buffer state → the new quality level."""
        return self.thinning.controller.on_nadu(playout_delay_ms,
                                                free_buffer_64b)

    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        raise NotImplementedError

    def send_rewritten(self, header: bytes, tail: bytes) -> WriteResult:
        """Send an engine-rewritten packet: 12-byte header + the original
        bytes from offset 12, wrapped when meta-info was negotiated."""
        if self.meta_field_ids is not None:
            return self.send_bytes(self.wrap_meta(header, tail),
                                   is_rtcp=False)
        return self.send_bytes(header + tail, is_rtcp=False)

    def wrap_meta(self, header: bytes, payload: bytes) -> bytes:
        """RTP → x-RTP-Meta-Info packet with the negotiated live fields:
        ``tt`` the wall-clock ms of sending, ``sq`` the seq of the packet
        as sent (clients correlate ``md`` with the RTP header), ``md`` the
        payload."""
        ids = self.meta_field_ids
        return rtp_meta.build_packet(
            header, media=payload, field_ids=ids,
            transmit_time=int(time.time() * 1000) if "tt" in ids else None,
            seq=rtp.peek_seq(header) if "sq" in ids else None)

    def write_rtp(self, packet: bytes) -> WriteResult:
        """Rewrite the header per this output's state and send — the scalar
        oracle the engine's batched rewrite must match byte for byte.  The
        rebase latches on the first attempt, even a WOULD_BLOCK'd one."""
        rw = self.rewrite
        if rw.base_src_seq < 0:
            rw.base_src_seq = rtp.peek_seq(packet)
            rw.base_src_ts = rtp.peek_timestamp(packet)
        out = rtp.rewrite_header(
            packet,
            seq=rw.map_seq(rtp.peek_seq(packet)),
            timestamp=rw.map_ts(rtp.peek_timestamp(packet)),
            ssrc=rw.ssrc)
        if self.meta_field_ids is not None:
            out = self.wrap_meta(out[:12], out[12:])
        res = self.send_bytes(out, is_rtcp=False)
        if res is WriteResult.OK:
            self.packets_sent += 1
            self.bytes_sent += len(out)
            self.payload_octets += max(len(packet) - 12, 0)
        elif res is WriteResult.WOULD_BLOCK:
            self.stalls += 1
        return res

    def write_rtcp(self, packet: bytes, *, src_ts_now: int | None = None,
                   unix_time: float = 0.0) -> WriteResult:
        """Relay an RTCP compound onto this output's timeline
        (``RTPSessionOutput.cpp:403-460``): every SSRC becomes the
        output's; when the stream's source-timeline "RTP time of now" is
        given and the rebase has latched, each SR also gets NTP ← now and
        RTP ← ``map_ts(now)`` and the output's own sender counts."""
        rw = self.rewrite
        if src_ts_now is not None and rw.base_src_ts >= 0:
            out = rtcp.rebase_compound(
                packet, rw.ssrc, unix_time=unix_time,
                rtp_ts_now=rw.map_ts(src_ts_now),
                packet_count=self.packets_sent,
                octet_count=self.payload_octets)
        else:
            out = rtcp.rewrite_compound_ssrc(packet, rw.ssrc)
        res = self.send_bytes(out, is_rtcp=True)
        # packets_sent/bytes_sent stay RTP-only: they feed the SR counts
        if res is WriteResult.WOULD_BLOCK:
            self.stalls += 1
        return res


class CollectingOutput(RelayOutput):
    """Test/bench sink that records everything (optionally stalling)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.rtp_packets: list[bytes] = []
        self.rtcp_packets: list[bytes] = []
        self.block_next = 0

    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        if self.block_next > 0:
            self.block_next -= 1
            return WriteResult.WOULD_BLOCK
        (self.rtcp_packets if is_rtcp else self.rtp_packets).append(data)
        return WriteResult.OK
