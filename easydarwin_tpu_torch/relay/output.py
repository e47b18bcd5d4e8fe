"""Subscriber sinks.

An output is one subscriber's view of one relayed track.  It owns a
**bookmark** (the absolute ring id of the next packet it needs; WouldBlock
replay is "don't advance") and its **rewrite state** (SSRC, seq and
timestamp rebase), which the device pass consumes as one row of the
``[S, 6]`` state matrix.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..protocol import rtp


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
    remaining bytes behind the socket's own buffer)."""

    native_addr: tuple[str, int] | None = None
    stream_fd: int = -1

    def engine_writable(self) -> bool:
        return False

    def push_tail(self, data: bytes) -> bool:
        return False

    def __init__(self, *, ssrc: int = 0, out_seq_start: int = 1,
                 out_ts_start: int = 0):
        self.bookmark: int | None = None      # next ring id; None = not primed
        self.rewrite = RewriteState(ssrc=ssrc, out_seq_start=out_seq_start,
                                    out_ts_start=out_ts_start)
        self.packets_sent = 0
        self.bytes_sent = 0
        #: RTP payload octets only (no 12-byte header)
        self.payload_octets = 0
        self.stalls = 0

    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        raise NotImplementedError

    def send_rewritten(self, header: bytes, tail: bytes) -> WriteResult:
        """Send an engine-rewritten packet: 12-byte header + the original
        bytes from offset 12."""
        return self.send_bytes(header + tail, is_rtcp=False)

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
        res = self.send_bytes(out, is_rtcp=False)
        if res is WriteResult.OK:
            self.packets_sent += 1
            self.bytes_sent += len(out)
            self.payload_octets += max(len(packet) - 12, 0)
        elif res is WriteResult.WOULD_BLOCK:
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
