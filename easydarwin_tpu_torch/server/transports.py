"""Interleaved RTP egress over a client's RTSP TCP connection.

WouldBlock flow control: a stalled client must never stall the relay.  Past
``HIGH_WATER`` buffered bytes the output reports WOULD_BLOCK and the
engine replays from its bookmark on a later pass.
"""

from __future__ import annotations

import asyncio

from ..relay.output import RelayOutput, WriteResult

#: interleaved write-buffer high water mark
HIGH_WATER = 256 * 1024


class InterleavedOutput(RelayOutput):
    """$-framed RTP/RTCP egress on the player's RTSP TCP connection."""

    def __init__(self, transport: asyncio.WriteTransport,
                 rtp_channel: int, rtcp_channel: int, **kw):
        super().__init__(**kw)
        self.transport = transport
        self.rtp_channel = rtp_channel
        self.rtcp_channel = rtcp_channel

    @property
    def interleave_chan(self) -> int:
        """The RTP interleave channel byte — the per-output framing
        constant that rides the device pass's ``chan`` column."""
        return self.rtp_channel

    def _send(self, channel: int, chunks: tuple[bytes, ...]) -> WriteResult:
        tr = self.transport
        if tr.is_closing():
            return WriteResult.ERROR
        if tr.get_write_buffer_size() > HIGH_WATER:
            return WriteResult.WOULD_BLOCK
        n = sum(len(c) for c in chunks)
        tr.write(b"$" + bytes((channel,)) + n.to_bytes(2, "big"))
        for c in chunks:
            tr.write(c)
        return WriteResult.OK

    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        ch = self.rtcp_channel if is_rtcp else self.rtp_channel
        return self._send(ch, (data,))

    def send_rewritten(self, header: bytes, tail: bytes) -> WriteResult:
        return self._send(self.rtp_channel, (header, tail))
