"""An RTSP client over interleaved TCP: the player a pull relay plays
with, and a pusher for tests.

``RtspClient`` sends requests (CSeq-matched replies; a late reply to a
timed-out request is dropped, never paired with a later one) and demuxes
``$``-framed packets into per-channel queues, or with
``enable_any_queue`` into one arrival-order queue (``recv_any``; ``(-1,
b"")`` at EOF).  ``ReceiverStats`` counts what arrived on even channels:
packets, bytes, and seq gaps, duplicates and reorderings.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from ..protocol import rtp, rtsp, sdp


@dataclass
class ReceiverStats:
    packets: int = 0
    bytes: int = 0
    lost: int = 0
    duplicates: int = 0
    out_of_order: int = 0
    _last_seq: int | None = None
    _seen: set = field(default_factory=set)

    def on_packet(self, data: bytes) -> None:
        self.packets += 1
        self.bytes += len(data)
        if len(data) < 12:
            return
        seq = rtp.peek_seq(data)
        if seq in self._seen:
            self.duplicates += 1
            return
        self._seen.add(seq)
        if self._last_seq is not None:
            d = rtp.seq_delta(seq, self._last_seq)
            if d > 1:
                self.lost += d - 1
            elif d < 0:
                self.out_of_order += 1
        if self._last_seq is None or rtp.seq_delta(seq, self._last_seq) > 0:
            self._last_seq = seq


class RtspClient:
    def __init__(self):
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None
        self.wire = rtsp.RtspWireReader(parse_responses=True)
        self.cseq = 0
        self.session_id: str | None = None
        #: headers merged into every request (a call's own win)
        self.default_headers: dict = {}
        self._responses: asyncio.Queue = asyncio.Queue()
        #: interleaved channel → queue of payloads
        self.channels: dict[int, asyncio.Queue] = {}
        #: one (channel, data) queue in arrival order, once enabled
        self.any_queue: asyncio.Queue | None = None
        self.stats = ReceiverStats()
        self._reader_task: asyncio.Task | None = None

    async def connect(self, host: str, port: int) -> None:
        self.reader, self.writer = await asyncio.open_connection(host, port)
        self._reader_task = asyncio.create_task(self._read_loop())

    async def close(self) -> None:
        if self._reader_task:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except (asyncio.CancelledError, ConnectionError):
                pass
        if self.writer:
            self.writer.close()

    async def _read_loop(self) -> None:
        try:
            while True:
                data = await self.reader.read(65536)
                if not data:
                    break
                self.wire.feed(data)
                for ev in self.wire.events():
                    if isinstance(ev, rtsp.InterleavedPacket):
                        if ev.channel % 2 == 0:
                            self.stats.on_packet(ev.data)
                        if self.any_queue is not None:
                            self.any_queue.put_nowait((ev.channel, ev.data))
                        else:
                            self.channels.setdefault(
                                ev.channel, asyncio.Queue()).put_nowait(
                                    ev.data)
                    else:
                        self._responses.put_nowait(ev)
        finally:
            if self.any_queue is not None:      # EOF for recv_any
                self.any_queue.put_nowait((-1, b""))

    # ------------------------------------------------------------ requests
    async def request(self, method: str, uri: str, headers=None,
                      body: bytes = b"", timeout: float = 5.0
                      ) -> rtsp.RtspResponse:
        self.cseq += 1
        want = self.cseq
        hdrs = {"cseq": str(want)}
        if self.session_id:
            hdrs["session"] = self.session_id
        hdrs.update(self.default_headers)
        hdrs.update(headers or {})
        self.writer.write(rtsp.RtspRequest(method, uri, hdrs, body)
                          .to_bytes())
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            resp = await asyncio.wait_for(
                self._responses.get(), max(deadline - loop.time(), 0.001))
            rc = resp.headers.get("cseq")
            if rc is not None and rc.isdigit() and int(rc) < want:
                continue                # a timed-out request's late reply
            break
        if sid := resp.headers.get("session"):
            self.session_id = sid.split(";")[0].strip()
        return resp

    def send_interleaved(self, channel: int, data: bytes) -> None:
        self.writer.write(rtsp.frame_interleaved(channel, data))

    async def recv_interleaved(self, channel: int,
                               timeout: float = 5.0) -> bytes:
        q = self.channels.setdefault(channel, asyncio.Queue())
        return await asyncio.wait_for(q.get(), timeout)

    def enable_any_queue(self) -> None:
        """Deliver (channel, data) in arrival order through ``recv_any``."""
        self.any_queue = asyncio.Queue()

    async def recv_any(self) -> tuple[int, bytes]:
        if self.any_queue is None:
            self.enable_any_queue()
        return await self.any_queue.get()

    # ---------------------------------------------------------- push flow
    async def push_start(self, uri: str, sdp_text: str) -> None:
        """ANNOUNCE, SETUP (record, interleaved) each track, RECORD."""
        r = await self.request("ANNOUNCE", uri, {
            "content-type": "application/sdp"}, sdp_text.encode())
        _expect(r, "ANNOUNCE")
        for i, st in enumerate(sdp.parse(sdp_text).streams):
            r = await self.request("SETUP", f"{uri}/trackID={st.track_id}", {
                "transport": f"RTP/AVP/TCP;unicast;interleaved={2 * i}-"
                             f"{2 * i + 1};mode=record"})
            _expect(r, "SETUP")
        _expect(await self.request("RECORD", uri), "RECORD")

    def push_packet(self, track_index: int, data: bytes,
                    is_rtcp: bool = False) -> None:
        self.send_interleaved(2 * track_index + (1 if is_rtcp else 0), data)

    # ---------------------------------------------------------- play flow
    async def play_start(self, uri: str) -> sdp.SessionDescription:
        """DESCRIBE, SETUP each track interleaved on channels 2i/2i+1,
        PLAY; returns the described session."""
        r = await self.request("DESCRIBE", uri, {"accept": "application/sdp"})
        _expect(r, "DESCRIBE")
        sd = sdp.parse(r.body)
        for i, st in enumerate(sd.streams):
            r = await self.request("SETUP", f"{uri}/trackID={st.track_id}", {
                "transport": f"RTP/AVP/TCP;unicast;interleaved={2 * i}-"
                             f"{2 * i + 1}"})
            _expect(r, "SETUP")
        _expect(await self.request("PLAY", uri), "PLAY")
        return sd

    async def teardown(self, uri: str) -> None:
        try:
            await self.request("TEARDOWN", uri, timeout=2.0)
        except (asyncio.TimeoutError, ConnectionError):
            pass


class RtspClientError(ConnectionError):
    """A request the server answered with a status other than 200."""

    def __init__(self, method: str, status: int):
        super().__init__(f"{method} answered {status}")
        self.status = status


def _expect(resp: rtsp.RtspResponse, method: str) -> None:
    if resp.status != 200:
        raise RtspClientError(method, resp.status)
