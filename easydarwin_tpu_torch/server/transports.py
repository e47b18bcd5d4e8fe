"""RTP egress to players (interleaved over the RTSP TCP connection, or
UDP), and the UDP port pairs of pushers.

WouldBlock flow control: a stalled client must never stall the relay.  Past
``HIGH_WATER`` buffered bytes an interleaved output reports WOULD_BLOCK,
and a UDP send that would block does too; the engine replays from the
bookmark on a later pass.

UDP players are served from one shared socket pair (``SharedUdpEgress``),
whose RTP socket the engine writes with one ``sendmmsg``/UDP-GSO scatter a
stream a wake.  Each datagram that reaches its RTCP socket is handed with
its source address to ``on_rtcp`` (the RTSP server, which routes a
player's receiver reports to its outputs).  That socket takes every UDP
player's reports, NACKs and reliable acks (one a packet), so a readiness
callback takes up to ``RTCP_DRAIN_MAX`` datagrams off it (an asyncio
endpoint takes one a loop turn; the bound keeps a flood from holding the
loop), and
its receive buffer (``RTCP_RCVBUF``) holds what arrives while a pump wake
holds the loop: a dropped ack is resent data, and a late one inflates
the reliable output's RTO.  With the server's ``shared_udp_egress`` off
each UDP player takes a port pair of its own from ``UdpPortPool``
instead: its packets leave through the engine's per-output loop, and its
RTCP port hands the player's reports on.

A pusher that SETUPs over UDP gets a port pair of its own from
``UdpPortPool``: an even RTP port and the odd one above it.  With the
native ingest (``allocate_native``) the RTP side is a plain non-blocking
socket watched by ``loop.add_reader``, and one readiness callback drains
the whole pending batch into the ring in recvmmsg batches
(``NativeIngestPair``); without it (``allocate``) each datagram is one
asyncio callback.  A pusher's RTCP side is an asyncio endpoint either
way.
"""

from __future__ import annotations

import asyncio
import os
import socket

from ..relay.output import RelayOutput, WriteResult

#: the shared RTCP socket's requested receive buffer (the kernel caps it
#: at twice ``net.core.rmem_max``)
RTCP_RCVBUF = 1 << 22
#: datagrams one readiness callback takes off the RTCP socket at most
RTCP_DRAIN_MAX = 64
RTCP_MAX_DATAGRAM = 65536

#: interleaved write-buffer high water mark
HIGH_WATER = 256 * 1024


class InterleavedOutput(RelayOutput):
    """$-framed RTP/RTCP egress on the player's RTSP TCP connection.

    The engine frames whole ring spans onto ``stream_fd`` through the
    native writev sender while the transport's own buffer is empty
    (``engine_writable``), and hands the remainder of a torn packet to
    ``push_tail``, after which the transport owns the order of the bytes
    until its buffer drains."""

    def __init__(self, transport: asyncio.WriteTransport,
                 rtp_channel: int, rtcp_channel: int, **kw):
        super().__init__(**kw)
        self.transport = transport
        self.rtp_channel = rtp_channel
        self.rtcp_channel = rtcp_channel
        sock = transport.get_extra_info("socket")
        #: the raw stream socket, or −1 where the transport has none
        self.stream_fd = sock.fileno() if sock is not None else -1

    @property
    def interleave_chan(self) -> int:
        """The RTP interleave channel byte — the per-output framing
        constant that rides the device pass's ``chan`` column."""
        return self.rtp_channel

    def engine_writable(self) -> bool:
        tr = self.transport
        return (self.stream_fd >= 0 and not tr.is_closing()
                and tr.get_write_buffer_size() == 0)

    def push_tail(self, data: bytes) -> bool:
        tr = self.transport
        if tr.is_closing():
            return False
        tr.write(data)
        return True

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
        if self.meta_field_ids is not None:
            return self._send(self.rtp_channel,
                              (self.wrap_meta(header, tail),))
        return self._send(self.rtp_channel, (header, tail))


class UdpOutput(RelayOutput):
    """RTP/RTCP egress to a client's UDP port pair through ``sender``: the
    server's ``SharedUdpEgress``, through whose socket the engine
    scatters its RTP natively to ``native_addr``, or a ``UdpPair`` of the
    player's own (``native_addr`` None: the engine's per-output loop
    sends each packet)."""

    def __init__(self, sender, client_ip: str, client_rtp_port: int,
                 client_rtcp_port: int, **kw):
        super().__init__(**kw)
        self.sender = sender
        self.rtp_addr = (client_ip, client_rtp_port)
        self.rtcp_addr = (client_ip, client_rtcp_port)
        self.native_addr = (self.rtp_addr
                            if isinstance(sender, SharedUdpEgress) else None)

    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        if is_rtcp:
            return self.sender.send_rtcp(data, self.rtcp_addr)
        return self.sender.send_rtp(data, self.rtp_addr)


class _DatagramSink(asyncio.DatagramProtocol):
    """Hands every incoming datagram and its source address on."""

    def __init__(self, on_packet):
        self.on_packet = on_packet
        self.received = 0

    def datagram_received(self, data, addr):
        self.received += 1
        if self.on_packet is not None:
            self.on_packet(data, addr)


class SharedUdpEgress:
    """The server's shared (RTP, RTCP) UDP pair for every UDP player.

    RTP leaves through one plain non-blocking socket: the engine's native
    scatter writes it (``fileno``), and ``send_rtp`` is the scalar send
    (WOULD_BLOCK when the socket buffer is full).  RTCP leaves through a
    plain non-blocking socket too, watched by ``loop.add_reader``; its
    incoming datagrams go to ``on_rtcp(data, addr)``."""

    def __init__(self, bind_ip: str = "0.0.0.0", on_rtcp=None):
        self.bind_ip = bind_ip
        self.on_rtcp = on_rtcp
        self.rtp_sock: socket.socket | None = None
        self.rtcp_sock: socket.socket | None = None
        self.rtcp_proto: _DatagramSink | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self.rtp_port = 0
        self.rtcp_port = 0
        self.send_errors = 0

    async def start(self) -> None:
        self.rtp_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rtp_sock.setblocking(False)
        self.rtp_sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)
        self.rtp_sock.bind((self.bind_ip, 0))
        self.rtp_port = self.rtp_sock.getsockname()[1]
        rtcp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            rtcp.setblocking(False)
            rtcp.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, RTCP_RCVBUF)
            rtcp.bind((self.bind_ip, 0))
        except OSError:
            rtcp.close()
            raise
        self.rtcp_sock = rtcp
        self.rtcp_port = rtcp.getsockname()[1]
        self.rtcp_proto = _DatagramSink(self.on_rtcp)
        self._loop = asyncio.get_running_loop()
        self._loop.add_reader(rtcp.fileno(), self._drain_rtcp)

    def _drain_rtcp(self) -> None:
        """Every datagram queued on the RTCP socket, up to
        ``RTCP_DRAIN_MAX`` a readiness callback."""
        sock, sink = self.rtcp_sock, self.rtcp_proto
        for _ in range(RTCP_DRAIN_MAX):
            try:
                data, addr = sock.recvfrom(RTCP_MAX_DATAGRAM)
            except OSError:             # EAGAIN: nothing more queued
                return
            sink.datagram_received(data, addr)

    def fileno(self) -> int:
        return self.rtp_sock.fileno() if self.rtp_sock is not None else -1

    def rtcp_socket_stats(self) -> dict:
        """The RTCP socket's receive buffer as granted and the datagrams
        the kernel dropped on it for want of room (``/proc/net/udp``'s
        ``drops``; -1 where that file has no row for it)."""
        sock = self.rtcp_sock
        if sock is None:
            return {"rcvbuf": 0, "drops": -1}
        inode = str(os.fstat(sock.fileno()).st_ino)
        drops = -1
        try:
            with open("/proc/net/udp") as f:
                for line in f.readlines()[1:]:
                    cols = line.split()
                    if cols[9] == inode:
                        drops = int(cols[-1])
        except OSError:
            pass
        return {"rcvbuf": sock.getsockopt(socket.SOL_SOCKET,
                                          socket.SO_RCVBUF),
                "drops": drops}

    def send_rtp(self, data: bytes, addr) -> WriteResult:
        if self.rtp_sock is None:
            return WriteResult.ERROR
        try:
            self.rtp_sock.sendto(data, addr)
        except BlockingIOError:
            return WriteResult.WOULD_BLOCK
        except OSError:
            self.send_errors += 1
            return WriteResult.ERROR
        return WriteResult.OK

    def send_rtcp(self, data: bytes, addr) -> WriteResult:
        if self.rtcp_sock is None:
            return WriteResult.ERROR
        try:
            self.rtcp_sock.sendto(data, addr)
        except BlockingIOError:
            return WriteResult.WOULD_BLOCK
        except OSError:
            self.send_errors += 1
            return WriteResult.ERROR
        return WriteResult.OK

    def close(self) -> None:
        if self.rtp_sock is not None:
            self.rtp_sock.close()
            self.rtp_sock = None
        if self.rtcp_sock is not None:
            self._loop.remove_reader(self.rtcp_sock.fileno())
            self.rtcp_sock.close()
            self.rtcp_sock = None


class UdpPair:
    """A bound even/odd (RTP, RTCP) port pair, each side an asyncio
    endpoint whose datagrams go to its callback: a pusher's, or a UDP
    player's own when the shared egress is off (its ``send_rtp`` and
    ``send_rtcp`` serve the player's ``UdpOutput``)."""

    def __init__(self, rtp_transport, rtcp_transport, rtp_port: int):
        self.rtp_transport: asyncio.DatagramTransport | None = rtp_transport
        self.rtcp_transport: asyncio.DatagramTransport | None = \
            rtcp_transport
        self.rtp_port = rtp_port

    @property
    def rtcp_port(self) -> int:
        return self.rtp_port + 1

    @staticmethod
    def _sendto(tr, data: bytes, addr) -> WriteResult:
        if tr is None or tr.is_closing():
            return WriteResult.ERROR
        tr.sendto(data, addr)
        return WriteResult.OK

    def send_rtp(self, data: bytes, addr) -> WriteResult:
        return self._sendto(self.rtp_transport, data, addr)

    def send_rtcp(self, data: bytes, addr) -> WriteResult:
        return self._sendto(self.rtcp_transport, data, addr)

    def close(self) -> None:
        for tr in (self.rtp_transport, self.rtcp_transport):
            if tr is not None and not tr.is_closing():
                tr.close()


class NativeIngestPair(UdpPair):
    """A ``UdpPair`` whose RTP side is a plain non-blocking socket: the
    event loop calls ``on_readable(fd)`` once a readiness edge, and that
    call drains the whole pending batch through the egress core's
    recvmmsg (``RelaySession.drain_native``)."""

    def __init__(self, rtp_sock: socket.socket, rtcp_transport,
                 rtp_port: int, loop: asyncio.AbstractEventLoop,
                 on_readable):
        super().__init__(None, rtcp_transport, rtp_port)
        self.rtp_sock: socket.socket | None = rtp_sock
        self._loop = loop
        loop.add_reader(rtp_sock.fileno(), on_readable, rtp_sock.fileno())

    def close(self) -> None:
        if self.rtp_sock is not None:
            self._loop.remove_reader(self.rtp_sock.fileno())
            self.rtp_sock.close()
            self.rtp_sock = None
        super().close()


class UdpPortPool:
    """Even/odd UDP port pairs for pushers, scanned upward from
    ``base_port`` (a port in use is skipped)."""

    def __init__(self, bind_ip: str = "0.0.0.0", base_port: int = 6970,
                 max_pairs: int = 4000):
        self.bind_ip = bind_ip
        self.base_port = base_port
        self.max_pairs = max_pairs
        self._next = base_port

    async def _scan(self, make_rtp, on_rtcp):
        """Bind ``make_rtp(loop, port)`` (returning ``(rtp, close)``) on an
        even port and the RTCP endpoint on the odd one above it, undoing
        the first when the second fails.  Returns ``(rtp, rtcp transport,
        port)``."""
        loop = asyncio.get_running_loop()
        last_err: OSError | None = None
        for _ in range(self.max_pairs):
            port = self._next
            self._next += 2
            if self._next >= self.base_port + 2 * self.max_pairs:
                self._next = self.base_port
            try:
                rtp, rtp_close = await make_rtp(loop, port)
            except OSError as e:
                last_err = e
                continue
            try:
                rtcp_t, _ = await loop.create_datagram_endpoint(
                    lambda: _DatagramSink(on_rtcp),
                    local_addr=(self.bind_ip, port + 1))
            except OSError as e:
                rtp_close()
                last_err = e
                continue
            return rtp, rtcp_t, port
        raise OSError(f"no free UDP port pair: {last_err}")

    async def allocate(self, on_rtp, on_rtcp) -> UdpPair:
        """A pair whose every datagram is one callback:
        ``on_rtp(data, addr)`` and ``on_rtcp(data, addr)``."""
        async def make_rtp(loop, port):
            tr, _ = await loop.create_datagram_endpoint(
                lambda: _DatagramSink(on_rtp),
                local_addr=(self.bind_ip, port))
            return tr, tr.close

        rtp_t, rtcp_t, port = await self._scan(make_rtp, on_rtcp)
        return UdpPair(rtp_t, rtcp_t, port)

    async def allocate_native(self, on_readable, on_rtcp) -> NativeIngestPair:
        """A pair whose RTP socket feeds the native drain:
        ``on_readable(fd)`` runs once a readiness edge."""
        async def make_rtp(_loop, port):
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                sock.setblocking(False)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 21)
                sock.bind((self.bind_ip, port))
            except OSError:
                sock.close()
                raise
            return sock, sock.close

        sock, rtcp_t, port = await self._scan(make_rtp, on_rtcp)
        return NativeIngestPair(sock, rtcp_t, port,
                                asyncio.get_running_loop(), on_readable)
