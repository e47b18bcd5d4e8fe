"""``.sdp`` relay sources: UDP and multicast broadcast ingest.

Besides ANNOUNCE pushes, the relay serves broadcasts described by a
``<path>.sdp`` file under the movie folder: each media section names a
UDP port (``m=``) and a destination (``c=``, media- or session-level).
``open`` binds each section's RTP port and the odd port after it
(joining the group when the destination is multicast) and registers the
path's relay session, owned by the source, whose ingest is
``RelaySession.push`` as a pusher's is.  The SDP served to players has
the ingest transport stripped (no ``c=``, ``m=`` ports 0), so they SETUP
through RTSP.  ``open`` is idempotent and safe against concurrent SETUPs
of one path; a path that already has a session (a pusher, a pull) is
served as it is.  ``sweep`` closes a source that had no player for
``idle_timeout`` seconds; a session someone else took over survives.
"""

from __future__ import annotations

import asyncio
import ipaddress
import os
import socket
import time

from ..protocol import sdp as sdp_mod
from .session import RelaySession, SessionRegistry


def _is_multicast(addr: str) -> bool:
    try:
        return ipaddress.ip_address(addr).is_multicast
    except ValueError:
        return False


class _IngestProtocol(asyncio.DatagramProtocol):
    def __init__(self, on_packet):
        self._on_packet = on_packet

    def datagram_received(self, data, addr):
        self._on_packet(data)

    def error_received(self, exc):
        pass


async def _open_ingest_socket(port: int, group: str | None, on_packet,
                              iface_ip: str = "0.0.0.0"):
    """A reusable wildcard bind on the SDP's port, joined to ``group``."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        sock.bind(("0.0.0.0", port))
        if group is not None:
            mreq = socket.inet_aton(group) + socket.inet_aton(iface_ip)
            sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        sock.setblocking(False)
        transport, _ = await asyncio.get_running_loop() \
            .create_datagram_endpoint(lambda: _IngestProtocol(on_packet),
                                      sock=sock)
    except OSError:
        sock.close()
        raise
    return transport


class BroadcastSource:
    """One open ``.sdp`` source: its bound sockets and its relay session."""

    def __init__(self, path: str, session: RelaySession):
        self.path = path
        self.session = session
        self.transports: list[asyncio.DatagramTransport] = []

    def close(self) -> None:
        for t in self.transports:
            t.close()
        self.transports.clear()


class SdpFileRelaySource:
    def __init__(self, movie_folder: str, registry: SessionRegistry,
                 *, idle_timeout: float = 20.0, on_ingest=None):
        self.movie_folder = movie_folder
        self.registry = registry
        self.idle_timeout = idle_timeout
        self.sources: dict[str, BroadcastSource] = {}
        #: called with the path after each media datagram (the pump's wake)
        self.on_ingest = on_ingest
        self._idle_since: dict[str, float] = {}
        self._open_lock = asyncio.Lock()
        #: sources opened, closed, opens that failed to bind, and
        #: datagrams taken in
        self.counts = dict.fromkeys(("opened", "closed", "bind_failures",
                                     "datagrams"), 0)

    # -- lookup ------------------------------------------------------------
    def sdp_file_for(self, path: str) -> str | None:
        rel = sdp_mod._norm(path).lstrip("/")
        if not rel:
            return None
        root = os.path.normpath(os.path.abspath(self.movie_folder))
        cand = os.path.normpath(os.path.join(root, rel + ".sdp"))
        if not cand.startswith(root + os.sep):
            return None                     # traversal
        return cand if os.path.isfile(cand) else None

    async def describe(self, path: str) -> str | None:
        fname = self.sdp_file_for(path)
        if fname is None:
            return None
        try:
            text = _read(fname)
        except OSError:                     # unreadable, or gone
            return None
        return client_facing(sdp_mod.parse(text))

    # -- activation --------------------------------------------------------
    async def open(self, path: str) -> RelaySession | None:
        key = sdp_mod._norm(path)
        async with self._open_lock:
            src = self.sources.get(key)
            if src is not None:
                return src.session
            fname = self.sdp_file_for(path)
            if fname is None:
                return None
            try:
                text = _read(fname)
            except OSError:
                return None
            # a path with a feeder already (a pusher, a pull) is served as
            # it is: binding ingest onto its session would feed it twice
            if self.registry.find(key) is not None:
                return self.registry.find(key)
            session = self.registry.find_or_create(key, text)
            session.owner = self
            src = BroadcastSource(key, session)
            sd = session.description
            # the cache holds the file as read: serve the stripped text
            # before any bind awaits, so no DESCRIBE sees the ingest ports
            self.registry.sdp_cache.set(
                key, client_facing(sdp_mod.parse(text)))
            try:
                for info in sd.streams:
                    if not info.port:
                        continue
                    dest = info.dest_address(sd.connection)
                    group = dest if _is_multicast(dest) else None
                    for port, is_rtcp in ((info.port, False),
                                          (info.port + 1, True)):
                        src.transports.append(await _open_ingest_socket(
                            port, group,
                            self._make_cb(src, info.track_id, is_rtcp)))
            except OSError:
                src.close()
                self.counts["bind_failures"] += 1
                # tear down only if still ours: an ANNOUNCE during the
                # binds takes the session over
                if (self.registry.find(key) is session
                        and session.owner is self):
                    self.registry.remove(key)
                return None
            self.sources[key] = src
            self.counts["opened"] += 1
            return session

    def _make_cb(self, src: BroadcastSource, track_id: int, is_rtcp: bool):
        def cb(data: bytes) -> None:
            src.session.push(track_id, data, is_rtcp=is_rtcp)
            self.counts["datagrams"] += 1
            if not is_rtcp and self.on_ingest is not None:
                self.on_ingest(src.path)
        return cb

    # -- teardown ----------------------------------------------------------
    def close_source(self, path: str) -> None:
        key = sdp_mod._norm(path)
        src = self.sources.pop(key, None)
        if src is not None:
            src.close()
            self.counts["closed"] += 1
            sess = self.registry.find(src.path)
            if sess is src.session and sess.owner is self:
                self.registry.remove(src.path)
        self._idle_since.pop(key, None)

    def sweep(self, now: float | None = None) -> int:
        """Close the sources that have had no player for
        ``idle_timeout``; returns how many."""
        t = time.monotonic() if now is None else now
        killed = 0
        for key, src in list(self.sources.items()):
            if src.session.num_outputs > 0:
                self._idle_since.pop(key, None)
                continue
            if t - self._idle_since.setdefault(key, t) >= self.idle_timeout:
                self.close_source(key)
                killed += 1
        return killed

    def close_all(self) -> None:
        for key in list(self.sources):
            self.close_source(key)


def client_facing(sd: sdp_mod.SessionDescription) -> str:
    """The SDP players get: session- and media-level ``c=`` stripped
    (``build`` zeroes the ``m=`` ports).  Mutates ``sd``: pass a
    throwaway parse."""
    for s in sd.streams:
        s.connection = ""
    sd.connection = ""
    return sdp_mod.build(sd)


def _read(fname: str) -> str:
    with open(fname, "r", encoding="utf-8", errors="replace") as f:
        return f.read()
