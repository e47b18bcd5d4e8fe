"""RTSP pull relay: pull a remote stream into a local path.

The server plays an upstream ``rtsp://`` URL as an interleaved TCP player
(``utils.client.RtspClient``) and publishes the stream under a local
path, where the relay serves it as it serves a pushed one: each packet
goes into the session's ring through ``RelaySession.push``, the ingest a
pusher's packets take, so the megabatch, the RTCP rebasing of the
upstream's SRs and the pump's wheel see a pulled stream as a pushed one.
Servers chain into distribution trees this way.

One ``PullRelay`` is one upstream session feeding one ``RelaySession``,
which it owns; ``PullRelayManager`` keeps them, is driven by REST
``startpullrelay`` / ``stoppullrelay`` / ``getpullrelays``, refuses a
path that already has a session, and sweeps pulls whose upstream ended.
A dead pull never removes a session something else has since taken
over (a re-ANNOUNCE).
"""

from __future__ import annotations

import asyncio
import time
from urllib.parse import urlparse

from ..utils.client import RtspClient
from .session import RelaySession, SessionRegistry


class PullError(Exception):
    pass


def parse_rtsp_url(url: str) -> tuple[str, int, str]:
    u = urlparse(url)
    if u.scheme != "rtsp" or not u.hostname:
        raise PullError(f"not an rtsp:// URL: {url!r}")
    return u.hostname, u.port or 554, u.path or "/"


class PullRelay:
    """One upstream pull session."""

    def __init__(self, local_path: str, url: str, registry: SessionRegistry,
                 *, on_packet=None):
        self.local_path = local_path
        self.url = url
        self.registry = registry
        #: called with the path after each media packet (the pump's wake)
        self.on_packet = on_packet
        self.client = RtspClient()
        self.session: RelaySession | None = None
        self.started_at = time.time()
        self.alive = False
        #: ms from ``start`` to the first media packet pushed (None: none
        #: yet), and host ns spent pushing and waking per packet
        self.first_packet_ms: float | None = None
        self.forward_ns = 0
        self._t0 = time.perf_counter()
        self._forward_task: asyncio.Task | None = None
        #: interleaved channel → (track_id, is_rtcp)
        self._channel_map: dict[int, tuple[int, bool]] = {}

    async def start(self, timeout: float = 10.0) -> None:
        host, port, _path = parse_rtsp_url(self.url)
        self._t0 = time.perf_counter()
        self.client.enable_any_queue()      # before any packet can arrive
        try:
            await asyncio.wait_for(self._handshake(host, port), timeout)
        except asyncio.CancelledError:
            # a caller's timeout cancels us mid-handshake: the socket and
            # its reader task must not leak
            await self.client.close()
            raise
        except (OSError, asyncio.TimeoutError) as e:
            await self.client.close()
            raise PullError(f"upstream {self.url}: {e!r}") from e

    async def _handshake(self, host: str, port: int) -> None:
        await self.client.connect(host, port)
        sd = await self.client.play_start(self.url)
        if not sd.streams:
            raise ConnectionError("SDP has no streams")
        for i, st in enumerate(sd.streams):
            self._channel_map[2 * i] = (st.track_id, False)
            self._channel_map[2 * i + 1] = (st.track_id, True)
        self.session = self.registry.find_or_create(self.local_path, sd.raw)
        self.session.owner = self
        self.alive = True
        self._forward_task = asyncio.create_task(
            self._forward_loop(), name=f"pull:{self.local_path}")

    async def _forward_loop(self) -> None:
        """Upstream interleaved packets → the local session's ingest."""
        client = self.client
        try:
            while True:
                ch, data = await client.recv_any()
                if ch < 0:                  # upstream EOF
                    break
                mapped = self._channel_map.get(ch)
                if mapped is None or self.session is None:
                    continue
                t = time.perf_counter_ns()
                track_id, is_rtcp = mapped
                self.session.push(track_id, data, is_rtcp=is_rtcp)
                if not is_rtcp:
                    if self.first_packet_ms is None:
                        self.first_packet_ms = (time.perf_counter()
                                                - self._t0) * 1e3
                    if self.on_packet is not None:
                        self.on_packet(self.local_path)
                self.forward_ns += time.perf_counter_ns() - t
        except (asyncio.CancelledError, ConnectionError):
            pass
        finally:
            self.alive = False
            # release the session now, as a pusher's disconnect does: a
            # later ANNOUNCE gets a fresh session, never a dead pull's
            self._release()

    def _release(self) -> None:
        """Remove the session if it is still this pull's."""
        if (self.session is not None
                and self.registry.find(self.local_path) is self.session
                and self.session.owner is self):
            self.registry.remove(self.local_path)
        self.session = None

    async def stop(self) -> None:
        was_alive = self.alive
        self.alive = False
        if self._forward_task is not None:
            self._forward_task.cancel()
            try:
                await self._forward_task
            except asyncio.CancelledError:
                pass
        if was_alive:       # a dead upstream would only time TEARDOWN out
            await self.client.teardown(self.url)
        await self.client.close()
        self._release()

    def stats(self) -> dict:
        n = self.client.stats.packets
        return {
            "path": self.local_path, "url": self.url,
            "alive": self.alive,
            "uptime_sec": int(time.time() - self.started_at),
            "packets": n,
            "lost": self.client.stats.lost,
            "first_packet_ms": self.first_packet_ms,
            "forward_us_per_packet": self.forward_ns / 1e3 / max(n, 1),
        }


class PullRelayManager:
    def __init__(self, registry: SessionRegistry, *, on_packet=None,
                 connect_timeout: float = 10.0):
        self.registry = registry
        self.on_packet = on_packet
        self.connect_timeout = connect_timeout
        self.pulls: dict[str, PullRelay] = {}
        self._lock = asyncio.Lock()         # concurrent REST start/stop
        #: pulls started, refused or failed at start, stopped, and swept
        #: after their upstream ended
        self.counts = dict.fromkeys(("started", "refused", "stopped",
                                     "swept"), 0)

    async def start_pull(self, local_path: str, url: str) -> PullRelay:
        key = local_path.rstrip("/") or "/"
        async with self._lock:
            old = self.pulls.get(key)
            if old is not None:
                if old.alive:
                    self.counts["refused"] += 1
                    raise PullError(f"pull already active on {key}")
                # dead but not swept yet: retire it before starting again
                self.pulls.pop(key, None)
                await old.stop()
            elif self.registry.find(key) is not None:
                self.counts["refused"] += 1
                raise PullError(f"{key} already has a live session")
            pull = PullRelay(key, url, self.registry,
                             on_packet=self.on_packet)
            try:
                await pull.start(self.connect_timeout)
            except PullError:
                self.counts["refused"] += 1
                raise
            self.pulls[key] = pull
            self.counts["started"] += 1
            return pull

    async def stop_pull(self, local_path: str) -> dict:
        key = local_path.rstrip("/") or "/"
        async with self._lock:
            pull = self.pulls.pop(key, None)
            if pull is None:
                raise KeyError(key)
            st = pull.stats()
            await pull.stop()
            self.counts["stopped"] += 1
            return st

    def list_pulls(self) -> list[dict]:
        return [p.stats() for p in self.pulls.values()]

    async def stop_all(self) -> None:
        for key in list(self.pulls):
            try:
                await self.stop_pull(key)
            except KeyError:
                pass

    def has_dead(self) -> bool:
        return any(not p.alive for p in self.pulls.values())

    async def sweep(self) -> int:
        """Retire pulls whose upstream ended, closing their sockets, so
        their paths free up; returns how many."""
        async with self._lock:
            dead = [k for k, p in self.pulls.items() if not p.alive]
            for k in dead:
                await self.pulls.pop(k).stop()
            self.counts["swept"] += len(dead)
            return len(dead)

    def stats(self) -> dict:
        return {**self.counts, "active": sum(p.alive for p in
                                             self.pulls.values())}
