"""Cluster presence + leases + load balancing over Redis.

Reference parity: ``EasyRedisHandler.cpp`` —
* ``EasyDarwin:{id}`` presence hash {IP, HTTP, RTSP, Load} with 15 s TTL,
  re-asserted by the 5 s server tick (``RedisTTL``, cpp:160-213; tick at
  ``RunServer.cpp:640-652``);
* per-live-stream ``Live:{name}`` hash with 150 s TTL (cpp:246-278);
* least-loaded EasyDarwin selection for stream placement (the CMS flavor's
  ``RedisGetAssociatedDarwin``).
A dead server or stale stream simply ages out of discovery — liveness *is*
the TTL, exactly the reference's failure-detection story (SURVEY §5).

The robustness tier grows this into a real Lease/Registry
pair: :class:`LeaseManager` heartbeats a TTL'd **fenced** lease
(``Node:{id}`` = ``token:json``, token minted from the global
``Cluster:fence`` INCR counter at every acquire) and
:class:`ClusterRegistry` reads the live lease set peers place streams
against.  The fencing token is the split-brain guard: a zombie whose
lease lapsed during a partition re-acquires with a NEW token, so every
write it fences with its OLD token is rejected (``fset`` → False) and it
must release the streams it thinks it still owns instead of
double-serving them.
"""

from __future__ import annotations

import asyncio
import json
import time

from .. import obs

SERVER_TTL_SEC = 15          # EasyRedisHandler.cpp:177
STREAM_TTL_SEC = 150         # EasyRedisHandler.cpp:272
TICK_SEC = 5                 # RunServer.cpp:642

#: global monotonic fencing-token counter (INCR — strictly increasing
#: across every node, so "newer claim" is a total order)
FENCE_COUNTER_KEY = "Cluster:fence"
#: per-node lease key prefix (fenced value: ``token:json-meta``)
NODE_KEY_PREFIX = "Node:"


class LeaseManager:
    """One server's TTL'd, fenced lease in Redis.

    ``acquire`` mints a fresh fencing token and writes the lease;
    ``heartbeat`` re-asserts the TTL while the stored token is still
    ours, and on observed loss (TTL expiry during a partition, injected
    ``lease_loss`` fault) counts ``cluster_lease_lost_total`` and
    re-acquires with a NEW token — from that moment every claim fenced
    with the old token is stale by construction."""

    def __init__(self, redis, node_id: str, *, ttl_sec: float = 5.0,
                 meta: dict | None = None, events=None):
        self.redis = redis
        self.node_id = node_id
        self.ttl_sec = max(1, int(round(ttl_sec)))
        self.meta = dict(meta or {})
        self.token: int | None = None
        self.acquired_at = 0.0
        self.losses = 0
        self._events = events if events is not None else obs.EVENTS

    @property
    def key(self) -> str:
        return f"{NODE_KEY_PREFIX}{self.node_id}"

    def payload(self) -> str:
        return json.dumps({"node": self.node_id, **self.meta},
                          separators=(",", ":"))

    async def acquire(self) -> int:
        self.token = int(await self.redis.incr(FENCE_COUNTER_KEY))
        await self.redis.fset(self.key, self.token, self.payload(),
                              ttl=self.ttl_sec)
        self.acquired_at = time.monotonic()
        obs.CLUSTER_LEASE_ACQUIRED.inc()
        self._events.emit("cluster.lease_acquire", node=self.node_id,
                          token=self.token)
        return self.token

    async def heartbeat(self) -> bool:
        """Re-assert the lease TTL; returns False when the lease was
        found lost/stolen (a fresh one has been re-acquired — the caller
        must treat its pre-loss stream claims as stale)."""
        if self.token is None:
            await self.acquire()
            return False
        from ..resilience import INJECTOR
        if INJECTOR.active and INJECTOR.lease_loss():
            await self.redis.delete(self.key)   # simulated TTL expiry
        cur = await self.redis.fget(self.key)
        if cur is None or cur[0] != self.token:
            self.losses += 1
            obs.CLUSTER_LEASE_LOST.inc()
            self._events.emit("cluster.lease_lost", level="warn",
                              node=self.node_id)
            await self.acquire()
            return False
        await self.redis.fset(self.key, self.token, self.payload(),
                              ttl=self.ttl_sec)
        obs.CLUSTER_LEASE_RENEWALS.inc()
        return True

    async def release(self) -> None:
        if self.token is not None:
            await self.redis.fdel(self.key, self.token)
            self.token = None


class ClusterRegistry:
    """Read side of the lease set: the live node list placement runs
    over.  A node is alive iff its ``Node:{id}`` lease still exists —
    failure detection IS the TTL, no extra gossip."""

    @staticmethod
    async def live_nodes(redis) -> dict[str, dict]:
        """``node_id -> {"token": int, **meta}`` for every live lease."""
        from .redis_client import scan_fenced
        out: dict[str, dict] = {}
        for key, (token, payload) in \
                (await scan_fenced(redis, NODE_KEY_PREFIX)).items():
            try:
                meta = json.loads(payload)
            except ValueError:
                continue
            if not isinstance(meta, dict):
                continue            # corrupt lease payload: skip it
            node = str(meta.get("node") or key[len(NODE_KEY_PREFIX):])
            meta["token"] = token
            out[node] = meta
        return out


class PresenceService:
    def __init__(self, redis, server_id: str, *, ip: str, rtsp_port: int,
                 http_port: int, tick_sec: float = TICK_SEC):
        self.redis = redis
        self.server_id = server_id
        self.ip = ip
        self.rtsp_port = rtsp_port
        self.http_port = http_port
        self.tick_sec = tick_sec
        self.load = 0
        self._streams: set[str] = set()
        self._task: asyncio.Task | None = None
        self.ticks = 0

    @property
    def server_key(self) -> str:
        return f"EasyDarwin:{self.server_id}"

    # -- assertion ---------------------------------------------------------
    async def assert_presence(self) -> None:
        await self.redis.hset(self.server_key, {
            "IP": self.ip, "RTSP": str(self.rtsp_port),
            "HTTP": str(self.http_port), "Load": str(self.load)})
        await self.redis.expire(self.server_key, SERVER_TTL_SEC)
        for name in list(self._streams):
            key = f"Live:{name}"
            await self.redis.hset(key, {
                "Server": self.server_id, "IP": self.ip,
                "RTSP": str(self.rtsp_port)})
            await self.redis.expire(key, STREAM_TTL_SEC)
        self.ticks += 1

    def add_stream(self, name: str) -> None:
        self._streams.add(name.strip("/"))

    async def remove_stream(self, name: str) -> None:
        name = name.strip("/")
        self._streams.discard(name)
        await self.redis.delete(f"Live:{name}")

    def set_load(self, load: int) -> None:
        self.load = load

    async def sync_streams(self, names) -> None:
        """Reconcile the advertised stream set with the live session list."""
        want = {n.strip("/") for n in names}
        for gone in self._streams - want:
            await self.remove_stream(gone)
        self._streams |= want

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        await self.assert_presence()
        self._task = asyncio.create_task(self._loop(), name="presence")

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        await self.redis.delete(self.server_key)
        for name in list(self._streams):
            await self.remove_stream(name)

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.tick_sec)
            try:
                await self.assert_presence()
            except Exception:
                pass                     # redis gone: keep trying (reconnect)

    # -- discovery (CMS side) ---------------------------------------------
    @staticmethod
    async def list_servers(redis) -> list[dict]:
        out = []
        for key in await redis.keys("EasyDarwin:*"):
            h = await redis.hgetall(key)
            if h:
                h["Id"] = key.split(":", 1)[1]
                out.append(h)
        return out

    @staticmethod
    async def pick_least_loaded(redis) -> dict | None:
        servers = await PresenceService.list_servers(redis)
        if not servers:
            return None
        return min(servers, key=lambda h: int(h.get("Load", "0") or 0))

    @staticmethod
    async def find_stream(redis, name: str) -> dict | None:
        h = await redis.hgetall(f"Live:{name.strip('/')}")
        return h or None
