"""Redis client (RESP2) and an in-memory fake with TTLs.

The reference's ``EasyRedisClient`` (hiredis behind a C++ wrapper:
connect with a timeout, a command, a pipeline), as a small asyncio RESP2
codec.  ``InMemoryRedis`` serves the commands the cluster tier uses
(hset/hgetall/expire/setex/del/keys/ttl/get/set/setnx/incr/ping and the
fenced lease ops below) on an injectable clock, the hermetic backend of
the tests; ``MiniRedisServer`` puts it behind real RESP sockets, so the
wire codec runs without a Redis installation.  Both are the reference's,
so a node of either package can share one of them.

Every ``AsyncRedis`` command runs under a per-command timeout that
covers connect, write and read: a hung or partitioned Redis raises
:class:`RedisTimeout` instead of wedging its caller.  A failed roundtrip
is retried ONCE on a fresh socket (the connection is taken for stale,
not the server for dead); each failure counts ``redis_errors_total``,
and the caller degrades (a lease it cannot renew ages out and a peer
takes over).

Fencing (the split-brain guard): a fenced record is the string
``"<token>:<payload>"``.  :meth:`AsyncRedis.fset` writes only when no
NEWER token holds the key, :meth:`AsyncRedis.fdel` deletes only a same or
older token, both atomic on the server through ``EVAL``: a real Redis
runs the Lua, ``InMemoryRedis`` recognises the two exact scripts and runs
their atomic equivalents, so one client code path serves both.

``MiniRedisServer.stop`` closes its clients' connections before it waits
for the listener: since Python 3.12 ``Server.wait_closed`` waits for
every connection a handler still holds.
"""

from __future__ import annotations

import asyncio
import fnmatch
import time
from typing import Any


class RedisError(Exception):
    pass


class RedisTimeout(RedisError):
    """A command exceeded its per-command timeout (a hung or partitioned
    Redis); the connection has been dropped."""


#: fenced SET: write "<token>:<payload>" unless the stored token is newer.
#: Returns 1 on write, 0 on fence rejection (a newer owner holds the key).
FENCE_SET_LUA = (
    "local cur = redis.call('GET', KEYS[1]) "
    "if cur then "
    "local t = tonumber(string.match(cur, '^(%d+):')) "
    "if t and t > tonumber(ARGV[1]) then return 0 end end "
    "redis.call('SET', KEYS[1], ARGV[1] .. ':' .. ARGV[2]) "
    "if tonumber(ARGV[3]) > 0 then "
    "redis.call('EXPIRE', KEYS[1], ARGV[3]) end "
    "return 1")

#: fenced DEL: delete only when the stored token is same-or-older than
#: ours (a release must never destroy a NEWER claimant's record).
FENCE_DEL_LUA = (
    "local cur = redis.call('GET', KEYS[1]) "
    "if not cur then return 1 end "
    "local t = tonumber(string.match(cur, '^(%d+):')) "
    "if t and t > tonumber(ARGV[1]) then return 0 end "
    "redis.call('DEL', KEYS[1]) "
    "return 1")


def split_fenced(raw) -> tuple[int, str] | None:
    """``"<token>:<payload>"`` → ``(token, payload)``; None when the
    value is missing or not fenced-formatted."""
    if raw is None:
        return None
    if isinstance(raw, bytes):
        raw = raw.decode()
    tok, sep, payload = str(raw).partition(":")
    if not sep or not tok.isdigit():
        return None
    return int(tok), payload


async def scan_fenced(redis, prefix: str) -> dict[str, tuple[int, str]]:
    """Every live fenced record under ``prefix`` as ``key -> (token,
    payload)``: one KEYS and one pipelined GET batch, two roundtrips
    whatever the record count.  The lease registry, the migration scan
    and the fleet aggregate all read through here."""
    keys = await redis.keys(f"{prefix}*")
    if not keys:
        return {}
    raws = await redis.pipeline([("GET", k) for k in keys])
    out: dict[str, tuple[int, str]] = {}
    for key, raw in zip(keys, raws):
        cur = split_fenced(raw)
        if cur is not None:
            out[key] = cur
    return out


def _count_error() -> None:
    from .. import obs
    obs.REDIS_ERRORS.inc()


class _RoundtripStats:
    """Process-wide Redis roundtrip accounting: every ``AsyncRedis``
    batch counts one roundtrip and its wall time here, so the cluster
    tick can hand the wake ledger its roundtrips and their time a tick.
    Plain int adds on the event-loop thread."""

    __slots__ = ("count", "ns")

    def __init__(self):
        self.count = 0
        self.ns = 0

    def delta_since(self, mark: tuple[int, int]) -> tuple[int, int]:
        return self.count - mark[0], self.ns - mark[1]

    def mark(self) -> tuple[int, int]:
        return (self.count, self.ns)


#: the one roundtrip ledger every AsyncRedis in the process feeds
ROUNDTRIPS = _RoundtripStats()


# --------------------------------------------------------------- wire codec
def encode_command(*args) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        elif isinstance(a, (int, float)):
            a = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


async def read_reply(reader: asyncio.StreamReader) -> Any:
    line = (await reader.readline()).rstrip(b"\r\n")
    if not line:
        raise RedisError("connection closed")
    t, rest = line[:1], line[1:]
    if t == b"+":
        return rest.decode()
    if t == b"-":
        raise RedisError(rest.decode())
    if t == b":":
        return int(rest)
    if t == b"$":
        n = int(rest)
        if n < 0:
            return None
        data = await reader.readexactly(n + 2)
        return data[:-2]
    if t == b"*":
        n = int(rest)
        if n < 0:
            return None
        return [await read_reply(reader) for _ in range(n)]
    raise RedisError(f"bad RESP type {t!r}")


class AsyncRedis:
    """A minimal asyncio Redis connection with pipelining."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout: float = 3.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._r: asyncio.StreamReader | None = None
        self._w: asyncio.StreamWriter | None = None
        #: one roundtrip in flight at a time: callers sharing this
        #: connection must not interleave writes and reads, or replies
        #: pair with the wrong commands
        self._lock = asyncio.Lock()

    async def connect(self) -> None:
        self._r, self._w = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), self.timeout)

    async def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._r = self._w = None

    @property
    def connected(self) -> bool:
        return self._w is not None and not self._w.is_closing()

    async def _roundtrip(self, commands: list[tuple]) -> list[Any]:
        if not self.connected:
            await self.connect()
        self._w.write(b"".join(encode_command(*c) for c in commands))
        await self._w.drain()
        return [await read_reply(self._r) for _ in commands]

    async def _guarded(self, commands: list[tuple]) -> list[Any]:
        """One roundtrip under the per-command timeout, with ONE
        transparent reconnect: a stale or hung connection is retried on
        a fresh socket, a second failure surfaces.  An error reply
        (``-ERR ...``) is protocol-level and never retried."""
        async with self._lock:
            for attempt in (0, 1):
                t0 = time.monotonic_ns()
                try:
                    replies = await asyncio.wait_for(
                        self._roundtrip(commands), self.timeout)
                    ROUNDTRIPS.count += 1
                    ROUNDTRIPS.ns += time.monotonic_ns() - t0
                    return replies
                except RedisError:
                    # an error reply mid-batch leaves the remaining
                    # replies unread in the socket: keeping the
                    # connection would pair them with the NEXT commands
                    await self.close()
                    raise
                except asyncio.CancelledError:
                    # the command was written, so its unread reply would
                    # pair with the next command: drop the connection
                    await self.close()
                    raise
                except asyncio.TimeoutError:
                    # a timed-out command cost its caller the whole
                    # timeout, which the tick's accounting must show
                    ROUNDTRIPS.count += 1
                    ROUNDTRIPS.ns += time.monotonic_ns() - t0
                    _count_error()
                    await self.close()
                    if attempt:
                        raise RedisTimeout(
                            f"redis command timed out after "
                            f"{self.timeout}s")
                except (ConnectionError, asyncio.IncompleteReadError,
                        OSError) as e:
                    ROUNDTRIPS.count += 1
                    ROUNDTRIPS.ns += time.monotonic_ns() - t0
                    _count_error()
                    await self.close()
                    if attempt:
                        raise RedisError(
                            f"redis connection failed: {e}") from e
            raise RedisError("unreachable")

    async def execute(self, *args) -> Any:
        return (await self._guarded([args]))[0]

    async def pipeline(self, commands: list[tuple]) -> list[Any]:
        return await self._guarded(list(commands))

    # convenience
    async def ping(self) -> bool:
        return await self.execute("PING") == "PONG"

    async def hset(self, key: str, mapping: dict) -> None:
        flat: list = []
        for k, v in mapping.items():
            flat += [k, v]
        await self.execute("HSET", key, *flat)

    async def hgetall(self, key: str) -> dict:
        raw = await self.execute("HGETALL", key) or []
        it = iter(raw)
        return {k.decode() if isinstance(k, bytes) else k:
                v.decode() if isinstance(v, bytes) else v
                for k, v in zip(it, it)}

    async def expire(self, key: str, seconds: int) -> None:
        await self.execute("EXPIRE", key, seconds)

    async def delete(self, key: str) -> None:
        await self.execute("DEL", key)

    async def keys(self, pattern: str) -> list[str]:
        raw = await self.execute("KEYS", pattern) or []
        return [k.decode() if isinstance(k, bytes) else k for k in raw]

    async def get(self, key: str) -> str | None:
        raw = await self.execute("GET", key)
        return raw.decode() if isinstance(raw, bytes) else raw

    async def set(self, key: str, value: str, *, ex: int = 0) -> None:
        if ex > 0:
            await self.execute("SET", key, value, "EX", ex)
        else:
            await self.execute("SET", key, value)

    async def setnx(self, key: str, value: str) -> bool:
        return bool(await self.execute("SETNX", key, value))

    async def incr(self, key: str) -> int:
        return int(await self.execute("INCR", key))

    # -- fenced lease ops (split-brain guard) ------------------------------
    async def fset(self, key: str, token: int, payload: str,
                   ttl: int = 0) -> bool:
        """Write ``token:payload`` unless a NEWER token holds ``key``;
        True on write, False on fence rejection (atomic via EVAL)."""
        return bool(await self.execute(
            "EVAL", FENCE_SET_LUA, 1, key, token, payload, ttl))

    async def fget(self, key: str) -> tuple[int, str] | None:
        return split_fenced(await self.execute("GET", key))

    async def fdel(self, key: str, token: int) -> bool:
        """Delete ``key`` only when its stored token is same-or-older;
        True when the key is gone afterwards."""
        return bool(await self.execute(
            "EVAL", FENCE_DEL_LUA, 1, key, token))


# ------------------------------------------------------------ in-memory fake
class InMemoryRedis:
    """An async fake with TTL semantics on an injectable clock."""

    def __init__(self, clock=None):
        self._clock = clock or time.monotonic
        self._data: dict[str, Any] = {}
        self._expiry: dict[str, float] = {}

    # -- clock/TTL ---------------------------------------------------------
    def _alive(self, key: str) -> bool:
        exp = self._expiry.get(key)
        if exp is not None and self._clock() >= exp:
            self._data.pop(key, None)
            self._expiry.pop(key, None)
            return False
        return key in self._data

    # -- API mirror --------------------------------------------------------
    async def connect(self) -> None:
        pass

    async def close(self) -> None:
        pass

    connected = True

    async def ping(self) -> bool:
        return True

    async def hset(self, key: str, mapping: dict) -> None:
        if not self._alive(key) or not isinstance(self._data.get(key), dict):
            self._data[key] = {}
        self._data[key].update({str(k): str(v) for k, v in mapping.items()})

    async def hgetall(self, key: str) -> dict:
        return dict(self._data.get(key, {})) if self._alive(key) else {}

    async def set(self, key: str, value: str, *, ex: int = 0) -> None:
        self._data[key] = str(value)
        self._expiry.pop(key, None)
        if ex > 0:
            self._expiry[key] = self._clock() + ex

    async def get(self, key: str):
        return self._data.get(key) if self._alive(key) else None

    async def setnx(self, key: str, value: str) -> bool:
        if self._alive(key):
            return False
        await self.set(key, value)
        return True

    async def incr(self, key: str) -> int:
        cur = int(self._data.get(key, "0")) if self._alive(key) else 0
        cur += 1
        self._data[key] = str(cur)
        # a fresh INCR revives an expired key with NO TTL (as Redis does:
        # a stale expiry would reset the counter forever)
        self._expiry.pop(key, None)
        return cur

    # -- fenced lease ops (the EVAL scripts' atomic equivalents) -----------
    async def fset(self, key: str, token: int, payload: str,
                   ttl: int = 0) -> bool:
        cur = split_fenced(await self.get(key))
        if cur is not None and cur[0] > int(token):
            return False
        await self.set(key, f"{int(token)}:{payload}",
                       ex=int(ttl) if ttl else 0)
        return True

    async def fget(self, key: str) -> tuple[int, str] | None:
        return split_fenced(await self.get(key))

    async def fdel(self, key: str, token: int) -> bool:
        cur = split_fenced(await self.get(key))
        if cur is not None and cur[0] > int(token):
            return False
        await self.delete(key)
        return True

    async def expire(self, key: str, seconds: int) -> None:
        if self._alive(key):
            self._expiry[key] = self._clock() + seconds

    async def ttl(self, key: str) -> int:
        if not self._alive(key):
            return -2
        exp = self._expiry.get(key)
        return -1 if exp is None else max(0, int(exp - self._clock()))

    async def delete(self, key: str) -> None:
        self._data.pop(key, None)
        self._expiry.pop(key, None)

    async def keys(self, pattern: str = "*") -> list[str]:
        return [k for k in list(self._data) if self._alive(k)
                and fnmatch.fnmatch(k, pattern)]

    async def pipeline(self, commands: list) -> list:
        return [await self.execute(*c) for c in commands]

    async def execute(self, *args):
        cmd = args[0].upper()
        if cmd == "PING":
            return "PONG"
        if cmd == "HSET":
            key = args[1]
            it = iter(args[2:])
            await self.hset(key, dict(zip(it, it)))
            return len(args[2:]) // 2
        if cmd == "HGETALL":
            d = await self.hgetall(args[1])
            out = []
            for k, v in d.items():
                out += [k.encode(), str(v).encode()]
            return out
        if cmd == "EXPIRE":
            await self.expire(args[1], int(args[2]))
            return 1
        if cmd == "DEL":
            await self.delete(args[1])
            return 1
        if cmd == "KEYS":
            return [k.encode() for k in await self.keys(args[1])]
        if cmd == "SET":
            ex = 0
            rest = [str(a).upper() if isinstance(a, str) else a
                    for a in args[3:]]
            if "EX" in rest:
                ex = int(args[3 + rest.index("EX") + 1])
            if "NX" in rest and self._alive(args[1]):
                return None
            await self.set(args[1], args[2], ex=ex)
            return "OK"
        if cmd == "GET":
            v = await self.get(args[1])
            return None if v is None else str(v).encode()
        if cmd == "TTL":
            return await self.ttl(args[1])
        if cmd == "SETNX":
            return 1 if await self.setnx(args[1], args[2]) else 0
        if cmd == "INCR":
            return await self.incr(args[1])
        if cmd == "EVAL":
            # the two fencing scripts only, run as their atomic
            # equivalents (a real Redis runs the Lua itself)
            script = args[1]
            if script == FENCE_SET_LUA:
                return 1 if await self.fset(
                    args[3], int(args[4]), str(args[5]),
                    int(float(args[6]))) else 0
            if script == FENCE_DEL_LUA:
                return 1 if await self.fdel(args[3], int(args[4])) else 0
            raise RedisError("unsupported EVAL script")
        raise RedisError(f"unsupported command {cmd}")


# --------------------------------------------------------- mini RESP server
class MiniRedisServer:
    """Real RESP sockets in front of an ``InMemoryRedis``."""

    def __init__(self, backend: InMemoryRedis | None = None):
        self.backend = backend or InMemoryRedis()
        self._server: asyncio.AbstractServer | None = None
        self._writers: set[asyncio.StreamWriter] = set()
        self.port: int | None = None

    async def start(self, host="127.0.0.1", port=0) -> None:
        self._server = await asyncio.start_server(self._client, host, port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            for w in list(self._writers):
                w.close()
            await self._server.wait_closed()

    async def _client(self, reader, writer) -> None:
        self._writers.add(writer)
        try:
            while True:
                line = (await reader.readline()).rstrip(b"\r\n")
                if not line:
                    break
                if line[:1] != b"*":
                    break
                n = int(line[1:])
                args = []
                for _ in range(n):
                    hdr = (await reader.readline()).rstrip(b"\r\n")
                    ln = int(hdr[1:])
                    data = await reader.readexactly(ln + 2)
                    args.append(data[:-2].decode())
                try:
                    res = await self.backend.execute(*args)
                    writer.write(_encode_reply(res))
                except RedisError as e:
                    writer.write(b"-ERR " + str(e).encode() + b"\r\n")
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()


def _encode_reply(res) -> bytes:
    if res is None:
        return b"$-1\r\n"
    if isinstance(res, str):
        return b"+" + res.encode() + b"\r\n"
    if isinstance(res, int):
        return b":%d\r\n" % res
    if isinstance(res, bytes):
        return b"$%d\r\n%s\r\n" % (len(res), res)
    if isinstance(res, list):
        return b"*%d\r\n" % len(res) + b"".join(_encode_reply(x) for x in res)
    raise RedisError(f"cannot encode {type(res)}")
