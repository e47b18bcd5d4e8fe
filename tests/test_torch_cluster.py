"""The port's cluster building blocks against the reference's
``easydarwin_tpu.cluster``, with the same seeded numpy inputs into both:

* ``InMemoryRedis``: TTLs on a fake clock (hashes, strings, INCR, fenced
  records) answer the same at every step;
* RESP: the port's ``AsyncRedis`` against the reference's
  ``MiniRedisServer`` and the reference's client against the port's
  server, each pair's replies equal to the reference pair's; the fenced
  and lease ops over the wire; the timeout and the transparent
  reconnect, with every socket closed before a ``wait_closed``;
* presence: the least-loaded pick and the ``Live:`` records' TTL;
* ``HashRing`` and ``PlacementService``: the same owners, ranks and
  weighted vnode counts over seeded node sets, minimal movement, the
  same sticky resolution and redirect edge;
* the pull envelope: the same backoff delays for the same seed, and the
  breaker's transitions under one seeded event sequence;
* ``LoadTracker``: the same samples from the same counts and clock, and
  ``quantize`` equal; the boot self-bench scores the host relay loop;
* ``tools/metrics_lint``: ``lint_cluster`` and ``lint`` pass on the
  port's registry and event schema.
"""

import asyncio
import json
import pathlib
import sys

import numpy as np
import pytest

from easydarwin_tpu import obs as ref_obs
from easydarwin_tpu.cluster import capacity as ref_capacity
from easydarwin_tpu.cluster import placement as ref_placement
from easydarwin_tpu.cluster import presence as ref_presence
from easydarwin_tpu.cluster import pull as ref_pull
from easydarwin_tpu.cluster import redis_client as ref_redis
from easydarwin_tpu_torch import obs
from easydarwin_tpu_torch.cluster import capacity, placement, presence, pull
from easydarwin_tpu_torch.cluster import redis_client as port_redis

REDIS = {"ref": ref_redis, "port": port_redis}


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ------------------------------------------------------------ InMemoryRedis
async def test_inmemory_redis_ttls_match_on_a_fake_clock():
    rng = np.random.default_rng(101)
    clock = Clock()
    fakes = [ref_redis.InMemoryRedis(clock=clock),
             port_redis.InMemoryRedis(clock=clock)]
    keys = [f"EasyDarwin:s{i}" for i in range(6)] + \
        [f"Own:live/c{i}" for i in range(6)]
    for step in range(120):
        op = int(rng.integers(7))
        key = keys[int(rng.integers(len(keys)))]
        ttl = int(rng.integers(1, 30))
        tok = int(rng.integers(1, 50))
        answers = []
        for r in fakes:
            if op == 0:
                await r.hset(key, {"Load": str(ttl), "IP": "10.0.0.1"})
                await r.expire(key, ttl)
                got = await r.hgetall(key)
            elif op == 1:
                await r.set(key, f"v{tok}", ex=ttl)
                got = await r.get(key)
            elif op == 2:
                got = (await r.fset(key, tok, '{"node":"a"}', ttl=ttl),
                       await r.fget(key))
            elif op == 3:
                got = await r.fdel(key, tok)
            elif op == 4:
                got = await r.incr("Cluster:fence")
            elif op == 5:
                got = await r.ttl(key)
            else:
                got = sorted(await r.keys("*"))
            answers.append(got)
        assert answers[0] == answers[1], (step, op, answers)
        clock.t += float(rng.uniform(0.0, 3.0))
    assert sorted(await fakes[0].keys("*")) == \
        sorted(await fakes[1].keys("*"))


def test_split_fenced_matches_the_reference():
    for raw in (None, b"7:{}", "12:a:b", "x:1", "3", b"", "0:", "07:p"):
        assert port_redis.split_fenced(raw) == ref_redis.split_fenced(raw)
    assert port_redis.FENCE_SET_LUA == ref_redis.FENCE_SET_LUA
    assert port_redis.FENCE_DEL_LUA == ref_redis.FENCE_DEL_LUA
    for args in (("SET", "k", 1), ("EVAL", "s", 1, "k", 2.5), ("GET", b"x")):
        assert port_redis.encode_command(*args) == \
            ref_redis.encode_command(*args)


# ----------------------------------------------------------------- RESP
async def _session(client_mod, server_mod) -> list:
    """The reference test's command surface, one client against one
    server; every reply in order."""
    srv = server_mod.MiniRedisServer()
    await srv.start()
    out = []
    try:
        c = client_mod.AsyncRedis("127.0.0.1", srv.port)
        out.append(await c.ping())
        await c.hset("k", {"a": "1", "b": "2"})
        out.append(await c.hgetall("k"))
        await c.expire("k", 100)
        out.append(await c.execute("TTL", "k") > 90)
        out.append(await c.keys("k*"))
        out.append(await c.pipeline([("SET", "x", "v"), ("GET", "x")]))
        await c.delete("k")
        out.append(await c.keys("k*"))
        with pytest.raises(client_mod.RedisError):
            await c.execute("BOGUSCMD")
        # the fenced and lease surface
        out.append(await c.setnx("lock", "a"))
        out.append(await c.setnx("lock", "b"))
        out.append([await c.incr("fence") for _ in range(3)])
        out.append(await c.fset("Own:x", 5, "n=a", ttl=100))
        out.append(await c.fget("Own:x"))
        out.append(await c.fset("Own:x", 4, "n=zombie"))
        out.append(await c.fget("Own:x"))
        out.append(await c.fdel("Own:x", 4))
        out.append(await c.fdel("Own:x", 5))
        out.append(await c.fget("Own:x"))
        await c.set("tmp", "v", ex=100)
        out.append(await c.execute("TTL", "tmp") > 90)
        out.append(await client_mod.scan_fenced(c, "Own:"))
        await c.close()
    finally:
        await asyncio.wait_for(srv.stop(), 5)
    return out


@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
async def test_resp_replies_equal_the_reference_pair(client, server):
    want = await _session(ref_redis, ref_redis)
    got = await _session(REDIS[client], REDIS[server])
    assert got == want
    assert want[0] is True and want[6] is True and want[7] is False
    assert want[9] is True and want[10] == (5, "n=a") and want[11] is False


async def test_fenced_records_written_over_resp_read_back_by_both():
    """A fenced record a port client writes through the reference's
    server reads back the same through the reference's client, and a
    newer token from it fences the port client out."""
    srv = ref_redis.MiniRedisServer()
    await srv.start()
    try:
        pc = port_redis.AsyncRedis("127.0.0.1", srv.port)
        rc = ref_redis.AsyncRedis("127.0.0.1", srv.port)
        assert await pc.fset("Ckpt:live/m", 9, '{"v":1}', ttl=30)
        assert await rc.fget("Ckpt:live/m") == (9, '{"v":1}')
        assert await rc.fset("Ckpt:live/m", 11, '{"v":2}')
        assert not await pc.fset("Ckpt:live/m", 9, '{"v":3}')
        assert await pc.fget("Ckpt:live/m") == (11, '{"v":2}')
        assert await pc.incr(presence.FENCE_COUNTER_KEY) == 1
        assert await rc.incr(ref_presence.FENCE_COUNTER_KEY) == 2
        await pc.close()
        await rc.close()
    finally:
        await asyncio.wait_for(srv.stop(), 5)


async def test_async_redis_timeout_and_reconnect():
    """A server that accepts and never replies: the per-command timeout
    surfaces as ``RedisTimeout`` after the one retry, both attempts
    counted; a stale connection is retried once on a fresh socket.  The
    blackhole's connections are closed before ``wait_closed`` (since
    Python 3.12 it waits for every connection a handler holds)."""
    release = asyncio.Event()
    held = []

    async def _blackhole(reader, writer):
        held.append(writer)
        try:
            await reader.read(1 << 16)
            await release.wait()
        except (asyncio.CancelledError, ConnectionError):
            pass
        finally:
            writer.close()

    hung = await asyncio.start_server(_blackhole, "127.0.0.1", 0)
    port = hung.sockets[0].getsockname()[1]
    errs = obs.REDIS_ERRORS.value()
    c = port_redis.AsyncRedis("127.0.0.1", port, timeout=0.2)
    with pytest.raises(port_redis.RedisTimeout):
        await c.ping()
    assert obs.REDIS_ERRORS.value() == errs + 2
    assert len(held) == 2            # the first socket and the retry's
    release.set()
    for w in held:
        w.close()
    hung.close()
    await asyncio.wait_for(hung.wait_closed(), 5)

    srv = port_redis.MiniRedisServer()
    await srv.start()
    try:
        c2 = port_redis.AsyncRedis("127.0.0.1", srv.port)
        assert await c2.ping()
        c2._w.close()                   # the peer's idle timeout
        await asyncio.sleep(0.05)
        rt = port_redis.ROUNDTRIPS.mark()
        assert await c2.ping()          # the transparent reconnect
        assert port_redis.ROUNDTRIPS.delta_since(rt)[0] >= 1
        # a client still connected does not hold the server's stop
        assert await c2.ping()
    finally:
        await asyncio.wait_for(srv.stop(), 5)
        await c2.close()


# ------------------------------------------------------------- presence
async def test_presence_least_loaded_and_stream_ttl_match():
    rng = np.random.default_rng(7)
    loads = [int(x) for x in rng.permutation(20)[:6]]
    picks, finds = [], []
    for pkg, red in ((ref_presence, ref_redis), (presence, port_redis)):
        clock = Clock()
        r = red.InMemoryRedis(clock=clock)
        svcs = []
        for i, load in enumerate(loads):
            p = pkg.PresenceService(r, f"srv-{i}", ip=f"10.0.0.{i + 1}",
                                    rtsp_port=554, http_port=8000)
            p.set_load(load)
            p.add_stream(f"/live/cam{i}")
            await p.assert_presence()
            svcs.append(p)
        pick = await pkg.PresenceService.pick_least_loaded(r)
        found = await pkg.PresenceService.find_stream(r, "live/cam2")
        clock.t = 20.0                  # past the server TTL
        picks.append((pick, await pkg.PresenceService.pick_least_loaded(r)))
        await svcs[1].remove_stream("/live/cam1")
        clock.t = 151.0                 # past the stream TTL
        finds.append((found, await pkg.PresenceService.find_stream(
            r, "live/cam2"), await r.keys("*")))
    assert picks[0] == picks[1]
    assert picks[1][0]["Id"] == f"srv-{loads.index(min(loads))}"
    assert picks[1][1] is None
    assert finds[0] == finds[1] and finds[1][0]["Server"] == "srv-2"
    assert finds[1][1] is None and finds[1][2] == []


# ------------------------------------------------------------ placement
def _node_sets(rng, n_sets: int):
    for _ in range(n_sets):
        n = int(rng.integers(2, 9))
        names = [f"n{int(x)}" for x in rng.choice(64, n, replace=False)]
        caps = {m: float(2 ** int(rng.integers(8, 16))) for m in names}
        yield names, caps


def test_hash_ring_owners_ranks_and_weights_equal_the_reference():
    rng = np.random.default_rng(2024)
    paths = [f"/live/cam{i}" for i in range(150)]
    for names, caps in _node_sets(rng, 12):
        for c in (None, caps):
            got = placement.HashRing(names, capacities=c)
            want = ref_placement.HashRing(names, capacities=c)
            assert got.vnode_counts() == want.vnode_counts()
            assert [got.rank(p) for p in paths] == \
                [want.rank(p) for p in paths]
        # equal capacities reproduce the unweighted ring
        eq = placement.HashRing(names, capacities=dict.fromkeys(names, 4.0))
        plain = placement.HashRing(list(reversed(names)))
        assert all(eq.owner(p) == plain.owner(p) for p in paths)


def test_hash_ring_minimal_movement_on_seeded_joins_and_leaves():
    rng = np.random.default_rng(11)
    paths = [f"/live/s{i}" for i in range(300)]
    for names, _caps in _node_sets(rng, 10):
        ring = placement.HashRing(names)
        joined = placement.HashRing(names + ["joiner"])
        moved = [p for p in paths if joined.owner(p) != ring.owner(p)]
        # only the joiner takes paths, and about a 1/(n+1) share
        assert all(joined.owner(p) == "joiner" for p in moved)
        assert 0 < len(moved) < 2 * len(paths) // len(names)
        gone = names[int(rng.integers(len(names)))]
        left = placement.HashRing([n for n in names if n != gone])
        for p in paths:
            if ring.owner(p) != gone:
                assert left.owner(p) == ring.owner(p)
            else:
                assert left.owner(p) == \
                    [n for n in ring.rank(p) if n != gone][0]
        assert [left.owner(p) for p in paths] == \
            [ref_placement.HashRing([n for n in names if n != gone])
             .owner(p) for p in paths]


async def test_placement_service_resolution_equals_the_reference():
    rng = np.random.default_rng(5)
    names = ["a", "b", "c", "d"]
    utils = {n: round(float(rng.uniform(0, 1)), 3) for n in names}
    caps = {n: float(2 ** int(rng.integers(10, 14))) for n in names}
    nodes = {n: {"ip": f"10.0.0.{i}", "rtsp": 554 + i, "http": 80 + i,
                 "util": utils[n], "cap": caps[n]}
             for i, n in enumerate(names)}
    paths = [f"/live/p{i}" for i in range(40)]
    results = []
    for pkg, red in ((ref_placement, ref_redis), (placement, port_redis)):
        r = red.InMemoryRedis()
        svc = pkg.PlacementService(r, "a")
        await r.fset(pkg.own_key("/live/p3"), 4, '{"node":"c"}')
        await r.fset(pkg.own_key("/live/p4"), 4, '{"node":"zz"}')
        await r.fset(pkg.own_key("/live/p5"), 4, '[1, 2]')
        res = [await svc.resolve(p, nodes) for p in paths]
        succ = [svc.successors(p, nodes) for p in paths]
        edges = [svc.edge_for(p, nodes, client_key=f"10.1.0.{i}:5{i}",
                              exclude=("a",), high_water=0.6)
                 for i, p in enumerate(paths)]
        ring = svc.ring(nodes).vnode_counts()
        cmd = svc.claim_command("/live/p9", 12, ttl=30, extra={"1": [0, 4]})
        results.append((res, succ, edges, ring, cmd))
    assert results[0] == results[1]
    res, _succ, edges, _ring, _cmd = results[1]
    assert res[3][0] == "c"              # a live claimant is sticky
    assert res[4][0] != "zz"             # a dead one is replaced
    assert all(e is None or utils[e] < 0.6 for e in edges)


async def test_placement_claims_fence_and_count_as_the_reference():
    for pkg, red, o in ((ref_placement, ref_redis, ref_obs),
                        (placement, port_redis, obs)):
        r = red.InMemoryRedis()
        a, b = pkg.PlacementService(r, "a"), pkg.PlacementService(r, "b")
        assert await a.claim("/live/x", 3)
        assert await b.claim("/live/x", 9)
        rej = o.CLUSTER_LEASE_FENCE_REJECTED.value()
        assert not await a.claim("/live/x", 3)
        assert o.CLUSTER_LEASE_FENCE_REJECTED.value() == rej + 1
        assert await b.claimant("/live/x") == "b"
        assert not await a.release("/live/x", 3)
        assert await b.release("/live/x", 9)
        assert await a.claimant("/live/x") is None


# --------------------------------------------------------- pull envelope
def test_backoff_delays_equal_the_reference_for_the_same_seed():
    rng = np.random.default_rng(99)
    for _ in range(8):
        kw = dict(backoff_ms=float(rng.integers(50, 400)),
                  backoff_cap_ms=float(rng.integers(500, 6000)),
                  jitter_frac=float(rng.uniform(0, 0.5)))
        seed = int(rng.integers(1 << 16))
        got = pull.Backoff(pull.PullConfig(**kw), seed=seed)
        want = ref_pull.Backoff(ref_pull.PullConfig(**kw), seed=seed)
        for i in range(12):
            if i == 7:
                got.reset()
                want.reset()
            assert got.next_delay() == want.next_delay()


def test_breaker_transitions_equal_the_reference():
    rng = np.random.default_rng(3)
    clock = Clock()
    got = pull.CircuitBreaker(3, 0.8, clock=clock)
    want = ref_pull.CircuitBreaker(3, 0.8, clock=clock)
    trail = []
    for _ in range(200):
        ev = int(rng.integers(3))
        if ev == 0:
            r = (got.allow(), want.allow())
        elif ev == 1:
            r = (got.failure(), want.failure())
        else:
            got.success()
            want.success()
            r = (None, None)
        assert r[0] == r[1]
        assert (got.state, got.failures, got.opened) == \
            (want.state, want.failures, want.opened)
        trail.append(got.state)
        clock.t += float(rng.uniform(0, 1.0))
    assert {"closed", "open", "half_open"} <= set(trail)


# ------------------------------------------------------------- capacity
def test_load_tracker_samples_equal_the_reference():
    rng = np.random.default_rng(8)
    clock = Clock()
    count = [0]
    subs = [0]
    kw = dict(clock=clock, source=lambda: count[0],
              subscribers=lambda: subs[0])
    got = capacity.LoadTracker(5000.0, **kw)
    want = ref_capacity.LoadTracker(5000.0, **kw)
    for _ in range(40):
        count[0] += int(rng.integers(0, 8000))
        subs[0] = int(rng.integers(0, 64))
        clock.t += float(rng.uniform(0.3, 1.2))
        assert got.sample() == want.sample()
        assert got.last_util == want.last_util
    assert obs.CLUSTER_CAPACITY_SCORE.value() == \
        ref_obs.CLUSTER_CAPACITY_SCORE.value() == capacity.quantize(5000.0)
    for s in (0.0, 0.5, 1.0, 3.0, 1500.0, 1e6, 123456.7):
        assert capacity.quantize(s) == ref_capacity.quantize(s)


def test_self_bench_scores_the_host_relay_loop():
    score = capacity.self_bench(0.05, cache=False)
    assert score > 1000.0               # relayed packets a second
    assert capacity.quantize(score) == ref_capacity.quantize(score)


# ------------------------------------------------------------------- lint
def test_cluster_lint_passes_on_the_port_registry():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "tools"))
    import metrics_lint
    from easydarwin_tpu_torch.obs import events
    assert metrics_lint.lint_cluster(obs.REGISTRY, events.SCHEMA) == []
    assert metrics_lint.lint(obs.REGISTRY) == []
    assert json.loads(json.dumps(sorted(events.SCHEMA))) == \
        sorted(ref_obs.events.SCHEMA)
