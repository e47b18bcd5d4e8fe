"""The port's cluster failover against the reference's
``tests/test_cluster_failover.py``: one counterpart for each of its tier-1
tests, each holding the port's result to the reference package's where
the two can be compared (the same operations on each package's objects,
over the same fake clock and seeded inputs), and:

* a mixed cluster: a ``Ckpt:`` document the reference's
  ``ClusterService`` published is adopted by the port's, and the other
  way round, with equal sessions, SSRCs, rewrite state and bookmarks,
  and the old owner fenced out;
* the two-server kill, migration and gapless e2e, and the cross-server
  pull e2e, with ``device="cpu"`` servers in this process, and the same
  kill through two CLI servers (``utils.cluster_loopback.cluster_kill``,
  the harness of ``chip_smoke.py`` phase 17, at a small size);
* a zombie owner (its cluster partitioned, its data plane serving on)
  fenced out of its data plane once it ticks again: its pusher closed,
  its session gone;
* the ``overload_spoof`` admission: 305 to the edge with headroom (the
  reference's ``edge_for`` names the same edge), 453 when no peer has
  headroom, each a ``cluster.refuse`` event; a plain local file is
  exempt;
* ``cloud_enabled`` presence records, and a server standalone when its
  Redis is unreachable;
* the cluster's fault sites counted under ``fault_injected_total`` by
  site, as the reference's injector counts the same calls.

Every socket wait here has a timeout of its own.
"""

import asyncio
import json
import struct
import time

import numpy as np
import pytest

from easydarwin_tpu import obs as ref_obs
from easydarwin_tpu.cluster import capacity as ref_capacity
from easydarwin_tpu.cluster import placement as ref_placement
from easydarwin_tpu.cluster import presence as ref_presence
from easydarwin_tpu.cluster import pull as ref_pull
from easydarwin_tpu.cluster import redis_client as ref_redis
from easydarwin_tpu.cluster import service as ref_service
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.relay.session import SessionRegistry as RefRegistry
from easydarwin_tpu.resilience import checkpoint as ref_ckpt
from easydarwin_tpu_torch import obs
from easydarwin_tpu_torch.cluster import capacity, placement, presence, pull
from easydarwin_tpu_torch.cluster import redis_client as port_redis
from easydarwin_tpu_torch.cluster import service
from easydarwin_tpu_torch.protocol import rtp
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.relay.session import SessionRegistry
from easydarwin_tpu_torch.resilience import checkpoint as port_ckpt
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.utils.chaos_loopback import _player, _pusher

SDP = ("v=0\r\no=- 1 1 IN IP4 127.0.0.1\r\ns=fo\r\nt=0 0\r\n"
       "m=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
       "a=control:trackID=1\r\n")

#: (package name, presence, placement, pull, redis, service, obs)
PKGS = [("ref", ref_presence, ref_placement, ref_pull, ref_redis,
         ref_service, ref_obs),
        ("port", presence, placement, pull, port_redis, service, obs)]


def _pkt(seq: int) -> bytes:
    return (struct.pack("!BBHII", 0x80, 96, seq & 0xFFFF, seq * 90, 0xFE)
            + bytes([0x65]) + bytes(60))


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _fresh_ledger():
    """Servers and ticks here fill the process-wide wake ledger: reset it
    after each test, so no later test reads their records."""
    yield
    obs.LEDGER.reset()


# --------------------------------------------------------------- lease layer
async def test_lease_acquire_heartbeat_and_expiry():
    seen = []
    for _name, pres, _pl, _pu, red, _svc, _o in PKGS:
        clock = Clock()
        r = red.InMemoryRedis(clock=clock)
        lease = pres.LeaseManager(r, "n1", ttl_sec=5,
                                  meta={"ip": "10.0.0.1"})
        tok = await lease.acquire()
        nodes = await pres.ClusterRegistry.live_nodes(r)
        clock.t = 4.0
        renewed = await lease.heartbeat()
        clock.t = 8.0
        alive = "n1" in await pres.ClusterRegistry.live_nodes(r)
        clock.t = 20.0
        seen.append((tok, nodes, renewed, alive,
                     await pres.ClusterRegistry.live_nodes(r)))
    assert seen[0] == seen[1]
    tok, nodes, renewed, alive, after = seen[1]
    assert tok >= 1 and nodes["n1"] == {"node": "n1", "ip": "10.0.0.1",
                                        "token": tok}
    assert renewed is True and alive and after == {}


async def test_lease_loss_reacquires_with_new_token():
    seen = []
    for _name, pres, _pl, _pu, red, _svc, o in PKGS:
        clock = Clock()
        r = red.InMemoryRedis(clock=clock)
        lease = pres.LeaseManager(r, "n1", ttl_sec=5)
        tok1 = await lease.acquire()
        lost = o.CLUSTER_LEASE_LOST.value()
        clock.t = 10.0
        ok = await lease.heartbeat()
        seen.append((tok1, ok, lease.losses, lease.token,
                     o.CLUSTER_LEASE_LOST.value() - lost,
                     sorted(await pres.ClusterRegistry.live_nodes(r))))
    assert seen[0] == seen[1]
    tok1, ok, losses, tok2, lost, live = seen[1]
    assert ok is False and losses == 1 and lost == 1
    assert tok2 > tok1 and live == ["n1"]


# ----------------------------------------------------------------- fencing
async def test_fencing_rejects_stale_owner_write():
    seen = []
    for _name, _pres, _pl, _pu, red, _svc, _o in PKGS:
        r = red.InMemoryRedis()
        seen.append([await r.fset("Own:live/x", 3, '{"node":"a"}'),
                     await r.fset("Own:live/x", 7, '{"node":"b"}'),
                     await r.fset("Own:live/x", 3, '{"node":"a"}'),
                     await r.fget("Own:live/x"),
                     await r.fdel("Own:live/x", 3),
                     await r.fdel("Own:live/x", 7),
                     await r.fget("Own:live/x")])
    assert seen[0] == seen[1] == [True, True, False, (7, '{"node":"b"}'),
                                  False, True, None]


async def test_placement_claim_fence_rejection_counts():
    seen = []
    for _name, _pres, pl, _pu, red, _svc, o in PKGS:
        r = red.InMemoryRedis()
        a, b = pl.PlacementService(r, "a"), pl.PlacementService(r, "b")
        first = (await a.claim("/live/x", 3), await b.claim("/live/x", 9))
        rej = o.CLUSTER_LEASE_FENCE_REJECTED.value()
        zombie = await a.claim("/live/x", 3)
        seen.append((first, zombie,
                     o.CLUSTER_LEASE_FENCE_REJECTED.value() - rej,
                     await b.claimant("/live/x")))
    assert seen[0] == seen[1] == ((True, True), False, 1, "b")


# ------------------------------------------------------------ consistent hash
def test_hash_ring_deterministic_and_minimal_movement():
    paths = [f"/live/cam{i}" for i in range(200)]
    r3 = placement.HashRing(["a", "b", "c"])
    ref3 = ref_placement.HashRing(["a", "b", "c"])
    assert [r3.owner(p) for p in paths] == [ref3.owner(p) for p in paths]
    assert all(placement.HashRing(["c", "a", "b"]).owner(p) == r3.owner(p)
               for p in paths)
    share = {n: sum(1 for p in paths if r3.owner(p) == n)
             for n in ("a", "b", "c")}
    assert all(v > 20 for v in share.values()), share
    r4 = placement.HashRing(["a", "b", "c", "d"])
    moved = sum(1 for p in paths if r4.owner(p) != r3.owner(p))
    assert 0 < moved < len(paths) // 2, moved
    r2 = placement.HashRing(["a", "b"])
    for p in paths:
        if r3.owner(p) != "c":
            assert r2.owner(p) == r3.owner(p)
        else:
            assert r2.owner(p) == [n for n in r3.rank(p) if n != "c"][0]


async def test_placement_resolve_sticky_then_replaces_dead_owner():
    seen = []
    for _name, pres, pl, _pu, red, _svc, o in PKGS:
        clock = Clock()
        r = red.InMemoryRedis(clock=clock)
        la = pres.LeaseManager(r, "a", ttl_sec=5)
        lb = pres.LeaseManager(r, "b", ttl_sec=5)
        await la.acquire()
        await lb.acquire()
        pb = pl.PlacementService(r, "b")
        await r.fset("Own:live/s", 4, '{"node":"a"}')
        owner, _meta = await pb.resolve("/live/s")
        moves = o.CLUSTER_PLACEMENT_MOVES.value()
        clock.t = 10.0
        await lb.heartbeat()
        owner2, _ = await pb.resolve("/live/s")
        seen.append((owner, owner2,
                     o.CLUSTER_PLACEMENT_MOVES.value() - moves))
    assert seen[0] == seen[1] == ("a", "b", 1)


# ------------------------------------------------------- backoff + breaker
def test_backoff_schedule_deterministic_capped():
    cfg = pull.PullConfig(backoff_ms=100.0, backoff_cap_ms=800.0,
                          jitter_frac=0.25)
    ref_cfg = ref_pull.PullConfig(backoff_ms=100.0, backoff_cap_ms=800.0,
                                  jitter_frac=0.25)
    a = pull.Backoff(cfg, seed=42)
    da = [a.next_delay() for _ in range(6)]
    assert da == [pull.Backoff(cfg, seed=42).next_delay()] + \
        [d for d in da[1:]]
    ref = ref_pull.Backoff(ref_cfg, seed=42)
    assert da == [ref.next_delay() for _ in range(6)]
    for d, want in zip(da, [0.1, 0.2, 0.4, 0.8, 0.8, 0.8]):
        assert want * 0.75 <= d <= want * 1.25, (d, want)
    a.reset()
    assert a.next_delay() <= 0.1 * 1.25
    c = pull.Backoff(pull.PullConfig(backoff_ms=100.0, backoff_cap_ms=800.0,
                                     jitter_frac=0.0))
    assert [c.next_delay() for _ in range(4)] == [0.1, 0.2, 0.4, 0.8]


def test_circuit_breaker_state_machine():
    trails = []
    for mod in (ref_pull, pull):
        clock = Clock()
        br = mod.CircuitBreaker(3, 10.0, clock=clock)
        trail = [br.allow(), br.failure(), br.failure(), br.failure(),
                 (br.state, br.opened), br.allow()]
        clock.t = 9.9
        trail.append(br.allow())
        clock.t = 10.5
        trail += [br.allow(), br.state, br.failure(), (br.state, br.opened)]
        clock.t = 21.0
        trail.append(br.allow())
        br.success()
        trail += [br.state, br.allow()]
        trails.append(trail)
    assert trails[0] == trails[1] == [
        True, False, False, True, ("open", 1), False, False, True,
        "half_open", True, ("open", 2), True, "closed", True]


# ---------------------------------------------------- migration state machine
def _restore_into(registry, log: list):
    def hook(doc):
        log.append(doc)
        for srec in doc.get("sessions", ()):
            registry.find_or_create(srec["path"], srec["sdp"])
        return len(doc.get("sessions", ())), 1
    return hook


async def test_service_migration_adopts_and_zombie_rejected():
    seen = []
    for _name, _pres, _pl, _pu, red, svc_mod, o in PKGS:
        clock = Clock()
        r = red.InMemoryRedis(clock=clock)
        reg_cls = RefRegistry if svc_mod is ref_service else SessionRegistry
        reg_a, reg_b = reg_cls(), reg_cls()
        reg_a.find_or_create("/live/m", SDP)
        restored, released = [], []
        svc_a = svc_mod.ClusterService(
            r, svc_mod.ClusterConfig("a", lease_ttl_sec=5), registry=reg_a,
            on_fence_lost=released.append)
        svc_b = svc_mod.ClusterService(
            r, svc_mod.ClusterConfig("b", lease_ttl_sec=5), registry=reg_b,
            restore_doc=_restore_into(reg_b, restored))
        await svc_a.lease.acquire()
        await svc_b.lease.acquire()
        await svc_a.tick()
        old_tok = svc_a._claims["/live/m"]
        ck = await r.fget(svc_mod.ckpt_key("/live/m"))
        mig = o.CLUSTER_MIGRATIONS.value()
        clock.t = 10.0
        await svc_b.tick()
        new_tok, _ = await r.fget("Own:live/m")
        ck2 = await r.fget(svc_mod.ckpt_key("/live/m"))
        rej = o.CLUSTER_LEASE_FENCE_REJECTED.value()
        await svc_a.tick()
        zombie = (svc_a.lease.losses, "/live/m" in svc_a._claims,
                  o.CLUSTER_LEASE_FENCE_REJECTED.value() > rej,
                  list(released), await svc_b.placement.claimant("/live/m"))
        await svc_b.tick()
        seen.append({
            "ckpt_path": json.loads(ck[1])["sessions"][0]["path"],
            "ckpt_token": ck[0] == old_tok,
            "migrations": (svc_b.migrations,
                           o.CLUSTER_MIGRATIONS.value() - mig),
            "restored": [s["path"] for s in restored[0]["sessions"]],
            "new_token": (new_tok > old_tok, ck2[0] == new_tok),
            "zombie": zombie})
    assert seen[0] == seen[1]
    assert seen[1]["zombie"] == (1, False, True, ["/live/m"], "b")
    assert seen[1]["migrations"] == (1, 1)


async def test_adoption_retries_failed_restore_without_losing_ckpt():
    seen = []
    for _name, _pres, _pl, _pu, red, svc_mod, o in PKGS:
        clock = Clock()
        r = red.InMemoryRedis(clock=clock)
        reg_cls = RefRegistry if svc_mod is ref_service else SessionRegistry
        reg_a, reg_b = reg_cls(), reg_cls()
        reg_a.find_or_create("/live/m", SDP)
        calls = [0]

        def flaky(doc, reg_b=reg_b, calls=calls):
            calls[0] += 1
            if calls[0] == 1:
                raise RuntimeError("egress not ready yet")
            for srec in doc.get("sessions", ()):
                reg_b.find_or_create(srec["path"], srec["sdp"])
            return 1, 1

        svc_a = svc_mod.ClusterService(
            r, svc_mod.ClusterConfig("a", lease_ttl_sec=5), registry=reg_a)
        svc_b = svc_mod.ClusterService(
            r, svc_mod.ClusterConfig("b", lease_ttl_sec=5), registry=reg_b,
            restore_doc=flaky)
        await svc_a.lease.acquire()
        await svc_b.lease.acquire()
        await svc_a.tick()
        clock.t = 10.0
        mig = o.CLUSTER_MIGRATIONS.value()
        await svc_b.tick()
        first = (svc_b.migrations, "/live/m" in svc_b._adopt_retry,
                 await r.fget(svc_mod.ckpt_key("/live/m")) is not None)
        await svc_b.tick()
        second = (svc_b.migrations, o.CLUSTER_MIGRATIONS.value() - mig,
                  svc_b._adopt_retry, "/live/m" in svc_b._claims,
                  reg_b.find("/live/m") is not None)
        await svc_b.tick()
        seen.append((first, second, svc_b.migrations,
                     await r.fget(svc_mod.ckpt_key("/live/m")) is not None))
    assert seen[0] == seen[1]
    assert seen[1] == ((0, True, True), (1, 1, {}, True, True), 1, True)


async def test_migration_merge_clamps_preexisting_bookmarks():
    doc = {"version": port_ckpt.CKPT_VERSION, "saved_wall": time.time(),
           "sessions": [{"path": "/live/mg", "sdp": SDP, "streams": [
               {"track": 1, "head": 60, "keyframe_id": None,
                "reporter_ssrc": 1, "rr": [-1, 0, 0, 0, 0, 0],
                "packets_in": 0, "packets_out": 0, "outputs": []}]}]}
    seen = []
    for reg_cls, out_cls, mod in ((RefRegistry, RefOutput, ref_ckpt),
                                  (SessionRegistry, CollectingOutput,
                                   port_ckpt)):
        reg = reg_cls()
        st = reg.find_or_create("/live/mg", SDP).streams[1]
        ahead, behind = out_cls(), out_cls()
        st.add_output(ahead)
        st.add_output(behind)
        ahead.bookmark = 500
        behind.bookmark = 10
        mod.restore_registry(reg, doc)
        seen.append((st.rtp_ring.head, st.rtp_ring.tail, ahead.bookmark,
                     behind.bookmark))
    assert seen[0] == seen[1] == (60, 60, 60, 10)


# ------------------------------------------------------------- mixed cluster
def _loaded_registry(reg_cls, out_cls, rng) -> tuple:
    """A registry with one session whose stream relayed a few packets to
    three outputs (their rewrite state set), and the outputs."""
    reg = reg_cls()
    st = reg.find_or_create("/live/mx", SDP).streams[1]
    outs = []
    for _ in range(3):
        o = out_cls(ssrc=int(rng.integers(1 << 32)),
                    out_seq_start=int(rng.integers(1 << 16)),
                    out_ts_start=int(rng.integers(1 << 32)))
        st.add_output(o)
        outs.append(o)
    seq0 = int(rng.integers(1 << 16))
    for i in range(12):
        st.push_rtp(_pkt(seq0 + i), 0)
    st.reflect(1_000_000)
    return reg, st, outs


def _rewrites(outs) -> list:
    return [(o.rewrite.ssrc, o.rewrite.base_src_seq, o.rewrite.base_src_ts,
             o.rewrite.out_seq_start, o.rewrite.out_ts_start,
             o.packets_sent, o.bytes_sent) for o in outs]


@pytest.mark.parametrize("publisher", ["ref", "port"])
async def test_mixed_cluster_adopts_the_other_package_checkpoint(publisher):
    """One Redis; the publisher package's ClusterService claims a path
    and publishes its checkpoint; its lease dies and the other package's
    service adopts it.  The adopted session, its outputs' SSRCs and
    rewrite state and their bookmarks equal what the publisher's own
    package restores from the same document, and the old owner is
    fenced out when it comes back."""
    rng = np.random.default_rng(31 if publisher == "ref" else 32)
    pub = dict(ref=(ref_service, RefRegistry, RefOutput, ref_ckpt),
               port=(service, SessionRegistry, CollectingOutput, port_ckpt))
    adopter = "port" if publisher == "ref" else "ref"
    svc_p, reg_p, out_p, _ckpt_p = pub[publisher]
    svc_a, reg_a, out_a, ckpt_a = pub[adopter]
    clock = Clock()
    r = (ref_redis if adopter == "ref" else port_redis).InMemoryRedis(
        clock=clock)
    reg_src, st_src, outs_src = _loaded_registry(reg_p, out_p, rng)
    released = []
    owner = svc_p.ClusterService(
        r, svc_p.ClusterConfig("owner", lease_ttl_sec=5), registry=reg_src,
        on_fence_lost=released.append)
    reg_dst = reg_a()
    adopted_outs: list = []

    def restore(doc):
        def factory(_rec):
            o = out_a()
            adopted_outs.append(o)
            return o
        return ckpt_a.restore_registry(reg_dst, doc, output_factory=factory)

    adopter_svc = svc_a.ClusterService(
        r, svc_a.ClusterConfig("adopter", lease_ttl_sec=5),
        registry=reg_dst, restore_doc=restore)
    await owner.lease.acquire()
    await adopter_svc.lease.acquire()
    await owner.tick()
    tok, raw = await r.fget(svc_p.ckpt_key("/live/mx"))
    doc = json.loads(raw)
    assert doc["version"] == svc_a.CKPT_VERSION == svc_p.CKPT_VERSION
    clock.t = 10.0
    await adopter_svc.tick()
    assert adopter_svc.migrations == 1
    assert await adopter_svc.placement.claimant("/live/mx") == "adopter"
    # the same document restored by the publisher's own package
    twin_reg = reg_p()
    twin_outs = []
    _ckpt_p.restore_registry(
        twin_reg, doc,
        output_factory=lambda _rec: twin_outs.append(out_p()) or
        twin_outs[-1])
    sess = reg_dst.find("/live/mx")
    twin = twin_reg.find("/live/mx")
    assert sess is not None and sess.path == twin.path == "/live/mx"
    assert reg_dst.sdp_cache.get("/live/mx") == SDP
    assert _rewrites(adopted_outs) == _rewrites(twin_outs) == \
        _rewrites(outs_src)
    st = sess.streams[1]
    assert st.rtp_ring.head == twin.streams[1].rtp_ring.head \
        == st_src.rtp_ring.head
    assert [o.bookmark for o in adopted_outs] == \
        [o.bookmark for o in twin_outs] == [st.rtp_ring.head] * 3
    assert sess.trace_id == twin.trace_id == reg_src.find("/live/mx").trace_id
    # the adopter republished under its own, newer token
    tok2, _ = await r.fget(svc_a.ckpt_key("/live/mx"))
    assert tok2 > tok
    # the old owner returns: fenced out, its data plane released
    await owner.tick()
    assert released == ["/live/mx"] and "/live/mx" not in owner._claims
    assert await owner.placement.claimant("/live/mx") == "adopter"


# ------------------------------------------------------------ two-server e2e
def _server_cfg(tmp_path, node: str, **kw) -> ServerConfig:
    cfg = ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        wan_ip="127.0.0.1", reflect_interval_ms=10,
        log_folder=str(tmp_path / node), access_log_enabled=False,
        movie_folder=str(tmp_path / node / "movies"),
        server_id=node, cluster_enabled=True,
        cluster_lease_ttl_sec=1.0, cluster_heartbeat_sec=0.2,
        cluster_pull_connect_timeout_sec=3.0,
        cluster_pull_read_timeout_sec=1.0,
        cluster_pull_backoff_ms=100.0, cluster_capacity_score=4096.0, **kw)
    cfg.stream.bucket_delay_ms = 0
    return cfg


async def _until(pred, timeout_s: float, step_s: float = 0.05) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if pred():
            return True
        await asyncio.sleep(step_s)
    return pred()


async def test_two_server_kill_migrate_gapless_e2e(tmp_path):
    """The owner dies mid-relay: the survivor adopts through the
    published checkpoint and the UDP player, which never re-SETUPs, sees
    the SAME SSRC and a gapless seq, within the 10 s budget."""
    redis = port_redis.InMemoryRedis()
    app_a = StreamingServer(_server_cfg(tmp_path, "node-a"), device="cpu",
                            redis_client=redis)
    app_b = StreamingServer(_server_cfg(tmp_path, "node-b"), device="cpu",
                            redis_client=redis)
    await app_a.start()
    await app_b.start()
    clients = []
    try:
        push = await _pusher(app_a.rtsp.port, "/live/fo", udp=False)
        clients.append(push)
        player, ssrc = await _player(app_a.rtsp.port, "/live/fo", "udp")
        clients.append(player)
        for seq in range(20):
            push.push(_pkt(seq))
            await asyncio.sleep(0.005)
        assert await _until(lambda: len(player.frames) >= 20, 5.0)
        assert await _until(lambda: "/live/fo" in app_a.cluster._claims,
                            5.0)
        await asyncio.sleep(0.3)            # a tick publishes the ckpt

        # the kill: lease and claims left as a SIGKILL leaves them
        mig = obs.CLUSTER_MIGRATIONS.value()
        app_a.cluster.crash()
        app_a.cluster = None
        t_kill = time.monotonic()
        await app_a.stop()
        assert await _until(
            lambda: app_b.registry.find("/live/fo") is not None, 10.0)
        assert time.monotonic() - t_kill <= 10.0
        assert obs.CLUSTER_MIGRATIONS.value() == mig + 1
        assert len(app_b._restored_subs) == 1
        sess = app_b.registry.find("/live/fo")
        assert "node-b" in sess.trace_nodes

        n_before = len(player.frames)
        push2 = await _pusher(app_b.rtsp.port, "/live/fo", udp=False)
        clients.append(push2)
        for seq in range(20, 40):
            push2.push(_pkt(seq))
            await asyncio.sleep(0.005)
        assert await _until(lambda: len(player.frames) >= n_before + 20,
                            5.0)
        frames = list(player.frames)
        assert {rtp.peek_ssrc(p) for p in frames} == {ssrc}
        seqs = [rtp.peek_seq(p) for p in frames]
        steps = {(b - a) & 0xFFFF for a, b in zip(seqs, seqs[1:])}
        assert steps == {1}, f"seq gap across migration: {sorted(steps)}"
        assert app_b.stats()["cluster"]["migrations"] == 1
    finally:
        for c in clients:
            await c.close()
        await app_b.stop()
    assert app_b.pump_errors == 0 and app_b.device_errors == 0


async def test_zombie_owner_is_fenced_out_of_its_data_plane(tmp_path):
    """A's cluster stops ticking while its data plane serves on (a
    partition, not a death); B adopts the path once A's lease lapses.
    When A ticks again its claim refresh is fence-rejected, and the fence
    loss reaches A's data plane: the pusher's connection is closed and
    the session removed, so one node serves the path."""
    redis = port_redis.InMemoryRedis()
    app_a = StreamingServer(_server_cfg(tmp_path, "node-a"), device="cpu",
                            redis_client=redis)
    app_b = StreamingServer(_server_cfg(tmp_path, "node-b"), device="cpu",
                            redis_client=redis)
    await app_a.start()
    await app_b.start()
    clients = []
    try:
        push = await _pusher(app_a.rtsp.port, "/live/z", udp=False)
        clients.append(push)
        for seq in range(10):
            push.push(_pkt(seq))
        assert await _until(lambda: "/live/z" in app_a.cluster._claims, 5.0)
        await asyncio.sleep(0.3)
        cl_a = app_a.cluster
        cl_a.crash()                            # the partition
        assert await _until(
            lambda: app_b.registry.find("/live/z") is not None, 10.0)
        assert app_a.registry.find("/live/z") is not None   # still serving
        rej = obs.CLUSTER_LEASE_FENCE_REJECTED.value()
        cl_a._running = True                    # the partition heals
        cl_a._task = asyncio.create_task(cl_a._loop())
        assert await _until(
            lambda: app_a.registry.find("/live/z") is None, 5.0)
        assert obs.CLUSTER_LEASE_FENCE_REJECTED.value() > rej
        assert "/live/z" not in cl_a._claims and cl_a.lease.losses == 1
        assert await _until(lambda: push._task.done(), 5.0)  # closed on it
        assert await app_b.cluster.placement.claimant("/live/z") == "node-b"
    finally:
        for c in clients:
            await c.close()
        await app_a.stop()
        await app_b.stop()


async def test_cross_server_pull_serves_remote_subscriber(tmp_path):
    """A subscriber on the node that does not own the path is served
    through the pull envelope; when the upstream dies the session
    survives and the failure is counted, with the stream's rung
    untouched and no pass served on the host; a source
    re-ANNOUNCEd here supersedes the pull and the node claims the path."""
    redis = port_redis.InMemoryRedis()
    app_a = StreamingServer(_server_cfg(tmp_path, "node-a"), device="cpu",
                            redis_client=redis)
    app_b = StreamingServer(_server_cfg(tmp_path, "node-b"), device="cpu",
                            redis_client=redis)
    await app_a.start()
    await app_b.start()
    clients = []
    try:
        push = await _pusher(app_a.rtsp.port, "/live/pl", udp=False)
        clients.append(push)
        assert await _until(lambda: "/live/pl" in app_a.cluster._claims,
                            5.0)
        player, _ssrc = await _player(app_b.rtsp.port, "/live/pl", "tcp")
        clients.append(player)
        assert "/live/pl" in app_b.cluster.pulls
        pushed = [_pkt(seq) for seq in range(40)]
        for p in pushed:
            push.push(p)
            await asyncio.sleep(0.002)
        assert await _until(lambda: len(player.frames) >= 10, 5.0)
        assert all(f[12:] == pushed[0][12:] for f in player.frames)
        sess_b = app_b.registry.find("/live/pl")
        rp = app_b.cluster.pulls["/live/pl"]
        assert sess_b.owner is rp
        retries = obs.CLUSTER_PULL_RETRIES.value()

        await push.close()
        clients.remove(push)
        assert await _until(lambda: rp.retries >= 1, 5.0)
        assert app_b.registry.find("/live/pl") is sess_b
        assert obs.CLUSTER_PULL_RETRIES.value() >= retries + 1
        assert app_b.pull_errors >= 1 and app_b.pull_errors_injected == 0
        assert app_b.ladder.status().get("/live/pl", {"retries": 0}) \
            ["retries"] == 0
        assert app_b.ladder.degrades == 0 and app_b.host_steps == 0

        push3 = await _pusher(app_b.rtsp.port, "/live/pl", udp=False)
        clients.append(push3)
        assert await _until(
            lambda: "/live/pl" not in app_b.cluster.pulls
            and "/live/pl" in app_b.cluster._claims, 5.0, 0.1)
        assert app_b.registry.find("/live/pl") is sess_b
    finally:
        for c in clients:
            await c.close()
        await app_a.stop()
        await app_b.stop()


def test_two_server_kill_through_the_cli(tmp_path):
    """The kill and migration through two CLI servers over the port's
    ``MiniRedisServer`` (``chip_smoke.py`` phase 17's harness), on the
    CPU: the pulled payloads equal the pushed ones and the freshness
    chain has two hops, the adopter lists both nodes with the dead one
    stale, and the UDP players keep their SSRC with no seq gap."""
    from easydarwin_tpu_torch.utils.cluster_loopback import cluster_kill
    res = asyncio.run(asyncio.wait_for(cluster_kill(
        "cpu", str(tmp_path), paths=3, pull_s=1.6, after_s=1.5), 90))
    assert res["adopt_s"] <= 10.0 and res["seq_gap"] == 0
    assert res["freshness_hops"] == 2 and res["migrations"] >= 3
    assert res["fleet"]["node-a"]["stale"] is True
    assert res["megabatch_passes"]["after_adoption"] > 0
    assert res["capacity_score"] > 0
    assert all(after > 0 for _before, after in res["udp_packets"])


# ------------------------------------------------------------------- admission
async def test_overload_spoof_admission_redirects_then_refuses(tmp_path):
    """With ``overload_spoof`` armed every play SETUP on A reads as past
    the high-water mark: 305 to B while B has headroom (the reference's
    ``edge_for`` names the same edge from the same node snapshot), 453
    once no peer has; each is a ``cluster.refuse`` event and counted by
    action."""
    from easydarwin_tpu_torch.utils.loopback import MiniClient
    redis = port_redis.InMemoryRedis()
    app_a = StreamingServer(_server_cfg(
        tmp_path, "node-a",
        resilience_fault_plan="seed=4,overload_spoof=1.0"), device="cpu",
        redis_client=redis)
    app_b = StreamingServer(_server_cfg(tmp_path, "node-b"), device="cpu",
                            redis_client=redis)
    await app_a.start()
    await app_b.start()
    clients = []
    seq0 = obs.EVENTS.seq
    red0 = obs.CLUSTER_ADMISSION_REFUSED.value(action="redirect")
    ref0 = obs.CLUSTER_ADMISSION_REFUSED.value(action="refuse")
    try:
        push = await _pusher(app_a.rtsp.port, "/live/adm", udp=False)
        clients.append(push)
        assert await _until(lambda: "node-b" in app_a.cluster.last_nodes
                            and "util" in app_a.cluster.last_nodes["node-b"],
                            5.0)

        async def setup() -> tuple:
            c = MiniClient()
            await c.connect(app_a.rtsp.port)
            clients.append(c)
            uri = f"rtsp://127.0.0.1:{app_a.rtsp.port}/live/adm"
            await c.request("DESCRIBE", uri)
            resp = await c._send_request(
                "SETUP", uri + "/trackID=1",
                {"transport": "RTP/AVP/TCP;unicast;interleaved=0-1"}, b"")
            return resp.status, resp.headers.get("location"), c

        nodes = dict(app_a.cluster.last_nodes)
        status, loc, c = await setup()
        want = ref_placement.PlacementService(
            ref_redis.InMemoryRedis(), "node-a").edge_for(
            "/live/adm", nodes, client_key=c.writer.get_extra_info(
                "sockname")[0] + f":{c.writer.get_extra_info('sockname')[1]}",
            exclude=("node-a",), high_water=0.85)
        assert status == 305 and want == "node-b"
        assert loc == f"rtsp://127.0.0.1:{app_b.rtsp.port}/live/adm"
        await app_b.stop()                  # the drain releases B's lease
        assert await _until(
            lambda: "node-b" not in app_a.cluster.last_nodes, 5.0)
        status2, _loc, _c = await setup()
        assert status2 == 453
        fired = [e for e in obs.EVENTS.tail()
                 if e["seq"] > seq0 and e["event"] == "cluster.refuse"]
        assert [e["action"] for e in fired] == ["redirect", "refuse"]
        assert fired[0]["target"] == "node-b"
        assert obs.CLUSTER_ADMISSION_REFUSED.value(action="redirect") \
            == red0 + 1
        assert obs.CLUSTER_ADMISSION_REFUSED.value(action="refuse") \
            == ref0 + 1
    finally:
        for c in clients:
            await c.close()
        await app_a.stop()
        await app_b.stop()


async def test_admission_exempts_plain_local_file_vod(tmp_path):
    """Past the high-water mark a play SETUP of a live path is refused,
    but one of a file under the movie folder is admitted: no peer can
    serve this node's files (the reference's exemption)."""
    from easydarwin_tpu_torch.utils.loopback import MiniClient
    from easydarwin_tpu_torch.utils.vod_clips import ClipSpec, write_clip
    cfg = _server_cfg(tmp_path, "node-v",
                      resilience_fault_plan="seed=2,overload_spoof=1.0")
    (tmp_path / "node-v" / "movies").mkdir(parents=True)
    write_clip(str(tmp_path / "node-v" / "movies" / "clip.mp4"),
               ClipSpec(width=64, height=48, frames=10), seed=3)
    app = StreamingServer(cfg, device="cpu",
                          redis_client=port_redis.InMemoryRedis())
    await app.start()
    clients = []
    try:
        push = await _pusher(app.rtsp.port, "/live/v", udp=False)
        clients.append(push)
        got = {}
        for path in ("/clip.mp4", "/live/v"):
            c = MiniClient()
            await c.connect(app.rtsp.port)
            clients.append(c)
            uri = f"rtsp://127.0.0.1:{app.rtsp.port}{path}"
            await c.request("DESCRIBE", uri)
            resp = await c._send_request(
                "SETUP", uri + "/trackID=1",
                {"transport": "RTP/AVP/TCP;unicast;interleaved=0-1"}, b"")
            got[path] = resp.status
        assert got == {"/clip.mp4": 200, "/live/v": 453}
    finally:
        for c in clients:
            await c.close()
        await app.stop()


async def test_cloud_presence_records_and_standalone_without_redis(tmp_path):
    """``cloud_enabled`` without a cluster keeps the reference's passive
    records (``EasyDarwin:{id}``, ``Live:{path}`` synced by a task of its
    own, removed at stop); a Redis unreachable at start leaves the server
    standalone."""
    import socket
    redis = port_redis.InMemoryRedis()
    cfg = ServerConfig(rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
                       log_folder=str(tmp_path / "p"), server_id="node-p",
                       access_log_enabled=False, cloud_enabled=True)
    app = StreamingServer(cfg, device="cpu", redis_client=redis)
    await app.start()
    clients = []
    try:
        assert app.presence is not None and app.cluster is None
        h = await redis.hgetall("EasyDarwin:node-p")
        assert h["RTSP"] == str(app.rtsp.port) and h["IP"] == "127.0.0.1"
        clients.append(await _pusher(app.rtsp.port, "/live/pr", udp=False))
        # the records' tick is the reference's 5 s
        assert await _until(lambda: bool(redis._data.get("Live:live/pr")),
                            presence.TICK_SEC + 3.0)
        rec = await presence.PresenceService.find_stream(redis, "live/pr")
        assert rec["Server"] == "node-p"
    finally:
        for c in clients:
            await c.close()
        await app.stop()
    assert await redis.keys("*") == []
    with socket.socket() as s:              # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    cfg2 = ServerConfig(rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
                        log_folder=str(tmp_path / "q"), cloud_enabled=True,
                        access_log_enabled=False, redis_port=dead)
    app2 = StreamingServer(cfg2, device="cpu")
    await app2.start()
    try:
        assert app2.presence is None        # standalone
        assert app2.rtsp.port
    finally:
        await app2.stop()


# ---------------------------------------------------------- the fault sites
class _FakeClientStats:
    packets = 0


class _FakePull:
    alive = True

    class client:
        stats = _FakeClientStats()


async def _drive_cluster_sites(svc_mod, pull_mod, cap_mod, red, injector,
                               SessionReg) -> None:
    """The same calls into one package's cluster tier: ticks (a partition
    raises), load samples (the capacity lie), a pull's liveness probe
    (the stall) and admission checks (the overload lie)."""
    r = red.InMemoryRedis()
    svc = svc_mod.ClusterService(r, svc_mod.ClusterConfig("n1"),
                                 registry=SessionReg())
    await svc.lease.acquire()
    for _ in range(6):
        try:
            await svc.tick()
        except red.RedisTimeout:
            pass
    lt = cap_mod.LoadTracker(1000.0, source=lambda: 0)
    for _ in range(3):
        lt.sample()
    rp = pull_mod.RemotePull("/live/s", None, None,
                             pull_mod.PullConfig(read_timeout_sec=0.2))
    for _ in range(2):
        assert await rp._monitor(_FakePull()) is True
    for _ in range(4):
        injector.overload_spoof()


@pytest.mark.parametrize("injected", [False, True],
                         ids=["real", "injected"])
async def test_only_an_injected_pull_failure_moves_the_rung(tmp_path,
                                                            injected):
    """A pull's failure reaches the server's hook, which counts it; only
    an injected ``pull_stall`` is charged to the path's rung (a retry and
    its backoff), a real read stall leaves the stream on the card."""
    from easydarwin_tpu_torch.resilience import INJECTOR
    from easydarwin_tpu_torch.resilience.inject import FaultPlan
    app = StreamingServer(_server_cfg(tmp_path, "node-a"), device="cpu")
    rp = pull.RemotePull("/live/s", None, None,
                         pull.PullConfig(read_timeout_sec=0.2),
                         on_failure=app._on_pull_failure)
    if injected:
        INJECTOR.arm(FaultPlan.parse("seed=5,pull_stall_every=1"))
    try:
        assert await rp._monitor(_FakePull()) is True
    finally:
        INJECTOR.disarm()
    assert rp.stall_injected is injected
    rp._failure("rtsp://a/live/s", stalled=True)
    assert rp.stall_injected is False
    assert (app.pull_errors, app.pull_errors_injected) == (1, int(injected))
    retries = app.ladder.status().get("/live/s", {"retries": 0})["retries"]
    assert retries == int(injected)
    assert (app.ladder.engine_mode("/live/s") == 0) is not injected


async def test_cluster_fault_sites_count_as_the_reference():
    from easydarwin_tpu.resilience import INJECTOR as REF_INJECTOR
    from easydarwin_tpu.resilience.inject import FaultPlan as RefPlan
    from easydarwin_tpu_torch.resilience import INJECTOR
    from easydarwin_tpu_torch.resilience.inject import FaultPlan
    spec = ("seed=9,lease_loss_every=2,redis_partition_every=3,"
            "pull_stall_every=1,capacity_spoof=2048,overload_spoof=0.5")
    sites = ("lease_loss", "redis_partition", "pull_stall",
             "capacity_spoof", "overload_spoof")
    before = {s: obs.FAULT_INJECTED.value(site=s) for s in sites}
    INJECTOR.arm(FaultPlan.parse(spec))
    REF_INJECTOR.arm(RefPlan.parse(spec))
    try:
        await _drive_cluster_sites(service, pull, capacity, port_redis,
                                   INJECTOR, SessionRegistry)
        await _drive_cluster_sites(ref_service, ref_pull, ref_capacity,
                                   ref_redis, REF_INJECTOR, RefRegistry)
        got, want = INJECTOR.counts(), REF_INJECTOR.counts()
        assert capacity.quantize(2048.0) == \
            obs.CLUSTER_CAPACITY_SCORE.value()
    finally:
        INJECTOR.disarm()
        REF_INJECTOR.disarm()
    for s in sites:
        assert got.get(s, 0) == want.get(s, 0), (s, got, want)
        assert obs.FAULT_INJECTED.value(site=s) - before[s] == got.get(s, 0)
    assert all(got.get(s, 0) > 0 for s in sites), got


# ------------------------------------------------------------------- lint
def test_cluster_lint_contract():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "tools"))
    import metrics_lint
    from easydarwin_tpu_torch.obs import events as ev
    assert metrics_lint.lint_cluster(obs.REGISTRY, ev.SCHEMA) == []
    assert metrics_lint.lint(obs.REGISTRY) == []
    for name in ("cluster.refuse", "cluster.rebalance", "fleet.node_stale",
                 "fleet.node_live"):
        assert name in ev.SCHEMA


async def test_redis_partition_skips_tick_and_counts():
    from easydarwin_tpu_torch.resilience import INJECTOR
    from easydarwin_tpu_torch.resilience.inject import FaultPlan
    r = port_redis.InMemoryRedis()
    svc = service.ClusterService(r, service.ClusterConfig("n1"),
                                 registry=SessionRegistry())
    await svc.lease.acquire()
    INJECTOR.arm(FaultPlan.parse("seed=3,redis_partition_every=1"))
    try:
        fi = obs.FAULT_INJECTED.value(site="redis_partition")
        ticks = svc.ticks
        with pytest.raises(port_redis.RedisTimeout):
            await svc.tick()
        assert obs.FAULT_INJECTED.value(site="redis_partition") == fi + 1
        assert svc.ticks == ticks       # the tick aborted before counting
    finally:
        INJECTOR.disarm()
    await svc.tick()
    assert svc.ticks == ticks + 1
