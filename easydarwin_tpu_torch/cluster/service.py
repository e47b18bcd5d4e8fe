"""The fault-tolerant cluster service: one node's membership duties.

Ties the pieces into one failure story (the original EasyDarwin never
had one: a server's death was an outage for its streams):

* **lease** — heartbeat a TTL'd fenced lease (``presence.LeaseManager``)
  plus the reference-shaped ``EasyDarwin:{id}``/``Live:{name}`` presence
  records the CMS reads;
* **claims** — every locally-sourced stream is claimed in Redis
  (``placement.PlacementService``), fenced by a fresh token minted at
  claim time; refreshes that lose the fence mean a NEWER owner exists —
  this node is the zombie and releases the stream's cluster duties
  instead of double-serving;
* **checkpoint publication** — each owned stream's session checkpoint
  (``resilience.checkpoint.snapshot_session``: ring cursors, rewrite
  5-tuples, RR accounting — plain ints) is published to ``Ckpt:{name}``
  each tick, fenced by the claim token, so the stream's recovery state
  exists OUTSIDE the process that may die;
* **migration** — each tick scans ownership records; a claimant whose
  lease is gone triggers deterministic re-placement (consistent hash
  over the live lease set) and, when this node is the successor, it
  mints a fresh token, claims, and hot-restores the published
  checkpoint: same ssrc, gapless rewritten seq, UDP subscribers
  re-pointed without re-SETUP (``cluster_migrations_total``);
* **pulls** — a subscriber landing here for a stream another node owns
  is served through a ``cluster.pull.RemotePull`` (retry/backoff/breaker
  envelope, owner re-resolution, the ``on_pull_failure`` hook);
* **drain** — planned handoff: publish fresh checkpoints for everything
  owned, release the lease, and let the peers' normal migration scan
  adopt within one tick (no TTL wait).

The service runs its own asyncio task at ``heartbeat_sec``; every tick
is guarded — a partitioned Redis (real or injected ``redis_partition``)
skips the tick, the lease ages toward expiry, and the cluster treats
this node exactly like a dead one.  That symmetry is the design: there
is ONE failure path, and chaos soaks drive it on purpose.  The tick is
the only code that awaits Redis; the pump's wake never does (admission
and the fleet readers take the last tick's snapshots).

The DVR and erasure-store hooks (``dvr_advertise``, ``dvr_peers``,
``storage_claims``, ``storage_repair``) are the reference's attributes;
the server leaves them unset (None, an empty map), so the tick skips
those duties and the DVR tier and the store serve one node.
"""

from __future__ import annotations

import asyncio
import json
import time

from .. import obs
from ..obs import fleet as fleet_mod
from ..resilience.checkpoint import CKPT_VERSION, snapshot_session
from .placement import OWN_KEY_PREFIX, PlacementService, own_key
from .presence import FENCE_COUNTER_KEY, LeaseManager, PresenceService
from .pull import PullConfig, RemotePull
from .redis_client import FENCE_SET_LUA, RedisTimeout

CKPT_KEY_PREFIX = "Ckpt:"


def ckpt_key(path: str) -> str:
    return f"{CKPT_KEY_PREFIX}{path.strip('/')}"


class ClusterConfig:
    """Mirrored from the ``cluster_*`` ServerConfig keys (plain class:
    the app fills ports at start once listeners are bound)."""

    def __init__(self, node_id: str, *, ip: str = "127.0.0.1",
                 rtsp_port: int = 0, http_port: int = 0,
                 lease_ttl_sec: float = 5.0, heartbeat_sec: float = 1.0,
                 vnodes: int = 64, own_ttl_sec: float = 30.0,
                 migration_ttl_sec: float = 30.0,
                 pull: PullConfig | None = None,
                 rebalance_enabled: bool = True,
                 rebalance_high_water: float = 0.9,
                 rebalance_low_water: float = 0.5,
                 rebalance_burn_sec: float = 10.0,
                 rebalance_cooldown_sec: float = 30.0,
                 admission_enabled: bool = True,
                 admission_high_water: float = 0.85):
        self.node_id = node_id
        self.ip = ip
        self.rtsp_port = rtsp_port
        self.http_port = http_port
        self.lease_ttl_sec = lease_ttl_sec
        self.heartbeat_sec = heartbeat_sec
        self.vnodes = vnodes
        self.own_ttl_sec = own_ttl_sec
        self.migration_ttl_sec = migration_ttl_sec
        self.pull = pull or PullConfig()
        # load-aware control plane
        self.rebalance_enabled = rebalance_enabled
        self.rebalance_high_water = rebalance_high_water
        self.rebalance_low_water = rebalance_low_water
        self.rebalance_burn_sec = rebalance_burn_sec
        self.rebalance_cooldown_sec = rebalance_cooldown_sec
        self.admission_enabled = admission_enabled
        self.admission_high_water = admission_high_water


class Rebalancer:
    """Proactive SLO-drain rebalancing: drain a sustained-burning node's
    hottest stream to the least-loaded live successor — the crash
    migration reused as a PLANNED move (fresh checkpoint publish +
    fenced hand-off record; same ssrc, gapless seq at the player).

    Hysteresis, as the degradation ladder's — the rebalancer must never
    flap:

    * **sustained burn** — the node must read past the high-water mark
      (utilization ≥ ``rebalance_high_water`` OR the SLO watchdog's
      multi-window burn latched) CONTINUOUSLY for ``rebalance_burn_sec``
      before any move; one clean sample resets the window.  A reported
      SLO burn only counts while utilization is at least the low-water
      mark — an under-utilized node is a drain target by definition,
      and its burn signal is not load it can shed;
    * **headroom gate** — a move happens only toward a live peer under
      ``rebalance_low_water`` (draining onto an equally-hot peer just
      moves the fire);
    * **cooldown** — at most one move per ``rebalance_cooldown_sec``,
      so the post-move rate decay gets to land before re-evaluation.
    """

    def __init__(self, service: "ClusterService", *,
                 clock=time.monotonic):
        self.service = service
        self._clock = clock
        self._burn_since: float | None = None
        self._last_move = float("-inf")
        #: drains INITIATED (hand-off records published); the completed
        #: count is the cluster_rebalance_moves_total metric
        self.moves = 0

    def _hottest_claim(self) -> str | None:
        """The hottest stream this node owns: most subscriber outputs
        (the load a drain actually sheds), ties by path for
        determinism; None when nothing owned has an audience."""
        svc = self.service
        best: tuple[int, str] | None = None
        for path in svc._claims:
            sess = svc.registry.find(path)
            if sess is None:
                continue
            n = sess.num_outputs
            if n > 0 and (best is None or (n, path) > best):
                best = (n, path)
        return best[1] if best else None

    async def tick(self, nodes: dict, load: dict | None) -> bool:
        """One evaluation; True when a drain was INITIATED (the
        hand-off record published; ``self.moves`` counts these).
        Completion is booked by ``_check_draining`` when the target's
        adoption flips the claimant — that is where the
        ``cluster_rebalance_moves_total`` metric increments."""
        cfg = self.service.config
        if load is None:
            # no sample: the burn window is no longer CONTINUOUS
            # evidence — restart it rather than let a sampling outage
            # bridge two non-adjacent burning samples into a move
            self._burn_since = None
            return False
        now = self._clock()
        util = load.get("util")
        util = float(util) if isinstance(util, (int, float)) else 0.0
        # a drain SOURCE must carry real load: under the low-water mark
        # a node is by definition a drain TARGET, and whatever SLO burn
        # it reports is not load-caused (a box-wide latency artifact, a
        # cold-start burst) — moving a stream off it sheds nothing and
        # just walks the stream around the cluster
        burning = util >= cfg.rebalance_low_water and (
            bool(load.get("burn")) or util >= cfg.rebalance_high_water)
        if not burning:
            self._burn_since = None
            return False
        if self._burn_since is None:
            self._burn_since = now
            return False
        if now - self._burn_since < cfg.rebalance_burn_sec:
            return False
        if now - self._last_move < cfg.rebalance_cooldown_sec:
            return False
        # headroom gate: the least-loaded LIVE peer under the low-water
        # mark; equal utilizations tie-break toward the HIGHEST
        # published capacity (never hand the hot stream to the weakest
        # idle node just because its name sorts first), then by name
        # for determinism
        cands = []
        for n, meta in nodes.items():
            if n == cfg.node_id or not isinstance(meta, dict):
                continue
            u = meta.get("util")
            if isinstance(u, (int, float)) and u < cfg.rebalance_low_water:
                cap = meta.get("cap")
                cap = float(cap) if isinstance(cap, (int, float)) else 0.0
                cands.append((float(u), -cap, n))
        if not cands:
            return False
        target = min(cands)[2]
        path = self._hottest_claim()
        if path is None:
            return False
        if not await self.service._handoff(path, target):
            return False
        self._last_move = now
        self._burn_since = None
        self.moves += 1
        return True


class ClusterService:
    """One server's cluster membership: lease + claims + checkpoint
    publication + migration + remote pulls."""

    def __init__(self, redis, config: ClusterConfig, *, registry,
                 pull_manager=None, restore_doc=None, on_pull_failure=None,
                 on_fence_lost=None, error_log=None, events=None):
        self.redis = redis
        self.config = config
        self.registry = registry
        self.pull_manager = pull_manager
        #: app hook: ``restore_doc(doc) -> (sessions, outputs)`` rebuilds
        #: sessions + UDP subscribers from a checkpoint document
        self.restore_doc = restore_doc
        #: app hook: ``on_pull_failure(path, injected)`` for each failure
        #: of a ``RemotePull`` (``injected``: an injected ``pull_stall``)
        self.on_pull_failure = on_pull_failure
        #: app hook: a NEWER owner fenced us out of this path — the DATA
        #: PLANE must stop serving it here (close the local source, drop
        #: restored stand-ins, remove the session); popping the Redis
        #: claim alone would leave two nodes transmitting to the same
        #: subscribers
        self.on_fence_lost = on_fence_lost
        self.error_log = error_log
        self._events = events if events is not None else obs.EVENTS
        self.lease = LeaseManager(
            redis, config.node_id, ttl_sec=config.lease_ttl_sec,
            meta={"ip": config.ip, "rtsp": config.rtsp_port,
                  "http": config.http_port})
        self.placement = PlacementService(redis, config.node_id,
                                          vnodes=config.vnodes)
        #: reference-shaped presence (EasyDarwin:/Live: records) so the
        #: CMS's least-loaded pick keeps working against cluster nodes
        self.presence = PresenceService(
            redis, config.node_id, ip=config.ip,
            rtsp_port=config.rtsp_port, http_port=config.http_port)
        #: locally-claimed paths -> claim fencing token
        self._claims: dict[str, int] = {}
        #: adoptions whose checkpoint restore did not materialize a
        #: session yet: path -> (claim token, tries).  Retried each tick
        #: so a transient restore failure cannot strand the stream with
        #: a live claim and no server behind it.
        self._adopt_retry: dict[str, tuple[int, int]] = {}
        #: path -> RemotePull for streams served here but owned elsewhere
        self.pulls: dict[str, RemotePull] = {}
        self._task: asyncio.Task | None = None
        self._running = False
        self.ticks = 0
        self.migrations = 0
        #: app hook: ``() -> {path: {track: [win_lo, win_hi]}}`` — the
        #: DVR tier's spilled-window spans, folded into this node's
        #: fenced Own: records so a flash crowd on a peer warms from
        #: THIS node's spill files instead of origin
        self.dvr_advertise = None
        #: what the LAST ownership scan saw other LIVE nodes advertise:
        #: path -> (ip, http_port, {track: [win_lo, win_hi]}).  Read
        #: synchronously by the app's DVR peer-fill fetcher (the segment
        #: cache calls it inline), refreshed once per cluster tick.
        self.dvr_peers: dict[str, tuple[str, int, dict]] = {}
        #: app hook: ``() -> {cap, util, burn, subs}`` — the
        #: LoadTracker sample folded into the lease record each
        #: heartbeat; None = no capacity/utilization published (the ring
        #: stays unweighted, rebalance/admission stay idle)
        self.load_status = None
        #: the latest sampled load record + live-node snapshot, read
        #: SYNCHRONOUSLY by the admission gate between ticks
        self.last_load: dict | None = None
        self.last_nodes: dict[str, dict] = {}
        #: app hook: ``() -> dict`` — obs.fleet.build_rollup,
        #: published into the fenced TTL'd Fleet:{node} record each
        #: heartbeat; None = no federation (rollups stay per-process)
        self.fleet_status = None
        #: the last fleet aggregation (every peer's rollup + liveness/
        #: staleness verdicts), read SYNCHRONOUSLY by /api/v1/fleet and
        #: admin command=fleet — a scrape must never wait on Redis
        self.last_fleet: dict = {}
        #: nodes currently latched stale (lease dead, rollup persists)
        #: so fleet.node_stale/node_live fire per TRANSITION, not tick
        self._fleet_stale: set[str] = set()
        #: what the LAST ownership scan recorded as each path's claim
        #: holder — the trace stitcher's synchronous upstream map
        self.owners: dict[str, str] = {}
        #: storage hooks: ``storage_claims() -> [(key, rec)]``
        #: drains the erasure tier's pending fenced ``Shard:`` claims
        #: (this tick mints the tokens and writes them — storage never
        #: touches Redis itself); ``storage_repair(live_nodes, records)``
        #: hands the parsed shard records over for dead-holder repair
        self.storage_claims = None
        self.storage_repair = None
        #: in-flight planned hand-offs: path -> (target, deadline) —
        #: the source keeps serving until the target's adoption clears
        #: the record's handoff marker (see _check_draining)
        self._draining: dict[str, tuple[str, float]] = {}
        self.rebalancer = Rebalancer(self) \
            if config.rebalance_enabled else None

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        self._running = True
        self.lease.meta = {"ip": self.config.ip,
                           "rtsp": self.config.rtsp_port,
                           "http": self.config.http_port}
        self.presence.rtsp_port = self.config.rtsp_port
        self.presence.http_port = self.config.http_port
        try:
            await self.lease.acquire()
            await self.presence.assert_presence()
        except Exception as e:
            self._warn(f"cluster start: {e!r}")
        self._task = asyncio.create_task(self._loop(), name="cluster")

    async def stop(self, *, drain: bool = True) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        for rp in list(self.pulls.values()):
            await rp.stop()
        self.pulls.clear()
        if drain:
            try:
                await self.drain()
            except Exception as e:
                self._warn(f"cluster drain: {e!r}")

    async def drain(self) -> None:
        """Planned handoff: final fresh checkpoints for every claim,
        then release the lease — the ownership records stay, so peers'
        migration scan adopts within one tick instead of a TTL wait."""
        for path, tok in list(self._claims.items()):
            try:
                await self._publish_ckpt(path, tok)
            except Exception:
                pass
        self._events.emit("cluster.drain", node=self.config.node_id,
                          streams=len(self._claims))
        try:
            await self.presence.stop()
        except Exception:
            pass
        await self.lease.release()

    def crash(self) -> None:
        """Abrupt death for tests/chaos: stop ticking WITHOUT releasing
        the lease or claims — peers must detect this node via TTL expiry,
        exactly as a SIGKILL'd process would look."""
        self._running = False
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def _warn(self, msg: str) -> None:
        if self.error_log is not None:
            self.error_log.warning(msg)

    # -- the tick ----------------------------------------------------------
    async def _loop(self) -> None:
        while self._running:
            # schedule-due stamp for the wake ledger: a tick that starts
            # late queued behind other event-loop work — that lateness
            # is its enqueue→start wait
            self._tick_due_ns = time.monotonic_ns()
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a partitioned Redis (RedisTimeout — real or injected)
                # skips the tick; the lease ages toward expiry and peers
                # treat this node as dead — the ONE failure path
                self._warn(f"cluster tick: {e!r}")
            await asyncio.sleep(self.config.heartbeat_sec)

    async def tick(self) -> None:
        from .redis_client import ROUNDTRIPS
        # wake-ledger accounting: the tick runs as its own
        # coroutine on the SAME event loop as the pump — its service
        # time is queueing delay for every relay class, and its Redis
        # roundtrips are THE cross-node suspect figure, so both are
        # recorded even when the tick aborts on a (real or injected)
        # partition — the timeout path is the expensive one.
        led = obs.LEDGER if obs.LEDGER.enabled else None
        t0_ns = time.monotonic_ns() if led else 0
        rt_mark = ROUNDTRIPS.mark() if led else (0, 0)
        try:
            await self._tick_inner()
        finally:
            if led:
                d_ops, d_ns = ROUNDTRIPS.delta_since(rt_mark)
                due = getattr(self, "_tick_due_ns", t0_ns)
                led.record(
                    "cluster_tick",
                    wait_ns=max(t0_ns - due, 0),
                    service_ns=time.monotonic_ns() - t0_ns,
                    redis_ops=d_ops, redis_ns=d_ns)

    async def _tick_inner(self) -> None:
        from ..resilience import INJECTOR
        if INJECTOR.active and INJECTOR.redis_partition():
            raise RedisTimeout("injected redis partition")
        self.ticks += 1
        # capacity + utilization publishing: the load sample
        # rides the fenced lease record so every peer's ring weighting,
        # successor ranking and redirect targeting read the same truth
        load = None
        if self.load_status is not None:
            try:
                load = self.load_status()
            except Exception as e:
                self._warn(f"load sample: {e!r}")
        if load:
            self.lease.meta.update(
                {k: load[k] for k in ("cap", "util", "burn", "subs")
                 if k in load})
        self.last_load = load
        await self.lease.heartbeat()
        # refresh the process-wide identity stamp (events/flight dumps):
        # a lease loss re-acquires under a NEW fencing token, and the
        # dedupe/attribution layers must see the current one
        obs.set_node(self.config.node_id, self.lease.token or 0)
        nodes = await self.placement.live_nodes()
        self.last_nodes = nodes
        await self._claim_local_sources(nodes)
        await self._retry_adoptions()
        await self._migration_scan(nodes)
        await self._check_draining()
        if self.rebalancer is not None:
            await self.rebalancer.tick(nodes, load)
        await self._sweep_pulls()
        await self._storage_tick(nodes)
        await self._publish_fleet(nodes)
        # reference-shaped presence for the CMS tier.  Only locally-
        # SOURCED paths are advertised: a pull replica writing (and on
        # retirement DELETing) the owner's Live:{name} record would flap
        # and blank the owner's still-valid advertisement.
        self.presence.set_load(sum(
            s.num_outputs for s in self.registry.sessions.values()))
        try:
            await self.presence.assert_presence()
            await self.presence.sync_streams(self.local_source_paths())
        except Exception:
            pass

    # -- claims + checkpoint publication -----------------------------------
    def local_source_paths(self) -> list[str]:
        """Paths fed by a LOCAL source (pusher, file broadcast, adopted
        migration) — everything in the registry except our own remote
        pulls (those belong to their upstream owner)."""
        pulled = set(self.pulls)
        return [p for p in self.registry.paths() if p not in pulled]

    def _dvr_adverts(self) -> dict:
        if self.dvr_advertise is None:
            return {}
        try:
            return self.dvr_advertise() or {}
        except Exception:
            return {}

    async def _claim_local_sources(self, nodes: dict) -> None:
        cfg = self.config
        local = self.local_source_paths()
        adv = self._dvr_adverts()
        # fresh claims (rare: a source just attached) stay individual —
        # they need a claimant read + a minted token first
        for path in local:
            if path in self._claims or path in self._draining:
                # a draining path is still a local source by design —
                # re-claiming it here would cancel our own hand-off
                continue
            claimant = await self.placement.claimant(path)
            if claimant and claimant != cfg.node_id and claimant in nodes:
                # a LIVE peer owns this path (we may be a zombie with a
                # still-connected source): do not fight it
                continue
            tok = int(await self.redis.incr(FENCE_COUNTER_KEY))
            if await self.placement.claim(path, tok,
                                          ttl=int(cfg.own_ttl_sec),
                                          extra=adv.get(path)):
                self._claims[path] = tok
            else:
                self._fence_lost(path)
        # steady state: ONE pipelined batch refreshes every claim and
        # ONE publishes every checkpoint — per-stream roundtrips would
        # serialize behind the connection lock and crowd the heartbeat
        claimed = [(p, self._claims[p]) for p in local if p in self._claims]
        if claimed:
            replies = await self.redis.pipeline(
                [self.placement.claim_command(p, t, ttl=int(cfg.own_ttl_sec),
                                              extra=adv.get(p))
                 for p, t in claimed])
            publishes = []
            for (path, tok), ok in zip(claimed, replies):
                if not self.placement.claim_result(path, ok):
                    # fence lost: a newer owner claimed while we were
                    # away — release the stream, cluster AND data plane
                    self._claims.pop(path, None)
                    self._fence_lost(path)
                    continue
                cmd = self._publish_cmd(path, tok)
                if cmd is not None:
                    publishes.append(cmd)
            if publishes:
                await self.redis.pipeline(publishes)
        # claims for sessions that no longer exist locally are released
        for path in [p for p in self._claims
                     if self.registry.find(p) is None]:
            tok = self._claims.pop(path)
            try:
                await self.placement.release(path, tok)
                await self.redis.fdel(ckpt_key(path), tok)
            except Exception:
                pass

    def _fence_lost(self, path: str) -> None:
        """A newer fencing token holds this path: hand the stream's
        DATA PLANE back too (placement already counted the rejection)."""
        if self.on_fence_lost is None:
            return
        try:
            self.on_fence_lost(path)
        except Exception as e:
            self._warn(f"fence-lost release {path}: {e!r}")

    def _publish_cmd(self, path: str, token: int):
        """The pipeline-able checkpoint publish (fenced EVAL fset), or
        None when the session has nothing restorable."""
        sess_doc = snapshot_session(self.registry, path,
                                    node_id=self.config.node_id)
        if sess_doc is None:
            return None
        doc = {"version": CKPT_VERSION,
               "saved_wall": round(time.time(), 3),
               "node": self.config.node_id,
               "sessions": [sess_doc]}
        return ("EVAL", FENCE_SET_LUA, 1, ckpt_key(path), int(token),
                json.dumps(doc, separators=(",", ":")),
                int(self.config.migration_ttl_sec))

    async def _publish_ckpt(self, path: str, token: int) -> bool:
        cmd = self._publish_cmd(path, token)
        if cmd is None:
            return False
        await self.redis.execute(*cmd)
        return True

    # -- planned rebalance hand-off -----------------------------------------
    #: seconds a hand-off may sit unadopted before the source reclaims
    #: the stream (the drain must never strand it)
    HANDOFF_TIMEOUT_SEC = 10.0

    async def _handoff(self, path: str, target: str) -> bool:
        """Drain one owned stream to ``target``: publish a FRESH
        checkpoint and mark the fenced ``Own:`` record with
        ``handoff_to`` — the record still names US as the claimant, so
        ``resolve()`` and the pusher keep pointing at the serving
        source.  The claimant flips to the target only when its
        adoption CLAIMS after restoring the checkpoint — the same
        restore-then-claim ordering the crash path has, which is what
        makes the move gapless: a pusher that re-resolves mid-drain can
        never land on a target that has not restored the subscribers
        yet (packets pushed into such a fresh session would die when a
        later restore reset the ring to the checkpoint id space).
        ``_check_draining`` watches for the flip (then releases the
        local data plane — the pusher re-announces onto the restored
        session with its resend tail) or reclaims on timeout."""
        tok = self._claims.get(path)
        if tok is None:
            return False
        if not await self._publish_ckpt(path, tok):
            return False                   # nothing restorable: no move
        new_tok = int(await self.redis.incr(FENCE_COUNTER_KEY))
        rec = {"node": self.config.node_id, "handoff_to": target}
        dvr = self._dvr_adverts().get(path)
        if dvr:
            # keep the spilled-window advertisement through the drain:
            # peers rebuild dvr_peers from this record every tick, and a
            # time-shifting viewer elsewhere must not lose peer-fill for
            # the whole hand-off window
            rec["dvr"] = dvr
        ok = await self.redis.execute(
            "EVAL", FENCE_SET_LUA, 1, own_key(path), new_tok,
            json.dumps(rec, separators=(",", ":")),
            int(self.config.own_ttl_sec))
        if not ok:
            # a newer token already holds the record: we were the
            # zombie all along — the refresh path will fence us out
            return False
        self._claims.pop(path, None)
        self._draining[path] = (target, time.monotonic()
                                + self.HANDOFF_TIMEOUT_SEC)
        util = (self.last_load or {}).get("util")
        self._events.emit("cluster.rebalance", level="warn", stream=path,
                          node=self.config.node_id, target=target,
                          util=util)
        return True

    async def _check_draining(self) -> None:
        """Advance in-flight hand-offs: release the local data plane
        once the target's adoption flipped the claimant (restore landed
        there first by construction), or reclaim the stream when the
        target never adopted within the timeout — a drain must never
        strand a stream."""
        for path, (target, deadline) in list(self._draining.items()):
            rec = await self.placement.claim_record(path)
            if rec is not None and str(rec[1]["node"]) == target:
                # adopted: the target restored + claimed.  NOW kick the
                # local source — the pusher re-resolves the claimant
                # (the restored target) and re-ANNOUNCEs there with its
                # resend tail: the post-crash recovery flow, gapless.
                # The moves counter lands HERE, not at initiation — a
                # hand-off the target never adopted is a reclaim, not a
                # completed drain
                del self._draining[path]
                obs.CLUSTER_REBALANCE_MOVES.inc()
                self.placement.forget(path)
                self._fence_lost(path)
                continue
            pending = (rec is not None
                       and str(rec[1]["node"]) == self.config.node_id
                       and rec[1].get("handoff_to") == target)
            if pending and time.monotonic() < deadline:
                continue
            # timed out / record gone / a third party took it: reclaim
            # if we still can, otherwise hand the data plane over too.
            # (A target adopting CONCURRENTLY with this reclaim mints a
            # newer token and wins the record back; our refresh batch
            # then hits the fence rejection within a heartbeat and
            # releases — bounded dual service, never a stranded stream.)
            del self._draining[path]
            tok = int(await self.redis.incr(FENCE_COUNTER_KEY))
            if await self.placement.claim(path, tok,
                                          ttl=int(self.config.own_ttl_sec)):
                self._claims[path] = tok
            else:
                self._fence_lost(path)

    # -- erasure storage ---------------------------------------------------
    async def _storage_tick(self, nodes: dict) -> None:
        """The storage tier's Redis face: write its pending fenced
        ``Shard:`` claims (one freshly minted token each — the same
        counter the stream claims use, so a zombie ex-holder's stale
        shard claim loses identically), then hand the full parsed shard
        record set plus the live lease set to the repair scanner."""
        if self.storage_claims is None and self.storage_repair is None:
            return
        if self.storage_claims is not None:
            try:
                pending = self.storage_claims() or []
            except Exception as e:
                self._warn(f"storage claims: {e!r}")
                pending = []
            for key, rec in pending:
                tok = int(await self.redis.incr(FENCE_COUNTER_KEY))
                ok = await self.redis.execute(
                    *self.placement.fenced_set_command(key, tok, rec))
                if not ok:
                    obs.CLUSTER_LEASE_FENCE_REJECTED.inc()
                    self._events.emit("cluster.fence_rejected",
                                      level="warn",
                                      node=self.config.node_id, key=key)
        if self.storage_repair is not None:
            from .placement import SHARD_KEY_PREFIX
            from .redis_client import scan_fenced
            records = await scan_fenced(self.redis, SHARD_KEY_PREFIX)
            parsed: dict[str, dict] = {}
            for key, (_tok, payload) in records.items():
                try:
                    rec = json.loads(payload)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("node"):
                    parsed[key] = rec
            try:
                self.storage_repair(nodes, parsed)
            except Exception as e:
                self._warn(f"storage repair scan: {e!r}")

    # -- fleet federation --------------------------------------------------
    async def _publish_fleet(self, nodes: dict) -> None:
        """Publish this node's rollup into the fenced TTL'd
        ``Fleet:{node}`` record, then refresh the cached aggregate every
        reader serves: each live peer's latest rollup plus the
        staleness-marked last rollup of any node whose lease died while
        its record's TTL still holds (last-known state, flagged — never
        a fresh lie, never a silent hole)."""
        if self.fleet_status is None:
            return
        from .redis_client import scan_fenced
        cfg = self.config
        try:
            roll = self.fleet_status() or {}
        except Exception as e:
            self._warn(f"fleet rollup: {e!r}")
            return
        roll.update({"node": cfg.node_id, "fence": self.lease.token or 0,
                     "ip": cfg.ip, "rtsp": cfg.rtsp_port,
                     "http": cfg.http_port})
        ttl = max(int(cfg.lease_ttl_sec * 3), int(cfg.heartbeat_sec * 3) + 1)
        await self.redis.execute(
            "EVAL", FENCE_SET_LUA, 1, fleet_mod.fleet_key(cfg.node_id),
            int(self.lease.token or 0),
            json.dumps(roll, separators=(",", ":")), ttl)
        obs.FLEET_PUBLISHES.inc()
        records = await scan_fenced(self.redis, fleet_mod.FLEET_KEY_PREFIX)
        now = time.time()
        agg: dict[str, dict] = {}
        for key, (_tok, payload) in records.items():
            try:
                rec = json.loads(payload)
            except ValueError:
                continue
            if not isinstance(rec, dict) or not rec.get("node"):
                continue
            nid = str(rec["node"])
            live = nid in nodes
            rec["live"] = live
            rec["age_sec"] = round(max(now - float(rec.get("ts") or now),
                                       0.0), 1)
            if not live:
                rec["stale"] = True
                if nid not in self._fleet_stale:
                    self._fleet_stale.add(nid)
                    self._events.emit("fleet.node_stale", level="warn",
                                      node=nid, age=rec["age_sec"])
            elif nid in self._fleet_stale:
                self._fleet_stale.discard(nid)
                self._events.emit("fleet.node_live", node=nid)
            agg[nid] = rec
        self.last_fleet = {"source": cfg.node_id,
                           "ts": round(now, 3),
                           "nodes": agg,
                           "nodes_live": sum(1 for r in agg.values()
                                             if r.get("live"))}
        fleet_mod.refresh_gauges(agg)

    # -- migration ---------------------------------------------------------
    async def _migration_scan(self, nodes: dict) -> None:
        """Adopt any stream whose recorded owner's lease is gone and
        whose deterministic successor (consistent hash over the LIVE
        lease set) is this node."""
        from .redis_client import scan_fenced
        cfg = self.config
        ring = self.placement.ring(nodes)
        records = await scan_fenced(self.redis, OWN_KEY_PREFIX)
        dvr_peers: dict[str, tuple[str, int, dict]] = {}
        owners: dict[str, str] = {}
        for key, (_token, payload) in records.items():
            try:
                rec = json.loads(payload)
            except ValueError:
                continue
            if not isinstance(rec, dict) or not rec.get("node"):
                continue            # corrupt record: skip, don't abort
            holder = str(rec["node"])
            path = "/" + key[len(OWN_KEY_PREFIX):]
            owners[path] = holder
            # DVR peer-fill map: a LIVE peer advertising
            # spilled windows for this path can warm our cold opens
            # through its spill files instead of origin
            dvr = rec.get("dvr")
            if (isinstance(dvr, dict) and dvr and holder != cfg.node_id
                    and holder in nodes):
                meta = nodes[holder]
                host, port = meta.get("ip"), meta.get("http")
                if host and port:
                    dvr_peers[path] = (str(host), int(port), dvr)
            if holder == cfg.node_id:
                continue                      # ours (serving or draining)
            if holder in nodes:
                # a LIVE holder draining this path to US (planned
                # rebalance): adopt through the published checkpoint
                # exactly like a crash migration.  The claim inside
                # _adopt flips the claimant only AFTER restore, so a
                # pusher re-resolving mid-drain always lands on a node
                # that already holds the subscribers
                if (rec.get("handoff_to") == cfg.node_id
                        and path not in self._claims
                        and path not in self._adopt_retry):
                    await self._adopt(path, holder, planned=True)
                continue
            if ring.owner(path) != cfg.node_id:
                continue                      # a different successor
            await self._adopt(path, holder)
        self.dvr_peers = dvr_peers
        self.owners = owners

    async def _adopt(self, path: str, from_node: str, *,
                     planned: bool = False) -> None:
        cfg = self.config
        raw_ckpt = await self.redis.fget(ckpt_key(path))
        if planned:
            # Planned drain: restore BEFORE claiming.  The gapless
            # contract is that the claimant never names a node without
            # the subscribers behind it — the source releases its data
            # plane the moment it sees the flip.  No adoption race
            # exists here (only the handoff_to target runs this branch),
            # so the crash path's claim-first ordering isn't needed: a
            # failed restore simply leaves the handoff record untouched
            # for the next scan, and the source reclaims on timeout.
            rp = self.pulls.pop(path, None)
            if rp is not None:
                await rp.stop()
            n_out = self._try_restore(path, raw_ckpt)
            if self.registry.find(path) is None:
                return
            tok = int(await self.redis.incr(FENCE_COUNTER_KEY))
            if not await self.placement.claim(path, tok,
                                              ttl=int(cfg.own_ttl_sec)):
                # a claim minted AFTER ours (rare: another writer's
                # INCR interleaved) holds the record: stand down
                self._fence_lost(path)
                return
            # NOTE: a source that timeout-reclaimed a beat earlier holds
            # an OLDER token, so this freshly minted claim overrides it
            # — the race is not prevented here, it is CONVERGED: the
            # loser's next heartbeat refresh hits the fence rejection
            # and releases (≤ one heartbeat of duplicate-seq dual
            # service, the same bounded window every crash-path claim
            # race has).  Single ownership within a tick either way.
            await self._finish_adoption(path, tok, n_out, from_node)
            return
        tok = int(await self.redis.incr(FENCE_COUNTER_KEY))
        if not await self.placement.claim(path, tok,
                                          ttl=int(cfg.own_ttl_sec)):
            return                            # lost an adoption race
        # drop any pull we were running toward the dead owner: the
        # stream is OURS now and the source will re-attach here
        rp = self.pulls.pop(path, None)
        if rp is not None:
            await rp.stop()
        n_out = self._try_restore(path, raw_ckpt)
        if self.registry.find(path) is None:
            # restore didn't materialize a session (transient factory/
            # egress failure): HOLD the fenced claim but park the path
            # for per-tick retry — recording it in _claims now would let
            # the stale-claim cleanup delete the published checkpoint,
            # destroying the only recovery state that exists
            self._adopt_retry[path] = (tok, 0)
            if raw_ckpt is not None:
                await self.redis.fset(ckpt_key(path), tok, raw_ckpt[1],
                                      ttl=int(cfg.migration_ttl_sec))
            return
        await self._finish_adoption(path, tok, n_out, from_node)

    async def _finish_adoption(self, path: str, tok: int, n_out: int,
                               from_node: str) -> None:
        """Book one completed adoption: claim recorded, checkpoint
        re-published under OUR token (a second failover keeps working),
        migration counted + latched event."""
        self._claims[path] = tok
        await self._publish_ckpt(path, tok)
        self.migrations += 1
        obs.CLUSTER_MIGRATIONS.inc()
        self._events.emit("cluster.migrate", level="warn", stream=path,
                          from_node=from_node, outputs=n_out)

    def _try_restore(self, path: str, raw_ckpt) -> int:
        """Run the app's restore hook on a fenced checkpoint payload;
        returns outputs restored (0 on failure — the caller decides
        whether a session materialized)."""
        if raw_ckpt is None or self.restore_doc is None:
            return 0
        try:
            _, n_out = self.restore_doc(json.loads(raw_ckpt[1]))
            return n_out
        except Exception as e:
            obs.RESILIENCE_CKPT_ERRORS.inc()
            self._warn(f"migration restore {path}: {e!r}")
            return 0

    async def _retry_adoptions(self) -> None:
        """Finish adoptions whose restore failed transiently; a path
        whose checkpoint is gone or that keeps failing is released so
        the ownership record doesn't point at a server with nothing
        behind it."""
        for path, (tok, tries) in list(self._adopt_retry.items()):
            if path in self._claims:
                # the source re-attached and _claim_local_sources minted
                # a NEWER claim while this adoption was parked: the live
                # session wins — installing the stale parked token would
                # fence US out next tick and tear the healthy stream down
                del self._adopt_retry[path]
                continue
            raw_ckpt = await self.redis.fget(ckpt_key(path))
            n_out = self._try_restore(path, raw_ckpt)
            if self.registry.find(path) is not None:
                del self._adopt_retry[path]
                await self._finish_adoption(path, tok, n_out, "retry")
            elif raw_ckpt is None or tries + 1 >= 10:
                del self._adopt_retry[path]
                await self.placement.release(path, tok)
            else:
                self._adopt_retry[path] = (tok, tries + 1)

    # -- remote pulls -------------------------------------------------------
    async def describe(self, path: str) -> str | None:
        """RTSP DESCRIBE fallback: a path another node owns is served
        locally through a pull relay; returns the SDP once the pull's
        session exists (None → the caller 404s).  A pull is started only
        for a path with a LIVE ownership claim — the hash ring names an
        'owner' for EVERY string, so without this gate a path-scanning
        client would turn each bogus DESCRIBE into a multi-tick
        cross-server retry loop."""
        if self.pull_manager is None:
            return None
        nodes = await self.placement.live_nodes()
        claimant = await self.placement.claimant(path)
        if (not claimant or claimant == self.config.node_id
                or claimant not in nodes):
            return None               # no live source anywhere: 404
        rp = self.ensure_pull(path)
        deadline = time.monotonic() + self.config.pull.connect_timeout_sec
        while time.monotonic() < deadline:
            text = self.registry.sdp_cache.get(path)
            if text is not None:
                return text
            if rp.breaker.state == "open":
                break
            await asyncio.sleep(0.05)
        return self.registry.sdp_cache.get(path)

    def ensure_pull(self, path: str) -> RemotePull:
        rp = self.pulls.get(path)
        if rp is None:
            import zlib
            # this node just became an origin→edge relay-tree edge for
            # ``path``: ONE pull upstream, local fan-out below it — the
            # origin sees E pulls instead of E×S subscribers
            obs.RELAY_TREE_EDGES.inc()
            rp = RemotePull(
                path, lambda: self._owner_url(path), self.pull_manager,
                self.config.pull,
                # crc32, not hash(): the jitter schedule must be the
                # same across processes (hash() is salt-randomized)
                seed=zlib.crc32(
                    f"{self.config.node_id}#{path}".encode()) & 0xFFFF,
                on_failure=self.on_pull_failure,
                # cluster-peer identity for the upstream's trace gate:
                # the origin tags its serving spans with OUR X-Trace-Id
                # only when this header names a live lease
                peer_headers={"x-cluster-node": self.config.node_id})
            self.pulls[path] = rp
            rp.start()
        return rp

    async def _owner_url(self, path: str) -> str | None:
        """Re-resolve the owner's pull URL (placement-aware: a migrated
        stream is re-pulled from its NEW owner automatically)."""
        res = await self.placement.resolve(path)
        if res is None:
            return None
        node, meta = res
        if node == self.config.node_id:
            return None                       # we became the owner
        ip, port = meta.get("ip"), meta.get("rtsp")
        if not ip or not port:
            return None
        return f"rtsp://{ip}:{int(port)}{path}"

    async def _sweep_pulls(self) -> None:
        """Retire pulls whose local audience left.  The idle budget
        covers the whole DESCRIBE wait window (connect timeout) plus
        one tick of SETUP-in-flight slack — the sweep must never win a
        race against a describe() that is still legitimately waiting on
        this pull's first SDP."""
        budget = max(2, int(self.config.pull.connect_timeout_sec
                            / max(self.config.heartbeat_sec, 0.05)) + 1)
        for path, rp in list(self.pulls.items()):
            sess = self.registry.find(path)
            if (sess is not None and sess.owner is not None
                    and sess.owner is not rp
                    and sess.owner is not rp._pull):
                # a LOCAL source adopted this session (a pusher was
                # directed here and re-ANNOUNCEd): the pull is
                # superseded — retire it so the path leaves self.pulls
                # and the claim machinery takes ownership next tick;
                # two feeds must never share one session
                self.pulls.pop(path, None)
                await rp.stop()
                continue
            idle = sess is None or sess.num_outputs == 0
            rp.idle_strikes = rp.idle_strikes + 1 if idle else 0
            if rp.idle_strikes >= budget:
                self.pulls.pop(path, None)
                await rp.stop()
                if (sess is not None
                        and self.registry.find(path) is sess
                        and sess.owner is rp):
                    self.registry.remove(path)

    # -- introspection ------------------------------------------------------
    def status(self) -> dict:
        return {
            "node": self.config.node_id,
            "lease_token": self.lease.token,
            "claims": dict(self._claims),
            "pulls": {p: {"alive": rp.alive, "retries": rp.retries,
                          "breaker": rp.breaker.state}
                      for p, rp in self.pulls.items()},
            "migrations": self.migrations,
            "ticks": self.ticks,
            "load": self.last_load,
            # initiations, deliberately NOT named like the metric:
            # cluster_rebalance_moves_total counts COMPLETED drains
            "rebalance_initiated": (self.rebalancer.moves
                                    if self.rebalancer is not None else 0),
        }
