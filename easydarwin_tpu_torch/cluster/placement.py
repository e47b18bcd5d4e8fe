"""Consistent-hash stream placement over live leases.

Who serves ``/live/cam1``?  The reference answers with the CMS's
least-loaded pick at stream-start and nothing afterwards — a dead server
is an outage for its streams.  Here placement is a pure function of the
LIVE lease set (``presence.ClusterRegistry``): every node hashes to
``vnodes`` points on a ring, a stream belongs to the first node
clockwise of its own hash, and when a lease expires the ring shrinks —
each orphaned stream lands on a DETERMINISTIC successor every surviving
node computes identically, so adoption needs no coordinator and no
election.  Node join/leave moves only ~1/N of the streams (the
consistent-hashing contract, pinned by ``tests/test_torch_cluster.py``).

Ownership is materialized as fenced ``Own:{path}`` records (claim token
= the claimant's freshly minted fencing token), so the ring decides who
*should* own while the fence decides whose writes *count* — a zombie
ex-owner that re-appears computes the same ring everyone else does, but
its stale claim token loses every fenced write
(``cluster_lease_fence_rejected_total``) and it must release the stream
instead of double-serving it.
"""

from __future__ import annotations

import bisect
import json
import zlib

from .. import obs
from .presence import ClusterRegistry

OWN_KEY_PREFIX = "Own:"
#: fenced erasure-shard claims: ``Shard:{asset}/t{t}/s{s}.{i}``
#: records ``{"node": holder}`` — the ring decides who SHOULD hold a
#: shard, the fence decides whose shard writes COUNT, exactly as with
#: stream ownership above
SHARD_KEY_PREFIX = "Shard:"
#: virtual points per node: enough that a 2..16-node ring splits paths
#: evenly, few enough that building the ring stays trivial
DEFAULT_VNODES = 64
#: capacity weighting never inflates one node past this many times the
#: base vnode count — a wild (or spoofed-high) capacity score must not
#: balloon the ring or starve every peer of keyspace
MAX_WEIGHT_FACTOR = 8
#: eligible redirect edges a flash crowd is spread across (hashed by
#: client key so one heartbeat's stale load ranking cannot funnel a
#: whole crowd onto a single edge)
EDGE_SPREAD = 4


def _h(s: str) -> int:
    return zlib.crc32(s.encode()) & 0xFFFFFFFF


def own_key(path: str) -> str:
    return f"{OWN_KEY_PREFIX}{path.strip('/')}"


def shard_key(asset: str, name: str) -> str:
    """Fenced claim key of one erasure shard of ``asset`` (``name`` is
    the ``t{track}/s{stripe}.{idx}`` relative shard name)."""
    return f"{SHARD_KEY_PREFIX}{asset.strip('/')}/{name}"


class HashRing:
    """Classic consistent-hash ring; order-insensitive in its node set
    (the ring is sorted by point, not by insertion).

    ``capacities`` (node → published capacity score) weights each node's
    vnode count by its capacity share: ``round(vnodes * cap / mean)``,
    clamped to [1, vnodes*MAX_WEIGHT_FACTOR].  The weighting is
    deterministic and order-insensitive (mean over the node set), and
    EQUAL capacities reproduce the unweighted ring byte-for-byte — a
    cluster of same-hardware peers upgrades with zero placement churn
    (pinned by tests/test_torch_cluster.py).  A node's points are always
    the prefix ``_h(f"{n}#{i}")`` for ``i < count``, so a capacity
    change only adds/removes THAT node's highest-index points — keyspace
    movement stays proportional to the capacity-share delta."""

    def __init__(self, nodes, vnodes: int = DEFAULT_VNODES,
                 capacities: dict | None = None):
        self.nodes = sorted(set(nodes))
        self.vnodes = vnodes
        self.capacities = dict(capacities or {})
        counts = self.vnode_counts()
        self._points: list[tuple[int, str]] = sorted(
            (_h(f"{n}#{i}"), n)
            for n in self.nodes for i in range(counts[n]))
        self._keys = [p for p, _ in self._points]

    def vnode_counts(self) -> dict[str, int]:
        """Virtual-point count per node.  Unweighted (every node missing
        a positive capacity) → exactly ``vnodes`` each."""
        if not self.nodes:
            return {}
        caps = self.capacities
        if not caps or any(not isinstance(caps.get(n), (int, float))
                           or caps.get(n, 0) <= 0 for n in self.nodes):
            return {n: self.vnodes for n in self.nodes}
        mean = sum(float(caps[n]) for n in self.nodes) / len(self.nodes)
        return {n: max(1, min(round(self.vnodes * float(caps[n]) / mean),
                              self.vnodes * MAX_WEIGHT_FACTOR))
                for n in self.nodes}

    def rank(self, path: str) -> list[str]:
        """Every node, in deterministic preference order for ``path``
        (clockwise ring walk, distinct nodes) — ``rank[0]`` is the
        owner, ``rank[1]`` the first failover successor."""
        if not self._points:
            return []
        start = bisect.bisect_left(self._keys, _h(path.strip("/")))
        seen: list[str] = []
        for i in range(len(self._points)):
            _, n = self._points[(start + i) % len(self._points)]
            if n not in seen:
                seen.append(n)
                if len(seen) == len(self.nodes):
                    break
        return seen

    def owner(self, path: str) -> str | None:
        r = self.rank(path)
        return r[0] if r else None


class PlacementService:
    """Placement decisions + fenced ownership claims for one node."""

    def __init__(self, redis, node_id: str, *,
                 vnodes: int = DEFAULT_VNODES, events=None):
        self.redis = redis
        self.node_id = node_id
        self.vnodes = vnodes
        self._events = events if events is not None else obs.EVENTS
        #: last observed owner per path — placement-move edge detection
        self._observed: dict[str, str] = {}

    async def live_nodes(self) -> dict[str, dict]:
        return await ClusterRegistry.live_nodes(self.redis)

    def ring(self, nodes) -> HashRing:
        """The placement ring over ``nodes`` — capacity-weighted when
        EVERY live node publishes a positive ``cap`` in its lease record
        (a mixed-version cluster mid-upgrade stays unweighted: every
        peer computes the same verdict from the same records either
        way)."""
        caps = None
        if isinstance(nodes, dict):
            got = {n: m.get("cap") for n, m in nodes.items()
                   if isinstance(m, dict)}
            if len(got) == len(nodes) and all(
                    isinstance(c, (int, float)) and c > 0
                    for c in got.values()):
                caps = {n: float(c) for n, c in got.items()}
        return HashRing(nodes, self.vnodes, capacities=caps)

    def successors(self, path: str, nodes: dict) -> list[str]:
        """The load-ranked successor list for ``path``: the ring's
        deterministic owner first (stickiness is resolve()'s job), then
        every other live node ordered by published utilization (ties
        broken by ring preference order) — the failover / relay-edge
        candidate ordering."""
        order = self.ring(nodes).rank(path)
        if len(order) <= 1:
            return order

        def util(n: str) -> float:
            u = (nodes.get(n) or {}).get("util")
            return float(u) if isinstance(u, (int, float)) else 0.0

        return [order[0]] + sorted(
            order[1:], key=lambda n: (util(n), order.index(n)))

    def edge_for(self, path: str, nodes: dict, *, client_key: str = "",
                 exclude=(), high_water: float | None = None
                 ) -> str | None:
        """The placement-resolved EDGE node a refused subscriber is
        redirected to: live successors under the utilization high-water
        mark, load-ranked, with the client key hashed across the top
        ``EDGE_SPREAD`` so a crowd fans over several edges.  Pure
        function of (path, client_key, nodes) — the admission 305's
        Location equals this resolution by construction (pinned by
        test)."""
        excl = set(exclude)
        # mixed-version rule, mirroring ring(): in a cluster where ANY
        # node publishes utilization, a node that doesn't is NOT a
        # redirect target — unknown load is not headroom, and shipping
        # a flash crowd onto an unreporting (possibly saturated) peer
        # is the melt the admission gate exists to prevent.  When NO
        # node publishes (pre-upgrade cluster) the filter is moot and
        # placement stays load-blind, same verdict on every peer.
        any_util = any(isinstance((nodes.get(n) or {}).get("util"),
                                  (int, float)) for n in nodes)
        cands = []
        for n in self.successors(path, nodes):
            if n in excl:
                continue
            u = (nodes.get(n) or {}).get("util")
            if high_water is not None and any_util:
                if not isinstance(u, (int, float)) or u >= high_water:
                    continue
            cands.append(n)
        if not cands:
            return None
        spread = cands[:EDGE_SPREAD]
        return spread[_h(f"{path.strip('/')}#{client_key}") % len(spread)]

    async def resolve(self, path: str,
                      nodes: dict[str, dict] | None = None
                      ) -> tuple[str, dict] | None:
        """The node currently responsible for ``path``: a LIVE claimant
        recorded in ``Own:{path}`` wins (placement is sticky while the
        owner lives); otherwise the consistent-hash owner over the live
        lease set — the deterministic re-placement every peer agrees on
        when a lease expires.  None when the cluster is empty."""
        if nodes is None:
            nodes = await self.live_nodes()
        if not nodes:
            return None
        claimed = await self.claimant(path)
        if claimed is not None and claimed in nodes:
            self._note(path, claimed)
            return claimed, nodes[claimed]
        owner = self.ring(nodes).owner(path)
        if owner is None:
            return None
        self._note(path, owner)
        return owner, nodes[owner]

    async def claim_record(self, path: str) -> tuple[int, dict] | None:
        """The parsed ``Own:{path}`` record with its fencing token, or
        None when absent/corrupt.  The record's ``handoff_to`` key
        marks a planned rebalance hand-off (cluster/service.py): the
        recorded node is still the SERVING source; the named target
        flips the claimant only when its checkpoint adoption claims."""
        cur = await self.redis.fget(own_key(path))
        if cur is None:
            return None
        try:
            rec = json.loads(cur[1])
        except ValueError:
            return None
        if not isinstance(rec, dict) or not rec.get("node"):
            return None
        return int(cur[0]), rec

    async def claimant(self, path: str) -> str | None:
        """The node recorded in ``Own:{path}`` (live or not)."""
        # non-dict JSON / missing node (a corrupt or operator-written
        # record) must read as "unclaimed", not crash the caller's tick
        # or fabricate a truthy "None" phantom node id
        rec = await self.claim_record(path)
        return str(rec[1]["node"]) if rec is not None else None

    def _note(self, path: str, owner: str) -> None:
        prev = self._observed.get(path)
        self._observed[path] = owner
        if prev is not None and prev != owner:
            obs.CLUSTER_PLACEMENT_MOVES.inc()
            self._events.emit("cluster.placement_move", stream=path,
                              owner=owner, prev=prev)

    def forget(self, path: str) -> None:
        self._observed.pop(path, None)

    # -- fenced claims -----------------------------------------------------
    def claim_command(self, path: str, token: int, *, ttl: int = 0,
                      extra: dict | None = None):
        """The pipeline-able form of :meth:`claim` (fenced EVAL fset);
        pair each pipelined reply with :meth:`claim_result`.  ``extra``
        rides the record as its ``dvr`` key — the spilled-window
        advertisement peers consult for cache peer-fill."""
        from .redis_client import FENCE_SET_LUA
        rec: dict = {"node": self.node_id}
        if extra:
            rec["dvr"] = extra
        return ("EVAL", FENCE_SET_LUA, 1, own_key(path), int(token),
                json.dumps(rec, separators=(",", ":")),
                int(ttl))

    def fenced_set_command(self, key: str, token: int, record: dict, *,
                           ttl: int = 0):
        """A pipeline-able fenced EVAL fset over an ARBITRARY key (the
        ``Shard:`` claim writes ride this through the cluster tick) —
        same Lua, same token discipline as :meth:`claim_command`."""
        from .redis_client import FENCE_SET_LUA
        return ("EVAL", FENCE_SET_LUA, 1, key, int(token),
                json.dumps(record, separators=(",", ":")), int(ttl))

    def claim_result(self, path: str, ok) -> bool:
        """Book one claim attempt's outcome (move note / rejection
        counter + event); returns the boolean verdict."""
        if ok:
            self._note(path, self.node_id)
        else:
            obs.CLUSTER_LEASE_FENCE_REJECTED.inc()
            self._events.emit("cluster.fence_rejected", level="warn",
                              node=self.node_id, key=own_key(path),
                              stream=path)
        return bool(ok)

    async def claim(self, path: str, token: int, *, ttl: int = 0,
                    extra: dict | None = None) -> bool:
        """Record this node as ``path``'s owner, fenced by ``token``.
        False = a newer token holds the record (we are the zombie)."""
        ok = await self.redis.execute(
            *self.claim_command(path, token, ttl=ttl, extra=extra))
        return self.claim_result(path, ok)

    async def release(self, path: str, token: int) -> bool:
        self.forget(path)
        return await self.redis.fdel(own_key(path), token)
