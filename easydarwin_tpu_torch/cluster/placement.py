"""Consistent-hash placement, trimmed to what the storage tier uses.

A copy of the reference's ``cluster/placement.py`` without the
``PlacementService`` (fenced ``Own:`` claims over the lease registry):
the shard-claim key helpers and the capacity-weighted ``HashRing``.  A
single-node store never builds a ring; the storage service keeps the
reference's ``ring_for`` hook so a cluster tier can hand it one.

Placement is a pure function of the node set: every node hashes to
``vnodes`` points on a ring (weighted by published capacity, clamped to
``MAX_WEIGHT_FACTOR`` times the base count), and a key belongs to the
first node clockwise of its own hash.
"""

from __future__ import annotations

import bisect
import zlib

#: fenced erasure-shard claims: ``Shard:{asset}/t{t}/s{s}.{i}`` records
#: ``{"node": holder}``
SHARD_KEY_PREFIX = "Shard:"
#: virtual points per node
DEFAULT_VNODES = 64
#: capacity weighting never inflates one node past this many times the
#: base vnode count
MAX_WEIGHT_FACTOR = 8


def _h(s: str) -> int:
    return zlib.crc32(s.encode()) & 0xFFFFFFFF


def shard_key(asset: str, name: str) -> str:
    """Fenced claim key of one erasure shard of ``asset`` (``name`` is
    the ``t{track}/s{stripe}.{idx}`` relative shard name)."""
    return f"{SHARD_KEY_PREFIX}{asset.strip('/')}/{name}"


class HashRing:
    """Consistent-hash ring, insensitive to the order of its node set.

    ``capacities`` (node → published capacity score) weights each node's
    vnode count by ``round(vnodes * cap / mean)``, clamped to
    ``[1, vnodes * MAX_WEIGHT_FACTOR]``; equal capacities (or any node
    without a positive one) give exactly ``vnodes`` each.  A node's
    points are the prefix ``_h(f"{n}#{i}")`` for ``i < count``."""

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
        """Every node in preference order for ``path`` (clockwise walk,
        distinct nodes): ``rank[0]`` owns it."""
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


__all__ = ["SHARD_KEY_PREFIX", "DEFAULT_VNODES", "MAX_WEIGHT_FACTOR",
           "HashRing", "shard_key"]
