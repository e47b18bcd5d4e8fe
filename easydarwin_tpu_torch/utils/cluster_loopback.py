"""The cluster tier on two CLI servers: a cross-server pull, a SIGKILL of
the owner and the migration.

``cluster_kill(device, folder, seed=...)`` runs the port's
``MiniRedisServer`` in this process and two servers as ``python -m
easydarwin_tpu_torch --device DEVICE -c node_{a,b}.toml`` (written under
``folder``), with ``cluster_enabled``, their own ``server_id``s and the
lease settings of the reference's ``tools/soak.py --cluster``
(``CLUSTER_KEYS``).  Then:

1. ``paths`` H.264 pushers on node A (interleaved TCP, paced like a
   camera), one UDP player a path on A, and once A's claims are in Redis
   an interleaved player of the first path on node B, which B serves
   through a ``RemotePull`` from A.  The pulled payloads must equal the
   pushed ones from byte 12, in push order, and B's ``x-freshness``
   answer for the path must be a chain of two hops (A, then B).
2. SIGKILL of A.  The pushers stop; the harness waits for B's fenced
   claim on every path (the reference's 10 s failover budget), reads
   B's ``/api/v1/fleet`` (both nodes, A stale) and re-pushes each path
   to B, its last ``TAIL`` packets first, as the soak's pusher does.
3. The UDP players, which never re-SETUP, must keep their SSRC, and every
   payload must be a pushed one.  The seq rewrite is affine in the
   source seq, and the source's seq is its push index plus a constant,
   so a player's seq minus the push index of its payload must be one
   constant over the whole run (``seq_check``): the adopter's rewrite
   resumes from the checkpoint, never from a fresh join.  No push index
   between a player's first and last may be missing, and only the
   resent tail may repeat (at most ``TAIL`` packets).
4. B's ``/metrics``: ``cluster_migrations_total`` at least one a path,
   ``megabatch_passes_total`` grown after the adoption (one
   ``ed_relay_window`` launch a pass on a card) and
   ``megabatch_wire_mismatch_total`` 0; B's exit stats: no pump or device
   error (``CliServer.stop``), no pass on the host scalar path, every
   path on a device rung and no pull failure charged to the ladder (the
   pull's failures after the kill are the network's), and the
   scheduler's window calls equal to its ``ed_relay_window`` launches on
   a card.

``paths`` is 3 by default: the megabatch engages at two streams with
players (``server.app.MEGABATCH_MIN_STREAMS``), and the SLO watchdog's
burn may move its worst stream to the device rung (the engine's own ring
on the card, off the megabatch), so a third path keeps two on it.

It returns the figures ``chip_smoke.py`` phase 17 prints: kill → adopt
seconds, the seq gap and duplicates, B's wake host ms p50/p99, the
capacity score and the packets each player got.  Async; call it under
``asyncio.run``.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import time

import numpy as np

from ..cluster.placement import own_key
from ..cluster.redis_client import MiniRedisServer
from ..protocol import rtp
from ..resilience.ladder import LEVEL_DEVICE
from .chaos_loopback import _player, _pusher, _Source
from .loopback import CliServer, check, http_get_json, metric_totals

#: the soak's cluster settings (``tools/soak.py _cluster_node_main``)
CLUSTER_KEYS = {"cluster_enabled": True, "cluster_lease_ttl_sec": 2.0,
                "cluster_heartbeat_sec": 0.5,
                "cluster_pull_connect_timeout_sec": 3.0,
                "cluster_pull_read_timeout_sec": 1.5,
                "cluster_pull_backoff_ms": 150.0,
                "reflect_interval_ms": 10, "bucket_delay_ms": 0,
                "access_log_enabled": False}
#: the reference's failover budget, s
ADOPT_BUDGET_S = 10.0
#: seconds B's fleet rollup may take to mark A stale after the adoption
#: (a few of the soak's 0.5 s heartbeats)
FLEET_WAIT_S = 3.0
#: packets a pusher keeps and resends to the new owner
TAIL = 64
#: B's ``/metrics`` families the harness reads
FAMILIES = ("cluster_migrations_total", "megabatch_passes_total",
            "megabatch_wire_mismatch_total", "cluster_capacity_score",
            "cluster_lease_acquired_total", "cluster_pull_retries_total")


def write_node_config(folder: str, node: str, redis_port: int) -> str:
    """One node's TOML: ``CLUSTER_KEYS``, its id, the Redis and its own
    log and movie folders."""
    base = os.path.join(folder, node)
    os.makedirs(base, exist_ok=True)
    keys = {**CLUSTER_KEYS, "server_id": node, "redis_port": redis_port,
            "log_folder": os.path.join(base, "logs"),
            "movie_folder": os.path.join(base, "movies")}
    lines = []
    for k, v in keys.items():
        if isinstance(v, bool):
            v = "true" if v else "false"
        elif isinstance(v, str):
            v = json.dumps(v)
        lines.append(f"{k} = {v}")
    path = os.path.join(base, f"{node}.toml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def seq_check(seqs: list[int], idxs: list[int]) -> tuple[int, int, int]:
    """(offsets, missing, repeats) of a player's rewritten ``seqs`` and the
    push indices ``idxs`` of their payloads, in arrival order: the number
    of distinct ``seq - index`` (mod 2^16; 1 for an affine rewrite that
    never rebased), the indices missing between the first and the last
    received, and the packets received more than once."""
    offsets = {(s - i) & 0xFFFF for s, i in zip(seqs, idxs)}
    got = set(idxs)
    missing = max(got) - min(got) + 1 - len(got) if got else 0
    return len(offsets), missing, len(idxs) - len(got)


async def _claimants(backend, paths) -> dict:
    out = {}
    for p in paths:
        cur = await backend.fget(own_key(p))
        out[p] = None if cur is None else json.loads(cur[1]).get("node")
    return out


async def _wait(pred, timeout_s: float, what: str,
                step_s: float = 0.05) -> float:
    """Poll the async ``pred`` until it holds; returns the seconds."""
    t0 = time.monotonic()
    while not await pred():
        check(time.monotonic() - t0 < timeout_s,
              f"{what} not within {timeout_s} s")
        await asyncio.sleep(step_s)
    return time.monotonic() - t0


async def cluster_kill(device: str, folder: str, *, seed: int = 17,
                       paths: int = 3, frame_s: float = 1 / 30,
                       pull_s: float = 2.5, after_s: float = 3.0) -> dict:
    rng = np.random.default_rng(seed)
    names = [f"/live/cam{k}" for k in range(paths)]
    srcs = [_Source(rng, k, frames=15, packets_per_frame=4,
                    body_len=(40, 300)) for k in range(paths)]
    #: every pushed packet a path, in push order
    pushed: list[list[bytes]] = [[] for _ in range(paths)]
    tails = [collections.deque(maxlen=TAIL) for _ in range(paths)]
    mini = MiniRedisServer()
    await mini.start()
    cfgs = [write_node_config(folder, n, mini.port)
            for n in ("node-a", "node-b")]
    a, b = (CliServer(device, "-c", c) for c in cfgs)
    clients = []
    t_phase = time.monotonic()
    try:
        await asyncio.gather(a.__aenter__(), b.__aenter__())
        pushers = [await _pusher(a.rtsp_port, p, udp=False) for p in names]
        clients += pushers
        players = []
        for p in names:
            pl, ssrc = await _player(a.rtsp_port, p, "udp")
            clients.append(pl)
            players.append((pl, ssrc))

        pumping = True

        async def pump(targets) -> None:
            while pumping:
                for k, c in enumerate(targets):
                    for pkt in srcs[k].next_frame():
                        c.push(pkt)
                        pushed[k].append(pkt)
                        tails[k].append(pkt)
                await asyncio.sleep(frame_s)

        task = asyncio.create_task(pump(pushers))
        await _wait(lambda: _has_claims(mini.backend, names, "node-a"),
                    10.0, "node A's claims")
        # an interleaved player on the node that does not own the path:
        # its DESCRIBE starts B's pull
        puller, _ = await _player(b.rtsp_port, names[0], "tcp")
        clients.append(puller)
        await asyncio.sleep(pull_s)
        fresh = await puller.request(
            "GET_PARAMETER", f"rtsp://127.0.0.1:{b.rtsp_port}{names[0]}",
            {"content-type": "text/parameters"}, b"x-freshness")
        chain = json.loads(fresh.body)
        check([h.get("node") for h in chain] == ["node-a", "node-b"],
              f"B's freshness chain for {names[0]}: {chain}")
        before_b = await metric_totals(b.rest_port, FAMILIES)

        # --- the kill
        pumping = False
        await task
        n_before = [len(pl.frames) for pl, _ in players]
        n_pull_before = len(puller.frames)
        a.proc.kill()
        t_kill = time.monotonic()
        await a.proc.wait()

        async def adopted() -> bool:
            return set((await _claimants(mini.backend, names)).values()) \
                == {"node-b"}
        adopt_s = await _wait(adopted, ADOPT_BUDGET_S, "B's adoption")
        at_adopt = await metric_totals(b.rest_port, FAMILIES)
        fleet: dict = {}

        async def fleet_marks_a_stale() -> bool:
            # the tick adopts before it publishes the fleet rollup, so
            # the rollup may lag the claims by a tick
            status, body = await http_get_json(b.rest_port, "/api/v1/fleet")
            check(status == 200, f"B's fleet answered {status}")
            fleet.update(body)
            nodes = body.get("nodes") or {}
            return (nodes.get("node-a") or {}).get("stale") is True
        await _wait(fleet_marks_a_stale, FLEET_WAIT_S,
                    "B's fleet marking A stale", step_s=0.1)
        nodes = fleet.get("nodes") or {}
        check(set(nodes) >= {"node-a", "node-b"}
              and nodes["node-b"].get("live") is True,
              f"B's fleet lists {sorted(nodes)}, B "
              f"{(nodes.get('node-b') or {}).get('live')!r} live")

        # --- the re-push to the adopter, the tail first
        pushers = [await _pusher(b.rtsp_port, p, udp=False) for p in names]
        clients += pushers
        for c, tail in zip(pushers, tails):
            for pkt in tail:
                c.push(pkt)
        pumping = True
        task = asyncio.create_task(pump(pushers))
        await asyncio.sleep(after_s)
        pumping = False
        await task
        await asyncio.sleep(0.5)
        after_b = await metric_totals(b.rest_port, FAMILIES)
        for c in clients:
            await c.close()
        clients = []
        stats_b = await b.stop()
    finally:
        for c in clients:
            await c.close()
        await a.__aexit__(None, None, None)
        await b.__aexit__(None, None, None)
        await mini.stop()

    # --- the players
    index = [{p[12:]: i for i, p in enumerate(seq)} for seq in pushed]
    out_players = []
    gap_total = back_total = 0
    offsets_max = 0
    for k, (pl, ssrc) in enumerate(players):
        frames = list(pl.frames)
        check(len(frames) > n_before[k] > 0,
              f"UDP player {k}: {n_before[k]} packets before the kill, "
              f"{len(frames) - n_before[k]} after")
        check({rtp.peek_ssrc(f) for f in frames} == {ssrc},
              f"UDP player {k}: the SSRC changed across the migration")
        check(all(f[12:] in index[k] for f in frames),
              f"UDP player {k}: a payload that was not pushed")
        offsets, gap, back = seq_check([rtp.peek_seq(f) for f in frames],
                                       [index[k][f[12:]] for f in frames])
        check(offsets == 1, f"UDP player {k}: {offsets} seq offsets from "
                            f"the push index (the rewrite rebased)")
        check(gap == 0, f"UDP player {k}: {gap} seqs missing across the "
                        f"migration")
        check(back <= TAIL, f"UDP player {k}: {back} repeated packets, "
                            f"more than the {TAIL} resent")
        offsets_max = max(offsets_max, offsets)
        gap_total += gap
        back_total += back
        out_players.append([n_before[k], len(frames) - n_before[k]])
    pulled = [index[0].get(f[12:]) for f in puller.frames[:n_pull_before]]
    check(len(pulled) >= 10 and None not in pulled
          and all(y - x == 1 for x, y in zip(pulled, pulled[1:])),
          f"the pulled player's payloads are not the pushed ones in order "
          f"({len(pulled)} packets)")

    # --- node B
    migrations = after_b["cluster_migrations_total"]
    passes_after = (after_b["megabatch_passes_total"]
                    - at_adopt["megabatch_passes_total"])
    check(migrations >= paths, f"B counted {migrations} migrations")
    check(passes_after > 0, "B ran no megabatch pass after the adoption")
    check(after_b["megabatch_wire_mismatch_total"] == 0,
          "B's megabatch disagreed with its host oracle")
    res_b = stats_b["resilience"]
    ladder = res_b["ladder"] or {}
    check(res_b["host_steps"] == 0 and res_b["pull_errors_injected"] == 0
          and all(st["level"] <= LEVEL_DEVICE
                  for st in (ladder.get("streams") or {}).values()),
          f"B served on the host: {res_b['host_steps']} host passes, "
          f"{res_b['pull_errors_injected']} pull errors charged, ladder "
          f"{ladder}")
    launches = stats_b["kernel_launches"]
    window_calls = stats_b["megabatch"]["window_calls"]
    if device == "cuda":
        check(launches.get("ed_relay_window", 0) == window_calls > 0,
              f"B: ed_relay_window launches {launches.get('ed_relay_window')}"
              f" != window calls {window_calls}")
    cl = stats_b["cluster"] or {}
    return {
        "paths": paths, "adopt_s": adopt_s,
        "seq_gap": gap_total, "seq_offsets": offsets_max,
        "resent_or_dup": back_total,
        "pull_errors": res_b["pull_errors"],
        "host_steps": res_b["host_steps"],
        "ladder_degrades": ladder.get("degrades"),
        "udp_packets": out_players,
        "pull_packets": [n_pull_before, len(puller.frames) - n_pull_before],
        "freshness_hops": len(chain),
        "fleet": {n: {k: nodes[n].get(k) for k in ("live", "stale")}
                  for n in sorted(nodes)},
        "migrations": migrations,
        "megabatch_passes": {"before_kill": before_b["megabatch_passes_total"],
                             "after_adoption": passes_after},
        "window_calls": window_calls, "kernel_launches": launches,
        "capacity_score": after_b["cluster_capacity_score"],
        "capacity_pps": cl.get("capacity_pps"),
        "wake_ms_p50": stats_b["wake_ms_p50"],
        "wake_ms_p99": stats_b["wake_ms_p99"],
        "pull_retries": after_b["cluster_pull_retries_total"],
        "server_stats": stats_b,
        "seconds": time.monotonic() - t_phase,
        "kill_to_end_s": time.monotonic() - t_kill,
    }


async def _has_claims(backend, paths, node: str) -> bool:
    return set((await _claimants(backend, paths)).values()) == {node}


__all__ = ["ADOPT_BUDGET_S", "CLUSTER_KEYS", "TAIL", "cluster_kill",
           "seq_check", "write_node_config"]
