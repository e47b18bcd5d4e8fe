"""Fleet observability: rollups, freshness chains, trace stitching.

PAPER.md's signature production feature is the EasyCMS tier — ONE place
that answers "what is every node serving and how healthy is it".  The
rest of the obs stack is strictly per-process; this module makes the
cluster one observable system:

* **rollups** — :func:`build_rollup` condenses one node's registry,
  status monitor, SLO budget, ladder rungs, tier populations and
  divergence tripwires into a compact JSON-able document.  The cluster
  service publishes it into a TTL'd fenced ``Fleet:{node}`` record
  every heartbeat and caches the aggregate (``ClusterService
  .last_fleet``); ``GET /api/v1/fleet`` / ``admin command=fleet`` on
  ANY node serve that aggregate — the ``getserverinfo`` heritage at
  cluster scale, with dead nodes' last rollups staleness-marked
  instead of silently dropped.
* **freshness chains** — every hop of a relay tree stamps its latest
  ingest wall-clock; an edge's pull polls the origin's chain
  (RTSP ``GET_PARAMETER x-freshness``) and appends its own stamp, so
  ``relay_e2e_freshness_seconds{hops}`` measures pusher→origin→edge→
  wire end to end without touching the media wire format.
* **trace stitching** — ``GET /api/v1/sessions/<id>/trace`` resolves
  the session's stream path, then follows the node's pull record and
  the cluster's ``Own:`` scan upstream, fetching each hop's local view
  (``/api/v1/streamtrace``) until the origin: one document, every hop,
  one ``trace_id`` (propagation: DESCRIBE replies carry the stream
  trace downstream; pulls echo it upstream via ``X-Trace-Id``,
  accepted only from live cluster peers; migration checkpoints carry
  the trace + node lineage).
"""

from __future__ import annotations

import time

from . import families
from .events import EVENTS, NODE
from .flight import FLIGHT

#: Redis key prefix of the per-node federation records
FLEET_KEY_PREFIX = "Fleet:"
#: closed serving-tier vocabulary of ``fleet_streams_total{tier}``
FLEET_TIERS = ("live", "pull", "vod", "dvr", "hls")
#: upstream hops a trace stitch / freshness chain will follow — a relay
#: tree deeper than this is an operator error worth surfacing as a
#: truncated chain, not an unbounded HTTP crawl
MAX_TRACE_HOPS = 4
#: a stream counts as actively relaying (freshness observed) only when
#: it ingested within this window — an idle stream's "staleness" is
#: just its age, not a delivery-health signal
FRESHNESS_ACTIVE_MS = 5000


def fleet_key(node_id: str) -> str:
    return f"{FLEET_KEY_PREFIX}{node_id}"


def _ingest_wall(sess) -> float:
    """Wall-clock time of the session's last ingest, derived from its
    monotonic stamp at read time (zero per-packet cost)."""
    from ..relay.session import now_ms
    return time.time() - max(now_ms() - sess.last_ingest_ms, 0) / 1000.0


def freshness_chain(sess, node_id: str) -> list[dict]:
    """The per-stream freshness chain, origin hop first.

    A locally-sourced session contributes one hop (this node's latest
    ingest wall-clock).  A pull-fed session prepends whatever chain its
    feeder's freshness poll last fetched from upstream (itself
    recursive, so a 3-level tree yields 3 hops), then appends this
    node's own stamp."""
    chain: list[dict] = []
    upstream = getattr(getattr(sess, "owner", None), "upstream_chain", None)
    if upstream:
        chain = [dict(h) for h in upstream
                 if isinstance(h, dict)][:MAX_TRACE_HOPS]
    chain.append({"node": node_id, "ingest": round(_ingest_wall(sess), 3)})
    return chain


def observe_freshness(app) -> None:
    """1 Hz maintenance duty: observe each actively-relaying stream's
    end-to-end freshness against the FIRST hop of its chain."""
    from ..relay.session import now_ms
    t = now_ms()
    nid = app.config.server_id
    for sess in list(app.registry.sessions.values()):
        if sess.num_outputs <= 0 \
                or t - sess.last_ingest_ms > FRESHNESS_ACTIVE_MS:
            continue
        chain = freshness_chain(sess, nid)
        origin = chain[0].get("ingest")
        if not isinstance(origin, (int, float)):
            continue
        families.RELAY_E2E_FRESHNESS.observe(
            max(time.time() - origin, 0.0),
            hops=str(min(len(chain), MAX_TRACE_HOPS + 1)))


# ------------------------------------------------------------- rollups
def _stream_tier(app, sess) -> str:
    owner = sess.owner
    if owner is not None and hasattr(owner, "upstream_chain"):
        return "pull"                   # fed by a pull relay
    return "live"


def _audience_rollup() -> dict:
    """The audience store's compact aggregate, never raising from the
    cluster tick (a broken column pass must not stop federation)."""
    try:
        from .audience import AUDIENCE
        return AUDIENCE.rollup()
    except Exception:
        return {}


def build_rollup(app) -> dict:
    """One node's compact federation rollup (the ``Fleet:{node}``
    payload): headline counters, SLO budget, ladder rungs, per-tier
    populations, divergence tripwires, active streams + relay-tree
    edges.  Pure reads — safe from the cluster tick."""
    snap = app.status.snapshot()
    nid = app.config.server_id
    tiers = dict.fromkeys(FLEET_TIERS, 0)
    streams: dict[str, dict] = {}
    subs = 0
    for sess in list(app.registry.sessions.values()):
        tier = _stream_tier(app, sess)
        tiers[tier] += 1
        subs += sess.num_outputs
        chain = freshness_chain(sess, nid)
        streams[sess.path] = {
            "tier": tier,
            "outputs": sess.num_outputs,
            "hops": len(chain),
            "ingest_wall": chain[-1]["ingest"],
        }
    pacer = getattr(app, "vod_pacer", None)
    if pacer is not None:
        tiers["vod"] = len(getattr(pacer, "sessions", ()) or ())
    tiers["dvr"] = int(families.DVR_TIMESHIFT_SESSIONS.value())
    hls = getattr(app, "hls", None)
    if hls is not None:
        tiers["hls"] = len(getattr(hls, "outputs", ()) or ())
    # rollup-local packet rates: the status console's rates only move
    # when its loop ticks (off on headless cluster nodes), so the
    # federation differences the cumulative counters itself between
    # publishes — every node's rollup carries live rates regardless of
    # which operator surfaces are enabled
    now_mono = time.monotonic()
    pin = int(snap.get("packets_in", 0))
    pout = int(snap.get("packets_out", 0))
    prev = getattr(app, "_fleet_rate_state", None)
    in_pps = out_pps = 0.0
    if prev is not None:
        dt = now_mono - prev[0]
        if dt >= 0.2:
            in_pps = max(pin - prev[1], 0) / dt
            out_pps = max(pout - prev[2], 0) / dt
            app._fleet_rate_state = (now_mono, pin, pout, in_pps, out_pps)
        else:
            in_pps, out_pps = prev[3], prev[4]
    else:
        app._fleet_rate_state = (now_mono, pin, pout, 0.0, 0.0)
    slo = getattr(app, "slo", None)
    budget = {}
    if slo is not None:
        fam = families.SLO_BUDGET_REMAINING
        budget = {",".join(k): round(v, 4)
                  for k, v in fam._values.items()}
    rungs = {",".join(k): int(v)
             for k, v in families.RESILIENCE_LADDER_LEVEL._values.items()
             if v}
    cl = getattr(app, "cluster", None)
    lt = getattr(app, "load_tracker", None)
    doc = {
        "node": nid,
        "ts": round(time.time(), 3),
        "headline": {
            "in_pps": round(in_pps, 1),
            "out_pps": round(out_pps, 1),
            "connections": snap.get("rtsp_connections", 0),
            "subscribers": subs,
            "itw_p99_ms": snap.get("ingest_to_wire_p99_ms", 0.0),
            "uptime_sec": snap.get("uptime_sec", 0),
        },
        "slo": {
            "violations": int(families.SLO_VIOLATIONS.total()),
            "budget": budget,
        },
        "ladder": rungs,
        "tiers": tiers,
        "streams": streams,
        "relay_edges": sorted(cl.pulls) if cl is not None else [],
        "mismatches": {
            "megabatch_wire": int(families.MEGABATCH_WIRE_MISMATCH.total()),
            "fec_oracle":
                int(families.FEC_PARITY_ORACLE_MISMATCH.total()),
            "requant_reassembly":
                int(families.REQUANT_REASSEMBLY_MISMATCH.total()),
        },
        "freshness_p99_s":
            round(families.RELAY_E2E_FRESHNESS.quantile(0.99), 4),
        # audience observatory: the viewer-experience
        # aggregate rides every rollup so /api/v1/fleet answers "how
        # is the audience doing" cluster-wide without extra RPCs
        "audience": _audience_rollup(),
    }
    if lt is not None:
        doc["util"] = round(getattr(lt, "last_util", 0.0), 4)
        doc["cap"] = getattr(lt, "capacity_pps", None)
    return doc


def refresh_gauges(nodes: dict) -> None:
    """Re-derive the fleet gauges from one aggregate's node map."""
    live = [rec for rec in nodes.values()
            if isinstance(rec, dict) and rec.get("live", True)]
    families.FLEET_NODES_LIVE.set(len(live))
    for tier in FLEET_TIERS:
        families.FLEET_STREAMS.set(
            sum(int((rec.get("tiers") or {}).get(tier, 0))
                for rec in live), tier=tier)


def fleet_snapshot(app) -> dict:
    """The aggregate topology document ``GET /api/v1/fleet`` serves.

    Under cluster mode this is the cluster tick's cached aggregation
    (refreshed every heartbeat; a read must never wait on Redis) with
    this node's own rollup rebuilt live.  Standalone servers answer a
    single-node fleet — the same shape, so dashboards don't care."""
    cl = getattr(app, "cluster", None)
    own = build_rollup(app)
    own["live"] = True
    own["fence"] = NODE["fence"]
    if cl is not None and cl.last_fleet:
        doc = {k: v for k, v in cl.last_fleet.items() if k != "nodes"}
        nodes = dict(cl.last_fleet.get("nodes") or {})
        prev = nodes.get(own["node"])
        if isinstance(prev, dict):
            own = {**prev, **own}
        nodes[own["node"]] = own
        doc["nodes"] = nodes
        doc["nodes_live"] = sum(
            1 for r in nodes.values()
            if isinstance(r, dict) and r.get("live"))
        return doc
    nodes = {own["node"]: own}
    refresh_gauges(nodes)
    return {"source": "local", "ts": round(time.time(), 3),
            "nodes": nodes, "nodes_live": 1}


# ------------------------------------------------------ trace stitching
def _trace_events(trace_id: str | None, limit: int = 64) -> list[dict]:
    if not trace_id:
        return []
    return [r for r in EVENTS.tail()
            if r.get("trace") == trace_id][-limit:]


def local_hop_doc(app, path: str) -> dict:
    """This node's view of one stream — a single hop of a stitched
    trace: the stream's trace id + node lineage, its freshness chain,
    and the local spans/events stamped with that trace.  ``upstream``
    names the node the stream is pulled from (the stitcher's next hop;
    None at the origin)."""
    from ..protocol.sdp import _norm
    key = _norm(path)
    sess = app.registry.find(key)
    nid = app.config.server_id
    doc: dict = {"node": nid, "path": key}
    if sess is None:
        doc["error"] = "no such stream"
        return doc
    trace = sess.trace_id
    doc.update({
        "trace": trace,
        "lineage": list(getattr(sess, "trace_nodes", ()) or ()) or [nid],
        "role": _stream_tier(app, sess),
        "outputs": sess.num_outputs,
        "freshness": freshness_chain(sess, nid),
        "spans": FLIGHT._span_summaries(trace, limit=64),
        "events": _trace_events(trace),
    })
    cl = getattr(app, "cluster", None)
    if cl is not None and key in cl.pulls:
        up = cl.owners.get(key)
        if up and up != nid:
            doc["upstream"] = up
    return doc


async def stitch_trace(app, doc: dict) -> dict:
    """Grow a session's flight/trace document into the multi-hop
    stitched trace: the local hop plus every upstream hop fetched over
    the peers' ``/api/v1/streamtrace`` endpoints (followed through the
    cluster's pull + ownership records, origin first).  Any fetch
    failure degrades to the hops already collected — a dead origin
    still leaves the local evidence readable."""
    import asyncio
    from urllib.parse import quote
    path = (doc.get("meta") or {}).get("path") or doc.get("stream")
    if not path:
        return doc
    hops = [local_hop_doc(app, path)]
    cl = getattr(app, "cluster", None)
    seen = {app.config.server_id}
    nxt = hops[0].get("upstream")
    loop = asyncio.get_running_loop()
    while (nxt and nxt not in seen and cl is not None
           and len(hops) <= MAX_TRACE_HOPS):
        seen.add(nxt)
        meta = (cl.last_nodes or {}).get(nxt) or {}
        host, port = meta.get("ip"), meta.get("http")
        if not host or not port:
            break
        raw = await loop.run_in_executor(
            app._ensure_dvr_fetch_pool(), app._peer_http_get,
            str(host), int(port),
            f"/api/v1/streamtrace?path={quote(path)}")
        if raw is None:
            break
        import json
        try:
            hop = json.loads(raw.decode("utf-8", "replace"))
        except ValueError:
            break
        if not isinstance(hop, dict):
            break
        hops.append(hop)
        nxt = hop.get("upstream")
    hops.reverse()                      # origin first
    traces = [h.get("trace") for h in hops if h.get("trace")]
    doc = dict(doc)
    doc["hops"] = hops
    if traces:
        doc["stream_trace"] = traces[0]
        doc["trace_stitched"] = len(set(traces)) == 1
    lineage = next((h.get("lineage") for h in reversed(hops)
                    if h.get("lineage")), None)
    if lineage:
        doc["lineage"] = lineage
    return doc
