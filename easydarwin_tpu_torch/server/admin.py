"""Admin dictionary-tree browse API (QTSSAdminModule parity).

Reference: ``QTSSAdminModule.cpp:365-1073`` + ``AdminQuery.cpp`` +
``AdminElementNode.cpp`` — the legacy ``/modules/admin`` API walks the
server's reflective attribute dictionaries as a filesystem-like tree with
``command=get|set`` queries, ``*`` wildcards and an optional recurse flag.

Here the same browse semantics sit on the JSON REST port: the tree is
assembled on demand from live server state (info, prefs, sessions,
modules), paths are ``/``-separated with a trailing ``*`` to list
children, and ``command=set`` writes a pref through the same validated
``ServerConfig.update`` path the setbaseconfig route uses.  The mongoose
web UI is intentionally superseded by ``/stats`` + this endpoint.
"""

from __future__ import annotations

from typing import Any


#: role hook names on server.modules.Module (QTSSModule.h:126-163 analogue)
ROLE_HOOKS = ("initialize", "shutdown", "reread_prefs", "rtsp_filter",
              "rtsp_route", "authorize", "rtsp_postprocess",
              "session_closing", "incoming_rtp")


def _module_attrs(module) -> dict:
    """Module-added attributes (QTSS_AddStaticAttribute analogue) under
    an ``attrs`` node; a module raising inside its own hook must not
    take the whole tree down."""
    try:
        attrs = module.attributes()
        if attrs:
            import json
            json.dumps(attrs)          # a non-serializable value would
    except Exception as e:             # break every tree query that
        return {"attrs_error": str(e)}  # includes this node, not just
    return {"attrs": attrs} if attrs else {}  # the module's own path


def _roles_of(module) -> list[str]:
    """Roles a module registers for = hooks it overrides (the dispatch
    arrays in QTSServer::BuildModuleRoleArrays, rebuilt by reflection)."""
    from .modules import Module
    return sorted(r for r in ROLE_HOOKS
                  if any(r in klass.__dict__
                         for klass in type(module).__mro__
                         if klass is not Module and klass is not object))


def _session_node(app, sess):
    """A session's tree node reads through its (cached) AttrStore and
    per-stream stores — the qtssClientSession/RTPStream dictionaries."""
    from . import dictionary as dct
    store = getattr(sess, "attr_store", None)
    if store is None:
        store = sess.attr_store = dct.session_store(app, sess)
    streams = {}
    for tid in sess.streams:
        skey = f"track{tid}"
        cache = getattr(sess, "_stream_stores", None)
        if cache is None:
            cache = sess._stream_stores = {}
        if tid not in cache:
            cache[tid] = dct.stream_store(sess, tid)
        streams[skey] = cache[tid]
    return {"attrs": store, "streams": streams}


def build_tree(app) -> dict[str, Any]:
    """Assemble the browseable dictionary tree from live server state.

    Mirrors the reference's top-level element list (AdminElementNode
    ``GetElementFromArray``): server attributes, prefs, connected
    sessions, loaded modules.  Nodes are either plain dict containers
    or ``AttrStore`` objects — the reflective dictionaries every query
    and set resolves through (QTSSDictionaryMap)."""
    from . import dictionary as dct
    sstore = getattr(app, "attr_store", None)
    if sstore is None:
        sstore = app.attr_store = dct.server_store(app)
    cstore = getattr(app.config, "attr_store", None)
    if cstore is None:
        cstore = app.config.attr_store = dct.config_store(app.config)
    mstore = getattr(app, "metrics_store", None)
    if mstore is None:
        mstore = app.metrics_store = dct.metrics_store()
    sessions = {}
    for s in app.registry.sessions.values():
        sessions[s.path.strip("/").replace("/", "~")] = \
            _session_node(app, s)
    modules = {}
    for m in getattr(app.modules, "modules", []):
        node: dict[str, Any] = {"roles": _roles_of(m),
                                **_module_attrs(m)}
        mstore = getattr(m, "attr_store", None)
        if mstore is not None and mstore.describe():
            node["instance_attrs"] = mstore
        modules[m.name] = node
    return {
        "server": {
            "info": sstore,
            "prefs": cstore,
            "metrics": mstore,
            "sessions": sessions,
            "modules": modules,
        },
    }


def _materialize(node: Any) -> Any:
    from .dictionary import AttrStore
    if isinstance(node, AttrStore):
        return node.as_dict()
    if isinstance(node, dict):
        return {k: _materialize(v) for k, v in node.items()}
    return node


def query(app, path: str, *, recurse: bool = False) -> tuple[int, Any]:
    """``command=get`` — resolve a tree path.

    Returns (status, payload).  A trailing ``*`` lists children one
    level deep (or the whole subtree with ``recurse``); a concrete path
    returns the node value.  Inside an ``AttrStore`` node, a segment is
    an attribute name or ``@<id>`` (get-by-id), and the reserved
    segment ``parameters`` returns the attribute metadata (id, type,
    access) like the reference's ?parameters view.  Unknown paths →
    404 (QTSSAdminModule.cpp ReportErr)."""
    from .dictionary import AttrStore
    tree: Any = build_tree(app)
    parts = [p for p in path.strip("/").split("/") if p]
    wildcard = bool(parts) and parts[-1] == "*"
    if wildcard:
        parts = parts[:-1]
    node = tree
    for part in parts:
        if isinstance(node, AttrStore):
            if part == "parameters":
                node = node.describe()
                continue
            try:
                node = node.get(part)
            except KeyError:
                return 404, {"error": f"no such path: {path}"}
            continue
        if not isinstance(node, dict) or part not in node:
            return 404, {"error": f"no such path: {path}"}
        node = node[part]
    if isinstance(node, AttrStore) and not wildcard:
        return 200, node.as_dict()
    if wildcard:
        if isinstance(node, AttrStore):
            return 200, node.as_dict()
        if not isinstance(node, dict):
            return 400, {"error": "wildcard on a leaf"}
        if recurse:
            return 200, _materialize(node)
        return 200, {k: (v if not isinstance(v, (dict, AttrStore))
                         else "*container*")
                     for k, v in node.items()}
    return 200, _materialize(node)


def flight_query(app, session_id: str) -> tuple[int, Any]:
    """``command=flight&session=<id>`` — the session's black box.

    A LIVE session answers with its current event ring + correlated span
    summaries (no dump side effects, ``"live": true``); an abnormally
    torn-down one answers with its stored flight dump.  Without
    ``session=``, lists what is retrievable (live rings + kept dumps)."""
    from ..obs import FLIGHT
    if not session_id:
        return 200, {"live": FLIGHT.live_sessions(),
                     "dumps": sorted(FLIGHT.dumps)}
    doc = FLIGHT.lookup(session_id)
    if doc is None:
        return 404, {"error": f"no flight data for session {session_id}"}
    return 200, doc


def profile_snapshot(app) -> dict:
    """``command=top`` / ``GET /api/v1/profile`` — the live attribution
    document: per-phase latency summaries, top sessions by wire bytes
    and by p99 contribution (obs/profile.py), plus the SLO watchdog's
    budget status when the server carries one (the raw profiler shape is
    preserved so operators' jq pipelines survive a headless profiler)."""
    from ..obs import PROFILER
    doc = PROFILER.snapshot()
    slo = getattr(app, "slo", None)
    if slo is not None:
        doc["slo"] = slo.status()
    return doc


def ledger_snapshot(app) -> dict:
    """``GET /api/v1/ledger`` — the wake-loop ledger's live document
   : per-work-class wait/service aggregates, deferred/shed
    counts, the worst wait's trace correlation, and the cluster tick's
    Redis roundtrip sub-accounting.  The node id rides along so a
    multi-node capture (blame_report, soak post-mortem) stays
    attributable after aggregation."""
    from ..obs import LEDGER, events
    doc = LEDGER.snapshot()
    doc["node"] = events.NODE.get("id") or ""
    return doc


def blame_snapshot(app) -> dict:
    """``command=blame`` — the "why is p99 high" table: the ledger
    snapshot ranked by wait-p99 blame through obs.ledger.blame_doc,
    with the live ingest→wire p50/p99 as the measured figures the
    attribution must conserve against (the same estimator bench's
    composed round pins at ≥ 90 %)."""
    from ..obs import LEDGER, RELAY_INGEST_TO_WIRE, blame_doc
    p50 = RELAY_INGEST_TO_WIRE.quantile(0.50) * 1e3
    p99 = RELAY_INGEST_TO_WIRE.quantile(0.99) * 1e3
    snap = ledger_snapshot(app)
    doc = blame_doc(snap, measured_p99_ms=p99 or None,
                    baseline_p50_ms=p50)
    doc["node"] = snap.get("node", "")
    doc["ledger"] = snap
    # audience suspect source: viewer impact joins the
    # cause — stall storms / collapsed QoE p10 become suspect lines
    # alongside the ledger's, and the rollup rides the doc so
    # tools/blame_report.py can re-derive them from a capture
    from ..obs import AUDIENCE
    from ..obs import audience as audience_mod
    roll = AUDIENCE.rollup()
    doc["audience"] = roll
    doc["suspects"] = list(doc.get("suspects") or []) \
        + audience_mod.suspect_flags(roll)
    return doc


def audience_snapshot(app, worst_n: int = 5) -> dict:
    """``GET /api/v1/audience`` / ``command=audience`` — the columnar
    per-subscriber QoE store's drill-down doc: per-stream
    rollup (QoE p50/p10, drops/late/RTX/FEC totals, stall figures,
    storm latches) + the worst-N subscribers of each stream.  The node
    id rides along so multi-node captures stay attributable."""
    from ..obs import AUDIENCE, events
    doc = AUDIENCE.snapshot(worst_n=worst_n)
    doc["node"] = events.NODE.get("id") or ""
    return doc


def set_pref(app, path: str, value: str) -> tuple[int, Any]:
    """``command=set`` — write one pref through the prefs AttrStore
    (``server/prefs/<name>`` or ``server/prefs/@<id>``; the reference
    likewise only honors sets on preference attributes, and read-only
    attributes refuse with the QTSS_ReadOnly analogue)."""
    from . import dictionary as dct
    parts = [p for p in path.strip("/").split("/") if p]
    if len(parts) != 3 or parts[:2] != ["server", "prefs"]:
        return 400, {"error": "set supports server/prefs/<name> only"}
    cstore = getattr(app.config, "attr_store", None)
    if cstore is None:
        cstore = app.config.attr_store = dct.config_store(app.config)
    try:
        spec = cstore.spec(parts[2])
    except KeyError:
        return 404, {"error": f"no such pref: {parts[2]}"}
    old = cstore.get(spec.attr_id)
    try:
        new = cstore.set(spec.attr_id, value)
    except PermissionError as e:
        return 400, {"error": str(e)}
    except (TypeError, ValueError) as e:
        return 400, {"error": str(e)}
    if spec.name == "rest_password":   # match the read-side redaction
        return 200, {spec.name: "(redacted)"}
    return 200, {spec.name: new, "was": old}
