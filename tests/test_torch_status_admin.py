"""The stats page, the admin tree, the dictionary stores, the module hooks,
``/metrics`` and the ``obs`` REST documents of the port's server against
the reference's server, both on the CPU with the same traffic.

Each server (the reference's on its device engine path, ``tpu_fanout``
with ``tpu_min_outputs`` 1, so both run engines and a megabatch over two
streams) takes two pushed paths, each played by one interleaved TCP and
one UDP player, then 60 more packets a path; a recording module is
registered on each before it starts.  Then:

* every player got every packet from its join on, the same count on both
  servers, and these ``obs`` counts moved alike: delivered
  ``relay_ingest_to_wire_seconds`` observations, ``tpu_packets_sent``,
  the ``rtsp.setup``/``rtsp.play``/``session.create``/
  ``stream.output_add`` events, the TCP egress packets and bytes;
* the pass counts follow the stated relation, not equality: the port
  makes ONE window call a dispatching wake for all its buckets where the
  reference makes one device pass a bucket, so each side's
  ``megabatch_passes_total`` equals its own scheduler's bucket passes,
  the port's ``relay_phase_seconds{engine="megabatch",phase="device_step"}``
  count equals its window calls (after the drain), and its window calls
  are at most its bucket passes;
* the module hooks ran in the same order for the same requests
  (initialize, then filter, route, authorize and postprocess of each
  request, the incoming-RTP count, session closings, and shutdown);
* GET ``/stats`` (and ``/`` on the port) answers 200 on both ports of
  both, with the same server keys and session rows; GET ``/metrics``
  names the same families; ``/debug/profile`` is a gzipped profile;
* the admin tree answers the same containers, server attributes, session
  and stream attributes and metric names; ``set_pref`` of a shared pref,
  a read-only attribute path and an unknown pref answer alike; the
  ``/admin`` page refuses a set without the CSRF token and takes it
  with; the dictionary stores list the same attributes;
* GET_PARAMETER with ``x-freshness`` answers a chain of the same shape;
* ``getserverinfo``'s ``IngestToWireP99Ms``, ``LedgerTopWaitClass`` and
  ``LedgerLastWakeMs`` are non-empty on the port, as on the reference;
* the ledger, profile, audience, events and fleet documents have the
  reference's keys, and the ledger names a work class of the closed set;
* the observed relay (``utils.obs_loopback``, the harness of the chip
  smoke's phase 15) at a small size through the CLI server on the CPU:
  every packet held, every scraped family in the inventory,
  ``relay_phase_seconds`` inside ``PHASES`` × ``ENGINES``, the blame
  report naming a work class, the megabatch's ``device_step`` count equal
  to the server's window calls, ``tpu_h2d_bytes_total`` and
  ``tpu_d2h_bytes_total`` equal to the bytes the relay tiers' copies
  moved (``ops.staging.COPIED``, counted from the copied tensors), the
  pprof profile parsing, and every page 200.
"""

import asyncio
import gzip
import json
import re

from easydarwin_tpu import obs as ref_obs
from easydarwin_tpu.server import ServerConfig as RefConfig
from easydarwin_tpu.server import StreamingServer as RefServer
from easydarwin_tpu.server import modules as ref_modules
from easydarwin_tpu_torch import obs as port_obs
from easydarwin_tpu_torch.protocol import rtsp
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.server import modules as port_modules
from easydarwin_tpu_torch.utils import loopback, synth
from easydarwin_tpu_torch.utils.surface_loopback import rest

PATHS = ("/live/cam1", "/live/cam2")
N_LIVE = 60


def _recorder(mod):
    class Recorder(mod.Module):
        name = "recorder"

        def __init__(self):
            self.calls = []

        def attributes(self):
            return {"calls": len(self.calls)}

        def initialize(self, server):
            self.calls.append(("initialize", ""))

        def shutdown(self, server):
            self.calls.append(("shutdown", ""))

        def rtsp_filter(self, conn, req):
            self.calls.append(("filter", req.method))

        def rtsp_route(self, conn, req):
            self.calls.append(("route", req.method))

        def authorize(self, conn, req):
            self.calls.append(("authorize", req.method))

        def rtsp_postprocess(self, conn, req, resp):
            self.calls.append(("postprocess", f"{req.method} {resp.status}"))

        def session_closing(self, conn):
            self.calls.append(("closing", ""))

        def incoming_rtp(self, session, track_id, packet):
            self.calls.append(("rtp", ""))

    return Recorder()


def _counts(o) -> dict:
    """The ``obs`` figures that must move alike on both servers."""
    ev = [json.loads(ln) for ln in o.EVENTS.dump_lines()]
    kinds = {}
    for r in ev:
        kinds[r["event"]] = kinds.get(r["event"], 0) + 1
    return {
        "lat": o.RELAY_INGEST_TO_WIRE.total_count(),
        "sent": o.TPU_PACKETS_SENT.value(),
        "tcp_pkts": o.TCP_EGRESS_PACKETS.total(),
        "tcp_bytes": o.TCP_EGRESS_BYTES.total(),
        "events": {k: kinds.get(k, 0) for k in (
            "rtsp.setup", "rtsp.play", "rtsp.announce", "rtsp.record",
            "session.create", "stream.output_add")},
        "seq": o.EVENTS.seq,
        "mb_passes": o.MEGABATCH_PASSES.value(),
        "device_step": o.RELAY_PHASE_SECONDS.count(engine="megabatch",
                                                   phase="device_step"),
    }


async def _http(port: int, target: str) -> tuple[int, dict, bytes]:
    """One GET: (status, headers, body), the body by its length (the REST
    port keeps the connection alive)."""
    r, w = await asyncio.open_connection("127.0.0.1", port)
    try:
        w.write(f"GET {target} HTTP/1.0\r\nHost: x\r\n\r\n".encode())
        head = await asyncio.wait_for(r.readuntil(b"\r\n\r\n"), 30)
        lines = head[:-4].decode("latin-1").split("\r\n")
        hdrs = {k.strip().lower(): v.strip() for k, _, v in
                (ln.partition(":") for ln in lines[1:])}
        body = await asyncio.wait_for(
            r.readexactly(int(hdrs.get("content-length", 0))), 30)
    finally:
        w.close()
    return int(lines[0].split()[1]), hdrs, body


async def _drive(app, rtsp_port: int) -> dict:
    """Push both paths, join the players, push the live part, wait for
    every packet; returns the clients and the per-player counts."""
    pushers, players = [], []
    seq = {p: 0 for p in PATHS}

    def packet(path, nal):
        seq[path] += 1
        return synth.h264_packet(seq[path], seq[path] * 3000, nal,
                                 ssrc=0x1234, body=bytes(64))

    for path in PATHS:
        pusher = loopback.MiniClient()
        await pusher.connect(rtsp_port)
        uri = f"rtsp://127.0.0.1:{rtsp_port}{path}"
        await pusher.request("ANNOUNCE", uri,
                             {"content-type": "application/sdp"},
                             loopback.VIDEO_SDP.encode())
        await pusher.request("SETUP", uri + "/trackID=1", {
            "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"})
        await pusher.request("RECORD", uri)
        pusher.push(packet(path, 5))               # the GOP head
        pushers.append(pusher)
    await asyncio.sleep(0.2)
    for path in PATHS:
        uri = f"rtsp://127.0.0.1:{rtsp_port}{path}"
        for kind in ("tcp", "udp"):
            pl = loopback.MiniClient()
            await pl.connect(rtsp_port)
            await pl.request("DESCRIBE", uri)
            if kind == "tcp":
                t = "RTP/AVP/TCP;unicast;interleaved=0-1"
            else:
                t = f"RTP/AVP;unicast;client_port={await pl.udp_ports()}"
            await pl.request("SETUP", uri + "/trackID=1", {"transport": t})
            await pl.request("PLAY", uri)
            players.append(pl)
    for i in range(N_LIVE):
        for k, path in enumerate(PATHS):
            pushers[k].push(packet(path, 5 if i % 20 == 19 else 1))
        await asyncio.sleep(0.005)
    for _ in range(1000):
        if all(len(p.frames) >= N_LIVE + 1 for p in players):
            break
        await asyncio.sleep(0.01)
    await asyncio.sleep(0.3)
    # the freshness chain from a player's connection
    pl = players[0]
    pl.cseq += 1
    pl._write(rtsp.RtspRequest(
        "GET_PARAMETER", f"rtsp://127.0.0.1:{rtsp_port}{PATHS[0]}",
        {"cseq": str(pl.cseq), "session": pl.session,
         "content-type": "text/parameters"}, b"x-freshness\r\n").to_bytes())
    fresh = await asyncio.wait_for(pl.responses.get(), 30)
    return {"pushers": pushers, "players": players,
            "frames": [len(p.frames) for p in players],
            "fresh": (fresh.status, json.loads(fresh.body or b"null"))}


def _shape(x):
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in sorted(x.items())}
    if isinstance(x, list):
        return [_shape(v) for v in x]
    return type(x).__name__


def _table_keys(html: bytes) -> list:
    return re.findall(r"<tr><td>([A-Za-z0-9_]+)</td>", html.decode())


async def _run(side, tmp_path) -> dict:
    o = ref_obs if side == "ref" else port_obs
    common = dict(rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
                  reflect_interval_ms=5, server_id="node-x",
                  log_folder=str(tmp_path / side / "logs"),
                  movie_folder=str(tmp_path / side))
    if side == "ref":
        app = RefServer(RefConfig(tpu_fanout=True, tpu_min_outputs=1,
                                  **common))
        rec = _recorder(ref_modules)
    else:
        app = StreamingServer(ServerConfig(**common), device="cpu")
        rec = _recorder(port_modules)
    app.register_module(rec)
    before = _counts(o)
    await app.start()
    out = {"rec": rec}
    try:
        traffic = await _drive(app, app.rtsp.port)
        out.update(frames=traffic["frames"], fresh=traffic["fresh"])
        rp, sp = app.rtsp.port, app.rest.port
        out["stats"] = {}
        for port, name in ((rp, "rtsp"), (sp, "rest")):
            st, _h, body = await _http(port, "/stats")
            out["stats"][name] = (st, _table_keys(body),
                                  sorted(set(re.findall(
                                      r"<td>(/live/cam\d)</td>",
                                      body.decode()))))
        # "/" on the RTSP port of both, and on the port's REST port
        out["root"] = [(await _http(p, "/"))[0]
                       for p in ((rp, sp) if side == "port" else (rp,))]
        st, hdrs, body = await _http(sp, "/metrics")
        out["metrics"] = (st, sorted(set(re.findall(
            r"^# TYPE (\S+) ", body.decode(), re.M))))
        st, _h, body = await _http(sp, "/debug/profile")
        out["pprof"] = (st, len(gzip.decompress(body)) > 0)
        docs = {}
        for cmd in ("ledger", "profile", "audience", "events", "fleet"):
            body = (await _http(sp, f"/api/v1/{cmd}"))[2]
            docs[cmd] = ([json.loads(ln) for ln in body.splitlines()]
                         if cmd == "events" else json.loads(body))
        out["docs"] = docs
        out["info"] = (await rest(sp, "getserverinfo"))[1][
            "EasyDarwin"]["Body"]
        adm = {}
        for q in ("path=server/*", "path=server/info/*",
                  "path=server/sessions/*",
                  "path=server/sessions/live~cam1/streams/track1/*",
                  "path=server/sessions/live~cam1/attrs/*",
                  "path=server/modules/*",
                  "path=server/modules/recorder/*",
                  "path=server/metrics/*",
                  "path=server/info/parameters",
                  "path=server/nowhere/*",
                  "path=server/prefs/bucket_delay_ms&command=set&value=61",
                  "path=server/prefs/no_such_pref&command=set&value=1",
                  "path=server/info/RTSPPort&command=set&value=1",
                  "command=bogus"):
            st, doc = await rest(sp, "admin", query=q)
            body = doc["EasyDarwin"]["Body"]
            adm[q] = (st, doc["EasyDarwin"]["Header"]["ErrorNum"],
                      sorted(body.get("Value", body))
                      if isinstance(body.get("Value", body), dict)
                      else _shape(body.get("Value", body)))
        for q in ("command=top", "command=blame", "command=audience",
                  "command=trace", "command=flight"):
            adm[q] = sorted(json.loads(
                (await _http(sp, f"/api/v1/admin?{q}"))[2]))
        out["admin"] = adm
        st, _h, page = await _http(
            sp, "/admin?path=server/prefs/bucket_delay_ms&command=set"
            "&value=62")
        out["admin_get_set"] = (st, b"set requires POST" in page)
        csrf = re.search(rb'name=csrf value="([^"]+)"',
                         (await _http(sp, "/admin?path=server/prefs/*"))[2])
        out["csrf"] = csrf is not None
        out["stores"] = {
            "server": [a["name"] for a in app.attr_store.describe()],
            "session": [a["name"] for a in
                        app.registry.sessions[PATHS[0]].attr_store
                        .describe()],
            "stream": [a["name"] for a in app.registry.sessions[PATHS[0]]
                       ._stream_stores[1].describe()],
            "metrics": [a["name"] for a in app.metrics_store.describe()],
        }
        out["bucket_delay"] = app.config.to_dict()["bucket_delay_ms"]
        for c in traffic["pushers"] + traffic["players"]:
            await c.close()
        await asyncio.sleep(0.3)
    finally:
        await app.stop()
    if side == "port":
        app.megabatch.drain()
        out["window_calls"] = app.megabatch.window_calls
        out["passes"] = app.megabatch.passes
    else:
        out["passes"] = app.megabatch.passes
    after = _counts(o)
    out["delta"] = {k: (after[k] - before[k]) if not isinstance(after[k],
                                                                 dict)
                    else {e: after[k][e] - before[k][e] for e in after[k]}
                    for k in after}
    return out


async def test_status_admin_and_obs_match_the_reference(tmp_path):
    ref = await _run("ref", tmp_path)
    ours = await _run("port", tmp_path)
    # every packet from the join on, alike
    assert ours["frames"] == ref["frames"] == [N_LIVE + 1] * 4
    d_ref, d_port = ref["delta"], ours["delta"]
    for k in ("lat", "sent", "tcp_pkts", "tcp_bytes", "events"):
        assert d_port[k] == d_ref[k], (k, d_ref[k], d_port[k])
    assert d_port["lat"] == 4 * (N_LIVE + 1)
    # the pass counts' relation
    assert d_port["mb_passes"] == ours["passes"] > 0
    assert d_ref["mb_passes"] == ref["passes"] > 0
    assert d_port["device_step"] == ours["window_calls"] > 0
    assert ours["window_calls"] <= ours["passes"]
    # module hooks, in order
    rc, pc = ref["rec"].calls, ours["rec"].calls
    req = [c for c in rc if c[0] not in ("rtp", "closing")]
    assert [c for c in pc if c[0] not in ("rtp", "closing")] == req
    assert req[0] == ("initialize", "") and req[-1] == ("shutdown", "")
    for role in ("rtp", "closing"):
        assert pc.count((role, "")) == rc.count((role, "")) > 0, role
    # the pages
    assert ours["stats"] == ref["stats"]
    assert ours["stats"]["rtsp"][0] == 200 and ours["root"] == [200, 200]
    assert ref["root"] == [200]
    assert ours["stats"]["rtsp"][2] == list(PATHS)
    assert ours["metrics"] == ref["metrics"]
    assert ours["pprof"] == ref["pprof"] == (200, True)
    assert ours["admin"] == ref["admin"]
    assert ours["admin_get_set"] == ref["admin_get_set"] == (200, True)
    assert ours["csrf"] and ref["csrf"]
    assert ours["bucket_delay"] == ref["bucket_delay"] == 61
    assert ours["stores"] == ref["stores"]
    # the freshness chain
    assert ours["fresh"][0] == ref["fresh"][0] == 200
    assert _shape(ours["fresh"][1]) == _shape(ref["fresh"][1])
    assert ours["fresh"][1]
    # getserverinfo's obs keys
    for k in ("IngestToWireP99Ms", "LedgerTopWaitClass",
              "LedgerLastWakeMs"):
        assert ours["info"][k] not in ("", None), k
        assert ref["info"][k] not in ("", None), k
    assert ours["info"]["LedgerTopWaitClass"] in port_obs.WORK_CLASSES
    assert sorted(ours["info"]) == sorted(ref["info"])
    # the documents
    for cmd in ("ledger", "profile", "audience", "fleet"):
        assert sorted(ours["docs"][cmd]) == sorted(ref["docs"][cmd]), cmd
    led = ours["docs"]["ledger"]
    assert set(led["classes"]) <= set(port_obs.WORK_CLASSES)
    assert led["node"] == "node-x"
    assert {r["event"] for r in ours["docs"]["events"]} >= {
        "rtsp.setup", "rtsp.play", "session.create"}
    assert "megabatch" in ours["docs"]["profile"]["phases"]["device_step"]


async def test_observed_relay_on_the_cpu():
    from easydarwin_tpu_torch.utils import obs_loopback as ol
    res = await ol.observed_relay(
        "cpu", 5, udp=2, tcp=2, meta=4, fec=2, gops=4, frames=30,
        packets_per_frame=4, body_len=(40, 200), deadline_s=30)
    st, final = res["server_stats"], res["final"]
    fams, samples = ol.exposition(final["metrics"][1])
    inventory = {f.name: f.kind for f in port_obs.REGISTRY.families()}
    assert fams and all(inventory.get(n) == k for n, k in fams.items())
    assert all(ol.family_of(n, fams) for n, _l, _v in samples)
    phases = ol.phase_stats(samples)
    assert all(e in port_obs.ENGINES and p in port_obs.PHASES
               for e, p in phases)
    rc, _report, top = res["blame"]
    assert rc == 0 and top in port_obs.WORK_CLASSES
    mb = st["megabatch"]
    assert phases[("megabatch", "device_step")][0] == mb["window_calls"] > 0
    for d in ("h2d", "d2h"):
        assert ol.sample_value(samples, f"tpu_{d}_bytes_total") == \
            st["copied_bytes"][d] > 0
    prof = ol.pprof_summary(final["pprof"][1])
    assert prof["samples"] > 0 and "engine.step" in prof["strings"]
    assert all(p[0] == 200 for p in final["pages"].values())
    info = final["info"][1]
    assert info["LedgerTopWaitClass"] in port_obs.WORK_CLASSES
    assert float(info["IngestToWireP99Ms"]) > 0
    assert res["scrapes"] and all(s[d][0] == 200 for s in res["scrapes"]
                                  for d in ol.DOCS)
