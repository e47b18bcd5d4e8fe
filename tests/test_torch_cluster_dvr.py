"""The cluster's DVR peer fill and the erasure store's wire in the port,
against the reference's ``tests/test_dvr.py``
(``test_peer_fetch_pending_holds_cursor``,
``test_manager_lifecycle_advertise_peer_fill``,
``test_dvrwindow_rest_endpoint``, ``test_remote_dvr_asset_bootstrap_replay``)
and ``tests/test_storage.py``
(``test_stripe_ranked_placement_spreads_one_stripe``,
``test_receive_shard_crc_gate_and_gen_replace``,
``test_dead_owner_dvrmeta_bootstrap_and_replay``): one counterpart each,
holding the port's result to the reference package's where the two can
be compared (the same seeded rows and frames into both packages: the same
blobs, ``dvrmeta`` documents, files, ranked holders and refusals), and:

* ``materialize``'s guards and ``advertise`` equal the reference's;
* the REST handlers ``dvrwindow``, ``dvrmeta`` (with its fallback to the
  store's manifest), ``shard``, ``shardmeta`` and ``shardpush`` answer as
  the reference's, status and bytes;
* the pump-side fetcher (``_dvr_peer_fetch``: the fetch-pending protocol,
  the advertised span, the in-flight cap) answers as the reference's,
  call for call, and asks a bootstrap peer only while its lease is
  live; the store's restore is asked beside a pending fetch, as in the
  reference, and concurrent DESCRIBEs share one ``dvrmeta`` sweep;
* a mixed cluster: a port node replays a ``.dvr`` asset a reference node
  recorded, through the reference's ``dvrmeta`` and ``dvrwindow``, and the
  other way round (one SSRC, a gapless seq, the pushed payloads, no
  repack in either package); the recording node's store pushes its
  shards to the other package's node, which accepts them;
* a ``shardpush`` refused by both packages' nodes when corrupt;
* a port node's ``advertise`` spans carried in its ``Own:`` record and
  read into the reference's ``ClusterService.dvr_peers``, and the other
  way round;
* peer calls on an auth-enabled pair: with the shared credentials the
  replay fills, with wrong ones a 401 is a failed call (None / False);
* ``utils.cluster_dvr_loopback.cluster_dvr``, the harness of
  ``chip_smoke.py`` phase 17b, at a small size on the CPU.

Every socket wait has a timeout of its own, and waits are deadline loops.
"""

import asyncio
import json
import os
import sys
import time
import types
from concurrent.futures import Future
from pathlib import Path
from urllib.parse import quote

import numpy as np
import pytest

from easydarwin_tpu.cluster import placement as ref_placement
from easydarwin_tpu.cluster import service as ref_service
from easydarwin_tpu.relay.session import SessionRegistry as RefRegistry
from easydarwin_tpu.server import ServerConfig as RefConfig
from easydarwin_tpu.server import StreamingServer as RefServer
from easydarwin_tpu.server.app import StreamingServer as RefApp
from easydarwin_tpu.server.rest import RestApi as RefRest
from easydarwin_tpu.storage import StorageService as RefStorage
from easydarwin_tpu.vod import cache as ref_cache
from easydarwin_tpu_torch import obs
from easydarwin_tpu_torch.cluster import placement, service
from easydarwin_tpu_torch.cluster.redis_client import InMemoryRedis
from easydarwin_tpu_torch.relay.session import SessionRegistry
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.server.rest import RestApi
from easydarwin_tpu_torch.storage import StorageService
from easydarwin_tpu_torch.storage.service import shard_name
from easydarwin_tpu_torch.utils import cluster_dvr_loopback as cdl
from easydarwin_tpu_torch.vod import cache as port_cache

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_storage import _blobs, _FakeDvr  # noqa: E402
from test_torch_dvr import (PORT, REF, SIDES, VIDEO_SDP,  # noqa: E402
                            _files, _frames, _info, _rows, _run_session,
                            _World)

REF_CMDS = {"ref": RefRest, "port": RestApi}


@pytest.fixture(autouse=True)
def _fresh_ledger():
    yield
    obs.LEDGER.reset()


# ================================================ the spill's fetch chain
def _pending_fetch(side, root):
    """Window 0 lives on a peer whose fetch stays in flight for six
    ticks, window 1 is local: the cursor holds on window 0, then serves
    both in full."""
    d = root / "t1"
    w = side.spill.SpillWriter(str(d), _info(side), window_pkts=8)
    w.append_window(1, _rows(side, np.random.default_rng(5), 8, id_lo=8))
    w.finalize()
    blob = side.spill.encode_blob(_rows(side, np.random.default_rng(6), 8,
                                        id_lo=0))
    state = {"ready": False, "calls": 0}

    def fetch(win):
        state["calls"] += 1
        if win != 0:
            return None
        return blob if state["ready"] else b""

    sp = side.spill.SpilledTrack(str(d), fetch=fetch)
    first = (sp.read_window(0) is None, sp.fetch_pending,
             sp.read_window(1) is not None, sp.fetch_pending)
    world = _World(side, root / "dvr")
    asset = side.service.DvrAsset("/live/pf", str(root), {1: sp},
                                  complete=True)
    out = side.Out(ssrc=0x666, out_seq_start=10, out_ts_start=0)
    sess = side.timeshift.TimeShiftSession(
        world.pacer, asset, {1: out}, start_ids={1: 0}, speed=1000.0,
        now_ms=world.t)
    world.pacer.adopt(sess)
    for _ in range(6):
        world.t += 5
        for st, _e in world.pacer.tick(world.t):
            st.reflect(world.t)
    held = (sess.tracks[0].cursor, sess.tracks[0].gaps, len(out.wire),
            state["calls"] > 1)
    state["ready"] = True
    done = _run_session(world, sess)
    res = (first, held, done, sess.tracks[0].gaps, out.wire)
    sess.stop()
    world.close()
    return res


def test_peer_fetch_pending_holds_cursor(tmp_path):
    got = {s.name: _pending_fetch(s, tmp_path / s.name) for s in SIDES}
    assert got["port"] == got["ref"]
    first, held, done, gaps, wire = got["port"]
    assert first == (True, True, True, False)
    assert held == (0, 0, 0, True), "the cursor hopped a pending window"
    assert done and gaps == 0 and len(wire) == 16
    assert [int.from_bytes(d[2:4], "big") for d in wire] == \
        list(range(10, 26))


def _restore_beside_pending(side, root):
    """Window 0's peer fetch never lands; the store's restore answers on
    its second poll.  The window is served from the restore while the
    fetch is still in flight."""
    d = root / "t1"
    w = side.spill.SpillWriter(str(d), _info(side), window_pkts=8)
    w.append_window(1, _rows(side, np.random.default_rng(5), 8, id_lo=8))
    w.finalize()
    blob = side.spill.encode_blob(_rows(side, np.random.default_rng(6), 8))
    restores = [b"", blob]
    log = []

    def fetch(win):
        log.append(("fetch", win))
        return b""

    def restore(win):
        log.append(("restore", win))
        return restores.pop(0) if restores else None

    sp = side.spill.SpilledTrack(str(d), fetch=fetch, restore=restore)
    first = (sp.read_window(0), sp.fetch_pending)
    rows = sp.read_window(0)
    return (first, rows.restored, rows.data.tobytes(), sp.fetch_pending,
            log)


def test_restore_serves_a_window_beside_a_pending_fetch(tmp_path):
    got = {s.name: _restore_beside_pending(s, tmp_path / s.name)
           for s in SIDES}
    assert got["port"] == got["ref"]
    first, restored, _data, _pending, log = got["port"]
    assert first == (None, True) and restored
    assert log == [("fetch", 0), ("restore", 0), ("fetch", 0),
                   ("restore", 0)]


# ============================================ the manager's cluster wire
def _lifecycle(side, root):
    w = _World(side, root / "dvr", path="/live/a")
    out = [w.dvr.arm(w.sess, VIDEO_SDP), w.dvr.arm(w.sess, VIDEO_SDP),
           w.dvr.armed("/live/a")]
    w.push(_frames(48, size=200), pump=False)
    w.dvr.tick(w.t + 1000)
    out.append(w.dvr.advertise())
    blob = w.dvr.window_blob("/live/a", 1, 0)
    out += [blob, w.dvr.window_blob("/live/a", 1, 9999)]
    w.reg.remove("/live/a")
    w.dvr.tick(w.t + 2000)
    asset = w.dvr.open_asset("/live/a")
    out += [w.dvr.armed("/live/a"), asset.complete, w.dvr.advertise(),
            w.dvr.window_blob("/live/a.dvr", 1, 0) == blob]
    asset.close()
    doc = w.dvr.meta_doc("/live/a")
    out.append(doc)
    # a node that never saw the stream: the peer's documents as a
    # skeleton, every window read through the fetcher
    calls = []
    dvr2 = side.service.DvrManager(str(root / "dvr2"), w.cache, w.pacer,
                                   w.reg, window_pkts=16)

    def fetch(path, tid, win):
        calls.append((path, tid, win))
        return blob if win == 0 else None

    dvr2.fetcher = fetch
    out.append(dvr2.materialize("/live/b", doc))
    out.append(_files(root / "dvr2"))
    a2 = dvr2.open_asset("/live/b")
    rows = a2.tracks[1].read_window(0)
    out += [rows.n, rows.data.tobytes(), rows.seq.tolist(),
            a2.tracks[1].read_window(1), list(calls), a2.complete,
            a2.duration_sec()]
    a2.close()
    w.close()
    return out


def test_manager_lifecycle_advertise_peer_fill(tmp_path):
    got = {s.name: _lifecycle(s, tmp_path / s.name) for s in SIDES}
    assert got["port"] == got["ref"]
    p = got["port"]
    assert p[:3] == [True, False, True]
    adv = p[3]
    assert list(adv) == ["/live/a"] and adv["/live/a"]["1"][0] == 0
    assert p[4] is not None and p[5] is None
    assert p[6:10] == [False, True, {}, True]
    assert p[11] is True
    assert p[13] == 16 and p[16] is None
    assert p[17][:2] == [("/live/b", 1, 0), ("/live/b", 1, 1)]


def _guards(side, root):
    w = _World(side, root / "dvr", path="/live/g")
    w.dvr.arm(w.sess, VIDEO_SDP)
    w.push(_frames(40, size=200), pump=False)
    armed_doc = w.dvr.meta_doc("/live/g")
    res = {"armed": w.dvr.materialize("/live/g", armed_doc)}
    w.dvr.finalize("/live/g")
    doc = w.dvr.meta_doc("/live/g")
    res["local_asset"] = w.dvr.materialize("/live/g", doc)
    res["incomplete"] = w.dvr.materialize("/live/i", armed_doc)
    res["escape"] = w.dvr.materialize("/../../x", doc)
    res["no_tracks"] = w.dvr.materialize("/live/n",
                                         {**doc, "tracks": {}})
    res["bad_track"] = w.dvr.materialize(
        "/live/t", {**doc, "tracks": {"x": {}, "1": 3}})
    res["not_a_doc"] = w.dvr.materialize("/live/d", {"meta": 1})
    # a torn skeleton (track dirs, no meta.json) is scrubbed and rebuilt
    torn = root / "dvr" / "live" / "torn" / "track7"
    torn.mkdir(parents=True)
    (torn / "junk").write_bytes(b"x")
    res["torn"] = w.dvr.materialize("/live/torn", doc)
    res["ok"] = w.dvr.materialize("/live/ok.dvr", doc)
    res["again"] = w.dvr.materialize("/live/ok", doc)
    res["files"] = _files(root / "dvr")
    res["bootstrap"] = w.dvr.open_asset("/live/ok.dvr").sdp
    w.close()
    return res


def test_materialize_guards_equal_the_reference(tmp_path):
    got = {s.name: _guards(s, tmp_path / s.name) for s in SIDES}
    assert got["port"] == got["ref"]
    p = got["port"]
    assert [p[k] for k in ("armed", "local_asset", "incomplete", "escape",
                           "no_tracks", "bad_track", "not_a_doc")] \
        == [False] * 7
    assert p["torn"] and p["ok"] and not p["again"]
    assert "live/torn/track7/junk" not in p["files"]
    assert p["files"]["live/ok/track1/spill.bin"] == b""
    assert p["bootstrap"] == VIDEO_SDP
    evs = [r for r in obs.EVENTS.tail(50) if r["event"] == "dvr.bootstrap"]
    assert {e["stream"] for e in evs} >= {"/live/torn", "/live/ok"}


# ================================================================ REST
def _rest(side, root, dvr=None, storage=None):
    reg = (RefRegistry if side.name == "ref" else SessionRegistry)()
    if side.name == "ref":
        cfg = RefConfig(movie_folder=str(root))
    else:
        cfg = ServerConfig(movie_folder=str(root))
    app = types.SimpleNamespace(registry=reg, dvr=dvr, storage=storage)
    return REF_CMDS[side.name](cfg, app), app


def _dvr_rest(side, root):
    rest, app = _rest(side, root)
    q = {"path": ["/live/x"], "track": ["1"], "win": ["0"]}
    out = [rest._cmd_dvrwindow(q, b""), rest._cmd_dvrmeta(q, b"")]
    w = _World(side, root / "dvr", k=8, path="/live/x")
    app.dvr = w.dvr
    w.dvr.arm(w.sess, VIDEO_SDP)
    w.push(_frames(20, size=200), pump=False)
    w.dvr.tick(99_999_999)
    for query in (q, {**q, "win": ["bad"]}, {**q, "track": [""]},
                  {**q, "win": ["999"]}, {**q, "path": ["/live/none"]}):
        out.append(rest._cmd_dvrwindow(query, b""))
    out.append(rest._cmd_dvrmeta(q, b""))
    w.dvr.finalize("/live/x")
    out.append(rest._cmd_dvrwindow(q, b""))
    out += [rest._cmd_dvrmeta(q, b""), rest._cmd_dvrmeta({}, b""),
            rest._cmd_dvrmeta({"path": ["/live/none"]}, b"")]
    w.close()
    return out


def test_dvrwindow_rest_endpoint(tmp_path):
    got = {s.name: _dvr_rest(s, tmp_path / s.name) for s in SIDES}
    assert got["port"] == got["ref"]
    p = got["port"]
    assert [r[0] for r in p] == [404, 404, 200, 400, 400, 404, 404, 200,
                                 200, 200, 404, 404]
    assert p[2][2] == "application/octet-stream"
    assert PORT.spill.decode_blob(p[2][1], 0).n == 8
    doc = json.loads(p[9][1])
    assert doc["meta"]["complete"] and doc["tracks"]["1"]["windows"]
    assert p[9][2] == "application/json"


def _stores(side, root, blobs, gen=1):
    if side.name == "ref":
        st = RefStorage(str(root / "shards"), "node-a", k=2, m=1,
                        use_device=False)
    else:
        st = StorageService(str(root / "shards"), "node-a", k=2, m=1,
                            device="cpu")
    man = st.store_asset("/live/sa", _FakeDvr({1: dict(enumerate(blobs))},
                                              gen=gen))
    return st, man


def _shard_rest(side, root):
    rest, app = _rest(side, root)
    name = shard_name(1, 0, 0)
    q = {"path": ["/live/sa"], "name": [name]}
    out = [rest._cmd_shard(q, b""), rest._cmd_shardmeta(q, b""),
           rest._cmd_shardpush(q, b"{}\n\nx")]
    blobs = _blobs(4)
    st, man = _stores(side, root / "a", blobs)
    app.storage = st
    for query in (q, {**q, "name": [""]}, {"path": ["/live/sa"],
                  "name": ["t1/s9.0"]}, {"path": ["/none"], "name": [name]}):
        out.append(rest._cmd_shard(query, b""))
    out += [rest._cmd_shardmeta(q, b""), rest._cmd_shardmeta({}, b"")]
    # the dvrmeta fallback: no DVR asset here, the manifest's document
    app.dvr = types.SimpleNamespace(meta_doc=lambda _p: None)
    out.append(rest._cmd_dvrmeta({"path": ["/live/sa"]}, b""))
    # shardpush into a second store: accepted, corrupt, no separator,
    # bad manifest, missing name, an older generation after a newer one
    rest2, app2 = _rest(side, root / "b")
    st2 = (RefStorage(str(root / "b" / "shards"), "node-b", k=2, m=1,
                      use_device=False) if side.name == "ref" else
           StorageService(str(root / "b" / "shards"), "node-b", k=2, m=1,
                          device="cpu"))
    app2.storage = st2
    man_json = json.dumps(man, separators=(",", ":")).encode()
    push = {"path": ["/live/sa"], "name": [name]}
    out.append(rest2._cmd_shardpush(push, man_json + b"\n\n" + blobs[0]))
    out.append(rest2._cmd_shardpush(
        {**push, "name": [shard_name(1, 0, 1)]},
        man_json + b"\n\n" + blobs[1][:-1] + b"\x00"))
    out.append(rest2._cmd_shardpush(push, man_json + blobs[0]))
    out.append(rest2._cmd_shardpush(push, b"{bad\n\n" + blobs[0]))
    out.append(rest2._cmd_shardpush({**push, "name": [""]},
                                    man_json + b"\n\n" + blobs[0]))
    out.append(rest2._cmd_shardpush(
        {**push, "name": [shard_name(1, 0, 1)]}, b"\n\n" + blobs[1]))
    out.append(st2.shards_local)
    out.append(st2.manifest("/live/sa") == man)
    return out


def test_shard_endpoints_and_shardpush_gate_equal_the_reference(tmp_path):
    got = {s.name: _shard_rest(s, tmp_path / s.name) for s in SIDES}
    assert got["port"] == got["ref"]
    p = got["port"]
    assert [r[0] for r in p[:-2]] == [404, 404, 404, 200, 400, 404, 404,
                                      200, 404, 200, 200, 400, 400, 400,
                                      400, 200]
    assert json.loads(p[7][1])["gen"] == 1
    assert json.loads(p[9][1]) == json.loads(p[7][1])["dvr"]
    assert "shard refused (crc/gen)" in p[11][1]
    assert p[-2] == 2 and p[-1] is True


def test_stripe_ranked_placement_spreads_one_stripe(tmp_path):
    """The ``k + m`` shards of a stripe deal down the stripe's own ring
    ranking: the same targets as the reference's for every stripe, and a
    survivor ring elects the same successor."""
    st = StorageService(str(tmp_path / "p"), "n0", k=2, m=1, device="cpu")
    ref = RefStorage(str(tmp_path / "r"), "n0", k=2, m=1, use_device=False)
    nodes = [f"n{i}" for i in range(5)]
    ring = placement.HashRing(nodes)
    ref_ring = ref_placement.HashRing(nodes)
    for s in range(12):
        targets = [st._placement_target(ring, "/live/pl",
                                        shard_name(1, s, j))
                   for j in range(3)]
        assert targets == [ref._placement_target(ref_ring, "/live/pl",
                                                 shard_name(1, s, j))
                           for j in range(3)]
        assert len(set(targets)) == 3
        assert targets == ring.rank(f"/live/pl/t1/s{s}")[:3]
    surv = placement.HashRing(["n0", "n1"])
    assert st._placement_target(surv, "/live/pl", shard_name(1, 0, 1)) \
        == ref._placement_target(ref_placement.HashRing(["n0", "n1"]),
                                 "/live/pl", shard_name(1, 0, 1)) \
        == surv.rank("/live/pl/t1/s0")[1]


def _receive(side, root):
    blobs = _blobs(2)
    st, man = _stores(side, root / "a", blobs)
    other_root = root / "b"
    other = (RefStorage(str(other_root), "node-b", k=2, m=1,
                        use_device=False) if side.name == "ref" else
             StorageService(str(other_root), "node-b", k=2, m=1,
                            device="cpu"))
    name = shard_name(1, 0, 0)
    man_doc = json.loads(json.dumps(man))
    out = [other.receive_shard("/live/sa", name, blobs[0], man_doc),
           other.shards_local,
           other.receive_shard("/live/sa", shard_name(1, 0, 1),
                               blobs[1][:-1] + b"\x00", man_doc),
           other.shards_local]
    dvr2 = _FakeDvr({1: dict(enumerate(_blobs(2, seed=9)))}, gen=2)
    man2 = st.store_asset("/live/sa", dvr2)
    b2 = dvr2.window_blob("/live/sa", 1, 0)
    out += [man2["gen"], other.receive_shard(
        "/live/sa", name, b2, json.loads(json.dumps(man2))),
        int(other.manifest("/live/sa")["gen"])]
    with open(other._shard_path("/live/sa", name), "rb") as fh:
        out.append(fh.read() == b2)
    # an older generation after the newer one: refused
    out.append(other.receive_shard("/live/sa", shard_name(1, 0, 1),
                                   blobs[1], man_doc))
    out.append(_files(other_root))
    return out


def test_receive_shard_crc_gate_and_gen_replace(tmp_path):
    got = {s.name: _receive(s, tmp_path / s.name) for s in SIDES}
    assert got["port"] == got["ref"]
    p = got["port"]
    assert p[:8] == [True, 1, False, 1, 2, True, 2, True]


# ====================================================== the pump's fetcher
class _Pool:
    """An executor whose futures the test completes."""

    def __init__(self):
        self.futs = []

    def submit(self, fn, *args):
        f = Future()
        f.args = args
        self.futs.append(f)
        return f


def _fetch_calls(side_cls) -> list:
    pool = _Pool()
    me = types.SimpleNamespace(
        cluster=types.SimpleNamespace(dvr_peers={
            "/live/p": ("10.0.0.1", 8000, {"1": [2, 40]})},
            last_nodes={"q": {"ip": "10.0.0.2", "http": 8001}}),
        _dvr_meta_peers={"/live/q": ("10.0.0.2", 8001, {})},
        _dvr_fetches={}, _DVR_FETCH_INFLIGHT_MAX=32,
        _ensure_dvr_fetch_pool=lambda: pool,
        _dvr_fetch_blocking=lambda *a: None)
    f = side_cls._dvr_peer_fetch
    out = [f(me, "/live/none", 1, 3), f(me, "/live/p", 1, 1),
           f(me, "/live/p", 1, 41), f(me, "/live/p", 1, 3),
           f(me, "/live/p", 1, 3)]
    pool.futs[0].set_result(b"blob3")
    out += [f(me, "/live/p", 1, 3), len(me._dvr_fetches),
            f(me, "/live/q", 2, 0)]
    pool.futs[1].set_exception(OSError("peer gone"))
    out.append(f(me, "/live/q", 2, 0))
    # the in-flight cap: 32 pending, then refusals; finished futures of
    # abandoned sessions are reaped to make room
    out += [f(me, "/live/p", 1, 4 + i) for i in range(33)]
    for fut in pool.futs[2:10]:
        fut.set_result(b"x")
    out += [f(me, "/live/p", 2, 7), len(me._dvr_fetches)]
    out.append([fu.args for fu in pool.futs[:3]])
    me.cluster = None
    out.append(f(me, "/live/p", 1, 3))
    return out


def test_peer_fetch_protocol_equals_the_reference():
    port = _fetch_calls(StreamingServer)
    assert port == _fetch_calls(RefApp)
    # no peer, outside the advertised span (both sides), a pending fetch
    assert port[:5] == [None, None, None, b"", b""]
    # the blob lands and its entry goes; a meta-routed peer; a failure
    assert port[5:9] == [b"blob3", 0, b"", None]
    # 32 in flight, the 33rd refused; 8 finished ones reaped for a new one
    assert port[9:41] == [b""] * 32 and port[41] is None
    assert port[42:44] == [b"", 25]
    assert port[44][0] == ("10.0.0.1", 8000, "/live/p", 1, 3)
    assert port[-1] is None


def test_a_stale_advert_defers_to_a_live_bootstrap_peer():
    """A window past the advertised span (a recording's last advert
    before its finalize) is asked of the peer whose ``dvrmeta``
    bootstrapped the path while that peer's lease is live; the
    reference's fetcher answers None there (the replay hops the window).
    A bootstrap peer whose lease lapsed is not asked."""
    got = {}
    for name, cls in (("port", StreamingServer), ("ref", RefApp)):
        for live in (True, False):
            pool = _Pool()
            me = types.SimpleNamespace(
                cluster=types.SimpleNamespace(
                    dvr_peers={
                        "/live/s": ("10.0.0.1", 8000, {"1": [0, 2]})},
                    last_nodes={"a": {"ip": "10.0.0.1", "http": 8000},
                                **({"b": {"ip": "10.0.0.2", "http": 8001}}
                                   if live else {})}),
                _dvr_meta_peers={
                    "/live/s": ("10.0.0.2", 8001, {"1": [0, 5]}),
                    "/live/t": ("10.0.0.2", 8001, {"1": [0, 5]})},
                _dvr_fetches={}, _DVR_FETCH_INFLIGHT_MAX=32,
                _ensure_dvr_fetch_pool=lambda: pool,
                _dvr_fetch_blocking=lambda *a: None)
            calls = [cls._dvr_peer_fetch(me, p, 1, w)
                     for p, w in (("/live/s", 1), ("/live/s", 5),
                                  ("/live/s", 6), ("/live/t", 3))]
            got[name, live] = (calls, [f.args[:2] for f in pool.futs])
    assert got["port", True] == (
        [b"", b"", None, b""],
        [("10.0.0.1", 8000), ("10.0.0.2", 8001), ("10.0.0.2", 8001)])
    assert got["port", False] == ([b"", None, None, None],
                                  [("10.0.0.1", 8000)])
    assert got["ref", True] == ([b"", None, None, b""],
                                [("10.0.0.1", 8000), ("10.0.0.2", 8001)])


async def test_meta_sync_sweeps_once_and_caches_a_miss(tmp_path):
    """Concurrent DESCRIBEs of one path share one ``dvrmeta`` sweep; a
    path no peer knows is not swept again within the miss window."""
    app = StreamingServer(cdl.node_config(str(tmp_path), "n", k=2, m=1,
                                          window_pkts=16), device="cpu")
    asked = []

    def meta_blocking(host, port, path):
        asked.append((host, port, path))
        time.sleep(0.05)
        return None

    app._dvr_meta_blocking = meta_blocking
    app.cluster = types.SimpleNamespace(
        last_nodes={"n": {"ip": "127.0.0.1", "http": 1},
                    "m": {"ip": "127.0.0.2", "http": 2}},
        config=types.SimpleNamespace(node_id="n"))
    try:
        got = await asyncio.gather(*(app._dvr_meta_sync("/live/zz")
                                     for _ in range(4)))
        assert got == [False] * 4
        assert asked == [("127.0.0.2", 2, "/live/zz")]
        assert await app._dvr_meta_sync("/live/zz") is False
        assert len(asked) == 1 and "/live/zz" in app._dvr_meta_misses
        assert not app._dvr_meta_sweeps
    finally:
        app.cluster = None
        if app._dvr_fetch_pool is not None:
            app._dvr_fetch_pool.shutdown(wait=True)


# ======================================================= the Own: records
@pytest.mark.parametrize("writer", ["port", "ref"])
async def test_advertised_spans_ride_own_records_across_packages(
        tmp_path, writer):
    """A node's ``advertise`` spans ride its fenced ``Own:`` record, and
    the other package's ``ClusterService`` reads them into ``dvr_peers``
    with the writer's address."""
    side = PORT if writer == "port" else REF
    svc_w = service if writer == "port" else ref_service
    svc_r = ref_service if writer == "port" else service
    w = _World(side, tmp_path / "dvr", path="/live/ad")
    w.dvr.arm(w.sess, VIDEO_SDP)
    w.push(_frames(40, size=200), pump=False)
    w.dvr.tick(w.t + 1000)
    adv = w.dvr.advertise()
    assert adv["/live/ad"]["1"][0] == 0
    r = InMemoryRedis()
    owner = svc_w.ClusterService(
        r, svc_w.ClusterConfig("writer", ip="10.1.0.1", http_port=18008,
                               lease_ttl_sec=5), registry=w.reg)
    owner.dvr_advertise = w.dvr.advertise
    reader_reg = (SessionRegistry if writer == "ref" else RefRegistry)()
    reader = svc_r.ClusterService(
        r, svc_r.ClusterConfig("reader", ip="10.1.0.2", http_port=18009,
                               lease_ttl_sec=5), registry=reader_reg)
    await owner.lease.acquire()
    await reader.lease.acquire()
    await owner.tick()
    await reader.tick()
    assert reader.dvr_peers == {"/live/ad": ("10.1.0.1", 18008,
                                             adv["/live/ad"])}
    assert owner.dvr_peers == {}          # its own records are not peers
    w.close()


# ===================================================== servers (the CPU)
def _ref_cfg(folder: str, node: str, **kw) -> RefConfig:
    d = os.path.join(folder, node)
    return RefConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        wan_ip="127.0.0.1", reflect_interval_ms=5, bucket_delay_ms=0,
        access_log_enabled=False, log_folder=os.path.join(d, "logs"),
        movie_folder=os.path.join(d, "movies"), server_id=node,
        cluster_enabled=True, cluster_lease_ttl_sec=cdl.LEASE_TTL_S,
        cluster_heartbeat_sec=cdl.HEARTBEAT_S,
        cluster_capacity_score=4096.0, dvr_enabled=True,
        dvr_window_pkts=16, storage_enabled=True, storage_data_shards=2,
        storage_parity_shards=1, storage_device=False, **kw)


async def _record(app, path: str, frames, n_windows: int = 3):
    """Push ``frames`` to ``app`` and finalize ``path``; the pushed
    packets."""
    c = await cdl._push(app.rtsp.port, path, frames, 0.004)
    try:
        await cdl._until(lambda: app.dvr.stats()["spilled_windows"]
                     >= n_windows, 10.0, "spilled windows")
        assert app.dvr.finalize(path) is not None
    finally:
        await c.close()
    return [p for pkts in frames for p in pkts]


async def _replay(app, path: str, n: int) -> list[bytes]:
    pl = await cdl._play(app.rtsp.port, path + ".dvr", n, 10.0)
    try:
        await pl["client"].teardown(pl["uri"])
    finally:
        await pl["client"].close()
    return pl["packets"]


async def test_remote_dvr_asset_bootstrap_replay(tmp_path):
    """B, which never saw the stream and has no ``.dvr`` tree, replays
    A's finalized recording: its DESCRIBE bootstraps through A's
    ``dvrmeta`` and every window comes over A's ``dvrwindow``; SPS first,
    one SSRC, a gapless seq, the pushed payloads, no repack.  B's
    skeleton holds A's documents as the reference's ``materialize``
    writes them."""
    redis = InMemoryRedis()
    cfgs = [cdl.node_config(str(tmp_path), n, k=2, m=1, window_pkts=16)
            for n in ("dvr-a", "dvr-b")]
    for c in cfgs:
        c.storage_enabled = False
    app_a, app_b = [StreamingServer(c, device="cpu", redis_client=redis)
                    for c in cfgs]
    await app_a.start()
    await app_b.start()
    try:
        await cdl._until(lambda: len(app_b.cluster.last_nodes) == 2, 10.0,
                     "both leases")
        frames = cdl.h264_frames(np.random.default_rng(41), 80, gop=8,
                                 nal_bytes=300)
        pushed = await _record(app_a, "/live/rb", frames)
        doc = app_a.dvr.meta_doc("/live/rb")
        n = sum(len(t["windows"]) for t in doc["tracks"].values()) * 16
        assert not os.path.isdir(os.path.join(
            app_b.config.movie_folder, ".dvr", "live"))
        packs = port_cache.pack_window.calls
        got = await _replay(app_b, "/live/rb", n)
        assert len(got) == n
        cdl.check_stream(got, pushed, "B's replay")
        assert port_cache.pack_window.calls == packs
        assert app_b._dvr_meta_peers["/live/rb"][:2] == (
            "127.0.0.1", app_a.rest.port)
        assert app_b.dvr.meta_doc("/live/rb") == doc
        # the skeleton's files are the reference's materialize of doc
        ref_dvr = REF.service.DvrManager(str(tmp_path / "ref"), None,
                                         None, RefRegistry())
        assert ref_dvr.materialize("/live/rb", doc)
        assert _files(os.path.join(app_b.config.movie_folder, ".dvr")) \
            == _files(tmp_path / "ref")
    finally:
        await app_a.stop()
        await app_b.stop()
    for app in (app_a, app_b):
        assert app.pump_errors == 0 and app.device_errors == 0


async def test_dead_owner_dvrmeta_bootstrap_and_replay(tmp_path):
    """The recording node stops after its store placed the asset's
    shards (k = 2, m = 1 over three nodes); a survivor's ``dvrmeta``
    answers from its shard manifest (the document the owner stored), and
    the survivor replays the asset through its own restore chain from
    the surviving shards: SPS first, one SSRC, a gapless seq, the pushed
    payloads, no repack, no codec oracle mismatch."""
    redis = InMemoryRedis()
    apps = [StreamingServer(cdl.node_config(str(tmp_path), n, k=2, m=1,
                                            window_pkts=16),
                            device="cpu", redis_client=redis)
            for n in cdl.NODES]
    app_a, app_b, app_c = apps
    for app in apps:
        await app.start()
    a_stopped = False
    try:
        await cdl._until(lambda: all(len(a.cluster.last_nodes) == 3
                                 for a in apps), 10.0, "three leases")
        frames = cdl.h264_frames(np.random.default_rng(43), 80, gop=8,
                                 nal_bytes=300)
        pushed = await _record(app_a, "/live/do", frames)
        await cdl._until(lambda: app_a.storage.stored_assets == 1, 10.0,
                     "the store")
        assert app_b.storage.shards_local > 0
        assert app_c.storage.shards_local > 0
        doc = app_a.dvr.meta_doc("/live/do")
        n = sum(len(t["windows"]) for t in doc["tracks"].values()) * 16
        await app_a.stop()
        a_stopped = True
        reader, writer = await asyncio.wait_for(asyncio.open_connection(
            "127.0.0.1", app_b.rest.port), 5.0)
        try:
            writer.write(b"GET /api/v1/dvrmeta?path=/live/do HTTP/1.1\r\n"
                         b"Host: x\r\n\r\n")
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 5.0)
            assert int(head.split(b" ")[1]) == 200, head
            clen = int([ln for ln in head.split(b"\r\n")
                        if ln.lower().startswith(b"content-length")][0]
                       .split(b":")[1])
            got_doc = json.loads(await asyncio.wait_for(
                reader.readexactly(clen), 5.0))
        finally:
            writer.close()
        assert got_doc == doc
        assert app_b.dvr.meta_doc("/live/do") is None   # not B's DVR
        packs = port_cache.pack_window.calls
        got = await _replay(app_b, "/live/do", n)
        assert len(got) == n
        cdl.check_stream(got, pushed, "B's replay")
        assert port_cache.pack_window.calls == packs
        st = app_b.storage.stats()
        assert st["reconstructs"] > 0 and st["reconstruct_failures"] == 0
        assert st["scrub_errors"] == 0 and st["oracle_mismatches"] == 0
    finally:
        if not a_stopped:
            await app_a.stop()
        await app_b.stop()
        await app_c.stop()


@pytest.mark.parametrize("recorder", ["ref", "port"])
async def test_mixed_cluster_replays_the_other_package_recording(
        tmp_path, recorder):
    """One Redis, a reference node and a port node.  The recorder's node
    records and finalizes; its store pushes the shards it does not keep
    to the other package's node over ``shardpush``, which accepts them.
    The other node replays the asset through the recorder's ``dvrmeta``
    and ``dvrwindow``: SPS first, one SSRC, a gapless seq, the pushed
    payloads, and no repack in either package."""
    redis = InMemoryRedis()
    ref_app = RefServer(_ref_cfg(str(tmp_path), "ref-node"),
                        redis_client=redis)
    port_app = StreamingServer(
        cdl.node_config(str(tmp_path), "port-node", k=2, m=1,
                        window_pkts=16), device="cpu", redis_client=redis)
    rec, rep = (ref_app, port_app) if recorder == "ref" \
        else (port_app, ref_app)
    await ref_app.start()
    await port_app.start()
    try:
        await cdl._until(lambda: len(ref_app.cluster.last_nodes) == 2
                     and len(port_app.cluster.last_nodes) == 2, 10.0,
                     "both leases")
        frames = cdl.h264_frames(np.random.default_rng(47), 80, gop=8,
                                 nal_bytes=300)
        pushed = await _record(rec, "/live/mx", frames)
        await cdl._until(lambda: rec.storage.stored_assets == 1, 10.0,
                     "the store")
        man = rec.storage.manifest("/live/mx")
        assert rec.storage.shards_pushed > 0
        assert rep.storage.shards_local == rec.storage.shards_pushed
        got_man = rep.storage.manifest("/live/mx")
        assert {k: v for k, v in got_man.items() if k != "holders"} \
            == {k: v for k, v in man.items() if k != "holders"}
        doc = rec.dvr.meta_doc("/live/mx")
        n = sum(len(t["windows"]) for t in doc["tracks"].values()) * 16
        # the reference's fetcher asks the advertising claim holder alone,
        # and the recording's last advert (its span as of its last tick
        # before the finalize) lives until the claim goes: the replay
        # starts once the replayer's map has dropped it
        await cdl._until(lambda: "/live/mx" not in rep.cluster.dvr_peers, 10.0,
                     "the recording's advert gone")
        packs = (ref_cache.pack_window.calls, port_cache.pack_window.calls)
        got = await _replay(rep, "/live/mx", n)
        assert len(got) == n
        cdl.check_stream(got, pushed, f"the {recorder} recording's replay")
        assert (ref_cache.pack_window.calls,
                port_cache.pack_window.calls) == packs
        assert rep._dvr_meta_peers["/live/mx"][:2] == ("127.0.0.1",
                                                       rec.rest.port)
        assert rep.dvr.meta_doc("/live/mx") == doc
    finally:
        await port_app.stop()
        await ref_app.stop()
    assert port_app.pump_errors == 0 and port_app.device_errors == 0


async def test_corrupt_shardpush_refused_by_both_packages(tmp_path):
    """The same corrupt ``shardpush`` POSTed over HTTP to a reference
    node and a port node: both answer 400 with the same envelope, and
    neither keeps a byte; the intact push is taken by both."""
    redis = InMemoryRedis()
    ref_app = RefServer(_ref_cfg(str(tmp_path), "ref-node"),
                        redis_client=redis)
    port_app = StreamingServer(
        cdl.node_config(str(tmp_path), "port-node", k=2, m=1,
                        window_pkts=16), device="cpu", redis_client=redis)
    await ref_app.start()
    await port_app.start()
    try:
        blobs = _blobs(2)
        st, man = _stores(PORT, tmp_path / "src", blobs)
        man_json = json.dumps(man, separators=(",", ":")).encode()
        name = shard_name(1, 0, 1)
        target = f"/api/v1/shardpush?path={quote('/live/sa')}&name=" \
                 f"{quote(name)}"
        answers = {}
        for side, app in (("ref", ref_app), ("port", port_app)):
            bad = await asyncio.to_thread(
                _post, app.rest.port, target,
                man_json + b"\n\n" + blobs[1][:-1] + b"\x00")
            kept = app.storage.shards_local
            good = await asyncio.to_thread(
                _post, app.rest.port, target,
                man_json + b"\n\n" + blobs[1])
            answers[side] = (bad, kept, good, app.storage.shards_local)
        assert answers["ref"] == answers["port"]
        bad, kept, good, after = answers["port"]
        assert bad[0] == 400 and b"shard refused (crc/gen)" in bad[1]
        assert kept == 0 and good[0] == 200 and after == 1
    finally:
        await port_app.stop()
        await ref_app.stop()


def _post(port: int, target: str, body: bytes) -> tuple[int, bytes]:
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5.0)
    try:
        conn.request("POST", target, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


async def test_peer_calls_on_an_auth_enabled_pair(tmp_path):
    """With ``auth_enabled`` every peer GET and POST carries the node's
    REST credentials: the shared ones replay through the peer fill; wrong
    ones get 401, which is a failed call (None, False), never an
    exception."""
    redis = InMemoryRedis()
    cfgs = [cdl.node_config(str(tmp_path), n, k=2, m=1, window_pkts=16)
            for n in ("auth-a", "auth-b")]
    for c in cfgs:
        c.auth_enabled = True
        c.rest_username, c.rest_password = "ops", "s3cret"
        c.storage_enabled = False
    app_a, app_b = [StreamingServer(c, device="cpu", redis_client=redis)
                    for c in cfgs]
    await app_a.start()
    await app_b.start()
    try:
        await cdl._until(lambda: len(app_b.cluster.last_nodes) == 2, 10.0,
                     "both leases")
        frames = cdl.h264_frames(np.random.default_rng(53), 80, gop=8,
                                 nal_bytes=300)
        pushed = await _record(app_a, "/live/au", frames)
        doc = app_a.dvr.meta_doc("/live/au")
        n = sum(len(t["windows"]) for t in doc["tracks"].values()) * 16
        refused = app_a.rest.refused["401"]
        got = await _replay(app_b, "/live/au", n)
        assert len(got) == n
        cdl.check_stream(got, pushed, "the authenticated replay")
        assert app_a.rest.refused["401"] == refused
        port = app_a.rest.port
        meta = {"ip": "127.0.0.1", "http": port}
        assert await asyncio.to_thread(app_b._dvr_meta_blocking,
                                       "127.0.0.1", port,
                                       "/live/au") == doc
        app_b.config.rest_password = "wrong"
        calls = await asyncio.to_thread(lambda: [
            app_b._dvr_meta_blocking("127.0.0.1", port, "/live/au"),
            app_b._dvr_fetch_blocking("127.0.0.1", port, "/live/au", 1, 0),
            app_b._storage_fetch_blocking(meta, "/live/au", "t1/s0.0"),
            app_b._storage_manifest_blocking(meta, "/live/au"),
            app_b._storage_push_blocking(meta, "/live/au", "t1/s0.0",
                                         b"x", "{}")])
        assert calls == [None, None, None, None, False]
        assert app_a.rest.refused["401"] == refused + 5
    finally:
        await app_a.stop()
        await app_b.stop()


async def test_cluster_dvr_harness_on_cpu(tmp_path):
    """``chip_smoke.py`` phase 17b's harness at a small size: the store
    across three nodes, B's remote replay, the dead owner's replay on C
    through B's manifest answer and a B4 reconstruct (a deleted shard of
    C's), and the CMS's two channels on one media server, every check
    of the harness passing."""
    res = await cdl.cluster_dvr("cpu", str(tmp_path), frames=60,
                                window_pkts=16, cms_frames=30)
    assert res["remote"]["players"][0]["first_index"] == 0
    assert res["dead_owner"]["c_product_ms"] > 0
    assert set(res["servers"]) == set(cdl.NODES)
    for node, counters in res["servers"].items():
        assert all(counters[k] == 0 for k in cdl.ZERO_COUNTERS), node
    assert res["dead_owner"]["reconstruct"]["reconstructs"] > 0
    assert res["pack_window_calls"] == 0
    assert res["cms"]["media"] in cdl.NODES[1:]
    assert len(res["cms"]["players"]) == 2
    assert res["deleted_shard"].endswith(".0") \
        or res["deleted_shard"].endswith(".1")
