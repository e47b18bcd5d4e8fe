"""Pull relays on the port: server B pulls a live path of server A.

* ``parse_rtsp_url`` equals the reference's, refusals included;
* in process (``device="cpu"``): a chain A → B where every packet a
  player on B gets equals the pushed one from byte 12, contiguous in seq
  from its RTP-Info; two pulled paths with players ride B's megabatch
  (its window calls > 0, mismatches 0); the REST control
  (``startpullrelay`` / ``getpullrelays`` / ``stoppullrelay``, a second
  start refused with 502);
* the reference's three failure cases: an occupied path is refused, a
  dead upstream is swept (its socket closed, its session gone), and a
  dead pull never removes a session a pusher took over;
* the pull client's receiver counts (lost, duplicates, reordered) equal
  the reference's ``ReceiverStats`` on the same seqs;
* ``utils.surface_loopback.serve_surface`` at a small size on the CPU:
  origin A from TOML, edge B from the reference's XML, B's pulls of A
  and a broadcast, tunneled, TCP and UDP players with Digest, every REST
  check, the per-IP cap, icy MP3 and the access log.
"""

import asyncio
import json

import numpy as np
import pytest

from easydarwin_tpu.relay import pull as ref_pull
from easydarwin_tpu_torch.protocol import rtp
from easydarwin_tpu_torch.relay.pull import PullError, parse_rtsp_url
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.utils import loopback, surface_loopback, synth
from easydarwin_tpu_torch.utils.client import RtspClient
from easydarwin_tpu_torch.utils.surface_loopback import rest


@pytest.mark.parametrize("url", [
    "rtsp://h:10554/live/x", "rtsp://h/live/x", "rtsp://127.0.0.1:1/",
    "rtsp://h:8554", "http://h/live/x", "rtsp:///x", "live/x", ""])
def test_parse_rtsp_url_equals_the_reference(url):
    try:
        want = ref_pull.parse_rtsp_url(url)
    except ref_pull.PullError:
        with pytest.raises(PullError):
            parse_rtsp_url(url)
        return
    assert parse_rtsp_url(url) == want


def test_receiver_stats_equal_the_reference():
    from easydarwin_tpu.utils.client import ReceiverStats as RefStats
    from easydarwin_tpu_torch.utils.client import ReceiverStats
    rng = np.random.default_rng(5)
    seqs = [int(s) & 0xFFFF for s in np.cumsum(rng.integers(-2, 4, 400))
            + 0xFFF0]
    ours, ref = ReceiverStats(), RefStats()
    for s in seqs:
        pkt = synth.h264_packet(s, 0, 1, ssrc=1, body=bytes(4))
        ours.on_packet(pkt)
        ref.on_packet(pkt)
    for k in ("packets", "bytes", "lost", "duplicates", "out_of_order"):
        assert getattr(ours, k) == getattr(ref, k), k
    assert ours.lost and ours.duplicates and ours.out_of_order


async def _server(tmp_path, **kw):
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        reflect_interval_ms=5, log_folder=str(tmp_path), **kw), device="cpu")
    await app.start()
    return app


async def _pusher(port: int, path: str) -> RtspClient:
    c = RtspClient()
    await c.connect("127.0.0.1", port)
    await c.push_start(f"rtsp://127.0.0.1:{port}{path}", loopback.VIDEO_SDP)
    return c


def _gop(rng, k: int, n: int = 2) -> list[bytes]:
    out = []
    for _ in range(n):
        out += synth.paced_gop(rng, seq0=100 * k + len(out),
                               ts0=3000 * len(out), ssrc=0xC0DE + k,
                               frames=4, packets_per_frame=3,
                               body_len=(40, 120))
    return out


async def test_pull_chain_and_the_megabatch(tmp_path):
    rng = np.random.default_rng(18)
    a = await _server(tmp_path / "a")
    b = await _server(tmp_path / "b")
    try:
        pushers, players, sent = [], [], []
        for k in (1, 2):
            pushers.append(await _pusher(a.rtsp.port, f"/cam{k}"))
            await b.pulls.start_pull(
                f"/pull{k}", f"rtsp://127.0.0.1:{a.rtsp.port}/cam{k}")
            p = RtspClient()
            await p.connect("127.0.0.1", b.rtsp.port)
            await p.play_start(f"rtsp://127.0.0.1:{b.rtsp.port}/pull{k}")
            players.append(p)
            sent.append(_gop(rng, k))
        for i in range(len(sent[0])):
            for k in range(2):
                pushers[k].push_packet(0, sent[k][i])
            await asyncio.sleep(0.002)
        for k, p in enumerate(players):
            got = [await p.recv_interleaved(0) for _ in sent[k]]
            seq0 = rtp.peek_seq(got[0])
            for i, (g, s) in enumerate(zip(got, sent[k])):
                assert g[12:] == s[12:] and g[:2] == s[:2]
                assert rtp.peek_seq(g) == (seq0 + i) & 0xFFFF
        mb = b.megabatch.stats()
        assert mb["window_calls"] > 0 and mb["mismatches"] == 0
        assert b.stats()["packets_in"] >= 2 * len(sent[0])
        for pl in b.pulls.list_pulls():
            assert pl["alive"] and pl["first_packet_ms"] is not None
            assert pl["packets"] >= len(sent[0])
        st = await b.pulls.stop_pull("/pull1")
        assert st["packets"] >= len(sent[0])
        assert b.registry.find("/pull1") is None
        for c in (*players, *pushers):
            await c.close()
    finally:
        await b.stop()
        await a.stop()


async def test_pull_rest_control(tmp_path):
    a = await _server(tmp_path / "a")
    b = await _server(tmp_path / "b")
    try:
        pusher = await _pusher(a.rtsp.port, "/live/cam")
        url = f"rtsp://127.0.0.1:{a.rtsp.port}/live/cam"
        st, doc = await rest(b.rest.port, "startpullrelay",
                             query=f"path=/mirror&url={url}")
        assert st == 200 and doc["EasyDarwin"]["Body"] == {
            "Pull": "/mirror", "Url": url}
        st, doc = await rest(b.rest.port, "getpullrelays")
        pulls = doc["EasyDarwin"]["Body"]["Pulls"]
        assert len(pulls) == 1 and pulls[0]["url"] == url
        st, doc = await rest(b.rest.port, "startpullrelay",
                             query=f"path=/mirror&url={url}")
        assert st == 502
        st, _ = await rest(b.rest.port, "startpullrelay", query="path=/x")
        assert st == 400
        st, doc = await rest(b.rest.port, "stoppullrelay",
                             query="path=/mirror")
        assert st == 200 and doc["EasyDarwin"]["Body"]["Pull"] == "/mirror"
        st, _ = await rest(b.rest.port, "stoppullrelay", query="path=/mirror")
        assert st == 404
        assert b.pulls.counts["refused"] == 1
        await pusher.close()
    finally:
        await b.stop()
        await a.stop()


async def test_pull_refuses_an_occupied_path_and_a_dead_url(tmp_path):
    b = await _server(tmp_path)
    try:
        b.registry.find_or_create("/busy", loopback.VIDEO_SDP)
        with pytest.raises(PullError):
            await b.pulls.start_pull("/busy", "rtsp://127.0.0.1:1/x")
        with pytest.raises(PullError):
            await b.pulls.start_pull("/free", "rtsp://127.0.0.1:1/x")
        assert not b.pulls.pulls and b.registry.find("/free") is None
    finally:
        await b.stop()


async def _dead_pull(tmp_path, path: str):
    a = await _server(tmp_path / "a")
    b = await _server(tmp_path / "b")
    pusher = await _pusher(a.rtsp.port, "/live/x")
    pusher.push_packet(0, synth.h264_packet(1, 0, 5, ssrc=5, body=bytes(30)))
    await b.pulls.start_pull(path, f"rtsp://127.0.0.1:{a.rtsp.port}/live/x")
    await pusher.close()
    await a.stop()
    for _ in range(200):
        if not b.pulls.pulls[path].alive:
            break
        await asyncio.sleep(0.02)
    assert not b.pulls.pulls[path].alive
    return b


async def test_dead_upstream_is_swept(tmp_path):
    b = await _dead_pull(tmp_path, "/dead")
    try:
        client = b.pulls.pulls["/dead"].client
        assert b.registry.find("/dead") is None     # released at EOF
        assert await b.pulls.sweep() == 1
        assert not b.pulls.pulls and client.writer.is_closing()
    finally:
        await b.stop()


async def test_dead_pull_never_removes_a_reannounced_session(tmp_path):
    b = await _dead_pull(tmp_path, "/x")
    try:
        takeover = b.registry.find_or_create("/x", loopback.VIDEO_SDP)
        assert await b.pulls.sweep() == 1
        assert b.registry.find("/x") is takeover
        # a pull started over the swept one's path is refused: occupied
        with pytest.raises(PullError):
            await b.pulls.start_pull("/x", "rtsp://127.0.0.1:1/x")
        assert b.registry.find("/x") is takeover
    finally:
        await b.stop()


async def test_housekeeping_sweeps_a_dead_pull(tmp_path):
    b = await _dead_pull(tmp_path, "/gone")
    try:
        for _ in range(150):
            if not b.pulls.pulls:
                break
            await asyncio.sleep(0.02)
        assert not b.pulls.pulls and b.pulls.counts["swept"] == 1
    finally:
        await b.stop()


async def test_the_server_surface_through_two_cli_servers(tmp_path):
    players = [(("tunnel", "pull1"), ("tcp", "pull1"), ("udp", "pull2"),
                ("udp" if i % 2 == 0 else "tcp", "bcast"))[i % 4]
               for i in range(8)]
    res = await surface_loopback.serve_surface(
        "cpu", np.random.default_rng(18), str(tmp_path), players=players,
        gops=3, frames=6, packets_per_frame=4, body_len=(40, 200),
        frame_interval_s=0.02, mp3_frames=30, deadline_s=10)
    assert res["players"] == 8 and res["access_log_plays"] == 9
    assert res["icy"]["meta_blocks"] == 1 and res["per_ip"]["fourth"] \
        == "refused"
    assert set(res["first_join_ms"]) == {"tunnel", "tcp", "udp"}
    b = res["b_stats"]
    assert b["pump_errors"] == 0 and b["megabatch"]["mismatches"] == 0
    assert b["megabatch"]["window_calls"] > 0
    assert b["surface"]["broadcasts"]["opened"] == 1
    assert res["pull_first_packet_ms"] > 0 and res["pull_forward_us"] > 0
    json.dumps(res)
