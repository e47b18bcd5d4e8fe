"""``.sdp`` broadcasts on the port, held against the reference's
``relay.source``.

* the multicast test, the media-level ``c=`` override, the ``.sdp`` file
  lookup (traversal refused) and the sanitized client-facing SDP equal
  the reference's on the same files;
* in process (``device="cpu"``): a unicast broadcast through the port's
  server, every packet a player gets equal to the datagram sent from
  byte 12; a live pushed session wins over an ``.sdp`` of the same path;
  ``open`` is idempotent and safe under concurrent opens; a viewerless
  broadcast is swept after its idle time (the server's housekeeping
  too); a session a pusher took over survives the source's teardown;
  multicast on loopback (skipped with a reason where the host refuses
  the join or does not route the group).
"""

import asyncio
import socket
import time

import pytest

from easydarwin_tpu.protocol import sdp as ref_sdp
from easydarwin_tpu.relay import source as ref_source
from easydarwin_tpu.relay.session import SessionRegistry as RefRegistry
from easydarwin_tpu_torch.protocol import rtp, sdp
from easydarwin_tpu_torch.relay import source
from easydarwin_tpu_torch.relay.session import SessionRegistry
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.utils import loopback, synth
from easydarwin_tpu_torch.utils.client import RtspClient
from easydarwin_tpu_torch.utils.surface_loopback import free_udp_pair


def broadcast_sdp(port: int, dest: str = "127.0.0.1",
                  media_c: str | None = None) -> str:
    return ("v=0\r\no=- 7 7 IN IP4 192.0.2.1\r\ns=bcast\r\n"
            f"c=IN IP4 {dest}\r\nt=0 0\r\na=tool:x\r\n"
            f"m=video {port} RTP/AVP 96\r\n"
            + (f"c=IN IP4 {media_c}\r\n" if media_c else "")
            + "a=rtpmap:96 H264/90000\r\na=fmtp:96 packetization-mode=1\r\n"
            "a=control:trackID=1\r\n"
            f"m=audio {port + 2} RTP/AVP 0\r\na=control:trackID=2\r\n")


@pytest.mark.parametrize("addr", ["239.255.0.1", "224.0.0.1", "127.0.0.1",
                                  "ff02::1", "not-an-ip", ""])
def test_is_multicast_equals_the_reference(addr):
    assert source._is_multicast(addr) == ref_source._is_multicast(addr)


@pytest.mark.parametrize("media_c", [None, "239.1.2.3/127", "10.9.9.9"])
def test_dest_address_and_client_sdp_equal_the_reference(media_c):
    text = broadcast_sdp(5004, "10.0.0.1", media_c)
    ours, ref = sdp.parse(text), ref_sdp.parse(text)
    for a, b in zip(ours.streams, ref.streams):
        assert a.dest_address(ours.connection) \
            == b.dest_address(ref.connection)
    assert source.client_facing(sdp.parse(text)) \
        == ref_source._client_facing(ref_sdp.parse(text))


async def test_lookup_and_describe_equal_the_reference(tmp_path):
    (tmp_path / "live").mkdir()
    (tmp_path / "live" / "cam.sdp").write_text(broadcast_sdp(5004,
                                                             "239.9.9.9"))
    (tmp_path / "top.sdp").write_text(broadcast_sdp(6004))
    ours = source.SdpFileRelaySource(str(tmp_path), SessionRegistry())
    ref = ref_source.SdpFileRelaySource(str(tmp_path), RefRegistry())
    for path in ("/live/cam", "/live/cam.sdp", "/live/other", "/top",
                 "/../etc/passwd", "/", "", "/live/../top",
                 "/live/../../x"):
        assert ours.sdp_file_for(path) == ref.sdp_file_for(path), path
        assert await ours.describe(path) == await ref.describe(path), path
    text = await ours.describe("/live/cam")
    assert "239.9.9.9" not in text and sdp.parse(text).streams[0].port == 0


async def _server(tmp_path, **kw):
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        reflect_interval_ms=5, movie_folder=str(tmp_path),
        log_folder=str(tmp_path), **kw), device="cpu")
    await app.start()
    return app


async def test_unicast_broadcast_end_to_end(tmp_path):
    port = free_udp_pair()
    (tmp_path / "bcast1.sdp").write_text(broadcast_sdp(port))
    app = await _server(tmp_path)
    try:
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/bcast1"
        player = RtspClient()
        await player.connect("127.0.0.1", app.rtsp.port)
        sd = await player.play_start(uri)
        assert [s.codec for s in sd.streams] == ["H264", "PCMU"]
        assert "/bcast1" in app.relay_source.sources
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sent = [synth.h264_packet(700 + i, 3000 * i, 5 if i == 0 else 1,
                                  ssrc=0xBCA5, body=bytes(range(i, i + 40)))
                for i in range(6)]
        for p in sent:
            tx.sendto(p, ("127.0.0.1", port))
            await asyncio.sleep(0.01)
        got = [await player.recv_interleaved(0) for _ in sent]
        seq0 = rtp.peek_seq(got[0])
        for i, (g, s) in enumerate(zip(got, sent)):
            assert g[12:] == s[12:] and rtp.peek_seq(g) == (seq0 + i) & 0xFFFF
        tx.close()
        await player.teardown(uri)
        await player.close()
        assert app.relay_source.counts["datagrams"] == len(sent)
    finally:
        await app.stop()
    assert app.relay_source.counts["closed"] == 1


async def test_live_session_wins_over_an_sdp_file(tmp_path):
    (tmp_path / "cam9.sdp").write_text(broadcast_sdp(5004, "239.9.9.9"))
    app = await _server(tmp_path)
    try:
        c = loopback.MiniClient()
        await c.connect(app.rtsp.port)
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/cam9"
        await c.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                        loopback.VIDEO_SDP.encode())
        assert await app.rtsp.describe("/cam9") == loopback.VIDEO_SDP
        assert await app.rtsp.open_for_play("/cam9") \
            is app.registry.find("/cam9")
        assert not app.relay_source.sources
        await c.close()
    finally:
        await app.stop()


async def test_open_is_idempotent_and_concurrency_safe(tmp_path):
    port = free_udp_pair()
    (tmp_path / "c.sdp").write_text(broadcast_sdp(port))
    reg = SessionRegistry()
    svc = source.SdpFileRelaySource(str(tmp_path), reg)
    r = await asyncio.gather(*(svc.open("/c") for _ in range(8)))
    assert all(x is r[0] for x in r) and len(svc.sources) == 1
    assert len(svc.sources["/c"].transports) == 4     # 2 tracks × RTP, RTCP
    assert await svc.open("/c.sdp") is r[0]
    cached = reg.sdp_cache.get("/c")
    assert f" {port} " not in cached and "IN IP4 127.0.0.1" not in cached
    assert r[0].description.connection.endswith("127.0.0.1")
    svc.close_all()
    assert reg.find("/c") is None and svc.counts["opened"] == 1


async def test_viewerless_broadcast_is_swept(tmp_path):
    port = free_udp_pair()
    (tmp_path / "x.sdp").write_text(broadcast_sdp(port))
    reg = SessionRegistry()
    svc = source.SdpFileRelaySource(str(tmp_path), reg, idle_timeout=10.0)
    assert await svc.open("/x") is not None
    t0 = time.monotonic()
    assert svc.sweep(t0) == 0
    assert svc.sweep(t0 + 9.0) == 0
    assert svc.sweep(t0 + 11.0) == 1
    assert reg.find("/x") is None and not svc.sources
    # the server's housekeeping sweeps one too
    (tmp_path / "y.sdp").write_text(broadcast_sdp(free_udp_pair()))
    app = await _server(tmp_path)
    app.relay_source.idle_timeout = 0.5
    try:
        assert await app.rtsp.open_for_play("/y") is not None
        for _ in range(150):
            if not app.relay_source.sources:
                break
            await asyncio.sleep(0.02)
        assert not app.relay_source.sources and app.registry.find("/y") \
            is None
    finally:
        await app.stop()


async def test_taken_over_session_survives_the_teardown(tmp_path):
    port = free_udp_pair()
    (tmp_path / "a.sdp").write_text(broadcast_sdp(port))
    reg = SessionRegistry()
    svc = source.SdpFileRelaySource(str(tmp_path), reg)
    sess = await svc.open("/a")
    assert sess.owner is svc
    sess.owner = object()                   # a pusher's ANNOUNCE took it
    svc.close_source("/a")
    assert reg.find("/a") is sess and "/a" not in svc.sources
    assert await svc.open("/a") is sess and "/a" not in svc.sources


async def test_multicast_on_loopback(tmp_path):
    group, port = "239.255.97.42", free_udp_pair()
    (tmp_path / "m.sdp").write_text(broadcast_sdp(port, group))
    reg = SessionRegistry()
    svc = source.SdpFileRelaySource(str(tmp_path), reg)
    sess = await svc.open("/m")
    if sess is None:
        pytest.skip("this host refuses the multicast join")
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_IF,
                      socket.inet_aton("127.0.0.1"))
        tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        for i in range(3):
            tx.sendto(synth.h264_packet(10 + i, 0, 5, ssrc=1,
                                        body=bytes(20)), (group, port))
            await asyncio.sleep(0.02)
    except OSError as e:
        pytest.skip(f"this host refuses the multicast send: {e}")
    finally:
        tx.close()
    await asyncio.sleep(0.1)
    if sess.streams[1].stats.packets_in == 0:
        pytest.skip("this host does not route multicast on loopback")
    assert sess.streams[1].stats.packets_in == 3
    svc.close_all()
