"""HTTP on the port's RTSP port: RTSP-over-HTTP tunnels and icy MP3.

* the MP3 bitrate, the metadata block's padding, the ID3 titles, the icy
  bytes written for a file (with and without ``Icy-MetaData``) and the
  ``.m3u`` listing equal the reference's ``server.mp3`` on the same input;
* through ``python -m easydarwin_tpu_torch --device cpu``: tunneled
  players (their requests base64 in two pieces split inside a quad) play
  a pushed path with every packet held to the pushed one from byte 12
  (``utils.loopback.push_play``), beside interleaved and UDP players;
* in process: a POST whose GET half is not there answers 404; a GET of a
  path nothing serves answers 404 (no 501); closing the GET half tears
  the player down and gives both per-IP slots back; the icy stream and
  the playlist on the RTSP port.
"""

import asyncio
import base64

import numpy as np
import pytest

from easydarwin_tpu.server import mp3 as ref_mp3
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.server import mp3
from easydarwin_tpu_torch.utils import loopback, surface_loopback


def mp3_frames(bitrate_idx: int, n: int) -> bytes:
    hdr = bytes((0xFF, 0xFB, bitrate_idx << 4, 0x00))
    return (hdr + bytes(413)) * n


def id3(title: str, artist: str, ver: int = 3, enc: int = 0) -> bytes:
    def frame(fid, text):
        body = bytes((enc,)) + (text.encode("utf-16") if enc == 1
                                else text.encode("latin-1"))
        if ver >= 4:
            n = len(body)
            sz = bytes(((n >> 21) & 0x7F, (n >> 14) & 0x7F, (n >> 7) & 0x7F,
                        n & 0x7F))
        else:
            sz = len(body).to_bytes(4, "big")
        return fid + sz + b"\x00\x00" + body
    frames = frame(b"TIT2", title) + frame(b"TPE1", artist)
    n = len(frames)
    return b"ID3" + bytes((ver, 0, 0, (n >> 21) & 0x7F, (n >> 14) & 0x7F,
                           (n >> 7) & 0x7F, n & 0x7F)) + frames


@pytest.mark.parametrize("data", [
    mp3_frames(9, 3), mp3_frames(14, 3), mp3_frames(1, 2), b"\x00" * 100,
    b"\xff\xe3\x90\x00" + mp3_frames(5, 2), id3("a", "b") + mp3_frames(11, 2),
    bytes(range(256)) * 4])
def test_mp3_bitrate_equals_the_reference(data):
    assert mp3.parse_mp3_bitrate(data) == ref_mp3.parse_mp3_bitrate(data)


@pytest.mark.parametrize("title", ["", "a", "song", "x" * 3, "y" * 4,
                                   "Band - Song of sixteen", "z" * 200])
def test_meta_block_equals_the_reference(title):
    block = mp3.meta_block(title)
    assert block == ref_mp3._meta_block(title)
    assert block[0] * 16 == len(block) - 1 and (len(block) - 1) % 16 == 0


@pytest.mark.parametrize("data", [
    id3("Song", "Band", 3) + b"\xff\xfb\x90\x00", id3("Song", "Band", 4),
    id3("Solo", "", 3), id3("Ünïcode", "Bänd", 3, enc=1),
    b"\xff\xfb\x90\x00" + bytes(32), b"ID3", id3("T", "A")[:14]])
def test_id3_titles_equal_the_reference(data):
    assert mp3.parse_id3_title(data) == ref_mp3.parse_id3_title(data)


class _Sink:
    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b

    async def drain(self):
        pass


@pytest.mark.parametrize("meta", ["1", "0"])
async def test_icy_bytes_equal_the_reference(tmp_path, meta):
    rng = np.random.default_rng(7)
    (tmp_path / "s.mp3").write_bytes(surface_loopback.mp3_bytes(rng, 45))
    want, got = _Sink(), _Sink()
    await ref_mp3.Mp3Service(str(tmp_path)).stream(
        want, "/s.mp3", {"icy-metadata": meta}, pace=False)
    await mp3.Mp3Service(str(tmp_path)).stream(
        got, "/s.mp3", {"icy-metadata": meta}, pace=False)
    assert bytes(got.data) == bytes(want.data) and len(got.data) > 16384
    for svc in (ref_mp3.Mp3Service(str(tmp_path)),
                mp3.Mp3Service(str(tmp_path))):
        miss = _Sink()
        await svc.stream(miss, "/../s.mp3", {})
        assert bytes(miss.data) == b"HTTP/1.0 404 Not Found\r\n\r\n"


def test_playlist_equals_the_reference(tmp_path):
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "a.mp3").write_bytes(id3("Anthem", "Relays")
                                           + mp3_frames(9, 2))
    (tmp_path / "d" / "b.mp3").write_bytes(mp3_frames(9, 2))
    (tmp_path / "top.mp3").write_bytes(mp3_frames(9, 1))
    for path in ("/d.m3u", "/d", "/.m3u", "/../x.m3u", "/missing.m3u"):
        assert (mp3.Mp3Service(str(tmp_path)).playlist(path)
                == ref_mp3.Mp3Service(str(tmp_path)).playlist(path))
    text = mp3.Mp3Service(str(tmp_path)).playlist("/d.m3u")
    assert "#EXTINF:-1,Relays - Anthem\n/d/a.mp3" in text


async def test_tunneled_players_play_a_pushed_path_through_the_cli():
    res = await loopback.serve_and_check(
        "cpu", np.random.default_rng(18), n_push=1, n_play=4,
        transport=("tunnel", "tcp", "tunnel", "udp"), gops=3, frames=5,
        packets_per_frame=4, deadline_s=10)
    assert res["players"] == 4 and res["delivered"] > 0
    surface = res["server_stats"]["surface"]
    assert surface["tunnels"] == {"opened": 2, "orphan_posts": 0}
    assert res["server_stats"]["pump_errors"] == 0


async def _server(**kw):
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       bind_ip="127.0.0.1", **kw),
                          device="cpu")
    await app.start()
    return app


async def _http(port: int, request: bytes, timeout: float = 5.0) -> bytes:
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(request)
    data = await asyncio.wait_for(r.read(-1), timeout)
    w.close()
    return data


async def test_orphan_post_and_unserved_get_answer_404(tmp_path):
    app = await _server(movie_folder=str(tmp_path), log_folder=str(tmp_path))
    try:
        port = app.rtsp.port
        post = await _http(port, b"POST /x HTTP/1.0\r\nx-sessioncookie: "
                           b"nobody\r\nContent-Length: 32767\r\n\r\n"
                           + base64.b64encode(b"OPTIONS * RTSP/1.0\r\n"))
        assert post == b"HTTP/1.0 404 Not Found\r\n\r\n"
        for target in (b"/nothing", b"/nothing.mp3", b"/../etc/passwd.mp3"):
            got = await _http(port, b"GET " + target + b" HTTP/1.0\r\n\r\n")
            assert got == b"HTTP/1.0 404 Not Found\r\n\r\n", target
        # the stats page is served on the RTSP port
        got = await _http(port, b"GET /stats HTTP/1.0\r\n\r\n")
        assert got.startswith(b"HTTP/1.0 200 OK\r\n"), got[:40]
        # a GET split before its fourth byte is still HTTP
        r, w = await asyncio.open_connection("127.0.0.1", port)
        w.write(b"GE")
        await w.drain()
        await asyncio.sleep(0.05)
        w.write(b"T /none.mp3 HTTP/1.0\r\n\r\n")
        assert await asyncio.wait_for(r.read(-1), 5) \
            == b"HTTP/1.0 404 Not Found\r\n\r\n"
        w.close()
        assert app.rtsp.tunnel_counts["orphan_posts"] == 1
    finally:
        await app.stop()


async def test_tunnel_keeps_partial_quads_across_reads(tmp_path):
    """A POST body cut into 3-byte reads (never a whole quad) still runs
    every request, each answered on the GET half."""
    app = await _server(log_folder=str(tmp_path))
    try:
        port = app.rtsp.port
        gr, gw = await asyncio.open_connection("127.0.0.1", port)
        gw.write(b"GET /t HTTP/1.0\r\nx-sessioncookie: q\r\n\r\n")
        head = await asyncio.wait_for(gr.readuntil(b"\r\n\r\n"), 5)
        assert b"application/x-rtsp-tunnelled" in head
        pr, pw = await asyncio.open_connection("127.0.0.1", port)
        pw.write(b"POST /t HTTP/1.0\r\nx-sessioncookie: q\r\n"
                 b"Content-Length: 32767\r\n\r\n")
        reqs = b"".join(f"OPTIONS * RTSP/1.0\r\nCSeq: {n}\r\n\r\n".encode()
                        for n in (1, 2))
        b64 = base64.b64encode(reqs)
        for i in range(0, len(b64), 3):
            pw.write(b64[i:i + 3])
            await pw.drain()
            await asyncio.sleep(0.002)
        wire = loopback.rtsp.RtspWireReader(parse_responses=True)
        got = []
        while len(got) < 2:
            wire.feed(await asyncio.wait_for(gr.read(4096), 5))
            got += list(wire.events())
        assert [(r.status, r.headers["cseq"]) for r in got] == [
            (200, "1"), (200, "2")]
        assert "GET_PARAMETER" in got[0].headers["public"]
        pw.close()
        gw.close()
    finally:
        await app.stop()


async def test_tunnel_close_tears_down_and_frees_the_slots(tmp_path):
    app = await _server(max_connections_per_ip=2, log_folder=str(tmp_path))
    try:
        port = app.rtsp.port
        pusher = loopback.MiniClient()
        uri = f"rtsp://127.0.0.1:{port}/live/tun"
        await pusher.connect(port)
        await pusher.request("ANNOUNCE", uri,
                             {"content-type": "application/sdp"},
                             loopback.VIDEO_SDP.encode())
        player = loopback.TunnelClient(local_ip="127.0.0.5")
        await player.connect(port)
        await player.request("DESCRIBE", uri)
        await player.request("SETUP", uri + "/trackID=1", {
            "transport": "RTP/AVP/TCP;unicast;interleaved=0-1"})
        await player.request("PLAY", uri)
        assert app.rtsp._per_ip["127.0.0.5"] == 2
        stream = app.registry.find("/live/tun").streams[1]
        assert stream.num_outputs == 1
        # a third connection from the address is over the cap
        r, w = await asyncio.open_connection("127.0.0.1", port,
                                             local_addr=("127.0.0.5", 0))
        assert await asyncio.wait_for(r.read(100), 5) == b""
        w.close()
        await player.close()
        for _ in range(100):
            if "127.0.0.5" not in app.rtsp._per_ip:
                break
            await asyncio.sleep(0.02)
        assert "127.0.0.5" not in app.rtsp._per_ip
        assert stream.num_outputs == 0 and not app.rtsp.tunnels
        assert app.rtsp.per_ip_refused == 1
        await pusher.close()
    finally:
        await app.stop()


async def test_icy_stream_and_playlist_on_the_rtsp_port(tmp_path):
    rng = np.random.default_rng(3)
    song = surface_loopback.mp3_bytes(rng, 25)
    (tmp_path / "song.mp3").write_bytes(song)
    app = await _server(movie_folder=str(tmp_path), log_folder=str(tmp_path))
    try:
        data = await _http(app.rtsp.port, b"GET /song.mp3 HTTP/1.0\r\n"
                           b"Icy-MetaData: 1\r\n\r\n", timeout=10)
        head, body = data.split(b"\r\n\r\n", 1)
        assert head.startswith(b"ICY 200 OK") and b"icy-metaint:8192" in head
        audio, metas = surface_loopback.strip_icy(body, mp3.META_INT)
        assert audio == song
        assert metas == [b"StreamTitle='Loopback - Relay Song';"]
        pl = await _http(app.rtsp.port, b"GET /.m3u HTTP/1.0\r\n\r\n")
        assert b"audio/x-mpegurl" in pl
        assert b"#EXTINF:-1,Loopback - Relay Song\n/song.mp3" in pl
        assert app.mp3.streams_served == 1
        assert app.mp3.bytes_served == len(song)
    finally:
        await app.stop()
