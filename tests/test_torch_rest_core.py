"""The core REST commands, REST auth, the watchdog, and the whole server
surface through two CLI servers.

* after the same traffic (one pushed path, one player) the port's and the
  reference's servers answer ``getserverinfo``, ``getrtsplivesessions``,
  ``getbaseconfig``, ``setbaseconfig`` (a known key read back, an
  unknown one 400), ``getdevicestream`` / ``livedevicestream`` (a live
  device and an offline one), ``restart``, ``getpullrelays`` and an
  unknown command with the same status, message type, error and body
  keys, the shared values equal;
* with ``auth_enabled`` both answer alike: 401 without credentials and
  for a bad login, Basic for a read, 403 for a mutating call whose token
  is not in ``X-Token``, 200 with it, and 401 after ``logout``;
* ``restart`` under the watchdog (``-w``): the server exits with the
  restart code and comes back on new ports; SIGTERM to the watchdog stops
  both with 0; ``run_supervised`` gives the reference's exit codes.
"""

import asyncio
import re
import signal
import sys
from pathlib import Path

import pytest

from easydarwin_tpu.server import ServerConfig as RefConfig
from easydarwin_tpu.server import StreamingServer as RefServer
from easydarwin_tpu.server import supervisor as ref_supervisor
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.server import supervisor
from easydarwin_tpu_torch.utils import loopback
from easydarwin_tpu_torch.utils.surface_loopback import rest

ROOT = Path(__file__).resolve().parents[1]


async def _pair(tmp_path, **kw):
    """The reference's server and the port's, on the same config."""
    common = dict(rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
                  reflect_interval_ms=5, **kw)
    ref = RefServer(RefConfig(log_folder=str(tmp_path / "ref"),
                              movie_folder=str(tmp_path), **common))
    ours = StreamingServer(ServerConfig(log_folder=str(tmp_path / "ours"),
                                        movie_folder=str(tmp_path), **common),
                           device="cpu")
    await ref.start()
    await ours.start()
    return ref, ours


async def _traffic(port: int) -> list:
    pusher = loopback.MiniClient()
    await pusher.connect(port)
    uri = f"rtsp://127.0.0.1:{port}/live/cam"
    await pusher.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                         loopback.VIDEO_SDP.encode())
    await pusher.request("SETUP", uri + "/trackID=1", {
        "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"})
    await pusher.request("RECORD", uri)
    pusher.push(bytes((0x80, 96, 0, 1)) + bytes(8) + bytes((0x65,))
                + bytes(30))
    player = loopback.MiniClient()
    await player.connect(port)
    await player.request("DESCRIBE", uri)
    await player.request("SETUP", uri + "/trackID=1", {
        "transport": "RTP/AVP/TCP;unicast;interleaved=0-1"})
    await player.request("PLAY", uri)
    for _ in range(200):
        if player.frames:
            break
        await asyncio.sleep(0.01)
    return [pusher, player]


def _shape(status: int, doc: dict) -> tuple:
    hdr = doc["EasyDarwin"]["Header"]
    return (status, hdr["MessageType"], hdr["ErrorNum"], hdr["ErrorString"],
            sorted(doc["EasyDarwin"]["Body"]))


async def test_core_commands_answer_as_the_reference(tmp_path):
    ref, ours = await _pair(tmp_path)
    clients = []
    try:
        for app in (ref, ours):
            clients += await _traffic(app.rtsp.port)
        calls = [("getserverinfo", "", b""),
                 ("getrtsplivesessions", "", b""),
                 ("getbaseconfig", "", b""),
                 ("setbaseconfig", "",
                  b'{"Config": {"bucket_delay_ms": 60, "rtsp_timeout_sec": '
                  b'91}}'),
                 ("setbaseconfig", "", b'{"Config": {"no_such_key": 1}}'),
                 ("setbaseconfig", "", b"not json"),
                 ("getdevicestream", "device=cam", b""),
                 ("livedevicestream", "serial=live/cam", b""),
                 ("getdevicestream", "device=nobody", b""),
                 ("getdevicestream", "", b""),
                 ("getpullrelays", "", b""),
                 ("stoppullrelay", "path=/none", b""),
                 ("restart", "", b""),
                 ("nosuchcommand", "", b"")]
        for cmd, query, body in calls:
            got = [await rest(app.rest.port, cmd, query=query, body=body)
                   for app in (ref, ours)]
            assert _shape(*got[0]) == _shape(*got[1]), cmd
            bodies = [d["EasyDarwin"]["Body"] for _s, d in got]
            if cmd == "getrtsplivesessions":
                for b, app in zip(bodies, (ref, ours)):
                    s = b["Sessions"][0]
                    assert b["SessionCount"] == "1" and s["Path"] == \
                        "/live/cam" and s["Outputs"] == "1"
                    assert s["Url"] == (f"rtsp://127.0.0.1:{app.rtsp.port}"
                                        f"/live/cam")
                    assert sorted(s) == sorted(
                        bodies[0]["Sessions"][0])
                    assert sorted(s["Streams"]["1"]) == sorted(
                        bodies[0]["Sessions"][0]["Streams"]["1"])
            if cmd in ("getdevicestream", "livedevicestream") and "URL" in \
                    bodies[0]:
                for b, app in zip(bodies, (ref, ours)):
                    assert b["URL"] == (f"rtsp://127.0.0.1:{app.rtsp.port}"
                                        f"/live/cam")
        cfgs = [(await rest(app.rest.port, "getbaseconfig"))[1]
                ["EasyDarwin"]["Body"]["Config"] for app in (ref, ours)]
        assert "rest_password" not in cfgs[0] and "rest_password" \
            not in cfgs[1]
        shared = (set(cfgs[0]) & set(cfgs[1])) - {"log_folder"}
        assert {k for k in shared if cfgs[0][k] != cfgs[1][k]} == set()
        assert cfgs[1]["bucket_delay_ms"] == 60 == ours.config.stream \
            .bucket_delay_ms and cfgs[1]["rtsp_timeout_sec"] == 91
        assert ours.restart_event.is_set() and ref.restart_event.is_set()
        info = [(await rest(app.rest.port, "getserverinfo"))[1]
                ["EasyDarwin"]["Body"] for app in (ref, ours)]
        for k in ("ServerName", "Version", "PushSessions", "TpuFanout"):
            assert info[1][k] == info[0][k] or k == "TpuFanout", k
        assert int(info[1]["Requests"]) == int(info[0]["Requests"])
        assert info[1]["PacketsIn"] == info[0]["PacketsIn"] == "1"
    finally:
        for c in clients:
            await c.close()
        await ours.stop()
        await ref.stop()


async def test_rest_auth_answers_as_the_reference(tmp_path):
    ref, ours = await _pair(tmp_path, auth_enabled=True,
                            rest_username="op", rest_password="pw")
    try:
        basic = ("op", "pw")
        tokens = []
        for app in (ref, ours):
            st, doc = await rest(app.rest.port, "login",
                                 query="username=op&password=pw")
            tokens.append(doc["EasyDarwin"]["Body"]["Token"])
        cases = [
            ("getserverinfo", {}, ""),                        # 401
            ("login", {}, "username=op&password=no"),         # 401
            ("getserverinfo", {"basic": basic}, ""),          # 200
            ("getserverinfo", {"basic": ("op", "no")}, ""),   # 401
            ("setbaseconfig", {"basic": basic}, ""),          # 403
            ("setbaseconfig", {}, "token={t}"),               # 403
            ("setbaseconfig", {"token": True}, ""),           # 200
            ("getrtsplivesessions", {}, "token={t}"),         # 200
            ("logout", {"token": True}, ""),                  # 200
            ("getserverinfo", {"token": True}, ""),           # 401
        ]
        for cmd, kw, query in cases:
            shapes = []
            for app, tok in zip((ref, ours), tokens):
                st, doc = await rest(
                    app.rest.port, cmd, tok if kw.get("token") else None,
                    query=query.format(t=tok), basic=kw.get("basic"))
                shapes.append(_shape(st, doc))
            assert shapes[0] == shapes[1], (cmd, kw, query, shapes)
        assert ours.rest.refused == {"401": 4, "403": 2}
    finally:
        await ours.stop()
        await ref.stop()


@pytest.mark.parametrize("codes,want", [
    ([supervisor.EXIT_RESTART, supervisor.EXIT_RESTART, 0], 0),
    ([1] * supervisor.MAX_CRASHES, 1), ([7], 7)])
def test_run_supervised_exits_as_the_reference(codes, want):
    results = []
    for mod in (ref_supervisor, supervisor):
        seq = iter(codes)
        results.append(mod.run_supervised(
            ["child"], spawn=lambda argv: next(seq), sleep=lambda s: None,
            log=lambda m: None, auto_restart=codes != [7]))
    assert results == [want, want]


async def test_restart_under_the_watchdog(tmp_path):
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "easydarwin_tpu_torch", "-w", "--device",
        "cpu", "-p", "0", "--service-port", "0", "--bind-ip", "127.0.0.1",
        "--movie-folder", str(tmp_path), cwd=ROOT,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
    try:
        async def listening() -> int:
            while True:
                line = (await asyncio.wait_for(proc.stdout.readline(),
                                               60)).decode()
                assert line, "the watchdog's child exited"
                m = re.search(r"listening: .* service http://[\d.]+:(\d+)",
                              line)
                if m:
                    return int(m.group(1))
        first = await listening()
        st, doc = await rest(first, "restart")
        assert st == 200 and doc["EasyDarwin"]["Body"] == {"Restarting": "1"}
        second = await listening()
        st, _ = await rest(second, "getserverinfo")
        assert st == 200
        proc.send_signal(signal.SIGTERM)
        _out, err = await asyncio.wait_for(proc.communicate(), 60)
        assert proc.returncode == 0, err.decode()
        assert b"restart requested" in err
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
