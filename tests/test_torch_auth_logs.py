"""RTSP auth, the per-IP cap and the rolling logs, held against the
reference's ``server.auth`` and ``utils.logs``.

* ``ha1``, ``digest_response``, the users file, the longest-prefix rule
  lookup and the Basic and Digest verdicts (nonce and clock pinned, nonce
  expiry included) equal the reference's on the same inputs;
* the W3C access line, the error log's level filter and the rolling
  log's files equal the reference's (clock pinned); the User-Agent
  columns parse as the reference's ``parse_user_agent``;
* in process on the port's server: Digest-protected playback (401 with
  ``WWW-Authenticate``, then the answer to the challenge, with the
  request's URI as ``uri``), Basic, an open path beside a protected one,
  the access log's line for a closed player and pusher, and the per-IP
  cap refusing past ``max_connections_per_ip`` and giving the slot back
  on close.
"""

import asyncio
import base64
import os
import time

import pytest

from easydarwin_tpu.server import auth as ref_auth
from easydarwin_tpu.utils import http_misc as ref_http
from easydarwin_tpu.utils import logs as ref_logs
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer, auth
from easydarwin_tpu_torch.utils import http_misc, logs, loopback

NONCE = "0123456789abcdef0123456789abcdef"


@pytest.fixture
def pinned(monkeypatch):
    """Both modules' nonces and clocks pinned (they share ``secrets`` and
    ``time``)."""
    now = [1_700_000_000.0]
    monkeypatch.setattr(ref_auth.secrets, "token_hex", lambda n=16: NONCE)
    monkeypatch.setattr(ref_auth.time, "time", lambda: now[0])
    return now


def services(scheme):
    out = []
    for mod in (ref_auth, auth):
        users = mod.UsersFile(realm="testrealm")
        users.add("alice", "secret")
        users.add("bob", "hunter2")
        rules = mod.AccessRules()
        rules.protect("/private", ["alice"])
        rules.protect("/members")
        rules.open_path("/members/open")
        out.append(mod.AuthService(users, rules, scheme=scheme))
    return out


@pytest.mark.parametrize("user,realm,pw", [("a", "r", "p"),
                                           ("viewer", "easydarwin-tpu", ""),
                                           ("ü", "real:m", "p:w")])
def test_ha1_and_digest_response_equal_the_reference(user, realm, pw):
    assert auth.ha1(user, realm, pw) == ref_auth.ha1(user, realm, pw)
    for uri in ("rtsp://h:554/live/x", "rtsp://h/x/trackID=1", "*"):
        assert (auth.digest_response(user, pw, realm, "SETUP", uri, NONCE)
                == ref_auth.digest_response(user, pw, realm, "SETUP", uri,
                                            NONCE))


def test_users_file_equals_the_reference(tmp_path):
    p = tmp_path / "users"
    p.write_text(f"# comment\n\nalice:testrealm:{auth.ha1('alice', 'testrealm', 'pw')}\n"
                 "bad line\nbob:other:00\n")
    ours, ref = auth.UsersFile(str(p)), ref_auth.UsersFile(str(p))
    assert (ours.users, ours.realm) == (ref.users, ref.realm)
    for user, pw in (("alice", "pw"), ("alice", "x"), ("ghost", "pw")):
        assert ours.check_password(user, pw) == ref.check_password(user, pw)


@pytest.mark.parametrize("path", ["/", "/open/x", "/private", "/private/cam",
                                  "/privateer", "/members/x",
                                  "/members/open/y", "/members"])
def test_rule_lookup_equals_the_reference(path):
    ours, ref = services("digest")
    assert ours.rules.required_users(path) == ref.rules.required_users(path)


@pytest.mark.parametrize("creds", [None, ("bob", "hunter2"),
                                   ("alice", "secret"), ("bob", "wrong"),
                                   ("ghost", "x")])
def test_basic_verdicts_equal_the_reference(creds):
    ours, ref = services("basic")
    assert ours.challenge() == ref.challenge()
    hdr = None if creds is None else "Basic " + base64.b64encode(
        f"{creds[0]}:{creds[1]}".encode()).decode()
    for path in ("/open", "/members/s", "/private/cam", "/members/open/z"):
        assert (ours.authorize(path, "DESCRIBE", hdr)
                == ref.authorize(path, "DESCRIBE", hdr))
    assert ours.authorize("/members/s", "PLAY", "Basic !!!") \
        == ref.authorize("/members/s", "PLAY", "Basic !!!")


def test_digest_verdicts_and_nonce_expiry_equal_the_reference(pinned):
    ours, ref = services("digest")
    assert ours.challenge() == ref.challenge()
    uri = "rtsp://127.0.0.1:554/private/cam"
    cases = [
        auth.digest_response("alice", "secret", "testrealm", "DESCRIBE",
                             uri, NONCE),
        auth.digest_response("alice", "wrong", "testrealm", "DESCRIBE",
                             uri, NONCE),
        auth.digest_response("bob", "hunter2", "testrealm", "DESCRIBE",
                             uri, NONCE),
        # the response computed over the path, not the request's URI: the
        # server hashes the header's uri with the method, so it still holds
        auth.digest_response("alice", "secret", "testrealm", "DESCRIBE",
                             "/private/cam", NONCE),
        auth.digest_response("alice", "secret", "testrealm", "DESCRIBE",
                             uri, "deadbeef"),
        auth.digest_response("alice", "secret", "testrealm", "SETUP",
                             uri, NONCE),
        "Digest garbage", None]
    for hdr in cases:
        for method in ("DESCRIBE", "SETUP"):
            assert (ours.authorize("/private/cam", method, hdr)
                    == ref.authorize("/private/cam", method, hdr)), hdr
    assert ours.authorize("/private/cam", "DESCRIBE", cases[0]) \
        == (True, "alice")
    pinned[0] += auth.AuthService.NONCE_TTL + 1     # the nonce expires
    assert (ours.authorize("/private/cam", "DESCRIBE", cases[0])
            == ref.authorize("/private/cam", "DESCRIBE", cases[0])
            == (False, None))


@pytest.mark.parametrize("ua", [
    "QTS (qtid=12;qtver=7.6;lang=en;os=Mac%20OS%20X;osver=10.4;cpu=ppc)",
    "QTS (os=(Windows NT);qtid=1;qtid=2)", "VLC/3.0.18 LibVLC/3.0.18",
    "", "(cpu=x86_64; bogus; osver=\"11\")"])
def test_user_agent_parse_equals_the_reference(ua):
    assert http_misc.parse_user_agent(ua) == ref_http.parse_user_agent(ua)


def test_w3c_lines_equal_the_reference(tmp_path, monkeypatch):
    fixed = time.gmtime(1_700_000_000)
    monkeypatch.setattr(ref_logs.time, "gmtime", lambda *a: fixed)
    recs = [dict(client_ip="10.1.2.3", uri="rtsp://h/live/cam",
                 method="PLAY", duration_sec=12.5, bytes_sent=1000,
                 packets_sent=42, user_agent="QTS (qtid=9;os=Linux)",
                 transport="UDP"),
            dict(client_ip="::1", uri="/x", method="RECORD", status=200,
                 duration_sec=0.04, user_agent="", transport="TCP"),
            dict()]
    ours = logs.AccessLog(str(tmp_path / "ours.log"))
    ref = ref_logs.AccessLog(str(tmp_path / "ref.log"))
    for r in recs:
        ours.record(logs.AccessRecord(**r))
        ref.record(ref_logs.AccessRecord(**r))
    ours.log.close()
    ref.log.close()
    assert ((tmp_path / "ours.log").read_text()
            == (tmp_path / "ref.log").read_text())
    assert ours.log.stats() == {"lines": 6, "rolls": 0}


@pytest.mark.parametrize("verbosity", ["fatal", "warning", "info", "debug",
                                       "bogus"])
def test_error_log_levels_equal_the_reference(tmp_path, verbosity):
    files = []
    for mod, name in ((logs, "ours"), (ref_logs, "ref")):
        log = mod.ErrorLog(str(tmp_path / f"{name}.log"), verbosity=verbosity)
        for level in ("fatal", "warning", "info", "debug"):
            log.write(level, f"{level} message")
        log.log.close()
        text = (tmp_path / f"{name}.log").read_text() \
            if (tmp_path / f"{name}.log").exists() else ""
        files.append([ln[20:] for ln in text.splitlines()])  # no timestamp
    assert files[0] == files[1]


def test_rolling_log_rolls_as_the_reference(tmp_path):
    for mod, name in ((logs, "ours"), (ref_logs, "ref")):
        d = tmp_path / name
        log = mod.RollingLog(str(d / "x.log"), max_bytes=100, keep=3)
        for i in range(30):
            log.write_line(f"{i:02d}" + "x" * 18)
        log.close()
    for name in sorted(os.listdir(tmp_path / "ref")):
        assert ((tmp_path / "ours" / name).read_text()
                == (tmp_path / "ref" / name).read_text())
    assert sorted(os.listdir(tmp_path / "ours")) \
        == sorted(os.listdir(tmp_path / "ref"))


async def _server(tmp_path, **kw):
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        reflect_interval_ms=5, log_folder=str(tmp_path), **kw), device="cpu")
    await app.start()
    return app


async def _push(port: int, path: str, creds=None) -> loopback.MiniClient:
    c = loopback.MiniClient(credentials=creds)
    await c.connect(port)
    uri = f"rtsp://127.0.0.1:{port}{path}"
    await c.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                    loopback.VIDEO_SDP.encode())
    await c.request("SETUP", uri + "/trackID=1", {
        "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"})
    await c.request("RECORD", uri)
    return c


async def _play(port: int, path: str, creds=None) -> loopback.MiniClient:
    p = loopback.MiniClient(credentials=creds)
    await p.connect(port)
    uri = f"rtsp://127.0.0.1:{port}{path}"
    await p.request("DESCRIBE", uri)
    await p.request("SETUP", uri + "/trackID=1", {
        "transport": "RTP/AVP/TCP;unicast;interleaved=0-1",
        "user-agent": "QTS (qtid=5;qtver=7.7;os=Linux)"})
    await p.request("PLAY", uri)
    return p


@pytest.mark.parametrize("scheme", ["digest", "basic"])
async def test_protected_playback_and_the_access_log(tmp_path, scheme):
    users = tmp_path / "users"
    users.write_text(f"viewer:easydarwin-tpu:"
                     f"{auth.ha1('viewer', 'easydarwin-tpu', 'pw')}\n")
    app = await _server(tmp_path, rtsp_auth_enabled=True,
                        users_file=str(users), auth_scheme=scheme)
    try:
        port = app.rtsp.port
        # every path needs a valid user, as the reference's "/" rule
        bare_pusher = loopback.MiniClient()
        await bare_pusher.connect(port)
        with pytest.raises(AssertionError, match="401"):
            await bare_pusher.request(
                "ANNOUNCE", f"rtsp://127.0.0.1:{port}/open/cam",
                {"content-type": "application/sdp"},
                loopback.VIDEO_SDP.encode())
        await bare_pusher.close()
        pusher = await _push(port, "/secure/cam", ("viewer", "pw"))
        uri = f"rtsp://127.0.0.1:{port}/secure/cam"
        bare = loopback.MiniClient()
        await bare.connect(port)
        with pytest.raises(AssertionError, match="401"):
            await bare.request("DESCRIBE", uri)
        await bare.close()
        player = await _play(port, "/secure/cam", ("viewer", "pw"))
        assert player.challenges == 1 and player.digest == (
            ("easydarwin-tpu", player.digest[1]) if scheme == "digest"
            else ("basic", None))
        wrong = loopback.MiniClient(credentials=("viewer", "nope"))
        await wrong.connect(port)
        with pytest.raises(AssertionError, match="401"):
            await wrong.request("DESCRIBE", uri)
        await wrong.close()
        pusher.push(bytes((0x80, 96, 0, 1)) + bytes(8) + bytes((0x65,))
                    + bytes(40))
        for _ in range(100):
            if player.frames:
                break
            await asyncio.sleep(0.02)
        assert player.frames
        await player.close()
        await pusher.close()
        await asyncio.sleep(0.1)
        assert app.rtsp.auth_refused >= 3
    finally:
        await app.stop()
    lines = [ln.split() for ln in (tmp_path / "access.log").read_text()
             .splitlines() if not ln.startswith("#")]
    secure = [ln for ln in lines if ln[3] == uri and ln[4] == "PLAY"]
    assert len(secure) == 1 and int(secure[0][8]) >= 1
    assert secure[0][11] == "TCP"
    assert any(ln[4] == "RECORD" and ln[3].endswith("/secure/cam")
               for ln in lines)


async def test_per_ip_cap_refuses_and_gives_slots_back(tmp_path):
    app = await _server(tmp_path, max_connections_per_ip=2)
    try:
        port = app.rtsp.port
        held = []
        for _ in range(2):
            c = loopback.MiniClient(local_ip="127.0.0.7")
            await c.connect(port)
            await c.request("OPTIONS", "*")
            held.append(c)
        r, w = await asyncio.open_connection("127.0.0.1", port,
                                             local_addr=("127.0.0.7", 0))
        assert await asyncio.wait_for(r.read(64), 5) == b""
        w.close()
        other = loopback.MiniClient(local_ip="127.0.0.8")
        await other.connect(port)
        await other.request("OPTIONS", "*")      # another address is free
        await held[0].close()
        for _ in range(100):
            if app.rtsp._per_ip.get("127.0.0.7") == 1:
                break
            await asyncio.sleep(0.02)
        again = loopback.MiniClient(local_ip="127.0.0.7")
        await again.connect(port)
        await again.request("OPTIONS", "*")
        assert app.rtsp.per_ip_refused == 1
        for c in (held[1], other, again):
            await c.close()
    finally:
        await app.stop()
    assert app.rtsp._per_ip == {}
