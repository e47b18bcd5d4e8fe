"""The reference's server surface end to end, over loopback: two CLI
servers, a pull chain, an ``.sdp`` broadcast, tunnels, Digest, REST,
the per-IP cap, icy MP3 and the access log.

``serve_surface(device, rng, folder)`` writes origin A's config as TOML
(``max_connections_per_ip = 3``) and edge B's as the reference's
``easydarwin.xml`` (Digest on every path with a users file, the access
log), a ``bcast.sdp`` naming a UDP port and a ``song.mp3`` under B's
movie folder, and starts both with ``-c``; B's keys that no XML pref
carries (REST auth, its user, the log folder) go as flags.  Two
pushers (from 127.0.0.2) send paced H.264 GOPs to A's ``/cam1`` and
``/cam2``; B logs in over REST and ``startpullrelay``s them into
``/pull1`` and ``/pull2`` with ``X-Token``; a UDP feeder sends a third
source to the broadcast's port, which B opens at the first SETUP of
``/bcast``.  Players join B one a frame, each of a kind of
``players`` (``tunnel``, ``tcp`` or ``udp``, on ``pull1``, ``pull2`` or
``bcast``); each answers the Digest challenge.

It holds every player to its source as ``loopback.push_play`` does: the
first packet a GOP head near its join (a pulled path lags its origin, so
one GOP either side of the heads pushed while PLAY was in flight), then
every later packet pushed, equal from byte 12 (and bytes 0-1), its seq
contiguous from the RTP-Info seq, its timestamp offset by the RTP-Info
rtptime, its SSRC the SETUP reply's.  It also checks the REST envelope
of each core command (message type, error, body keys), a mutating call
without ``X-Token`` (403), a bad login (401), ``getbaseconfig`` without
``rest_password``, a ``setbaseconfig`` read back, the live sessions
listed, A refusing a fourth connection from one address, the icy stream
equal to the file between its metadata blocks, and a W3C line in B's
access log for each closed player.  Any failure raises
``AssertionError``.  Returns the figures: B's exit stats (with its
kernel launches), each kind's first join, the pull's first packet after
``startpullrelay`` and its host µs a forwarded packet.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import re
import socket
import time
from urllib.parse import quote

import numpy as np

from ..protocol import rtp, rtsp
from . import synth
from .loopback import (VIDEO_SDP, CliServer, MiniClient, TunnelClient,
                       check, gop_heads)

#: B's REST and RTSP credentials
REST_USER, REST_PASSWORD = "operator", "s3cret"
VIEWER, VIEWER_PASSWORD, REALM = "viewer", "pw-viewer", "easydarwin-tpu"
#: 7b's 64 players as the phase mixes them: 16 tunneled and 16 TCP on
#: /pull1, 16 UDP on /pull2, 8 UDP and 8 TCP on /bcast, in join order
PHASE_PLAYERS = [
    (("tunnel", "pull1"), ("tcp", "pull1"), ("udp", "pull2"),
     ("udp" if i % 2 == 0 else "tcp", "bcast"))[i % 4]
    for i in range(4 * 16)]
#: the message type each core command answers with, and its body keys
ENVELOPES = {
    "login": (0x0020, {"Token"}),
    "getserverinfo": (0x0020, {
        "ServerName", "Version", "UpTimeSec", "RTSPPort", "ServicePort",
        "Connections", "PushSessions", "Requests", "PacketsIn",
        "PacketsOut", "InRatePps", "OutRatePps", "IngestToWireP99Ms",
        "TpuFanout", "LedgerTopWaitClass", "LedgerLastWakeMs"}),
    "getrtsplivesessions": (0x0021, {"SessionCount", "Sessions"}),
    "getbaseconfig": (0x0022, {"Config"}),
    "setbaseconfig": (0x0022, set()),
    "getdevicestream": (0x000C, {"URL"}),
    "livedevicestream": (0x000C, {"URL"}),
    "startpullrelay": (0x0020, {"Pull", "Url"}),
    "getpullrelays": (0x0020, {"Pulls"}),
    "stoppullrelay": (0x0020, {"Pull", "Packets"}),
    "logout": (0x0020, set()),
}


def mp3_bytes(rng: np.random.Generator, frames: int) -> bytes:
    """An ID3v2.3 tag (TIT2 "Relay Song", TPE1 "Loopback") and ``frames``
    MPEG1 Layer III frames at 128 kbps, 44.1 kHz (417 bytes each) with
    seeded bodies."""
    def frame(fid: bytes, text: str) -> bytes:
        body = b"\x00" + text.encode("latin-1")
        return fid + len(body).to_bytes(4, "big") + b"\x00\x00" + body
    tag = frame(b"TIT2", "Relay Song") + frame(b"TPE1", "Loopback")
    n = len(tag)
    head = b"ID3" + bytes((3, 0, 0, (n >> 21) & 0x7F, (n >> 14) & 0x7F,
                           (n >> 7) & 0x7F, n & 0x7F))
    body = rng.integers(0, 0xFF, size=(frames, 413), dtype=np.uint8)
    return head + tag + b"".join(b"\xff\xfb\x90\x00" + r.tobytes()
                                 for r in body)


def strip_icy(data: bytes, metaint: int) -> tuple[bytes, list[bytes]]:
    """An icy body → (its audio bytes, its metadata blocks' text)."""
    audio, metas, pos = bytearray(), [], 0
    while pos < len(data):
        audio += data[pos:pos + metaint]
        pos += metaint
        if pos >= len(data):
            break
        n = data[pos] * 16
        metas.append(data[pos + 1:pos + 1 + n].rstrip(b"\x00"))
        pos += 1 + n
    return bytes(audio), metas


def free_udp_pair() -> int:
    """An even port whose odd neighbour is free too (a broadcast's RTP and
    RTCP)."""
    for _ in range(64):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as a:
            a.bind(("127.0.0.1", 0))
            port = a.getsockname()[1] & ~1
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as a, \
                    socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as b:
                a.bind(("0.0.0.0", port))
                b.bind(("0.0.0.0", port + 1))
            return port
        except OSError:
            continue
    raise OSError("no free UDP port pair")


def write_configs(folder: str, rng: np.random.Generator, bcast_port: int,
                  mp3_frames: int) -> dict:
    """A's TOML, B's XML, B's users file, ``bcast.sdp`` and ``song.mp3``
    under ``folder``; returns their paths and the song's bytes."""
    a_dir, b_dir = (os.path.join(folder, n) for n in ("a", "b"))
    b_movies = os.path.join(b_dir, "movies")
    for d in (a_dir, b_movies):
        os.makedirs(d, exist_ok=True)
    a_toml = os.path.join(a_dir, "a.toml")
    with open(a_toml, "w") as f:
        f.write(f'max_connections_per_ip = 3\n'
                f'movie_folder = "{os.path.join(a_dir, "movies")}"\n'
                f'log_folder = "{os.path.join(a_dir, "logs")}"\n'
                f'slo_enabled = true\n')
    users = os.path.join(b_dir, "users")
    from hashlib import md5
    with open(users, "w") as f:
        f.write(f"{VIEWER}:{REALM}:"
                f"{md5(f'{VIEWER}:{REALM}:{VIEWER_PASSWORD}'.encode()).hexdigest()}\n")
    b_xml = os.path.join(b_dir, "easydarwin.xml")
    with open(b_xml, "w") as f:
        f.write(f"""<?xml version ="1.0"?>
<CONFIGURATION>
  <SERVER>
    <PREF NAME="movie_folder" >{b_movies}</PREF>
    <PREF NAME="authentication_scheme" >digest</PREF>
    <PREF NAME="rtsp_session_timeout" TYPE="UInt32" >90</PREF>
    <PREF NAME="service_wan_ip" >127.0.0.1</PREF>
    <PREF NAME="run_num_threads" TYPE="UInt32" >4</PREF>
  </SERVER>
  <MODULE NAME="QTSSAccessModule" >
    <PREF NAME="modAccess_enabled" TYPE="bool" >true</PREF>
    <PREF NAME="modAccess_usersfilepath" >{users}</PREF>
  </MODULE>
  <MODULE NAME="QTSSAccessLogModule" >
    <PREF NAME="request_logging" TYPE="bool" >true</PREF>
  </MODULE>
  <MODULE NAME="QTSSReflectorModule" >
    <PREF NAME="reflector_bucket_offset_delay_msec" TYPE="UInt32" >73</PREF>
  </MODULE>
</CONFIGURATION>
""")
    with open(os.path.join(b_movies, "bcast.sdp"), "w") as f:
        f.write("v=0\r\no=- 7 7 IN IP4 127.0.0.1\r\ns=bcast\r\n"
                "c=IN IP4 127.0.0.1\r\nt=0 0\r\n"
                f"m=video {bcast_port} RTP/AVP 96\r\n"
                "a=rtpmap:96 H264/90000\r\na=control:trackID=1\r\n")
    song = mp3_bytes(rng, mp3_frames)
    with open(os.path.join(b_movies, "song.mp3"), "wb") as f:
        f.write(song)
    # B's keys that no easydarwin.xml pref carries go as flags
    b_flags = ["--auth-enabled", "1", "--rest-username", REST_USER,
               "--rest-password", REST_PASSWORD,
               "--log-folder", os.path.join(b_dir, "logs")]
    return {"a_toml": a_toml, "b_xml": b_xml, "b_flags": b_flags,
            "song": song,
            "b_log": os.path.join(b_dir, "logs", "access.log")}


async def rest(port: int, cmd: str, token: str | None = None, *,
               query: str = "", body: bytes = b"",
               basic: tuple[str, str] | None = None) -> tuple[int, dict]:
    """One REST call on B → (status, JSON); ``token`` goes in the
    ``X-Token`` header."""
    import base64
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        head = [f"POST /api/v1/{cmd}{'?' + query if query else ''} "
                f"HTTP/1.1", "Host: 127.0.0.1",
                f"Content-Length: {len(body)}"]
        if token is not None:
            head.append(f"X-Token: {token}")
        if basic is not None:
            head.append("Authorization: Basic " + base64.b64encode(
                f"{basic[0]}:{basic[1]}".encode()).decode())
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        raw = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 30)
        status = int(raw.split()[1])
        n = int(re.search(rb"(?i)content-length:\s*(\d+)", raw).group(1))
        doc = json.loads(await asyncio.wait_for(reader.readexactly(n), 30))
        return status, doc
    finally:
        writer.close()


def envelope(cmd: str, status: int, doc: dict) -> dict:
    """Check a core command's answer: 200, the reference's message type,
    error 200 and its body keys; returns the body."""
    want_type, keys = ENVELOPES[cmd]
    hdr = doc["EasyDarwin"]["Header"]
    check(status == 200 and hdr["ErrorNum"] == "200"
          and hdr["MessageType"] == f"0x{want_type:04X}"
          and set(hdr) == {"CSeq", "MessageType", "Version", "ErrorNum",
                           "ErrorString"},
          f"REST {cmd}: {status} {hdr}")
    body = doc["EasyDarwin"]["Body"]
    check(keys <= set(body), f"REST {cmd}: body keys {sorted(body)}")
    return body


class _Player:
    def __init__(self, index: int, kind: str, path: str, port: int):
        self.index, self.kind, self.path = index, kind, path
        self.client = (TunnelClient if kind == "tunnel" else MiniClient)(
            credentials=(VIEWER, VIEWER_PASSWORD))
        self.uri = f"rtsp://127.0.0.1:{port}/{path}"
        self.t_join = 0.0
        self.first_ms: float | None = None

    def frames(self) -> list[bytes]:
        if self.kind == "udp":
            return [d for _t, d in self.client.frames]
        return self.client.frames

    async def join(self, port: int, pushed: int, gop: int) -> None:
        c = self.client
        self.t_join = time.monotonic()
        await c.connect(port)
        await c.request("DESCRIBE", self.uri)
        spec = "RTP/AVP/TCP;unicast;interleaved=0-1"
        if self.kind == "udp":
            spec = ("RTP/AVP;unicast;client_port="
                    f"{await c.udp_ports(stamp=True)}")
        resp = await c.request("SETUP", self.uri + "/trackID=1",
                               {"transport": spec})
        t = rtsp.TransportSpec.parse(resp.headers["transport"])
        self.ssrc = t.ssrc
        self.before = pushed
        resp = await c.request("PLAY", self.uri)
        info = resp.headers["rtp-info"]
        self.seq0 = int(re.search(r"seq=(\d+)", info).group(1))
        self.ts0 = int(re.search(r"rtptime=(\d+)", info).group(1))
        self.gop = gop

    def note_first(self) -> None:
        """The ms from the join's connect to the first media packet."""
        c = self.client
        got = c.frames if self.kind == "udp" else c.channels.get(0)
        if self.first_ms is None and got:
            self.first_ms = (got[0][0] - self.t_join) * 1e3


def _want(p: _Player, sent: list[bytes], after: int) -> list[bytes] | None:
    """The packets a player should hold: from the GOP head its first
    packet carries, within a GOP of the heads pushed while it joined."""
    got = p.frames()
    if not got:
        return None
    heads = gop_heads(max(p.before, 1), max(after, 1), p.gop)
    lo, hi = max(heads.start - p.gop, 0), heads.stop + p.gop
    i0 = next((i for i in range(lo, min(hi, len(sent)), p.gop)
               if sent[i][12:] == got[0][12:]), None)
    return None if i0 is None else sent[i0:]


def _check_player(p: _Player, want: list[bytes] | None) -> int:
    got = p.frames()
    who = f"{p.kind} player {p.index} of /{p.path}"
    check(want is not None, f"{who}: no packet, or a first packet that is "
          f"no GOP head near its join ({len(got)} packets)")
    check(len(got) == len(want), f"{who}: {len(got)} of {len(want)} packets")
    src_ts0 = rtp.peek_timestamp(want[0])
    for i, (g, s) in enumerate(zip(got, want)):
        check(g[:2] == s[:2] and g[12:] == s[12:],
              f"{who} packet {i}: payload differs from byte 12 on")
        check(rtp.peek_seq(g) == (p.seq0 + i) & 0xFFFF,
              f"{who} packet {i}: seq not contiguous from RTP-Info")
        check(rtp.peek_timestamp(g)
              == (p.ts0 + rtp.peek_timestamp(s) - src_ts0) & 0xFFFFFFFF,
              f"{who} packet {i}: ts not offset by RTP-Info rtptime")
        check(rtp.peek_ssrc(g) == p.ssrc,
              f"{who} packet {i}: SSRC is not the SETUP reply's")
    return len(got)


async def _per_ip_cap(port: int) -> dict:
    """Three connections from 127.0.0.3 answer OPTIONS; a fourth is
    closed unanswered."""
    held = []
    for _ in range(3):
        c = MiniClient(local_ip="127.0.0.3")
        await c.connect(port)
        await c.request("OPTIONS", "*")
        held.append(c)
    r, w = await asyncio.open_connection("127.0.0.1", port,
                                         local_addr=("127.0.0.3", 0))
    w.write(b"OPTIONS * RTSP/1.0\r\nCSeq: 1\r\n\r\n")
    try:
        data = await asyncio.wait_for(r.read(4096), 10)
    except ConnectionError:
        data = b""
    w.close()
    check(data == b"", f"A answered a 4th connection from one address: "
          f"{data[:60]!r}")
    for c in held:
        await c.close()
    return {"held": len(held), "fourth": "refused"}


async def _icy(port: int, song: bytes) -> dict:
    """GET /song.mp3 with Icy-MetaData: 1 on B's RTSP port, to EOF."""
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(b"GET /song.mp3 HTTP/1.0\r\nIcy-MetaData: 1\r\n\r\n")
    t0 = time.monotonic()
    head = await asyncio.wait_for(r.readuntil(b"\r\n\r\n"), 30)
    body = await asyncio.wait_for(r.read(-1), 60)
    w.close()
    check(head.startswith(b"ICY 200 OK") and b"icy-metaint:8192" in head,
          f"icy GET answered {head[:80]!r}")
    audio, metas = strip_icy(body, 8192)
    check(audio == song, f"icy audio: {len(audio)} bytes, not the file's "
          f"{len(song)} byte for byte")
    check(metas and all(m == b"StreamTitle='Loopback - Relay Song';"
                        for m in metas), f"icy metadata blocks {metas[:2]}")
    return {"bytes": len(audio), "meta_blocks": len(metas),
            "seconds": time.monotonic() - t0}


@contextlib.asynccontextmanager
async def _started(*servers: CliServer):
    """Start the servers side by side; kill any still running at exit."""
    try:
        await asyncio.gather(*(s.__aenter__() for s in servers))
        yield servers
    finally:
        for s in servers:
            await s.__aexit__(None, None, None)


async def serve_surface(device: str, rng: np.random.Generator, folder: str,
                        *, players=PHASE_PLAYERS, gops: int = 5,
                        frames: int = 30, packets_per_frame: int = 13,
                        body_len=(1270, 1300),
                        frame_interval_s: float = 1 / 30,
                        mp3_frames: int = 60,
                        deadline_s: float = 30.0) -> dict:
    gop = frames * packets_per_frame
    bcast_port = free_udp_pair()
    files = write_configs(folder, rng, bcast_port, mp3_frames)
    sent = [[] for _ in range(3)]             # cam1, cam2, bcast
    for k in range(3):
        for g in range(gops):
            sent[k] += synth.paced_gop(
                rng, seq0=0xFFE0 + 1000 * k + len(sent[k]),
                ts0=0xFFFF0000 + 3000 * len(sent[k]), ssrc=0xB0DE0000 + k,
                frames=frames, packets_per_frame=packets_per_frame,
                body_len=body_len)
    async with _started(CliServer(device, "-c", files["a_toml"]),
                        CliServer(device, "-c", files["b_xml"],
                                  *files["b_flags"])) as (a, b):
        res = {"a_unmapped": a.preamble, "b_unmapped": b.preamble}
        check(any("slo_enabled" in ln for ln in a.preamble),
              f"A did not print its unmapped key: {a.preamble}")
        check(any("run_num_threads" in ln for ln in b.preamble),
              f"B did not print its unmapped pref: {b.preamble}")
        pushers = []
        for k in (1, 2):
            c = MiniClient(local_ip="127.0.0.2")
            await c.connect(a.rtsp_port)
            uri = f"rtsp://127.0.0.1:{a.rtsp_port}/cam{k}"
            await c.request("ANNOUNCE", uri,
                            {"content-type": "application/sdp"},
                            VIDEO_SDP.encode())
            await c.request("SETUP", uri + "/trackID=1", {
                "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;"
                             "mode=record"})
            await c.request("RECORD", uri)
            pushers.append(c)
        feeder = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        pushed = 0

        def push_to(n: int) -> None:
            nonlocal pushed
            for i in range(pushed, n):
                pushers[0].push(sent[0][i])
                pushers[1].push(sent[1][i])
                feeder.sendto(sent[2][i], ("127.0.0.1", bcast_port))
            pushed = n

        # the broadcast's ports are bound at its first SETUP: a primer
        # sets it up (and holds it) before the sources start, so its ring
        # starts at the first IDR; the first GOP is paced, as a UDP source
        # must be
        primer = MiniClient(credentials=(VIEWER, VIEWER_PASSWORD))
        await primer.connect(b.rtsp_port)
        bcast_uri = f"rtsp://127.0.0.1:{b.rtsp_port}/bcast"
        await primer.request("DESCRIBE", bcast_uri)
        await primer.request("SETUP", bcast_uri + "/trackID=1", {
            "transport": "RTP/AVP/TCP;unicast;interleaved=0-1"})
        for i in range(0, gop, packets_per_frame):
            push_to(i + packets_per_frame)
            await asyncio.sleep(frame_interval_s)
        await asyncio.sleep(0.3)
        # REST on B: a bad login, a mutating call without X-Token, login
        st, doc = await rest(b.rest_port, "login",
                             query="username=operator&password=wrong")
        check(st == 401 and doc["EasyDarwin"]["Header"]["ErrorNum"]
              == "401", f"a bad login answered {st}")
        st, doc = await rest(b.rest_port, "login",
                             query=f"username={REST_USER}&password="
                                   f"{REST_PASSWORD}")
        token = envelope("login", st, doc)["Token"]
        st, _ = await rest(b.rest_port, "startpullrelay",
                           query=f"token={token}&path=/x&url=rtsp://h/x")
        check(st == 403, f"startpullrelay without X-Token answered {st}")
        st, _ = await rest(b.rest_port, "getserverinfo")
        check(st == 401, f"getserverinfo without credentials answered {st}")
        t_pull = time.monotonic()
        for k in (1, 2):
            url = quote(f"rtsp://127.0.0.1:{a.rtsp_port}/cam{k}", safe="")
            envelope("startpullrelay", *await rest(
                b.rest_port, "startpullrelay", token,
                query=f"path=/pull{k}&url={url}"))
        res["startpullrelay_ms"] = (time.monotonic() - t_pull) * 1e3
        icy = asyncio.create_task(_icy(b.rtsp_port, files["song"]))
        joined: list[_Player] = []
        queue = [_Player(i, kind, path, b.rtsp_port)
                 for i, (kind, path) in enumerate(players)]
        source_of = {"pull1": 0, "pull2": 1, "bcast": 2}
        n = len(sent[0])
        for i in range(gop, n, packets_per_frame):
            if queue:
                p = queue.pop(0)
                await p.join(b.rtsp_port, pushed, gop)
                p.after = pushed
                joined.append(p)
            push_to(i + packets_per_frame)
            for p in joined:
                p.note_first()
            await asyncio.sleep(frame_interval_s)
        check(not queue, f"{len(queue)} players did not join while the "
              f"sources ran: give the sources more GOPs")
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            for p in joined:
                p.note_first()
            wants = [_want(p, sent[source_of[p.path]], p.after)
                     for p in joined]
            if all(w is not None and len(p.frames()) >= len(w)
                   for p, w in zip(joined, wants)):
                break
            await asyncio.sleep(0.05)
        delivered = sum(_check_player(p, w) for p, w in zip(joined, wants))
        res["icy"] = await asyncio.wait_for(icy, 60)
        # the core commands, after the traffic
        info = envelope("getserverinfo", *await rest(
            b.rest_port, "getserverinfo", token))
        live = envelope("getrtsplivesessions", *await rest(
            b.rest_port, "getrtsplivesessions", token))
        paths = {s["Path"] for s in live["Sessions"]}
        check({"/pull1", "/pull2", "/bcast"} <= paths,
              f"getrtsplivesessions lists {sorted(paths)}")
        cfg = envelope("getbaseconfig", *await rest(
            b.rest_port, "getbaseconfig", token))["Config"]
        check("rest_password" not in cfg and cfg["rtsp_auth_enabled"]
              and cfg["auth_enabled"] and cfg["rtsp_timeout_sec"] == 90,
              "getbaseconfig: rest_password shown, or B's XML not applied")
        envelope("setbaseconfig", *await rest(
            b.rest_port, "setbaseconfig", token,
            body=b'{"Config": {"rtsp_timeout_sec": 91}}'))
        cfg = envelope("getbaseconfig", *await rest(
            b.rest_port, "getbaseconfig", token))["Config"]
        check(cfg["rtsp_timeout_sec"] == 91, "setbaseconfig not read back")
        for cmd in ("getdevicestream", "livedevicestream"):
            url = envelope(cmd, *await rest(
                b.rest_port, cmd, token, query="device=pull1"))["URL"]
            check(url == f"rtsp://127.0.0.1:{b.rtsp_port}/pull1",
                  f"{cmd} answered {url}")
        st, doc = await rest(b.rest_port, "getdevicestream", token,
                             query="device=nobody")
        check(st == 404 and doc["EasyDarwin"]["Header"]["ErrorNum"]
              == "600", f"an offline device answered {st}")
        pulls = envelope("getpullrelays", *await rest(
            b.rest_port, "getpullrelays", token))["Pulls"]
        check(len(pulls) == 2 and all(p["alive"] for p in pulls),
              f"getpullrelays: {pulls}")
        res["per_ip"] = await _per_ip_cap(a.rtsp_port)
        for p in joined:
            await p.client.close()
        await primer.close()
        for c in pushers:
            await c.close()
        feeder.close()
        stopped = envelope("stoppullrelay", *await rest(
            b.rest_port, "stoppullrelay", token, query="path=/pull2"))
        check(int(stopped["Packets"]) > 0, f"stoppullrelay: {stopped}")
        envelope("logout", *await rest(b.rest_port, "logout", token))
        st, _ = await rest(b.rest_port, "getserverinfo", token)
        check(st == 401, f"a logged-out token answered {st}")
        await asyncio.sleep(0.3)
        res["b_stats"] = b_stats = await b.stop()
        res["a_stats"] = await a.stop()
    surface = b_stats["surface"]
    with open(files["b_log"]) as f:
        lines = [ln.split() for ln in f if not ln.startswith("#")]
    plays = [ln for ln in lines if ln[4] == "PLAY"]
    check(len(plays) == len(joined) + 1,
          f"B's access log has {len(plays)} PLAY lines for {len(joined)} "
          f"closed players and the broadcast's primer")
    check(surface["tunnels"]["opened"]
          == sum(p.kind == "tunnel" for p in joined),
          f"tunnels opened: {surface['tunnels']}")
    check(surface["rtsp_auth_refused"] >= len(joined),
          f"Digest challenges: {surface['rtsp_auth_refused']}")
    check(surface["error_log"]["lines"] == 0,
          f"B's error log has {surface['error_log']['lines']} lines")
    check(res["a_stats"]["surface"]["per_ip_refused"] == 1,
          f"A refused {res['a_stats']['surface']['per_ip_refused']}")
    first = {}
    for p in joined:
        if p.first_ms is not None:
            first.setdefault(p.kind, []).append(p.first_ms)
    each = {p["path"]: p for p in pulls}
    res.update(
        players=len(joined), delivered=delivered,
        packets_per_source=len(sent[0]),
        first_join_ms={k: {"first": v[0], "p50": float(np.median(v))}
                       for k, v in first.items()},
        pull_first_packet_ms=each["/pull1"]["first_packet_ms"],
        pull_forward_us=each["/pull1"]["forward_us_per_packet"],
        access_log_plays=len(plays), server_info_keys=sorted(info))
    return res
