"""End-to-end checks of a running relay server over loopback RTSP.

``push_play`` plays pushers (ANNOUNCE → SETUP record → RECORD, then
``$``-framed RTP, or with ``push_transport="udp"`` RTP datagrams to the
``server_port`` pair the SETUP reply named, an SR a second to its RTCP
port) and players (DESCRIBE → SETUP → PLAY) against a server on
``127.0.0.1:port``: interleaved TCP players read ``$``-framed RTP from
the connection, UDP players (``client_port``) read datagrams on a port
pair of their own.  Every relayed packet is held to what was pushed: each
player receives every packet from its fast-start keyframe on — the newest
IDR pushed before its PLAY reply came back, or the next one where one was
pushed while PLAY was in flight — the payload is bit-equal from byte 12,
seq is contiguous from the RTP-Info seq, ts is offset by the RTP-Info
rtptime, and the SSRC is the one the SETUP reply named.  A UDP pusher
must also receive an RR of the relay naming its SSRC.  Any failure
raises ``AssertionError``.

``push_play_av`` adds RTCP and the per-player options: one pusher of an
H.264 track (FU-A, so a frame is one NAL) and an AAC track, each with an
SR + SDES compound a second, and players of both tracks that send RRs,
may ask for ``x-RTP-Meta-Info: tt;sq;md`` and may report loss once.  It
holds every player to the oracle (each packet the rewrite of a pushed
one), a thinned player to a frame-whole, level-1 subset of it, every SR
to its output's SSRC, timeline and the host's wall clock, and the
pusher's upstream RRs to its media SSRCs.  It reads RTCP and meta-info
with ``struct`` alone (RFC 3550 §6.4, the meta-info TLV layout), not with
the port's parsers, so that a fault there cannot cancel itself out.

``push_play_lossy`` plays ``push_play``'s pusher to players of four
kinds: plain UDP ones; interleaved TCP ones (``tcp``); FEC ones
(``x-FEC: parity``) that drop media datagrams at a seeded rate, report a
fixed loss in an RR each ``rr_every_s``, rebuild what they can from
parity (``relay.fec.FecReceiver``) and send a generic NACK for each
packet still missing ``NACK_AFTER_S`` after a later one arrived, or
after the push ended for a lost tail (at most ``NACK_MAX_PER_TICK`` a
50 ms tick); and reliable ones (``x-Retransmit: our-retransmit``) that
drop at a seeded rate and ack each datagram they keep with a 'qtak' APP.
A plain or TCP player may also ask for the loss tiers (``ask``: SETUP
headers) and keeps the reply's ``x-FEC`` and ``x-Retransmit``; a FEC
player counts the payload types it received.  Every player's whole span,
from its fast-start IDR to the last pushed packet, must end byte-equal
to the oracle, however each packet came.

``serve_and_check`` starts ``python -m easydarwin_tpu_torch`` on free
ports (``CliServer``), runs ``push_play`` (or another harness) against
it, stops it with SIGTERM and checks the stats it prints at exit.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import itertools
import json
import re
import secrets
import signal
import socket
import struct
import sys
import time
from pathlib import Path

import numpy as np

from ..protocol import rtcp, rtp, rtsp
from ..relay.fec import FecReceiver
from ..relay.reliable import build_ack
from . import synth

VIDEO_SDP = ("v=0\r\no=- 1 1 IN IP4 127.0.0.1\r\ns=loopback\r\n"
             "c=IN IP4 0.0.0.0\r\nt=0 0\r\na=control:*\r\n"
             "m=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
             "a=control:trackID=1\r\n")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class _Datagrams(asyncio.DatagramProtocol):
    """Appends each datagram to ``sink``, with ``stamp`` as
    ``(monotonic seconds, data)``; ``before`` runs first."""

    def __init__(self, sink: list | None, stamp: bool = False,
                 before=None):
        self.sink = sink
        self.stamp = stamp
        self.before = before

    def datagram_received(self, data, addr):
        if self.before is not None:
            self.before()
        if self.sink is not None:
            self.sink.append((time.monotonic(), data) if self.stamp
                             else data)


async def _udp_endpoint(sink: list | None, stamp: bool = False, *,
                        before=None, sock=None):
    """A datagram endpoint on a free loopback port (or ``sock``) with a
    deep receive buffer (a fast-start burst must not overflow it)."""
    if sock is None:
        sock = _udp_socket()
    tr, _ = await asyncio.get_running_loop().create_datagram_endpoint(
        lambda: _Datagrams(sink, stamp, before), sock=sock)
    return tr


def _udp_socket() -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    sock.bind(("127.0.0.1", 0))
    return sock


class MiniClient:
    """Just enough RTSP over TCP for a pusher, an interleaved player or a
    UDP player or pusher (``udp_ports`` opens its RTP/RTCP endpoints; a
    UDP pusher sets ``server_port`` from its SETUP reply).  It connects
    from ``local_ip`` (any 127.x address), and with ``credentials``
    (user, password) answers a Basic or Digest challenge: the request
    that got 401 goes again, and every later one carries the credentials
    (for Digest, its own response to the same nonce)."""

    def __init__(self, local_ip: str | None = None,
                 credentials: tuple[str, str] | None = None):
        self.local_ip = local_ip
        self.credentials = credentials
        #: (realm, nonce) of the server's Digest challenge, or ("basic",
        #: None) for a Basic one, once answered
        self.digest: tuple[str, str | None] | None = None
        #: requests answered 401 before their retry
        self.challenges = 0
        self.wire = rtsp.RtspWireReader(parse_responses=True)
        self.responses: asyncio.Queue = asyncio.Queue()
        self.frames: list[bytes] = []
        #: datagrams on the RTCP endpoint of ``udp_ports``
        self.rtcp: list[bytes] = []
        #: the server's (RTP, RTCP) ports a UDP pusher sends to
        self.server_port: tuple[int, int] | None = None
        #: interleaved channel → [(monotonic seconds, data)]
        self.channels: dict[int, list] = {}
        self.cseq = 0
        self.session = None
        self._task = None
        self._udp: list = []

    async def udp_ports(self, stamp: bool = False) -> str:
        """Open the RTP (into ``frames``; with ``stamp`` as ``(monotonic
        seconds, data)``) and RTCP (into ``rtcp``) endpoints; returns the
        ``client_port=a-b`` value."""
        self._udp = [await _udp_endpoint(self.frames, stamp),
                     await _udp_endpoint(self.rtcp)]
        a, b = (t.get_extra_info("sockname")[1] for t in self._udp)
        return f"{a}-{b}"

    async def connect(self, port: int) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", port,
            local_addr=(self.local_ip, 0) if self.local_ip else None)
        self._task = asyncio.create_task(self._read())

    def _write(self, data: bytes) -> None:
        self.writer.write(data)

    async def _read(self) -> None:
        while True:
            data = await self.reader.read(65536)
            if not data:
                return
            self.wire.feed(data)
            for ev in self.wire.events():
                if isinstance(ev, rtsp.InterleavedPacket):
                    if ev.channel == 0:
                        self.frames.append(ev.data)
                    self.channels.setdefault(ev.channel, []).append(
                        (time.monotonic(), ev.data))
                else:
                    self.responses.put_nowait(ev)

    async def request(self, method: str, uri: str, headers=None,
                      body: bytes = b""):
        resp = await self._send_request(method, uri, headers, body)
        if (resp.status == 401 and self.credentials is not None
                and self.digest is None):
            challenge = resp.headers.get("www-authenticate", "")
            self.digest = (
                ("basic", None) if challenge.lower().startswith("basic")
                else (re.search(r'realm="([^"]*)"', challenge).group(1),
                      re.search(r'nonce="([^"]*)"', challenge).group(1)))
            self.challenges += 1
            resp = await self._send_request(method, uri, headers, body)
        check(resp.status == 200, f"{method} {uri} -> {resp.status}")
        if "session" in resp.headers:
            self.session = resp.headers["session"].split(";")[0]
        return resp

    async def _send_request(self, method: str, uri: str, headers,
                            body: bytes):
        self.cseq += 1
        h = {"cseq": str(self.cseq), **(headers or {})}
        if self.session:
            h["session"] = self.session
        if self.digest == ("basic", None):
            h["authorization"] = "Basic " + base64.b64encode(
                ":".join(self.credentials).encode()).decode()
        elif self.digest is not None:
            h["authorization"] = digest_authorization(
                *self.credentials, *self.digest, method, uri)
        self._write(rtsp.RtspRequest(method, uri, h, body).to_bytes())
        return await asyncio.wait_for(self.responses.get(), 30)

    def push(self, pkt: bytes, channel: int = 0) -> None:
        """Send one packet: ``$``-framed on ``channel``, or for a UDP
        pusher as a datagram to the server's RTP (even channel) or RTCP
        (odd) port from the matching endpoint."""
        if self.server_port is None:
            self._write(rtsp.frame_interleaved(channel, pkt))
        else:
            self._udp[channel % 2].sendto(
                pkt, ("127.0.0.1", self.server_port[channel % 2]))

    async def close(self) -> None:
        for tr in self._udp:
            tr.close()
        self.writer.close()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, ConnectionError):
                pass


def digest_authorization(user: str, password: str, realm: str, nonce: str,
                         method: str, uri: str) -> str:
    """The ``Authorization`` header answering a Digest challenge (RFC
    2617, MD5, no qop), computed here apart from the server's code;
    ``uri`` is the request's URI as sent."""
    def md5(text: str) -> str:
        return hashlib.md5(text.encode()).hexdigest()
    resp = md5(f"{md5(f'{user}:{realm}:{password}')}:{nonce}:"
               f"{md5(f'{method}:{uri}')}")
    return (f'Digest username="{user}", realm="{realm}", nonce="{nonce}", '
            f'uri="{uri}", response="{resp}"')


class TunnelClient(MiniClient):
    """A player over an RTSP-over-HTTP tunnel: a GET connection that
    carries every reply and ``$``-framed packet, and a POST connection
    that carries the requests in base64, each written in two pieces split
    inside a quad."""

    async def connect(self, port: int) -> None:
        cookie = secrets.token_hex(8)
        local = (self.local_ip, 0) if self.local_ip else None
        self.reader, self.get_writer = await asyncio.open_connection(
            "127.0.0.1", port, local_addr=local)
        self.get_writer.write(
            f"GET /tunnel HTTP/1.0\r\nx-sessioncookie: {cookie}\r\n"
            f"Accept: application/x-rtsp-tunnelled\r\n\r\n".encode())
        head = await asyncio.wait_for(self.reader.readuntil(b"\r\n\r\n"),
                                      30)
        check(head.startswith(b"HTTP/1.0 200") and
              b"application/x-rtsp-tunnelled" in head,
              f"tunnel GET answered {head[:80]!r}")
        self._task = asyncio.create_task(self._read())
        _r, self.writer = await asyncio.open_connection(
            "127.0.0.1", port, local_addr=local)
        self.writer.write(
            f"POST /tunnel HTTP/1.0\r\nx-sessioncookie: {cookie}\r\n"
            f"Content-Type: application/x-rtsp-tunnelled\r\n"
            f"Content-Length: 32767\r\n\r\n".encode())

    def _write(self, data: bytes) -> None:
        b64 = base64.b64encode(data)
        cut = min(len(b64), 4 * (len(b64) // 8) + 3)
        self.writer.write(b64[:cut])
        self.writer.write(b64[cut:])

    async def close(self) -> None:
        self.get_writer.close()
        await super().close()


async def push_play(port: int, rng: np.random.Generator, *, n_push: int,
                    n_play: int, transport: str = "tcp",
                    push_transport: str = "tcp", gops: int = 4,
                    frames: int = 5, packets_per_frame: int = 4,
                    body_len=(40, 400), frame_interval_s: float = 0.02,
                    join_every: int = 0, deadline_s: float = 20.0) -> dict:
    """Push ``gops`` GOPs of ``frames`` frames from each of ``n_push``
    sources over ``push_transport`` (``tcp`` or ``udp``), one frame each
    ``frame_interval_s`` (a UDP pusher paces its first GOP too, and sends
    an SR a second); ``n_play`` players of ``transport`` (``tcp`` or
    ``udp``, or a sequence of them taken in turn by the joins) join each
    source after the first GOP, or — with ``join_every`` — one every
    ``join_every`` frames of the live part; a ``tunnel`` player plays
    interleaved through an RTSP-over-HTTP tunnel.  Returns counts."""
    gop = frames * packets_per_frame           # packets a GOP; IDR first
    udp_push = push_transport == "udp"
    kinds = (transport,) if isinstance(transport, str) else tuple(transport)
    pushers, sent = [], []
    for k in range(n_push):
        c = MiniClient()
        await c.connect(port)
        uri = f"rtsp://127.0.0.1:{port}/live/cam{k}"
        await c.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                        VIDEO_SDP.encode())
        spec = "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"
        if udp_push:
            spec = (f"RTP/AVP;unicast;client_port={await c.udp_ports()};"
                    f"mode=record")
        resp = await c.request("SETUP", uri + "/trackID=1",
                               {"transport": spec})
        if udp_push:
            c.server_port = rtsp.TransportSpec.parse(
                resp.headers["transport"]).server_port
            check(c.server_port is not None,
                  "a UDP record SETUP reply names no server_port")
        await c.request("RECORD", uri)
        pkts = []
        for _ in range(gops):
            pkts += synth.paced_gop(rng, seq0=0xFFE0 + 1000 * k + len(pkts),
                                    ts0=0xFFFF0000 + 3000 * len(pkts),
                                    ssrc=0xC0DE0000 + k, frames=frames,
                                    packets_per_frame=packets_per_frame,
                                    body_len=body_len)
        pushers.append((c, uri))
        sent.append(pkts)
    #: packets of each source pushed so far
    pushed = [0] * n_push
    joins = [k for _ in range(n_play) for k in range(n_push)]
    players = []
    #: each player's transport, in join order
    player_kinds: list[str] = []

    def push(k: int, pkts: list[bytes]) -> None:
        for pkt in pkts:
            pushers[k][0].push(pkt)
        pushed[k] += len(pkts)

    def send_sr(k: int) -> None:
        """An SR + SDES of source k on its newest packet."""
        last = sent[k][pushed[k] - 1]
        pushers[k][0].push(sr_compound(
            rtp.peek_ssrc(last), time.time(), rtp.peek_timestamp(last),
            pushed[k], sum(len(p) - 12 for p in sent[k][:pushed[k]]),
            PUSHER_CNAME), channel=1)

    async def push_frames(start: int, stop: int) -> None:
        """Frames [start, stop) of every source, paced, with a UDP
        pusher's SRs a second; staggered joins happen in the live part
        (``start`` past the first GOP)."""
        for f, i in enumerate(range(start, stop, packets_per_frame)):
            if join_every and joins and start and f % join_every == 0:
                await join(joins.pop(0))
            for k in range(n_push):
                push(k, sent[k][i:i + packets_per_frame])
                if udp_push and (i // packets_per_frame) % sr_every == 0:
                    send_sr(k)
            await asyncio.sleep(frame_interval_s)

    async def join(k: int) -> None:
        uri = pushers[k][1]
        kind = kinds[len(player_kinds) % len(kinds)]
        player_kinds.append(kind)
        p = TunnelClient() if kind == "tunnel" else MiniClient()
        await p.connect(port)
        await p.request("DESCRIBE", uri)
        spec = "RTP/AVP/TCP;unicast;interleaved=0-1"
        if kind == "udp":
            spec = f"RTP/AVP;unicast;client_port={await p.udp_ports()}"
        resp = await p.request("SETUP", uri + "/trackID=1",
                               {"transport": spec})
        t = rtsp.TransportSpec.parse(resp.headers["transport"])
        check(t.ssrc is not None, "SETUP reply names no ssrc")
        check(kind != "udp" or t.server_port is not None,
              "UDP SETUP reply names no server_port")
        before = pushed[k]
        resp = await p.request("PLAY", uri)
        info = resp.headers["rtp-info"]
        seq0 = int(re.search(r"seq=(\d+)", info).group(1))
        ts0 = int(re.search(r"rtptime=(\d+)", info).group(1))
        players.append((p, k, seq0, ts0, t.ssrc,
                        gop_heads(before, pushed[k], gop)))

    sr_every = max(1, round(1 / frame_interval_s))     # frames a second
    if udp_push:                               # the first GOP, paced
        await push_frames(0, gop)
    else:
        for k in range(n_push):
            push(k, sent[k][:gop])
    await asyncio.sleep(0.3)
    if not join_every:
        for k in joins:
            await join(k)
        joins = []
    await push_frames(gop, len(sent[0]))
    for k in joins:                            # joiners the frames outran
        await join(k)

    def want(j: int) -> list[bytes] | None:
        """Player j's expected packets: from its fast-start point (the one
        of its allowed GOP heads whose payload its first packet carries)
        to the end."""
        p, k, *_, allowed = players[j]
        if not p.frames:
            return None
        i0 = next((i for i in allowed
                   if sent[k][i][12:] == p.frames[0][12:]), None)
        return None if i0 is None else sent[k][i0:]

    def upstream_rrs(k: int) -> int:
        """RRs on pusher k's RTCP port that name its SSRC."""
        ssrc = rtp.peek_ssrc(sent[k][0])
        n = 0
        for data in pushers[k][0].rtcp:
            for pt, count, body in rtcp_packets(data):
                if pt == _RR and ssrc in [
                        struct.unpack_from("!I", body, 4 + 24 * b)[0]
                        for b in range(count)]:
                    n += 1
        return n

    deadline = time.monotonic() + deadline_s
    while (time.monotonic() < deadline
           and (any(want(j) is None or len(players[j][0].frames)
                    < len(want(j)) for j in range(len(players)))
                or udp_push and not all(map(upstream_rrs, range(n_push))))):
        await asyncio.sleep(0.05)
    delivered = 0
    for j, (p, k, seq0, ts0, ssrc, allowed) in enumerate(players):
        got, w = p.frames, want(j)
        kind = player_kinds[j]
        check(w is not None, f"{kind} player of cam{k}: no packet, or "
              f"a first packet that is not the IDR at packet "
              f"{' or '.join(map(str, allowed))}, the newest pushed before "
              f"its PLAY reply")
        check(len(got) == len(w), f"{kind} player of cam{k}: "
              f"{len(got)} of {len(w)} packets")
        src_ts0 = rtp.peek_timestamp(w[0])
        for i, (g, s) in enumerate(zip(got, w)):
            check(g[:2] == s[:2] and g[12:] == s[12:],
                  f"cam{k} packet {i}: payload differs from byte 12 on")
            check(rtp.peek_seq(g) == (seq0 + i) & 0xFFFF,
                  f"cam{k} packet {i}: seq not contiguous from RTP-Info")
            check(rtp.peek_timestamp(g)
                  == (ts0 + rtp.peek_timestamp(s) - src_ts0) & 0xFFFFFFFF,
                  f"cam{k} packet {i}: ts not offset by RTP-Info rtptime")
            check(rtp.peek_ssrc(g) == ssrc,
                  f"cam{k} packet {i}: SSRC is not the SETUP reply's")
        delivered += len(got)
    rrs = [upstream_rrs(k) for k in range(n_push)] if udp_push else []
    check(all(rrs), f"a UDP pusher received no RR naming its SSRC: {rrs}")
    for p, *_ in players:
        await p.close()
    for c, _ in pushers:
        await c.close()
    return {"pushers": n_push, "players": len(players),
            "transport": transport, "push_transport": push_transport,
            "packets_per_player": len(sent[0]),
            "packets_pushed": sum(pushed), "upstream_rrs": rrs,
            "delivered": delivered}


def gop_heads(before: int, after: int, gop: int) -> range:
    """The fast-start points a PLAY may get: the heads of ``gop``-packet
    GOPs from the newest one pushed before the request (``before``
    packets) to the newest one pushed by the time of its reply
    (``after``)."""
    return range((before - 1) // gop * gop, (after - 1) // gop * gop + 1, gop)


#: the ``/metrics`` counter families of the VOD cache, DVR spill, store and
#: HLS requant tiers (scraped by ``CliServer.stop(counters=...)``)
TIER_COUNTERS = ("vod_cache_hits_total", "vod_cache_misses_total",
                 "dvr_windows_spilled_total", "storage_reconstructs_total",
                 "requant_aus_total", "requant_slices_total",
                 "requant_renditions_total")


class CliServer:
    """``python -m easydarwin_tpu_torch`` on free loopback ports, as an
    async context manager: ``rtsp_port`` and ``rest_port`` are set once
    it listens; ``stop()`` sends SIGTERM and returns the stats it prints
    at exit (a server still running at exit is killed).  ``config`` is a
    config file for ``-c`` (a TOML of config keys or the reference's
    XML)."""

    def __init__(self, device: str, *args: str, config: str | None = None):
        self.device = device
        #: more command-line arguments (``--movie-folder DIR``)
        self.args = args + (("-c", str(config)) if config else ())
        self.proc = None
        self.rtsp_port = self.rest_port = None

    async def __aenter__(self) -> "CliServer":
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "easydarwin_tpu_torch", "-p", "0",
            "--service-port", "0", "--bind-ip", "127.0.0.1",
            "--device", self.device, *self.args,
            cwd=Path(__file__).resolve().parents[2],
            stdout=asyncio.subprocess.PIPE)
        try:
            #: what the server printed before it listened (``-c``'s
            #: unmapped keys)
            self.preamble = []
            for _ in range(8):
                line = (await asyncio.wait_for(self.proc.stdout.readline(),
                                               60)).decode()
                m = re.search(r"listening: rtsp://[\d.]+:(\d+) service "
                              r"http://[\d.]+:(\d+)", line)
                if m is not None or not line:
                    break
                self.preamble.append(line)
            check(m is not None, f"server did not start: {line!r}")
        except BaseException:
            await self.__aexit__(None, None, None)
            raise
        self.rtsp_port, self.rest_port = int(m.group(1)), int(m.group(2))
        return self

    async def stop(self, counters: tuple = ()) -> dict:
        """SIGTERM, then the exit stats; pump errors, device errors and
        oracle mismatches must be 0.  ``counters`` (exposition names of
        ``/metrics`` families) are scraped just before the SIGTERM into
        ``stats["counters"]``, each summed over its label sets."""
        totals = await metric_totals(self.rest_port, counters) \
            if counters else {}
        self.proc.send_signal(signal.SIGTERM)
        out, _ = await asyncio.wait_for(self.proc.communicate(), 60)
        check(self.proc.returncode == 0,
              f"server exited {self.proc.returncode}")
        stats = json.loads(out.decode().split("stats ", 1)[1])
        stats["counters"] = totals
        check(stats["pump_errors"] == 0, f"server pump errors: {stats}")
        check(stats["resilience"]["device_errors"] == 0,
              f"server device errors: {stats['resilience']}")
        check(stats["megabatch"]["mismatches"] == 0,
              f"server scheduler mismatches: {stats}")
        return stats

    async def __aexit__(self, *exc) -> None:
        if self.proc is not None and self.proc.returncode is None:
            self.proc.kill()
            await self.proc.wait()


async def serve_and_check(device: str, rng: np.random.Generator, *,
                          harness=None, **kw) -> dict:
    """``harness`` (``push_play`` by default, or ``push_play_av``; ``kw``
    passed on, ``push_transport="udp"`` among them) against the CLI
    server on ``device``; adds the server's exit stats (pump errors and
    oracle mismatches must be 0); a failed check of the harness is raised
    again with those stats, which say why a player went short."""
    async with CliServer(device) as srv:
        try:
            res = await (harness or push_play)(srv.rtsp_port, rng, **kw)
        except AssertionError as e:
            raise AssertionError(
                f"{e}; the server's exit stats: {await srv.stop()}") from e
        res["server_stats"] = await srv.stop()
        return res


# ------------------------------------------------------- audio + video + RTCP
AV_SDP = VIDEO_SDP + ("m=audio 0 RTP/AVP 97\r\n"
                      "a=rtpmap:97 mpeg4-generic/48000/2\r\n"
                      "a=control:trackID=2\r\n")
#: RTCP packet types (RFC 3550 §12.1)
_SR, _RR, _SDES = 200, 201, 202
_NTP_EPOCH = 2208988800
PUSHER_CNAME = b"loopback-pusher"
#: the CNAME of the relay's own SRs
RELAY_CNAME = b"easydarwin-tpu"
#: (clock rate, ticks a packet or frame) of the two tracks
VIDEO, AUDIO = 1, 2
CLOCK = {VIDEO: 90000, AUDIO: 48000}
AUDIO_TICKS = 1024                      # one AAC frame
#: video frames a second
FPS = 30
#: the fraction a lossy player reports once: 90/256 ≈ 0.35
LOSS_FRACTION = 90


def rtcp_packets(data: bytes) -> list[tuple[int, int, bytes]]:
    """``(packet type, count, body)`` of each packet of an RTCP compound
    (RFC 3550 §6.1); a malformed compound fails the check."""
    out, off = [], 0
    while off < len(data):
        check(off + 4 <= len(data), "RTCP compound: a torn header")
        b0, pt, words = struct.unpack_from("!BBH", data, off)
        end = off + 4 + 4 * words
        check(b0 >> 6 == 2 and end <= len(data),
              "RTCP compound: a bad version or length")
        out.append((pt, b0 & 0x1F, data[off + 4:end]))
        off = end
    return out


def sdes_cname(body: bytes) -> bytes | None:
    """The CNAME item of an SDES packet's first chunk."""
    pos = 4
    while pos + 2 <= len(body) and body[pos] != 0:
        item, n = body[pos], body[pos + 1]
        if item == 1:
            return body[pos + 2:pos + 2 + n]
        pos += 2 + n
    return None


def sr_compound(ssrc: int, unix_time: float, rtp_ts: int, packets: int,
                octets: int, cname: bytes) -> bytes:
    """SR (no report blocks) + SDES(CNAME), as a sender sends them."""
    ntp = struct.pack("!II", int(unix_time) + _NTP_EPOCH,
                      int(unix_time % 1 * (1 << 32)) & 0xFFFFFFFF)
    sr = (struct.pack("!BBHI", 0x80, _SR, 6, ssrc) + ntp
          + struct.pack("!III", rtp_ts & 0xFFFFFFFF, packets, octets))
    chunk = struct.pack("!IBB", ssrc, 1, len(cname)) + cname + b"\0"
    chunk += b"\0" * (-len(chunk) % 4)
    return sr + struct.pack("!BBH", 0x81, _SDES, len(chunk) // 4) + chunk


def receiver_report(reporter: int, ssrc: int, fraction_lost: int,
                    highest_seq: int) -> bytes:
    """An RR with one report block on ``ssrc``."""
    return struct.pack("!BBHIIIIIII", 0x81, _RR, 7, reporter, ssrc,
                       (fraction_lost & 0xFF) << 24, highest_seq, 0, 0, 0)


def meta_fields(pkt: bytes, ids: dict[str, int]) -> dict[str, bytes]:
    """The x-RTP-Meta-Info fields after a packet's 12-byte header: a
    compressed field is ``0x80 | id``, an 8-bit length and its data, an
    uncompressed one its 2-letter name, a 16-bit length and its data."""
    by_id = {i: n for n, i in ids.items() if i >= 0}
    out, pos = {}, 12
    while pos < len(pkt):
        if pkt[pos] & 0x80:
            check(pos + 2 <= len(pkt), "meta-info: a torn field header")
            name, n, pos = by_id.get(pkt[pos] & 0x7F), pkt[pos + 1], pos + 2
        else:
            check(pos + 4 <= len(pkt), "meta-info: a torn field header")
            name = pkt[pos:pos + 2].decode("ascii", "replace")
            n, pos = int.from_bytes(pkt[pos + 2:pos + 4], "big"), pos + 4
        check(name is not None and pos + n <= len(pkt),
              f"meta-info: an unknown or overlong field at {pos}")
        out[name] = pkt[pos:pos + n]
        pos += n
    return out


def udp_rcvbuf_errors() -> int:
    """The host's UDP ``RcvbufErrors`` (``/proc/net/snmp``): datagrams a
    full receive buffer dropped; 0 where the file has no such row."""
    try:
        with open("/proc/net/snmp") as f:
            rows = [line.split() for line in f if line.startswith("Udp:")]
        return int(dict(zip(rows[0][1:], rows[1][1:]))["RcvbufErrors"])
    except (OSError, KeyError, IndexError):
        return 0


async def http_get_json(port: int, target: str) -> tuple[int, dict]:
    """One GET on the REST port → (status, JSON body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {target} HTTP/1.1\r\nHost: 127.0.0.1\r\n\r\n"
                     .encode())
        head = (await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 30)
                ).decode("latin-1")
        status = int(head.split()[1])
        clen = int(re.search(r"(?i)content-length:\s*(\d+)", head).group(1))
        body = await asyncio.wait_for(reader.readexactly(clen), 30)
        return status, json.loads(body)
    finally:
        writer.close()


async def metric_totals(port: int, names) -> dict:
    """``/metrics`` on the REST port → {family: its samples summed over
    their label sets} for each exposition name in ``names``."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(b"GET /metrics HTTP/1.1\r\nHost: 127.0.0.1\r\n\r\n")
        head = (await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 30)
                ).decode("latin-1")
        check(int(head.split()[1]) == 200, f"/metrics answered {head!r}")
        clen = int(re.search(r"(?i)content-length:\s*(\d+)", head).group(1))
        body = await asyncio.wait_for(reader.readexactly(clen), 30)
    finally:
        writer.close()
    totals = dict.fromkeys(names, 0.0)
    for line in body.decode().splitlines():
        m = re.match(r"([A-Za-z_:][\w:]*)(?:\{.*\})?\s+(\S+)$", line)
        if m is not None and m.group(1) in totals:
            totals[m.group(1)] += float(m.group(2))
    return totals


def _drain(sock: socket.socket, sink: list) -> None:
    """Stamp and keep every datagram queued on ``sock`` now."""
    while True:
        try:
            data = sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        sink.append((time.monotonic(), data))


def _meta_ids(header: str) -> dict[str, int]:
    """``tt=0;sq=1;md`` → {field: compressed id, −1 = uncompressed}."""
    out = {}
    for part in header.split(";"):
        name, _, fid = part.strip().partition("=")
        if name:
            out[name] = int(fid) if fid else -1
    return out


def _s32(v: int) -> int:
    """A 32-bit difference as a signed number."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


class _AvTrack:
    """One player's view of one track: what its SETUP and PLAY replies
    named, and what arrived ``[(monotonic s, bytes)]``."""

    def __init__(self):
        self.ssrc = self.seq0 = self.ts0 = None
        self.meta_ids: dict[str, int] | None = None
        self.rtp: list = []
        self.rtcp: list = []
        self.rtcp_tr = None             # UDP: the RTCP endpoint
        self.server_rtcp = None         # UDP: the server's RTCP address


class _AvPlayer:
    def __init__(self, index: int, spec: dict, rng):
        self.index = index
        self.transport = spec.get("transport", "udp")
        self.meta = bool(spec.get("meta"))
        self.lossy = bool(spec.get("lossy"))
        self.kind = "meta" if self.meta else "lossy" if self.lossy \
            else "plain"
        self.client = MiniClient()
        self.tracks = {VIDEO: _AvTrack(), AUDIO: _AvTrack()}
        self.reporter = int(rng.integers(1 << 32))
        self.joined_at = None
        self.loss_sent_at = None
        self.allowed = range(0)

    def received(self, tid: int) -> list[tuple[float, bytes]]:
        """``(arrival, RTP packet)``: a meta-info packet as the RTP packet
        it carries (header ∥ ``md``), its ``sq`` held to its seq and its
        ``tt`` to the host's wall clock (within 2 s)."""
        tr = self.tracks[tid]
        if tr.meta_ids is None:
            return tr.rtp
        wall_minus_mono = time.time() - time.monotonic()
        out = []
        for t, pkt in tr.rtp:
            f = meta_fields(pkt, tr.meta_ids)
            check({"tt", "sq", "md"} <= set(f),
                  f"player {self.index}: a meta-info packet without tt, sq "
                  f"or md: {sorted(f)}")
            check(f["sq"] == pkt[2:4],
                  f"player {self.index}: sq differs from the packet's seq")
            tt = int.from_bytes(f["tt"], "big") / 1000
            check(abs(tt - (t + wall_minus_mono)) <= 2.0,
                  f"player {self.index}: tt {tt:.3f} is not the host "
                  f"clock's {t + wall_minus_mono:.3f}")
            out.append((t, pkt[:12] + f["md"]))
        return out

    def send_rr(self, tid: int, fraction_lost: int) -> None:
        tr = self.tracks[tid]
        got = tr.rtp
        highest = rtp.peek_seq(got[-1][1]) if got else 0
        rr = receiver_report(self.reporter, tr.ssrc, fraction_lost, highest)
        if self.transport == "udp":
            tr.rtcp_tr.sendto(rr, tr.server_rtcp)
        else:
            self.client.push(rr, 2 * (tid - 1) + 1)


async def push_play_av(port: int, rng: np.random.Generator, *,
                       players: list[dict], gops: int = 7, frames: int = 30,
                       packets_per_frame: int = 13, body_len=(1270, 1300),
                       rr_every_s: float = 1.0, loss_after_s: float = 1.0,
                       deadline_s: float = 30.0,
                       path: str = "/live/av") -> dict:
    """One pusher of ``gops`` GOPs of ``frames`` H.264 frames (FU-A,
    ``packets_per_frame`` packets a frame) at ``FPS`` and an AAC track
    (one packet of 200–400 bytes each 1024 ticks at 48 kHz), each with an
    SR + SDES compound a second; after the first GOP one player of
    ``players`` joins each frame.  A player spec is ``{"transport":
    "udp"|"tcp", "meta": bool, "lossy": bool}``; every player sends an RR
    on each track each ``rr_every_s``, a lossy one reports
    ``LOSS_FRACTION`` on video once, ``loss_after_s`` after its join.
    The pusher announces ``path``.  Every check of the module docstring
    is made; returns the counts."""
    gop = frames * packets_per_frame
    duration = gops * frames / FPS
    v_ssrc, a_ssrc = 0xC0DE0001, 0xA0D10002
    video = []
    for _ in range(gops):
        video += synth.paced_gop(
            rng, seq0=0xFFE0 + len(video), ts0=0xFFFF0000 + 3000 * (
                len(video) // packets_per_frame), ssrc=v_ssrc, frames=frames,
            packets_per_frame=packets_per_frame, body_len=body_len,
            fu_a=True)
    n_audio = int(duration * CLOCK[AUDIO] / AUDIO_TICKS)
    audio = [synth.aac_packet(rng, 0xFF00 + i, 0xFFFFF000 + AUDIO_TICKS * i,
                              ssrc=a_ssrc) for i in range(n_audio)]
    sent = {VIDEO: video, AUDIO: audio}
    media_ssrc = {VIDEO: v_ssrc, AUDIO: a_ssrc}
    pusher = MiniClient()
    await pusher.connect(port)
    uri = f"rtsp://127.0.0.1:{port}{path}"
    await pusher.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                         AV_SDP.encode())
    for tid in (VIDEO, AUDIO):
        await pusher.request("SETUP", f"{uri}/trackID={tid}", {
            "transport": f"RTP/AVP/TCP;unicast;interleaved={2 * tid - 2}-"
                         f"{2 * tid - 1};mode=record"})
    await pusher.request("RECORD", uri)
    # the push schedule: (seconds from the start, track or 0 = SR, index)
    events = [(f / FPS, VIDEO, f) for f in range(gops * frames)]
    events += [(i * AUDIO_TICKS / CLOCK[AUDIO], AUDIO, i)
               for i in range(n_audio)]
    k = 0
    while k + 0.75 < duration:                 # out of phase with joins
        events.append((k + 0.75, 0, k))
        k += 1
    events.sort()
    pushed = {VIDEO: 0, AUDIO: 0}
    octets = {VIDEO: 0, AUDIO: 0}
    av = [_AvPlayer(i, spec, rng) for i, spec in enumerate(players)]
    waiting = list(av)
    joins: list[asyncio.Task] = []

    async def join(pl: _AvPlayer) -> None:
        c = pl.client
        await c.connect(port)
        await c.request("DESCRIBE", uri)
        for tid, tr in pl.tracks.items():
            if pl.transport == "udp":
                rtp_sock = _udp_socket()
                rtp_tr = await _udp_endpoint(tr.rtp, True, sock=rtp_sock)
                # an RTCP datagram is stamped only after every RTP datagram
                # already queued on the track's socket: the two sockets'
                # events reach the loop in no fixed order
                tr.rtcp_tr = await _udp_endpoint(
                    tr.rtcp, True, before=lambda s=rtp_sock, sink=tr.rtp:
                    _drain(s, sink))
                c._udp += [rtp_tr, tr.rtcp_tr]
                a, b = (x.get_extra_info("sockname")[1]
                        for x in (rtp_tr, tr.rtcp_tr))
                spec = f"RTP/AVP;unicast;client_port={a}-{b}"
            else:
                spec = (f"RTP/AVP/TCP;unicast;interleaved={2 * tid - 2}-"
                        f"{2 * tid - 1}")
                tr.rtp = c.channels.setdefault(2 * tid - 2, [])
                tr.rtcp = c.channels.setdefault(2 * tid - 1, [])
            hdr = {"transport": spec}
            if pl.meta:
                hdr["x-rtp-meta-info"] = "tt;sq;md"
            resp = await c.request("SETUP", f"{uri}/trackID={tid}", hdr)
            t = rtsp.TransportSpec.parse(resp.headers["transport"])
            check(t.ssrc is not None, "SETUP reply names no ssrc")
            tr.ssrc = t.ssrc
            if pl.transport == "udp":
                check(t.server_port is not None,
                      "UDP SETUP reply names no server_port")
                tr.server_rtcp = ("127.0.0.1", t.server_port[1])
            if pl.meta:
                granted = resp.headers.get("x-rtp-meta-info")
                check(granted is not None,
                      "a meta-info SETUP was answered without the header")
                tr.meta_ids = _meta_ids(granted)
                check(set(tr.meta_ids) == {"tt", "sq", "md"}
                      and tr.meta_ids["md"] == -1,
                      f"meta-info grant {granted!r}")
        before = pushed[VIDEO]
        resp = await c.request("PLAY", uri)
        pl.allowed = gop_heads(before, pushed[VIDEO], gop)
        for item in resp.headers["rtp-info"].split(","):
            tid = int(re.search(r"trackID=(\d+)", item).group(1))
            pl.tracks[tid].seq0 = int(re.search(r"seq=(\d+)", item).group(1))
            pl.tracks[tid].ts0 = int(
                re.search(r"rtptime=(\d+)", item).group(1))
        pl.joined_at = time.monotonic()

    stop = asyncio.Event()

    async def rr_ticker() -> None:
        while not stop.is_set():
            now = time.monotonic()
            for pl in av:
                if pl.joined_at is None:
                    continue
                for tid in (VIDEO, AUDIO):
                    frac = 0
                    if (pl.lossy and tid == VIDEO and pl.loss_sent_at is None
                            and now - pl.joined_at >= loss_after_s):
                        frac, pl.loss_sent_at = LOSS_FRACTION, now
                    pl.send_rr(tid, frac)
            try:
                await asyncio.wait_for(stop.wait(), rr_every_s)
            except asyncio.TimeoutError:
                pass

    ticker = asyncio.create_task(rr_ticker())
    t_start = time.monotonic()
    wall0 = time.time()
    try:
        for t_ev, tid, i in events:
            delay = t_start + t_ev - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            if tid == 0:
                for trk in (VIDEO, AUDIO):
                    n = pushed[trk]
                    rtp_ts = (rtp.peek_timestamp(sent[trk][0])
                              + int(t_ev * CLOCK[trk])) & 0xFFFFFFFF
                    pusher.push(sr_compound(
                        media_ssrc[trk], wall0 + t_ev, rtp_ts, n,
                        octets[trk], PUSHER_CNAME), 2 * trk - 1)
                continue
            if tid == VIDEO:
                if i >= frames and waiting:
                    joins.append(asyncio.create_task(join(waiting.pop(0))))
                pkts = video[i * packets_per_frame:(i + 1) * packets_per_frame]
            else:
                pkts = [audio[i]]
            for pkt in pkts:
                pusher.push(pkt, 2 * tid - 2)
                octets[tid] += len(pkt) - 12
            pushed[tid] += len(pkts)
        for pl in waiting:                      # joiners the frames outran
            joins.append(asyncio.create_task(join(pl)))
        await asyncio.gather(*joins)
        deadline = time.monotonic() + deadline_s

        def done(pl: _AvPlayer) -> bool:
            """Both tracks reached their last pushed packet (a thinned
            video its last two frames), and both had RTCP."""
            v, a = pl.tracks[VIDEO].rtp, pl.tracks[AUDIO].rtp
            tail = video[-2 * packets_per_frame:] if pl.lossy else video[-1:]
            return (bool(v) and bool(a)
                    and any(v[-1][1].endswith(p[12:]) for p in tail)
                    and a[-1][1].endswith(audio[-1][12:])
                    and all(tr.rtcp for tr in pl.tracks.values()))

        while time.monotonic() < deadline and not all(map(done, av)):
            await asyncio.sleep(0.05)
        settled = time.monotonic()
        await asyncio.sleep(0.5)               # thinned players' last frames
        stop.set()
        await ticker
        res = _check_av(av, sent, media_ssrc, pusher, frames,
                        packets_per_frame, time.time() - time.monotonic())
    finally:
        stop.set()
        if not ticker.done():
            ticker.cancel()
            try:
                await ticker
            except asyncio.CancelledError:
                pass
        for pl in av:
            if pl.client._task is not None:
                await pl.client.close()
        await pusher.close()
    res.update(players=len(av), video_packets=len(video),
               audio_packets=len(audio), push_s=duration,
               settle_s=settled - t_start - duration)
    return res


def _oracle(src: bytes, seq: int, ts: int, ssrc: int) -> bytes:
    """What a player must receive for the pushed ``src``: its bytes with
    seq, ts and SSRC rewritten."""
    return src[:2] + struct.pack("!HII", seq & 0xFFFF, ts & 0xFFFFFFFF,
                                 ssrc) + src[12:]


def _check_track(pl: _AvPlayer, tid: int, sent: list[bytes],
                 frames: int, ppf: int) -> list[int]:
    """Hold one player's track to the oracle; returns the pushed indices
    it received."""
    tr = pl.tracks[tid]
    got = [pkt for _t, pkt in pl.received(tid)]
    who = f"player {pl.index} ({pl.kind}, {pl.transport}) track {tid}"
    check(bool(got), f"{who}: no packet")
    if tid == VIDEO:
        starts = list(pl.allowed)
    else:
        starts = range(len(sent))
    i0 = next((i for i in starts if sent[i][12:] == got[0][12:]), None)
    check(i0 is not None, f"{who}: the first packet is not a fast-start "
          f"point ({list(starts)[:4]}...)")
    src_ts0 = rtp.peek_timestamp(sent[i0])
    idxs = []
    for pkt in got:
        j = (rtp.peek_seq(pkt) - tr.seq0) & 0xFFFF
        check(i0 + j < len(sent) and (not idxs or j > idxs[-1]),
              f"{who}: seq {rtp.peek_seq(pkt)} out of order or range")
        src = sent[i0 + j]
        check(pkt == _oracle(src, tr.seq0 + j,
                             tr.ts0 + rtp.peek_timestamp(src) - src_ts0,
                             tr.ssrc),
              f"{who}: packet {j} differs from the oracle's bytes")
        idxs.append(j)
    idxs = [i0 + j for j in idxs]
    if pl.lossy and tid == VIDEO:
        _check_thinned(who, idxs, frames, ppf)
    else:
        check(idxs == list(range(i0, len(sent))),
              f"{who}: {len(idxs)} of {len(sent) - i0} packets")
    return idxs


def _check_thinned(who: str, idxs: list[int], frames: int,
                   ppf: int) -> None:
    """A thinned video track: whole frames only, strictly fewer packets
    than were pushed over its span, and between its first and its last
    missing frame the level-1 pattern (every keyframe kept, never two
    non-key frames in a row)."""
    span = idxs[-1] - idxs[0] + 1
    check(len(idxs) < span, f"{who}: not thinned ({len(idxs)} packets of "
          f"the {span} pushed over its span)")
    have: dict[int, int] = {}
    for i in idxs:
        have[i // ppf] = have.get(i // ppf, 0) + 1
    first, last = idxs[0] // ppf, idxs[-1] // ppf
    for f in range(first, last + 1):
        n = have.get(f, 0)
        check(n in (0, ppf), f"{who}: frame {f} partly delivered ({n} of "
              f"{ppf})")
    missing = [f for f in range(first, last + 1) if not have.get(f)]
    for f in range(missing[0], missing[-1] + 1):
        if f % frames == 0:
            check(f in have, f"{who}: keyframe {f} dropped at level 1")
        elif f + 1 <= missing[-1] and (f + 1) % frames:
            check(not (f in have and f + 1 in have),
                  f"{who}: non-key frames {f} and {f + 1} both delivered "
                  f"while thinned (a rung skipped the filter)")


def _check_srs(pl: _AvPlayer, tid: int, wall_minus_mono: float) -> dict:
    """Every SR a player got on a track: its output's SSRC, an NTP time
    within 2 s of the host clock, and an RTP time on the output's
    timeline: within a second of clock ticks of the newest RTP timestamp
    it had received on that SSRC, carried forward by the time since that
    packet arrived (the SR's RTP time is "now")."""
    tr = pl.tracks[tid]
    who = f"player {pl.index} ({pl.kind}, {pl.transport}) track {tid}"
    rtp_in = pl.received(tid)
    counts = {"relayed": 0, "originated": 0}
    for t, data in tr.rtcp:
        pkts = rtcp_packets(data)
        srs = [body for pt, _c, body in pkts if pt == _SR]
        check(len(srs) == 1, f"{who}: an RTCP compound with {len(srs)} SRs")
        ssrc, sec, frac, rtp_ts = struct.unpack_from("!IIII", srs[0])
        check(ssrc == tr.ssrc, f"{who}: SR SSRC {ssrc:#x}, not {tr.ssrc:#x}")
        ntp_unix = sec - _NTP_EPOCH + frac / (1 << 32)
        check(abs(ntp_unix - (t + wall_minus_mono)) <= 2.0,
              f"{who}: SR NTP time {ntp_unix:.3f} is not the host clock's "
              f"{t + wall_minus_mono:.3f}")
        before = [(ta, p) for ta, p in rtp_in if ta <= t]
        ta, ref = before[-1] if before else rtp_in[0]
        want = rtp.peek_timestamp(ref) + round((t - ta) * CLOCK[tid])
        check(abs(_s32(rtp_ts - want)) <= CLOCK[tid],
              f"{who}: SR RTP time {rtp_ts} is not on the output's "
              f"timeline (newest received {rtp.peek_timestamp(ref)}, "
              f"{t - ta:.3f} s before it)")
        cname = next((sdes_cname(b) for pt, _c, b in pkts if pt == _SDES),
                     None)
        counts["originated" if cname == RELAY_CNAME else "relayed"] += 1
    check(sum(counts.values()) > 0, f"{who}: no SR")
    return counts


def _check_av(av, sent, media_ssrc, pusher, frames, ppf,
              wall_minus_mono) -> dict:
    delivered = {"plain": 0, "meta": 0, "lossy": 0}
    #: (kind, transport) → SRs by origin
    srs: dict[str, dict[str, int]] = {}
    thinned = []
    for pl in av:
        for tid in (VIDEO, AUDIO):
            idxs = _check_track(pl, tid, sent[tid], frames, ppf)
            delivered[pl.kind] += len(idxs)
            if pl.lossy and tid == VIDEO:
                thinned.append((len(idxs), idxs[-1] - idxs[0] + 1))
            got = srs.setdefault(f"{pl.kind}/{pl.transport}",
                                 {"relayed": 0, "originated": 0})
            for k, n in _check_srs(pl, tid, wall_minus_mono).items():
                got[k] += n
    upstream = {}
    for tid in (VIDEO, AUDIO):
        rrs = 0
        for _t, data in pusher.channels.get(2 * tid - 1, []):
            for pt, count, body in rtcp_packets(data):
                if pt != _RR:
                    continue
                reporter = struct.unpack_from("!I", body)[0]
                blocks = [struct.unpack_from("!I", body, 4 + 24 * b)[0]
                          for b in range(count)]
                check(reporter != media_ssrc[tid],
                      f"track {tid}: the upstream RR reports as the media "
                      f"SSRC")
                check(media_ssrc[tid] in blocks,
                      f"track {tid}: the upstream RR names {blocks}, not "
                      f"the pushed SSRC")
                rrs += 1
        check(rrs > 0, f"track {tid}: the pusher received no RR")
        upstream[tid] = rrs
    return {"delivered": delivered, "srs": srs, "thinned": thinned,
            "upstream_rrs": upstream,
            "plain_udp_packets": sum(
                len(pl.tracks[t].rtp) for pl in av for t in (VIDEO, AUDIO)
                if pl.kind == "plain" and pl.transport == "udp")}


# ------------------------------------------------------- lossy UDP players
#: the RR loss a FEC player reports, 20/256 ≈ 8%: above the FEC
#: controller's 2% step, below thinning's 10%
FEC_LOSS_FRACTION = 20
#: how long a FEC player waits for parity to rebuild a missing packet
#: (its window's parity is due by then) before it NACKs it, and before it
#: NACKs it again
NACK_AFTER_S = 0.25
NACK_AGAIN_S = 2.0
#: the seqs a FEC player NACKs at most in one 50 ms tick: 40 a second,
#: inside the server's RTX budget of 64 an output a second (and a burst
#: of 32 covers the NACKs that queue behind a slow wake)
NACK_MAX_PER_TICK = 2


class _LossyPlayer:
    """One UDP player of ``push_play_lossy`` (the module docstring)."""

    def __init__(self, index: int, spec: dict, rng):
        self.index = index
        self.kind = spec.get("kind", "plain")
        self.drop = float(spec.get("drop", 0.0))
        #: loss-tier headers a plain or TCP player sends at SETUP, and the
        #: reply's ``x-fec`` / ``x-retransmit`` headers
        self.ask: dict[str, str] = dict(spec.get("ask", {}))
        self.grants: dict[str, str] = {}
        #: RTP payload type → datagrams received (a FEC player's)
        self.pts: dict[int, int] = {}
        #: the player's own seeded drop stream
        self.rng = np.random.default_rng(int(rng.integers(1 << 62)))
        self.client = MiniClient()
        self.reporter = int(rng.integers(1 << 32))
        self.ssrc = self.seq0 = self.ts0 = None
        self.allowed = range(0)
        self.rtcp_tr = None
        self.server_rtcp = None
        self.joined_at = None
        self.datagrams: list[bytes] = []   # plain: in arrival order
        self.rx: FecReceiver | None = None
        self.got: dict[int, bytes] = {}    # reliable: seq → packet
        self.dropped = self.duplicates = self.acks = 0
        self.nacks = self.nacked_seqs = 0
        #: packet indices since the RTP-Info seq held (however they came),
        #: the bytes of index 0, the newest index, and index → when it
        #: was first seen missing below the newest
        self.held: set[int] = set()
        self.first: bytes | None = None
        self.max_j = -1
        self.missing: dict[int, float] = {}
        self._nacked_at: dict[int, float] = {}
        self._early: list[tuple[int, bytes]] = []
        #: the span's length once the push is over (None: not known yet)
        self.end: int | None = None

    def set_origin(self, seq0: int, ts0: int) -> None:
        """The PLAY reply's RTP-Info: index what arrived before it."""
        self.seq0, self.ts0 = seq0, ts0
        early, self._early = self._early, []
        for key, data in early:
            self._hold(key, data)

    def _hold(self, key: int, data: bytes) -> None:
        """Note a packet held, by its (extended) seq."""
        if self.seq0 is None:
            self._early.append((key, data))
            return
        j = (key - self.seq0) & 0xFFFF
        if j in self.held:
            return
        self.held.add(j)
        if j == 0:
            self.first = data
        self.missing.pop(j, None)
        now = time.monotonic()
        for m in range(self.max_j + 1, j):
            if m not in self.held:
                self.missing[m] = now
        self.max_j = max(self.max_j, j)

    def note_end(self, n: int) -> None:
        """The push is over and the span holds ``n`` packets (what a
        receiver learns from the sender's report of its packet count):
        the indices past the newest held become missing, so a lost tail
        is NACKed like a lost middle."""
        if self.end is not None:
            return
        self.end = n
        now = time.monotonic()
        for m in range(self.max_j + 1, n):
            if m not in self.held:
                self.missing[m] = now

    # -- the RTP socket --------------------------------------------------
    def on_rtp(self, data: bytes) -> None:
        if self.kind == "plain":
            self.datagrams.append(data)
            return
        if self.kind == "fec" and len(data) >= 2:
            pt = data[1] & 0x7F
            self.pts[pt] = self.pts.get(pt, 0) + 1
        if len(data) >= 12 and (data[1] & 0x7F) == 96 \
                and self.rng.random() < self.drop:
            self.dropped += 1              # a media datagram lost
            return
        if self.kind == "fec":
            rx = self.rx
            sizes = [(d, len(d)) for d in (rx.media, rx.rtx_restored,
                                           rx.recovered)]
            rx.on_packet(data)
            for d, n0 in sizes:            # the entries this packet added
                for ext in itertools.islice(reversed(d), len(d) - n0):
                    self._hold(ext, d[ext])
            return
        seq = rtp.peek_seq(data)
        if seq in self.got:
            self.duplicates += 1
        self.got[seq] = data
        self._hold(seq, data)
        self.rtcp_tr.sendto(build_ack(self.ssrc, seq), self.server_rtcp)
        self.acks += 1

    # -- what it holds -----------------------------------------------------
    def span(self) -> dict[int, bytes]:
        """Packet index since the RTP-Info seq → its bytes (media first,
        then an RTX replay, then a parity rebuild)."""
        if self.kind == "reliable":
            return {(s - self.seq0) & 0xFFFF: d for s, d in self.got.items()}
        out: dict[int, bytes] = {}
        for src in (self.rx.recovered, self.rx.rtx_restored, self.rx.media):
            for ext, d in src.items():
                out[(ext - self.seq0) & 0xFFFF] = d
        return out

    def nack_due(self, now: float) -> list[int]:
        """Indices missing below the newest held for ``NACK_AFTER_S``,
        each again after ``NACK_AGAIN_S``: the oldest
        ``NACK_MAX_PER_TICK`` of them."""
        due = []
        for j, since in self.missing.items():
            if now - since >= NACK_AFTER_S and \
                    now - self._nacked_at.get(j, -NACK_AGAIN_S) \
                    >= NACK_AGAIN_S:
                due.append(j)
                if len(due) == NACK_MAX_PER_TICK:
                    break
        for j in due:
            self._nacked_at[j] = now
        return due

    def send_rtcp(self, data: bytes) -> None:
        self.rtcp_tr.sendto(data, self.server_rtcp)


async def push_play_lossy(port: int, rng: np.random.Generator, *,
                          players: list[dict], gops: int = 8,
                          frames: int = 30, packets_per_frame: int = 13,
                          body_len=(1270, 1300),
                          frame_interval_s: float = 1 / 30,
                          rr_every_s: float = 0.5,
                          deadline_s: float = 30.0,
                          path: str = "/live/lossy",
                          joined: asyncio.Event | None = None) -> dict:
    """One pusher of ``gops`` GOPs (``push_play``'s), then one player of
    ``players`` joining each frame of the live part; a spec is
    ``{"kind": "plain"|"tcp"|"fec"|"reliable", "drop": fraction,
    "ask": {header: value}}``.  Holds every player's span to the oracle
    (the module docstring); returns the counts, per FEC player the
    packets rebuilt from parity and replayed and the payload types it
    received, and each asking player's grants.  The pusher announces
    ``path``; ``joined`` is set once the first player's PLAY answered."""
    gop = frames * packets_per_frame
    uri = f"rtsp://127.0.0.1:{port}{path}"
    sent = []
    for _ in range(gops):
        sent += synth.paced_gop(rng, seq0=0xFFE0 + len(sent),
                                ts0=0xFFFF0000 + 3000 * len(sent),
                                ssrc=0xC0DE0000, frames=frames,
                                packets_per_frame=packets_per_frame,
                                body_len=body_len)
    pusher = MiniClient()
    await pusher.connect(port)
    await pusher.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                         VIDEO_SDP.encode())
    await pusher.request("SETUP", uri + "/trackID=1", {
        "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"})
    await pusher.request("RECORD", uri)
    av = [_LossyPlayer(i, spec, rng) for i, spec in enumerate(players)]
    pushed = 0

    async def join(pl: _LossyPlayer) -> None:
        c = pl.client
        await c.connect(port)
        await c.request("DESCRIBE", uri)
        if pl.kind == "tcp":
            pl.datagrams = c.frames        # channel 0, in arrival order
            resp = await c.request("SETUP", uri + "/trackID=1", {
                "transport": "RTP/AVP/TCP;unicast;interleaved=0-1",
                **pl.ask})
            pl.ssrc = rtsp.TransportSpec.parse(resp.headers["transport"]).ssrc
            check(pl.ssrc is not None, "TCP SETUP reply names no ssrc")
            await play(pl, resp)
            return
        rtp_sock = _udp_socket()
        rtp_tr, _ = await asyncio.get_running_loop() \
            .create_datagram_endpoint(lambda: _Callback(pl.on_rtp),
                                      sock=rtp_sock)
        pl.rtcp_tr = await _udp_endpoint(None)
        c._udp += [rtp_tr, pl.rtcp_tr]
        a, b = (x.get_extra_info("sockname")[1] for x in (rtp_tr, pl.rtcp_tr))
        hdr = {"transport": f"RTP/AVP;unicast;client_port={a}-{b}",
               **pl.ask}
        if pl.kind == "fec":
            hdr["x-fec"] = "parity"
        elif pl.kind == "reliable":
            hdr["x-retransmit"] = "our-retransmit"
        resp = await c.request("SETUP", uri + "/trackID=1", hdr)
        t = rtsp.TransportSpec.parse(resp.headers["transport"])
        check(t.ssrc is not None and t.server_port is not None,
              "UDP SETUP reply names no ssrc or server_port")
        pl.ssrc = t.ssrc
        pl.server_rtcp = ("127.0.0.1", t.server_port[1])
        if pl.kind == "fec":
            grant = resp.headers.get("x-fec", "")
            m = re.fullmatch(r"parity;pt=(\d+);rtx-pt=(\d+)", grant)
            check(m is not None, f"x-FEC grant {grant!r}")
            pl.rx = FecReceiver(media_pt=96, fec_pt=int(m.group(1)),
                                rtx_pt=int(m.group(2)))
        elif pl.kind == "reliable":
            check(resp.headers.get("x-retransmit") == "our-retransmit",
                  "x-Retransmit was not granted")
        await play(pl, resp)

    async def play(pl: _LossyPlayer, setup) -> None:
        pl.grants = {k: setup.headers[k] for k in ("x-fec", "x-retransmit")
                     if k in setup.headers}
        before = pushed
        resp = await pl.client.request("PLAY", uri)
        pl.allowed = gop_heads(before, pushed, gop)
        info = resp.headers["rtp-info"]
        pl.set_origin(int(re.search(r"seq=(\d+)", info).group(1)),
                      int(re.search(r"rtptime=(\d+)", info).group(1)))
        pl.joined_at = time.monotonic()
        if joined is not None:
            joined.set()

    def first_index(pl: _LossyPlayer, first: bytes | None) -> int | None:
        if first is None:
            return None
        return next((i for i in pl.allowed if sent[i][12:] == first[12:]),
                    None)

    def done(pl: _LossyPlayer) -> bool:
        if pl.seq0 is None:
            return False
        if pl.kind in ("plain", "tcp"):
            i0 = first_index(pl, pl.datagrams[0] if pl.datagrams else None)
            return i0 is not None and len(pl.datagrams) >= len(sent) - i0
        i0 = first_index(pl, pl.first)
        return i0 is not None and len(pl.held) >= len(sent) - i0

    stop = asyncio.Event()

    async def ticker() -> None:
        last_rr = 0.0
        while not stop.is_set():
            now = time.monotonic()
            rr_due = now - last_rr >= rr_every_s
            if rr_due:
                last_rr = now
            for pl in av:
                if pl.seq0 is None or pl.kind in ("plain", "tcp"):
                    continue
                if rr_due:
                    pl.send_rtcp(receiver_report(
                        pl.reporter, pl.ssrc,
                        FEC_LOSS_FRACTION if pl.kind == "fec" else 0, 0))
                if pl.kind == "fec":
                    due = pl.nack_due(now)
                    if due:
                        pl.nacks += 1
                        pl.nacked_seqs += len(due)
                        pl.send_rtcp(rtcp.GenericNack.from_seqs(
                            pl.reporter, pl.ssrc,
                            [(pl.seq0 + j) & 0xFFFF for j in due])
                            .to_bytes())
            try:
                await asyncio.wait_for(stop.wait(), 0.05)
            except asyncio.TimeoutError:
                pass

    tick = asyncio.create_task(ticker())
    waiting = list(av)
    joins: list[asyncio.Task] = []
    t_start = time.monotonic()
    try:
        for f, i in enumerate(range(0, len(sent), packets_per_frame)):
            delay = t_start + f * frame_interval_s - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            if i >= gop and waiting:
                joins.append(asyncio.create_task(join(waiting.pop(0))))
            for pkt in sent[i:i + packets_per_frame]:
                pusher.push(pkt)
            pushed += len(sent[i:i + packets_per_frame])
        for pl in waiting:                      # joiners the frames outran
            joins.append(asyncio.create_task(join(pl)))
        await asyncio.gather(*joins)
        push_s = time.monotonic() - t_start
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline and not all(map(done, av)):
            for pl in av:
                if pl.kind == "fec" and pl.end is None:
                    i0 = first_index(pl, pl.first)
                    if i0 is not None:
                        pl.note_end(len(sent) - i0)
            await asyncio.sleep(0.1)
        settle_s = time.monotonic() - t_start - push_s
        stop.set()
        await tick
        res = _check_lossy(av, sent)
    finally:
        stop.set()
        if not tick.done():
            tick.cancel()
            try:
                await tick
            except asyncio.CancelledError:
                pass
        for pl in av:
            if pl.client._task is not None:
                await pl.client.close()
        await pusher.close()
    res.update(players=len(av), packets_pushed=len(sent), push_s=push_s,
               settle_s=settle_s)
    return res


class _Callback(asyncio.DatagramProtocol):
    """Hands each datagram to ``fn``."""

    def __init__(self, fn):
        self.fn = fn

    def datagram_received(self, data, addr):
        self.fn(data)


def _check_lossy(av: list[_LossyPlayer], sent: list[bytes]) -> dict:
    delivered = {"plain": 0, "tcp": 0, "fec": 0, "reliable": 0}
    fec_players, reliable_players = [], []
    for pl in av:
        who = f"player {pl.index} ({pl.kind})"
        if pl.kind in ("plain", "tcp"):
            have = dict(enumerate(pl.datagrams))
        else:
            have = pl.span()
        first = have.get(0)
        i0 = next((i for i in pl.allowed
                   if first is not None and sent[i][12:] == first[12:]), None)
        check(i0 is not None, f"{who}: no packet at its RTP-Info seq, or "
              f"one that is not the IDR at packet "
              f"{' or '.join(map(str, pl.allowed))}")
        n = len(sent) - i0
        check(sorted(have) == list(range(n)),
              f"{who}: {len(have)} packets held of the {n} of its span "
              f"(missing {[j for j in range(n) if j not in have][:8]})")
        src_ts0 = rtp.peek_timestamp(sent[i0])
        for j in range(n):
            src = sent[i0 + j]
            check(have[j] == _oracle(src, pl.seq0 + j,
                                     pl.ts0 + rtp.peek_timestamp(src)
                                     - src_ts0, pl.ssrc),
                  f"{who}: packet {j} differs from the oracle's bytes")
        delivered[pl.kind] += n
        if pl.kind == "fec":
            def idx(d):
                return {(e - pl.seq0) & 0xFFFF for e in d}
            media = idx(pl.rx.media)
            parity = idx(pl.rx.recovered) - media
            fec_players.append({
                "index": pl.index, "packets": n, "dropped": pl.dropped,
                "parity": len(parity),
                "rtx": len(idx(pl.rx.rtx_restored) - media - parity),
                "nacks": pl.nacks, "nacked_seqs": pl.nacked_seqs,
                "pts": dict(pl.pts)})
        elif pl.kind == "reliable":
            reliable_players.append({
                "index": pl.index, "packets": n, "dropped": pl.dropped,
                "duplicates": pl.duplicates, "acks": pl.acks})
    return {"delivered": delivered, "fec_players": fec_players,
            "reliable_players": reliable_players,
            "grants": [{"index": pl.index, "kind": pl.kind, "ask": pl.ask,
                        "grants": pl.grants} for pl in av if pl.ask]}
