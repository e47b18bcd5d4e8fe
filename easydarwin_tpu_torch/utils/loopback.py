"""End-to-end check of a running relay server over loopback RTSP.

``push_play`` plays pushers (ANNOUNCE → SETUP record → RECORD, then
``$``-framed RTP) and players (DESCRIBE → SETUP → PLAY) against a server
on ``127.0.0.1:port``: interleaved TCP players read ``$``-framed RTP from
the connection, UDP players (``client_port``) read datagrams on a port
pair of their own.  Every relayed packet is held to what was pushed: each
player receives every packet from its fast-start keyframe on — the newest
IDR pushed before its PLAY reply came back, or the next one where one was
pushed while PLAY was in flight — the payload is bit-equal from byte 12,
seq is contiguous from the RTP-Info seq, ts is offset by the RTP-Info
rtptime, and the SSRC is the one the SETUP reply named.  Any failure
raises ``AssertionError``.

``serve_and_check`` starts ``python -m easydarwin_tpu_torch`` on free
ports (``CliServer``), runs ``push_play`` against it, stops it with
SIGTERM and checks the stats it prints at exit.
"""

from __future__ import annotations

import asyncio
import json
import re
import signal
import socket
import sys
import time
from pathlib import Path

import numpy as np

from ..protocol import rtp, rtsp
from . import synth

VIDEO_SDP = ("v=0\r\no=- 1 1 IN IP4 127.0.0.1\r\ns=loopback\r\n"
             "c=IN IP4 0.0.0.0\r\nt=0 0\r\na=control:*\r\n"
             "m=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
             "a=control:trackID=1\r\n")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class _Datagrams(asyncio.DatagramProtocol):
    def __init__(self, sink: list | None):
        self.sink = sink

    def datagram_received(self, data, addr):
        if self.sink is not None:
            self.sink.append(data)


async def _udp_endpoint(sink: list | None):
    """A datagram endpoint on a free loopback port with a deep receive
    buffer (a fast-start burst must not overflow it)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    sock.bind(("127.0.0.1", 0))
    tr, _ = await asyncio.get_running_loop().create_datagram_endpoint(
        lambda: _Datagrams(sink), sock=sock)
    return tr


class MiniClient:
    """Just enough RTSP over TCP for a pusher, an interleaved player or a
    UDP player (``udp_ports`` opens its RTP/RTCP endpoints)."""

    def __init__(self):
        self.wire = rtsp.RtspWireReader(parse_responses=True)
        self.responses: asyncio.Queue = asyncio.Queue()
        self.frames: list[bytes] = []
        self.cseq = 0
        self.session = None
        self._task = None
        self._udp: list = []

    async def udp_ports(self) -> str:
        """Open the RTP (into ``frames``) and RTCP endpoints; returns the
        ``client_port=a-b`` value."""
        self._udp = [await _udp_endpoint(self.frames),
                     await _udp_endpoint(None)]
        a, b = (t.get_extra_info("sockname")[1] for t in self._udp)
        return f"{a}-{b}"

    async def connect(self, port: int) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", port)
        self._task = asyncio.create_task(self._read())

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
                else:
                    self.responses.put_nowait(ev)

    async def request(self, method: str, uri: str, headers=None,
                      body: bytes = b""):
        self.cseq += 1
        h = {"cseq": str(self.cseq), **(headers or {})}
        if self.session:
            h["session"] = self.session
        self.writer.write(rtsp.RtspRequest(method, uri, h, body).to_bytes())
        resp = await asyncio.wait_for(self.responses.get(), 30)
        check(resp.status == 200, f"{method} {uri} -> {resp.status}")
        if "session" in resp.headers:
            self.session = resp.headers["session"].split(";")[0]
        return resp

    def push(self, pkt: bytes) -> None:
        self.writer.write(rtsp.frame_interleaved(0, pkt))

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


async def push_play(port: int, rng: np.random.Generator, *, n_push: int,
                    n_play: int, transport: str = "tcp", gops: int = 4,
                    frames: int = 5, packets_per_frame: int = 4,
                    body_len=(40, 400), frame_interval_s: float = 0.02,
                    join_every: int = 0, deadline_s: float = 20.0) -> dict:
    """Push ``gops`` GOPs of ``frames`` frames from each of ``n_push``
    sources, one frame each ``frame_interval_s``; ``n_play`` players of
    ``transport`` (``tcp`` or ``udp``) join each source after the first
    GOP, or — with ``join_every`` — one every ``join_every`` frames of the
    live part.  Returns counts."""
    gop = frames * packets_per_frame           # packets a GOP; IDR first
    pushers, sent = [], []
    for k in range(n_push):
        c = MiniClient()
        await c.connect(port)
        uri = f"rtsp://127.0.0.1:{port}/live/cam{k}"
        await c.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                        VIDEO_SDP.encode())
        await c.request("SETUP", uri + "/trackID=1", {
            "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"})
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

    def push(k: int, pkts: list[bytes]) -> None:
        for pkt in pkts:
            pushers[k][0].push(pkt)
        pushed[k] += len(pkts)

    def starts(before: int, after: int) -> range:
        """The fast-start points a PLAY may get: the GOP heads from the
        newest one pushed before the request to the newest one pushed by
        the time of its reply."""
        return range((before - 1) // gop * gop, (after - 1) // gop * gop + 1,
                     gop)

    async def join(k: int) -> None:
        uri = pushers[k][1]
        p = MiniClient()
        await p.connect(port)
        await p.request("DESCRIBE", uri)
        spec = "RTP/AVP/TCP;unicast;interleaved=0-1"
        if transport == "udp":
            spec = f"RTP/AVP;unicast;client_port={await p.udp_ports()}"
        resp = await p.request("SETUP", uri + "/trackID=1",
                               {"transport": spec})
        t = rtsp.TransportSpec.parse(resp.headers["transport"])
        check(t.ssrc is not None, "SETUP reply names no ssrc")
        check(transport == "tcp" or t.server_port is not None,
              "UDP SETUP reply names no server_port")
        before = pushed[k]
        resp = await p.request("PLAY", uri)
        info = resp.headers["rtp-info"]
        seq0 = int(re.search(r"seq=(\d+)", info).group(1))
        ts0 = int(re.search(r"rtptime=(\d+)", info).group(1))
        players.append((p, k, seq0, ts0, t.ssrc,
                        starts(before, pushed[k])))

    for k in range(n_push):                    # the first GOP
        push(k, sent[k][:gop])
    await asyncio.sleep(0.3)
    if not join_every:
        for k in joins:
            await join(k)
        joins = []
    for f, i in enumerate(range(gop, len(sent[0]), packets_per_frame)):
        if join_every and joins and f % join_every == 0:
            await join(joins.pop(0))
        for k in range(n_push):
            push(k, sent[k][i:i + packets_per_frame])
        await asyncio.sleep(frame_interval_s)
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

    deadline = time.monotonic() + deadline_s
    while (time.monotonic() < deadline
           and any(want(j) is None or len(players[j][0].frames)
                   < len(want(j)) for j in range(len(players)))):
        await asyncio.sleep(0.05)
    delivered = 0
    for j, (p, k, seq0, ts0, ssrc, allowed) in enumerate(players):
        got, w = p.frames, want(j)
        check(w is not None, f"{transport} player of cam{k}: no packet, or "
              f"a first packet that is not the IDR at packet "
              f"{' or '.join(map(str, allowed))}, the newest pushed before "
              f"its PLAY reply")
        check(len(got) == len(w), f"{transport} player of cam{k}: "
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
    for p, *_ in players:
        await p.close()
    for c, _ in pushers:
        await c.close()
    return {"pushers": n_push, "players": len(players),
            "transport": transport, "packets_per_player": len(sent[0]),
            "delivered": delivered}


class CliServer:
    """``python -m easydarwin_tpu_torch`` on free loopback ports, as an
    async context manager: ``rtsp_port`` and ``rest_port`` are set once
    it listens; ``stop()`` sends SIGTERM and returns the stats it prints
    at exit (a server still running at exit is killed)."""

    def __init__(self, device: str):
        self.device = device
        self.proc = None
        self.rtsp_port = self.rest_port = None

    async def __aenter__(self) -> "CliServer":
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "easydarwin_tpu_torch", "-p", "0",
            "--service-port", "0", "--bind-ip", "127.0.0.1",
            "--device", self.device,
            cwd=Path(__file__).resolve().parents[2],
            stdout=asyncio.subprocess.PIPE)
        try:
            line = (await asyncio.wait_for(self.proc.stdout.readline(),
                                           60)).decode()
            m = re.search(r"listening: rtsp://[\d.]+:(\d+) service "
                          r"http://[\d.]+:(\d+)", line)
            check(m is not None, f"server did not start: {line!r}")
        except BaseException:
            await self.__aexit__(None, None, None)
            raise
        self.rtsp_port, self.rest_port = int(m.group(1)), int(m.group(2))
        return self

    async def stop(self) -> dict:
        """SIGTERM, then the exit stats; pump errors and oracle mismatches
        must be 0."""
        self.proc.send_signal(signal.SIGTERM)
        out, _ = await asyncio.wait_for(self.proc.communicate(), 60)
        check(self.proc.returncode == 0,
              f"server exited {self.proc.returncode}")
        stats = json.loads(out.decode().split("stats ", 1)[1])
        check(stats["pump_errors"] == 0, f"server pump errors: {stats}")
        check(stats["megabatch"]["mismatches"] == 0,
              f"server scheduler mismatches: {stats}")
        return stats

    async def __aexit__(self, *exc) -> None:
        if self.proc is not None and self.proc.returncode is None:
            self.proc.kill()
            await self.proc.wait()


async def serve_and_check(device: str, rng: np.random.Generator, *,
                          n_push: int, n_play: int, **kw) -> dict:
    """``push_play`` (``kw`` passed on) against the CLI server on
    ``device``; adds the server's exit stats (pump errors and oracle
    mismatches must be 0)."""
    async with CliServer(device) as srv:
        res = await push_play(srv.rtsp_port, rng, n_push=n_push,
                              n_play=n_play, **kw)
        res["server_stats"] = await srv.stop()
        return res
