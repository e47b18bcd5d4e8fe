"""End-to-end check of a running relay server over loopback RTSP.

``push_play`` plays pushers (ANNOUNCE → SETUP record → RECORD, then
``$``-framed RTP) and interleaved TCP players (DESCRIBE → SETUP → PLAY)
against a server on ``127.0.0.1:port`` and holds every relayed packet to
what was pushed: each player receives every packet from its fast-start
keyframe on, the payload is bit-equal from byte 12, seq is contiguous from
the RTP-Info seq, ts is offset by the RTP-Info rtptime, and each player
sees one SSRC.  Any failure raises ``AssertionError``.

``serve_and_check`` starts ``python -m easydarwin_tpu_torch`` on free
ports (``CliServer``), runs ``push_play`` against it, stops it with
SIGTERM and checks the stats it prints at exit.
"""

from __future__ import annotations

import asyncio
import json
import re
import signal
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


class MiniClient:
    """Just enough RTSP over TCP for a pusher or an interleaved player."""

    def __init__(self):
        self.wire = rtsp.RtspWireReader(parse_responses=True)
        self.responses: asyncio.Queue = asyncio.Queue()
        self.frames: list[bytes] = []
        self.cseq = 0
        self.session = None
        self._task = None

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
        self.writer.close()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, ConnectionError):
                pass


async def push_play(port: int, rng: np.random.Generator, *, n_push: int,
                    n_play: int, gops: int = 4, frames: int = 5,
                    deadline_s: float = 20.0) -> dict:
    """Push ``gops`` paced GOPs from each of ``n_push`` sources; after the
    first GOP, ``n_play`` players join each source.  Returns counts."""
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
                                    packets_per_frame=4)
        pushers.append((c, uri))
        sent.append(pkts)
    head = frames * 4                          # the first GOP
    for (c, _), pkts in zip(pushers, sent):
        for pkt in pkts[:head]:
            c.push(pkt)
    await asyncio.sleep(0.3)
    players = []
    for k, (_, uri) in enumerate(pushers):
        for _ in range(n_play):
            p = MiniClient()
            await p.connect(port)
            await p.request("DESCRIBE", uri)
            await p.request("SETUP", uri + "/trackID=1", {
                "transport": "RTP/AVP/TCP;unicast;interleaved=0-1"})
            resp = await p.request("PLAY", uri)
            info = resp.headers["rtp-info"]
            seq0 = int(re.search(r"seq=(\d+)", info).group(1))
            ts0 = int(re.search(r"rtptime=(\d+)", info).group(1))
            players.append((p, k, seq0, ts0))
    for i in range(head, len(sent[0])):        # the live part, paced
        for (c, _), pkts in zip(pushers, sent):
            c.push(pkts[i])
        await asyncio.sleep(0.005)
    deadline = time.monotonic() + deadline_s
    while (any(len(p.frames) < len(sent[k]) for p, k, _, _ in players)
           and time.monotonic() < deadline):
        await asyncio.sleep(0.05)
    for p, k, seq0, ts0 in players:
        got, want = p.frames, sent[k]
        check(len(got) == len(want), f"player of cam{k}: {len(got)} of "
              f"{len(want)} packets (fast start is the first IDR)")
        check(len({rtp.peek_ssrc(g) for g in got}) == 1,
              "a player saw more than one SSRC")
        src_ts0 = rtp.peek_timestamp(want[0])
        for i, (g, s) in enumerate(zip(got, want)):
            check(g[:2] == s[:2] and g[12:] == s[12:],
                  f"cam{k} packet {i}: payload differs from byte 12 on")
            check(rtp.peek_seq(g) == (seq0 + i) & 0xFFFF,
                  f"cam{k} packet {i}: seq not contiguous from RTP-Info")
            check(rtp.peek_timestamp(g)
                  == (ts0 + rtp.peek_timestamp(s) - src_ts0) & 0xFFFFFFFF,
                  f"cam{k} packet {i}: ts not offset by RTP-Info rtptime")
    for p, *_ in players:
        await p.close()
    for c, _ in pushers:
        await c.close()
    return {"pushers": n_push, "players": len(players),
            "packets_per_player": len(sent[0])}


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
                          n_push: int, n_play: int,
                          deadline_s: float = 20.0) -> dict:
    """``push_play`` against the CLI server on ``device``; adds the
    server's exit stats (pump errors and oracle mismatches must be 0)."""
    async with CliServer(device) as srv:
        res = await push_play(srv.rtsp_port, rng, n_push=n_push,
                              n_play=n_play, deadline_s=deadline_s)
        res["server_stats"] = await srv.stop()
        return res
