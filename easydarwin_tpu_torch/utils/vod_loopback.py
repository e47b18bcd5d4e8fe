"""End-to-end checks of file playback (VOD) and the recorder over loopback.

Every delivered packet is held to the cold path: ``cold_packets`` runs the
``FileSession`` packetizers over every sample of a clip (ssrc 0, seq 0),
and a player's packet ``j`` after its first must equal packet ``k0 + j``
of that list (``k0`` the first packet of the sample its PLAY seeked to)
with the player's SSRC, seq ``seq0 + j`` and, under Scale, the timestamp
divided by the scale.  Keyed by seq, so a datagram a full receive buffer
dropped shows as a gap (``lost``), never as a mismatch.

* ``vod_in_process`` drives the group pacer, the megabatch scheduler and
  one ``FanoutEngine`` a stream over loopback UDP receivers in one
  process (the pump's wake, written out), with every join primed on the
  device from the cache's resident windows.
* ``play_vod`` plays a clip from a running server (``python -m
  easydarwin_tpu_torch --movie-folder``) to players of several kinds:
  UDP from npt 0, with a Range, with Scale 2, with a PAUSE and a PLAY
  with a Range, interleaved TCP, x-Retransmit (acking every datagram)
  and one whose SETUP asks for x-FEC (which a file session does not
  grant).  The DESCRIBE SDP, Range and RTP-Info are held to what the
  cold path computes.
* ``record_via_rest`` pushes packets to a server while REST
  ``startrecord``/``stoprecord`` record them, and holds the file to what a
  ``RecorderOutput`` writes from the same packets in this process.

Any failure raises ``AssertionError``.
"""

from __future__ import annotations

import asyncio
import base64
import os
import re
import socket
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..protocol import rtp, rtsp, sdp
from ..relay.output import RelayOutput, WriteResult
from ..relay.reliable import build_ack
from ..vod.cache import SegmentCache, tracks_by_no
from ..vod.mp4 import open_shared
from ..vod.packetizer import AacPacketizer, H264Packetizer, sdp_for_file
from ..vod.record import RecorderOutput
from ..vod.session import VodPacerGroup, seek_index
from .loopback import (MiniClient, _drain, _udp_socket, check,
                       http_get_json, udp_rcvbuf_errors)


# ------------------------------------------------------------- the oracle
@dataclass
class ColdTrack:
    """The cold path's packets of one track: bytes, and each packet's
    sample; ``first[i]`` is the first packet of sample ``i``."""
    track: object
    packets: list = field(default_factory=list)
    sample: list = field(default_factory=list)
    first: list = field(default_factory=list)


def cold_packets(path: str) -> dict[int, ColdTrack]:
    """track_no → the ``FileSession`` packetizers' packets of every sample
    (ssrc 0, seq from 0)."""
    f = open_shared(path)
    out = {}
    try:
        for tno, tr in tracks_by_no(f).items():
            cls = H264Packetizer if tr.info.handler == "vide" \
                else AacPacketizer
            pk = cls(tr, ssrc=0, seq_start=0)
            ct = ColdTrack(tr)
            for i in range(tr.n_samples):
                ct.first.append(len(ct.packets))
                for p in pk.packetize_sample(f.read_sample(tr, i), i):
                    ct.packets.append(p)
                    ct.sample.append(i)
            out[tno] = ct
    finally:
        f.close()
    return out


def expected_packet(ct: ColdTrack, k: int, *, ssrc: int, seq: int,
                    ts_scale: float = 1.0) -> bytes:
    """Cold packet ``k`` as a player with ``ssrc`` gets it at ``seq``."""
    p = ct.packets[k]
    ts = rtp.peek_timestamp(p)
    if ts_scale != 1.0:
        ts = int(ts / ts_scale) & 0xFFFFFFFF
    return rtp.rewrite_header(p, seq=seq, timestamp=ts, ssrc=ssrc)


def hold_to_cold(got: list[bytes], ct: ColdTrack, *, start_sample: int,
                 ssrc: int, seq0: int, ts_scale: float = 1.0,
                 resends: bool = False, who: str = "") -> dict:
    """Every datagram of ``got`` equal to its cold packet (by seq from
    ``seq0``; the first cold packet is that of ``start_sample``); a packet
    may arrive twice only with ``resends`` (a reliable player's resend).
    Returns ``received`` (distinct), ``span`` (highest index + 1),
    ``lost`` (gaps inside the span) and ``duplicates``."""
    k0 = ct.first[start_sample]
    seen = set()
    dups = 0
    for data in got:
        j = (rtp.peek_seq(data) - seq0) & 0xFFFF
        check(k0 + j < len(ct.packets),
              f"{who}: seq {rtp.peek_seq(data)} is past the clip's end")
        want = expected_packet(ct, k0 + j, ssrc=ssrc, seq=(seq0 + j) & 0xFFFF,
                               ts_scale=ts_scale)
        check(data == want, f"{who}: packet {j} from sample {start_sample} "
              f"differs from the cold path's")
        if j in seen:
            check(resends, f"{who}: packet {j} delivered twice")
            dups += 1
        seen.add(j)
    span = max(seen) + 1 if seen else 0
    return {"received": len(seen), "span": span, "lost": span - len(seen),
            "duplicates": dups}


# ------------------------------------------------------ in-process pacer
class _RxOutput(RelayOutput):
    """A player track whose RTP the engine's native scatter sends to
    ``native_addr``; RTCP is dropped."""

    def __init__(self, tx: socket.socket, addr, **kw):
        super().__init__(**kw)
        self.tx = tx
        self.native_addr = addr

    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        if not is_rtcp:
            try:
                self.tx.sendto(data, self.native_addr)
            except BlockingIOError:
                return WriteResult.WOULD_BLOCK
        return WriteResult.OK


@dataclass
class VodClip:
    """``players`` players of every track of the clip at ``path``, one
    joining each ``join_every`` frames of ``1 / fps`` seconds."""
    path: str
    players: int
    join_every: int = 1
    fps: int = 30


def _rx_socket() -> socket.socket:
    s = _udp_socket()
    s.setblocking(False)
    return s


def vod_in_process(device, clips: list[VodClip], *, run_s: float,
                   window_samples: int = 64, lookahead_ms: int = 500,
                   seed: int = 0) -> dict:
    """Play ``clips`` to their players for ``run_s`` seconds through the
    group pacer over a warm ``SegmentCache`` on ``device``, the megabatch
    scheduler and one ``FanoutEngine`` a stream, then hold every
    datagram to the cold path.  Returns what was counted."""
    from .. import native
    from ..relay.fanout import FanoutEngine
    from ..relay.megabatch import MegabatchScheduler

    rng = np.random.default_rng(seed)
    cache = SegmentCache(device=device, window_samples=window_samples)
    files = [open_shared(c.path) for c in clips]
    t0 = time.perf_counter()
    windows = sum(cache.warm_asset(f) for f in files)
    warm_s = time.perf_counter() - t0
    colds = [cold_packets(c.path) for c in clips]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)
    tx.setblocking(False)
    engines: dict[int, FanoutEngine] = {}
    #: the counters of engines whose streams retired
    dropped = {"native_sent": 0, "send_errors": 0}

    def engine_for(st):
        e = engines.get(id(st))
        if e is None:
            e = engines[id(st)] = FanoutEngine(egress_fd=tx.fileno(),
                                               device=device)
        return e

    def engine_drop(st):
        e = engines.pop(id(st), None)
        for k in dropped:
            dropped[k] += getattr(e, k, 0)

    sched = MegabatchScheduler(device=device)
    pacer = VodPacerGroup(cache, engine_for=engine_for,
                          engine_drop=engine_drop, scheduler=lambda: sched,
                          lookahead_ms=lookahead_ms)
    # the shapes of the prime's window calls, apart from the scheduler's
    shapes: dict[str, int] = {}
    in_prime = [False]
    sched_steps, prime_joined = sched._window_steps, pacer._prime_joined

    def window_steps(inputs):
        if in_prime[0]:
            key = " + ".join(f"[{w.shape[0]},{w.shape[1]},{w.shape[2]}]x"
                             f"[{s.shape[0]},{s.shape[1]},6]"
                             for w, s in inputs)
            shapes[key] = shapes.get(key, 0) + 1
        return sched_steps(inputs)

    def prime():
        in_prime[0] = True
        try:
            prime_joined()
        finally:
            in_prime[0] = False

    sched._window_steps = window_steps
    pacer._prime_joined = prime
    joins = sorted((j * c.join_every / c.fps, ci, j)
                   for ci, c in enumerate(clips) for j in range(c.players))
    players = []
    wake_ms = []
    rcvbuf0 = udp_rcvbuf_errors()
    core0 = native.get_stats() if native.loaded() else None
    start = time.monotonic()
    try:
        while True:
            now = time.monotonic()
            if now - start >= run_s:
                break
            t = int(now * 1000)
            while joins and joins[0][0] <= now - start:
                _, ci, j = joins.pop(0)
                outs, rxs = {}, {}
                for tno in colds[ci]:
                    rx = _rx_socket()
                    outs[tno] = _RxOutput(
                        tx, rx.getsockname(),
                        ssrc=int(rng.integers(1, 1 << 32)),
                        out_seq_start=int(rng.integers(1 << 16)))
                    rxs[tno] = (rx, [])
                sess = pacer.open(files[ci], outs, now_ms=t)
                players.append((ci, sess, outs, rxs))
            w0 = time.perf_counter()
            pairs = pacer.tick(t)
            engaged = len(pairs) >= 2
            if engaged:
                sched.begin_wake(pairs, t)
            else:
                sched.idle_wake()
            for st, e in pairs:
                e.megabatch_owned = engaged
                e.step(st, t)
            if engaged:
                sched.end_wake(pairs, t)
            if pairs:
                wake_ms.append((time.perf_counter() - w0) * 1e3)
            for _ci, _s, _o, rxs in players:
                for rx, sink in rxs.values():
                    _drain(rx, sink)
            time.sleep(0.001)
        for _ci, sess, _o, _r in players:
            sess.stop()
        sched.drain()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        time.sleep(0.2)
        res = {"windows_warmed": windows, "warm_s": warm_s,
               "players": len(players), "datagrams": 0, "lost": 0,
               "sent": 0}
        for ci, _sess, outs, rxs in players:
            for tno, out in outs.items():
                rx, sink = rxs[tno]
                _drain(rx, sink)
                rx.close()
                got = hold_to_cold([d for _t, d in sink], colds[ci][tno],
                                   start_sample=0,
                                   ssrc=out.rewrite.ssrc,
                                   seq0=out.rewrite.out_seq_start,
                                   who=f"clip {ci} player track {tno}")
                check(got["span"] <= (out.bookmark or 0),
                      "a player received more than its output sent")
                res["datagrams"] += got["received"]
                res["sent"] += out.bookmark or 0
                res["lost"] += (out.bookmark or 0) - got["received"]
        res["udp_rcvbuf_errors"] = udp_rcvbuf_errors() - rcvbuf0
        if core0 is not None:
            core = native.get_stats()
            res["egress"] = {k: core[k] - core0[k] for k in (
                "sendmmsg_calls", "send_packets", "send_ns")}
        st = pacer.stats()
        cs = cache.stats()
        res.update(
            pacer=st, cache=cs, scheduler=sched.stats(),
            prime_shapes=shapes,
            joins=sum(len(o) for _c, _s, o, _r in players),
            windows_touched=sum(1 for w in cache._lru.values() if w.hits),
            native_sent=dropped["native_sent"] + sum(
                e.native_sent for e in engines.values()),
            send_errors=dropped["send_errors"] + sum(
                e.send_errors for e in engines.values()))
        res["wake_ms_sum"] = sum(wake_ms)
        wake_ms.sort()
        res["wake_ms_p50"] = wake_ms[len(wake_ms) // 2] if wake_ms else None
        res["wake_ms_max"] = wake_ms[-1] if wake_ms else None
        return res
    finally:
        pacer.close()
        cache.close()
        tx.close()
        for f in files:
            f.close()


# ---------------------------------------------------------- a CLI server
def player_kinds(range_npt: float, pause_at: float) -> dict[str, dict]:
    """What each kind of player asks for: its PLAY and SETUP headers,
    interleaved TCP, and a PAUSE ``pause_at`` seconds into its play
    followed by a PLAY with ``Range: npt=pause_at-``."""
    return {
        "plain": {},
        "range": {"play": {"range": f"npt={range_npt:g}-"}},
        "scale": {"play": {"scale": "2"}},
        "pause": {"pause_at": pause_at, "replay": f"npt={pause_at:g}-"},
        "tcp": {"tcp": True},
        "retransmit": {"setup": {"x-retransmit": "our-retransmit"}},
        "fec": {"setup": {"x-fec": "parity"}},
    }


class _VodPlayer:
    """One player of every track of a file: its RTSP connection and, per
    track, its datagrams (or interleaved packets) with arrival times."""

    def __init__(self, index: int, kind: str, spec: dict):
        self.index = index
        self.kind = kind
        self.spec = spec
        self.c = MiniClient()
        self.tracks: dict[int, dict] = {}
        self.replies: list[dict] = []     # per PLAY: Range, RTP-Info, when
        self.pause_reply_at: float | None = None
        self.acks = 0

    def drain(self, tid: int) -> None:
        """Read every datagram waiting on track ``tid``'s RTP socket, all
        stamped with one clock reading; a reliable player acks each."""
        tr = self.tracks[tid]
        sock = tr.get("rtp_sock")
        now = time.monotonic()
        while sock is not None:
            try:
                data = sock.recv(65536)
            except BlockingIOError:
                return
            tr["got"].append((now, data))
            if self.kind == "retransmit":
                tr["rtcp_sock"].sendto(
                    build_ack(tr["ssrc"], rtp.peek_seq(data)),
                    tr["server_rtcp"])
                self.acks += 1

    async def setup(self, port: int, uri: str, n_tracks: int) -> dict:
        """DESCRIBE and SETUP every track; returns the DESCRIBE SDP and
        each SETUP's extension headers."""
        await self.c.connect(port)
        desc = await self.c.request("DESCRIBE", uri,
                                    {"accept": "application/sdp"})
        grants = {}
        for tid in range(1, n_tracks + 1):
            tr = {"got": []}
            self.tracks[tid] = tr
            if self.spec.get("tcp"):
                ch = 2 * (tid - 1)
                spec = f"RTP/AVP/TCP;unicast;interleaved={ch}-{ch + 1}"
            else:
                # a plain socket drained whole at each readiness event
                # (``drain``): one asyncio callback a datagram would
                # starve the TCP players' reads
                tr["rtp_sock"], tr["rtcp_sock"] = _rx_socket(), _rx_socket()
                asyncio.get_running_loop().add_reader(
                    tr["rtp_sock"].fileno(), self.drain, tid)
                a = tr["rtp_sock"].getsockname()[1]
                b = tr["rtcp_sock"].getsockname()[1]
                spec = f"RTP/AVP;unicast;client_port={a}-{b}"
            resp = await self.c.request(
                "SETUP", f"{uri}/trackID={tid}",
                {"transport": spec, **self.spec.get("setup", {})})
            t = rtsp.TransportSpec.parse(resp.headers["transport"])
            check(t.ssrc is not None, "a VOD SETUP reply names no ssrc")
            tr["ssrc"] = t.ssrc
            if t.server_port is not None:
                tr["server_rtcp"] = ("127.0.0.1", t.server_port[1])
            grants[tid] = {k: v for k, v in resp.headers.items()
                           if k.startswith("x-")}
        return {"sdp": desc.body.decode(), "grants": grants}

    async def play(self, uri: str, headers: dict) -> None:
        resp = await self.c.request("PLAY", uri, headers)
        self.replies.append({"range": resp.headers.get("range"),
                             "scale": resp.headers.get("scale"),
                             "rtp_info": resp.headers.get("rtp-info", ""),
                             "at": time.monotonic()})

    async def pause(self, uri: str) -> None:
        await self.c.request("PAUSE", uri)
        # datagrams the server sent before it stopped may still wait in
        # this loop; whatever arrives by the boundary is the first PLAY's
        await asyncio.sleep(0.3)
        self.pause_reply_at = time.monotonic()

    def packets(self, tid: int, segment: int) -> list[bytes]:
        """The track's packets of PLAY ``segment`` (0, or 1 after a
        PAUSE)."""
        if self.spec.get("tcp"):
            ch = 2 * (tid - 1)
            got = self.c.channels.get(ch, [])
        else:
            got = self.tracks[tid]["got"]
        if self.pause_reply_at is None:
            return [d for _t, d in got]
        if segment == 0:
            return [d for t, d in got if t <= self.pause_reply_at]
        return [d for t, d in got if t > self.pause_reply_at]

    async def close(self) -> None:
        for tid, tr in self.tracks.items():
            if "rtp_sock" in tr:
                asyncio.get_running_loop().remove_reader(
                    tr["rtp_sock"].fileno())
                self.drain(tid)
                tr["rtp_sock"].close()
                tr["rtcp_sock"].close()
        await self.c.close()


async def play_vod(port: int, folder: str, name: str, kinds: list[str], *,
                   join_every_s: float = 1 / 30, run_s: float = 8.0,
                   range_npt: float = 10.0, pause_at: float = 3.0,
                   cold=None) -> dict:
    """Play ``folder/name`` from the server on ``port`` to one player of
    each kind in ``kinds`` (``player_kinds``; joining one each
    ``join_every_s``) for ``run_s`` seconds from the first join, then hold
    every player to the cold path.  Returns counts per kind."""
    specs = player_kinds(range_npt, pause_at)
    path = os.path.join(folder, name)
    cold = cold or cold_packets(path)
    f = open_shared(path)
    want_sdp = sdp.build(sdp_for_file(f, name=name))
    by_no = tracks_by_no(f)
    f.close()
    uri = f"rtsp://127.0.0.1:{port}/{name}"
    players: list[_VodPlayer] = []
    start = time.monotonic()
    tasks = []

    async def run_player(pl: _VodPlayer) -> None:
        got = await pl.setup(port, uri, len(by_no))
        check(got["sdp"] == want_sdp, "DESCRIBE differs from the file's SDP")
        for tid, g in got["grants"].items():
            check("x-fec" not in g, "a VOD SETUP was granted x-FEC")
            if pl.kind == "retransmit":
                check(g.get("x-retransmit") == "our-retransmit",
                      f"x-Retransmit not echoed: {g}")
        await pl.play(uri, pl.spec.get("play", {}))
        if "pause_at" in pl.spec:
            await asyncio.sleep(pl.spec["pause_at"])
            await pl.pause(uri)
            await pl.play(uri, {"range": pl.spec["replay"]})

    for i, kind in enumerate(kinds):
        pl = _VodPlayer(i, kind, specs[kind])
        players.append(pl)
        tasks.append(asyncio.create_task(run_player(pl)))
        await asyncio.sleep(join_every_s)
    await asyncio.gather(*tasks)
    await asyncio.sleep(max(run_s - (time.monotonic() - start), 0.0))
    for pl in players:
        await pl.c.request("TEARDOWN", uri)
    await asyncio.sleep(0.3)
    for pl in players:
        for tid in pl.tracks:
            pl.drain(tid)
    res = {"players": len(players), "by_kind": {}}
    for pl in players:
        segments = [("npt=0-" if not pl.spec.get("play") else
                     pl.spec["play"].get("range", "npt=0-"))]
        if "replay" in pl.spec:
            segments.append(pl.spec["replay"])
        scale = float(pl.spec.get("play", {}).get("scale", 1.0))
        row = res["by_kind"].setdefault(
            pl.kind, {"players": 0, "datagrams": 0, "lost": 0, "acks": 0,
                      "duplicates": 0})
        row["players"] += 1
        row["acks"] += pl.acks
        for seg, rng_hdr in enumerate(segments):
            reply = pl.replies[seg]
            npt = float(rng_hdr[4:].split("-")[0] or 0.0)
            check(reply["range"] == f"npt={npt:.3f}-",
                  f"{pl.kind}: Range {reply['range']!r} for {rng_hdr}")
            check(reply["scale"] == ("2" if scale != 1.0 else None),
                  f"{pl.kind}: Scale reply {reply['scale']!r}")
            seqs = [int(s) for s in re.findall(r";seq=(\d+)",
                                               reply["rtp_info"])]
            urls = re.findall(r"url=([^;]+);", reply["rtp_info"])
            check(urls == [f"{uri}/trackID={t}" for t in by_no],
                  f"{pl.kind}: RTP-Info {reply['rtp_info']!r}")
            for (tid, ct), seq0 in zip(cold.items(), seqs):
                pkts = pl.packets(tid, seg)
                check(pkts, f"{pl.kind} player {pl.index} track {tid} "
                      f"segment {seg}: nothing received")
                start_sample = seek_index(ct.track, npt)
                got = hold_to_cold(
                    pkts, ct, start_sample=start_sample,
                    ssrc=pl.tracks[tid]["ssrc"], seq0=seq0, ts_scale=scale,
                    resends=pl.kind == "retransmit",
                    who=f"{pl.kind} player {pl.index} track {tid}")
                # a TCP stream loses nothing but what the server's TCP
                # rung sheds from a reader half its ring behind (the
                # caller holds its gaps to ``tcp_shed_pkts``), a shed
                # before the first packet included
                row["datagrams"] += got["received"]
                row["lost"] += got["lost"]
                row["duplicates"] += got["duplicates"]
        await pl.close()
    return res


# ----------------------------------------------------------- the recorder
def sprop_sdp(sps: bytes, pps: bytes) -> str:
    """A pusher's H.264 SDP naming its parameter sets (a recorder seeds its
    MP4's avcC from them)."""
    props = ",".join(base64.b64encode(x).decode() for x in (sps, pps))
    return ("v=0\r\no=- 1 1 IN IP4 127.0.0.1\r\ns=record\r\n"
            "c=IN IP4 0.0.0.0\r\nt=0 0\r\na=control:*\r\n"
            "m=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
            f"a=fmtp:96 packetization-mode=1;sprop-parameter-sets={props}"
            "\r\na=control:trackID=1\r\n")


async def record_via_rest(port: int, rest_port: int, folder: str,
                          packets: list[bytes], *, sps: bytes, pps: bytes,
                          frame_s: float, packets_per_frame: int,
                          path: str = "/live/rec",
                          file: str = "rec.mp4") -> dict:
    """Push ``packets`` (``packets_per_frame`` a frame, one frame each
    ``frame_s``) to ``path`` with REST ``startrecord`` before the first and
    ``stoprecord`` after the last; the file must equal what a
    ``RecorderOutput`` seeded with the same parameter sets writes from the
    same packets here, and read back through ``Mp4File``."""
    from ..vod.mp4 import Mp4File
    c = MiniClient()
    await c.connect(port)
    uri = f"rtsp://127.0.0.1:{port}{path}"
    await c.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                    sprop_sdp(sps, pps).encode())
    await c.request("SETUP", uri + "/trackID=1", {
        "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"})
    await c.request("RECORD", uri)
    st, doc = await http_get_json(rest_port,
                                  f"/api/v1/startrecord?path={path}"
                                  f"&file={file}")
    check(st == 200, f"startrecord: {st} {doc}")
    t0 = time.monotonic()
    for i in range(0, len(packets), packets_per_frame):
        for p in packets[i:i + packets_per_frame]:
            c.push(p)
        await asyncio.sleep(max(t0 + (i // packets_per_frame + 1) * frame_s
                                - time.monotonic(), 0.0))
    await asyncio.sleep(0.5)
    st, doc = await http_get_json(rest_port,
                                  f"/api/v1/stoprecord?path={path}")
    check(st == 200, f"stoprecord: {st} {doc}")
    await c.close()
    got_path = os.path.join(folder, file)
    want_path = os.path.join(folder, "expected_" + file)
    rec = RecorderOutput(want_path)
    rec.depack.sps, rec.depack.pps = sps, pps
    for p in packets:
        rec.send_bytes(p, is_rtcp=False)
    want = rec.finish()
    with open(got_path, "rb") as a, open(want_path, "rb") as b:
        got_bytes, want_bytes = a.read(), b.read()
    check(got_bytes == want_bytes, f"the recorded MP4 ({len(got_bytes)} B) "
          f"differs from the CPU recorder's ({len(want_bytes)} B)")
    f = Mp4File(got_path)
    v = f.video_track()
    check(v is not None and v.n_samples == want["samples"]
          and v.info.sps == [sps] and v.info.pps == [pps],
          "the recorded MP4's tables do not read back")
    res = {"samples": v.n_samples, "bytes": len(got_bytes),
           "sync_samples": int(v.sync.sum()),
           "rest_samples": doc["EasyDarwin"]["Body"]["Samples"]}
    f.close()
    check(res["rest_samples"] == str(res["samples"]),
          f"stoprecord reported {res['rest_samples']} samples")
    return res
