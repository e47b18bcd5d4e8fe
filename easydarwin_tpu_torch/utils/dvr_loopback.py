"""End-to-end check of DVR, time-shift and the erasure-coded store over
loopback, against ``python -m easydarwin_tpu_torch --dvr-enabled 1
--storage-enabled 1``.

``dvr_session`` plays one recording through two server processes:

1. Server A.  One pusher of paced H.264 (FU-A, ``packets_per_frame``
   packets a frame, an IDR each ``gop`` frames) and an AAC track (one
   packet each 1,024 ticks at 48 kHz) over interleaved TCP for
   ``push_s``.  After the first GOP one UDP player of both tracks joins
   each frame.  Players of kind ``live`` stay at the live edge; ``pause``
   players PAUSE at ``pause_at`` and PLAY with no Range and ``Speed:
   pause_speed`` at ``resume_at`` (the time-shift tier resumes them at
   their bookmarks, and they catch up onto the live stream); ``range``
   players PLAY with ``Range: npt=range_npt-`` and ``Speed: range_speed``
   at ``range_at`` (a rewind, then the catch-up).  When the push ends and
   every player has its tail, REST ``stoprecord`` finalizes the asset,
   ``n_replay`` players replay ``<path>.dvr`` from npt 0 at
   ``replay_speed``, and the store of the asset is awaited over REST
   ``storagestats``.  The server stops (SIGTERM) and prints its stats
   (with its tiers' ``/metrics`` counters, scraped just before).
2. In this process: one ``scrub_tick`` of a ``StorageService`` on
   ``device`` over every shard file must report no error.  Then every
   ``spill.bin`` and ``lost`` shards of every stripe (data shards first,
   so the reconstruct is a B4 product, not an XOR) are deleted.
3. Server B on the same movie folder (a cold segment cache):
   ``n_reconstruct`` players replay the asset, now served only through the
   storage tier's reconstruct.

Every datagram of every player is held to the pushed packets: its
payload from byte 12 is a pushed packet's (found by its bytes), its SSRC
the one the SETUP reply named, and its seq and timestamp the pushed
packet's offset by the player's first datagram's.  In arrival order each
player track's source ids rise (a gap is a lost datagram, allowed only
as far as the host's UDP ``RcvbufErrors`` rose); a ``range`` player's
may restart once, at a GOP head (video) no later than where it was.
Live, pause and range players end at the last pushed packet; replay
players run from the first packet to the last spilled one.  Any failure
raises ``AssertionError``.
"""

from __future__ import annotations

import asyncio
import os
import re
import shutil
import time

from ..protocol import rtp, rtsp
from . import synth
from .loopback import (AV_SDP, TIER_COUNTERS, MiniClient, _udp_endpoint,
                       check, http_get_json, udp_rcvbuf_errors, CliServer)

VIDEO, AUDIO = 1, 2
CLOCK = {VIDEO: 90000, AUDIO: 48000}
AUDIO_TICKS = 1024
FPS = 30
PATH = "/live/dvr"


def phase_players(n_live: int, n_pause: int, n_range: int) -> list[str]:
    """Join order: the live players, then the pause and range players
    (so those have joined well before they pause or rewind)."""
    return ["live"] * n_live + ["pause"] * n_pause + ["range"] * n_range


class _Player:
    """One UDP player of both tracks: its SSRCs and what arrived,
    ``[(monotonic s, bytes)]`` a track."""

    def __init__(self, index: int, kind: str):
        self.index = index
        self.kind = kind
        self.client = MiniClient()
        self.ssrc: dict[int, int] = {}
        self.rtp: dict[int, list] = {VIDEO: [], AUDIO: []}
        self.play_at = None             # monotonic s of the PLAY reply

    async def join(self, port: int, uri: str) -> None:
        c = self.client
        await c.connect(port)
        await c.request("DESCRIBE", uri)
        for tid in (VIDEO, AUDIO):
            rtp_tr = await _udp_endpoint(self.rtp[tid], True)
            rtcp_tr = await _udp_endpoint(None)
            c._udp += [rtp_tr, rtcp_tr]
            a, b = (x.get_extra_info("sockname")[1] for x in (rtp_tr,
                                                               rtcp_tr))
            resp = await c.request("SETUP", f"{uri}/trackID={tid}", {
                "transport": f"RTP/AVP;unicast;client_port={a}-{b}"})
            t = rtsp.TransportSpec.parse(resp.headers["transport"])
            check(t.ssrc is not None, "SETUP reply names no ssrc")
            self.ssrc[tid] = t.ssrc

    async def play(self, uri: str, headers=None):
        resp = await self.client.request("PLAY", uri, headers or {})
        if self.play_at is None:
            self.play_at = time.monotonic()
        return resp


def _source_index(sent: list[bytes]) -> dict[bytes, int]:
    idx = {p[12:]: i for i, p in enumerate(sent)}
    check(len(idx) == len(sent), "pushed payloads are not unique")
    return idx


def _hold(pl: _Player, tid: int, sent: list[bytes], where: dict,
          *, restarts: int, gop: int | None) -> dict:
    """Hold one player track to the pushed packets (``restarts`` times
    its source ids may go back); returns the source ids it received in
    arrival order, split at the restarts, and the lost count."""
    who = f"player {pl.index} ({pl.kind}) track {tid}"
    got = [d for _t, d in pl.rtp[tid]]
    check(bool(got), f"{who}: no packet")
    i0 = where.get(got[0][12:])
    check(i0 is not None, f"{who}: a payload that was never pushed")
    seq0, ts0 = rtp.peek_seq(got[0]), rtp.peek_timestamp(got[0])
    src_seq0 = rtp.peek_seq(sent[i0])
    src_ts0 = rtp.peek_timestamp(sent[i0])
    runs: list[list[int]] = [[]]
    lost = 0
    for d in got:
        i = where.get(d[12:])
        check(i is not None, f"{who}: a payload that was never pushed")
        src = sent[i]
        want = (src[:2]
                + ((rtp.peek_seq(src) - src_seq0 + seq0) & 0xFFFF
                   ).to_bytes(2, "big")
                + ((rtp.peek_timestamp(src) - src_ts0 + ts0) & 0xFFFFFFFF
                   ).to_bytes(4, "big")
                + pl.ssrc[tid].to_bytes(4, "big") + src[12:])
        check(d == want, f"{who}: datagram of source id {i} differs from "
              f"the pushed packet's rewrite")
        run = runs[-1]
        if run and i <= run[-1]:
            check(len(runs) <= restarts,
                  f"{who}: source ids went back ({run[-1]} -> {i})")
            if gop is not None:
                check(i % gop == 0, f"{who}: a rewind to {i}, not a GOP "
                      f"head")
            runs.append([i])
            continue
        if run:
            lost += i - run[-1] - 1
        run.append(i)
    return {"runs": runs, "lost": lost, "first": runs[0][0],
            "last": runs[-1][-1], "datagrams": len(got)}


async def _push_and_play(port: int, rest_port: int, rng, *, kinds,
                         push_s, gop, packets_per_frame, body_len,
                         pause_at, resume_at, pause_speed, range_at,
                         range_npt, range_speed, settle_s) -> dict:
    uri = f"rtsp://127.0.0.1:{port}{PATH}"
    gop_pkts = gop * packets_per_frame
    n_frames = int(push_s * FPS)
    video: list[bytes] = []
    while len(video) < n_frames * packets_per_frame:
        video += synth.paced_gop(
            rng, seq0=0xFFE0 + len(video),
            ts0=0xFFFF0000 + 3000 * (len(video) // packets_per_frame),
            ssrc=0xC0DE0001, frames=gop, packets_per_frame=packets_per_frame,
            body_len=body_len, fu_a=True)
    video = video[:n_frames * packets_per_frame]
    n_audio = int(push_s * CLOCK[AUDIO] / AUDIO_TICKS)
    audio = [synth.aac_packet(rng, 0xFF00 + i, 0xFFFFF000 + AUDIO_TICKS * i,
                              ssrc=0xA0D10002) for i in range(n_audio)]
    sent = {VIDEO: video, AUDIO: audio}
    pusher = MiniClient()
    await pusher.connect(port)
    await pusher.request("ANNOUNCE", uri,
                         {"content-type": "application/sdp"},
                         AV_SDP.encode())
    for tid in (VIDEO, AUDIO):
        await pusher.request("SETUP", f"{uri}/trackID={tid}", {
            "transport": f"RTP/AVP/TCP;unicast;interleaved={2 * tid - 2}-"
                         f"{2 * tid - 1};mode=record"})
    await pusher.request("RECORD", uri)
    events = [(f / FPS, VIDEO, f) for f in range(n_frames)]
    events += [(i * AUDIO_TICKS / CLOCK[AUDIO], AUDIO, i)
               for i in range(n_audio)]
    events += [(pause_at, "pause", 0), (resume_at, "resume", 0),
               (range_at, "range", 0)]
    events.sort(key=lambda e: (e[0], str(e[1])))
    players = [_Player(i, k) for i, k in enumerate(kinds)]
    waiting = list(players)
    tasks: list[asyncio.Task] = []

    async def join(pl: _Player) -> None:
        await pl.join(port, uri)
        await pl.play(uri)

    async def control(kind: str) -> None:
        sel = [p for p in players if p.kind == ("pause" if kind != "range"
                                                else "range")]
        await asyncio.gather(*tasks)     # every player has joined
        for pl in sel:
            if kind == "pause":
                await pl.client.request("PAUSE", uri)
            elif kind == "resume":
                resp = await pl.play(uri, {"speed": f"{pause_speed:g}"})
                check(resp.headers.get("speed") == f"{pause_speed:g}",
                      "the resume's reply does not echo its Speed")
            else:
                resp = await pl.play(uri, {
                    "range": f"npt={range_npt:g}-",
                    "speed": f"{range_speed:g}"})
                check(resp.headers.get("speed") == f"{range_speed:g}",
                      "the rewind's reply does not echo its Speed")

    t_start = time.monotonic()
    controls = []
    for t_ev, what, i in events:
        delay = t_start + t_ev - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        if what in ("pause", "resume", "range"):
            controls.append(asyncio.create_task(control(what)))
            continue
        if what == VIDEO:
            if i >= gop and waiting:
                tasks.append(asyncio.create_task(join(waiting.pop(0))))
            pkts = video[i * packets_per_frame:(i + 1) * packets_per_frame]
        else:
            pkts = [audio[i]]
        for pkt in pkts:
            pusher.push(pkt, 2 * what - 2)
    await asyncio.gather(*tasks, *controls)
    deadline = time.monotonic() + settle_s

    def done() -> bool:
        return all(pl.rtp[t] and pl.rtp[t][-1][1][12:] == sent[t][-1][12:]
                   for pl in players for t in (VIDEO, AUDIO))

    while time.monotonic() < deadline and not done():
        await asyncio.sleep(0.05)
    await asyncio.sleep(0.3)
    status, body = await http_get_json(rest_port,
                                       f"/api/v1/stoprecord?path={PATH}")
    check(status == 200, f"stoprecord -> {status} {body}")
    windows = int(body["EasyDarwin"]["Body"]["DvrWindows"])
    res = {"players": players, "sent": sent, "pusher": pusher,
           "gop_pkts": gop_pkts, "windows": windows,
           "push_s": time.monotonic() - t_start}
    return res


async def _replay(port: int, n: int, speed: float, spilled: dict,
                  settle_s: float) -> tuple[list[_Player], list[float]]:
    """``n`` players of ``<path>.dvr`` from npt 0 at ``speed``, staggered
    by 100 ms; returns them and each one's ms from PLAY reply to its
    first datagram."""
    uri = f"rtsp://127.0.0.1:{port}{PATH}.dvr"
    players = [_Player(i, "replay") for i in range(n)]
    for pl in players:
        await pl.join(port, uri)
        resp = await pl.play(uri, {"range": "npt=0-",
                                   "speed": f"{speed:g}"})
        check(resp.headers.get("speed") == f"{speed:g}",
              "the replay's reply does not echo its Speed")
        await asyncio.sleep(0.1)
    deadline = time.monotonic() + settle_s
    while time.monotonic() < deadline and not all(
            pl.rtp[t] and pl.rtp[t][-1][1][12:] == spilled[t][12:]
            for pl in players for t in (VIDEO, AUDIO)):
        await asyncio.sleep(0.05)
    await asyncio.sleep(0.2)
    firsts = [(pl.rtp[VIDEO][0][0] - pl.play_at) * 1e3 if pl.rtp[VIDEO]
              else float("nan") for pl in players]
    return players, firsts


def _spilled_end(sent: dict, k: int) -> dict:
    """The last packet of each track's last full window."""
    return {t: sent[t][len(sent[t]) // k * k - 1] for t in sent}


def _delete_for_reconstruct(folder: str, lost: int,
                            path: str = PATH) -> dict:
    """Delete every ``spill.bin`` of ``path``'s asset and ``lost`` shards
    of each stripe (data shards first); returns the counts."""
    dvr_dir = os.path.join(folder, ".dvr", path.strip("/"))
    spills = 0
    for name in os.listdir(dvr_dir):
        p = os.path.join(dvr_dir, name, "spill.bin")
        if os.path.isfile(p):
            os.unlink(p)
            spills += 1
    shard_dir = os.path.join(folder, ".shards", path.strip("/"))
    stripes: dict[tuple, list[int]] = {}
    for tdir in os.listdir(shard_dir):
        full = os.path.join(shard_dir, tdir)
        if not (tdir.startswith("t") and os.path.isdir(full)):
            continue
        for f in os.listdir(full):
            m = re.fullmatch(r"s(\d+)\.(\d+)", f)
            if m:
                stripes.setdefault((tdir, int(m.group(1))), []).append(
                    int(m.group(2)))
    deleted = 0
    for (tdir, s), idxs in stripes.items():
        for idx in sorted(idxs)[:lost]:
            os.unlink(os.path.join(shard_dir, tdir, f"s{s}.{idx}"))
            deleted += 1
    return {"spill_files": spills, "stripes": len(stripes),
            "shards_deleted": deleted}


def _scrub_all(folder: str, device) -> dict:
    """One scrub over every shard file, in this process."""
    from ..storage import StorageService
    st = StorageService(os.path.join(folder, ".shards"), "scrub", k=4, m=2,
                        device=device)
    files = len(st._walk_shards())
    n = st.scrub_tick(batch=files + 1)
    st.close()
    return {"files": files, "scrubbed": n, "errors": st.scrub_errors}


def _check_players(players, sent, *, gop_pkts, end: dict) -> dict:
    where = {t: _source_index(sent[t]) for t in sent}
    out = {k: {"players": 0, "datagrams": 0, "lost": 0} for k in
           ("live", "pause", "range", "replay")}
    for pl in players:
        for tid in (VIDEO, AUDIO):
            h = _hold(pl, tid, sent[tid], where[tid],
                      restarts=1 if pl.kind == "range" else 0,
                      gop=gop_pkts if tid == VIDEO else None)
            who = f"player {pl.index} ({pl.kind}) track {tid}"
            if pl.kind == "replay":
                check(h["first"] == 0, f"{who}: the replay starts at "
                      f"{h['first']}, not 0")
            if pl.kind == "range":
                check(len(h["runs"]) == 2,
                      f"{who}: no rewind ({len(h['runs'])} runs)")
            check(h["last"] == where[tid][end[tid][12:]],
                  f"{who}: ends at {h['last']}, not at "
                  f"{where[tid][end[tid][12:]]}")
            o = out[pl.kind]
            o["datagrams"] += h["datagrams"]
            o["lost"] += h["lost"]
        out[pl.kind]["players"] += 1
    return out


async def dvr_session(device: str, folder: str, rng, *,
                      kinds: list[str] | None = None, push_s: float = 12.0,
                      gop: int = 30, packets_per_frame: int = 13,
                      body_len=(1270, 1300), pause_at: float = 3.0,
                      resume_at: float = 5.0, pause_speed: float = 2.0,
                      range_at: float = 6.0, range_npt: float = 1.0,
                      range_speed: float = 4.0, replay_speed: float = 4.0,
                      n_replay: int = 4, n_reconstruct: int = 4,
                      lost: int = 2, window_pkts: int = 64,
                      settle_s: float = 20.0) -> dict:
    """The whole check of the module docstring; returns the counts, both
    servers' exit stats, the scrub and what was deleted."""
    kinds = kinds or phase_players(48, 8, 8)
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    args = ("--movie-folder", folder, "--dvr-enabled", "1",
            "--storage-enabled", "1", "--dvr-window-pkts", str(window_pkts))
    rcvbuf0 = udp_rcvbuf_errors()
    async with CliServer(device, *args) as srv:
        live = await _push_and_play(
            srv.rtsp_port, srv.rest_port, rng, kinds=kinds, push_s=push_s,
            gop=gop, packets_per_frame=packets_per_frame, body_len=body_len,
            pause_at=pause_at, resume_at=resume_at, pause_speed=pause_speed,
            range_at=range_at, range_npt=range_npt, range_speed=range_speed,
            settle_s=settle_s)
        sent = live["sent"]
        spilled = _spilled_end(sent, window_pkts)
        replay, replay_first = await _replay(
            srv.rtsp_port, n_replay, replay_speed, spilled, settle_s)
        deadline = time.monotonic() + settle_s
        while time.monotonic() < deadline:
            _s, store = await http_get_json(srv.rest_port,
                                            "/api/v1/storagestats")
            if store.get("assets"):
                break
            await asyncio.sleep(0.1)
        for pl in live["players"] + replay:
            await pl.client.close()
        await live["pusher"].close()
        stats_a = await srv.stop(counters=TIER_COUNTERS)
    scrub = _scrub_all(folder, device)
    deleted = _delete_for_reconstruct(folder, lost)
    async with CliServer(device, *args) as srv:
        rebuilt, rebuilt_first = await _replay(
            srv.rtsp_port, n_reconstruct, replay_speed, spilled, settle_s)
        for pl in rebuilt:
            await pl.client.close()
        stats_b = await srv.stop(counters=TIER_COUNTERS)
    rcvbuf = udp_rcvbuf_errors() - rcvbuf0
    last = {t: sent[t][-1] for t in sent}
    by_kind = _check_players(live["players"], sent,
                             gop_pkts=live["gop_pkts"], end=last)
    by_kind["replay"] = _check_players(
        replay, sent, gop_pkts=live["gop_pkts"], end=spilled)["replay"]
    by_kind["reconstruct"] = _check_players(
        rebuilt, sent, gop_pkts=live["gop_pkts"], end=spilled)["replay"]
    lost_total = sum(v["lost"] for v in by_kind.values())
    check(lost_total <= rcvbuf,
          f"{lost_total} datagrams not received, but the host's UDP "
          f"RcvbufErrors rose by {rcvbuf}")
    return {"by_kind": by_kind, "lost": lost_total,
            "udp_rcvbuf_errors": rcvbuf, "windows": live["windows"],
            "video_packets": len(sent[VIDEO]),
            "audio_packets": len(sent[AUDIO]), "push_s": live["push_s"],
            "replay_first_ms": replay_first,
            "reconstruct_first_ms": rebuilt_first, "scrub": scrub,
            "deleted": deleted, "server_a": stats_a, "server_b": stats_b}


__all__ = ["dvr_session", "phase_players", "PATH"]
