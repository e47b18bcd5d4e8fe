"""Harnesses of the resilience tier (``resilience``) on a running server.

``chaos_relay`` serves ``streams`` pushed H.264 streams (even ones
pushed over interleaved TCP, so their packets meet ``push_rtp``'s
gauntlet; odd ones over UDP, drained natively, so they meet
``ingest_ring``'s) to ``players`` UDP players each, from an in-process
``StreamingServer`` whose ``resilience_fault_plan`` (``CHAOS_PLAN``) is
armed from its start.  When every player plays, it arms that plan again
with the device faults of ``device_fault_plan`` added, so that no stream
degrades before the megabatch serves them all, and samples each
stream's rung every ``SAMPLE_S`` for ``fault_s``; then it disarms the
injector and waits for every stream to climb back to the megabatch
rung, and serves ``confirm_s`` more.  It holds:

* ``fault_injected_total`` by site to the injector's own ``counts()``;
* the ladder to have degraded (``resilience_transitions_total`` down);
* the scheduler's window call (``ed_relay_window`` on a card) to have
  run while the faults fired and again after the recovery, with no
  segment that disagreed with the host oracle;
* the recovery to within ``RUNGS × recover_sec + RECOVER_SLACK_S``;
* the device errors the pump counted to be no more than the faults
  injected at the device sites, and none of them a real one;
* each player's datagrams to one SSRC, strictly increasing rewritten
  seqs, and each payload to be a pushed one (or a pushed one with one
  byte flipped: ``ingest_corrupt``).

It returns the figures: faults by site (the egress core's own count
beside), rung-seconds by rung, the time to recover, the wakes' host ms
(p50, p99) while the faults fired, and the window calls and launches of
each part.  The SLO watchdog is off in this run, so that only the device
errors move the ladder.

``restart_resume`` restarts a server from its checkpoint: server A (with
``resilience_checkpoint_enabled``) relays one pushed stream to a UDP
player and an interleaved-TCP player, and stops (writing its last
checkpoint); server B starts on the same ``log_folder`` and restores the
session and the UDP subscriber; the TCP player connects again with its
old ``Session`` id and re-attaches its parked record; the pusher
re-ANNOUNCEs and goes on with its numbering.  Each player must see one
SSRC and a contiguous rewritten seq across the restart, and the
restored UDP subscriber's receiver report must prove it alive.

Both are async; call them under ``asyncio.run``.
"""

from __future__ import annotations

import asyncio
import os
import struct
import time

import numpy as np

from .. import native, obs
from ..ops import kernel_lib
from ..protocol import rtp, rtsp
from ..resilience import INJECTOR, RUNGS
from ..resilience.inject import SITES, FaultPlan
from ..server import ServerConfig, StreamingServer
from . import synth
from .loopback import VIDEO_SDP, MiniClient, check

#: the plan of the chaos run: ingest drop and corrupt, EAGAIN and ENOBUFS
#: at the egress core; ``chaos_relay`` arms it with its own seed, and for
#: the fault window with the device faults of ``device_fault_plan`` too
CHAOS_PLAN = ("ingest_drop=0.01,ingest_corrupt=0.01,egress_eagain_every=97,"
              "egress_enobufs_every=131")
#: device faults a ``recover_sec``: see ``device_fault_plan``
DEVICE_FAULTS_PER_RECOVER = 2
#: the rung sampling period, s
SAMPLE_S = 0.05
#: the recovery's allowance past ``RUNGS × recover_sec``: the 1 Hz
#: maintenance tick, and a retry's backoff still running at the disarm
RECOVER_SLACK_S = 2.0


def device_fault_plan(recover_sec: float) -> str:
    """Device errors on the ``megabatch.dispatch`` and
    ``fanout.device_params`` sites, each at the first draw past
    ``recover_sec / DEVICE_FAULTS_PER_RECOVER`` since the last.  The
    ladder drops a stream's rung after ``max_retries`` + 1 faults with no
    clean ``recover_sec`` between them.  Counted every Nth draw, the
    faults come as far apart as the host's dispatch rate puts them, and a
    slow host never degrades.  Under the period a slower host only moves
    each fault to a later draw: the stream that draws first in a wake (or
    every stream, when the scheduler's draw comes first) takes its faults
    at most a period and a wake apart."""
    return (f"device_error_period_s="
            f"{recover_sec / DEVICE_FAULTS_PER_RECOVER!r}")


def _window_launches() -> int:
    return kernel_lib.LAUNCHES.get("ed_relay_window", 0)


def _pct(vals, q: float):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(len(vals) * q))] if vals else None


class _Source:
    """One pushed H.264 stream: GOPs made on demand with continuing seq
    and timestamp."""

    def __init__(self, rng: np.random.Generator, k: int, *,
                 frames: int, packets_per_frame: int, body_len):
        self.rng = rng
        self.ssrc = 0xC4A00000 + k
        self.seq = (0xFF00 + 977 * k) & 0xFFFF
        self.ts = 0xFFF00000 + 90_000 * k
        self.frames = frames
        self.ppf = packets_per_frame
        self.body_len = body_len
        self.queue: list[bytes] = []
        #: payloads of everything pushed (from byte 12)
        self.payloads: set[bytes] = set()

    def next_frame(self) -> list[bytes]:
        if not self.queue:
            self.queue = synth.paced_gop(
                self.rng, seq0=self.seq, ts0=self.ts, ssrc=self.ssrc,
                frames=self.frames, packets_per_frame=self.ppf,
                body_len=self.body_len)
            self.seq = (self.seq + len(self.queue)) & 0xFFFF
            self.ts = (self.ts + 3000 * self.frames) & 0xFFFFFFFF
        out, self.queue = self.queue[:self.ppf], self.queue[self.ppf:]
        for p in out:
            self.payloads.add(p[12:])
        return out


async def _pusher(port: int, path: str, udp: bool) -> MiniClient:
    c = MiniClient()
    await c.connect(port)
    uri = f"rtsp://127.0.0.1:{port}{path}"
    await c.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                    VIDEO_SDP.encode())
    spec = "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"
    if udp:
        spec = f"RTP/AVP;unicast;client_port={await c.udp_ports()};mode=record"
    resp = await c.request("SETUP", uri + "/trackID=1", {"transport": spec})
    if udp:
        c.server_port = rtsp.TransportSpec.parse(
            resp.headers["transport"]).server_port
    await c.request("RECORD", uri)
    return c


async def _player(port: int, path: str, kind: str,
                  session: str | None = None) -> tuple[MiniClient, int]:
    """A player of ``path`` over ``kind`` (``udp`` or ``tcp``); with
    ``session``, an interleaved SETUP that carries that old Session id.
    Returns the client and the SSRC its SETUP reply named."""
    p = MiniClient()
    await p.connect(port)
    uri = f"rtsp://127.0.0.1:{port}{path}"
    await p.request("DESCRIBE", uri)
    spec = "RTP/AVP/TCP;unicast;interleaved=0-1"
    if kind == "udp":
        spec = f"RTP/AVP;unicast;client_port={await p.udp_ports()}"
    p.session = session
    resp = await p.request("SETUP", uri + "/trackID=1", {"transport": spec})
    ssrc = rtsp.TransportSpec.parse(resp.headers["transport"]).ssrc
    await p.request("PLAY", uri)
    return p, ssrc


def _check_player(who: str, frames: list[bytes], ssrc: int,
                  payloads: set[bytes]) -> int:
    """One SSRC, strictly increasing seqs, each payload pushed (or pushed
    with one byte flipped); returns the packets."""
    check(frames, f"{who}: no packet")
    seqs = []
    for pkt in frames:
        check(len(pkt) >= 12 and rtp.peek_ssrc(pkt) == ssrc,
              f"{who}: a packet of another SSRC")
        seqs.append(rtp.peek_seq(pkt))
        body = pkt[12:]
        if body not in payloads:
            near = [p for p in payloads if len(p) == len(body) and sum(
                a != b for a, b in zip(p, body)) == 1]
            check(near, f"{who}: a payload that was never pushed")
    steps = [(b - a) & 0xFFFF for a, b in zip(seqs, seqs[1:])]
    check(all(0 < s < 0x8000 for s in steps),
          f"{who}: seq not increasing ({sorted(set(steps))[:6]})")
    return len(frames)


async def chaos_relay(device, seed: int = 21, *, streams: int = 8,
                      players: int = 8, plan: str = CHAOS_PLAN,
                      recover_sec: float = 1.0, max_retries: int = 2,
                      fault_s: float = 4.0, confirm_s: float = 1.0,
                      frame_interval_s: float = 0.02, frames: int = 15,
                      packets_per_frame: int = 4, body_len=(40, 400),
                      log_folder: str | None = None) -> dict:
    rng = np.random.default_rng(seed)
    cfg = ServerConfig(rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
                       slo_enabled=False, access_log_enabled=False,
                       resilience_fault_plan=f"seed={seed},{plan}",
                       resilience_recover_sec=recover_sec,
                       resilience_max_retries=max_retries,
                       resilience_backoff_ms=50.0)
    if log_folder is not None:
        cfg.log_folder = log_folder
    sites = list(SITES)
    base_fault = {s: obs.FAULT_INJECTED.value(site=s) for s in sites}
    base_down = obs.RESILIENCE_TRANSITIONS.value(direction="down")
    base_up = obs.RESILIENCE_TRANSITIONS.value(direction="up")
    base_native = native.get_stats()["fault_injections"] \
        if native.available() else 0
    app = StreamingServer(cfg, device=device)
    await app.start()
    pushers, sources, plays = [], [], []
    pushing = True
    pushed = [0]

    async def push_loop():
        while pushing:
            for c, src in zip(pushers, sources):
                for pkt in src.next_frame():
                    c.push(pkt)
                    pushed[0] += 1
            await asyncio.sleep(frame_interval_s)

    try:
        for k in range(streams):
            pushers.append(await _pusher(app.rtsp.port, f"/live/chaos{k}",
                                         udp=k % 2 == 1))
            sources.append(_Source(rng, k, frames=frames,
                                   packets_per_frame=packets_per_frame,
                                   body_len=body_len))
        task = asyncio.create_task(push_loop())
        await asyncio.sleep(0.2)
        for k in range(streams):
            for _ in range(players):
                plays.append((k, *await _player(app.rtsp.port,
                                                f"/live/chaos{k}", "udp")))
        # -- the faults fire: the plan again, with the device faults
        armed = f"seed={seed},{device_fault_plan(recover_sec)},{plan}"
        counts0 = INJECTOR.counts()
        INJECTOR.arm(FaultPlan.parse(armed))
        calls0, launches0 = app.megabatch.window_calls, _window_launches()
        wake0 = len(app.wake_ms)
        rung_s = dict.fromkeys(RUNGS, 0.0)
        t_prev = time.monotonic()
        t_end = t_prev + fault_s
        while t_prev < t_end:
            await asyncio.sleep(SAMPLE_S)
            now = time.monotonic()
            levels = app.ladder.status()
            for k in range(streams):
                lv = levels.get(f"/live/chaos{k}", {"rung": RUNGS[0]})
                rung_s[lv["rung"]] += now - t_prev
            t_prev = now
        fault_wakes = list(app.wake_ms)[wake0:]
        counts = {k: counts0.get(k, 0) + v
                  for k, v in INJECTOR.counts().items()
                  if counts0.get(k, 0) + v}
        calls_fault = app.megabatch.window_calls - calls0
        launches_fault = _window_launches() - launches0
        # -- disarm and recover
        INJECTOR.disarm()
        t_d = time.monotonic()
        bound = len(RUNGS) * recover_sec + RECOVER_SLACK_S
        while True:
            worst = app.ladder.worst_level()
            if worst == 0:
                break
            check(time.monotonic() - t_d <= bound,
                  f"streams still degraded {bound:.1f} s after the disarm: "
                  f"{app.ladder.status()}")
            await asyncio.sleep(SAMPLE_S)
        recover_s = time.monotonic() - t_d
        calls1, launches1 = app.megabatch.window_calls, _window_launches()
        await asyncio.sleep(confirm_s)
        calls_after = app.megabatch.window_calls - calls1
        launches_after = _window_launches() - launches1
        pushing = False
        await task
        await asyncio.sleep(0.3)
        stats = app.stats()
    finally:
        pushing = False
        INJECTOR.disarm()
        await app.stop()
        for c in pushers:
            await c.close()
        for _k, p, _s in plays:
            await p.close()
    res = stats["resilience"]
    faults = {s: obs.FAULT_INJECTED.value(site=s) - base_fault[s]
              for s in sites}
    for site, n in counts.items():
        check(faults[site] == n, f"fault_injected_total{{site={site}}} "
              f"{faults[site]} != the injector's {n}")
    native_faults = (native.get_stats()["fault_injections"] - base_native
                     if native.available() else 0)
    down = obs.RESILIENCE_TRANSITIONS.value(direction="down") - base_down
    up = obs.RESILIENCE_TRANSITIONS.value(direction="up") - base_up
    check(counts.get("device_dispatch", 0) > 0, "no device fault fired")
    check(down > 0, "the ladder never degraded")
    check(calls_fault > 0, "no window call while the faults fired")
    check(calls_after > 0, "no window call after the recovery")
    check(stats["megabatch"]["mismatches"] == 0,
          f"window segments disagreed with the host oracle: "
          f"{stats['megabatch']['mismatches']}")
    check(res["device_errors"] <= counts.get("device_dispatch", 0),
          f"{res['device_errors']} device errors counted, only "
          f"{counts.get('device_dispatch', 0)} injected")
    check(res["device_errors"] == res["device_errors_injected"],
          f"{res['device_errors'] - res['device_errors_injected']} device "
          f"errors were not injected ones")
    check(stats["pump_errors"] == 0, f"pump errors: {stats['pump_errors']}")
    delivered = 0
    for i, (k, p, ssrc) in enumerate(plays):
        delivered += _check_player(f"player {i} of /live/chaos{k}", p.frames,
                                   ssrc, sources[k].payloads)
    return {
        "streams": streams, "players": streams * players,
        "plan": armed, "recover_sec": recover_sec, "fault_s": fault_s,
        "faults": counts, "fault_injected_total": {
            s: v for s, v in faults.items() if v},
        "egress_native_faults": native_faults,
        "device_errors": res["device_errors"],
        "device_errors_injected": res["device_errors_injected"],
        "transitions": {"down": down, "up": up},
        "rung_s": rung_s, "recover_s": recover_s, "recover_bound_s": bound,
        "wake_ms_p50": _pct(fault_wakes, 0.5),
        "wake_ms_p99": _pct(fault_wakes, 0.99),
        "wakes_faulted": len(fault_wakes),
        "window_calls": {"fault": calls_fault, "after": calls_after},
        "window_launches": {"fault": launches_fault,
                            "after": launches_after},
        "pushed": pushed[0], "delivered": delivered,
        "egress_send_errors": stats["send_errors"],
        "mismatches": stats["megabatch"]["mismatches"],
    }


def _rr(reporter: int, ssrc: int) -> bytes:
    """An RTCP RR of one report block naming ``ssrc``."""
    return struct.pack("!BBHIIIIIII", 0x81, 201, 7, reporter, ssrc,
                       0, 0, 0, 0, 0)


def _restart_config(folder: str) -> ServerConfig:
    cfg = ServerConfig(rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
                       reflect_interval_ms=10, access_log_enabled=False,
                       log_folder=folder,
                       resilience_checkpoint_enabled=True,
                       resilience_checkpoint_interval_sec=0.5)
    cfg.stream.bucket_delay_ms = 0
    return cfg


async def restart_resume(device, folder: str, seed: int = 5, *,
                         packets: int = 40,
                         interval_s: float = 0.005) -> dict:
    rng = np.random.default_rng(seed)
    src = _Source(rng, 0, frames=10, packets_per_frame=4, body_len=(40, 300))
    os.makedirs(folder, exist_ok=True)
    path = "/live/ckpt"

    async def push(c: MiniClient, n: int) -> None:
        sent = 0
        while sent < n:
            for pkt in src.next_frame():
                c.push(pkt)
                sent += 1
            await asyncio.sleep(interval_s)

    app_a = StreamingServer(_restart_config(folder), device=device)
    await app_a.start()
    closers = []
    try:
        pusher = await _pusher(app_a.rtsp.port, path, udp=False)
        closers.append(pusher)
        udp, udp_ssrc = await _player(app_a.rtsp.port, path, "udp")
        closers.append(udp)
        tcp, tcp_ssrc = await _player(app_a.rtsp.port, path, "tcp")
        closers.append(tcp)
        await push(pusher, packets)
        await asyncio.sleep(0.4)
        n_udp_a, n_tcp_a = len(udp.frames), len(tcp.frames)
        check(n_udp_a >= packets // 2 and n_tcp_a >= packets // 2,
              f"phase A flowed {n_udp_a} / {n_tcp_a} packets")
        old_session = tcp.session
        # the "crash": the players never tear down; their state lives in
        # the checkpoint that stop writes
    finally:
        await app_a.stop()
        for c in closers[:1] + closers[2:]:
            await c.close()
    tcp_a_frames = list(tcp.frames)
    app_b = StreamingServer(_restart_config(folder), device=device)
    await app_b.start()
    closers = [udp]
    try:
        restored = app_b.restored
        sess = app_b.registry.find(path)
        check(sess is not None, "server B restored no session")
        check(sess.streams[1].num_outputs == 1,
              f"server B restored {sess.streams[1].num_outputs} outputs")
        check(len(app_b._pending_tcp) == 1, "no TCP record parked")
        tcp2, tcp2_ssrc = await _player(app_b.rtsp.port, path, "tcp",
                                        session=old_session)
        closers.append(tcp2)
        check(tcp2_ssrc == tcp_ssrc,
              f"the re-attached SETUP named SSRC {tcp2_ssrc:#x}, "
              f"not {tcp_ssrc:#x}")
        pusher2 = await _pusher(app_b.rtsp.port, path, udp=False)
        closers.append(pusher2)
        await push(pusher2, packets)
        await asyncio.sleep(0.4)
        # the restored subscriber's RR proves it alive
        sub = app_b._restored_subs[0]
        before = sub.last_activity
        await asyncio.sleep(0.02)
        udp._udp[1].sendto(_rr(0x7A7A, udp_ssrc),
                           ("127.0.0.1", app_b.rtsp.shared_egress.rtcp_port))
        await asyncio.sleep(0.2)
        proven = sub.last_activity > before
        stats_b = app_b.stats()["resilience"]
    finally:
        await app_b.stop()
        for c in closers:
            await c.close()
    check(app_a.device_errors == app_b.device_errors == 0,
          f"device errors: server A {app_a.device_errors}, server B "
          f"{app_b.device_errors}")
    out = {"restored_sessions": restored[0], "restored_outputs": restored[1],
           "rr_proved": proven, "checkpoint": stats_b["checkpoint"]}
    for who, frames, ssrc, n_a in (
            ("udp", list(udp.frames), udp_ssrc, n_udp_a),
            ("tcp", tcp_a_frames + list(tcp2.frames), tcp_ssrc, n_tcp_a)):
        check(len(frames) > n_a, f"{who}: nothing after the restart")
        check({rtp.peek_ssrc(p) for p in frames} == {ssrc},
              f"{who}: the SSRC changed across the restart")
        seqs = [rtp.peek_seq(p) for p in frames]
        steps = {(b - a) & 0xFFFF for a, b in zip(seqs, seqs[1:])}
        check(steps == {1}, f"{who}: seq not contiguous across the restart "
                            f"(steps {sorted(steps)[:6]})")
        out[f"{who}_packets"] = [n_a, len(frames) - n_a]
    check(proven, "the restored subscriber's RR did not prove it alive")
    return out


__all__ = ["CHAOS_PLAN", "chaos_relay", "device_fault_plan",
           "restart_resume"]
