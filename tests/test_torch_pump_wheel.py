"""The pump's timer wheel and per-player UDP pairs ≡ the JAX package's.

* ``native.TimerWheel`` (the port's egress core) answers schedule,
  cancel, advance, next and pending exactly as the reference's
  ``native.TimerWheel`` on the same seeded operations and pinned clock;
* ``RelayStream.next_deadline_ms`` equals the reference's on the same
  ring and outputs: held bucket releases (due and not, with and without
  ``allow_due``), a stalled stream, reliable-UDP RTOs future and due;
* the pump arms each stream's deadline on the wheel: with a 500 ms
  reflect interval a bucket-1 release arrives at its bucket delay, not
  at the tick; a stalled stream's due release is not re-armed; a server
  without its egress core does not start;
* ``shared_udp_egress=False``: no shared pair, each UDP player on a pool
  pair of its own, every packet as the oracle has it, its RTCP routed from
  the pair's odd port, the pair back in the pool at TEARDOWN.
"""

import asyncio
import socket
import time

import numpy as np
import pytest

from easydarwin_tpu import native as ref_native
from easydarwin_tpu.protocol import sdp as ref_sdp
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.relay.reliable import ReliableUdpOutput as RefReliable
from easydarwin_tpu.relay.stream import RelayStream as RefStream
from easydarwin_tpu.relay.stream import StreamSettings as RefSettings
from easydarwin_tpu_torch import convert, native
from easydarwin_tpu_torch.protocol import rtsp, sdp
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.relay.reliable import ReliableUdpOutput
from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.utils import loopback, synth

SDP = ("v=0\r\nm=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
       "a=control:trackID=1\r\n")


def _pkt(seq: int, ts: int, nal_type: int, *, ssrc: int) -> bytes:
    return synth.h264_packet(seq, ts, nal_type, ssrc=ssrc, body=bytes(40))


needs_ref_core = pytest.mark.skipif(not ref_native.available(),
                                    reason="the reference's core is not built")


# ----------------------------------------------------------------- the wheel
@needs_ref_core
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timer_wheel_equals_the_reference_on_a_pinned_clock(seed):
    rng = np.random.default_rng(seed)
    t = int(rng.integers(0, 1 << 40))
    mine, ref = native.TimerWheel(t), ref_native.TimerWheel(t)
    ids = []
    for step in range(400):
        op = rng.integers(0, 10)
        if op < 4:                       # schedule, past revolutions too
            delay = int(rng.choice([rng.integers(-5, 50),
                                    rng.integers(0, 9000)]))
            user = int(rng.integers(0, 1 << 62))
            a, b = mine.schedule(delay, user), ref.schedule(delay, user)
            assert a == b, step
            ids.append(a)
        elif op < 6 and ids:
            tid = int(rng.choice(ids + [10_000 + step]))
            assert mine.cancel(tid) == ref.cancel(tid), step
        elif op < 9:                     # advance, backwards as well
            t += int(rng.choice([rng.integers(-3, 40),
                                 rng.integers(0, 6000)]))
            assert sorted(mine.advance(t)) == sorted(ref.advance(t)), step
        q = t + int(rng.integers(-10, 100))
        assert mine.next_deadline(q) == ref.next_deadline(q), step
        assert mine.pending == ref.pending, step
    mine.close()
    assert mine._w is None


def test_a_missing_core_refuses_the_wheel(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="host core unavailable"):
        native.TimerWheel(0)
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       bind_ip="127.0.0.1"), device="cpu")
    with pytest.raises(RuntimeError):
        asyncio.run(app.start())


# -------------------------------------------------------- next_deadline_ms
def _twins(delay: int, clock):
    """A reference stream with history and the port stream carried over,
    with outputs in buckets 0-3 at staggered bookmarks and one reliable
    output each with the same pending packets."""
    rng = np.random.default_rng(5)
    settings = dict(bucket_size=2, bucket_delay_ms=delay)
    ref = RefStream(ref_sdp.parse(SDP).streams[0], RefSettings(**settings))
    t = 10_000
    for k in range(60):
        ref.push_rtp(_pkt(k, 3000 * k, 5 if k % 20 == 0 else 1, ssrc=7), t)
        t += 7
    r = ref.rtp_ring
    port = RelayStream(sdp.parse(SDP).streams[0], StreamSettings(**settings),
                       rtp_ring=convert.ring_from_arrays(
                           r.data, r.length, r.arrival, r.seq, r.timestamp,
                           r.flags, r.head, r.tail, r.capacity))
    for i in range(7):
        kw = dict(ssrc=int(rng.integers(1 << 32)), out_seq_start=i)
        a, b = RefOutput(**kw), CollectingOutput(**kw)
        a.bookmark = b.bookmark = (None if i == 6 else
                                   int(r.head) - 5 * i - 1 if i < 5
                                   else int(r.head))
        ref.add_output(a)
        port.add_output(b)
    rel_ref = RefReliable(RefOutput(ssrc=1), clock=clock)
    rel = ReliableUdpOutput(CollectingOutput(ssrc=1), clock=clock)
    ref.add_output(rel_ref)
    port.add_output(rel)
    for seq in range(4):
        for o in (rel_ref, rel):
            o.resender.add(seq, bytes(40), t - 300 * seq)
    return ref, port, t


def test_next_deadline_equals_the_reference():
    clock = [0]
    ref, port, t = _twins(40, lambda: clock[0])
    seen = set()
    for now in range(t - 100, t + 2500, 13):
        for allow_due in (False, True):
            a = port.next_deadline_ms(now, allow_due=allow_due)
            assert a == ref.next_deadline_ms(now, allow_due=allow_due), \
                (now, allow_due)
            seen.add(a > 0)
    assert seen == {True, False}
    # RTOs only: no held release once every bookmark is at the head
    for a, b in zip(ref.outputs, port.outputs):
        if a.bookmark is not None:
            a.bookmark = b.bookmark = ref.rtp_ring.head
    for now in (t, t + 700, t + 5000):
        assert port.next_deadline_ms(now) == ref.next_deadline_ms(now)
    # nothing held and nothing pending: -1
    for o in (ref.outputs[-1], port.outputs[-1]):
        o.resender.pending.clear()
    assert port.next_deadline_ms(t) == ref.next_deadline_ms(t) == -1


def test_a_stalled_stream_is_not_rearmed_for_a_due_release():
    """The pump arms a due release of a stream whose last pass did not
    stall at 1 ms, and leaves a stalled stream's to ingest or the tick."""
    app = StreamingServer(ServerConfig(), device="cpu")
    sess = app.registry.find_or_create("/live/w", SDP)
    (st,) = sess.streams.values()
    st.settings.bucket_size = 1
    for k in range(4):
        st.push_rtp(_pkt(k, 3000 * k, 1, ssrc=3), 1000)
    for _ in range(2):
        st.add_output(CollectingOutput(ssrc=9))
    for o in st.outputs:
        o.bookmark = 0
    app._wheel = native.TimerWheel(5000)
    st.last_pass_stalled = True
    app._schedule_stream_deadlines(5000)
    assert app._wheel.pending == 0 and not app._wheel_sched
    st.last_pass_stalled = False
    app._schedule_stream_deadlines(5000)
    assert app._wheel.pending == 1
    assert app._wheel.next_deadline(5000) == 1
    app._schedule_stream_deadlines(5000)   # an equal timer is kept
    assert app._wheel.pending == 1
    assert app._wheel.advance(5001) == [id(st)]
    app._wheel.close()


# ------------------------------------------------------------ the live pump
async def _push_session(port: int, uri: str, sdp_text: str):
    pusher = loopback.MiniClient()
    await pusher.connect(port)
    await pusher.request("ANNOUNCE", uri, {"content-type": "application/sdp"},
                         sdp_text.encode())
    await pusher.request("SETUP", uri + "/trackID=1", {
        "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"})
    await pusher.request("RECORD", uri)
    return pusher


async def test_bucket_release_arrives_at_its_delay_not_at_the_tick():
    """reflect_interval_ms=500, one player a bucket, bucket delay 60 ms:
    after each pushed packet the bucket-1 player's copy leaves on the
    wheel's deadline, within the delay plus a few ms, long before the
    500 ms tick."""
    delay = 60
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        reflect_interval_ms=500,
        stream=StreamSettings(bucket_size=1, bucket_delay_ms=delay)),
        device="cpu")
    await app.start()
    clients = []
    try:
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/wheel"
        pusher = await _push_session(app.rtsp.port, uri,
                                     loopback.VIDEO_SDP)
        clients.append(pusher)
        pusher.push(_pkt(0, 0, 5, ssrc=11))
        players = []
        for _ in range(2):
            pl = loopback.MiniClient()
            clients.append(pl)
            await pl.connect(app.rtsp.port)
            await pl.request("DESCRIBE", uri)
            await pl.request("SETUP", uri + "/trackID=1", {
                "transport": "RTP/AVP/TCP;unicast;interleaved=0-1"})
            await pl.request("PLAY", uri)
            players.append(pl)
        for _ in range(100):
            if all(pl.channels.get(0) for pl in players):
                break
            await asyncio.sleep(0.02)
        assert all(pl.channels.get(0) for pl in players)
        wakes0 = app.wheel_wakes
        lags = {0: [], 1: []}
        for k in range(1, 6):
            await asyncio.sleep(0.2)
            n = [len(pl.channels[0]) for pl in players]
            t_push = time.monotonic()
            pusher.push(_pkt(k, 3000 * k, 1, ssrc=11))
            while time.monotonic() - t_push < 0.45 and not all(
                    len(pl.channels[0]) > c for pl, c in zip(players, n)):
                await asyncio.sleep(0.002)
            for i, (pl, c) in enumerate(zip(players, n)):
                assert len(pl.channels[0]) == c + 1, (k, i)
                lags[i].append((pl.channels[0][c][0] - t_push) * 1e3)
        early, late = sorted(lags.values(), key=np.median)
        assert np.median(early) < 30, lags
        # the bucket-1 copy: at the delay (never before it), and well
        # before the next ingest (200 ms on) or the 500 ms tick, which
        # would release it without the wheel
        assert min(late) >= delay - 2, lags
        assert np.median(late) < delay + 30 and max(late) < 150, lags
        assert app.wheel_wakes - wakes0 >= 5
        st = app.stats()["pump"]
        assert st["event_wakes"] > 0 and st["wheel_wakes"] >= 5
        assert 0 <= st["schedule_ms_p50"] <= st["schedule_ms_max"]
    finally:
        for c in clients:
            await c.close()
        await app.stop()


# ------------------------------------------------------ per-player UDP pairs
async def test_udp_play_falls_back_without_shared_egress():
    """``shared_udp_egress=False`` serves a UDP player from a pool pair:
    no shared egress, the reply's ``server_port`` is the pair, the packet
    arrives with its payload, the output's SSRC and the seq of RTP-Info;
    the player's RR on the pair's odd port reaches the RTCP router; the
    pair's ports are free again after TEARDOWN."""
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        reflect_interval_ms=5, shared_udp_egress=False), device="cpu")
    await app.start()
    clients = []
    rtp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rtcp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        assert app.rtsp.shared_egress is None
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/fb"
        pusher = await _push_session(app.rtsp.port, uri, loopback.VIDEO_SDP)
        clients.append(pusher)
        rtp.bind(("127.0.0.1", 0))
        rtp.setblocking(False)
        rtcp.bind(("127.0.0.1", 0))
        c = loopback.MiniClient()
        clients.append(c)
        await c.connect(app.rtsp.port)
        await c.request("DESCRIBE", uri)
        resp = await c.request("SETUP", uri + "/trackID=1", {
            "transport": f"RTP/AVP;unicast;client_port="
                         f"{rtp.getsockname()[1]}-{rtcp.getsockname()[1]}"})
        t = rtsp.TransportSpec.parse(resp.headers["transport"])
        (conn,) = [k for k in app.rtsp.connections if k.player_pairs]
        pair = conn.player_pairs[1]
        assert t.server_port == (pair.rtp_port, pair.rtcp_port)
        assert pair.rtp_port % 2 == 0
        play = await c.request("PLAY", uri)
        pkt = _pkt(7, 1234, 5, ssrc=0xABC)
        pusher.push(pkt)
        got = None
        for _ in range(200):
            try:
                got = rtp.recv(65536)
                break
            except BlockingIOError:
                await asyncio.sleep(0.02)
        assert got is not None and got[12:] == pkt[12:]
        assert int.from_bytes(got[8:12], "big") == t.ssrc
        seq0 = int(play.headers["rtp-info"].split("seq=")[1].split(";")[0])
        assert int.from_bytes(got[2:4], "big") == seq0
        stats = app.stats()
        assert stats["native_sent"] == 0 and stats["loop_sent"] == 1
        rr = loopback.receiver_report(0x1234, t.ssrc, 0, seq0)
        rtcp.sendto(rr, ("127.0.0.1", pair.rtcp_port))
        for _ in range(100):
            if app.rtsp.rtcp_counts["rr"]:
                break
            await asyncio.sleep(0.02)
        assert app.rtsp.rtcp_counts["rr"] == 1
        ports = (pair.rtp_port, pair.rtcp_port)
        await c.request("TEARDOWN", uri)
        await asyncio.sleep(0.05)
        for p in ports:                 # both ports bind again
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind(("127.0.0.1", p))
            s.close()
    finally:
        rtp.close()
        rtcp.close()
        for cl in clients:
            if cl._task is not None:
                await cl.close()
        await app.stop()


async def test_per_player_pairs_deliver_every_packet_as_the_oracle():
    """Four UDP players joining a source one a frame, each on its own
    pair: the harness checks every packet (payload, one SSRC each, seq
    and ts rebased per RTP-Info); none went through the shared scatter."""
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
        shared_udp_egress=False), device="cpu")
    await app.start()
    try:
        res = await loopback.push_play(
            app.rtsp.port, np.random.default_rng(17), n_push=1, n_play=4,
            transport="udp", gops=3, frames=5, join_every=1, deadline_s=20)
        assert res["players"] == 4 and res["delivered"] > 0
        st = app.stats()
        assert st["native_sent"] == 0
        assert st["loop_sent"] == st["packets_out"] == res["delivered"]
        assert st["loop_us_per_packet"] > 0
        assert st["pump_errors"] == 0
    finally:
        await app.stop()
