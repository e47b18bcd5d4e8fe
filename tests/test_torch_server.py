"""The port's server end to end on the CPU, and what the port imports.

* a loopback push → play through ``python -m easydarwin_tpu_torch
  --device cpu``: 1 source × 2 interleaved TCP players (the per-stream
  device ring, the native framed-writev rung), 2 sources × 2 UDP players
  (the megabatch, the native sendmmsg scatter) and 1 source × 3 UDP
  players joining one by one; every relayed packet held to what was
  pushed (``utils.loopback``);
* a UDP SETUP names the shared egress ports, and is refused without
  ``client_port`` (a pusher's too); the outputs' native hooks;
* one stream that raises in a wake leaves the other streams served and
  the scheduler dispatching; a failed ``begin_wake`` serves the wake's
  streams one by one;
* a UDP player whose RTSP connection is silent stays while it sends RTCP
  (from its registered RTCP address, or naming its SSRC in an RR) and a
  silent one is closed; the port's RR parse against the reference's;
* RTCP end to end (1 pusher of H.264 + AAC with SRs, 4 players): relayed
  and originated SRs reach UDP and TCP players on their own timelines, an
  RR with loss thins only the players that sent it (a TCP player's on
  its interleaved RTCP channel), a meta-info SETUP is granted and served,
  and the pusher gets its upstream RRs (``utils.loopback.push_play_av``);
* forged RTCP (an unregistered address, no owned SSRC) neither refreshes
  an idle clock nor moves a level; a closing pusher clears only the
  upstream-RR writer it installed;
* the loss tiers: ``x-FEC`` and ``x-Retransmit`` grants equal the
  reference's headers (TCP gets neither); lossy UDP players (seeded drops,
  RRs, generic NACKs, 'qtak' acks) through the CLI end byte-equal to the
  oracle; a NACK and an APP with forged SSRCs neither refresh an idle
  clock nor replay, and the same from the registered address do; the
  shared RTCP socket takes a burst of acks in batches a readiness
  callback and drops none;
* OPTIONS lists GET_PARAMETER and SET_PARAMETER, and both answer 200
  with the CSeq (and the Session once there is one), as the reference's
  server does in process;
* a server on the CPU touches nothing of CUDA when it starts;
* importing the port, its server, its CLI, the transcode modules, the
  REST API, the VOD tier, the HLS tier with its codecs and the server
  surface (auth, MP3, the watchdog, the config file, the logs, the RTSP
  client, pull relays and ``.sdp`` sources), and the observability stack
  (the eleven ``obs`` modules, the status monitor, the dictionary, the
  modules and the admin tree), and the cluster tier (``cluster.*`` and
  its harness) leaves ``jax`` and ``easydarwin_tpu`` out of
  ``sys.modules``;
* the CLI's device defaults to the card, and without one it raises.
"""

import asyncio
import socket
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from easydarwin_tpu.protocol import rtcp as ref_rtcp
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.server.config import ServerConfig as RefConfig
from easydarwin_tpu.server.rtsp import RtspConnection as RefConnection
from easydarwin_tpu_torch import __main__ as cli
from easydarwin_tpu_torch.ops import kernel_lib
from easydarwin_tpu_torch.protocol import rtcp, rtsp
from easydarwin_tpu_torch.relay.output import CollectingOutput, WriteResult
from easydarwin_tpu_torch.relay.reliable import (BandwidthTracker,
                                                 ReliableUdpOutput, build_ack)
from easydarwin_tpu_torch.relay.session import now_ms
from easydarwin_tpu_torch.relay.stream import RelayStream
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.server.transports import (RTCP_DRAIN_MAX,
                                                    InterleavedOutput,
                                                    SharedUdpEgress, UdpOutput)
from easydarwin_tpu_torch.utils import loopback, synth

ROOT = Path(__file__).resolve().parents[1]


async def test_loopback_push_play_through_the_cli_on_cpu():
    res = await loopback.serve_and_check(
        "cpu", np.random.default_rng(2026), n_push=1, n_play=2,
        deadline_s=10)
    assert res["players"] == 2 and res["packets_per_player"] == 80
    stats = res["server_stats"]
    assert stats["packets_in"] == 80
    assert stats["packets_out"] == 2 * 80      # fast start replays GOP 1
    # one stream: the megabatch idles, the engine queries its own ring
    assert stats["megabatch"]["installs"] == 0
    assert stats["device_param_refreshes"] > 0
    assert stats["native_loaded"] and stats["native_sent"] > 0
    assert stats["send_errors"] == 0
    # CPU tensors take the plain versions: no kernel was launched
    assert stats["kernel_launches"] == {"ed_parse_packets": 0,
                                        "ed_relay_window": 0,
                                        "ed_ring_query": 0,
                                        "ed_decode_blocks": 0,
                                        "ed_gf_parity": 0,
                                        "ed_relay_batch": 0,
                                        "ed_relay_shard": 0,
                                        "ed_requant_rungs": 0,
                                        "ed_h264_requant": 0,
                                        "ed_h264_requant_chroma": 0}


async def test_udp_players_through_the_cli_on_cpu():
    """UDP SETUP (``client_port``) is served: 2 sources engage the
    megabatch, and every datagram leaves through the native scatter."""
    res = await loopback.serve_and_check(
        "cpu", np.random.default_rng(7), n_push=2, n_play=2,
        transport="udp", deadline_s=10)
    assert res["players"] == 4 and res["delivered"] == 4 * 80
    stats = res["server_stats"]
    assert stats["packets_out"] == 4 * 80
    assert stats["native_sent"] == stats["packets_out"]
    assert stats["native_passes"] > 0 and stats["send_errors"] == 0
    assert stats["megabatch"]["installs"] > 0
    assert stats["megabatch"]["native_gather"]


async def test_staggered_udp_joins_on_one_stream_through_the_cli_on_cpu():
    """Players joining one every third frame of one source: each join is
    a per-stream ring query, and each player starts at its keyframe."""
    res = await loopback.serve_and_check(
        "cpu", np.random.default_rng(8), n_push=1, n_play=3,
        transport="udp", gops=6, join_every=3, deadline_s=10)
    assert res["players"] == 3
    stats = res["server_stats"]
    assert stats["device_param_refreshes"] >= 3
    assert stats["native_sent"] == stats["packets_out"] == res["delivered"]
    assert stats["megabatch"]["installs"] == 0


async def test_udp_setup_replies_with_the_shared_egress_ports_in_process():
    """A player's UDP SETUP is answered with the shared egress pair's ports
    as ``server_port``; a UDP SETUP without ``client_port``, a pusher's
    too, gets 461."""
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       bind_ip="127.0.0.1"), device="cpu")
    await app.start()
    clients = [loopback.MiniClient(), loopback.MiniClient()]
    try:
        pusher, player = clients
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/cam0"
        await pusher.connect(app.rtsp.port)
        await pusher.request("ANNOUNCE", uri,
                             {"content-type": "application/sdp"},
                             loopback.VIDEO_SDP.encode())
        with pytest.raises(AssertionError, match="-> 461"):
            await pusher.request("SETUP", uri + "/trackID=1", {
                "transport": "RTP/AVP;unicast;mode=record"})
        await player.connect(app.rtsp.port)
        await player.request("DESCRIBE", uri)
        with pytest.raises(AssertionError, match="-> 461"):
            await player.request("SETUP", uri + "/trackID=1",
                                 {"transport": "RTP/AVP;unicast"})
        resp = await player.request("SETUP", uri + "/trackID=1", {
            "transport": "RTP/AVP;unicast;client_port=5000-5001"})
        t = rtsp.TransportSpec.parse(resp.headers["transport"])
        egress = app.rtsp.shared_egress
        assert t.server_port == (egress.rtp_port, egress.rtcp_port)
        assert t.client_port == (5000, 5001) and t.ssrc is not None
    finally:
        for c in clients:
            if c._task is not None:
                await c.close()
        await app.stop()


def test_output_hooks_default_to_the_python_loop():
    """The engine's native hooks default to None / -1 / False; a UDP
    output names its RTP address, an interleaved one its socket."""
    out = CollectingOutput()
    assert (out.native_addr, out.stream_fd) == (None, -1)
    assert not out.engine_writable() and not out.push_tail(b"x")
    udp = UdpOutput(SharedUdpEgress("127.0.0.1"), "127.0.0.1", 5000, 5001)
    assert udp.native_addr == ("127.0.0.1", 5000) and udp.stream_fd == -1
    a, b = socket.socketpair()
    try:
        tr = _Transport(a)
        il = InterleavedOutput(tr, 0, 1)
        assert il.stream_fd == a.fileno() and il.engine_writable()
        tr.buffered = 1
        assert not il.engine_writable()
        assert il.push_tail(b"tail") and tr.written == [b"tail"]
    finally:
        a.close()
        b.close()


class _Transport:
    """The few ``asyncio.WriteTransport`` calls an interleaved output
    makes."""

    def __init__(self, sock):
        self.sock, self.buffered, self.written = sock, 0, []

    def get_extra_info(self, name):
        return self.sock if name == "socket" else None

    def is_closing(self):
        return False

    def get_write_buffer_size(self):
        return self.buffered

    def write(self, data):
        self.written.append(data)


class _BrokenOutput(CollectingOutput):
    """An output whose every send raises (a bug in one output's code)."""

    def send_bytes(self, data, *, is_rtcp):
        raise OSError("broken output")


def _scheduler_down(*_args):
    raise RuntimeError("scheduler down")


@pytest.mark.parametrize("fault", ["stream_step", "begin_wake"])
def test_one_stream_error_leaves_the_wake_to_the_others(fault, monkeypatch):
    """Two streams (the megabatch engages).  ``stream_step``: the first
    stream's first output raises on every send; the second stream's bytes
    still equal ``RelayStream.reflect``'s and the scheduler dispatches a
    pass every wake.  ``begin_wake``: the scheduler raises; both streams
    are served one by one from their own rings."""
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0),
                          device="cpu")
    bad, good = (next(iter(app.registry.find_or_create(
        path, loopback.VIDEO_SDP).streams.values()))
        for path in ("/live/bad", "/live/good"))
    twins = {id(s): RelayStream(s.info, s.settings) for s in (bad, good)}
    rng = np.random.default_rng(61)
    for stream in (bad, good):
        for i in range(3):
            kw = dict(ssrc=int(rng.integers(1 << 32)),
                      out_seq_start=int(rng.integers(1 << 16)),
                      out_ts_start=int(rng.integers(1 << 32)))
            broken = fault == "stream_step" and stream is bad and i == 0
            stream.add_output((_BrokenOutput if broken
                               else CollectingOutput)(**kw))
            twins[id(stream)].add_output(CollectingOutput(**kw))
    if fault == "begin_wake":
        monkeypatch.setattr(app.megabatch, "begin_wake", _scheduler_down)
    pkts = synth.paced_gop(rng, seq0=65530, ts0=0xFFFFF000, ssrc=0x51,
                           frames=12, packets_per_frame=4)
    passes = []
    for wake in range(6):
        t = now_ms()
        for pkt in pkts[8 * wake:8 * (wake + 1)]:
            for s in (bad, good, *twins.values()):
                s.push_rtp(pkt, t)
        app.reflect_all()
        t = now_ms()
        for twin in twins.values():
            twin.reflect(t)
        passes.append(app.megabatch.passes)
    assert app.pump_errors == 6                 # one a wake, counted
    served = (good,) if fault == "stream_step" else (bad, good)
    for stream in served:
        outs, want = stream.outputs, twins[id(stream)].outputs
        assert all(o.rtp_packets for o in outs)
        assert [o.rtp_packets for o in outs] == [o.rtp_packets for o in want]
    if fault == "stream_step":
        # a pass dispatched every wake (the first wake primes one too)
        assert all(b > a for a, b in zip([0] + passes, passes))
        assert app.megabatch.stats()["mismatches"] == 0
    else:
        assert passes == [0] * 6
        assert app.stats()["device_param_refreshes"] >= 2


def _rr(sender: int, *reported: int) -> bytes:
    """A receiver report naming ``reported`` in its report blocks."""
    return (struct.pack("!BBHI", 0x80 | len(reported), rtcp.RR,
                        1 + 6 * len(reported), sender)
            + b"".join(struct.pack("!IIIIII", s, 0, 7, 0, 0, 0)
                       for s in reported))


def test_rr_report_ssrcs_matches_the_reference_parse():
    """The report-block SSRCs an RR names (what routes it and proves
    ownership) come from the port's full parse exactly as from the
    reference's; what is not RTCP raises, and less than a header is an
    empty compound."""
    sr = ref_rtcp.SenderReport(5, 1 << 40, 9, 3, 4, [
        ref_rtcp.ReportBlock(77, 0, 0, 1, 0, 0, 0)]).to_bytes()
    rr = ref_rtcp.ReceiverReport(6, [ref_rtcp.ReportBlock(
        s, 3, -1, 9, 2, 0, 0) for s in (11, 12)]).to_bytes()
    bye = ref_rtcp.Bye([6]).to_bytes()
    for data in (rr, sr + rr, rr + bye, sr, _rr(1), _rr(2, 99, 1 << 31)):
        want = {b.ssrc for p in ref_rtcp.parse_compound(data)
                if isinstance(p, ref_rtcp.ReceiverReport) for b in p.reports}
        assert {b.ssrc for p in rtcp.parse_compound(data)
                if isinstance(p, rtcp.ReceiverReport)
                for b in p.reports} == want
    for bad in (rr[:-4], b"\x40" + rr[1:], b"junk" * 4):
        with pytest.raises(rtcp.RtcpError):
            rtcp.parse_compound(bad)
        with pytest.raises(ref_rtcp.RtcpError):
            ref_rtcp.parse_compound(bad)
    for empty in (b"", b"\x80"):          # no packet: names no SSRC
        assert rtcp.parse_compound(empty) == \
            ref_rtcp.parse_compound(empty) == []


@pytest.mark.parametrize("proof", ["source_address", "report_block_ssrc"])
async def test_udp_player_kept_alive_by_rtcp_alone(proof):
    """Two UDP players whose RTSP connections go silent after PLAY, with a
    2 s idle limit: the one that sends RRs to the shared pair's RTCP port
    (from the RTCP port it registered, or from another naming its SSRC)
    stays; the silent one is closed."""
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1", rtsp_timeout_sec=2,
        push_timeout_sec=60), device="cpu")
    await app.start()
    pusher, live, silent = (loopback.MiniClient() for _ in range(3))
    other = None
    try:
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/cam0"
        await pusher.connect(app.rtsp.port)
        await pusher.request("ANNOUNCE", uri,
                             {"content-type": "application/sdp"},
                             loopback.VIDEO_SDP.encode())
        ssrc = {}
        for player in (live, silent):
            await player.connect(app.rtsp.port)
            ports = await player.udp_ports()
            await player.request("DESCRIBE", uri)
            resp = await player.request("SETUP", uri + "/trackID=1", {
                "transport": f"RTP/AVP;unicast;client_port={ports}"})
            ssrc[player] = rtsp.TransportSpec.parse(
                resp.headers["transport"]).ssrc
            await player.request("PLAY", uri)
        server_rtcp = ("127.0.0.1", app.rtsp.shared_egress.rtcp_port)
        if proof == "source_address":
            send, report = live._udp[1].sendto, _rr(0x1234)
        else:
            loop = asyncio.get_running_loop()
            other, _ = await loop.create_datagram_endpoint(
                asyncio.DatagramProtocol, local_addr=("127.0.0.1", 0))
            send, report = other.sendto, _rr(0x1234, ssrc[live])
        for _ in range(23):                     # 4.6 s: past two sweeps
            send(report, server_rtcp)
            send(b"not rtcp", server_rtcp)
            await asyncio.sleep(0.2)
        assert silent._task.done(), "the silent player was not closed"
        assert not live._task.done(), "the player sending RRs was closed"
        assert app.rtsp.rtcp_in >= 20
        assert app.rtsp.shared_egress.rtcp_proto.received >= 40
    finally:
        if other is not None:
            other.close()
        for c in (pusher, live, silent):
            if c._task is not None:
                await c.close()
        await app.stop()


async def test_rtcp_meta_and_thinning_through_the_cli_on_cpu():
    res = await loopback.serve_and_check(
        "cpu", np.random.default_rng(11), harness=loopback.push_play_av,
        players=[dict(transport="udp"), dict(transport="udp", meta=True),
                 dict(transport="udp", lossy=True),
                 dict(transport="tcp", lossy=True)],
        gops=6, frames=15, packets_per_frame=4, body_len=(40, 200),
        rr_every_s=0.25, loss_after_s=0.3, deadline_s=10)
    srs = res["srs"]
    assert all(srs[k]["relayed"] > 0 for k in ("plain/udp", "lossy/tcp"))
    assert sum(v["originated"] for v in srs.values()) > 0
    assert len(res["thinned"]) == 2
    assert all(got < span for got, span in res["thinned"])
    assert res["delivered"]["meta"] > 0
    assert all(n > 0 for n in res["upstream_rrs"].values())
    stats = res["server_stats"]
    assert stats["rtcp"]["rr"] > 0 and stats["rtcp"]["in"] > 0
    assert stats["batch_sent"] >= res["delivered"]["meta"]
    assert stats["native_sent"] >= res["plain_udp_packets"]
    assert stats["send_errors"] == 0 and stats["missing_params"] == 0


async def test_forged_rtcp_neither_keeps_alive_nor_thins():
    """A UDP player whose RTSP connection is silent, and a forger on an
    unregistered address whose RR, NADU, NACK and APP name no SSRC the
    player owns: the player is closed at its idle limit, its level never
    moves, and the NACK and APP are counted."""
    app = StreamingServer(ServerConfig(
        rtsp_port=0, service_port=0, bind_ip="127.0.0.1", rtsp_timeout_sec=2,
        push_timeout_sec=60), device="cpu")
    await app.start()
    pusher, player = loopback.MiniClient(), loopback.MiniClient()
    forger = None
    try:
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/cam0"
        await pusher.connect(app.rtsp.port)
        await pusher.request("ANNOUNCE", uri,
                             {"content-type": "application/sdp"},
                             loopback.VIDEO_SDP.encode())
        await player.connect(app.rtsp.port)
        ports = await player.udp_ports()
        await player.request("DESCRIBE", uri)
        resp = await player.request("SETUP", uri + "/trackID=1", {
            "transport": f"RTP/AVP;unicast;client_port={ports}"})
        ssrc = rtsp.TransportSpec.parse(resp.headers["transport"]).ssrc
        await player.request("PLAY", uri)
        (out,) = next(iter(app.registry.sessions.values())) \
            .streams[1].outputs
        forged = (_rr(0x1234, ssrc ^ 1, ssrc ^ 2)
                  + rtcp.Nadu(0x1234, [rtcp.NaduBlock(ssrc ^ 1, 0, 0, 0,
                                                      0)]).to_bytes()
                  + rtcp.GenericNack.from_seqs(0x1234, ssrc, [1, 2])
                  .to_bytes()
                  + rtcp.App(ssrc, "qtak", data=bytes(4)).to_bytes())
        forger, _ = await asyncio.get_running_loop().create_datagram_endpoint(
            asyncio.DatagramProtocol, local_addr=("127.0.0.1", 0))
        for _ in range(18):                     # 3.6 s: past two sweeps
            forger.sendto(forged, ("127.0.0.1",
                                   app.rtsp.shared_egress.rtcp_port))
            await asyncio.sleep(0.2)
        assert player._task.done(), "forged RTCP kept the player alive"
        assert out.thinning.controller.level == 0
        counts = app.rtsp.rtcp_counts
        assert app.rtsp.rtcp_in >= 15 and counts["rr"] == counts["nadu"] == 0
        assert counts["nack"] == counts["app"] == app.rtsp.rtcp_in
    finally:
        if forger is not None:
            forger.close()
        for c in (pusher, player):
            if c._task is not None:
                await c.close()
        await app.stop()


async def test_a_closing_pusher_clears_only_its_own_upstream_rr_writer():
    """A pusher's interleaved SETUP installs the stream's upstream-RR
    writer on its RTCP channel; a second pusher that re-ANNOUNCEs the
    path takes it over, and the first one's close leaves it alone."""
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       bind_ip="127.0.0.1"), device="cpu")
    await app.start()
    first, second = loopback.MiniClient(), loopback.MiniClient()
    try:
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/cam0"
        for c in (first, second):
            await c.connect(app.rtsp.port)
            await c.request("ANNOUNCE", uri,
                            {"content-type": "application/sdp"},
                            loopback.VIDEO_SDP.encode())
            await c.request("SETUP", uri + "/trackID=1", {
                "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;"
                             "mode=record"})
        st = app.registry.find("/live/cam0").streams[1]
        owner = st.upstream_rtcp_owner
        assert owner is not None and st.upstream_rtcp is not None
        st.push_rtp(synth.h264_packet(1, 0, 5, ssrc=0x99, body=bytes(20)),
                    now_ms())
        await first.close()
        await asyncio.sleep(0.2)
        assert st.upstream_rtcp_owner is owner and owner.closed is False
        assert st.send_upstream_rr(now_ms() + 10_000)
        await asyncio.sleep(0.2)
        for _t, data in second.channels[1]:    # the pump's and this one
            (rr,) = rtcp.parse_compound(data)
            assert rr.ssrc == st.reporter_ssrc and rr.reports[0].ssrc == 0x99
        assert not first.channels.get(1)
        await second.close()
        await asyncio.sleep(0.2)
        assert st.upstream_rtcp is None and st.upstream_rtcp_owner is None
    finally:
        for c in (first, second):
            if c._task is not None and not c._task.done():
                await c.close()
        await app.stop()


# ------------------------------------------------------------ loss tiers
_TIER_HEADERS = [
    {"x-fec": "parity"},
    {"x-retransmit": "our-retransmit"},
    {"x-retransmit": "our-retransmit;window=64"},
    {"x-fec": "parity", "x-retransmit": "our-retransmit"},
    {"x-fec": "parity", "x-rtp-meta-info": "tt;sq;md"},
    {"x-fec": "xor-please"},
]


def _reference_grants(headers: dict, is_tcp: bool) -> dict:
    """The headers the reference server adds to a SETUP reply for these
    loss-tier requests (its ``_negotiate_retransmit`` then ``_attach_fec``
    on a plain output)."""
    conn = type("Conn", (), {})()
    conn.server = type("Srv", (), {})()
    conn.server.config = RefConfig()
    req = type("Req", (), {})()
    req.headers = headers
    t = rtsp.TransportSpec(protocol="RTP/AVP", is_tcp=is_tcp)
    out = RefOutput(ssrc=1)
    if "x-rtp-meta-info" in headers:
        out.meta_field_ids = {"tt": 0, "sq": 1, "md": -1}
    out, extra = RefConnection._negotiate_retransmit(conn, req, out, t)
    extra = dict(extra)
    extra.update(RefConnection._attach_fec(conn, req, out, t))
    return {k.lower(): v for k, v in extra.items()
            if k.lower() in ("x-fec", "x-retransmit")}


async def test_loss_tier_grants_match_the_reference():
    """Each SETUP's ``x-FEC``/``x-Retransmit`` reply headers equal the
    reference's, byte for byte; the outputs are armed to match, and an
    interleaved SETUP gets neither."""
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       bind_ip="127.0.0.1"), device="cpu")
    await app.start()
    pusher = loopback.MiniClient()
    players = []
    try:
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/cam0"
        await pusher.connect(app.rtsp.port)
        await pusher.request("ANNOUNCE", uri,
                             {"content-type": "application/sdp"},
                             loopback.VIDEO_SDP.encode())
        for headers in _TIER_HEADERS:
            for is_tcp in (False, True):
                player = loopback.MiniClient()
                players.append(player)
                await player.connect(app.rtsp.port)
                await player.request("DESCRIBE", uri)
                spec = ("RTP/AVP/TCP;unicast;interleaved=0-1" if is_tcp else
                        f"RTP/AVP;unicast;client_port="
                        f"{await player.udp_ports()}")
                resp = await player.request("SETUP", uri + "/trackID=1",
                                            {"transport": spec, **headers})
                got = {k: v for k, v in resp.headers.items()
                       if k in ("x-fec", "x-retransmit")}
                want = _reference_grants(headers, is_tcp)
                assert got == want, (headers, is_tcp)
                conn = next(c for c in app.rtsp.connections
                            if c.session_id == player.session)
                out = conn.player_tracks[1]
                assert isinstance(out, ReliableUdpOutput) == \
                    ("x-retransmit" in want)
                assert (out.fec is not None) == ("x-fec" in want)
                if "x-fec" in want:
                    assert want["x-fec"] == "parity;pt=127;rtx-pt=126"
                    assert out.fec.cfg.device == "cpu"
                if is_tcp:
                    assert want == {}
    finally:
        for c in (pusher, *players):
            if c._task is not None:
                await c.close()
        await app.stop()


async def test_lossy_udp_players_through_the_cli_on_cpu():
    """Plain, FEC and reliable UDP players with seeded drops, RRs, generic
    NACKs and 'qtak' acks: every player's span ends byte-equal to the
    oracle; parity and RTX did the FEC players' repairs, resends the
    reliable one's, and the stats count them."""
    res = await loopback.serve_and_check(
        "cpu", np.random.default_rng(5), harness=loopback.push_play_lossy,
        players=[dict(kind="plain"), dict(kind="fec", drop=0.1),
                 dict(kind="fec", drop=0.08),
                 dict(kind="reliable", drop=0.05)],
        gops=5, frames=15, packets_per_frame=4, body_len=(40, 200),
        rr_every_s=0.2, deadline_s=15)
    assert res["players"] == 4
    assert res["delivered"]["fec"] > 0 and res["delivered"]["reliable"] > 0
    assert all(p["dropped"] > 0 and p["parity"] > 0 and p["rtx"] > 0
               for p in res["fec_players"])
    (rel,) = res["reliable_players"]
    assert rel["dropped"] > 0 and rel["acks"] >= rel["packets"]
    st = res["server_stats"]
    fec = st["fec"]
    assert fec["oracle_mismatches"] == 0 and st["pump_errors"] == 0
    assert fec["device_passes"] > 0 and fec["parity_sent"] > 0
    assert fec["rtx_sent"] > 0 and fec["rtx_giveups"] == 0
    assert st["reliable"]["resends"] >= rel["dropped"] > 0
    assert st["reliable"]["giveups"] == 0
    assert st["reliable"]["acks"] == rel["packets"]
    assert st["rtcp"]["nack"] == sum(p["nacks"] for p in res["fec_players"])
    # FEC players' media left through the native scatter, the reliable
    # player's through the batch-header rung
    assert st["batch_sent"] == rel["packets"]
    assert st["kernel_launches"]["ed_gf_parity"] == 0     # CPU: plain
    assert st["send_errors"] == 0 and st["missing_params"] == 0
    assert st["rtcp"]["socket_drops"] == 0
    assert st["reliable"]["rto_ms_max"] >= BandwidthTracker.MIN_RTO_MS


async def test_shared_rtcp_socket_drains_a_burst_in_batches():
    """A burst of acks queued on the shared RTCP socket is taken up to
    ``RTCP_DRAIN_MAX`` a readiness callback (an asyncio endpoint takes one
    a loop turn), none dropped, with its buffer and drops in the socket's stats; RTCP goes
    back out through the same socket."""
    got = []
    egress = SharedUdpEgress("127.0.0.1",
                             on_rtcp=lambda data, addr: got.append(data))
    await egress.start()
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        tx.bind(("127.0.0.1", 0))
        acks = [build_ack(7, seq) for seq in range(512)]
        for ack in acks:
            tx.sendto(ack, ("127.0.0.1", egress.rtcp_port))
        turns = 0
        while len(got) < len(acks) and turns < 100:
            await asyncio.sleep(0)
            turns += 1
        assert got == acks
        # RTCP_DRAIN_MAX a callback; an asyncio endpoint takes one a turn
        assert turns <= 2 * len(acks) // RTCP_DRAIN_MAX + 2
        assert egress.rtcp_proto.received == len(acks)
        st = egress.rtcp_socket_stats()
        assert st["drops"] == 0
        assert st["rcvbuf"] == egress.rtcp_sock.getsockopt(
            socket.SOL_SOCKET, socket.SO_RCVBUF) > 0
        reply = build_ack(9, 1)
        assert egress.send_rtcp(reply, tx.getsockname()) is \
            WriteResult.OK
        tx.settimeout(5)
        assert tx.recvfrom(2048) == (reply, ("127.0.0.1", egress.rtcp_port))
    finally:
        tx.close()
        egress.close()
    assert egress.rtcp_sock is None
    assert egress.send_rtcp(b"x", ("127.0.0.1", 9)) is \
        WriteResult.ERROR


async def test_forged_nack_and_app_neither_refresh_nor_replay():
    """A FEC player and a reliable player, both silent on RTSP: a NACK and
    an APP naming SSRCs they do not own, from an unregistered address,
    move neither idle clock and replay nothing; the same NACK and ack
    from the players' registered addresses do both."""
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       bind_ip="127.0.0.1"), device="cpu")
    await app.start()
    pusher = loopback.MiniClient()
    fec_pl, rel_pl = loopback.MiniClient(), loopback.MiniClient()
    forger = None
    try:
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/cam0"
        await pusher.connect(app.rtsp.port)
        await pusher.request("ANNOUNCE", uri,
                             {"content-type": "application/sdp"},
                             loopback.VIDEO_SDP.encode())
        await pusher.request("SETUP", uri + "/trackID=1", {
            "transport": "RTP/AVP/TCP;unicast;interleaved=0-1;mode=record"})
        await pusher.request("RECORD", uri)
        rng = np.random.default_rng(3)
        pkts = synth.paced_gop(rng, seq0=10, ts0=0, ssrc=0x99, frames=4,
                               packets_per_frame=4, body_len=(40, 80))
        for pkt in pkts[:8]:
            pusher.push(pkt)
        await asyncio.sleep(0.2)
        ssrc = {}
        for player, hdr in ((fec_pl, {"x-fec": "parity"}),
                            (rel_pl, {"x-retransmit": "our-retransmit"})):
            await player.connect(app.rtsp.port)
            ports = await player.udp_ports()
            await player.request("DESCRIBE", uri)
            resp = await player.request("SETUP", uri + "/trackID=1", {
                "transport": f"RTP/AVP;unicast;client_port={ports}", **hdr})
            ssrc[player] = rtsp.TransportSpec.parse(
                resp.headers["transport"]).ssrc
            await player.request("PLAY", uri)
        for pkt in pkts[8:]:
            pusher.push(pkt)
        await asyncio.sleep(0.3)
        conns = {p: next(c for c in app.rtsp.connections
                         if c.session_id == p.session)
                 for p in (fec_pl, rel_pl)}
        st = next(iter(app.registry.sessions.values())).streams[1]
        rel_out = conns[rel_pl].player_tracks[1]
        in_flight = rel_out.resender.in_flight
        assert in_flight > 0 and st.fec is not None
        pending = sorted(rel_out.resender.pending)
        before = {p: c.last_activity for p, c in conns.items()}
        server = ("127.0.0.1", app.rtsp.shared_egress.rtcp_port)
        forged = (rtcp.GenericNack.from_seqs(0x1234, ssrc[fec_pl] ^ 1,
                                             [1, 2, 3]).to_bytes()
                  + build_ack(ssrc[rel_pl] ^ 1, pending[0], 0xFFFFFFFF))
        forger, _ = await asyncio.get_running_loop().create_datagram_endpoint(
            asyncio.DatagramProtocol, local_addr=("127.0.0.1", 0))
        for _ in range(3):
            forger.sendto(forged, server)
        await asyncio.sleep(0.3)
        assert {p: c.last_activity for p, c in conns.items()} == before
        assert st.fec.rtx_sent == 0
        assert rel_out.resender.in_flight == in_flight
        assert app.rtsp.rtcp_counts["nack"] == app.rtsp.rtcp_counts["app"] \
            == 3
        fec_seq0 = conns[fec_pl].player_tracks[1].rewrite.out_seq_start
        fec_pl._udp[1].sendto(rtcp.GenericNack.from_seqs(
            0x1234, ssrc[fec_pl] ^ 1, [fec_seq0 + 1]).to_bytes(), server)
        rel_pl._udp[1].sendto(build_ack(ssrc[rel_pl] ^ 1, pending[0]),
                              server)
        await asyncio.sleep(0.3)
        for p, c in conns.items():
            assert c.last_activity > before[p]
        assert st.fec.rtx_sent == 1
        assert rel_out.resender.in_flight == in_flight - 1
        assert app.rtsp.reliable_acks == 1
    finally:
        if forger is not None:
            forger.close()
        for c in (pusher, fec_pl, rel_pl):
            if c._task is not None:
                await c.close()
        await app.stop()


async def _parameter_replies(port: int) -> list:
    """OPTIONS, then GET_PARAMETER and SET_PARAMETER without a session
    and inside a pusher's session: (method, status, CSeq, Session, Public)
    of each reply."""
    client = loopback.MiniClient()
    await client.connect(port)
    uri = f"rtsp://127.0.0.1:{port}/live/keepalive"
    out = []

    async def ask(method, headers=None, body=b"", track=""):
        client.cseq += 1
        h = {"cseq": str(client.cseq), **(headers or {})}
        if client.session:
            h["session"] = client.session
        client.writer.write(rtsp.RtspRequest(method, uri + track, h,
                                             body).to_bytes())
        resp = await asyncio.wait_for(client.responses.get(), 30)
        if "session" in resp.headers:
            client.session = resp.headers["session"].split(";")[0]
        out.append((method, resp.status, resp.headers.get("cseq"),
                    resp.headers.get("session"), resp.headers.get("public")))

    try:
        await ask("OPTIONS")
        await ask("GET_PARAMETER")
        await ask("SET_PARAMETER", {"content-type": "text/parameters"},
                  b"barparam: barstuff\r\n")
        await ask("ANNOUNCE", {"content-type": "application/sdp"},
                  loopback.VIDEO_SDP.encode())
        await ask("SETUP", {"transport": "RTP/AVP/TCP;unicast;"
                            "interleaved=0-1;mode=record"},
                  track="/trackID=1")
        await ask("GET_PARAMETER")
        await ask("SET_PARAMETER", {"content-type": "text/parameters"},
                  b"barparam: barstuff\r\n")
    finally:
        await client.close()
    return out


async def test_get_and_set_parameter_answer_as_the_reference():
    """RTSP players send GET_PARAMETER as a keep-alive: the port lists
    both parameter methods in OPTIONS and answers each 200 with the
    request's CSeq, and with the Session once SETUP made one, exactly as
    the reference's server does."""
    from easydarwin_tpu.server import ServerConfig as RefServerConfig
    from easydarwin_tpu.server import StreamingServer as RefServer
    mine = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                        bind_ip="127.0.0.1"), device="cpu")
    ref = RefServer(RefServerConfig(rtsp_port=0, service_port=0,
                                    bind_ip="127.0.0.1"))
    await mine.start()
    await ref.start()
    try:
        got = await _parameter_replies(mine.rtsp.port)
        want = await _parameter_replies(ref.rtsp.port)
    finally:
        await mine.stop()
        await ref.stop()
    methods = {m.strip() for m in got[0][4].split(",")}
    assert {"GET_PARAMETER", "SET_PARAMETER"} <= methods
    assert methods == {m.strip() for m in want[0][4].split(",")}
    for (m, status, cseq, sess, _), (rm, rstatus, rcseq, rsess, _) in zip(
            got, want):
        assert (m, status, cseq) == (rm, rstatus, rcseq)
        assert (sess is None) == (rsess is None), m
    assert [g[1] for g in got] == [200] * 7
    assert got[1][3] is None and got[5][3] is not None
    assert got[5][3] == got[4][3] == got[6][3]


async def test_a_cpu_server_touches_nothing_of_cuda(monkeypatch):
    """``start`` warms the card only when the device is CUDA."""
    def no_cuda(*_a, **_k):
        raise AssertionError("a CPU server touched CUDA")
    monkeypatch.setattr(kernel_lib, "library", no_cuda)
    monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_stream", no_cuda)
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       bind_ip="127.0.0.1"), device="cpu")
    was_initialized = torch.cuda.is_initialized()
    await app.start()
    await app.stop()
    assert torch.cuda.is_initialized() == was_initialized
    assert app.stats()["wake_ms_first"] is None


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import easydarwin_tpu_torch, easydarwin_tpu_torch.__main__\n"
            "import easydarwin_tpu_torch.convert, easydarwin_tpu_torch.server\n"
            "import easydarwin_tpu_torch.ops.parse_kernel\n"
            "import easydarwin_tpu_torch.ops.device_ring\n"
            "import easydarwin_tpu_torch.native\n"
            "import easydarwin_tpu_torch.server.transports\n"
            "import easydarwin_tpu_torch.ops.transform_kernel\n"
            "import easydarwin_tpu_torch.models.transcode_pipeline\n"
            "import easydarwin_tpu_torch.models.mjpeg_ladder\n"
            "import easydarwin_tpu_torch.server.rest\n"
            "import easydarwin_tpu_torch.utils.loopback\n"
            "import easydarwin_tpu_torch.utils.mjpeg_loopback\n"
            "import easydarwin_tpu_torch.relay.fec\n"
            "import easydarwin_tpu_torch.relay.reliable\n"
            "import easydarwin_tpu_torch.ops.fec_kernel\n"
            "import easydarwin_tpu_torch.storage.codec\n"
            "import easydarwin_tpu_torch.codecs.h264_transform\n"
            "import easydarwin_tpu_torch.vod, easydarwin_tpu_torch.vod.cache\n"
            "import easydarwin_tpu_torch.vod.record\n"
            "import easydarwin_tpu_torch.vod.session\n"
            "import easydarwin_tpu_torch.utils.paths\n"
            "import easydarwin_tpu_torch.utils.vod_clips\n"
            "import easydarwin_tpu_torch.dvr, easydarwin_tpu_torch.dvr.spill\n"
            "import easydarwin_tpu_torch.dvr.timeshift\n"
            "import easydarwin_tpu_torch.dvr.service\n"
            "import easydarwin_tpu_torch.storage.service\n"
            "import easydarwin_tpu_torch.cluster.placement\n"
            "import easydarwin_tpu_torch.utils.dvr_loopback\n"
            "import easydarwin_tpu_torch.hls\n"
            "import easydarwin_tpu_torch.hls.requant\n"
            "import easydarwin_tpu_torch.codecs\n"
            "import easydarwin_tpu_torch.codecs.h264_requant\n"
            "import easydarwin_tpu_torch.codecs.h264_cabac\n"
            "import easydarwin_tpu_torch.ops.h264_kernel\n"
            "import easydarwin_tpu_torch.protocol.aac\n"
            "import easydarwin_tpu_torch.utils.hls_loopback\n"
            "import easydarwin_tpu_torch.codecs.h264_pred\n"
            "import easydarwin_tpu_torch.codecs.h264_closed_loop\n"
            "import easydarwin_tpu_torch.parallel\n"
            "import easydarwin_tpu_torch.parallel.megabench\n"
            "import easydarwin_tpu_torch.server.auth\n"
            "import easydarwin_tpu_torch.server.mp3\n"
            "import easydarwin_tpu_torch.server.supervisor\n"
            "import easydarwin_tpu_torch.server.config\n"
            "import easydarwin_tpu_torch.utils.logs\n"
            "import easydarwin_tpu_torch.utils.http_misc\n"
            "import easydarwin_tpu_torch.utils.client\n"
            "import easydarwin_tpu_torch.utils.surface_loopback\n"
            "import easydarwin_tpu_torch.relay.pull\n"
            "import easydarwin_tpu_torch.relay.source\n"
            "import easydarwin_tpu_torch.cluster.protocol\n"
            "import easydarwin_tpu_torch.obs\n"
            "import easydarwin_tpu_torch.obs.metrics\n"
            "import easydarwin_tpu_torch.obs.families\n"
            "import easydarwin_tpu_torch.obs.trace\n"
            "import easydarwin_tpu_torch.obs.events\n"
            "import easydarwin_tpu_torch.obs.flight\n"
            "import easydarwin_tpu_torch.obs.ledger\n"
            "import easydarwin_tpu_torch.obs.profile\n"
            "import easydarwin_tpu_torch.obs.slo\n"
            "import easydarwin_tpu_torch.obs.audience\n"
            "import easydarwin_tpu_torch.obs.fleet\n"
            "import easydarwin_tpu_torch.server.status\n"
            "import easydarwin_tpu_torch.server.dictionary\n"
            "import easydarwin_tpu_torch.server.modules\n"
            "import easydarwin_tpu_torch.server.admin\n"
            "import easydarwin_tpu_torch.cluster.redis_client\n"
            "import easydarwin_tpu_torch.cluster.presence\n"
            "import easydarwin_tpu_torch.cluster.capacity\n"
            "import easydarwin_tpu_torch.cluster.pull\n"
            "import easydarwin_tpu_torch.cluster.service\n"
            "import easydarwin_tpu_torch.utils.cluster_loopback\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'easydarwin_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_device_defaults_to_the_card():
    args = cli.build_parser().parse_args([])
    assert args.device == "cuda"
    assert cli.build_parser().parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--device", "mps"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["-p", "0", "--bind-ip", "127.0.0.1"])


def test_hls_device_option_runs_the_ladders_apart():
    """``--hls-device`` (``ServerConfig.hls_device``) puts the HLS requant
    rungs' B6 on another device than the server's; by default they share
    it."""
    assert cli.build_parser().parse_args([]).hls_device is None
    assert cli.build_parser().parse_args(
        ["--hls-device", "cpu"]).hls_device == "cpu"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--hls-device", "tpu"])
    app = StreamingServer(ServerConfig(hls_device="cpu"), device="cpu")
    assert app.hls.device == torch.device("cpu")
    assert StreamingServer(device="cpu").hls.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamingServer(ServerConfig(hls_device="cuda"), device="cpu")
