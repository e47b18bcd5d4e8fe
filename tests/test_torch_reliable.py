"""The port's reliable UDP (``easydarwin_tpu_torch.relay.reliable``)
against the reference (``easydarwin_tpu.relay.reliable``) on the CPU:

* ``BandwidthTracker``, ``PacketResender`` and ``OverbufferWindow`` go
  through the same state sequences on the same seeded operations;
* the 'qtak' ack's bytes and parse;
* ``ReliableUdpOutput`` end to end (cwnd gating, acks by output seq,
  RTO resends, give-ups), across a seq wrap, byte for byte;
* through ``FanoutEngine`` it takes the batch-header rung only (never the
  native, TCP or megabatch rungs) and its wire equals ``reflect``'s and
  the reference's;
* the reference's ack-ownership rule (``tests/test_advice_r4.py``): a
  fallback ack proves ownership only when it pops a packet, an ack routed
  by SSRC or by the registered address always does.
"""

import types

import numpy as np
import pytest

from easydarwin_tpu.protocol import rtcp as ref_rtcp
from easydarwin_tpu.protocol import sdp as ref_sdp
from easydarwin_tpu.relay import reliable as ref_rel
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.relay.stream import RelayStream as RefStream
from easydarwin_tpu.relay.stream import StreamSettings as RefSettings
from easydarwin_tpu.server.rtsp import RtspServer as RefRtspServer
from easydarwin_tpu_torch.protocol import rtcp, rtp, sdp
from easydarwin_tpu_torch.relay import reliable as rel
from easydarwin_tpu_torch.relay.fanout import FanoutEngine
from easydarwin_tpu_torch.relay.output import CollectingOutput, WriteResult
from easydarwin_tpu_torch.relay.session import SessionRegistry
from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
from easydarwin_tpu_torch.server import ServerConfig
from easydarwin_tpu_torch.server.rtsp import RtspServer

SDP_TXT = ("v=0\r\ns=f\r\nt=0 0\r\nm=video 0 RTP/AVP 96\r\n"
           "a=rtpmap:96 H264/90000\r\na=control:trackID=1\r\n")
WALL = 1_760_000_000.25


def _pkt(seq: int, size: int = 100, ts: int = 0, nal: int = 0x41) -> bytes:
    return rtp.RtpPacket(payload_type=96, seq=seq & 0xFFFF,
                         timestamp=ts & 0xFFFFFFFF, ssrc=1,
                         payload=bytes((nal,)) + bytes(size - 13)).to_bytes()


def _tracker_state(t) -> tuple:
    return (t.srtt_ms, t.rttvar_ms, t.cwnd, t.ssthresh, t.max_cwnd,
            t.bytes_in_flight, t.acks, t.losses, t.rto_ms)


def _resender_state(r) -> tuple:
    return (sorted((s, p.data, p.first_sent_ms, p.last_sent_ms, p.resends)
                   for s, p in r.pending.items()), r.resent, r.expired,
            r.in_flight)


# ------------------------------------------------------- state sequences
@pytest.mark.parametrize("seed", range(3))
def test_tracker_and_resender_state_sequences_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    port_t, ref_t = rel.BandwidthTracker(), ref_rel.BandwidthTracker()
    if seed == 2:
        port_t.max_cwnd = ref_t.max_cwnd = 9000.0
    port_r, ref_r = rel.PacketResender(port_t), ref_rel.PacketResender(ref_t)
    now, seq = 0, 65_500
    for _ in range(600):
        now += int(rng.integers(0, 120))
        op = rng.random()
        if op < 0.45:
            data = _pkt(seq, int(rng.integers(20, 1400)))
            port_r.add(seq, data, now)
            ref_r.add(seq, data, now)
            seq = (seq + 1) & 0xFFFF
        elif op < 0.8:
            s = (seq - int(rng.integers(1, 40))) & 0xFFFF
            assert port_r.ack(s, now) == ref_r.ack(s, now)
        elif op < 0.95:
            assert port_r.due_for_resend(now) == ref_r.due_for_resend(now)
        else:
            n = int(rng.integers(0, 3000))
            port_t.on_loss(n)
            ref_t.on_loss(n)
        assert port_r.next_deadline_ms(now) == ref_r.next_deadline_ms(now)
        assert _tracker_state(port_t) == _tracker_state(ref_t)
        assert _resender_state(port_r) == _resender_state(ref_r)
        assert port_t.can_send(1300) == ref_t.can_send(1300)
    assert port_r.resent > 0 and port_t.acks > 0


def test_overbuffer_window_equals_the_reference():
    rng = np.random.default_rng(7)
    for window in (10_000, 0, 3_000):
        port = rel.OverbufferWindow(window_ms=window)
        ref = ref_rel.OverbufferWindow(window_ms=window)
        for _ in range(200):
            playout, now = (int(x) for x in rng.integers(0, 40_000, 2))
            assert port.can_send(playout, now) == ref.can_send(playout, now)
            assert port.suggested_wakeup(playout, now) == \
                ref.suggested_wakeup(playout, now)


def test_ack_bytes_and_parse_equal_the_reference():
    rng = np.random.default_rng(1)
    for _ in range(50):
        ssrc, first = int(rng.integers(1 << 32)), int(rng.integers(1 << 16))
        mask = int(rng.integers(1 << 32))
        raw = rel.build_ack(ssrc, first, mask)
        assert raw == ref_rel.build_ack(ssrc, first, mask)
        (app,) = rtcp.parse_compound(raw)
        (ref_app,) = ref_rtcp.parse_compound(raw)
        assert rel.parse_ack(app) == ref_rel.parse_ack(ref_app)
        assert rel.parse_ack(app)[0] == first
    assert rel.parse_ack(rtcp.App(1, "xxxx", data=bytes(4))) == []
    legacy = rtcp.App(1, rel.LEGACY_ACK_NAME, data=bytes(8))
    assert rel.parse_ack(legacy) == [0]


# ------------------------------------------------------- the output, e2e
@pytest.mark.parametrize("seq0,window_kb", [(0, None), (65_520, None),
                                            (65_530, 8)])
def test_reliable_output_end_to_end_like_the_reference(seq0, window_kb):
    """Gated sends, acks by output seq (a mask spanning 65535 → 0 where
    the seqs wrap), RTO resends and give-ups: the same wire, window and
    counts as the reference."""
    clock = {"t": 1000}
    port = rel.ReliableUdpOutput(
        CollectingOutput(ssrc=9, out_seq_start=seq0), window_kb=window_kb,
        clock=lambda: clock["t"])
    ref = ref_rel.ReliableUdpOutput(
        RefOutput(ssrc=9, out_seq_start=seq0), window_kb=window_kb,
        clock=lambda: clock["t"])
    rng = np.random.default_rng(seq0)
    src = 700
    for step in range(400):
        clock["t"] += int(rng.integers(0, 60))
        op = rng.random()
        if op < 0.5:
            data = _pkt(src, int(rng.integers(100, 1300)))
            a, b = port.write_rtp(data), ref.write_rtp(data)
            assert a.name == b.name
            if a is WriteResult.OK:
                src += 1
        elif op < 0.85 and port.resender.pending:
            first = int(rng.choice(sorted(port.resender.pending)))
            if rng.random() < 0.3:
                first = (first + 40_000) & 0xFFFF      # misses the window
            mask = int(rng.integers(1 << 32))
            raw = rel.build_ack(9, first, mask)
            (app,) = rtcp.parse_compound(raw)
            (ref_app,) = ref_rtcp.parse_compound(raw)
            assert port.on_rtcp_app(app) == ref.on_rtcp_app(ref_app)
        else:
            assert port.tick() == ref.tick()
        assert port.transport.rtp_packets == ref.transport.rtp_packets
        assert _tracker_state(port.tracker) == _tracker_state(ref.tracker)
        assert _resender_state(port.resender) == \
            _resender_state(ref.resender)
    assert port.resender.resent > 0
    assert (port.packets_sent, port.bytes_sent) == (ref.packets_sent,
                                                    ref.bytes_sent)
    if seq0 >= 65_500:
        assert any(rtp.peek_seq(p) < 100 for p in port.transport.rtp_packets)
    if window_kb is not None:
        assert port.tracker.cwnd <= window_kb * 1024


def test_reliable_output_takes_only_the_batch_header_rung():
    """Through ``FanoutEngine`` a reliable output is served by the
    batch-header rung (every datagram enters its window), never by the
    native, TCP or megabatch rungs; its wire equals ``reflect``'s and the
    reference's."""
    rng = np.random.default_rng(3)
    streams = [RelayStream(sdp.parse(SDP_TXT).streams[0],
                           StreamSettings(bucket_delay_ms=0))
               for _ in range(2)]
    streams.append(RefStream(ref_sdp.parse(SDP_TXT).streams[0],
                             RefSettings(bucket_delay_ms=0)))
    outs = []
    for st, cls, mod in zip(streams, (CollectingOutput, CollectingOutput,
                                      RefOutput), (rel, rel, ref_rel)):
        st._wall_base = WALL
        out = mod.ReliableUdpOutput(cls(ssrc=0x77, out_seq_start=65_530,
                                        out_ts_start=5),
                                    clock=lambda: 0)
        out.transport.native_addr = ("127.0.0.1", 9)
        st.add_output(out)
        outs.append(out)
    eng = FanoutEngine(egress_fd=-1, device="cpu")
    assert eng.split_flat(eng._flat_outputs(streams[1]))[3] == []  # unprimed
    t = 1000
    for i in range(120):
        pkt = _pkt(30_000 + i, int(rng.integers(100, 1200)), ts=3000 * i,
                   nal=0x65 if i % 30 == 0 else 0x41)
        for st in streams:
            st.push_rtp(pkt, t)
        t += 10
        streams[0].reflect(t)
        eng.step(streams[1], t)
        streams[2].reflect(t)
        flat = eng._flat_outputs(streams[1])
        assert eng.fast_from_flat(flat) == []
        assert [o for o, _ in eng.split_flat(flat)[3]] == [outs[1]]
        if i % 4 == 3:                     # ack all but the newest
            for out in outs:
                for s in list(out.resender.pending)[:-1]:
                    out.resender.ack(s, t)
    assert streams[1].tickable_outputs == [outs[1]]
    assert outs[0].transport.rtp_packets == outs[2].transport.rtp_packets
    assert outs[1].transport.rtp_packets == outs[2].transport.rtp_packets
    assert eng.native_sent == 0 and eng.batch_sent == outs[1].packets_sent
    assert eng.batch_sent > 0 and eng.megabatch_installs == 0


# ------------------------------------------------ ack ownership (advice r4)
class _Conn:
    """The parts of an RTSP connection ``on_client_rtcp`` reads."""

    def __init__(self, output):
        self.player_tracks = {1: output}
        self.last_activity = 0.0
        self.relay = None


def _owner_case(case: str):
    """The reference and the port dispatching the same APP to a
    connection with one reliable track; returns, for each, whether the
    idle clock moved and how many packets stayed in flight."""
    out = {}
    for side in ("ref", "port"):
        mod = ref_rel if side == "ref" else rel
        inner = (RefOutput if side == "ref" else CollectingOutput)(
            ssrc=0x42, out_seq_start=100)
        inner.rtcp_addr = ("10.0.0.1", 5001)
        reliable = mod.ReliableUdpOutput(inner, clock=lambda: 1000)
        wire = _pkt(700)
        assert reliable.send_bytes(wire, is_rtcp=False).name == "OK"
        seq = rtp.peek_seq(wire)
        ack = {"forged": mod.build_ack(0xDEAD, first_seq=9999),
               "fallback": mod.build_ack(0xDEAD, first_seq=seq),
               "owned_ssrc": mod.build_ack(0x42, first_seq=1)}[case]
        if side == "ref":
            conn = types.SimpleNamespace(
                player_tracks={1: types.SimpleNamespace(output=reliable)},
                last_activity=0.0)
            RefRtspServer.on_client_rtcp(types.SimpleNamespace(stats={}),
                                         conn, ack, ("6.6.6.6", 9999))
        else:
            srv = RtspServer(ServerConfig(), SessionRegistry(),
                             device="cpu")
            conn = _Conn(reliable)
            srv.note_player_output(conn, reliable)
            if case == "owned_ssrc":
                # from an unregistered address on the shared pair: routed
                # by the SSRC the APP carries
                srv.on_client_rtcp(ack, addr=("6.6.6.6", 9999))
            else:
                # on the connection, from no registered address
                srv.on_client_rtcp(ack, conn=conn)
        out[side] = (conn.last_activity > 0.0, reliable.resender.in_flight)
    return out


@pytest.mark.parametrize("case,want", [("forged", (False, 1)),
                                       ("fallback", (True, 0)),
                                       ("owned_ssrc", (True, 1))])
def test_ack_ownership_rule_like_the_reference(case, want):
    got = _owner_case(case)
    assert got["port"] == got["ref"] == want


def test_ack_from_the_registered_address_and_forged_acks_on_the_pair():
    srv = RtspServer(ServerConfig(), SessionRegistry(), device="cpu")
    inner = CollectingOutput(ssrc=0x42, out_seq_start=100)
    inner.rtcp_addr = ("10.0.0.1", 5001)
    reliable = rel.ReliableUdpOutput(inner, clock=lambda: 1000)
    conn = _Conn(reliable)
    srv.note_player_output(conn, reliable)
    for i in range(3):
        reliable.send_bytes(_pkt(700 + i), is_rtcp=False)
    # a forged ack on the shared pair: unknown address, unowned SSRC
    srv.on_client_rtcp(rel.build_ack(0xDEAD, first_seq=700,
                                     extra_mask=0xFFFFFFFF),
                       addr=("6.6.6.6", 9))
    assert conn.last_activity == 0.0 and reliable.resender.in_flight == 3
    # from the registered address, whatever SSRC it carries
    srv.on_client_rtcp(rel.build_ack(0xDEAD, first_seq=700,
                                     extra_mask=1 << 31),
                       addr=("10.0.0.1", 5001))
    assert conn.last_activity > 0.0 and reliable.resender.in_flight == 1
    assert srv.reliable_acks == 2 and srv.rtcp_counts["app"] == 2
