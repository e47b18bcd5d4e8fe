"""The port's RTCP and meta-info tier ≡ the JAX package's.

* every RTCP packet type, and every x-RTP-Meta-Info packet and header,
  builds to the same bytes in both packages and parses to the same
  fields; ``rebase_compound``, ``rewrite_compound_ssrc`` and
  ``build_server_compound`` give equal bytes for equal inputs;
* a relayed SR is rebased onto the output's timeline, an SR is
  originated on the 5 s cadence when the pusher sends none, and none
  goes to an output whose rebase has not latched;
* the upstream RR's reception figures (RFC 3550 A.3) equal the
  reference's;
* one pushed sequence with SR and SDES compounds through the port's
  ``RelayStream.reflect``, its ``FanoutEngine.step`` (with the megabatch
  scheduler) and the JAX ``RelayStream.reflect``, with the wall-clock
  base, the reporter SSRC and the meta-info transmit time pinned, gives
  the same RTP and RTCP bytes per output: plain, meta-info, thinned from
  the start and thinned mid-stream.
"""

import dataclasses
import struct
import time

import numpy as np
import pytest

from easydarwin_tpu.protocol import rtcp as ref_rtcp
from easydarwin_tpu.protocol import rtp_meta as ref_meta
from easydarwin_tpu.protocol import sdp as ref_sdp
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.relay.stream import RelayStream as RefStream
from easydarwin_tpu.relay.stream import StreamSettings as RefSettings
from easydarwin_tpu_torch.protocol import rtcp, rtp_meta, sdp
from easydarwin_tpu_torch.relay.fanout import FanoutEngine
from easydarwin_tpu_torch.relay.megabatch import MegabatchScheduler
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.relay.stream import (SR_INTERVAL_MS, RelayStream,
                                               StreamSettings)
from easydarwin_tpu_torch.utils import synth

VIDEO_SDP = ("v=0\r\nm=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
             "a=control:trackID=1\r\n")
#: one pinned wall clock for both packages' SR NTP times and tt fields
WALL = 1_760_000_000.25


def _both(build):
    """``build(module)`` for the port's and the reference's rtcp."""
    return build(rtcp), build(ref_rtcp)


def _fields(pkts) -> list:
    return [(type(p).__name__, dataclasses.asdict(p)) for p in pkts]


def _blocks(m, rng, n):
    def u32():
        return int(rng.integers(1 << 32))
    return [m.ReportBlock(u32(), int(rng.integers(256)),
                          int(rng.integers(-(1 << 23), 1 << 23)), u32(),
                          u32(), u32(), u32())
            for _ in range(n)]


PACKETS = {
    "sr": lambda m, r: m.SenderReport(5, int(r.integers(1 << 63)), 9, 3, 4,
                                      _blocks(m, r, 2)),
    "sr_no_blocks": lambda m, r: m.SenderReport(7, 1 << 40, 1, 0, 0),
    "rr": lambda m, r: m.ReceiverReport(6, _blocks(m, r, 3)),
    "sdes": lambda m, r: m.Sdes([m.SdesChunk(11, "cam"),
                                 m.SdesChunk(12, "a-longer-cname")]),
    "bye": lambda m, r: m.Bye([6, 7], reason="gone"),
    "app": lambda m, r: m.App(3, "qtak", subtype=1, data=bytes(range(8))),
    "nadu": lambda m, r: m.Nadu(4, [m.NaduBlock(8, 120, 77, 3, 20),
                                    m.NaduBlock(9)]),
    "nack": lambda m, r: m.GenericNack.from_seqs(1, 2, [5, 6, 9, 30, 65535,
                                                        0]),
}


@pytest.mark.parametrize("kind", sorted(PACKETS))
def test_every_rtcp_packet_type_round_trips_like_the_reference(kind):
    port, ref = _both(lambda m: PACKETS[kind](m, np.random.default_rng(3)))
    data = port.to_bytes()
    assert data == ref.to_bytes()
    assert _fields(rtcp.parse_compound(data)) == \
        _fields(ref_rtcp.parse_compound(data))
    if kind == "nack":
        assert port.lost_seqs() == ref.lost_seqs()


def test_compounds_parse_and_rewrite_like_the_reference():
    rng = np.random.default_rng(8)
    build = [PACKETS[k] for k in sorted(PACKETS)]
    for _ in range(40):
        picks = rng.choice(len(build), int(rng.integers(1, 5)))
        data = b"".join(build[i](ref_rtcp, rng).to_bytes() for i in picks)
        assert _fields(rtcp.parse_compound(data)) == \
            _fields(ref_rtcp.parse_compound(data))
        assert rtcp.compound_has_sr(data) == ref_rtcp.compound_has_sr(data)
        ssrc = int(rng.integers(1 << 32))
        assert rtcp.rewrite_compound_ssrc(data, ssrc) == \
            ref_rtcp.rewrite_compound_ssrc(data, ssrc)
        kw = dict(unix_time=float(rng.uniform(1e9, 2e9)),
                  rtp_ts_now=int(rng.integers(1 << 32)),
                  packet_count=int(rng.integers(1 << 20)),
                  octet_count=int(rng.integers(1 << 30)))
        assert rtcp.rebase_compound(data, ssrc, **kw) == \
            ref_rtcp.rebase_compound(data, ssrc, **kw)
        cut = data[:int(rng.integers(1, len(data)))]
        try:
            want = _fields(ref_rtcp.parse_compound(cut))
        except ref_rtcp.RtcpError:
            with pytest.raises(rtcp.RtcpError):
                rtcp.parse_compound(cut)
        else:
            assert _fields(rtcp.parse_compound(cut)) == want


def test_server_compound_and_ntp_like_the_reference():
    for t in (0.0, 1.5, WALL, 2_208_988_800.999):
        assert rtcp.ntp_now(t) == ref_rtcp.ntp_now(t)
        assert rtcp.ntp_middle32(rtcp.ntp_now(t)) == \
            ref_rtcp.ntp_middle32(ref_rtcp.ntp_now(t))
    for bye in (False, True):
        kw = dict(unix_time=WALL, rtp_ts=0xFFFFFFF0, packet_count=12,
                  octet_count=3400, bye=bye)
        assert rtcp.build_server_compound(0xABCD, "easydarwin-tpu", **kw) == \
            ref_rtcp.build_server_compound(0xABCD, "easydarwin-tpu", **kw)


META_CASES = {
    "uncompressed": {"tt": -1, "sq": -1, "md": -1},
    "compressed": {"tt": 0, "sq": 1, "md": -1},
    "all": {"pp": 3, "tt": 0, "ft": 2, "pn": -1, "sq": 1, "md": -1},
    "md_only": {"md": -1},
}


@pytest.mark.parametrize("case", sorted(META_CASES))
def test_meta_info_packets_and_headers_like_the_reference(case):
    ids = META_CASES[case]
    header = ref_meta.build_header(ids)
    assert rtp_meta.build_header(ids) == header
    assert rtp_meta.parse_header(header) == ref_meta.parse_header(header)
    rng = np.random.default_rng(len(case))
    rtp_hdr = bytes(rng.integers(0, 256, 12, dtype=np.uint8))
    for media in (b"", bytes(rng.integers(0, 256, 300, dtype=np.uint8))):
        kw = dict(media=media, field_ids=ids, packet_position=7,
                  transmit_time=int(WALL * 1000), frame_type=1,
                  packet_number=99, seq=0xBEEF)
        kw = {k: v for k, v in kw.items()
              if k in ("media", "field_ids") or
              {"packet_position": "pp", "transmit_time": "tt",
               "frame_type": "ft", "packet_number": "pn",
               "seq": "sq"}[k] in ids}
        pkt = rtp_meta.build_packet(rtp_hdr, **kw)
        assert pkt == ref_meta.build_packet(rtp_hdr, **kw)
        assert dataclasses.asdict(rtp_meta.parse_packet(pkt, ids)) == \
            dataclasses.asdict(ref_meta.parse_packet(pkt, ids))
        assert rtp_meta.strip_to_rtp(pkt, ids) == \
            ref_meta.strip_to_rtp(pkt, ids) == rtp_hdr + media
    bad = rtp_meta.build_packet(rtp_hdr, media=b"xyz", field_ids=ids)[:-1]
    assert rtp_meta.parse_packet(bad, ids) is None
    assert ref_meta.parse_packet(bad, ids) is None


# --------------------------------------------------------- SR semantics
def _pkt(seq, ts, ssrc=0xFEED):
    return struct.pack("!BBHII", 0x80, 96, seq, ts, ssrc) + b"\x65" + bytes(30)


def _stream(**kw):
    st = RelayStream(sdp.parse(VIDEO_SDP).streams[0],
                     StreamSettings(bucket_delay_ms=0, **kw))
    st._wall_base = WALL
    return st


def _pusher_sr(m=rtcp, ssrc=0xFEED):
    return (m.SenderReport(ssrc, 0x11112222_33334444, 50_000, 7,
                           700).to_bytes()
            + m.Sdes([m.SdesChunk(ssrc, "pusher")]).to_bytes())


def _sr(compound):
    return next(p for p in rtcp.parse_compound(compound)
                if isinstance(p, rtcp.SenderReport))


def test_relayed_sr_is_rebased_onto_the_output_timeline():
    st = _stream()
    out = CollectingOutput(ssrc=0xAA, out_seq_start=100, out_ts_start=5000)
    st.add_output(out)
    st.push_rtp(_pkt(10, 90_000), 1000)
    st.push_rtp(_pkt(11, 93_000), 1500)
    st.push_rtcp(_pusher_sr(), 1500)
    st.reflect(2000)
    sr = _sr(out.rtcp_packets[0])
    assert sr.ssrc == 0xAA
    assert sr.ntp_ts == rtcp.ntp_now(WALL + 2.0)
    assert sr.rtp_ts == out.rewrite.map_ts(93_000 + 500 * 90)
    assert (sr.packet_count, sr.octet_count) == (out.packets_sent,
                                                 out.payload_octets)
    sdes = [p for p in rtcp.parse_compound(out.rtcp_packets[0])
            if isinstance(p, rtcp.Sdes)]
    assert sdes[0].chunks[0].ssrc == 0xAA and len(out.rtcp_packets) == 1


def test_sr_originated_on_its_cadence_and_never_before_the_latch():
    st = _stream(bucket_size=1)
    out = CollectingOutput(ssrc=0xBB, out_seq_start=1, out_ts_start=0)
    late = CollectingOutput(ssrc=0xCC)
    st.add_output(out)
    st.add_output(late)                 # bucket 1: its packets wait
    st.settings.bucket_delay_ms = 10_000
    st.push_rtp(_pkt(1, 10_000), 1000)
    st.push_rtcp(_pusher_sr(), 1000)
    st.reflect(1000)
    assert len(out.rtcp_packets) == 1 and not late.rtcp_packets
    assert _sr(out.rtcp_packets[0]).rtp_ts == out.rewrite.map_ts(10_000)
    st.push_rtp(_pkt(2, 13_000), 2000)
    st.reflect(2000)
    assert len(out.rtcp_packets) == 1   # inside the 5 s window
    st.reflect(1000 + SR_INTERVAL_MS)
    assert len(out.rtcp_packets) == 2
    sr = _sr(out.rtcp_packets[1])
    assert sr.ssrc == 0xBB and sr.packet_count == 2
    assert not late.rtcp_packets        # its rebase has not latched


def test_upstream_rr_matches_the_reference():
    rng = np.random.default_rng(4)
    port = _stream()
    ref = RefStream(ref_sdp.parse(VIDEO_SDP).streams[0],
                    RefSettings(bucket_delay_ms=0))
    sent_port, sent_ref = [], []
    for st, sink in ((port, sent_port), (ref, sent_ref)):
        st.reporter_ssrc = 0x5151
        st.upstream_rtcp = sink.append
    seqs = [65530 + i for i in range(30)] + [3, 2, 2, 40, 41]  # wrap, dup
    t = 1000
    for k, seq in enumerate(seqs):
        if k in (11, 12):               # lost
            continue
        pkt = _pkt(seq & 0xFFFF, 3000 * k, ssrc=0x77)
        port.push_rtp(pkt, t)
        ref.push_rtp(pkt, t)
        t += int(rng.integers(100, 900))
        for st in (port, ref):
            st.send_upstream_rr(t)
    assert sent_port == sent_ref and len(sent_port) >= 2
    rr = rtcp.parse_compound(sent_port[-1])[0]
    assert rr.ssrc == 0x5151 and rr.reports[0].ssrc == 0x77
    port.upstream_rtcp = _raise_oserror
    assert port.send_upstream_rr(t + SR_INTERVAL_MS)
    assert port.upstream_rtcp is None   # a dead transport stops the RRs


def _raise_oserror(_data):
    raise OSError("closed")


# ------------------------------------------- three-way byte equality
def _kinds():
    return ("plain", "meta", "thin0", "plain", "change", "meta", "thin0",
            "plain")


def _twins(seed=17):
    """A port stream for ``reflect``, one for the engine and a reference
    stream, each with one output per kind of ``_kinds``, same state."""
    rng = np.random.default_rng(seed)
    settings = dict(bucket_size=2, bucket_delay_ms=100)
    info, ref_info = (sdp.parse(VIDEO_SDP).streams[0],
                      ref_sdp.parse(VIDEO_SDP).streams[0])
    streams = [RelayStream(info, StreamSettings(**settings)),
               RelayStream(info, StreamSettings(**settings)),
               RefStream(ref_info, RefSettings(**settings))]
    for st in streams:
        st._wall_base = WALL
        st.reporter_ssrc = 0x1234
    for kind in _kinds():
        kw = dict(ssrc=int(rng.integers(1 << 32)),
                  out_seq_start=int(rng.integers(1 << 16)),
                  out_ts_start=int(rng.integers(1 << 32)))
        for st, cls in zip(streams, (CollectingOutput, CollectingOutput,
                                     RefOutput)):
            out = cls(**kw)
            if kind == "meta":
                out.meta_field_ids = {"tt": 0, "sq": 1, "md": -1}
            if kind == "thin0":
                out.on_receiver_report(0.35)      # level 1 from the start
            st.add_output(out)
    return rng, streams


def test_reflect_engine_and_reference_give_the_same_rtp_and_rtcp(
        monkeypatch):
    monkeypatch.setattr(time, "time", lambda: WALL + 100.0)   # meta tt
    rng, (oracle, served, ref) = _twins()
    pkts = []
    while len(pkts) < 600:
        pkts += synth.paced_gop(rng, seq0=0xFFA0 + len(pkts),
                                ts0=0xFFFF0000 + 750 * len(pkts),
                                ssrc=0xFEED, frames=6, packets_per_frame=4,
                                body_len=(20, 200), fu_a=True)
        pkts.append(b"\x80\x60\x00")                 # a runt
    eng = FanoutEngine(device="cpu")
    sched = MegabatchScheduler(device="cpu")
    pairs = [(served, eng)]
    t = 1000
    for wake in range(34):
        for p in pkts[wake * 17:(wake + 1) * 17]:
            for st in (oracle, served, ref):
                st.push_rtp(p, t)
        if wake in (3, 9):
            for st, m in ((oracle, rtcp), (served, rtcp), (ref, ref_rtcp)):
                st.push_rtcp(_pusher_sr(m), t)
        if wake == 5:                   # an SDES-only compound
            for st in (oracle, served, ref):
                st.push_rtcp(ref_rtcp.Sdes([ref_rtcp.SdesChunk(
                    0xFEED, "cam")]).to_bytes(), t)
        if wake == 12:                  # thinned mid-stream, then back
            for st in (oracle, served, ref):
                st.outputs[4].on_receiver_report(0.5)
        if wake == 20:
            for st in (oracle, served, ref):
                for _ in range(6):
                    st.outputs[4].on_receiver_report(0.0)
        if wake == 7:                   # a stall on a thinned output
            for st in (oracle, served, ref):
                st.outputs[2].block_next = 1
        sched.begin_wake(pairs, t)
        for o in served.outputs:        # never staged for the window pass
            if o.meta_field_ids is not None or not o.thinning.passthrough():
                assert o not in eng.fast_outputs(served)
        eng.step(served, t)
        sched.end_wake(pairs, t)
        oracle.reflect(t)
        ref.reflect(t)
        for i, (a, b, c) in enumerate(zip(oracle.outputs, served.outputs,
                                          ref.outputs)):
            assert a.rtp_packets == b.rtp_packets == c.rtp_packets, (wake, i)
            assert a.rtcp_packets == b.rtcp_packets == c.rtcp_packets, \
                (wake, i)
            assert (a.bookmark, a.packets_sent, a.payload_octets,
                    a.thinning.dropped) == \
                (b.bookmark, b.packets_sent, b.payload_octets,
                 b.thinning.dropped) == \
                (c.bookmark, c.packets_sent, c.payload_octets,
                 c.thinning.dropped), (wake, i)
        t += 250
    outs = served.outputs
    assert all(o.rtcp_packets for o in outs)
    assert len(outs[0].rtcp_packets) >= 4           # relayed + originated
    assert outs[2].thinning.dropped > 0 and outs[4].thinning.dropped > 0
    assert outs[4].thinning.controller.level == 0
    assert eng.batch_sent > 0 and eng.batch_passes > 0
    assert sched.mismatches == 0 and eng.missing_params == 0
    meta = rtp_meta.parse_packet(outs[1].rtp_packets[0],
                                 outs[1].meta_field_ids)
    assert meta.transmit_time == int((WALL + 100.0) * 1000)
    assert meta.seq == struct.unpack("!H", outs[1].rtp_packets[0][2:4])[0]
