"""The port's MJPEG host codec, ladder and REST surface ≡ the JAX package's.

* ``protocol.jpeg_entropy``: encoded bytes and decoded arrays equal the
  reference codec's, for both RTP/JPEG types and three frame sizes each;
* ``protocol.mjpeg``: payload headers, tables, JFIF headers, the
  packetizer and the depacketizer equal the reference module's;
* the ladder: the same frames into a reference ``MjpegTranscodeService``
  and a port one (``device="cpu"``) give byte-equal rung packets for
  quality rungs and half-resolution ``s2`` rungs (bit-exact holds here,
  tighter than the ≤ 1 on < 1% the fp32 downscale product would allow);
* an MJPEG stream through the port's engine and megabatch scheduler writes
  what the reference's scalar ``RelayStream.reflect`` writes, and a ladder
  behind the engine receives whole rewritten packets;
* the REST envelope is byte-compatible, and the CLI serves the ladder end
  to end on the CPU.
"""

import asyncio

import numpy as np
import pytest
import torch

from easydarwin_tpu.cluster import protocol as ref_ep
from easydarwin_tpu.models import mjpeg_ladder as ref_ml
from easydarwin_tpu.protocol import jpeg_entropy as ref_je
from easydarwin_tpu.protocol import mjpeg as ref_mjpeg
from easydarwin_tpu.protocol import sdp as ref_sdp
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.relay.session import SessionRegistry as RefRegistry
from easydarwin_tpu.relay.stream import RelayStream as RefStream
from easydarwin_tpu.relay.stream import StreamSettings as RefSettings
from easydarwin_tpu_torch.cluster import protocol as ep
from easydarwin_tpu_torch.hls import HlsService
from easydarwin_tpu_torch.models import mjpeg_ladder as ml
from easydarwin_tpu_torch.ops import kernel_lib
from easydarwin_tpu_torch.protocol import jpeg_entropy as je
from easydarwin_tpu_torch.protocol import mjpeg, rtp, sdp
from easydarwin_tpu_torch.relay.fanout import FanoutEngine
from easydarwin_tpu_torch.relay.megabatch import MegabatchScheduler
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.relay.session import SessionRegistry
from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
from easydarwin_tpu_torch.server.rest import RestApi
from easydarwin_tpu_torch.utils import mjpeg_loopback as mlb

MJPEG_SDP = ("v=0\r\ns=cam\r\nt=0 0\r\nm=video 0 RTP/AVP 26\r\n"
             "a=rtpmap:26 JPEG/90000\r\na=control:trackID=1\r\n")


def sparse_levels(rng, n, density=6):
    arr = np.zeros((n, 64), np.int16)
    for b in arr:
        b[0] = rng.integers(-180, 180)
        for k in rng.integers(1, 64, size=density):
            b[k] = rng.integers(-60, 60)
    return arr


def frame_set(rng, jtype, w, h):
    gw, gh = je.mcu_grid(w, h, jtype)
    n = gw * gh
    return [sparse_levels(rng, n * (4 if jtype & 1 else 2)),
            sparse_levels(rng, n), sparse_levels(rng, n)]


# ------------------------------------------------------------ host codec

@pytest.mark.parametrize("jtype,w,h", [(1, 32, 32), (1, 64, 48),
                                       (1, 112, 80), (0, 48, 16),
                                       (0, 64, 32), (0, 96, 40)])
def test_entropy_codec_equals_reference(jtype, w, h):
    rng = np.random.default_rng(jtype * 1000 + w + h)
    levels = frame_set(rng, jtype, w, h)
    scan = je.encode_scan(levels, jtype)
    assert scan == ref_je.encode_scan(levels, jtype)
    assert je.mcu_grid(w, h, jtype) == ref_je.mcu_grid(w, h, jtype)
    got, want = je.decode_scan(scan, w, h, jtype), \
        ref_je.decode_scan(scan, w, h, jtype)
    for a, b, c in zip(got, want, levels):
        assert a.dtype == b.dtype == np.int16
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_entropy_extremes_and_errors_equal_reference():
    levels = [np.zeros((4, 64), np.int16), np.zeros((1, 64), np.int16),
              np.zeros((1, 64), np.int16)]
    levels[0][0][0] = 1023
    levels[0][0][63] = -1            # 3× ZRL then a coefficient at the end
    levels[0][1][0] = -1023
    scan = je.encode_scan(levels, 1)
    assert scan == ref_je.encode_scan(levels, 1)
    for a, b in zip(je.decode_scan(scan, 16, 16, 1), levels):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(je.JpegEntropyError):
        je.decode_scan(b"\x00" * 8, 16, 16, 1)
    with pytest.raises(ref_je.JpegEntropyError):
        ref_je.decode_scan(b"\x00" * 8, 16, 16, 1)


# ----------------------------------------------------------- RTP/JPEG kit

@pytest.mark.parametrize("q", [10, 50, 99])
def test_tables_packetizer_and_jfif_equal_reference(q):
    assert mjpeg.make_qtables(q) == ref_mjpeg.make_qtables(q)
    rng = np.random.default_rng(q)
    scan = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    for type_, qq, tables in ((1, q, b""), (0, q, b""),
                              (1, 200, mjpeg.make_qtables(q))):
        kw = dict(width=64, height=48, seq=0xFFFE, timestamp=0xFFFFFF00,
                  ssrc=0xABCDEF, type_=type_, q=qq, qtables=tables, mtu=900)
        pkts = mjpeg.packetize_jpeg(scan, **kw)
        assert pkts == ref_mjpeg.packetize_jpeg(scan, **kw)
        assert len(pkts) > 1 and rtp.peek_seq(pkts[1]) == 0xFFFF
        assert mjpeg.is_frame_first_packet(pkts[0])
        assert not mjpeg.is_frame_first_packet(pkts[1])
    for type_, ri in ((1, 0), (0, 0), (65, 4)):
        h = mjpeg.JpegHeader(type=type_, q=q, width=64, height=48,
                             restart_interval=ri)
        rh = ref_mjpeg.JpegHeader(type=type_, q=q, width=64, height=48,
                                  restart_interval=ri)
        assert mjpeg.make_jfif_headers(h, b"") == \
            ref_mjpeg.make_jfif_headers(rh, b"")
        half = mjpeg.make_qtables(q)[:64]          # one in-band table
        assert mjpeg.make_jfif_headers(h, half) == \
            ref_mjpeg.make_jfif_headers(rh, half)
    with pytest.raises(mjpeg.MjpegError):
        mjpeg.packetize_jpeg(scan, width=60, height=48, seq=0, timestamp=0,
                             ssrc=1)


def test_payload_parse_and_build_equal_reference():
    qt = mjpeg.make_qtables(70)
    for kw in (dict(type=1, q=80, width=640, height=480),
               dict(type=65, q=80, width=64, height=32, restart_interval=3),
               dict(type=1, q=255, width=32, height=32, qtables=qt),
               dict(type=1, q=255, width=32, height=32, qtables=qt,
                    fragment_offset=1400)):
        payload = mjpeg.build_payload(mjpeg.JpegHeader(**kw), b"scan-bytes")
        assert payload == ref_mjpeg.build_payload(ref_mjpeg.JpegHeader(**kw),
                                                  b"scan-bytes")
        (h, frag), (rh, rfrag) = (mjpeg.parse_payload(payload),
                                  ref_mjpeg.parse_payload(payload))
        assert frag == rfrag == b"scan-bytes"
        assert vars(h) == vars(rh)
    for bad in (b"\x00" * 5, bytes([0, 0, 0, 0, 70, 80, 8, 8, 0])):
        with pytest.raises(mjpeg.MjpegError):
            mjpeg.parse_payload(bad)


def test_depacketizer_equals_reference():
    rng = np.random.default_rng(5)
    scans = [rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
             for _ in range(4)]
    frames = [mjpeg.packetize_jpeg(s, width=32, height=32, seq=10 * i,
                                   timestamp=9000 * i, ssrc=7, q=60, mtu=700)
              for i, s in enumerate(scans)]
    stream = list(frames[0])
    stream += frames[1][:2]                        # frame 1 cut short
    f2 = list(frames[2])
    f2[1], f2[2] = f2[2], f2[1]                    # reordered fragments
    stream += f2
    stream += frames[3][:1] + frames[3][2:]        # a lost middle fragment
    stream += frames[0]                            # a repeat, complete
    dep, ref = mjpeg.JpegDepacketizer(), ref_mjpeg.JpegDepacketizer()
    dep2, ref2 = mjpeg.JpegDepacketizer(), ref_mjpeg.JpegDepacketizer()
    outs = []
    for p in stream:
        a, b = dep.push(p), ref.push(p)
        assert a == b
        pa, pb = dep2.push_parts(p), ref2.push_parts(p)
        assert (pa is None) == (pb is None)
        if pa is not None:
            assert vars(pa[0]) == vars(pb[0]) and pa[1:] == pb[1:]
            outs.append(pa)
        if a is not None:
            assert a.startswith(b"\xff\xd8") and a.endswith(b"\xff\xd9")
    assert (dep.frames_out, dep.frames_dropped) == \
        (ref.frames_out, ref.frames_dropped) == (3, 2)
    assert [o[1] for o in outs] == [scans[0], scans[2], scans[0]]


# ----------------------------------------------------------------- ladder

def test_rung_helpers_equal_reference():
    for spec in (40, "40", "20s2", " 7S1 ", "99s2"):
        assert ml.parse_rung(spec) == ref_ml.parse_rung(spec)
    with pytest.raises(ValueError):
        ml.parse_rung("40s3")
    assert ml.rung_suffix(40, 1) == ref_ml.rung_suffix(40, 1) == "@q40"
    assert ml.rung_suffix(20, 2) == ref_ml.rung_suffix(20, 2) == "@q20s2"
    assert ml._rung_sdp("/a@q1") == ref_ml._rung_sdp("/a@q1")
    for jt, gw, gh in ((1, 4, 4), (1, 40, 30), (0, 6, 10)):
        for a, b in zip(ml._quad_index(jt, gw, gh),
                        ref_ml._quad_index(jt, gw, gh)):
            np.testing.assert_array_equal(a, b)


def _ladder_frames(rng, w, h, q, n, ts0=9000):
    """n frames of smooth content at quality ``q`` → packets per frame."""
    out, seq = [], 1
    for k in range(n):
        levels = mlb.frame_levels(rng, w, h, q, k)
        pkts = mjpeg.packetize_jpeg(je.encode_scan(levels, 1), width=w,
                                    height=h, seq=seq,
                                    timestamp=ts0 + 9000 * k, ssrc=0xF00D,
                                    type_=1, q=q, mtu=600)
        seq += len(pkts)
        out.append(pkts)
    return out


def _rung_packets(reg, path):
    ring = reg.find(path).streams[1].rtp_ring
    return [ring.get(i) for i in ring.ids()]


def _twin_ladders(rungs):
    ref_reg, reg = RefRegistry(), SessionRegistry()
    ref_src = ref_reg.find_or_create("/cam", MJPEG_SDP)
    src = reg.find_or_create("/cam", MJPEG_SDP)
    ref_out = ref_ml.MjpegTranscodeService(ref_reg).start("/cam", rungs)
    out = ml.MjpegTranscodeService(reg, device="cpu").start("/cam", rungs)
    return (ref_reg, ref_src, ref_out), (reg, src, out)


def _push_both(twins, packets, t):
    (_rr, ref_src, _ro), (_r, src, _o) = twins
    for p in packets:
        ref_src.push(1, p, t_ms=t)
        src.push(1, p, t_ms=t)
    ref_src.reflect(t)
    src.streams[1].reflect(t)


def _assert_ladders_equal(twins):
    (ref_reg, _rs, ref_out), (reg, _s, out) = twins
    for r, rr in zip(out.rungs, ref_out.rungs):
        assert r.session.path == rr.session.path
        assert _rung_packets(reg, r.session.path) == \
            _rung_packets(ref_reg, rr.session.path), r.session.path
    st, rst = out.stats(), ref_out.stats()
    assert set(st) - set(rst) == {"seconds", "last_frame_seconds"}
    assert {k: v for k, v in st.items() if k in rst} == rst


def test_ladder_rung_packets_equal_the_reference_ladder():
    rungs = (40, 10, "20s2")
    twins = _twin_ladders(rungs)
    rng = np.random.default_rng(9)
    for k, pkts in enumerate(_ladder_frames(rng, 64, 64, 80, 3)):
        _push_both(twins, pkts, 1000 + 100 * k)
    _assert_ladders_equal(twins)
    out = twins[1][2]
    assert out.frames_in == 3 and out.decode_errors == 0
    assert [r.frames for r in out.rungs] == [3, 3, 3]
    assert all(v > 0 for v in out.seconds.values())


@pytest.mark.parametrize("case", ["up_quality_clamp", "inband_tables",
                                  "unalignable_s2"])
def test_ladder_edge_cases_equal_the_reference(case):
    rng = np.random.default_rng(17)
    if case == "up_quality_clamp":       # q20 source into a q95 rung
        twins = _twin_ladders((95,))
        frames = _ladder_frames(rng, 32, 32, 20, 2)
    elif case == "inband_tables":        # Q >= 128: tables in frame 1 only
        twins = _twin_ladders((40,))
        scan = je.encode_scan(frame_set(rng, 1, 32, 32), 1)
        qt = mjpeg.make_qtables(75)
        f1 = mjpeg.packetize_jpeg(scan, width=32, height=32, seq=1,
                                  timestamp=9000, ssrc=1, q=200, qtables=qt)
        f2 = mjpeg.packetize_jpeg(scan, width=32, height=32,
                                  seq=1 + len(f1), timestamp=18000, ssrc=1,
                                  q=200)
        frames = [f1, f2]
    else:                                 # 48×48: odd MCU grid, s2 skips
        twins = _twin_ladders((40, "30s2"))
        frames = _ladder_frames(rng, 48, 48, 80, 2)
    for k, pkts in enumerate(frames):
        _push_both(twins, pkts, 1000 + 100 * k)
    _assert_ladders_equal(twins)
    assert twins[1][2].decode_errors == 0


def test_service_errors_sweep_and_stop_match_reference_semantics():
    reg = SessionRegistry()
    reg.find_or_create("/h264", "v=0\r\nm=video 0 RTP/AVP 96\r\n"
                       "a=rtpmap:96 H264/90000\r\na=control:trackID=1\r\n")
    src = reg.find_or_create("/cam", MJPEG_SDP)
    svc = ml.MjpegTranscodeService(reg, device="cpu")
    with pytest.raises(ValueError):
        svc.start("/h264")
    with pytest.raises(KeyError):
        svc.start("/nope")
    for bad in ((150,), (0,), ()):
        with pytest.raises(ValueError):
            svc.start("/cam", bad)
    out = svc.start("/cam", (40, 40, "20s2"))         # duplicates collapse
    assert [(r.q, r.scale) for r in out.rungs] == [(40, 1), (20, 2)]
    assert out in src.streams[1].outputs
    with pytest.raises(ValueError):
        svc.start("/cam", (30,))                      # already active
    assert svc.stop("/cam/")["path"] == "/cam"         # path normalized
    assert reg.find("/cam@q40") is None and src.streams[1].num_outputs == 0
    reg.find_or_create("/cam@q40", MJPEG_SDP)          # a live rung path
    with pytest.raises(ValueError):
        svc.start("/cam", (40,))
    svc.start("/cam", (25,))
    reg.remove("/cam")                                 # pusher gone
    assert svc.sweep() == 1 and not svc.ladders
    assert reg.find("/cam@q25") is None
    src2 = reg.find_or_create("/cam", MJPEG_SDP)
    assert svc.start("/cam", (25,)).source_session is src2
    assert [s["path"] for s in svc.list_ladders()] == ["/cam"]
    svc.stop_all()
    assert not svc.ladders
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ml.MjpegTranscodeService(reg)


def _mjpeg_twins(n_out=6, seed=4):
    """A reference and a port MJPEG stream with identical outputs."""
    rng = np.random.default_rng(seed)
    settings = dict(bucket_size=2, bucket_delay_ms=10)
    ref = RefStream(ref_sdp.parse(MJPEG_SDP).streams[0], RefSettings(**settings))
    port = RelayStream(sdp.parse(MJPEG_SDP).streams[0],
                       StreamSettings(**settings))
    for _ in range(n_out):
        kw = dict(ssrc=int(rng.integers(1 << 32)),
                  out_seq_start=int(rng.integers(1 << 16)),
                  out_ts_start=int(rng.integers(1 << 32)))
        ref.add_output(RefOutput(**kw))
        port.add_output(CollectingOutput(**kw))
    return ref, port, rng


def test_mjpeg_stream_through_engine_and_scheduler_equals_reflect():
    ref, port, rng = _mjpeg_twins()
    frames = _ladder_frames(rng, 64, 48, 70, 5, ts0=0xFFFF0000)
    eng, sched = FanoutEngine(), MegabatchScheduler(device="cpu")
    t = 1000
    for wake, pkts in enumerate(frames * 2):
        if wake == 3:
            ref.outputs[1].block_next = port.outputs[1].block_next = 1
        for p in pkts:
            ref.push_rtp(p, t)
            port.push_rtp(p, t)
        sched.begin_wake([(port, eng)], t)
        eng.step(port, t)
        sched.end_wake([(port, eng)], t)
        ref.reflect(t)
        for a, b in zip(port.outputs, ref.outputs):
            assert a.rtp_packets == b.rtp_packets, wake
            assert (a.bookmark, a.packets_sent, a.bytes_sent) == \
                (b.bookmark, b.packets_sent, b.bytes_sent), wake
        t += 25
    assert sum(len(o.rtp_packets) for o in port.outputs) >= 50
    assert sched.mismatches == 0 and eng.missing_params == 0
    assert port.stats.keyframes == ref.stats.keyframes >= 1


def test_ladder_behind_the_engine_receives_whole_rewritten_packets():
    reg = SessionRegistry()
    src = reg.find_or_create("/cam", MJPEG_SDP)
    out = ml.MjpegTranscodeService(reg, device="cpu").start("/cam", (40,))
    stream = src.streams[1]
    eng, sched = FanoutEngine(), MegabatchScheduler(device="cpu")
    rng = np.random.default_rng(12)
    frames = _ladder_frames(rng, 32, 32, 80, 4, ts0=0x12345678)
    t = 500
    for pkts in frames:
        for p in pkts:
            src.push(1, p, t_ms=t)
        sched.begin_wake([(stream, eng)], t)
        eng.step(stream, t)
        sched.end_wake([(stream, eng)], t)
        t += 100
    n_pkts = sum(len(f) for f in frames)
    assert out.frames_in == 4 and out.decode_errors == 0
    # the ladder and the engine each count a delivered packet, as the
    # reference's engine and ladder do
    assert out.packets_sent == 2 * n_pkts
    rung = _rung_packets(reg, "/cam@q40")
    got = mlb.frames_of(rung)
    # rewritten on the way in: ts rebased to the ladder's origin (0)
    assert [ts for _h, _s, ts in got] == [9000 * k for k in range(4)]
    for k, (hdr, scan, _ts) in enumerate(got):
        src_levels = je.decode_scan(
            mlb.frames_of(frames[k])[0][1], 32, 32, 1)
        want, _w, _h = mlb.rung_oracle(src_levels, 32, 32, 80, 40, 1)
        for a, b in zip(je.decode_scan(scan, 32, 32, 1), want):
            np.testing.assert_array_equal(a, b)
    assert kernel_lib.LAUNCHES["ed_decode_blocks"] == 0


async def test_threaded_ladder_drops_older_frames_when_behind():
    reg = SessionRegistry()
    src = reg.find_or_create("/cam", MJPEG_SDP)
    svc = ml.MjpegTranscodeService(reg, device="cpu")
    out = svc.start("/cam", (40,))
    frames = _ladder_frames(np.random.default_rng(2), 64, 64, 80, 6)
    for k, pkts in enumerate(frames):
        for p in pkts:
            src.push(1, p, t_ms=100 * k)
        src.streams[1].reflect(100 * k)
    for _ in range(500):
        with out._lock:
            idle = not out._busy and out._pending is None
        if idle and out.rungs[0].frames == out.frames_in:
            break
        await asyncio.sleep(0.02)
    assert out.frames_in + out.frames_dropped == 6
    assert out.frames_in >= 1 and out.decode_errors == 0
    assert out.rungs[0].frames == out.frames_in
    svc.stop_all()


# ------------------------------------------------------------------- REST

async def test_rest_envelope_is_byte_compatible_and_unknown_is_404():
    for args, kw in (((ep.MSG_SC_SERVER_INFO_ACK,), dict(body={"A": ["x"]})),
                     ((ep.MSG_SC_EXCEPTION,), dict(error=ep.ERR_NOT_FOUND)),
                     ((ep.MSG_SC_EXCEPTION,),
                      dict(error=ep.ERR_BAD_REQUEST, body={"Detail": "d"}))):
        assert ep.ack(*args, **kw) == ref_ep.ack(*args, **kw)

    class App:
        transcodes = ml.MjpegTranscodeService(SessionRegistry(), device="cpu")
        hls = HlsService(SessionRegistry(), device="cpu")
    api = RestApi(None, App())
    status, doc = await api.route("GET", "/api/v1/getserverinfo", {}, b"")
    assert status == 404 and doc == ref_ep.ack(ref_ep.MSG_SC_EXCEPTION,
                                               error=ref_ep.ERR_NOT_FOUND)
    assert (await api.route("GET", "/hls/x/index.m3u8", {}, b""))[0] == 404
    status, doc = await api.route(
        "GET", "/api/v1/StartTranscode?path=/nope&rungs=40", {}, b"")
    assert status == 404
    status, doc = await api.route("GET", "/api/v1/gettranscodes/", {}, b"")
    assert status == 200 and '"Transcodes": []' in doc
    status, doc = await api.route("GET", "/api/v1/stoptranscode?path=/x", {},
                                  b"")
    assert status == 404


async def test_cli_serves_the_ladder_end_to_end_on_cpu():
    res = await mlb.serve_mjpeg_ladder(
        "cpu", np.random.default_rng(2026), width=64, height=64, n_frames=4,
        rungs=("40", "20s2"), deadline_s=15)
    assert res["frames_in"] + res["frames_dropped"] == 4
    assert res["decode_errors"] == 0
    assert [r["path"] for r in res["rungs"]] == ["/cam@q40", "/cam@q20s2"]
    for r in res["rungs"]:
        assert r["frames"] == res["frames_in"] and r["max_abs_err"] == 0
        assert r["source_frames"][0] == 0
    stats = res["server_stats"]
    assert stats["packets_in"] >= 4 and stats["pump_errors"] == 0
    assert stats["kernel_launches"] == {"ed_parse_packets": 0,
                                        "ed_relay_window": 0,
                                        "ed_ring_query": 0,
                                        "ed_decode_blocks": 0,
                                        "ed_gf_parity": 0,
                                        "ed_relay_batch": 0,
                                        "ed_requant_rungs": 0,
                                        "ed_h264_requant": 0,
                                        "ed_h264_requant_chroma": 0}
