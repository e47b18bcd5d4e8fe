"""The port's HLS tier ≡ the JAX package's, on the CPU.

The same packets go through the reference's ``hls`` package and the
port's, each on its own relay session driven by the scalar reflect, and
every byte is compared:

* ``HlsOutput`` init and media segments, playlists and the sliding
  window, for a synthetic GOP stream;
* ``HlsService`` with the temporal rungs (r1, r2) and the requant rungs
  (q6, q12) on real CAVLC and CABAC pictures (96×96, 1 and 3 slices),
  with an AAC track (RFC 3640) riding every rendition;
* ``RequantHlsOutput`` and ``RequantLadder`` (inline) against the
  reference's, and the AAC depacketizer;
* ``HlsService.serve``: the files it answers, their content types, the
  ETag shapes (the generation token is random on both packages), the
  auto-start of master and rendition playlists, unknown paths;
* ``HlsService.sweep`` and ``stop`` retiring entries;
* a CPU server end to end (``utils.hls_loopback.serve_hls``): 16 sources
  over interleaved TCP, REST ``starthls`` with q6 and q12, master GETs,
  every playlist, init segment and segment fetched and held to the
  pushed pictures or the host scalar oracle, one 304 revalidation,
  ``gethlsstreams``, 0 device errors, 0 shed AUs.
"""

import asyncio
import re

import numpy as np
import pytest
import torch

from easydarwin_tpu.codecs.h264_intra import encode_iframe
from easydarwin_tpu.hls import requant as ref_rq
from easydarwin_tpu.hls import segmenter as ref_seg
from easydarwin_tpu.protocol import aac as ref_aac
from easydarwin_tpu.protocol import nalu as ref_nalu
from easydarwin_tpu.relay.session import SessionRegistry as RefRegistry
from easydarwin_tpu_torch.hls import requant as rq
from easydarwin_tpu_torch.hls import segmenter as seg
from easydarwin_tpu_torch.protocol import aac
from easydarwin_tpu_torch.relay.session import SessionRegistry
from easydarwin_tpu_torch.utils import hls_loopback as hl

CPU = torch.device("cpu")
SPS = bytes((0x67, 0x42, 0x00, 0x1F)) + bytes(range(8))
PPS = bytes((0x68, 0xCE, 0x3C, 0x80, 1, 2, 3, 4))
VIDEO_SDP = ("v=0\r\ns=x\r\nt=0 0\r\nm=video 0 RTP/AVP 96\r\n"
             "a=rtpmap:96 H264/90000\r\na=control:trackID=1\r\n")
AV_SDP = VIDEO_SDP + ("m=audio 0 RTP/AVP 97\r\n"
                      "a=rtpmap:97 mpeg4-generic/48000/2\r\n"
                      "a=fmtp:97 streamtype=5; mode=AAC-hbr; config=1190; "
                      "sizeLength=13; indexLength=3; indexDeltaLength=3\r\n"
                      "a=control:trackID=2\r\n")


def _gop_packets(n_gops=6, gop_len=10, fps=30):
    """Synthetic 1-packet frames, SPS/PPS at each IDR."""
    seq, frame, out = 0, 0, []
    for _g in range(n_gops):
        for i in range(gop_len):
            ts = int(frame * 90000 / fps)
            if i == 0:
                for cfg in (SPS, PPS):
                    out += ref_nalu.packetize_h264(
                        cfg, seq=seq, timestamp=ts, ssrc=1,
                        marker_on_last=False)
                    seq += 1
            nal = bytes((0x65 if i == 0 else 0x41,)) + bytes((frame,)) * 300
            out += ref_nalu.packetize_h264(nal, seq=seq, timestamp=ts,
                                           ssrc=1)
            seq += 1
            frame += 1
    return out


def test_hls_output_segments_and_playlists_equal():
    outs = [m.HlsOutput(target_duration=0.3, window=3)
            for m in (ref_seg, seg)]
    for p in _gop_packets(n_gops=8):
        for o in outs:
            o.send_bytes(p, is_rtcp=False)
    ref, got = outs
    assert got.init_segment == ref.init_segment is not None
    assert [s.data for s in got.segments] == [s.data for s in ref.segments]
    assert [(s.seq, s.duration_sec) for s in got.segments] \
        == [(s.seq, s.duration_sec) for s in ref.segments]
    assert got.media_seq == ref.media_seq == 4
    assert got.playlist("x/") == ref.playlist("x/")
    assert got.playlist("x/") is got.playlist("x/")        # cached text
    assert got.get_segment(5) is got.segments[1].data
    assert got.get_segment(3) is None
    assert got.codec_string() == ref.codec_string()
    assert got.observed_bandwidth() == ref.observed_bandwidth() > 0


def _pictures(n_frames, entropy, slices, seed=0):
    rng = np.random.default_rng(seed)
    pics = []
    for f in range(n_frames):
        y = rng.integers(60, 200, (96, 96)).astype(np.uint8)
        y = np.clip(y // 4 * 4 + (np.arange(96)[None, :] + 3 * f) % 40,
                    0, 255).astype(np.uint8)
        pics.append(encode_iframe(y, 24, cb=y[::2, ::2], cr=y[1::2, 1::2],
                                  idr_pic_id=f % 2, slices=slices,
                                  entropy=entropy))
    return pics


def _drive(mod, reg_cls, sdp, rungs, pics, *, audio=False, **svc_kw):
    """One service on its own registry, fed the same packets through the
    scalar reflect; returns the entry."""
    reg = reg_cls()
    sess = reg.find_or_create("/cam", sdp)
    for st in sess.streams.values():
        st.settings.bucket_delay_ms = 0
    svc = mod.HlsService(reg, target_duration=0.1, **svc_kw)
    svc.start("/cam", rungs)
    rng = np.random.default_rng(3)
    vseq = aseq = 0
    for f, nals in enumerate(pics):
        ts = f * 3000
        t = 1000 + f * 33
        for j, nal in enumerate(nals):
            for p in ref_nalu.packetize_h264(nal, seq=vseq, timestamp=ts,
                                             ssrc=1,
                                             marker_on_last=j == len(nals)
                                             - 1):
                vseq += 1
                sess.push(1, p, t_ms=t)
        for _ in range(2 if audio else 0):
            au = bytes(rng.integers(0, 256, 120, dtype=np.uint8))
            sess.push(2, ref_aac.packetize_aac_hbr(
                au, seq=aseq, timestamp=aseq * 1024, ssrc=2), t_ms=t)
            aseq += 1
        for st in sess.streams.values():
            st.reflect(t)
    return svc, svc.outputs["/cam"]


@pytest.mark.parametrize("entropy,slices,audio", [
    ("cavlc", 1, False), ("cabac", 1, True), ("cavlc", 3, True),
    ("cabac", 3, False)])
def test_service_renditions_byte_equal(entropy, slices, audio):
    pics = _pictures(7, entropy, slices, seed=slices)
    rungs = (1, 2, "q6", "q12")
    sdp = AV_SDP if audio else VIDEO_SDP
    _s, ref = _drive(ref_seg, RefRegistry, sdp, rungs, pics, audio=audio)
    svc, got = _drive(seg, SessionRegistry, sdp, rungs, pics, audio=audio,
                      device=CPU)
    assert set(got.renditions) == set(ref.renditions) \
        == {"", "r1", "r2", "q6", "q12"}
    for name, out in got.renditions.items():
        r = ref.renditions[name]
        assert out.init_segment == r.init_segment is not None, name
        assert out.segments, name
        assert [s.data for s in out.segments] \
            == [s.data for s in r.segments], name
        assert out.audio_samples_muxed == r.audio_samples_muxed
        if audio:
            assert all(s.data.count(b"traf") == 2 for s in out.segments)
    for d in (6, 12):
        st = got.renditions[f"q{d}"].requant.stats
        rs = ref.renditions[f"q{d}"].requant.stats
        assert (st.slices_requantized, st.slices_passed_through,
                st.bytes_out) == (rs.slices_requantized,
                                  rs.slices_passed_through, rs.bytes_out)
        assert st.slices_passed_through == 0
    assert svc.master_playlist(got) == _s.master_playlist(ref)
    stats = svc.stats()
    # the relay's fast start passes the first picture's SPS and PPS by
    assert stats["aus"] == 7 == stats["dispatches"] + stats["no_ps_aus"]
    assert stats["dispatches"] >= 6
    assert stats["device_errors"] == stats["shed"] == 0
    assert set(stats["stage_ms_per_au"]) == set(rq.REQUANT_STAGES)


def test_requant_hls_output_and_ladder_equal_the_reference():
    pics = _pictures(5, "cavlc", 2, seed=9)
    pkts, seq = [], 0
    for f, nals in enumerate(pics):
        for j, nal in enumerate(nals):
            p = ref_nalu.packetize_h264(nal, seq=seq, timestamp=f * 9000,
                                        ssrc=1,
                                        marker_on_last=j == len(nals) - 1)
            seq += len(p)
            pkts += p
    ref = ref_rq.RequantHlsOutput(12, use_device=False, target_duration=0.05)
    mine = rq.RequantHlsOutput(12, device=CPU, target_duration=0.05)
    host = rq.RequantHlsOutput(12, target_duration=0.05)
    lad_ref = ref_rq.RequantLadder(use_device=False, target_duration=0.05)
    lad = rq.RequantLadder(device=CPU, target_duration=0.05)
    r_outs = [lad_ref.add_rendition(d) for d in (6, 12)]
    outs = [lad.add_rendition(d) for d in (6, 12)]
    for p in pkts:
        for o in (ref, mine, host):
            o.write_rtp(p)
        lad_ref.write_rtp(p)
        lad.write_rtp(p)
    want = [s.data for s in ref.segments]
    assert want and [s.data for s in mine.segments] == want
    assert [s.data for s in host.segments] == want
    assert [s.data for s in outs[1].segments] == want
    for a, b in zip(outs, r_outs):
        assert [s.data for s in a.segments] == [s.data for s in b.segments]
        assert a.shed == 0 and a.pending == 0
    assert lad.counters()["dispatches"] == 5


def test_aac_depacketizer_equals_the_reference():
    rng = np.random.default_rng(5)
    cfg_r = ref_aac.AacConfig.from_sdp("config=1190; sizeLength=13; "
                                       "indexLength=3; indexDeltaLength=3",
                                       48000)
    cfg = aac.AacConfig.from_sdp("config=1190; sizeLength=13; "
                                 "indexLength=3; indexDeltaLength=3", 48000)
    assert vars(cfg) == vars(cfg_r)
    assert cfg.default_asc() == cfg_r.default_asc()
    d_r, d = ref_aac.AacDepacketizer(cfg_r), aac.AacDepacketizer(cfg)
    for i in range(40):
        au = bytes(rng.integers(0, 256, int(rng.integers(10, 3000)),
                                dtype=np.uint8))
        pkts = aac.packetize_aac_hbr(au, seq=i, timestamp=i * 1024, ssrc=7)
        assert pkts == ref_aac.packetize_aac_hbr(au, seq=i,
                                                 timestamp=i * 1024, ssrc=7)
        for p in (pkts if isinstance(pkts, list) else [pkts]):
            assert d.push(p) == d_r.push(p)
    assert aac.AAC_SAMPLES_PER_FRAME == ref_aac.AAC_SAMPLES_PER_FRAME


def _etag_shape(etag):
    return None if etag is None else re.sub(r"-[0-9a-f]{8}-", "-G-", etag)


def test_serve_paths_and_etags_behave_as_the_reference():
    pics = _pictures(7, "cavlc", 1, seed=4)
    svc_r, _e = _drive(ref_seg, RefRegistry, VIDEO_SDP, (), pics)
    svc, _e2 = _drive(seg, SessionRegistry, VIDEO_SDP, (), pics, device=CPU)
    urls = ["/hls/cam/index.m3u8", "/hls/cam/init.mp4", "/hls/cam/seg0.m4s",
            "/hls/cam/seg1.m4s", "/hls/cam/seg99.m4s", "/hls/cam/bogus",
            "/hls/cam/master.m3u8", "/hls/cam/r1/index.m3u8",
            "/hls/cam/q6/index.m3u8", "/hls/cam/r3/index.m3u8",
            "/hls/nope/index.m3u8", "/hls/x", "/api/v1/x"]
    for url in urls:
        a, b = svc.serve(url), svc_r.serve(url)
        assert (a is None) == (b is None), url
        if a is None:
            continue
        assert a[0] == b[0], url
        assert _etag_shape(a[2]) == _etag_shape(b[2]), url
        if url.endswith((".mp4", ".m4s")) or "index" in url:
            assert a[1] == b[1], url
    assert set(svc.outputs["/cam"].renditions) \
        == set(svc_r.outputs["/cam"].renditions) == {"", "r1", "r2", "q6"}
    # a segment's ETag is stable and served by reference
    a1, a2 = svc.serve("/hls/cam/seg0.m4s"), svc.serve("/hls/cam/seg0.m4s")
    assert a1[2] == a2[2] and a1[1] is a2[1]
    # sweep and stop retire what they must
    sess = svc.registry.find("/cam")
    svc.registry.remove("/cam")
    assert svc.sweep() == 1 and not svc.outputs
    assert sum(st.num_outputs for st in sess.streams.values()) == 0
    assert svc.stats()["dispatches"] == 0
    with pytest.raises(ValueError):
        svc.start("/missing", ("q7",))
    with pytest.raises(KeyError):
        svc.start("/missing", (1,))


def test_cpu_server_sixteen_sources_end_to_end():
    res = asyncio.run(hl.serve_hls(
        "cpu", np.random.default_rng(14), sources=hl.config5_sources(16),
        width=48, height=48, frames=10, fps=4.0, seed=14, workers=4,
        deadline_s=240))
    hls = res["server_stats"]["hls"]
    assert len(res["streams"]) == 16
    assert hls["aus"] == hls["dispatches"] + hls["no_ps_aus"] == 16 * 10
    assert hls["no_ps_aus"] <= 16 * 3          # the first GOP at most
    assert hls["device_errors"] == hls["shed"] == hls["mismatches"] == 0
    assert res["server_stats"]["hls_not_modified"] == 1
    assert res["av_segments"] > 0 and res["samples"] > 16 * 6
    assert res["server_stats"]["kernel_launches"]["ed_h264_requant"] == 0


def test_service_stats_keep_peaks_and_sum_the_rest():
    """A ladder's AU latency and pending peak reach ``stats()`` beside the
    summed counts; a retired ladder's peaks stay peaks."""
    pics = _pictures(4, "cabac", 1, seed=9)
    svc, _e = _drive(seg, SessionRegistry, VIDEO_SDP, ("q6",), pics,
                     device=CPU)
    st = svc.stats()
    assert st["aus"] >= 3 and st["device"] == "cpu"
    assert 0 < st["latency_s_max"] <= st["latency_s"]
    assert st["latency_ms_per_au"] == st["latency_s"] * 1e3 / st["aus"]
    assert st["pending_max"] == 0 and st["pool_workers"] >= 1
    assert (st["paths"], st["paths_retired"]) == (1, 0)
    svc.registry.remove("/cam")
    assert svc.sweep() == 1
    after = svc.stats()
    assert after["latency_s_max"] == st["latency_s_max"]
    assert (after["paths"], after["paths_retired"]) == (0, 1)
    tot = {}
    for counts in ({"aus": 3, "latency_s_max": 0.5, "pending_max": 2},
                   {"aus": 4, "latency_s_max": 0.2, "pending_max": 5}):
        seg._fold_counters(tot, counts)
    assert tot == {"aus": 7, "latency_s_max": 0.5, "pending_max": 5}
