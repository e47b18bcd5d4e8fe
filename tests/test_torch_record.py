"""The port's recorder on the CPU, against the JAX package.

* the depacketizer's access units (FU-A, STAP-A, SPS/PPS capture) and its
  garbage tolerance equal the reference's;
* a ``RecorderOutput`` fed a packet list writes the reference's MP4 byte
  for byte, and its tables read back through ``Mp4File``;
* a ``RecordingManager`` on a live session served by ``reflect``;
* ``sweep_orphans`` lists the reference's orphans;
* REST ``startrecord``/``stoprecord`` on the port's server and on the
  reference's, fed the same pushed packets, leave the same file.
"""

import asyncio
import json
import os

import numpy as np
import pytest

from easydarwin_tpu.protocol import nalu as ref_nalu
from easydarwin_tpu.server import ServerConfig as RefConfig
from easydarwin_tpu.server import StreamingServer as RefServer
from easydarwin_tpu.utils.client import RtspClient
from easydarwin_tpu.vod import record as ref_record
from easydarwin_tpu.vod.depacketize import H264Depacketizer as RefDepack
from easydarwin_tpu_torch.protocol import nalu, rtp, sdp
from easydarwin_tpu_torch.relay.session import RelaySession
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.utils.vod_clips import ClipSpec, write_clip
from easydarwin_tpu_torch.vod.depacketize import H264Depacketizer
from easydarwin_tpu_torch.vod.mp4 import Mp4File
from easydarwin_tpu_torch.vod.packetizer import H264Packetizer, split_avcc
from easydarwin_tpu_torch.vod.record import (RecorderOutput,
                                             RecordingManager, sweep_orphans)

VIDEO_SDP = ("v=0\r\nm=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
             "a=control:trackID=1\r\n")


def clip_packets(tmp_path, spec: ClipSpec, seed: int) -> list[bytes]:
    """A pusher's packets: the clip's samples through the file
    packetizer (SPS/PPS ahead of every IDR, FU-A past 1,400 bytes)."""
    path = write_clip(tmp_path / f"src{seed}.mp4", spec, seed=seed)
    f = Mp4File(path)
    v = f.video_track()
    pk = H264Packetizer(v, ssrc=0x51, seq_start=65000)
    pkts = [p for i in range(v.n_samples)
            for p in pk.packetize_sample(f.read_sample(v, i), i)]
    f.close()
    return pkts


@pytest.mark.parametrize("size,mtu", [(3000, 1400), (200, 1400),
                                      (5000, 700)])
def test_depacketizer_roundtrip_equals_the_reference(size, mtu):
    d, rd = H264Depacketizer(), RefDepack()
    rng = np.random.default_rng(size)
    sps = bytes((0x67, 0x42, 0x00, 0x1F)) + bytes(range(8))
    pps = bytes((0x68, 0xCE, 0x3C, 0x80, 1, 2, 3, 4))
    seq, originals = 10, []
    for i in range(4):
        nal = bytes((0x65 if i == 0 else 0x41,)) + rng.integers(
            0, 256, size, dtype=np.uint8).tobytes()
        originals.append(nal)
        pkts = []
        if i == 0:
            for cfg in (sps, pps):
                pkts += nalu.packetize_h264(cfg, seq=seq + len(pkts),
                                            timestamp=0, ssrc=1,
                                            marker_on_last=False)
        pkts += nalu.packetize_h264(nal, seq=seq + len(pkts),
                                    timestamp=i * 3000, ssrc=1, mtu=mtu)
        assert pkts == [p for ps in ([ref_nalu.packetize_h264(
            c, seq=seq + k, timestamp=0, ssrc=1, marker_on_last=False)
            for k, c in enumerate((sps, pps))] if i == 0 else [])
            for p in ps] + ref_nalu.packetize_h264(
                nal, seq=seq + (2 if i == 0 else 0), timestamp=i * 3000,
                ssrc=1, mtu=mtu)
        # a STAP-A of two small NALs rides along with the last frame
        if i == 3:
            stap = bytes((24,)) + b"".join(len(n).to_bytes(2, "big") + n
                                           for n in (b"\x06ab", b"\x06cd"))
            pkts.insert(0, rtp.RtpPacket(payload_type=96, seq=seq - 1,
                                         timestamp=i * 3000, ssrc=1,
                                         payload=stap).to_bytes())
        for p in pkts:
            d.push(p)
            rd.push(p)
        seq += len(pkts)
    got, want = d.flush(), rd.flush()
    assert [(u.timestamp, u.nals) for u in got] == \
        [(u.timestamp, u.nals) for u in want]
    assert (d.sps, d.pps, d.packets, d.malformed) == \
        (rd.sps, rd.pps, rd.packets, rd.malformed) == (sps, pps, d.packets, 0)
    assert [split_avcc(u.to_avcc())[-1] for u in got] == originals


@pytest.mark.parametrize("junk", [
    b"\x00\x01",                                             # not RTP
    rtp.RtpPacket(payload_type=96, seq=1, timestamp=0, ssrc=1,
                  payload=bytes((0x7C, 0x05)) + b"x").to_bytes(),
    rtp.RtpPacket(payload_type=96, seq=2, timestamp=0, ssrc=1,
                  payload=bytes((24, 0, 9, 1))).to_bytes(),  # short STAP-A
    rtp.RtpPacket(payload_type=96, seq=3, timestamp=0, ssrc=1,
                  payload=bytes((30, 1))).to_bytes(),        # unknown type
], ids=["not_rtp", "fu_without_start", "short_stap", "type_30"])
def test_depacketizer_tolerates_garbage_as_the_reference(junk):
    d, rd = H264Depacketizer(), RefDepack()
    d.push(junk)
    rd.push(junk)
    assert (d.malformed, d.packets) == (rd.malformed, rd.packets)
    assert d.malformed == 1
    assert d.pop_units() == rd.pop_units() == []


@pytest.mark.parametrize("spec", [
    ClipSpec(frames=40, fps=30, gop=12, idr_bytes=6000, p_bytes=700),
    ClipSpec(frames=20, fps=25, gop=5, idr_bytes=300, p_bytes=90),
], ids=["fu_a", "single_nal"])
def test_recorded_mp4_equals_the_reference(tmp_path, spec):
    pkts = clip_packets(tmp_path, spec, seed=2)
    got, want = str(tmp_path / "port.mp4"), str(tmp_path / "ref.mp4")
    rec, rrec = RecorderOutput(got), ref_record.RecorderOutput(want)
    for p in pkts:
        rec.send_bytes(p, is_rtcp=False)
        rrec.send_bytes(p, is_rtcp=False)
    res, rres = rec.finish(), rrec.finish()
    assert res["samples"] == rres["samples"] == spec.frames
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    f = Mp4File(got)
    v = f.video_track()
    assert v.n_samples == spec.frames
    assert int(v.sync.sum()) == -(-spec.frames // spec.gop)
    assert int(v.dts[1] - v.dts[0]) == 90000 // spec.fps
    f.close()
    assert not os.path.exists(got + ".tmp")


def test_recording_manager_on_a_live_session(tmp_path):
    spec = ClipSpec(frames=12, fps=30, gop=6, idr_bytes=500, p_bytes=200)
    pkts = clip_packets(tmp_path, spec, seed=4)
    sess = RelaySession("/live/rec", sdp.parse(VIDEO_SDP))
    mgr = RecordingManager()
    out_path = str(tmp_path / "rec.mp4")
    rec = mgr.start(sess, out_path)
    with pytest.raises(ValueError):
        mgr.start(sess, out_path)
    for k, p in enumerate(pkts):
        sess.push(1, p, t_ms=1000 + k)
        if k == 0:
            sess.streams[1].reflect(2000)      # prime at the stream head
    sess.streams[1].reflect(5000)
    res = mgr.stop("/live/rec")
    assert res["samples"] == 12 and res["malformed"] == 0
    assert rec not in sess.streams[1].outputs
    direct = str(tmp_path / "direct.mp4")
    d = RecorderOutput(direct)
    for p in pkts:
        d.send_bytes(p, is_rtcp=False)
    d.finish()
    with open(out_path, "rb") as a, open(direct, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(KeyError):
        mgr.stop("/live/rec")


def test_sweep_orphans_lists_the_reference_orphans(tmp_path):
    for rel in ("a.mp4.tmp", "sub/b.mp4.tmp", "sub/c.mp4", ".dvr/d.mp4.tmp",
                "e.tmp"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    got = sweep_orphans(str(tmp_path))
    assert got == ref_record.sweep_orphans(str(tmp_path))
    assert [os.path.relpath(p, tmp_path) for p in got] == \
        ["a.mp4.tmp", "sub/b.mp4.tmp"]
    assert sweep_orphans(str(tmp_path / "missing")) == []


async def _record_via_rest(kind: str, folder: str, pkts) -> dict:
    if kind == "ref":
        app = RefServer(RefConfig(rtsp_port=0, service_port=0,
                                  bind_ip="127.0.0.1", movie_folder=folder,
                                  reflect_interval_ms=5, log_folder=folder,
                                  access_log_enabled=False))
    else:
        app = StreamingServer(ServerConfig(
            rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
            movie_folder=folder, reflect_interval_ms=5), device="cpu")
    await app.start()
    try:
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/cam9"
        pusher = RtspClient()
        await pusher.connect("127.0.0.1", app.rtsp.port)
        await pusher.push_start(uri, VIDEO_SDP)
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       app.rest.port)

        async def get(path):
            writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
            head = await reader.readuntil(b"\r\n\r\n")
            clen = int([ln for ln in head.split(b"\r\n")
                        if ln.lower().startswith(b"content-length")][0]
                       .split(b":")[1])
            return (int(head.split(b" ")[1]),
                    json.loads(await reader.readexactly(clen)))

        st, _ = await get("/api/v1/startrecord?path=/live/cam9"
                          f"&file={kind}/../{kind}.mp4")
        assert st == 200
        bad, _ = await get("/api/v1/startrecord?path=/live/cam9"
                           "&file=../escape.mp4")
        missing, _ = await get("/api/v1/stoprecord?path=/nope")
        # the first frame alone, so the recorder starts at the first IDR
        # (a recorder joining a burst starts at its newest IDR)
        first = next(k for k, p in enumerate(pkts) if p[1] & 0x80) + 1
        for k, p in enumerate(pkts):
            pusher.push_packet(0, p)
            if k + 1 == first:
                await asyncio.sleep(0.2)
        await asyncio.sleep(0.5)
        st, doc = await get("/api/v1/stoprecord?path=/live/cam9")
        assert st == 200
        writer.close()
        await pusher.close()
        return {"bad": bad, "missing": missing,
                "samples": doc["EasyDarwin"]["Body"]["Samples"]}
    finally:
        await app.stop()


async def test_rest_record_writes_the_reference_file(tmp_path):
    """The same pushed packets, recorded over REST by each server: the
    same MP4 bytes; a file outside the movie folder is a 400, stopping an
    unknown path a 404."""
    spec = ClipSpec(frames=18, fps=30, gop=6, idr_bytes=2500, p_bytes=400)
    pkts = clip_packets(tmp_path, spec, seed=8)
    folder = str(tmp_path / "movies")
    got = await _record_via_rest("port", folder, pkts)
    want = await _record_via_rest("ref", folder, pkts)
    assert got == want == {"bad": 400, "missing": 404, "samples": "18"}
    with open(os.path.join(folder, "port.mp4"), "rb") as a, \
            open(os.path.join(folder, "ref.mp4"), "rb") as b:
        assert a.read() == b.read()
