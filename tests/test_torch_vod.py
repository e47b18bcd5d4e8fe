"""The port's file tier on the CPU, against the JAX package.

* the muxer writes the reference's bytes, and the parser reads the
  reference's tables (dts, ctts, sizes, offsets, sync, ``TrackInfo``);
* both packetizers give the same packets for every sample, and the
  DESCRIBE SDP text is the same;
* ``VodService.resolve`` and ``confined_subpath`` refuse ``..``
  traversal, sibling folders and symlinks as the reference does;
* pinned pacing: a seek snaps to a sync sample, Scale rewrites
  timestamps, the SR cadence and its RTP time;
* the window launch plans P = 8,192 and 16,384 at W = 100, and a wider
  row runs in pieces equal to the reference's window pass;
* the servers end to end on loopback: the port's ``StreamingServer`` on
  the CPU (cache on: the group pacer; cache off: ``FileSession``s) and the
  reference's serve one file; the DESCRIBE SDP, Range and RTP-Info are
  the same, the players get the same payloads and timestamps, with a
  Range, Scale, a negative Scale, and a PAUSE then a PLAY with a Range;
  a VOD SETUP gets no x-FEC, x-Retransmit is echoed and meta-info granted
  as the reference grants them;
* the chip smoke's VOD harnesses (``utils.vod_loopback``) at a small size
  on the CPU: the in-process pacer with the device prime, and the CLI
  server's players and recorder.
"""

import asyncio
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from easydarwin_tpu.models.relay_pipeline import \
    megabatch_window_step as ref_window_step
from easydarwin_tpu.protocol import sdp as ref_sdp
from easydarwin_tpu.server import ServerConfig as RefConfig
from easydarwin_tpu.server import StreamingServer as RefServer
from easydarwin_tpu.utils.client import RtspClient
from easydarwin_tpu.utils.paths import confined_subpath as ref_confined
from easydarwin_tpu.vod import packetizer as ref_packetizer
from easydarwin_tpu.vod.mp4 import Mp4File as RefMp4File
from easydarwin_tpu.vod.mp4_writer import Mp4Writer as RefWriter
from easydarwin_tpu.vod.session import FileSession as RefFileSession
from easydarwin_tpu.vod.session import VodService as RefVodService
from easydarwin_tpu_torch.ops import fanout, kernel_lib
from easydarwin_tpu_torch.protocol import rtcp, rtp, sdp
from easydarwin_tpu_torch.relay.output import CollectingOutput, RelayOutput
from easydarwin_tpu_torch.relay.output import WriteResult
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.utils.paths import confined_subpath
from easydarwin_tpu_torch import native
from easydarwin_tpu_torch.utils import loopback, synth, vod_clips, vod_loopback
from easydarwin_tpu_torch.utils.vod_clips import ClipSpec, write_clip
from easydarwin_tpu_torch.vod import packetizer
from easydarwin_tpu_torch.vod.mp4 import Mp4File, open_shared
from easydarwin_tpu_torch.vod.session import (FileSession, VodService,
                                              seek_index)

CLIPS = {
    "av": ClipSpec(frames=30, fps=30, gop=10, idr_bytes=2000, p_bytes=80,
                   audio_rate=8000, audio_frame_bytes=40),
    "video_only": ClipSpec(frames=17, fps=25, gop=8, idr_bytes=3100,
                           p_bytes=1500),
    "big_frames": ClipSpec(frames=12, fps=30, gop=6, idr_bytes=20_000,
                           p_bytes=4000, audio_rate=44_100,
                           audio_frame_bytes=372),
}


@pytest.fixture
def clip(tmp_path):
    return write_clip(tmp_path / "clip.mp4", CLIPS["av"], seed=11)


# ------------------------------------------------------------ mp4 tables

@pytest.mark.parametrize("name", sorted(CLIPS))
def test_writer_writes_the_reference_bytes(tmp_path, name):
    a = write_clip(tmp_path / "port.mp4", CLIPS[name], seed=7)
    b = write_clip(tmp_path / "ref.mp4", CLIPS[name], seed=7,
                   writer_cls=RefWriter)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_mp4_tables_equal_the_reference(tmp_path, name):
    path = write_clip(tmp_path / "c.mp4", CLIPS[name], seed=7)
    f, rf = Mp4File(path), RefMp4File(path)
    assert (f.timescale, f.duration) == (rf.timescale, rf.duration)
    assert len(f.tracks) == len(rf.tracks) == (2 if CLIPS[name].audio_rate
                                               else 1)
    for t, rt in zip(f.tracks, rf.tracks):
        assert dataclasses.asdict(t.info) == dataclasses.asdict(rt.info)
        for col in ("offsets", "sizes", "dts", "ctts", "sync"):
            assert np.array_equal(getattr(t, col), getattr(rt, col)), col
        assert t.duration_sec() == rt.duration_sec()
        for i in range(t.n_samples):
            assert f.read_sample(t, i) == rf.read_sample(rt, i)
    spec = CLIPS[name]
    v = f.video_track()
    assert (v.info.width, v.info.height) == (spec.width, spec.height)
    assert int(v.sync.sum()) == -(-spec.frames // spec.gop)
    f.close()
    rf.close()


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_packets_and_sdp_equal_the_reference(tmp_path, name):
    path = write_clip(tmp_path / "c.mp4", CLIPS[name], seed=7)
    f, rf = Mp4File(path), RefMp4File(path)
    for t, rt in zip(f.tracks, rf.tracks):
        video = t.info.handler == "vide"
        pk = (packetizer.H264Packetizer if video
              else packetizer.AacPacketizer)(t, ssrc=0x1234, seq_start=65530)
        rpk = (ref_packetizer.H264Packetizer if video
               else ref_packetizer.AacPacketizer)(rt, ssrc=0x1234,
                                                  seq_start=65530)
        for i in range(t.n_samples):
            data = f.read_sample(t, i)
            assert pk.packetize_sample(data, i) == \
                rpk.packetize_sample(data, i)
            if video:
                assert packetizer.split_avcc(data) == \
                    ref_packetizer.split_avcc(data)
    got = sdp.build(packetizer.sdp_for_file(f, name="c.mp4"))
    want = ref_sdp.build(ref_packetizer.sdp_for_file(rf, name="c.mp4"))
    assert got == want and "m=video" in got
    svc, rsvc = VodService(str(tmp_path)), RefVodService(str(tmp_path))
    assert svc.describe("/c.mp4") == asyncio.run(rsvc.describe("/c.mp4"))
    f.close()
    rf.close()


# ------------------------------------------------------------ resolution

def test_resolve_refuses_traversal_siblings_and_symlinks(tmp_path):
    movies = tmp_path / "movies"
    movies.mkdir()
    spec = ClipSpec(frames=3)
    write_clip(movies / "ok.mp4", spec, seed=1)
    secret = write_clip(tmp_path / "secret.mp4", spec, seed=1)
    (tmp_path / "movies2").mkdir()
    write_clip(tmp_path / "movies2" / "leak.mp4", spec, seed=1)
    os.symlink(secret, str(movies / "link.mp4"))
    svc, rsvc = VodService(str(movies)), RefVodService(str(movies))
    cases = {"/ok.mp4": True, "/ok": True, "/ok.sdp": True,
             "/../secret.mp4": False, "/../secret": False,
             "/../movies2/leak.mp4": False, "/link.mp4": False,
             "/link": False, "/missing": False, "/../etc/passwd": False}
    for path, ok in cases.items():
        assert (svc.resolve(path) is not None) == ok, path
        assert svc.resolve(path) == rsvc.resolve(path), path
    root = str(movies)
    for rel in ("rec/a.mp4", "../secret.mp4", "../movies2/x.mp4",
                "link.mp4", "", "/abs.mp4", "a/../../b.mp4"):
        assert confined_subpath(root, rel) == ref_confined(root, rel), rel


# ------------------------------------------------------------ pinned pacing

@pytest.mark.parametrize("npt,sample", [(0.0, 0), (0.5, 10), (0.34, 10),
                                        (0.2, 0), (99.0, 20)])
def test_seek_snaps_to_a_sync_sample(clip, npt, sample):
    """30 fps, an IDR every 10 samples: 0.5 s is sample 15, which snaps
    back to 10; past the end is the last sync sample."""
    f = open_shared(clip)
    v = f.video_track()
    assert seek_index(v, npt) == sample
    rf = RefMp4File(clip)
    assert RefFileSession._seek_index(rf.video_track(), npt) == sample
    rf.close()
    f.close()


@pytest.mark.parametrize("ts_scale,delta", [(2.0, 1500), (4.0, 750),
                                            (0.5, 6000)])
def test_scale_rewrites_timestamps(clip, ts_scale, delta):
    """Frame i sits at i·3000 ticks; Scale s delivers it at i·3000/s."""
    f = open_shared(clip)
    out = CollectingOutput(ssrc=1, out_seq_start=0)
    asyncio.run(FileSession(f, {1: out}, speed=2000.0,
                            ts_scale=ts_scale).run())
    ts = sorted({rtp.peek_timestamp(p) for p in out.rtp_packets})
    assert {b - a for a, b in zip(ts, ts[1:])} == {delta}
    f.close()


def test_sr_cadence_and_rtp_time_extrapolation(clip):
    """An SR a track every 5 s: RTP time = the last sent ts extrapolated
    at the track clock and Speed (9000 + 1.5 s · 90 kHz · 2 = 279000)."""

    class RtcpCollect(RelayOutput):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.rtcp = []

        def send_bytes(self, data, *, is_rtcp):
            if is_rtcp:
                self.rtcp.append(data)
            return WriteResult.OK

    f = open_shared(clip)
    out = RtcpCollect(ssrc=0xABC, out_seq_start=1)
    sess = FileSession(f, {1: out}, speed=2.0)
    sess._sr_ref = {1: (9000, 100.0)}
    sess._sr_pkts = {1: 7}
    sess._sr_octets = {1: 4242}
    sess._maybe_send_srs(101.5)
    assert len(out.rtcp) == 1
    sr = rtcp.parse_compound(out.rtcp[0])[0]
    assert (sr.ssrc, sr.rtp_ts, sr.packet_count, sr.octet_count) == \
        (0xABC, 279000, 7, 4242)
    sess._maybe_send_srs(104.0)            # inside the 5 s window
    assert len(out.rtcp) == 1
    sess._maybe_send_srs(106.5)
    assert len(out.rtcp) == 2
    f.close()


# ------------------------------------------------------- the window pass

@pytest.mark.parametrize("p,cluster,smem", [(8192, 8, 102_416),
                                            (16384, 8, 204_816)])
def test_window_launch_plans_vod_windows(p, cluster, smem):
    (plan,) = fanout.window_launch_plan([(1, p, 100, 8)], [0])
    assert (plan.cluster, plan.smem_bytes) == (cluster, smem)
    assert smem <= kernel_lib.WINDOW_SMEM_LIMIT
    assert fanout.window_max_rows(100) >= 16384


def test_window_smem_limit_matches_the_kernel_source():
    src = open(kernel_lib.SOURCES[0]).read()
    m = re.search(r"constexpr int kWindowSmemLimit = ([0-9 *+-]+);", src)
    assert m and eval(m.group(1)) == kernel_lib.WINDOW_SMEM_LIMIT


@pytest.mark.parametrize("shapes", [
    [(2, 32768, 100, 8)],
    [(1, 20000, 100, 3), (2, 2048, 100, 8)],
], ids=["pow2", "ragged_and_mixed"])
def test_wide_windows_run_in_pieces_equal_to_the_reference(shapes):
    """A row wider than one launch takes is cut into pieces; the merged
    result equals the reference's window pass on the whole row (the
    newest keyframe in the last piece, in the first, and none)."""
    rng = np.random.default_rng(4)
    pairs, want = [], []
    for b, p, w, s in shapes:
        win = np.zeros((b, p, w), np.uint8)
        lens = rng.integers(20, 96, (b, p))
        win[:, :, 12] = 0x41                     # non-IDR single NALs
        win[:, :, 0] = 0x80
        for k, row in enumerate((p - 5, 3, None)[:b]):
            if row is not None:
                win[k, row, 12] = 0x65           # one IDR
        win[..., 96:100] = lens.astype("<u4")[..., None].view(np.uint8)
        state = rng.integers(0, 1 << 32, (b, s, 6), dtype=np.uint64) \
            .astype(np.uint32)
        pairs.append((torch.from_numpy(win), torch.from_numpy(state)))
        want.append(np.asarray(ref_window_step(win, state)))
    got = fanout.relay_affine_step_windows(pairs)
    for g, w_ in zip(got, want):
        assert np.array_equal(g.numpy(), w_)
    assert int(got[0][0, -1]) == shapes[0][1] - 5


# ------------------------------------------------- the servers end to end

async def _start(kind: str, folder: str):
    if kind == "ref":
        app = RefServer(RefConfig(rtsp_port=0, service_port=0,
                                  bind_ip="127.0.0.1", movie_folder=folder,
                                  access_log_enabled=False))
    else:
        app = StreamingServer(ServerConfig(
            rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
            movie_folder=folder, vod_cache_enabled=kind == "hot",
            vod_cache_window_samples=8), device="cpu")
    await app.start()
    return app


async def _collect(c, quiet: float = 0.4) -> dict[int, list[bytes]]:
    """Every interleaved packet until ``quiet`` seconds pass without one."""
    got: dict[int, list[bytes]] = {0: [], 2: []}
    while True:
        try:
            ch, data = await asyncio.wait_for(c.recv_any(), quiet)
        except asyncio.TimeoutError:
            return got
        if ch in got:
            got[ch].append(data)


def _norm_info(info: str, port: int) -> str:
    return re.sub(r";seq=\d+", ";seq=N",
                  info.replace(f"127.0.0.1:{port}", "HOST"))


async def _play_case(kind: str, folder: str, case: str) -> dict:
    app = await _start(kind, folder)
    try:
        port = app.rtsp.port
        uri = f"rtsp://127.0.0.1:{port}/clip.mp4"
        c = RtspClient()
        await c.connect("127.0.0.1", port)
        c.enable_any_queue()
        r = await c.request("DESCRIBE", uri, {"accept": "application/sdp"})
        res = {"describe": r.body}
        ssrc = {}
        for i, tid in enumerate((1, 2)):
            r = await c.request("SETUP", f"{uri}/trackID={tid}", {
                "transport": f"RTP/AVP/TCP;unicast;interleaved={2*i}-{2*i+1}"})
            assert r.status == 200
            ssrc[2 * i] = int(re.search(r"ssrc=([0-9A-Fa-f]+)",
                                        r.headers["transport"]).group(1), 16)
        play = {"plain": {}, "range": {"range": "npt=0.5-"},
                "scale": {"scale": "2.0"}, "negative_scale": {"scale": "-2"},
                "pause_range": {}}[case]
        r = await c.request("PLAY", uri, play)
        if case == "pause_range":
            await asyncio.sleep(0.3)
            r = await c.request("PAUSE", uri)
            assert r.status == 200
            await _collect(c, 0.3)              # what was sent before
            r = await c.request("PLAY", uri, {"range": "npt=0.5-"})
        assert r.status == 200
        res["range"] = r.headers.get("range")
        res["scale"] = r.headers.get("scale")
        res["rtp_info"] = _norm_info(r.headers["rtp-info"], port)
        seqs = [int(s) for s in re.findall(r";seq=(\d+)",
                                           r.headers["rtp-info"])]
        got = await _collect(c)
        for i, ch in enumerate((0, 2)):
            pkts = got[ch]
            assert pkts, (kind, case, ch)
            for k, p in enumerate(pkts):       # seq runs on from RTP-Info
                assert rtp.peek_seq(p) == (seqs[i] + k) & 0xFFFF
                assert rtp.peek_ssrc(p) == ssrc[ch]
            res[ch] = [(rtp.peek_timestamp(p), p[1], p[12:]) for p in pkts]
        if kind == "hot":
            # the group pacer served every player that has no Scale
            pacer = app.vod_pacer.stats()
            assert (pacer["hot_pkts"] + pacer["cold_pkts"] > 0) == \
                (case != "scale")
            assert app.stats()["vod_errors"] == 0
        await c.teardown(uri)
        await c.close()
        return res
    finally:
        await app.stop()


@pytest.mark.parametrize("case", ["plain", "range", "scale",
                                  "negative_scale", "pause_range"])
async def test_servers_play_a_file_alike(tmp_path, case):
    """Port hot (the group pacer on the CPU), port cold (a FileSession a
    player) and the reference deliver the same payloads, markers and
    timestamps on both tracks, and answer the same SDP, Range, Scale and
    RTP-Info.  The 1 s clip plays at 1x, so each case takes its media
    time."""
    write_clip(tmp_path / "clip.mp4", ClipSpec(
        frames=30, fps=30, gop=10, idr_bytes=3000, p_bytes=300,
        audio_rate=8000, audio_frame_bytes=40), seed=21)
    want = await _play_case("ref", str(tmp_path), case)
    for kind in ("hot", "cold"):
        got = await _play_case(kind, str(tmp_path), case)
        assert got == want, (kind, case)
    assert want["scale"] == {"scale": "2", "negative_scale": "1"}.get(case)
    assert want["range"] == ("npt=0.500-" if case in ("range", "pause_range")
                             else "npt=0.000-")


async def _setup_headers(kind: str, folder: str, extra: dict) -> dict:
    app = await _start(kind, folder)
    try:
        c = RtspClient()
        await c.connect("127.0.0.1", app.rtsp.port)
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/clip.mp4"
        r = await c.request("SETUP", f"{uri}/trackID=1", {
            "transport": "RTP/AVP;unicast;client_port=40000-40001", **extra})
        assert r.status == 200
        await c.close()
        return {k: v for k, v in r.headers.items()
                if k.startswith("x-")}
    finally:
        await app.stop()


@pytest.mark.parametrize("extra", [
    {"x-fec": "parity"},
    {"x-retransmit": "our-retransmit;window=128"},
    {"x-rtp-meta-info": "pp;tt;ft;pn;sq;md"},
    {"x-rtp-meta-info": "tt;md", "x-fec": "parity"},
], ids=["fec_refused", "retransmit", "meta_vod_fields", "meta_and_fec"])
async def test_vod_setup_grants_equal_the_reference(clip, tmp_path, extra):
    folder = os.path.dirname(clip)
    want = await _setup_headers("ref", folder, extra)
    got = await _setup_headers("hot", folder, extra)
    assert got == want
    assert "x-fec" not in got


# ----------------------------------------------- the chip smoke's harnesses

def test_vod_in_process_harness_on_the_cpu(tmp_path):
    """Phase 11's harness at a small size: the group pacer, the megabatch
    scheduler and the engines' native scatter, every join primed from the
    cache's resident windows, every datagram held to the cold path."""
    if not native.available():
        pytest.skip("the egress core does not build here")
    a = write_clip(tmp_path / "a.mp4", ClipSpec(
        frames=60, fps=30, gop=15, idr_bytes=6000, p_bytes=800,
        audio_rate=8000, audio_frame_bytes=40), seed=1)
    b = write_clip(tmp_path / "b.mp4", ClipSpec(
        frames=20, fps=30, gop=10, idr_bytes=30_000, p_bytes=8000), seed=2)
    res = vod_loopback.vod_in_process(
        "cpu", [vod_loopback.VodClip(a, 6), vod_loopback.VodClip(b, 2, 3)],
        run_s=1.5, window_samples=16)
    pacer, cache, sched = res["pacer"], res["cache"], res["scheduler"]
    assert res["players"] == 8 and res["joins"] == 14
    assert res["datagrams"] > 0
    assert res["lost"] <= res["udp_rcvbuf_errors"]
    assert pacer["device_primes"] == res["joins"]
    assert pacer["prime_failures"] == 0
    assert 1 <= cache["device_uploads"] <= res["windows_touched"]
    assert sched["mismatches"] == 0 and sched["streams_coalesced"] > 0
    assert res["send_errors"] == 0 and res["prime_shapes"]
    assert res["native_sent"] == res["sent"]


async def test_vod_and_recorder_through_the_cli_on_the_cpu(tmp_path):
    """Phases 11b and 11c at a small size: every kind of player of a file
    held to the cold path (Range, Scale, PAUSE + Range, TCP, x-Retransmit,
    an x-FEC request that gets no grant), then a pusher recorded over
    REST into the file a ``RecorderOutput`` writes from the same
    packets."""
    if not native.available():
        pytest.skip("the egress core does not build here")
    folder = str(tmp_path)
    write_clip(tmp_path / "clip.mp4", ClipSpec(
        frames=75, fps=30, gop=15, idr_bytes=4000, p_bytes=600,
        audio_rate=8000, audio_frame_bytes=40), seed=3)
    kinds = ["plain", "range", "scale", "pause", "tcp", "retransmit", "fec"]
    async with loopback.CliServer("cpu", "--movie-folder", folder,
                                  "--vod-cache-window-samples", "16") as srv:
        res = await vod_loopback.play_vod(
            srv.rtsp_port, folder, "clip.mp4", kinds, run_s=3.0,
            range_npt=1.0, pause_at=1.0)
        rng = np.random.default_rng(5)
        pkts = [p for g in range(3) for p in synth.paced_gop(
            rng, seq0=0xFFF0 + 40 * g, ts0=0xFFFF0000 + 30000 * g,
            ssrc=0xC0DE, frames=10, packets_per_frame=4,
            body_len=(200, 400))]
        rec = await vod_loopback.record_via_rest(
            srv.rtsp_port, srv.rest_port, folder, pkts,
            sps=vod_clips.SPS, pps=vod_clips.PPS, frame_s=0.01,
            packets_per_frame=4)
        stats = await srv.stop()
    assert set(res["by_kind"]) == set(kinds)
    assert all(row["datagrams"] > 0 for row in res["by_kind"].values())
    assert res["by_kind"]["retransmit"]["acks"] > 0
    assert res["by_kind"]["tcp"]["lost"] <= stats["tcp_shed_pkts"]
    assert sum(r["lost"] for k, r in res["by_kind"].items()
               if k != "tcp") == 0
    assert rec["samples"] == 30 and rec["sync_samples"] == 3
    assert stats["vod_errors"] == 0 and stats["pump_errors"] == 0
    assert stats["vod"]["prime_failures"] == 0
    assert stats["vod"]["device_primes"] > 0


class _HintFile:
    """Samples by (track, index), as ``Mp4File.read_sample`` serves them."""

    def __init__(self, samples):
        self.samples = samples

    def read_sample(self, track, i):
        return self.samples[(track.info.handler, i)]


def _hint_sample(rng, n_media: int) -> bytes:
    """A hint sample of 3 packets: immediates, sample ranges (one past the
    media's samples), a marker bit on the last."""
    import struct
    out = struct.pack(">HH", 3, 0)
    for k in range(3):
        cons = [bytes((1, 5)) + bytes(rng.integers(0, 256, 14, np.uint8)),
                struct.pack(">BBHII4x", 2, 0, 40, int(rng.integers(1, 4)),
                            int(rng.integers(0, 30))),
                struct.pack(">BBHII4x", 2, 0, 10, n_media + 1, 0)]
        out += struct.pack(">iHHHH", 0, 0x0080 if k == 2 else 0,
                           1000 + k, 0, len(cons)) + b"".join(cons)
    return out


@pytest.mark.parametrize("rtp_timescale", [0, 90000, 8000])
def test_hint_samples_equal_the_reference(rtp_timescale):
    from easydarwin_tpu_torch.vod.mp4 import Track, TrackInfo
    rng = np.random.default_rng(rtp_timescale)
    media = Track(TrackInfo(handler="vide", timescale=90000))
    media.sizes = np.full(3, 64)
    hint = Track(TrackInfo(handler="hint", timescale=600,
                           rtp_timescale=rtp_timescale))
    hint.dts = np.arange(4) * 20
    samples = {("vide", i): bytes(rng.integers(0, 256, 64, np.uint8))
               for i in range(3)}
    samples.update({("hint", i): _hint_sample(rng, 3) for i in range(4)})
    f = _HintFile(samples)
    got = packetizer.HintInterpreter(f, hint, media, ssrc=77)
    want = ref_packetizer.HintInterpreter(f, hint, media, ssrc=77)
    for i in range(4):
        pkts = got.packetize_sample(i)
        assert len(pkts) == 3 and pkts == want.packetize_sample(i)
        assert rtp.RtpPacket.parse(pkts[2]).marker
