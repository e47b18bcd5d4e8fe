"""The port's DVR and time-shift tier (``easydarwin_tpu_torch.dvr``) on the
CPU, against the JAX package's.

The same seeded inputs go through both packages, and the results must be
equal bytes and integers, no tolerance:

* blobs: ``encode_blob`` bytes, ``decode_blob`` of either package's blob,
  and the corruption cases (bad magic, truncated payload, truncated
  metadata) raise in both;
* spill files: ``spill.bin`` and ``index.json`` after the same appends,
  under byte and duration retention with compaction, with pinned arrival
  times; the crc guard; ``seek_id`` on an npt grid; a ``WindowSpiller``
  riding the same live ring feed;
* ``SegmentCache.get_packed`` rows (``CachedWindow.from_packed``), with
  ``pack_window`` never called;
* ``TimeShiftSession`` wire bytes on a pinned clock (the pushes' arrival
  ms, the pump's wakes, the sessions' ``now_ms``) with pinned SSRCs, seq
  and timestamp origins: a ``Range`` rewind at ``Speed`` 4 with its
  catch-up join, a live PAUSE resumed at ``Speed`` 2 with its catch-up, a
  1x resume that stays shifted, the tail-clamped window, the resume
  anchored on the first served row, the re-arm generation with the full
  finalize flush, and the replay of a finalized asset;
* the RTSP flow of the reference's end-to-end test (push with DVR on,
  PAUSE, PLAY with a Range at Speed 4, the catch-up join, stoprecord,
  ``.dvr`` DESCRIBE/SETUP/PLAY, PAUSE and resume) on both servers, the
  port's on ``device="cpu"``.
"""

import asyncio
import json
import os
import socket
import time
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

from easydarwin_tpu.dvr import service as ref_service
from easydarwin_tpu.dvr import spill as ref_spill
from easydarwin_tpu.dvr import timeshift as ref_timeshift
from easydarwin_tpu.protocol import nalu as ref_nalu
from easydarwin_tpu.protocol.sdp import StreamInfo as RefStreamInfo
from easydarwin_tpu.relay.output import RelayOutput as RefRelayOutput
from easydarwin_tpu.relay.output import WriteResult as RefWriteResult
from easydarwin_tpu.relay.ring import PacketFlags
from easydarwin_tpu.relay.session import SessionRegistry as RefRegistry
from easydarwin_tpu.vod import cache as ref_cache
from easydarwin_tpu.vod.session import VodPacerGroup as RefPacer
from easydarwin_tpu_torch import native
from easydarwin_tpu_torch.dvr import service, spill, timeshift
from easydarwin_tpu_torch.protocol import rtp
from easydarwin_tpu_torch.protocol.sdp import StreamInfo
from easydarwin_tpu_torch.relay.output import RelayOutput, WriteResult
from easydarwin_tpu_torch.relay.session import SessionRegistry
from easydarwin_tpu_torch.vod import cache
from easydarwin_tpu_torch.vod.session import VodPacerGroup

SPS = bytes((0x67, 0x42, 0x00, 0x1F)) + bytes(range(8))
PPS = bytes((0x68, 0xCE, 0x3C, 0x80, 1, 2, 3, 4))
VIDEO_SDP = ("v=0\r\nm=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
             "a=fmtp:96 packetization-mode=1\r\n"
             "a=control:trackID=1\r\n")
#: the pinned relay clock's origin (ms)
T0 = 1_000_000


class _Collect(RelayOutput):
    """Keeps every RTP packet it is sent (RTCP carries the wall clock
    and is dropped)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.wire: list[bytes] = []

    def send_bytes(self, data, *, is_rtcp):
        if not is_rtcp:
            self.wire.append(bytes(data))
        return WriteResult.OK


class _RefCollect(RefRelayOutput):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.wire: list[bytes] = []

    def send_bytes(self, data, *, is_rtcp):
        if not is_rtcp:
            self.wire.append(bytes(data))
        return RefWriteResult.OK


REF = SimpleNamespace(
    name="ref", spill=ref_spill, service=ref_service,
    timeshift=ref_timeshift, cache=ref_cache, Registry=RefRegistry,
    Pacer=RefPacer, Out=_RefCollect, StreamInfo=RefStreamInfo,
    new_cache=lambda: ref_cache.SegmentCache(budget_bytes=8 << 20,
                                             device=False))
PORT = SimpleNamespace(
    name="port", spill=spill, service=service, timeshift=timeshift,
    cache=cache, Registry=SessionRegistry, Pacer=VodPacerGroup,
    Out=_Collect, StreamInfo=StreamInfo,
    new_cache=lambda: cache.SegmentCache(budget_bytes=8 << 20,
                                         device="cpu"))
SIDES = (REF, PORT)


def _info(side, media="video"):
    if media == "video":
        return side.StreamInfo(media_type="video", payload_type=96,
                               payload_name="H264/90000", codec="H264",
                               clock_rate=90000, track_id=1)
    return side.StreamInfo(media_type="audio", payload_type=97,
                           payload_name="MPEG4-GENERIC/8000", codec="AAC",
                           clock_rate=8000, track_id=2)


def _rows(side, rng, n=8, id_lo=0, slot=64, arrival0=1000):
    """``n`` fuzzed RTP rows (seeded), keyframe-first at row 0."""
    data = np.zeros((n, slot), np.uint8)
    length = np.zeros(n, np.int32)
    for i in range(n):
        body = rng.integers(0, 256, int(rng.integers(1, slot - 12)),
                            dtype=np.uint8).tobytes()
        pkt = bytes((0x80, 96, 0, i, 0, 0, 0, i, 0, 0, 0, 7)) + body
        data[i, :len(pkt)] = np.frombuffer(pkt, np.uint8)
        length[i] = len(pkt)
    flags = np.zeros(n, np.int32)
    flags[0] = int(PacketFlags.KEYFRAME_FIRST)
    return side.spill.WindowRows(
        id_lo, data, length, flags,
        np.arange(n, dtype=np.int64) * 3000 + id_lo,
        np.arange(n, dtype=np.int32) + 100 + id_lo,
        np.arange(n, dtype=np.int64) * 33 + arrival0)


def _same_rows(a, b):
    assert a.id_lo == b.id_lo and a.n == b.n
    for f in ("length", "flags", "seq", "ts", "arrival"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for i in range(a.n):
        assert a.data[i, :a.length[i]].tobytes() \
            == b.data[i, :b.length[i]].tobytes()


def _files(d) -> dict[str, bytes]:
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            full = os.path.join(root, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, d)] = fh.read()
    return out


# ================================================================= blobs
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_blobs_equal_the_reference(seed):
    rows = {s.name: _rows(s, np.random.default_rng(seed), n=12)
            for s in SIDES}
    blob = spill.encode_blob(rows["port"])
    assert blob == ref_spill.encode_blob(rows["ref"])
    _same_rows(spill.decode_blob(blob, 0), ref_spill.decode_blob(blob, 0))
    _same_rows(spill.decode_blob(blob, 0), rows["port"])


@pytest.mark.parametrize("cut", ["magic", "payload", "meta"])
def test_corrupt_blobs_raise_in_both(cut):
    blob = spill.encode_blob(_rows(PORT, np.random.default_rng(5)))
    bad = {"magic": b"XXXX" + blob[4:], "payload": blob[:-3],
           "meta": blob[:20]}[cut]
    errs = []
    for mod in (spill, ref_spill):
        with pytest.raises((mod.SpillError, ValueError)) as ei:
            mod.decode_blob(bad, 0)
        errs.append(type(ei.value).__name__)
    assert errs[0] == errs[1]


# =========================================================== spill files
def _writer(side, d, **kw):
    return side.spill.SpillWriter(str(d), _info(side), **kw)


@pytest.mark.parametrize("budget", [
    dict(retention_bytes=2000, retention_sec=1e9, compact_floor_bytes=512),
    dict(retention_bytes=1 << 30, retention_sec=3.5,
         compact_floor_bytes=256),
    dict(retention_bytes=1 << 30, retention_sec=1e9),
])
def test_spill_writer_files_equal_the_reference(tmp_path, budget):
    ws = {}
    for side in SIDES:
        w = _writer(side, tmp_path / side.name / "t1", window_pkts=8,
                    **budget)
        rng = np.random.default_rng(7)
        for win in range(16):
            w.append_window(win, _rows(side, rng, 8, id_lo=win * 8,
                                       arrival0=win * 1000))
        ws[side.name] = w
    r, p = ws["ref"], ws["port"]
    assert (p.evictions, p.compactions, p.live_bytes, p.dead_bytes) == \
        (r.evictions, r.compactions, r.live_bytes, r.dead_bytes)
    if budget["retention_bytes"] < (1 << 30) \
            or budget["retention_sec"] < 1e9:
        assert p.evictions > 0 and p.compactions > 0
    for w in ws.values():
        w.finalize()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    sp = spill.SpilledTrack(str(tmp_path / "port" / "t1"))
    rsp = ref_spill.SpilledTrack(str(tmp_path / "ref" / "t1"))
    assert sp.complete and sorted(sp.windows) == sorted(rsp.windows)
    for win in sp.windows:
        _same_rows(sp.read_window(win), rsp.read_window(win))
    assert sp.duration_sec() == rsp.duration_sec()


def test_rearmed_writer_truncates_like_the_reference(tmp_path):
    for side in SIDES:
        rng = np.random.default_rng(3)
        d = tmp_path / side.name / "t1"
        w1 = _writer(side, d, window_pkts=8)
        for win in range(4):
            w1.append_window(win, _rows(side, rng, 8, id_lo=win * 8))
        w1.finalize()
        w2 = _writer(side, d, window_pkts=8, gen=2)
        w2.append_window(0, _rows(side, rng, 8))
        w2.finalize()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def test_crc_guard_equals_the_reference(tmp_path):
    got = {}
    for side in SIDES:
        d = tmp_path / side.name / "t1"
        w = _writer(side, d, window_pkts=8)
        rng = np.random.default_rng(11)
        blobs = {}
        for win in range(3):
            rows = _rows(side, rng, 8, id_lo=win * 8)
            w.append_window(win, rows)
            blobs[win] = side.spill.encode_blob(rows)
        w.finalize()
        sp = side.spill.SpilledTrack(str(d))
        crcs = {win: rec["crc"] for win, rec in sp.windows.items()}
        assert crcs == {win: zlib.crc32(b) & 0xFFFFFFFF
                        for win, b in blobs.items()}
        rec = sp.windows[1]
        with open(sp.bin_path, "r+b") as fh:
            fh.seek(rec["off"] + rec["nbytes"] // 2)
            b = fh.read(1)
            fh.seek(rec["off"] + rec["nbytes"] // 2)
            fh.write(bytes([b[0] ^ 0xFF]))
        flipped = (sp.window_blob(1), sp.crc_errors, sp.window_blob(0))
        del rec["crc"]                       # an index without crcs
        unverified = sp.window_blob(1) is not None
        os.unlink(sp.bin_path)               # spill bytes gone
        gone = (sp.window_blob(0), sp.read_window(0))
        got[side.name] = (flipped, unverified, gone)
        assert flipped[0] is None and flipped[1] == 1
        assert flipped[2] == blobs[0] and unverified
        assert gone == (None, None)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("keyframe", [True, False])
def test_seek_id_on_an_npt_grid_equals_the_reference(tmp_path, keyframe):
    sps = {}
    for side in SIDES:
        d = tmp_path / side.name / "t1"
        w = _writer(side, d, window_pkts=8)
        rng = np.random.default_rng(13)
        for win in range(6):
            rows = _rows(side, rng, 8, id_lo=win * 8)
            rows.arrival = (np.arange(8, dtype=np.int64) * 100
                            + win * 800 + 5000)
            rows.flags[:] = 0
            if win % 2 == 0:                 # SPS, PPS, IDR run
                rows.flags[2:5] = int(PacketFlags.KEYFRAME_FIRST)
            w.append_window(win, rows)
        w.finalize()
        sps[side.name] = side.spill.SpilledTrack(str(d))
    grid = np.round(np.arange(-0.5, 6.0, 0.05), 3)
    got = [sps["port"].seek_id(float(t), keyframe=keyframe) for t in grid]
    assert got == [sps["ref"].seek_id(float(t), keyframe=keyframe)
                   for t in grid]
    assert len(set(got)) > 4


def _frames(n_frames, *, gop=8, size=700, seq0=0, ts0=0, first=True):
    """``n_frames`` H.264 frames (FU-A past 1,400 bytes), SPS + PPS before
    the first IDR: [(frame, packets)]."""
    out, seq = [], seq0
    for i in range(n_frames):
        pkts = []
        if first and i == 0:
            for cfg in (SPS, PPS):
                pkts += ref_nalu.packetize_h264(
                    cfg, seq=seq, timestamp=ts0, ssrc=7,
                    marker_on_last=False)
                seq += 1
        nal = bytes((0x65 if i % gop == 0 else 0x41,)) \
            + bytes((i + j) & 0xFF for j in range(size))
        fr = ref_nalu.packetize_h264(nal, seq=seq, timestamp=ts0 + i * 3000,
                                     ssrc=7, mtu=1400)
        seq += len(fr)
        out.append(pkts + fr)
    return out


def test_spiller_on_the_live_ring_equals_the_reference(tmp_path):
    frames = _frames(40, size=300)
    counts = {}
    for side in SIDES:
        reg = side.Registry()
        sess = reg.find_or_create("/live/sp", VIDEO_SDP)
        stream = sess.streams[1]
        w = side.spill.SpillWriter(str(tmp_path / side.name / "t1"),
                                   stream.info, window_pkts=16)
        sp = side.spill.WindowSpiller(stream, w)
        for i, pkts in enumerate(frames):
            for p in pkts:
                sess.push(1, p, t_ms=T0 + i * 10)
            sp.tick(T0 + i * 10)
        counts[side.name] = (sp.spilled, sp.skipped, sp.next_win,
                             stream.rtp_ring.head)
        w.finalize()
    assert counts["port"] == counts["ref"]
    assert counts["port"][0] == counts["port"][3] // 16
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


# ======================================================== the cache's path
def test_get_packed_rows_equal_the_reference():
    got = {}
    for side in SIDES:
        c = side.new_cache()
        calls0 = side.cache.pack_window.calls
        rows = _rows(side, np.random.default_rng(17), 24, id_lo=48)

        def loader(win, rows=rows, side=side):
            return side.cache.CachedWindow.from_packed(
                None, rows.id_lo, rows.data, rows.length, rows.flags,
                rows.ts, seq=rows.seq, arrival=rows.arrival)

        w = c.get_packed(("dvr", "a"), 1, 2, loader)
        assert c.get_packed(("dvr", "a"), 1, 2, loader) is w
        c.pin(w)
        assert w.pins == 1
        c.unpin(w)
        assert side.cache.pack_window.calls == calls0
        got[side.name] = (w, (c.hits, c.misses, c.fills, c.bytes))
        c.close()
    w, rw = got["port"][0], got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    assert (w.lo, w.hi, w.key) == (rw.lo, rw.hi, rw.key)
    for f in ("data", "length", "flags", "ts", "seq", "arrival", "sample",
              "pkt_base", "staged"):
        assert np.array_equal(getattr(w, f), getattr(rw, f)), f
    assert w.restored is False and w.nbytes == rw.nbytes


def test_get_packed_loader_error_is_counted():
    c = cache.SegmentCache(budget_bytes=1 << 20, device="cpu")

    def loader(win):
        raise OSError("spill file gone")

    assert c.get_packed(("dvr", "a"), 1, 0, loader) is None
    assert c.fill_errors == 1 and c.stats()["fill_errors"] == 1


# ======================================================= time-shift wires
class _NativeOut(RelayOutput):
    """The engine's native UDP rung sends RTP to ``native_addr``; only
    RTCP reaches ``send_bytes``."""

    def send_bytes(self, data, *, is_rtcp):
        return WriteResult.OK


class _World:
    """One side's live session, DVR manager and pacer on a pinned clock:
    ``push`` admits frames at their arrival ms, ``pump`` is one wake
    (spill tick, pacer tick, every live and pacer stream served).  The
    port's streams are served by ``reflect`` (``engine=None``), by a
    ``FanoutEngine`` a stream on its native UDP rung (``"native"``), or
    with the megabatch scheduler in front of the engines as the server's
    pump runs it (``"megabatch"``)."""

    def __init__(self, side, root, *, k=16, sdp=VIDEO_SDP, path="/live/ts",
                 lookahead_ms=150, engine=None):
        self.engine = engine
        self.engines: dict = {}
        self.rx: list = []
        if engine is not None:
            from easydarwin_tpu_torch.relay.megabatch import \
                MegabatchScheduler
            self.tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.sched = MegabatchScheduler(device="cpu")
        self.side = side
        self.reg = side.Registry()
        self.cache = side.new_cache()
        self.pacer = side.Pacer(self.cache, lookahead_ms=lookahead_ms)
        self.dvr = side.service.DvrManager(
            str(root), self.cache, self.pacer, self.reg, window_pkts=k,
            retention_bytes=32 << 20, retention_sec=600.0)
        self.sess = self.reg.find_or_create(path, sdp)
        self.path = path
        self.t = T0

    def push(self, frames, *, dt=33, pump=True):
        for pkts in frames:
            for p in pkts:
                self.sess.push(1, p, t_ms=self.t)
            if pump:
                self.pump()
            self.t += dt

    def pump(self, t=None):
        t = self.t if t is None else t
        self.dvr.tick(t)
        pairs = self.pacer.tick(t)
        if self.engine is None:
            for st in self.sess.streams.values():
                st.reflect(t)
            for st, _e in pairs:
                st.reflect(t)
            return
        from easydarwin_tpu_torch.relay.fanout import FanoutEngine
        served = []
        for st in [s for s in self.sess.streams.values() if s.num_outputs] \
                + [s for s, _e in pairs]:
            eng = self.engines.get(id(st))
            if eng is None:
                eng = self.engines[id(st)] = FanoutEngine(device="cpu")
                eng.egress_fd = self.tx.fileno()
            served.append((st, eng))
        mega = self.engine == "megabatch" and len(served) >= 2
        if mega:
            self.sched.begin_wake(served, t)
        else:
            self.sched.idle_wake()
            for _st, eng in served:
                eng.megabatch_owned = False
        for st, eng in served:
            eng.step(st, t)
        if mega:
            self.sched.end_wake(served, t)

    def output(self, **kw):
        """A new output of this world's serving kind, and a function that
        returns what it was sent."""
        if self.engine is None:
            out = self.side.Out(**kw)
            return out, lambda: out.wire
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        rx.setblocking(False)
        self.rx.append(rx)
        out = _NativeOut(**kw)
        out.native_addr = rx.getsockname()
        got: list[bytes] = []

        def capture():
            while True:
                try:
                    got.append(rx.recv(65536))
                except BlockingIOError:
                    return got
        return out, capture

    def close(self):
        self.pacer.close()
        self.cache.close()
        if self.engine is not None:
            self.sched.drain()
            for rx in self.rx:
                rx.close()
            self.tx.close()


def _gapless(wire, seq0, ssrc):
    seqs = [rtp.peek_seq(d) for d in wire]
    assert {rtp.peek_ssrc(d) for d in wire} == {ssrc}
    assert seqs == [(seq0 + i) & 0xFFFF for i in range(len(wire))]


def _rewind_catchup(side, root, frames, engine=None):
    """A Range rewind (npt 0, Speed 4) on a fresh output with the live
    capture's rewrite, pushed until it joins; the live capture and the
    shifted one."""
    w = _World(side, root, engine=engine)
    live, live_wire = w.output(ssrc=0x111, out_seq_start=500,
                               out_ts_start=9000)
    w.sess.streams[1].add_output(live)
    assert w.dvr.arm(w.sess, VIDEO_SDP)
    w.push(frames[:60])
    shifted, shifted_wire = w.output(ssrc=0x111, out_seq_start=500,
                                     out_ts_start=9000)
    sh = w.dvr.open_timeshift(w.path, {1: shifted}, start_npt=0.0,
                              speed=4.0, now_ms=w.t)
    assert sh is not None and sh.catchup_pending
    i = 60
    while not sh.tracks[0].joined and i < len(frames) - 12:
        w.push(frames[i:i + 1])
        i += 1
    assert sh.tracks[0].joined, "no catch-up join"
    w.push(frames[i:i + 12])
    for _ in range(10):
        w.t += 33
        w.pump()
    res = {"live": list(live_wire()), "shifted": list(shifted_wire()),
           "join_at": i,
           "joins": sum(tr.joined for tr in sh.tracks),
           "windows": w.dvr.finalize(w.path)["windows"],
           "calls": side.cache.pack_window.calls,
           "sched": w.sched.stats() if engine else None,
           "native_sent": sum(e.native_sent for e in w.engines.values())}
    w.close()
    return res


@pytest.mark.parametrize("engine", ["native", "megabatch"])
def test_rewind_through_the_engine_rungs_equals_the_reference(tmp_path,
                                                              engine):
    """The shift stream and the live one served by the port's
    ``FanoutEngine`` on its native UDP rung, alone or behind the megabatch
    scheduler: the datagrams equal the reference's scalar wire."""
    if not native.available():
        pytest.skip("the egress core does not build here")
    frames = _frames(300)
    r = _rewind_catchup(REF, tmp_path / "ref", frames)
    p = _rewind_catchup(PORT, tmp_path / "port", frames, engine=engine)
    assert p["join_at"] == r["join_at"] and p["joins"] == 1
    assert p["live"] == r["live"]
    assert p["shifted"] == r["shifted"]
    _gapless(p["shifted"], 500, 0x111)
    assert p["native_sent"] == len(p["live"]) + len(p["shifted"])
    if engine == "megabatch":
        assert p["sched"]["window_calls"] > 0
        assert p["sched"]["streams_coalesced"] > 0
        assert p["sched"]["mismatches"] == 0


def test_rewind_at_speed_4_wire_equals_the_reference(tmp_path):
    frames = _frames(300)
    calls0 = cache.pack_window.calls
    got = {s.name: _rewind_catchup(s, tmp_path / s.name, frames)
           for s in SIDES}
    p, r = got["port"], got["ref"]
    assert p["shifted"] == r["shifted"] and p["live"] == r["live"]
    assert (p["join_at"], p["joins"], p["windows"]) == \
        (r["join_at"], r["joins"], r["windows"])
    assert p["joins"] == 1 and p["windows"] > 0
    # the replay and its catch-up tail are the live capture's bytes
    assert len(p["live"]) > 70
    assert p["shifted"] == p["live"][:len(p["shifted"])]
    assert len(p["shifted"]) == len(p["live"])
    _gapless(p["shifted"], 500, 0x111)
    assert p["calls"] == calls0              # nothing was repacked


def _pause_resume(side, root, frames, speed):
    """A live output PAUSEs at frame 50 (its bookmark latched as the
    resume cursor), 30 frames go by, and it resumes at ``speed``."""
    w = _World(side, root)
    out = side.Out(ssrc=0x222, out_seq_start=100, out_ts_start=777)
    stream = w.sess.streams[1]
    stream.add_output(out)
    assert w.dvr.arm(w.sess, VIDEO_SDP)
    w.push(frames[:50])
    ids = {1: int(out.bookmark)}
    stream.remove_output(out)
    w.push(frames[50:80])
    sh = w.dvr.open_timeshift(w.path, {1: out}, start_ids=ids,
                              speed=speed, now_ms=w.t)
    pause_ids = []
    i = 80
    while i < 200 and not sh.tracks[0].joined:
        w.push(frames[i:i + 1])
        pause_ids.append(sh.pause_ids())
        i += 1
    res = {"wire": out.wire, "ids": ids, "joined": sh.tracks[0].joined,
           "pause_ids": pause_ids, "npt": sh.position_npt(),
           "head": stream.rtp_ring.head}
    sh.stop()
    w.close()
    return res


@pytest.mark.parametrize("speed", [2.0, 1.0])
def test_pause_resume_wire_equals_the_reference(tmp_path, speed):
    frames = _frames(220)
    got = {s.name: _pause_resume(s, tmp_path / s.name, frames, speed)
           for s in SIDES}
    p, r = got["port"], got["ref"]
    assert p == r
    assert p["joined"] == (speed > 1.0)      # a 1x resume stays shifted
    _gapless(p["wire"], 100, 0x222)
    # the first packet after the pause is the bookmark's own packet
    ring_ids = [p["ids"][1] + j for j in range(len(p["wire"]))]
    assert ring_ids[0] == p["ids"][1]
    assert all(0 < d[1] <= p["head"] for d in p["pause_ids"])


def _run_session(w, sess, limit=400):
    for _ in range(limit):
        if sess.done:
            break
        w.t += 5
        for st, _e in w.pacer.tick(w.t):
            st.reflect(w.t)
    return sess.done


def _clamped(side, root):
    """A window snapshot above its grid line (ids 5..12 of window 0) and a
    resume cursor at 0: the rows are served once each, and the resume is
    anchored on the first row served."""
    d = root / "t1"
    wr = side.spill.SpillWriter(str(d), _info(side), window_pkts=16)
    wr.append_window(0, _rows(side, np.random.default_rng(19), 8, id_lo=5))
    wr.finalize()
    sp = side.spill.SpilledTrack(str(d))
    w = _World(side, root / "dvr")
    asset = side.service.DvrAsset("/live/tc", str(root), {1: sp},
                                  complete=True)
    out = side.Out(ssrc=0x444, out_seq_start=10, out_ts_start=0)
    sess = side.timeshift.TimeShiftSession(
        w.pacer, asset, {1: out}, start_ids={1: 0}, speed=1000.0,
        now_ms=w.t)
    pending = sess.anchor_pending
    w.pacer.adopt(sess)
    done = _run_session(w, sess)
    res = (out.wire, pending, done, sess.tracks[0].gaps)
    sess.stop()
    w.close()
    return res


def test_tail_clamped_window_equals_the_reference(tmp_path):
    got = {s.name: _clamped(s, tmp_path / s.name) for s in SIDES}
    assert got["port"] == got["ref"]
    wire, pending, done, gaps = got["port"]
    assert pending and done and gaps >= 1
    assert len(wire) == 8 and len({d[12:] for d in wire}) == 8


def _audio_resume(side, root):
    """An audio-only PAUSE resume at id 24 of a recording spread over
    ~64 s: anchored at the resume point, so the tail arrives at once."""
    d = root / "t2"
    wr = side.spill.SpillWriter(str(d), _info(side, "audio"),
                                window_pkts=8)
    rng = np.random.default_rng(23)
    for win in range(4):
        rows = _rows(side, rng, 8, id_lo=win * 8)
        rows.arrival = (np.arange(8, dtype=np.int64) + win * 8) * 2000
        wr.append_window(win, rows)
    wr.finalize()
    sp = side.spill.SpilledTrack(str(d))
    w = _World(side, root / "dvr")
    asset = side.service.DvrAsset("/live/ao", str(root), {2: sp},
                                  complete=True)
    out = side.Out(ssrc=0x555, out_seq_start=10, out_ts_start=0)
    sess = side.timeshift.TimeShiftSession(
        w.pacer, asset, {2: out}, start_ids={2: 24}, speed=1000.0,
        now_ms=w.t)
    pending = sess.anchor_pending
    w.pacer.adopt(sess)
    done = _run_session(w, sess, limit=40)
    res = (out.wire, pending, done, sess.anchor_pending, sess.anchor_arr)
    sess.stop()
    w.close()
    return res


def test_resume_anchor_equals_the_reference(tmp_path):
    got = {s.name: _audio_resume(s, tmp_path / s.name) for s in SIDES}
    assert got["port"] == got["ref"]
    wire, pending, done, still, _arr = got["port"]
    assert pending and done and not still and len(wire) == 8


def _rearm(side, root):
    """Windows past the per-wake cap pushed with no tick: the finalize
    flushes them all; a re-arm bumps the generation (a new cache key)
    and an old reader's reload finds itself superseded."""
    w = _World(side, root, k=8, path="/live/g")
    assert w.dvr.arm(w.sess, VIDEO_SDP)
    w.push(_frames(96, size=200), pump=False)
    head = w.sess.streams[1].rtp_ring.head
    res1 = w.dvr.finalize("/live/g")
    a1 = w.dvr.open_asset("/live/g")
    sess2 = w.reg.find_or_create("/live/g", VIDEO_SDP)
    assert w.dvr.arm(sess2, VIDEO_SDP)
    w.dvr.finalize("/live/g")
    a2 = w.dvr.open_asset("/live/g")
    old = a1.tracks[1]
    miss = old.read_window(10 ** 6)
    out = (res1["windows"], head // 8, a1.asset_key[2], a2.asset_key[2],
           miss, old.superseded, old.windows)
    a1.close()
    a2.close()
    w.close()
    return out


def test_rearm_generation_and_full_flush_equal_the_reference(tmp_path):
    got = {s.name: _rearm(s, tmp_path / s.name) for s in SIDES}
    assert got["port"] == got["ref"]
    windows, full, g1, g2, miss, superseded, wins = got["port"]
    assert windows == full and g2 == g1 + 1
    assert miss is None and superseded and wins == {}
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def _replay(side, root, frames):
    w = _World(side, root)
    assert w.dvr.arm(w.sess, VIDEO_SDP)
    w.push(frames)
    w.reg.remove(w.path)
    w.pump()                                 # the pusher left: finalize
    assert not w.dvr.armed(w.path)
    asset = w.dvr.open_asset(w.path)
    n = sum(r["n"] for r in asset.tracks[1].windows.values())
    complete = asset.complete
    asset.close()
    out = side.Out(ssrc=0x777, out_seq_start=60000, out_ts_start=1)
    calls0 = side.cache.pack_window.calls
    sess = w.dvr.open_timeshift(w.path + ".dvr", {1: out}, start_npt=0.0,
                                speed=2000.0, now_ms=w.t)
    done = _run_session(w, sess)
    res = (out.wire, n, complete, done,
           side.cache.pack_window.calls - calls0)
    w.close()
    return res


def test_finalized_replay_equals_the_reference(tmp_path):
    frames = _frames(90)
    got = {s.name: _replay(s, tmp_path / s.name, frames) for s in SIDES}
    assert got["port"] == got["ref"]
    wire, n, complete, done, repacks = got["port"]
    assert complete and done and repacks == 0 and len(wire) == n
    _gapless(wire, 60000, 0x777)
    assert rtp.RtpPacket.parse(wire[0]).payload[0] & 0x1F == 7
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def test_a_failing_finalize_hook_is_counted(tmp_path):
    w = _World(PORT, tmp_path)
    assert w.dvr.arm(w.sess, VIDEO_SDP)
    w.push(_frames(40))

    def boom(_result):
        raise RuntimeError("store refused")

    w.dvr.on_finalize = boom
    res = w.dvr.finalize(w.path)
    assert res["windows"] > 0 and w.dvr.finalize_errors == 1
    st = w.dvr.stats()
    assert st["finalize_errors"] == 1 and st["finalized"] == 1
    asset = w.dvr.open_asset(w.path)
    assert asset.complete                    # the asset still finalized
    asset.close()
    w.close()


# ======================================================= RTSP end to end
async def _rtsp_flow(app, client_cls, tmp_path):
    """The reference's end-to-end flow over interleaved TCP: returns what
    the player and the replayer saw."""
    uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/e2e"
    pusher = client_cls()
    await pusher.connect("127.0.0.1", app.rtsp.port)
    await pusher.push_start(uri, VIDEO_SDP)
    assert app.dvr.armed("/live/e2e")        # RECORD armed the spiller
    frames = _frames(400, size=300)
    pos = 0

    async def push(n):
        nonlocal pos
        for pkts in frames[pos:pos + n]:
            for p in pkts:
                pusher.push_packet(0, p)
            await asyncio.sleep(0.005)
        pos += n

    async def drain(client, sink, timeout):
        try:
            while True:
                sink.append(await client.recv_interleaved(0,
                                                          timeout=timeout))
        except asyncio.TimeoutError:
            pass

    await push(40)
    player = client_cls()
    await player.connect("127.0.0.1", app.rtsp.port)
    await player.play_start(uri)
    got = [await player.recv_interleaved(0, timeout=5)]
    await push(10)
    await drain(player, got, 0.3)
    r = await player.request("PAUSE", uri)
    assert r.status == 200
    conn = next(c for c in app.rtsp.connections if c.player_tracks)
    assert conn.pause_ids, "PAUSE under DVR must latch resume ids"
    await push(10)
    r = await player.request("PLAY", uri, {"range": "npt=0.0-",
                                           "speed": "4"})
    assert r.status == 200 and r.headers.get("speed") == "4"
    shifted = []
    deadline = time.time() + 10
    while (conn.vod_session is not None
           and not conn.vod_session.tracks[0].joined
           and time.time() < deadline):
        await push(2)
        await drain(player, shifted, 0.05)
    joined = conn.vod_session.tracks[0].joined
    await push(8)
    await drain(player, shifted, 0.3)
    status, body = await _rest(app.rest.port,
                               "/api/v1/stoprecord?path=/live/e2e")
    replayer = client_cls()
    await replayer.connect("127.0.0.1", app.rtsp.port)
    await replayer.play_start(uri + ".dvr")
    more = [await replayer.recv_interleaved(0, timeout=5)]
    try:
        while len(more) < 12:
            more.append(await replayer.recv_interleaved(0, timeout=1.0))
    except asyncio.TimeoutError:
        pass
    r = await replayer.request("PAUSE", uri + ".dvr")
    assert r.status == 200
    await drain(replayer, more, 0.2)
    rconn = next(c for c in app.rtsp.connections if c.dvr_path is not None)
    dvr_pause = dict(rconn.pause_ids or {})
    r = await replayer.request("PLAY", uri + ".dvr")
    assert r.status == 200
    nxt = await replayer.recv_interleaved(0, timeout=5)
    await replayer.teardown(uri + ".dvr")
    await replayer.close()
    await player.teardown(uri)
    await player.close()
    await pusher.close()
    return {"got": got, "shifted": shifted, "joined": joined,
            "stop": (status, body), "more": more, "next": nxt,
            "dvr_pause": dvr_pause}


async def _rest(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    head = await reader.readuntil(b"\r\n\r\n")
    clen = int([ln for ln in head.split(b"\r\n")
                if ln.lower().startswith(b"content-length")][0]
               .split(b":")[1])
    body = json.loads(await reader.readexactly(clen))
    writer.close()
    return int(head.split(b" ")[1]), body


def _check_flow(res):
    shifted = res["shifted"]
    assert res["joined"], "no catch-up join"
    seqs = [rtp.RtpPacket.parse(d).seq for d in shifted]
    assert len({rtp.RtpPacket.parse(d).ssrc for d in shifted}) == 1
    assert seqs == [(seqs[0] + i) & 0xFFFF for i in range(len(seqs))]
    # the replay restarted at npt 0: the stream's first packet, the SPS
    assert rtp.RtpPacket.parse(shifted[0]).payload[0] & 0x1F == 7
    status, body = res["stop"]
    assert status == 200
    assert int(body["EasyDarwin"]["Body"]["DvrWindows"]) > 0
    assert rtp.RtpPacket.parse(res["more"][0]).payload[0] & 0x1F == 7
    assert res["dvr_pause"], ".dvr PAUSE must latch resume ids"
    last = rtp.RtpPacket.parse(res["more"][-1]).seq
    assert rtp.RtpPacket.parse(res["next"]).seq == (last + 1) & 0xFFFF


async def test_rtsp_pause_rewind_catchup_replay_on_both_servers(tmp_path):
    from easydarwin_tpu.server import ServerConfig as RefConfig
    from easydarwin_tpu.server import StreamingServer as RefServer
    from easydarwin_tpu.utils.client import RtspClient
    from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
    res = {}
    for name, (cfg_cls, srv_cls, kw) in {
            "ref": (RefConfig, RefServer, dict(log_folder=str(tmp_path))),
            "port": (ServerConfig, lambda c: StreamingServer(c,
                                                             device="cpu"),
                     {})}.items():
        folder = tmp_path / name
        cfg = cfg_cls(rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
                      movie_folder=str(folder), reflect_interval_ms=5,
                      dvr_enabled=True, dvr_window_pkts=16, **kw)
        app = srv_cls(cfg)
        await app.start()
        try:
            assert app.dvr is not None
            res[name] = await _rtsp_flow(app, RtspClient, tmp_path)
            if name == "port":
                st = app.stats()
                assert st["dvr"]["catchup_joins"] >= 1
                assert st["dvr"]["finalize_errors"] == 0
                assert st["dvr"]["spill_errors"] == 0
                assert st["pump_errors"] == 0 and st["vod_errors"] == 0
        finally:
            await app.stop()
        _check_flow(res[name])


def test_dvr_loopback_harness_on_the_cpu(tmp_path):
    """``utils.dvr_loopback.dvr_session`` at a small size against the CLI
    server on the CPU: live, pause and range players with their catch-up
    joins, ``.dvr`` replays, and replays served by the store's
    reconstruct after the spill files and 2 shards a stripe are gone."""
    if not native.available():
        pytest.skip("the egress core does not build here")
    from easydarwin_tpu_torch.utils import dvr_loopback as dl
    res = asyncio.run(dl.dvr_session(
        "cpu", str(tmp_path / "movies"), np.random.default_rng(31),
        kinds=dl.phase_players(2, 1, 1), push_s=3.0, gop=15,
        packets_per_frame=3, body_len=(200, 400), pause_at=1.0,
        resume_at=1.5, range_at=1.8, range_npt=0.5, n_replay=1,
        n_reconstruct=1, window_pkts=16, settle_s=15.0))
    a, b = res["server_a"], res["server_b"]
    assert a["dvr"]["catchup_joins"] == 2 * 2      # 2 players, 2 tracks
    assert a["dvr"]["finalize_errors"] == a["dvr"]["spill_errors"] == 0
    assert a["dvr_megabatch_streams"] > 0
    st = a["storage"]
    assert st["assets"] == 1 and st["oracle_mismatches"] == 0
    assert st["push_failures"] == st["worker_errors"] == 0
    assert res["scrub"]["errors"] == 0
    assert res["scrub"]["scrubbed"] == res["scrub"]["files"] \
        == st["shards_local"]
    rb = b["storage"]
    assert rb["reconstructs"] > 0 and rb["reconstruct_failures"] == 0
    assert rb["device_passes"] >= res["deleted"]["stripes"]
    assert res["by_kind"]["reconstruct"]["players"] == 1


@pytest.mark.parametrize("flags,dvr,storage", [
    (dict(dvr_enabled=True, vod_cache_enabled=False), False, False),
    (dict(storage_enabled=True), False, False),
    (dict(dvr_enabled=True, storage_enabled=True), True, True),
])
def test_dvr_and_storage_need_their_tiers(tmp_path, flags, dvr, storage):
    """DVR without the segment cache, or the store without DVR, is
    refused and stays off, as in the reference."""
    from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
    app = StreamingServer(ServerConfig(movie_folder=str(tmp_path),
                                       **flags), device="cpu")
    assert (app.dvr is not None) == dvr
    assert (app.storage is not None) == storage
    if storage:
        assert app.dvr.on_finalize is not None
        assert app.dvr.restorer is not None
        assert app.storage.codec.device.type == "cpu"
    st = app.stats()
    assert (st["dvr"] is not None) == dvr
    assert (st["storage"] is not None) == storage


async def test_rest_record_arms_and_finalizes_dvr_like_the_reference(
        tmp_path):
    """startrecord also arms DVR, stoprecord also finalizes it, and
    storagestats answers, on both servers."""
    from easydarwin_tpu.server import ServerConfig as RefConfig
    from easydarwin_tpu.server import StreamingServer as RefServer
    from easydarwin_tpu.utils.client import RtspClient
    from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
    got = {}
    for name, (cfg_cls, make, kw) in {
            "ref": (RefConfig, RefServer, dict(log_folder=str(tmp_path))),
            "port": (ServerConfig,
                     lambda c: StreamingServer(c, device="cpu"), {})
    }.items():
        cfg = cfg_cls(rtsp_port=0, service_port=0, bind_ip="127.0.0.1",
                      movie_folder=str(tmp_path / name),
                      reflect_interval_ms=5, dvr_enabled=True,
                      dvr_window_pkts=16, storage_enabled=True, **kw)
        app = make(cfg)
        await app.start()
        try:
            uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/rec"
            pusher = RtspClient()
            await pusher.connect("127.0.0.1", app.rtsp.port)
            await pusher.push_start(uri, VIDEO_SDP)
            for pkts in _frames(40, size=300):
                for p in pkts:
                    pusher.push_packet(0, p)
                await asyncio.sleep(0.003)
            st1, b1 = await _rest(app.rest.port, "/api/v1/startrecord?"
                                  "path=/live/rec&file=rec.mp4")
            await asyncio.sleep(0.2)
            st2, b2 = await _rest(app.rest.port,
                                  "/api/v1/stoprecord?path=/live/rec")
            st3, b3 = await _rest(app.rest.port,
                                  "/api/v1/stoprecord?path=/live/none")
            for _ in range(100):
                st4, b4 = await _rest(app.rest.port,
                                      "/api/v1/storagestats")
                if b4.get("assets"):
                    break
                await asyncio.sleep(0.05)
            await pusher.close()
        finally:
            await app.stop()
        got[name] = (st1, b1["EasyDarwin"]["Body"]["Dvr"], st2,
                     int(b2["EasyDarwin"]["Body"]["DvrWindows"]), st3,
                     st4, b4["enabled"], b4["assets"],
                     isinstance(b4["pack_window_calls"], int))
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (200, "1") and got["port"][3] > 0
    assert got["port"][4] == 404 and got["port"][7] == 1
