"""The port's segment cache, group pacer and device prime on the CPU,
against the JAX package.

* ``pack_window`` gives the reference's packed rows (``staged``,
  ``length``, ``flags``, ``ts``, packet bytes) for every window of a
  seeded clip, video and audio;
* ``ops.staging.gather_window`` over a ``StagedPacketRing`` (per-packet
  pushes and ``push_block``) equals the reference's and the port's plain
  gather over a ``PacketRing``;
* wire bytes over real UDP sockets: the hot path (cache-fed ring, the
  scalar ``reflect`` or the ``FanoutEngine``'s native scatter) equals
  the cold ``FileSession`` and the reference's cold path, with a seek and
  thinning; a cache miss streams the same bytes;
* ``_prime_joined`` of 4 joins with distinct SSRC and seq installs the
  reference's affine segments, on a window of 2,048 rows and on one of
  32,768 (past one launch's 16,384: run in pieces);
* the megabatch ride: 4 native subscribers device-primed, coalesced,
  oracle-clean, every datagram equal to the cold path's;
* host pieces pinned by hand: the cache's LRU budget and pinning, the
  checkpoint metadata round trip, thinning admit/shed counts.
"""

import asyncio
import socket
import time

import numpy as np
import pytest
import torch

from easydarwin_tpu.ops import staging as ref_staging
from easydarwin_tpu.relay.fanout import TpuFanoutEngine as RefEngine
from easydarwin_tpu.relay.output import RelayOutput as RefRelayOutput
from easydarwin_tpu.relay.output import WriteResult as RefWriteResult
from easydarwin_tpu.relay.ring import PacketRing as RefRing
from easydarwin_tpu.vod import cache as ref_cache
from easydarwin_tpu.vod import session as ref_session
from easydarwin_tpu.vod.mp4 import open_shared as ref_open_shared
from easydarwin_tpu_torch import native
from easydarwin_tpu_torch.ops import staging
from easydarwin_tpu_torch.relay.fanout import FanoutEngine
from easydarwin_tpu_torch.relay.megabatch import MegabatchScheduler
from easydarwin_tpu_torch.relay.output import RelayOutput, WriteResult
from easydarwin_tpu_torch.relay.ring import PacketRing
from easydarwin_tpu_torch.utils.vod_clips import ClipSpec, write_clip
from easydarwin_tpu_torch.vod.cache import (SegmentCache, StagedPacketRing,
                                            pack_window, tracks_by_no)
from easydarwin_tpu_torch.vod.mp4 import open_shared
from easydarwin_tpu_torch.vod.session import FileSession, VodPacerGroup

#: the reference suite's fixture shape: 30 frames at 30 fps, an IDR every
#: 10 (2,000 bytes: FU-A fragments), P frames of 80 bytes, 8 kHz AAC
SMALL = ClipSpec(frames=30, fps=30, gop=10, idr_bytes=2000, p_bytes=80,
                 audio_rate=8000, audio_frame_bytes=40)


@pytest.fixture
def clip(tmp_path):
    return write_clip(tmp_path / "clip.mp4", SMALL, seed=11)


class UdpOut(RelayOutput):
    """A real-socket sink (RTCP dropped, so RTP streams compare clean)."""

    def __init__(self, sock, addr, **kw):
        super().__init__(**kw)
        self.sock, self.addr = sock, addr

    def send_bytes(self, data, *, is_rtcp):
        if not is_rtcp:
            self.sock.sendto(data, self.addr)
        return WriteResult.OK


class RefUdpOut(RefRelayOutput):
    def __init__(self, sock, addr, **kw):
        super().__init__(**kw)
        self.sock, self.addr = sock, addr

    def send_bytes(self, data, *, is_rtcp):
        if not is_rtcp:
            self.sock.sendto(data, self.addr)
        return RefWriteResult.OK


class NativeOut(RelayOutput):
    """The engine's UDP fast rung sends RTP through ``native_addr``; only
    RTCP reaches ``send_bytes``."""

    def send_bytes(self, data, *, is_rtcp):
        return WriteResult.OK


class RefNativeOut(RefRelayOutput):
    def send_bytes(self, data, *, is_rtcp):
        return RefWriteResult.OK


def _rx():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.setblocking(False)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    return s


def _drain(sock) -> list[bytes]:
    out = []
    while True:
        try:
            out.append(sock.recv(65536))
        except BlockingIOError:
            return out


@pytest.fixture
def socks():
    rx_v, rx_a = _rx(), _rx()
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    yield rx_v, rx_a, tx
    for s in (rx_v, rx_a, tx):
        s.close()


# ---------------------------------------------------------------- packing

@pytest.mark.parametrize("window_samples", [4, 8, 64])
def test_pack_window_equals_the_reference(tmp_path, window_samples):
    spec = ClipSpec(frames=40, fps=30, gop=12, idr_bytes=5000, p_bytes=300,
                    audio_rate=8000, audio_frame_bytes=40)
    path = write_clip(tmp_path / "c.mp4", spec, seed=5)
    f, rf = open_shared(path), ref_open_shared(path)
    for (tno, tr), rtr in zip(tracks_by_no(f).items(),
                              ref_cache.tracks_by_no(rf).values()):
        for lo in range(0, tr.n_samples, window_samples):
            hi = min(lo + window_samples, tr.n_samples)
            w = pack_window(f, tr, lo, hi)
            rw = ref_cache.pack_window(rf, rtr, lo, hi)
            for name in ("staged", "length", "flags", "ts", "data",
                         "sample", "npt", "pkt_base", "sample_npt"):
                assert np.array_equal(getattr(w, name), getattr(rw, name)), \
                    (tno, lo, name)
    f.close()
    rf.close()


def test_staged_ring_gather_equals_the_reference_and_the_plain(clip):
    f = open_shared(clip)
    tr = f.video_track()
    w = pack_window(f, tr, 0, 12)
    n = w.n_pkts
    t = 1000
    plain, st = PacketRing(64, is_video=True), StagedPacketRing(64,
                                                                is_video=True)
    rplain = RefRing(64, is_video=True)
    rst = ref_cache.StagedPacketRing(64, is_video=True)
    for k in range(n):
        pkt = w.data[k, :w.length[k]].tobytes()
        for ring in (plain, st, rplain, rst):
            ring.push(pkt, t)
    rows = {}
    for name, ring, mod in (("plain", plain, staging),
                            ("staged", st, staging),
                            ("ref_plain", rplain, ref_staging),
                            ("ref_staged", rst, ref_staging)):
        out = np.zeros((staging.pow2(n, 16), staging.ROW_STRIDE), np.uint8)
        assert mod.gather_window(ring, 0, n, out) == n
        rows[name] = out
    for name in ("staged", "ref_plain", "ref_staged"):
        assert np.array_equal(rows["plain"], rows[name]), name
    # the block fill keeps the staged rows current as the pushes did,
    # from a wrapped start
    blk, rblk = StagedPacketRing(64, is_video=True), \
        ref_cache.StagedPacketRing(64, is_video=True)
    for ring in (blk, rblk):
        ring.head = ring.tail = 60
    seqs = (np.arange(n) + 7) & 0xFFFF
    blk.push_block(w.data[:n], w.length[:n], np.full(n, t, np.int64),
                   w.flags[:n], seqs, w.ts[:n])
    rblk.push_block(w.data[:n], w.length[:n], np.full(n, t, np.int64),
                    w.flags[:n], seqs.astype(np.uint32), w.ts[:n])
    a = np.zeros_like(rows["plain"])
    b = np.zeros_like(a)
    assert staging.gather_window(blk, 60, n, a) == n
    assert ref_staging.gather_window(rblk, 60, n, b) == n
    assert np.array_equal(a, b)
    for name in ("data", "length", "flags", "seq", "timestamp", "arrival"):
        assert np.array_equal(getattr(blk, name), getattr(rblk, name)), name
    f.close()


# ------------------------------------------------------- wire byte identity

def _run_cold(path, rx_v, rx_a, tx, *, start_npt=0.0, level=0,
              ref=False):
    f = (ref_open_shared if ref else open_shared)(path)
    out_cls = RefUdpOut if ref else UdpOut
    vo = out_cls(tx, rx_v.getsockname(), ssrc=0x111, out_seq_start=500)
    ao = out_cls(tx, rx_a.getsockname(), ssrc=0x222, out_seq_start=900)
    vo.thinning.controller.level = level
    cls = ref_session.FileSession if ref else FileSession
    sess = cls(f, {1: vo, 2: ao}, start_npt=start_npt, speed=2000.0)
    asyncio.run(sess.run())
    f.close()
    time.sleep(0.05)
    return _drain(rx_v), _drain(rx_a), sess


def _run_hot(path, rx_v, rx_a, tx, *, start_npt=0.0, level=0,
             engine=False, cache=None):
    f = open_shared(path)
    cache = cache or SegmentCache(window_samples=8, device="cpu")
    engines = {}

    def engine_for(st):
        e = engines.get(id(st))
        if e is None:
            e = engines[id(st)] = FanoutEngine(egress_fd=tx.fileno(),
                                               device="cpu")
        return e

    pacer = VodPacerGroup(cache, engine_for=engine_for if engine else None,
                          engine_drop=lambda s: engines.pop(id(s), None),
                          lookahead_ms=250)
    if engine:
        vo = NativeOut(ssrc=0x111, out_seq_start=500)
        vo.native_addr = rx_v.getsockname()
        ao = NativeOut(ssrc=0x222, out_seq_start=900)
        ao.native_addr = rx_a.getsockname()
    else:
        vo = UdpOut(tx, rx_v.getsockname(), ssrc=0x111, out_seq_start=500)
        ao = UdpOut(tx, rx_a.getsockname(), ssrc=0x222, out_seq_start=900)
    vo.thinning.controller.level = level
    sess = pacer.open(f, {1: vo, 2: ao}, start_npt=start_npt, speed=2000.0,
                      now_ms=int(time.monotonic() * 1000))
    deadline = time.time() + 20
    while not sess.done and time.time() < deadline:
        t = int(time.monotonic() * 1000)
        for st, e in pacer.tick(t):
            if e is not None:
                e.megabatch_owned = False
                e.step(st, t)
            else:
                st.reflect(t)
        time.sleep(0.001)
    assert sess.done, "hot session never finished"
    pacer.close()
    f.close()
    time.sleep(0.05)
    return _drain(rx_v), _drain(rx_a), sess


@pytest.mark.parametrize("engine", [False, True], ids=["reflect", "engine"])
@pytest.mark.parametrize("start_npt,level", [(0.0, 0), (0.5, 2), (0.0, 1)])
def test_hot_wire_bytes_equal_cold_and_the_reference(clip, socks, engine,
                                                     start_npt, level):
    """The acceptance oracle: mixed video + audio, a seek and thinning,
    over real UDP sockets; the hot path's wire bytes equal the cold
    ``FileSession``'s and the reference's cold path's, frame for frame,
    with the same frames shed.  Level 1 sheds every second non-key frame
    (15 of 30); level 2 every non-key frame after the seek to 0.5 s, which
    snaps to the IDR at sample 10 (18 of 20)."""
    if engine and not native.available():
        pytest.skip("the egress core does not build here")
    rx_v, rx_a, tx = socks
    cv, ca, cs = _run_cold(clip, rx_v, rx_a, tx, start_npt=start_npt,
                           level=level)
    rv, ra, rs = _run_cold(clip, rx_v, rx_a, tx, start_npt=start_npt,
                           level=level, ref=True)
    hv, ha, hs = _run_hot(clip, rx_v, rx_a, tx, start_npt=start_npt,
                          level=level, engine=engine)
    assert cv and ca
    assert cv == rv and ca == ra
    assert hv == cv and ha == ca
    assert hs.frames_thinned == cs.frames_thinned == rs.frames_thinned
    want = {0: 0, 1: 15, 2: 18}[level]
    assert cs.frames_thinned == want


def test_cold_miss_path_streams_the_hot_bytes(clip, socks):
    """A cache miss streams through the per-sample path into the same
    ring: the wire bytes equal the hot fill's."""
    rx_v, rx_a, tx = socks

    class NeverHit(SegmentCache):
        def get(self, *a, **kw):
            kw["background_fill"] = False
            super().get(*a, **kw)        # count the miss
            return None

    hv, ha, _ = _run_hot(clip, rx_v, rx_a, tx)
    cache = NeverHit(window_samples=8, device="cpu")
    mv, ma, _ = _run_hot(clip, rx_v, rx_a, tx, cache=cache)
    assert mv == hv and ma == ha
    assert cache.misses > 0 and cache.hits == 0


# ------------------------------------------------ the device prime

class _Recorder:
    """A scheduler stand-in that records every installed segment and runs
    the real window call."""

    def __init__(self, real):
        self.real = real
        self.installed = []

    def __getattr__(self, name):
        return getattr(self.real, name)

    def _install_segment(self, eng, key, seg, base=None):
        self.installed.append((key, seg))
        return self.real._install_segment(eng, key, seg, base)


def _prime_once(path, window_samples, *, ref, tx):
    """Open 4 sessions of distinct SSRC and seq on a warm cache and tick
    the pacer once: the fill and ``_prime_joined``."""
    if ref:
        from easydarwin_tpu.relay.megabatch import MegabatchScheduler as RS
        f = ref_open_shared(path)
        cache = ref_cache.SegmentCache(window_samples=window_samples,
                                       device=True)
        sched = _Recorder(RS())
        engines = {}

        def engine_for(st):
            return engines.setdefault(id(st), RefEngine(egress_fd=tx))
        pacer = ref_session.VodPacerGroup(
            cache, engine_for=engine_for, scheduler=lambda: sched,
            lookahead_ms=250)
        out_cls = RefNativeOut
    else:
        f = open_shared(path)
        cache = SegmentCache(window_samples=window_samples, device="cpu")
        sched = _Recorder(MegabatchScheduler(device="cpu"))
        engines = {}

        def engine_for(st):
            return engines.setdefault(id(st), FanoutEngine(egress_fd=tx,
                                                           device="cpu"))
        pacer = VodPacerGroup(cache, engine_for=engine_for,
                              scheduler=lambda: sched, lookahead_ms=250)
        out_cls = NativeOut
    cache.fill_now(f, 1, f.video_track(), 0)
    t0 = 1_000_000
    for k in range(4):
        o = out_cls(ssrc=0x7000 + 17 * k, out_seq_start=31 * k + 1000)
        o.native_addr = ("127.0.0.1", 9 + k)
        pacer.open(f, {1: o}, speed=1.0, now_ms=t0)
    pacer.tick(t0)
    stats = (pacer.device_primes, pacer.prime_failures)
    rows = next(iter(cache._lru.values())).staged.shape[0]
    pacer.close()
    cache.close()
    f.close()
    return sched.installed, stats, rows


@pytest.mark.parametrize("spec,rows", [
    # 64 samples of ~23 packets: 1,452 packets, padded to 2,048 rows
    (ClipSpec(frames=64, fps=30, gop=32, idr_bytes=40_000, p_bytes=30_000),
     2048),
    # 64 samples of 290 single-NAL packets: 18,563 packets, padded to
    # 32,768 rows, past the 16,384 one launch takes at 100 B a row
    (None, 32768),
], ids=["2048_rows", "32768_rows"])
def test_prime_joined_installs_the_reference_segments(tmp_path, spec, rows):
    if not native.available():
        pytest.skip("the egress core does not build here")
    path = str(tmp_path / "p.mp4")
    if spec is not None:
        write_clip(path, spec, seed=3)
    else:
        _write_many_nal_clip(path)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        got, got_stats, got_rows = _prime_once(path, 64, ref=False,
                                               tx=tx.fileno())
        want, want_stats, want_rows = _prime_once(path, 64, ref=True,
                                                  tx=tx.fileno())
    finally:
        tx.close()
    assert got_rows == want_rows == rows
    assert got_stats == want_stats == (4, 0)
    assert len(got) == len(want) == 4
    for (k, seg), (rk, rseg) in zip(got, want):
        assert k == rk
        for a, b in zip(seg[:4], rseg[:4]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert seg[4] == rseg[4]


def _write_many_nal_clip(path):
    """64 samples, each 290 NAL units of 1,000 bytes (one RTP packet
    each), an IDR sample first."""
    from easydarwin_tpu_torch.utils.vod_clips import PPS, SPS
    from easydarwin_tpu_torch.vod.mp4_writer import Mp4Writer
    rng = np.random.default_rng(9)
    w = Mp4Writer(path)
    v = w.add_h264_track(SPS, PPS, 640, 480)
    for i in range(64):
        head = 0x65 if i == 0 else 0x41
        nals = rng.integers(0, 256, (290, 1000), dtype=np.uint8)
        nals[:, 0] = head
        sample = b"".join((1000).to_bytes(4, "big") + n.tobytes()
                          for n in nals)
        w.write_sample(v, sample, 3000, sync=i == 0)
    w.close()


def test_vod_streams_ride_the_megabatch_with_the_device_prime(clip):
    """Warm cache + 4 native subscribers of the video track: every join's
    params come from the device prime over the resident window (one
    upload per window), installed through the scheduler's oracle; the
    wakes coalesce the VOD streams; every datagram equals the cold
    path's."""
    if not native.available():
        pytest.skip("the egress core does not build here")
    f = open_shared(clip)
    cache = SegmentCache(window_samples=16, device="cpu")
    assert cache.warm_asset(f) > 0
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    engines = {}

    def engine_for(st):
        return engines.setdefault(id(st), FanoutEngine(egress_fd=tx.fileno(),
                                                       device="cpu"))

    sched = MegabatchScheduler(device="cpu")
    pacer = VodPacerGroup(cache, engine_for=engine_for,
                          engine_drop=lambda s: engines.pop(id(s), None),
                          scheduler=lambda: sched, lookahead_ms=250)
    rxs = [_rx() for _ in range(4)]
    sessions = []
    for k, rx in enumerate(rxs):
        o = NativeOut(ssrc=0x7000 + k, out_seq_start=31 * k + 1)
        o.native_addr = rx.getsockname()
        sessions.append(pacer.open(f, {1: o}, speed=2000.0,
                                   now_ms=int(time.monotonic() * 1000)))
    deadline = time.time() + 20
    while any(not s.done for s in sessions) and time.time() < deadline:
        t = int(time.monotonic() * 1000)
        pairs = pacer.tick(t)
        if len(pairs) >= 2:
            sched.begin_wake(pairs, t)
        for st, e in pairs:
            e.megabatch_owned = len(pairs) >= 2
            e.step(st, t)
        if len(pairs) >= 2:
            sched.end_wake(pairs, t)
        time.sleep(0.001)
    sched.drain()
    assert all(s.done for s in sessions)
    time.sleep(0.05)
    got = [_drain(rx) for rx in rxs]
    for k, rx in enumerate(rxs):
        cold_rx = _rx()
        out = UdpOut(tx, cold_rx.getsockname(), ssrc=0x7000 + k,
                     out_seq_start=31 * k + 1)
        asyncio.run(FileSession(f, {1: out}, speed=2000.0).run())
        time.sleep(0.05)
        assert got[k] == _drain(cold_rx)
        cold_rx.close()
        rx.close()
    assert pacer.device_primes == 4 and pacer.prime_failures == 0
    assert 1 <= cache.stats()["device_uploads"] <= 2
    assert sched.mismatches == 0 and sched.streams_coalesced > 0
    assert pacer.hot_pkts > 0 and pacer.cold_pkts == 0
    tx.close()
    pacer.close()
    cache.close()
    f.close()


def test_a_window_is_uploaded_once(clip):
    """One upload per window, however the device is spelled (a card's
    rows land on ``cuda:0`` for a cache made with ``"cuda"``), counted
    into the byte budget once and dropped with the window."""
    f = open_shared(clip)
    cache = SegmentCache(window_samples=16, device="cpu")
    w = cache.fill_now(f, 1, f.video_track(), 0)
    before = cache.bytes
    rows = w.device_rows(torch.device("cpu"))
    assert w.device_rows("cpu") is rows and w.device_uploads == 1
    assert torch.equal(rows, torch.from_numpy(w.staged))
    assert cache.bytes == before + w.staged.nbytes
    assert cache.stats()["device_bytes"] == w.staged.nbytes
    cache.close()
    assert w._device is None
    f.close()


def test_a_window_upload_error_raises_out_of_the_tick(clip, monkeypatch):
    """No quiet fallback: a failed upload in ``device_rows`` leaves the
    pacer's tick with the error, where the server counts it."""
    f = open_shared(clip)
    cache = SegmentCache(window_samples=16, device="cpu")
    cache.warm_asset(f)
    eng = FanoutEngine(egress_fd=0, device="cpu")
    monkeypatch.setattr(eng, "_native_ok", lambda: True)
    pacer = VodPacerGroup(cache, engine_for=lambda st: eng,
                          scheduler=lambda: MegabatchScheduler(device="cpu"))
    o = NativeOut(ssrc=1, out_seq_start=1)
    o.native_addr = ("127.0.0.1", 9)
    pacer.open(f, {1: o}, now_ms=1000)

    def fail(self, device):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(type(next(iter(cache._lru.values()))),
                        "device_rows", fail)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        pacer.tick(1000)
    assert pacer.device_primes == 0
    pacer.close()
    cache.close()
    f.close()


# ----------------------------------------------------- cache LRU/checkpoint

def _cache_trace(cache_cls, open_fn, path, **kw):
    """The reference suite's pinned LRU scenario, as (event, key) facts."""
    f = open_fn(path)
    tr = f.video_track()
    cache = cache_cls(budget_bytes=1, window_samples=4, **kw)
    facts = []
    w0 = cache.fill_now(f, 1, tr, 0)
    facts.append(cache._lru.get(w0.key) is w0)   # just-filled never thrashed
    cache.pin(w0)
    w1 = cache.fill_now(f, 1, tr, 1)
    w2 = cache.fill_now(f, 1, tr, 2)             # only w1 is evictable
    facts += [w1.key not in cache._lru, cache._lru.get(w0.key) is w0,
              cache._lru.get(w2.key) is w2, cache.evictions]
    cache.unpin(w0)                              # unpin re-runs the scan
    facts.append(w0.key not in cache._lru)
    facts.append(cache.get(f, 1, tr, 3, background_fill=False) is None)
    w3 = cache.fill_now(f, 1, tr, 3)
    facts += [cache.get(f, 1, tr, 3) is w3, cache.hits, cache.misses,
              cache.evictions, [k[2] for k in cache._lru]]
    cache.close()
    f.close()
    return facts


def test_cache_lru_budget_and_pinning_equal_the_reference(clip):
    got = _cache_trace(SegmentCache, open_shared, clip, device="cpu")
    want = _cache_trace(ref_cache.SegmentCache, ref_open_shared, clip,
                        device=False)
    assert got == want
    assert got[:4] == [True, True, True, True] and got[5:7] == [True, True]


def test_cache_checkpoint_metadata_roundtrip(clip):
    f = open_shared(clip)
    tr = tracks_by_no(f)[1]
    cache = SegmentCache(window_samples=8, device="cpu")
    cache.fill_now(f, 1, tr, 0)
    cache.fill_now(f, 1, tr, 1)
    snap = cache.snapshot()
    rcache = ref_cache.SegmentCache(window_samples=8, device=False)
    rf = ref_open_shared(clip)
    rcache.fill_now(rf, 1, rf.video_track(), 0)
    rcache.fill_now(rf, 1, rf.video_track(), 1)
    assert snap == rcache.snapshot()
    assert snap["version"] == 1 and len(snap["windows"]) == 2
    fresh = SegmentCache(window_samples=8, device="cpu")
    assert fresh.restore(snap) == 2
    assert fresh.note_open(f) == 2       # background re-packs
    deadline = time.time() + 5
    while fresh.stats()["windows"] < 2 and time.time() < deadline:
        time.sleep(0.02)
    assert fresh.stats()["windows"] == 2
    assert fresh.restore({"version": 99}) == 0
    assert fresh.restore({"version": 1, "windows": [{"bad": 1}]}) == 0
    for c in (cache, rcache, fresh):
        c.close()
    f.close()
    rf.close()


def test_segment_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegmentCache()
