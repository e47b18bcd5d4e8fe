"""The port's host egress core (``csrc/egress_core.cpp``) on real sockets.

The library builds with ``g++`` and loads here.  Every rung's bytes are
held against the reference's scalar relay (``RelayStream.reflect`` of the
JAX package, on the same ring):

* ``fanout_send_multi`` over loopback UDP — the plain ``sendmmsg`` rung
  and UDP GSO where the kernel grants it;
* ``stream_send`` over a ``socketpair`` — ``$``-framed interleaved bytes;
* with ``fault_set`` EAGAIN (and ENOBUFS), replaying from the bookmark the
  call reports gives the identical stream with no duplicates;
* ``stage_gather`` equals the numpy gather.
"""

import errno
import socket

import numpy as np
import pytest

from easydarwin_tpu.protocol import sdp as ref_sdp
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.relay.stream import RelayStream as RefStream
from easydarwin_tpu.relay.stream import StreamSettings as RefSettings
from easydarwin_tpu_torch import native
from easydarwin_tpu_torch.ops import staging
from easydarwin_tpu_torch.protocol.rtsp import frame_interleaved
from easydarwin_tpu_torch.relay.ring import PacketRing
from easydarwin_tpu_torch.utils import synth

SDP = ("v=0\r\nm=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
       "a=control:trackID=1\r\n")


@pytest.fixture(autouse=True)
def _no_faults():
    assert native.available(), native.load_error
    native.fault_clear()
    yield
    native.fault_clear()


def _oracle(seed: int, n_subs: int, n_pkts: int = 60, gop: int = 20):
    """The reference stream after one scalar reflect: its ring, each
    subscriber's delivered packets, its affine params and its op list
    (every non-runt slot from the fast-start point, subscriber-major)."""
    rng = np.random.default_rng(seed)
    st = RefStream(ref_sdp.parse(SDP).streams[0],
                   RefSettings(bucket_size=1 << 10, bucket_delay_ms=0))
    t = 1000
    for i in range(n_pkts):
        if i % 13 == 6:
            st.push_rtp(b"\x80\x60\x01", t)                     # runt
            continue
        body = rng.integers(0, 256, int(rng.integers(10, 1300)),
                            dtype=np.uint8).tobytes()
        st.push_rtp(synth.h264_packet(0xFFF0 + i, 0xFFFFFF00 + 3000 * i,
                                      5 if i % gop == 0 else 1, ssrc=0x5EED,
                                      body=body, marker=i % 4 == 3), t)
    outs = [RefOutput(ssrc=int(rng.integers(1 << 32)),
                      out_seq_start=int(rng.integers(1 << 16)),
                      out_ts_start=int(rng.integers(1 << 32)))
            for _ in range(n_subs)]
    for o in outs:
        st.add_output(o)
    ring = st.rtp_ring
    start = st.first_packet_for_new_output(t + 100)
    st.reflect(t + 100)
    slots = [pid % ring.capacity for pid in range(start, ring.head)
             if ring.length[pid % ring.capacity] >= 12]
    ops = np.array([[s, k] for k in range(n_subs) for s in slots], np.int32)
    rw = [o.rewrite for o in outs]
    seq_off = np.array([[(r.out_seq_start - r.base_src_seq) & 0xFFFF
                         for r in rw]], np.uint32)
    ts_off = np.array([[(r.out_ts_start - r.base_src_ts) & 0xFFFFFFFF
                        for r in rw]], np.uint32)
    ssrc = np.array([[r.ssrc for r in rw]], np.uint32)
    return ring, [o.rtp_packets for o in outs], (seq_off, ts_off, ssrc), ops


def _receivers(n):
    socks = []
    for _ in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 21)
        s.bind(("127.0.0.1", 0))
        s.setblocking(False)
        socks.append(s)
    return socks


def _drain(sock):
    got = []
    while True:
        try:
            got.append(sock.recv(65536))
        except BlockingIOError:
            return got


@pytest.mark.parametrize("rung", [native.SEND_PLAIN, native.SEND_GSO])
def test_fanout_send_multi_equals_reference_reflect(rung):
    ring, want, (seq_off, ts_off, ssrc), ops = _oracle(1 + rung, 5)
    rx = _receivers(5)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)
    try:
        dests = native.make_dests([s.getsockname() for s in rx])
        native.reset_stats()
        r = native.fanout_send_multi(tx.fileno(), ring.data, ring.length,
                                     seq_off, ts_off, ssrc, dests,
                                     native.ops_from_numpy(ops), len(ops),
                                     use_gso=rung)
        if rung == native.SEND_GSO and r < 0:
            # no UDP GSO in this kernel: the capability answer the engine
            # takes as a strike, and nothing went out
            assert -r in (errno.EINVAL, errno.EOPNOTSUPP)
            assert all(not _drain(s) for s in rx)
            return
        assert r == len(ops), native.last_send_errno()
        for s, w in zip(rx, want):
            assert _drain(s) == w
        stats = native.get_stats()
        assert stats["send_packets"] == len(ops)
        assert stats["sendmmsg_calls"] > 0
        if rung == native.SEND_GSO:
            assert stats["gso_supers"] > 0
    finally:
        tx.close()
        for s in rx:
            s.close()


@pytest.mark.parametrize("rung,eagain_every", [
    (native.SEND_PLAIN, 2), (native.SEND_PLAIN, 3), (native.SEND_GSO, 2)])
def test_udp_eagain_replay_from_bookmark_has_no_duplicates(rung,
                                                           eagain_every):
    ring, want, (seq_off, ts_off, ssrc), ops = _oracle(7, 3, 400, gop=400)
    rx = _receivers(3)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        dests = native.make_dests([s.getsockname() for s in rx])
        native.fault_set(eagain_every, 0)
        done, calls = 0, 0
        while done < len(ops):
            rest = np.ascontiguousarray(ops[done:])
            r = native.fanout_send_multi(
                tx.fileno(), ring.data, ring.length, seq_off, ts_off, ssrc,
                dests, native.ops_from_numpy(rest), len(rest), use_gso=rung)
            assert r >= 0
            if r < len(rest):
                assert native.last_send_errno() == errno.EAGAIN
            done += r
            calls += 1
        assert calls > 1
        for s, w in zip(rx, want):
            assert _drain(s) == w
        assert native.get_stats()["fault_injections"] > 0
    finally:
        tx.close()
        for s in rx:
            s.close()


def test_udp_hard_error_reports_what_was_delivered():
    ring, want, (seq_off, ts_off, ssrc), ops = _oracle(8, 2)
    rx = _receivers(2)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        dests = native.make_dests([s.getsockname() for s in rx])
        native.fault_set(0, 1)                       # the first call: ENOBUFS
        r = native.fanout_send_multi(
            tx.fileno(), ring.data, ring.length, seq_off, ts_off, ssrc,
            dests, native.ops_from_numpy(ops), len(ops),
            use_gso=native.SEND_PLAIN)
        assert r == -errno.ENOBUFS
        assert native.last_send_errno() == errno.ENOBUFS
        assert all(not _drain(s) for s in rx)
    finally:
        tx.close()
        for s in rx:
            s.close()


def _stream_expected(want, chan):
    return b"".join(frame_interleaved(chan, p) for p in want)


def _read_all(sock, n):
    buf = bytearray()
    sock.settimeout(5)
    while len(buf) < n:
        chunk = sock.recv(1 << 20)
        if not chunk:
            break
        buf += chunk
    return bytes(buf)


def test_stream_send_equals_reference_framed_bytes():
    ring, want, (seq_off, ts_off, ssrc), ops = _oracle(11, 1)
    slots = ops[:, 0]
    a, b = socket.socketpair()
    try:
        a.setblocking(False)
        r, partial = native.stream_send(a.fileno(), ring.data, ring.length,
                                        int(seq_off[0, 0]), int(ts_off[0, 0]),
                                        int(ssrc[0, 0]), 4, slots)
        assert (r, partial) == (len(slots), 0)
        exp = _stream_expected(want[0], 4)
        assert _read_all(b, len(exp)) == exp
    finally:
        a.close()
        b.close()


def test_stream_eagain_and_short_writes_replay_without_duplicates():
    """EAGAIN injected every other call and a send buffer too small for a
    batch: each call resumes at the bookmark it reported, and a torn
    packet's remainder is written before anything else."""
    ring, want, (seq_off, ts_off, ssrc), ops = _oracle(12, 1, 200, gop=200)
    slots = ops[:, 0]
    exp = _stream_expected(want[0], 2)
    a, b = socket.socketpair()
    got = bytearray()

    def drain():
        while True:
            try:
                chunk = b.recv(1 << 20)
            except BlockingIOError:
                return
            got.extend(chunk)

    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        a.setblocking(False)
        b.setblocking(False)
        native.fault_set(2, 0)
        bm, calls, torn = 0, 0, 0
        while bm < len(slots):
            r, partial = native.stream_send(
                a.fileno(), ring.data, ring.length, int(seq_off[0, 0]),
                int(ts_off[0, 0]), int(ssrc[0, 0]), 2, slots[bm:])
            calls += 1
            assert r >= 0
            bm += r
            if partial:                        # finish the torn packet
                torn += 1
                rest = frame_interleaved(2, want[0][bm])[partial:]
                while rest:
                    try:
                        rest = rest[a.send(rest):]
                    except BlockingIOError:
                        drain()
                bm += 1
            drain()
        a.shutdown(socket.SHUT_WR)
        b.setblocking(True)
        got += _read_all(b, len(exp) - len(got))
        assert bytes(got) == exp
        assert calls > 2
        assert torn > 0
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("stride,count", [(100, 37), (104, 64), (100, 0)])
def test_stage_gather_equals_numpy(stride, count):
    rng = np.random.default_rng(stride + count)
    ring = PacketRing(64, is_video=True)
    for i in range(150):
        ring.push(synth.random_packet(rng), i)
    start = ring.head - count
    slots = (np.arange(start, start + count) % ring.capacity).astype(np.int32)
    out = np.full((64, stride), 0xAB, np.uint8)
    assert native.stage_gather(ring.data, ring.length, slots, 96, out) == count
    ref = np.zeros((64, stride), np.uint8)
    ref[:count, :96] = ring.data[slots, :96]
    ref[:count, 96:100] = np.ascontiguousarray(
        ring.length[slots], "<u4")[:, None].view(np.uint8)
    np.testing.assert_array_equal(out, ref)
    # the scheduler's gather takes the native walk once the library is
    # loaded, with the same bytes
    again = np.full((64, stride), 0xCD, np.uint8)
    assert staging.gather_window(ring, start, count, again) == count
    np.testing.assert_array_equal(again, ref)
    assert native.stage_gather(ring.data, ring.length,
                               np.array([64], np.int32), 96, out) < 0


def test_abi_and_argument_checks():
    assert native.loaded()
    assert set(native.get_stats()) == set(native.STAT_FIELDS)
    with pytest.raises(ValueError):
        native.ops_from_numpy(np.zeros((3, 2), np.int64))
    with pytest.raises(ValueError):
        native.fanout_send_multi(-1, np.zeros((4, 8), np.int8),
                                 np.zeros(4, np.int32), *[np.zeros((1, 1))] * 3,
                                 native.make_dests([("127.0.0.1", 9)]),
                                 None, 0)
