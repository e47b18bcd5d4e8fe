"""The port's relay tier ≡ the JAX package's host oracle.

* the port's packet ring classifies and stores exactly what the
  reference ring does;
* the megabatch scheduler installs exactly ``host_affine_params``;
* the fan-out engine, fed by the scheduler, writes the same wire bytes
  as the reference's scalar ``RelayStream.reflect`` on state carried over
  with ``convert.py`` (stalls, runts, bucket delays and a late joiner
  included);
* on real sockets, a stream of UDP (native scatter), interleaved TCP
  (native framed writev) and collecting outputs delivers the reference's
  bytes, megabatch-owned and through the per-stream ring query, and a
  torn TCP write is completed through ``push_tail``;
* meta-info and thinned outputs take only the batch-header rung: never
  staged for the device params, never sent by the native UDP or TCP
  rung, and an output thinned and thickened mid-stream keeps its
  bookmark and the reference's bytes across the moves.
"""

import socket
import time

import numpy as np
import pytest
import torch

from easydarwin_tpu.protocol import sdp as ref_sdp
from easydarwin_tpu.relay import megabatch as ref_megabatch
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.relay.ring import PacketRing as RefRing
from easydarwin_tpu.relay.stream import RelayStream as RefStream
from easydarwin_tpu.relay.stream import StreamSettings as RefSettings
from easydarwin_tpu_torch import convert, native, resolve_device
from easydarwin_tpu_torch.models.relay_pipeline import RelayPipeline
from easydarwin_tpu_torch.ops import device_ring
from easydarwin_tpu_torch.protocol import sdp
from easydarwin_tpu_torch.relay import megabatch
from easydarwin_tpu_torch.relay.fanout import (FanoutEngine,
                                               host_affine_params, params_key)
from easydarwin_tpu_torch.relay.megabatch import MegabatchScheduler
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.relay.ring import PacketRing
from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
from easydarwin_tpu_torch.server import StreamingServer
from easydarwin_tpu_torch.server.transports import (InterleavedOutput,
                                                    SharedUdpEgress, UdpOutput)
from easydarwin_tpu_torch.utils import synth

SDP = ("v=0\r\nm=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
       "a=control:trackID=1\r\n")


def _packets(rng, n, seq0=65500, ts0=0xFFFFF000):
    """Paced H.264 with an IDR run every 30 packets and a runt every 17."""
    out = []
    for i in range(n):
        if i % 17 == 9:
            out.append(b"\x80\x60\x00")                       # runt
            continue
        body = rng.integers(0, 256, int(rng.integers(8, 200)),
                            dtype=np.uint8).tobytes()
        out.append(synth.h264_packet(seq0 + i, ts0 + 3000 * (i // 3),
                                     5 if i % 30 < 3 else 1, ssrc=0xABC,
                                     body=body, marker=i % 3 == 2))
    return out


@pytest.mark.parametrize("codec", [None, "JPEG"])
def test_ring_push_matches_reference_ring(codec):
    rng = np.random.default_rng(6)
    ref = RefRing(32, is_video=True, codec=codec)
    port = PacketRing(32, is_video=True, codec=codec)
    pkts = _packets(rng, 70) + [bytes(2100)]                  # oversize drop
    pkts += [synth.random_packet(rng) for _ in range(20)]
    for i, p in enumerate(pkts):
        assert port.push(p, 10 * i) == ref.push(p, 10 * i)
    for name in ("data", "length", "arrival", "flags", "seq", "timestamp",
                 "ssrc"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)
    assert (port.head, port.tail, port.total_dropped, port.total_oversize) == \
        (ref.head, ref.tail, ref.total_dropped, ref.total_oversize)
    assert port.evict_older_than(700, 200, pin_id=port.head - 5) == \
        ref.evict_older_than(700, 200, pin_id=ref.head - 5)
    ids_p, len_p, fl_p = port.window_meta(port.tail, 9)
    ids_r, len_r, fl_r = ref.window_meta(ref.tail, 9)
    for a, b in ((ids_p, ids_r), (len_p, len_r), (fl_p, fl_r)):
        np.testing.assert_array_equal(a, b)


def test_convert_validates_and_copies():
    st = np.arange(2 * 3 * 6, dtype=np.uint32).reshape(2, 3, 6)
    t = convert.state_from_numpy(st, "cpu")
    assert t.dtype == torch.uint32 and t.numpy().tolist() == st.tolist()
    st[0, 0, 0] = 99
    assert int(t[0, 0, 0]) == 0                        # a copy, not a view
    with pytest.raises(TypeError):
        convert.state_from_numpy(st.astype(np.int64), "cpu")
    with pytest.raises(ValueError):
        convert.state_from_numpy(np.zeros((3, 5), np.uint32), "cpu")
    ref = RefRing(8, is_video=True)
    with pytest.raises(ValueError):
        convert.ring_from_arrays(ref.data, ref.length, ref.arrival, ref.seq,
                                 ref.timestamp, ref.flags, 3, 5, 8)


def test_host_affine_oracle_matches_reference():
    rng = np.random.default_rng(12)
    for _ in range(20):
        key = tuple((int(rng.integers(1 << 32)),
                     int(rng.choice([-1, int(rng.integers(1 << 16))])),
                     int(rng.choice([-1, int(rng.integers(1 << 32))])),
                     int(rng.integers(1 << 16)), int(rng.integers(1 << 32)),
                     int(rng.choice([-1, 0, 2])))
                    for _ in range(int(rng.integers(1, 9))))
        for a, b in zip(host_affine_params(key),
                        ref_megabatch._host_affine_params(key)):
            np.testing.assert_array_equal(a, b)


def _twin_streams(n_out=10, seed=31):
    """A reference stream with history, and the port stream carried over
    from its arrays; outputs with identical rewrite state on both."""
    rng = np.random.default_rng(seed)
    settings = dict(bucket_size=4, bucket_delay_ms=10)
    ref = RefStream(ref_sdp.parse(SDP).streams[0], RefSettings(**settings))
    pkts = _packets(rng, 400)
    t = 1000
    for p in pkts[:40]:
        ref.push_rtp(p, t)
        t += 4
    r = ref.rtp_ring
    ring = convert.ring_from_arrays(r.data, r.length, r.arrival, r.seq,
                                    r.timestamp, r.flags, r.head, r.tail,
                                    r.capacity)
    port = RelayStream(sdp.parse(SDP).streams[0], StreamSettings(**settings),
                       rtp_ring=ring)
    port.keyframe_id = ref.keyframe_id
    port._kf_run_active = ref._kf_run_active
    kws = [dict(ssrc=int(rng.integers(1 << 32)),
                out_seq_start=int(rng.integers(1 << 16)),
                out_ts_start=int(rng.integers(1 << 32)))
           for _ in range(n_out + 2)]
    for k in kws[:n_out]:
        ref.add_output(RefOutput(**k))
        port.add_output(CollectingOutput(**k))
    return ref, port, pkts[40:], kws[n_out:], t


def test_engine_wire_bytes_match_reference_scalar_reflect():
    ref, port, more, late, t = _twin_streams()
    eng = FanoutEngine()
    sched = MegabatchScheduler(device="cpu")
    pairs = [(port, eng)]
    for wake in range(14):
        for p in more[wake * 9:(wake + 1) * 9]:
            ref.push_rtp(p, t)
            port.push_rtp(p, t)
        if wake == 4:                          # a stall: replay next wake
            ref.outputs[1].block_next = port.outputs[1].block_next = 1
        if wake == 6:                          # a late joiner
            ref.add_output(RefOutput(**late[0]))
            port.add_output(CollectingOutput(**late[0]))
        if wake == 9:                          # a leaver
            ref.remove_output(ref.outputs[3])
            port.remove_output(port.outputs[3])
        sched.begin_wake(pairs, t)
        eng.step(port, t)
        sched.end_wake(pairs, t)
        ref.reflect(t)
        for a, b in zip(port.outputs, ref.outputs):
            assert a.rtp_packets == b.rtp_packets, wake
            assert (a.bookmark, a.packets_sent, a.bytes_sent,
                    a.payload_octets, a.stalls) == \
                (b.bookmark, b.packets_sent, b.bytes_sent, b.payload_octets,
                 b.stalls), wake
        t += 20
    assert sum(len(o.rtp_packets) for o in port.outputs) > 500
    assert sched.mismatches == 0 and eng.missing_params == 0
    assert port.stats.stalls == ref.stats.stalls == 1
    assert sched.prime_passes >= 2 and sched.harvests > 0


def test_scheduler_installs_exactly_the_host_oracle():
    streams, engines = [], []
    rng = np.random.default_rng(2)
    for i, n_out in enumerate((3, 9, 20)):     # three subscriber buckets
        st = RelayStream(sdp.parse(SDP).streams[0])
        for p in _packets(rng, 25 + 10 * i, seq0=i * 1000):
            st.push_rtp(p, 500)
        for _ in range(n_out):
            st.add_output(CollectingOutput(
                ssrc=int(rng.integers(1 << 32)),
                out_seq_start=int(rng.integers(1 << 16)),
                out_ts_start=int(rng.integers(1 << 32))))
        streams.append(st)
        engines.append(FanoutEngine())
    sched = MegabatchScheduler(device="cpu")
    pairs = list(zip(streams, engines))
    extra = _packets(rng, 6, seq0=9000)
    for wake in range(3):
        for st in streams:                     # fresh packets every wake
            for p in extra[2 * wake:2 * wake + 2]:
                st.push_rtp(p, 1000 + wake)
        sched.begin_wake(pairs, 1000 + wake)
        for st, eng in pairs:
            key = params_key(eng.fast_outputs(st))
            assert eng.megabatch_params[0] == key
            for a, b in zip(eng.megabatch_params[1],
                            ref_megabatch._host_affine_params(key)):
                np.testing.assert_array_equal(a[0], b)
            eng.step(st, 1000 + wake)
        sched.end_wake(pairs, 1000 + wake)
    assert sched.drain() == 3 and sched.mismatches == 0


def test_one_window_call_per_wake_over_many_buckets():
    """Four (window, subscriber) buckets a wake and primes over two
    subscriber buckets, each one window call; wire bytes, installs and the
    oracle as the reference has them."""
    rng = np.random.default_rng(44)
    settings = dict(bucket_size=4, bucket_delay_ms=10)
    n_outs = (3, 5, 12, 12)            # s_pad 8, 8, 16, 16
    bursts = (5, 20, 5, 40)            # p_pad 16, 32, 16, 64
    kws = [[dict(ssrc=int(rng.integers(1 << 32)),
                 out_seq_start=int(rng.integers(1 << 16)),
                 out_ts_start=int(rng.integers(1 << 32)))
            for _ in range(n + 1)] for n in n_outs]
    refs = [RefStream(ref_sdp.parse(SDP).streams[0], RefSettings(**settings))
            for _ in n_outs]
    ports = [RelayStream(sdp.parse(SDP).streams[0], StreamSettings(**settings))
             for _ in n_outs]
    for ref, port, kw, n in zip(refs, ports, kws, n_outs):
        for k in kw[:n]:
            ref.add_output(RefOutput(**k))
            port.add_output(CollectingOutput(**k))
    feeds = [_packets(rng, 6 * b, seq0=1000 * i) for i, b in enumerate(bursts)]
    engines = [FanoutEngine() for _ in n_outs]
    sched = MegabatchScheduler(device="cpu")
    pairs = list(zip(ports, engines))
    t, delivered, prime_buckets = 1000, 0, []
    for wake in range(6):
        for ref, port, feed, b in zip(refs, ports, feeds, bursts):
            for p in feed[wake * b:(wake + 1) * b]:
                ref.push_rtp(p, t)
                port.push_rtp(p, t)
        if wake == 3:                  # late joiners in both s_pad buckets
            for i in (0, 2):
                refs[i].add_output(RefOutput(**kws[i][-1]))
                ports[i].add_output(CollectingOutput(**kws[i][-1]))
        calls, primes = sched.window_calls, sched.prime_passes
        sched.begin_wake(pairs, t)
        prime_buckets.append(sched.prime_passes - primes)
        assert sched.window_calls - calls == (prime_buckets[-1] > 0)
        for port, eng in pairs:
            key = params_key(eng.fast_outputs(port))
            assert eng.megabatch_params[0] == key
            for a, b in zip(eng.megabatch_params[1],
                            ref_megabatch._host_affine_params(key)):
                np.testing.assert_array_equal(a[0], b)
            eng.step(port, t)
        calls, passes = sched.window_calls, sched.passes
        sched.end_wake(pairs, t)
        assert sched.window_calls - calls == 1
        assert sched.passes - passes == 4          # four buckets, one call
        for ref, port in zip(refs, ports):
            ref.reflect(t)
            for a, b in zip(port.outputs, ref.outputs):
                assert a.rtp_packets == b.rtp_packets, wake
                delivered += len(a.rtp_packets)
        t += 20
    sched.drain()
    # primes: the joins of wake 0, the rebase latched by wake 0's first
    # sends, the late joiners of wake 3 — each over both s_pad buckets
    assert prime_buckets == [2, 2, 0, 2, 0, 0]
    assert sched.stats()["window_calls"] == 6 + 3
    assert delivered > 300
    assert sched.mismatches == 0
    assert all(e.missing_params == 0 for e in engines)


def test_scheduler_discards_a_segment_that_disagrees_with_the_oracle(
        monkeypatch):
    _ref, port, _more, _late, t = _twin_streams(n_out=4)
    eng = FanoutEngine(device="cpu")
    sched = MegabatchScheduler(device="cpu")
    real = megabatch.megabatch_window_steps
    real_query = device_ring.query_params

    def corrupt(pairs):
        outs = [o.clone() for o in real(pairs)]
        outs[0][0, 0] = outs[0][0, 0] ^ 1      # flip one seq_off bit
        return outs

    def corrupt_query(state, out_state):
        out = real_query(state, out_state).clone()
        out[0] = out[0] ^ 1
        return out

    monkeypatch.setattr(megabatch, "megabatch_window_steps", corrupt)
    # the engine's fallback, its own ring query, disagrees the same way
    monkeypatch.setattr(device_ring, "query_params", corrupt_query)
    sched.begin_wake([(port, eng)], t)
    assert sched.mismatches == 1 and eng.megabatch_params is None
    before = [o.bookmark for o in port.outputs]
    assert eng.step(port, t) == 0              # no params: nothing sent
    assert [o.bookmark for o in port.outputs] == before
    assert eng.missing_params == 1
    assert all(not o.rtp_packets for o in port.outputs)


def test_staging_buffer_returns_to_the_pool_only_at_harvest():
    _ref, port, more, _late, t = _twin_streams(n_out=2)
    eng = FanoutEngine()
    sched = MegabatchScheduler(device="cpu")
    pairs = [(port, eng)]
    sched.begin_wake(pairs, t)
    eng.step(port, t)
    sched.end_wake(pairs, t)
    (inf,) = sched._inflight
    (buf,) = inf.buf                           # one shard: one device
    assert all(buf is not b for pool in sched._free.values() for b in pool)
    port.push_rtp(more[0], t + 5)
    sched.begin_wake(pairs, t + 5)             # harvest recycles it
    assert not sched._inflight
    assert any(buf is b for pool in sched._free.values() for b in pool)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    for make in (resolve_device, MegabatchScheduler, RelayPipeline,
                 StreamingServer,
                 lambda: convert.state_from_numpy(np.zeros((1, 6), np.uint32))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(ValueError):
        resolve_device("mps")


class _Transport:
    """The slice of an asyncio write transport an interleaved output uses:
    a write goes straight to the socket while nothing is buffered, the
    rest waits for ``flush`` (the event loop's job)."""

    def __init__(self, sock):
        self.sock = sock
        self.buf = bytearray()

    def get_extra_info(self, name):
        return self.sock if name == "socket" else None

    def is_closing(self) -> bool:
        return False

    def get_write_buffer_size(self) -> int:
        return len(self.buf)

    def write(self, data) -> None:
        self.buf += data
        self.flush()

    def flush(self) -> None:
        while self.buf:
            try:
                n = self.sock.send(self.buf)
            except BlockingIOError:
                return
            del self.buf[:n]


class _TornCountingOutput(InterleavedOutput):
    tails = 0

    def push_tail(self, data: bytes) -> bool:
        self.tails += 1
        return super().push_tail(data)


def _tcp_pair(bufsize: int):
    """A loopback TCP connection (the kind a player's RTSP connection is):
    the writer's send and the reader's receive buffer set to ``bufsize``,
    the reader's before the handshake, so that the window it offers is
    that small from the first byte on."""
    with socket.socket() as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, bufsize)
        srv.bind(("127.0.0.1", 0))
        srv.listen()
        a = socket.create_connection(srv.getsockname())
        b, _ = srv.accept()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, bufsize)
    b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, bufsize)
    a.setblocking(False)
    b.setblocking(False)
    return a, b


def _recv_all(sock, into) -> None:
    while True:
        try:
            data = sock.recv(1 << 20)
        except BlockingIOError:
            return
        if isinstance(into, bytearray):
            into += data
        else:
            into.append(data)


def _deframe(buf: bytes) -> list[tuple[int, bytes]]:
    """``(channel, data)`` of each whole ``$``-framed chunk of ``buf``."""
    out, off = [], 0
    while off + 4 <= len(buf):
        assert buf[off] == 0x24, off
        n = int.from_bytes(buf[off + 2:off + 4], "big")
        if off + 4 + n > len(buf):
            break
        out.append((buf[off + 1], buf[off + 4:off + 4 + n]))
        off += 4 + n
    return out


class _MixedTwins:
    """A port stream of UDP, interleaved and collecting outputs on real
    sockets beside a reference stream of collecting outputs with the same
    rewrite state, fed the same packets."""

    def __init__(self, kinds, seed, *, sndbuf=1 << 21):
        self.rng = np.random.default_rng(seed)
        settings = dict(bucket_size=2, bucket_delay_ms=10)
        self.ref = RefStream(ref_sdp.parse(SDP).streams[0],
                             RefSettings(**settings))
        self.port = RelayStream(sdp.parse(SDP).streams[0],
                                StreamSettings(**settings))
        self.egress = SharedUdpEgress("127.0.0.1")
        self.egress.rtp_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.egress.rtp_sock.setblocking(False)
        self.sndbuf = sndbuf
        self.socks = []
        self.outs = []          # (kind, port output, ref output, sink)
        for kind in kinds:
            self.add(kind)

    def add(self, kind):
        kw = dict(ssrc=int(self.rng.integers(1 << 32)),
                  out_seq_start=int(self.rng.integers(1 << 16)),
                  out_ts_start=int(self.rng.integers(1 << 32)))
        if kind == "udp":
            rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
            rx.bind(("127.0.0.1", 0))
            rx.setblocking(False)
            self.socks.append(rx)
            out = UdpOutput(self.egress, "127.0.0.1", rx.getsockname()[1],
                            rx.getsockname()[1] + 1, **kw)
            sink = (rx, [])
        elif kind in ("tcp", "torn"):
            a, b = _tcp_pair(self.sndbuf)
            self.socks += [a, b]
            cls = _TornCountingOutput if kind == "torn" else InterleavedOutput
            out = cls(_Transport(a), 2 * len(self.outs), 2 * len(self.outs) + 1,
                      **kw)
            sink = (b, bytearray())
        else:
            out = CollectingOutput(**kw)
            sink = None
        ref_out = RefOutput(**kw)
        self.port.add_output(out)
        self.ref.add_output(ref_out)
        self.outs.append((kind, out, ref_out, sink))

    def remove(self, i):
        kind, out, ref_out, _sink = self.outs[i]
        self.port.remove_output(out)
        self.ref.remove_output(ref_out)

    def push(self, pkts, t):
        for p in pkts:
            self.ref.push_rtp(p, t)
            self.port.push_rtp(p, t)
        # one wall clock for both streams' SR NTP times
        self.port._wall_base = self.ref._wall_base

    def collect(self):
        for kind, out, _ref, sink in self.outs:
            if kind in ("tcp", "torn"):
                out.transport.flush()
            if sink is not None:
                _recv_all(*sink)

    def assert_same(self, wake, *, counters=True):
        for kind, out, ref_out, sink in self.outs:
            if kind == "udp":
                got, want = sink[1], ref_out.rtp_packets
            elif kind in ("tcp", "torn"):
                # the connection carries the output's SRs on its RTCP
                # channel between the RTP frames
                frames = _deframe(bytes(sink[1]))
                got = [d for ch, d in frames if ch == out.rtp_channel]
                want = ref_out.rtp_packets
                assert [d for ch, d in frames if ch == out.rtcp_channel] \
                    == ref_out.rtcp_packets, (wake, kind)
                assert len(frames) == len(want) + len(ref_out.rtcp_packets)
            else:
                got, want = out.rtp_packets, ref_out.rtp_packets
            assert got == want, (wake, kind)
            if counters:
                assert (out.bookmark, out.packets_sent,
                        out.payload_octets) == \
                    (ref_out.bookmark, ref_out.packets_sent,
                     ref_out.payload_octets), (wake, kind)
                # the engine counts a meta-info packet's RTP bytes, as the
                # reference's engine does; its scalar oracle the wrap's
                assert out.meta_field_ids is not None or \
                    out.bytes_sent == ref_out.bytes_sent, (wake, kind)

    def close(self):
        for s in self.socks:
            s.close()
        self.egress.rtp_sock.close()


@pytest.mark.parametrize("owned", [True, False],
                         ids=["megabatch", "per_stream_query"])
def test_mixed_udp_tcp_collecting_wire_bytes_match_reference(owned):
    tw = _MixedTwins(["udp", "tcp", "col", "udp", "tcp", "udp", "col"], 91)
    eng = FanoutEngine(egress_fd=tw.egress.fileno(), device="cpu")
    sched = MegabatchScheduler(device="cpu")
    pairs = [(tw.port, eng)]
    feed = _packets(tw.rng, 200)
    t = 1000
    try:
        tw.push(feed[:40], t)
        for wake in range(16):
            tw.push(feed[40 + wake * 9:40 + (wake + 1) * 9], t)
            if wake == 3:                      # a stall on a collecting one
                tw.outs[2][1].block_next = tw.outs[2][2].block_next = 1
            if wake == 5:                      # joiners of every kind
                for kind in ("udp", "tcp", "col"):
                    tw.add(kind)
            if wake == 9:                      # leavers
                tw.remove(0)
                tw.remove(4)
            if owned:
                sched.begin_wake(pairs, t)
            eng.step(tw.port, t)
            if owned:
                sched.end_wake(pairs, t)
            tw.ref.reflect(t)
            tw.collect()
            tw.assert_same(wake)
            t += 20
        assert eng.native_sent > 300 and eng.native_passes > 0
        assert eng.missing_params == 0 and eng.send_errors == 0
        assert tw.port.stats.stalls == tw.ref.stats.stalls == 1
        if owned:
            assert sched.mismatches == 0 and sched.installs > 0
        else:
            # one query per membership or rebase change, none in between
            assert 2 <= eng.device_param_refreshes <= 6
            assert eng.dring_appends == 16
            assert eng.last_newest_keyframe >= 0
    finally:
        tw.close()


@pytest.mark.parametrize("owned", [True, False],
                         ids=["megabatch", "per_stream_query"])
def test_meta_and_thinned_outputs_take_the_batch_header_rung(owned,
                                                             monkeypatch):
    """Meta-info and thinned UDP and interleaved outputs are never staged
    for the device params (the megabatch's state rows, the per-stream
    query) and never reach the native UDP scatter or TCP writev; a plain
    UDP output thinned mid-stream moves to the batch-header rung and,
    thickened again, back, with no packet twice and none skipped; every
    output's wire bytes equal the reference's scalar reflect."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)  # meta-info tt
    tw = _MixedTwins(["udp", "tcp", "udp", "tcp", "col", "udp"], 23)
    for i in (0, 3):                   # meta-info: UDP and interleaved
        for o in tw.outs[i][1:3]:
            o.meta_field_ids = {"tt": 0, "sq": 1, "md": -1}
    for i in (1, 2):                   # thinned: interleaved and UDP
        for o in tw.outs[i][1:3]:
            o.on_receiver_report(0.35)
    mover = tw.outs[5][1]
    eng = FanoutEngine(egress_fd=tw.egress.fileno(), device="cpu")
    sched = MegabatchScheduler(device="cpu")
    pairs = [(tw.port, eng)]
    seen = {"native": [], "query": [], "megabatch": []}

    def plain_only(where, outs):
        for o in outs:
            assert o.meta_field_ids is None and o.thinning.passthrough(), \
                where
        seen[where].extend(outs)

    def spy(where, real, pick):
        def call(*args):
            plain_only(where, pick(args))
            return real(*args)
        return call

    for name in ("_udp_scatter", "_tcp_scatter"):
        monkeypatch.setattr(eng, name, spy("native", getattr(eng, name),
                                           lambda a: [o for o, _ in a[1]]))
    monkeypatch.setattr(eng, "_device_params", spy(
        "query", eng._device_params, lambda a: a[0]))
    monkeypatch.setattr(megabatch, "pack_output_state", spy(
        "megabatch", megabatch.pack_output_state, lambda a: a[0]))
    feed = _packets(tw.rng, 260)
    t = 1000
    try:
        tw.push(feed[:40], t)
        for wake in range(22):
            tw.push(feed[40 + wake * 10:40 + (wake + 1) * 10], t)
            if wake == 6:
                for o in tw.outs[5][1:3]:
                    o.on_receiver_report(0.5)
            if wake == 9:
                native_before = seen["native"].count(mover)
            if wake == 14:
                for o in tw.outs[5][1:3]:
                    for _ in range(6):
                        o.on_receiver_report(0.0)
            if owned:
                sched.begin_wake(pairs, t)
            eng.step(tw.port, t)
            if owned:
                sched.end_wake(pairs, t)
            tw.ref.reflect(t)
            tw.collect()
            tw.assert_same(wake)
            if 6 < wake < 14:
                assert not mover.thinning.passthrough()
            t += 20
        assert seen["native"].count(mover) > native_before > 0
        assert mover.thinning.dropped > 0
        assert seen["megabatch" if owned else "query"]
        assert eng.batch_sent > 0 and eng.native_sent > 0
        assert all(len(tw.outs[i][3][1]) for i in (0, 2))  # UDP got them
        assert eng.missing_params == 0 and eng.send_errors == 0
        if owned:
            assert sched.mismatches == 0
    finally:
        tw.close()


def test_torn_tcp_write_is_completed_through_push_tail():
    """4 KB socket buffers and a reader that reads every twelfth wake:
    the native writev tears packets, their tails go through the transport,
    the output waits on the loop rung while the transport holds bytes, and
    the byte stream still equals the reference's.  The reader's window is
    small from the handshake on, so the first writes that outrun it tear
    within the first wakes; the tail of the stream is read for as long as
    bytes keep arriving, not for a wall-clock time."""
    tw = _MixedTwins(["torn", "udp"], 5, sndbuf=4096)
    eng = FanoutEngine(egress_fd=tw.egress.fileno(), device="cpu")
    feed = _packets(tw.rng, 1220)
    t = 1000
    kind, out, ref_out, (reader, got) = tw.outs[0]
    try:
        tw.push(feed[:20], t)
        for wake in range(40):
            tw.push(feed[20 + wake * 30:20 + (wake + 1) * 30], t)
            eng.step(tw.port, t)
            tw.ref.reflect(t)
            if wake % 12 == 11:
                out.transport.flush()
                _recv_all(reader, got)
                out.transport.flush()
            t += 20
        assert out.tails > 0
        # the tail of the stream: a small TCP window drains on the
        # kernel's clock, so the wakes go on while each brings bytes
        reader.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
        idle = 0
        while (len(got) < sum(4 + len(p) for p in ref_out.rtp_packets
                              + ref_out.rtcp_packets)
               and idle < 1000):
            before = len(got)
            eng.step(tw.port, t)
            tw.ref.reflect(t)
            tw.collect()
            t += 20
            idle = 0 if len(got) > before else idle + 1
            if idle:
                time.sleep(0.002)
        tw.assert_same("end", counters=False)
        assert out.bookmark == ref_out.bookmark
        assert out.packets_sent == ref_out.packets_sent
        assert eng.send_errors == 0 and eng.native_sent > 0
    finally:
        tw.close()


def _is_subsequence(got, want) -> bool:
    it = iter(want)
    return all(any(g == w for w in it) for g in got)


@pytest.mark.parametrize("gso,eagain_every,enobufs_every", [
    (True, 3, 0), (False, 7, 0), (False, 0, 5)],
    ids=["eagain_gso", "eagain_plain", "enobufs_plain"])
def test_udp_fault_bookmarks_replay_without_duplicates(gso, eagain_every,
                                                       enobufs_every):
    """EAGAIN holds each output's bookmark at its first unsent packet and
    the next wakes deliver the rest exactly once; a hard error (ENOBUFS)
    skips the failing output's rest for that pass, counted in
    ``send_errors``, and nothing is ever sent twice.  (Under GSO a hard
    stop is retried without GSO first, so the plain sendmmsg rung — an
    engine whose GSO strikes are spent — shows it.)"""
    tw = _MixedTwins(["udp"] * 6 + ["col"], 17)
    eng = FanoutEngine(egress_fd=tw.egress.fileno(), device="cpu")
    eng._gso_disabled = not gso
    feed = _packets(tw.rng, 220)
    t = 1000
    try:
        tw.push(feed[:40], t)
        native.fault_set(eagain_every, enobufs_every)
        for wake in range(20):
            tw.push(feed[40 + wake * 9:40 + (wake + 1) * 9], t)
            eng.step(tw.port, t)
            tw.ref.reflect(t)
            tw.collect()
            t += 20
        native.fault_clear()
        for _ in range(4):                     # the replays, fault-free
            eng.step(tw.port, t)
            tw.ref.reflect(t)
            tw.collect()
            t += 20
        missing = 0
        for kind, out, ref_out, sink in tw.outs:
            if kind != "udp":
                continue
            assert _is_subsequence(sink[1], ref_out.rtp_packets)
            missing += len(ref_out.rtp_packets) - len(sink[1])
        assert missing == eng.send_errors
        assert native.get_stats()["fault_injections"] > 0
        if enobufs_every:
            assert eng.send_errors > 0
        else:
            tw.assert_same("end", counters=False)
            assert eng.send_errors == 0
            assert sum(o.stalls for _k, o, _r, _s in tw.outs) > 0
    finally:
        native.fault_clear()
        tw.close()
