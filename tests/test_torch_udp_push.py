"""UDP pushers and the native recvmmsg ingest of the port, on the CPU.

* ``PacketRing.native_drain`` (``ed_udp_ingest`` in the port's egress
  core) against the port's own per-packet ``push`` and against the
  reference ring's drain of the same datagrams: flags, parsed fields,
  bytes, keyframe bookmark, RR accounting, overwrite-oldest wrap and its
  counts; a kernel-truncated datagram dropped and compacted over; an
  oversize flood held to the drain's budget;
* the egress core's receive counters and its io_uring probe;
* end to end through ``python -m easydarwin_tpu_torch --device cpu``: a
  UDP pusher (``client_port`` SETUP with ``mode=record``, datagrams to the
  ``server_port`` pair, SRs to its RTCP port) and an interleaved and a UDP
  player, every packet held to what was pushed (``utils.loopback``), the
  relay's RRs reaching the pusher, the native drain serving every packet
  in fewer drains than packets;
* in process: the same packets with ``native_ingest=False`` (one asyncio
  callback a datagram); a record SETUP without ``client_port`` gets 461,
  one with it gets the pair's ports as ``server_port``.
"""

import asyncio
import socket
import struct
import time

import numpy as np
import pytest

from easydarwin_tpu.protocol import sdp as ref_sdp
from easydarwin_tpu.relay.ring import PacketRing as RefRing
from easydarwin_tpu.relay.stream import RelayStream as RefStream
from easydarwin_tpu.relay.stream import StreamSettings as RefSettings
from easydarwin_tpu_torch import native
from easydarwin_tpu_torch.protocol import rtsp, sdp
from easydarwin_tpu_torch.relay.ring import PacketRing
from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
from easydarwin_tpu_torch.server import ServerConfig, StreamingServer
from easydarwin_tpu_torch.utils import loopback

H264_SDP = ("v=0\r\no=- 1 1 IN IP4 127.0.0.1\r\ns=live\r\nt=0 0\r\n"
            "m=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
            "a=control:trackID=1\r\n")


@pytest.fixture(autouse=True)
def _egress_core():
    assert native.available(), native.load_error


def vid_pkt(seq, ts=0, nal_type=1, size=120, marker=False):
    return (struct.pack("!BBHII", 0x80, 96 | (0x80 if marker else 0),
                        seq & 0xFFFF, ts & 0xFFFFFFFF, 0x77)
            + bytes([(3 << 5) | nal_type]) + bytes(size - 13))


def _stream_pkts(n, seed):
    """A GOP-structured stream: IDR every 7th packet, a marker on every
    third, seqs wrapping past 0xFFFF, sizes 13 to 1,400 bytes."""
    rng = np.random.default_rng(seed)
    return [vid_pkt(0xFFF0 + i, 3000 * i, nal_type=5 if i % 7 == 0 else 1,
                    size=int(rng.integers(13, 1400)), marker=i % 3 == 2)
            for i in range(n)]


class _Socks:
    """A non-blocking loopback receiver and a sender."""

    def __enter__(self):
        self.rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 21)
        self.rx.bind(("127.0.0.1", 0))
        self.rx.setblocking(False)
        self.tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        return self

    def send(self, pkts):
        for p in pkts:
            self.tx.sendto(p, self.rx.getsockname())
        time.sleep(0.05)

    def __exit__(self, *exc):
        self.rx.close()
        self.tx.close()


def _ring_state(ring):
    live = range(ring.tail, ring.head)
    slots = [ring.slot(i) for i in live]
    return (ring.head, ring.tail, ring.total_dropped, ring.total_oversize,
            [ring.get(i) for i in live], ring.flags[slots].tolist(),
            ring.seq[slots].tolist(), ring.timestamp[slots].tolist(),
            ring.ssrc[slots].tolist(), ring.length[slots].tolist(),
            ring.arrival[slots].tolist())


def test_ring_native_drain_matches_push_classification():
    """Draining datagrams through recvmmsg leaves the stream as pushing
    the same bytes does, and as the reference's drain does."""
    pkts = _stream_pkts(150, 1)
    info = sdp.parse(H264_SDP).streams[0]
    drained, pushed = (RelayStream(info, StreamSettings()) for _ in "ab")
    ref = RefStream(ref_sdp.parse(H264_SDP).streams[0], RefSettings())
    with _Socks() as a, _Socks() as b:
        a.send(pkts)
        b.send(pkts)
        assert drained.drain_rtp_native(a.rx.fileno(), 1000) == len(pkts)
        assert ref.drain_rtp_native(b.rx.fileno(), 1000) == len(pkts)
    for p in pkts:
        pushed.push_rtp(p, 1000)
    assert _ring_state(drained.rtp_ring) == _ring_state(pushed.rtp_ring)
    ra, rr = drained.rtp_ring, ref.rtp_ring
    assert ra.head == rr.head == len(pkts)
    for name in ("flags", "seq", "timestamp", "ssrc", "length", "arrival"):
        np.testing.assert_array_equal(getattr(ra, name)[:150],
                                      getattr(rr, name)[:150])
    assert [ra.get(i) for i in range(150)] == [rr.get(i) for i in range(150)]
    for st in (pushed, ref):
        assert drained.keyframe_id == st.keyframe_id
        assert drained.stats.keyframes == st.stats.keyframes
        assert drained._rr_max_seq == st._rr_max_seq
        assert drained._rr_cycles == st._rr_cycles
        assert drained._rr_received == st._rr_received
    assert drained.stats.packets_in == pushed.stats.packets_in == 150
    assert drained.stats.bytes_in == pushed.stats.bytes_in
    assert drained.native_ingest_batches == 1
    assert drained.native_ingest_pkts == len(pkts)


@pytest.mark.parametrize("max_pkts", [512, 40])
def test_native_drain_wraps_the_ring_as_push_does(max_pkts):
    """150 datagrams into a 64-slot ring: one ring's worth a call at most,
    overwrite-oldest with exact drop counts, the same live window as
    per-packet push and as the reference ring's drain."""
    pkts = _stream_pkts(150, 2)
    drained, pushed, ref = PacketRing(64, is_video=True), \
        PacketRing(64, is_video=True), RefRing(64, is_video=True)
    with _Socks() as a, _Socks() as b:
        a.send(pkts)
        b.send(pkts)
        calls = []
        while True:
            n = drained.native_drain(a.rx.fileno(), 7, max_pkts)
            if not n:
                break
            calls.append(n)
        while ref.native_drain(b.rx.fileno(), 7, max_pkts):
            pass
    assert sum(calls) == 150 and max(calls) <= min(64, max_pkts)
    for p in pkts:
        pushed.push(p, 7)
    assert _ring_state(drained) == _ring_state(pushed)
    assert (drained.head, drained.tail, drained.total_dropped) == \
        (ref.head, ref.tail, ref.total_dropped) == (150, 86, 86)
    assert [drained.get(i) for i in range(86, 150)] == \
        [ref.get(i) for i in range(86, 150)]


def test_native_drain_drops_kernel_truncated_datagrams():
    """A datagram larger than the slot is dropped, not admitted cut
    short, and the next one of the batch takes its slot."""
    ring = PacketRing(capacity=64)
    keep1 = b"\x80\x60\x00\x01" + b"A" * 60
    keep2 = b"\x80\x60\x00\x03" + b"C" * 60
    with _Socks() as s:
        s.send([keep1, b"\x80\x60\x00\x02" + b"B" * 3000, keep2])
        assert ring.native_drain(s.rx.fileno(), 123) == 2
    assert ring.get(0) == keep1 and ring.get(1) == keep2
    assert ring.total_oversize == 1 and ring.head == 2
    assert not ring.data[1, len(keep2):].any()    # zero past the length


def test_native_drain_oversize_flood_respects_budget():
    """``max_pkts`` bounds the datagrams consumed, dropped ones included:
    an oversize flood cannot stretch one drain past its budget."""
    ring = PacketRing(capacity=64)
    with _Socks() as s:
        s.send([b"\x80\x60" + bytes([0, i]) + b"B" * 3000
                for i in range(20)])
        assert ring.native_drain(s.rx.fileno(), 1, max_pkts=8) == 0
        assert ring.total_oversize == 8
        assert ring.native_drain(s.rx.fileno(), 2, max_pkts=64) == 0
        assert ring.total_oversize == 20 and ring.head == 0


def test_ingest_counters_and_argument_checks():
    ring = PacketRing(capacity=16)
    before = native.get_stats()
    with _Socks() as s:
        s.send([vid_pkt(i, size=100) for i in range(5)])
        assert ring.native_drain(s.rx.fileno(), 5) == 5
        assert ring.native_drain(s.rx.fileno(), 5) == 0   # EAGAIN: empty
        after = native.get_stats()
        assert after["recv_packets"] - before["recv_packets"] == 5
        assert after["recv_bytes"] - before["recv_bytes"] == 500
        assert after["recvmmsg_calls"] > before["recvmmsg_calls"]
        assert after["ingest_ns"] > before["ingest_ns"]
        with pytest.raises(ValueError, match="ring_len"):
            native.udp_ingest(s.rx.fileno(), ring.data,
                              ring.length.astype(np.int64), ring.arrival,
                              0, 0, 4)
        with pytest.raises(ValueError, match="ring_arrival"):
            native.udp_ingest(s.rx.fileno(), ring.data, ring.length,
                              ring.arrival[:8], 0, 0, 4)
    with pytest.raises(OSError):                 # a closed socket
        native.udp_ingest(s.rx.fileno(), ring.data, ring.length,
                          ring.arrival, 0, 0, 4)


def test_uring_probe_answers_and_is_cached():
    caps = native.uring_probe()
    assert isinstance(caps, int) and caps == native.uring_probe()
    text = native.describe_uring(caps)
    if caps >= 0:
        assert caps & native.URING_CAPS["ring"] and "ring" in text
    else:
        assert text.startswith("E")
    assert native.describe_uring(-38) == "ENOSYS"
    assert native.describe_uring(1 | 8) == "ring+recv_multi"


# ------------------------------------------------------------ end to end
async def test_udp_pusher_through_the_cli_on_cpu():
    res = await loopback.serve_and_check(
        "cpu", np.random.default_rng(11), n_push=1, n_play=2,
        transport=("tcp", "udp"), push_transport="udp", deadline_s=12)
    assert res["players"] == 2 and res["packets_pushed"] == 80
    assert res["delivered"] == 2 * 80 and res["upstream_rrs"][0] >= 1
    st = res["server_stats"]
    ing = st["ingest"]
    assert ing["native_pkts"] == 80 and ing["datagram_pkts"] == 0
    assert 0 < ing["native_batches"] < ing["native_pkts"]
    assert ing["oversize"] == 0 and ing["errors"] == 0
    assert ing["recv_packets"] == 80 and ing["ingest_ns"] > 0
    assert st["send_errors"] == 0 and st["missing_params"] == 0


async def test_udp_pusher_without_the_native_ingest_in_process():
    """``native_ingest=False``: every datagram is one asyncio callback, and
    the same packets reach the players."""
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       bind_ip="127.0.0.1",
                                       native_ingest=False), device="cpu")
    await app.start()
    try:
        res = await loopback.push_play(
            app.rtsp.port, np.random.default_rng(11), n_push=1, n_play=2,
            transport=("tcp", "udp"), push_transport="udp", deadline_s=12)
    finally:
        await app.stop()
    assert res["delivered"] == 2 * 80 and res["upstream_rrs"][0] >= 1
    ing = app.stats()["ingest"]
    assert ing["datagram_pkts"] == 80 and ing["native_pkts"] == 0
    assert app.stats()["pump_errors"] == 0


async def test_udp_record_setup_in_process():
    """A record SETUP over UDP without ``client_port`` gets 461; with it,
    the reply names the track's own pair as ``server_port``, whose RTP
    port feeds the ring and whose RTCP port feeds the RTCP ring."""
    app = StreamingServer(ServerConfig(rtsp_port=0, service_port=0,
                                       bind_ip="127.0.0.1"), device="cpu")
    await app.start()
    pusher = loopback.MiniClient()
    try:
        uri = f"rtsp://127.0.0.1:{app.rtsp.port}/live/udp"
        await pusher.connect(app.rtsp.port)
        await pusher.request("ANNOUNCE", uri,
                             {"content-type": "application/sdp"},
                             H264_SDP.encode())
        with pytest.raises(AssertionError, match="-> 461"):
            await pusher.request("SETUP", uri + "/trackID=1",
                                 {"transport": "RTP/AVP;unicast;mode=record"})
        ports = await pusher.udp_ports()
        resp = await pusher.request("SETUP", uri + "/trackID=1", {
            "transport": f"RTP/AVP;unicast;client_port={ports};mode=record"})
        t = rtsp.TransportSpec.parse(resp.headers["transport"])
        assert t.mode == "RECORD" and not t.is_tcp
        assert t.client_port == tuple(map(int, ports.split("-")))
        assert t.server_port[1] == t.server_port[0] + 1
        assert t.server_port[0] % 2 == 0
        await pusher.request("RECORD", uri)
        pusher.server_port = t.server_port
        for p in _stream_pkts(10, 3):
            pusher.push(p)
        pusher.push(loopback.sr_compound(0x77, time.time(), 0, 10, 100,
                                         b"x"), channel=1)
        stream = app.registry.find("/live/udp").streams[1]
        for _ in range(100):
            if len(stream.rtp_ring) == 10 and len(stream.rtcp_ring) == 1:
                break
            await asyncio.sleep(0.02)
        assert len(stream.rtp_ring) == 10 and len(stream.rtcp_ring) == 1
        assert stream.native_ingest_pkts == 10
        assert stream.upstream_rtcp_owner is not None
    finally:
        await pusher.close()
        await app.stop()
