"""The port's resilience package against the reference's, on the CPU.

* ``FaultPlan``: the parse and the spec round trip, key for key the
  reference's; for the same plan and seed the injector fires at the same
  calls of every site (N draws a site), and one site's stream does not
  move when another site is drawn in between;
* the ladder: ``status()`` and the events after the same scripted
  sequence equal the reference's;
* ``snapshot_registry``: the same pushes and reflects give the same
  document; restore gives back the bookkeeping, bucket placement and
  parked TCP records;
* the 16 × 16 kill-and-restore run through the megabatch over real UDP
  sockets: the port's wire bytes after the restore equal its own
  uninterrupted run's and the reference's, destination by destination;
* the megabatch draws its fault once a bucket, in bucket order, before
  it stages anything;
* the egress core's knobs are armed with a plan and cleared with it;
* a dropped ingest slot (push or native drain) reaches no wire, on the
  megabatch path, the per-stream path and the host path.
"""

import json
import random
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from easydarwin_tpu import native as ref_native
from easydarwin_tpu import obs as ref_obs
from easydarwin_tpu.obs.events import EventLog as RefEventLog
from easydarwin_tpu.obs.metrics import Counter as RefCounter
from easydarwin_tpu.obs.metrics import Gauge as RefGauge
from easydarwin_tpu.relay.fanout import TpuFanoutEngine as RefEngine
from easydarwin_tpu.relay.megabatch import \
    MegabatchScheduler as RefScheduler
from easydarwin_tpu.relay.output import CollectingOutput as RefOutput
from easydarwin_tpu.relay.session import SessionRegistry as RefRegistry
from easydarwin_tpu.relay.stream import StreamSettings as RefSettings
from easydarwin_tpu.resilience import checkpoint as ref_ckpt
from easydarwin_tpu.resilience import inject as ref_inject
from easydarwin_tpu.resilience import ladder as ref_ladder
from easydarwin_tpu_torch import native, obs
from easydarwin_tpu_torch.obs.events import EventLog
from easydarwin_tpu_torch.obs.metrics import Counter, Gauge
from easydarwin_tpu_torch.protocol import rtp, sdp
from easydarwin_tpu_torch.relay.fanout import FanoutEngine
from easydarwin_tpu_torch.relay.megabatch import MegabatchScheduler
from easydarwin_tpu_torch.relay.output import CollectingOutput
from easydarwin_tpu_torch.relay.session import SessionRegistry
from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings
from easydarwin_tpu_torch.resilience import checkpoint as ckpt
from easydarwin_tpu_torch.resilience import inject, ladder
from easydarwin_tpu_torch.resilience.inject import (INJECTOR, FaultPlan,
                                                    InjectedFault)

ROOT = Path(__file__).resolve().parents[1]
VIDEO_SDP = ("v=0\r\nm=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
             "a=control:trackID=1\r\n")


def vid_pkt(seq: int, ts: int | None = None, nal_type: int = 1) -> bytes:
    payload = bytes(((3 << 5) | nal_type,)) + bytes(
        (seq * 7 + i) & 0xFF for i in range(80))
    return rtp.RtpPacket(payload_type=96, seq=seq & 0xFFFF,
                         timestamp=(seq * 90 if ts is None else ts),
                         ssrc=0x1234, payload=payload).to_bytes()


@pytest.fixture
def armed():
    """The process-wide injector the relay's sites consult, disarmed
    after the test whatever it did."""
    try:
        yield INJECTOR
    finally:
        INJECTOR.disarm()


def _pair(clock=None, **plan_kw):
    """A private port injector and a private reference injector, both
    armed with the same plan."""
    kw = {} if clock is None else {"clock": clock}
    port = inject.FaultInjector(
        events=EventLog(), counter=Counter("t_fault_total", "t",
                                           labels=("site",)), **kw)
    ref = ref_inject.FaultInjector(
        events=RefEventLog(), counter=RefCounter("t_fault_total", "t",
                                                 labels=("site",)), **kw)
    port.arm(FaultPlan(**plan_kw))
    ref.arm(ref_inject.FaultPlan(**plan_kw))
    return port, ref


# ------------------------------------------------------------- the plan
def test_fault_plan_fields_and_sites_equal_the_reference():
    from dataclasses import fields
    assert [(f.name, f.type, f.default) for f in fields(FaultPlan)] == [
        (f.name, f.type, f.default) for f in fields(ref_inject.FaultPlan)]
    assert inject.SITES == ref_inject.SITES
    assert inject.EMIT_INTERVAL_S == ref_inject.EMIT_INTERVAL_S


@pytest.mark.parametrize("spec", [
    "seed=7,ingest_drop=0.05,egress_enobufs_every=300",
    "seed=3,device_error_every=40,device_error_period_s=2.5,"
    "stale_params_every=9,slow_sub_every=4",
    "egress_eagain_every=97,egress_latency_every=5,egress_latency_us=200,"
    "rr_loss_spoof=0.3,capacity_spoof=1e5,overload_spoof=0.2",
    "lease_loss_every=3,redis_partition_every=4,pull_stall_every=5,"
    "egress_drop=0.01",
    "",
])
def test_fault_plan_parse_and_spec_round_trip(spec):
    p = FaultPlan.parse(spec)
    r = ref_inject.FaultPlan.parse(spec)
    assert p.to_spec() == r.to_spec()
    assert FaultPlan.parse(p.to_spec()) == p
    assert p.any_active() == r.any_active() == bool(spec)


def test_fault_plan_rejects_unknown_key():
    with pytest.raises(ValueError, match="ingest_dorp"):
        FaultPlan.parse("ingest_dorp=0.1")


# ------------------------------------------------------ the schedules
def _draw(inj, site: str, i: int, hold: list, ring=None):
    """One decision of ``site`` (call ``i``) as a comparable value."""
    if site == "ingest":
        return tuple(inj.ingest(vid_pkt(i), hold))
    if site == "ingest_ring":
        inj.ingest_ring(ring, ring.head - 4, ring.head)
        return None
    if site == "device_dispatch":
        try:
            inj.device_dispatch("t")
            return False
        except Exception as e:
            return type(e).__name__
    return getattr(inj, site)()


SITE_PLANS = {
    "ingest": dict(ingest_drop=0.2, ingest_corrupt=0.3, ingest_reorder=0.15),
    "device_dispatch": dict(device_error_every=7),
    "stale_params": dict(stale_params_every=5),
    "slow_subscriber": dict(slow_sub_every=3),
    "egress_drop": dict(egress_drop=0.25),
    "rr_loss_spoof": dict(rr_loss_spoof=0.4),
    "capacity_spoof": dict(capacity_spoof=123456.0),
    "overload_spoof": dict(overload_spoof=0.3),
    "lease_loss": dict(lease_loss_every=4),
    "redis_partition": dict(redis_partition_every=6),
    "pull_stall": dict(pull_stall_every=2),
}


@pytest.mark.parametrize("site", sorted(SITE_PLANS))
@pytest.mark.parametrize("seed", [0, 21])
def test_schedule_equals_the_reference_at_every_site(site, seed):
    port, ref = _pair(seed=seed, **SITE_PLANS[site])
    hp, hr = [], []
    a = [_draw(port, site, i, hp) for i in range(400)]
    b = [_draw(ref, site, i, hr) for i in range(400)]
    assert a == b
    assert port.counts() == ref.counts()
    assert sum(port.counts().values()) > 0
    assert port._counter.value(site=next(iter(port.counts()))) == \
        ref._counter.value(site=next(iter(ref.counts())))


def test_ring_gauntlet_equals_the_reference():
    from easydarwin_tpu.relay.ring import PacketRing as RefRing
    from easydarwin_tpu_torch.relay.ring import PacketRing
    port, ref = _pair(seed=5, ingest_drop=0.25, ingest_corrupt=0.25)
    rings = (PacketRing(256, is_video=True), RefRing(256, is_video=True))
    for inj, ring in zip((port, ref), rings):
        for k in range(40):
            for i in range(4):
                ring.push(vid_pkt(4 * k + i), 1000)
            inj.ingest_ring(ring, ring.head - 4, ring.head)
    assert port.counts() == ref.counts()
    assert np.array_equal(rings[0].length[:160], rings[1].length[:160])
    assert np.array_equal(rings[0].flags[:160], rings[1].flags[:160])
    assert np.array_equal(rings[0].data[:160], rings[1].data[:160])


def test_device_dispatch_period_equals_the_reference():
    clk = [0.0]
    port, ref = _pair(clock=lambda: clk[0], seed=1,
                      device_error_period_s=60.0)
    out = []
    for t in (0.0, 30.0, 61.0, 62.0, 121.5):
        clk[0] = t
        out.append((_draw(port, "device_dispatch", 0, []),
                    _draw(ref, "device_dispatch", 0, [])))
    assert [a for a, _ in out] == [b for _, b in out]
    assert [a for a, _ in out] == ["InjectedFault", False, "InjectedFault",
                                   False, "InjectedFault"]


def test_schedule_independent_of_other_sites():
    a, _ = _pair(seed=5, ingest_drop=0.5)
    b, _ = _pair(seed=5, ingest_drop=0.5, slow_sub_every=2,
                 device_error_every=3)
    seq_a, seq_b = [], []
    for i in range(200):
        seq_a.append(len(a.ingest(vid_pkt(i), [])))
        b.slow_subscriber()             # other sites drawn in between
        try:
            b.device_dispatch("x")
        except InjectedFault:
            pass
        seq_b.append(len(b.ingest(vid_pkt(i), [])))
    assert seq_a == seq_b


def test_rearm_same_seed_replays_schedule():
    inj, _ = _pair(seed=9, ingest_drop=0.4)
    first = [len(inj.ingest(vid_pkt(i), [])) for i in range(100)]
    inj.arm(FaultPlan(seed=9, ingest_drop=0.4))
    assert [len(inj.ingest(vid_pkt(i), [])) for i in range(100)] == first


def test_ingest_sites_keep_the_header_and_swap_adjacent():
    cor, _ = _pair(seed=1, ingest_corrupt=1.0)
    pkt = vid_pkt(0)
    (mut,) = cor.ingest(pkt, [])
    assert mut[:12] == pkt[:12] and mut != pkt and len(mut) == len(pkt)
    ro, _ = _pair(seed=1, ingest_reorder=1.0)
    hold: list = []
    p0, p1 = vid_pkt(0), vid_pkt(1)
    assert ro.ingest(p0, hold) == []
    assert ro.ingest(p1, hold) == [p1, p0]
    assert hold == []


# ---------------------------------------------------------- the wiring
def test_reorder_hold_is_stream_owned(armed):
    armed.arm(FaultPlan(seed=2, ingest_reorder=1.0))
    a = RelayStream(sdp.parse(VIDEO_SDP).streams[0])
    held = vid_pkt(0)
    a.push_rtp(held, 1000)
    assert len(a.rtp_ring) == 0 and a._chaos_hold == [held]
    b = RelayStream(sdp.parse(VIDEO_SDP).streams[0])
    b.push_rtp(vid_pkt(100), 1000)
    b.push_rtp(vid_pkt(101), 1000)
    assert len(b.rtp_ring) == 2 and b.rtp_ring.get(0) == vid_pkt(101)
    assert a._chaos_hold == [held]


def test_push_drop_and_slow_subscriber_wiring(armed):
    st = RelayStream(sdp.parse(VIDEO_SDP).streams[0],
                     StreamSettings(bucket_delay_ms=0))
    armed.arm(FaultPlan(seed=3, ingest_drop=1.0))
    assert st.push_rtp(vid_pkt(0), 1000) == -1 and len(st.rtp_ring) == 0
    armed.disarm()
    out = CollectingOutput(ssrc=1)
    st.add_output(out)
    for i in range(1, 9):
        st.push_rtp(vid_pkt(i), 1000)
    armed.arm(FaultPlan(seed=3, slow_sub_every=2))
    st.reflect(1000)
    assert out.stalls > 0
    armed.disarm()
    st.reflect(1000)
    assert len(out.rtp_packets) == 8     # the bookmark replayed them all


def test_egress_drop_is_accounted_sent(armed):
    st = RelayStream(sdp.parse(VIDEO_SDP).streams[0],
                     StreamSettings(bucket_delay_ms=0))
    out = CollectingOutput(ssrc=1)
    st.add_output(out)
    for i in range(20):
        st.push_rtp(vid_pkt(i), 1000)
    armed.arm(FaultPlan(seed=4, egress_drop=0.5))
    st.reflect(1000)
    lost = armed.counts()["egress_drop"]
    assert 0 < lost < 20
    assert out.packets_sent == 20 and len(out.rtp_packets) == 20 - lost


def test_engine_device_dispatch_and_stale_params_wiring(armed):
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.setblocking(False)
    try:
        st = RelayStream(sdp.parse(VIDEO_SDP).streams[0],
                         StreamSettings(bucket_delay_ms=0))
        out = CollectingOutput(ssrc=7)
        out.native_addr = recv.getsockname()
        st.add_output(out)
        eng = FanoutEngine(egress_fd=send.fileno(), device="cpu")
        t, seq = 1000, 0

        def wake():
            nonlocal t, seq
            st.push_rtp(vid_pkt(seq), t)
            seq += 1
            eng.step(st, t)
            t += 20

        wake()
        armed.arm(FaultPlan(seed=3, device_error_every=1))
        with pytest.raises(InjectedFault):
            wake()
        armed.arm(FaultPlan(seed=3, stale_params_every=1))
        pre = eng.device_param_refreshes
        wake()
        wake()
        assert eng.device_param_refreshes >= pre + 2
    finally:
        send.close()
        recv.close()


# -------------------------------------------------------------- the ladder
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _ladders(clock, **cfg_kw):
    port = ladder.DegradationLadder(
        ladder.LadderConfig(**cfg_kw), clock=clock, events=EventLog(),
        gauge=Gauge("t_level", "t", labels=("stream",)),
        transitions=Counter("t_trans_total", "t", labels=("direction",)),
        retries=Counter("t_retries_total", "t"))
    ref = ref_ladder.DegradationLadder(
        ref_ladder.LadderConfig(**cfg_kw), clock=clock,
        events=RefEventLog(),
        gauge=RefGauge("t_level", "t", labels=("stream",)),
        transitions=RefCounter("t_trans_total", "t", labels=("direction",)),
        retries=RefCounter("t_retries_total", "t"))
    return port, ref


def _events(lad):
    return [{k: v for k, v in r.items() if k not in ("ts", "seq", "node")}
            for r in lad._events.tail()]


BURN = {"objectives": {"latency": {"in_violation": True}}}
CALM = {"objectives": {"latency": {"in_violation": False}}}
#: scripted sequences: (time, call, args)
SCRIPTS = {
    "bounded_retry": (dict(max_retries=2, backoff_ms=100), [
        (0.0, "err", "/x"), (0.2, "mode", "/x"), (0.3, "err", "/x"),
        (0.6, "err", "/x"), (0.7, "mode", "/x")]),
    "interleaved_ok": (dict(max_retries=2, backoff_ms=10, recover_sec=10.0), [
        (0.0, "err", "/x"), (1.0, "ok", "/x"), (2.0, "err", "/x"),
        (3.0, "ok", "/x"), (4.0, "err", "/x"), (5.0, "ok", "/x"),
        (100.0, "ok", "/x"), (100.0, "err", "/x")]),
    "hysteresis": (dict(max_retries=0, recover_sec=10.0), [
        (0.0, "err", "/x"), (1.0, "err", "/x"), (5.0, "tick", {"/x": 0}),
        (12.0, "tick", {"/x": 0}), (13.0, "tick", {"/x": 0})]),
    "shed": (dict(max_retries=0, recover_sec=10.0, shed_stall_growth=50), [
        (0.0, "err", "/x"), (0.0, "err", "/x"), (1.0, "tick", {"/x": 100}),
        (2.0, "tick", {"/x": 200})]),
    "slo_edge": ({}, [
        (0.0, "slo", (BURN, "/w")), (1.0, "slo", (BURN, "/w")),
        (2.0, "slo", (CALM, None)), (3.0, "slo", (BURN, "/w"))]),
    "scheduler": (dict(max_retries=0), [
        (0.0, "sched", ["/a", "/b", None]), (0.5, "sched", ["/a"]),
        (1.0, "tick", {"/a": 0, "/b": 0})]),
    "cpu_errors_do_not_pin": (dict(max_retries=0, recover_sec=10.0), [
        (0.0, "err", "/x"), (0.0, "err", "/x")] + [
        (float(t), "err_tick", "/x") for t in range(1, 14)]),
    "prune": (dict(max_retries=0), [
        (0.0, "err", "/dead"), (1.0, "tick", {"/live": 0})]),
    "rtx_and_pull_reasons": (dict(max_retries=0), [
        (0.0, "reason", ("/r", "rtx_giveup")),
        (0.0, "reason", ("/p", "pull_errors"))]),
}


def _run_script(lad, clk, steps):
    seen = []
    for t, op, arg in steps:
        clk.t = t
        if op == "err":
            lad.note_device_error(arg)
        elif op == "reason":
            lad.note_device_error(arg[0], reason=arg[1])
        elif op == "ok":
            lad.note_device_ok(arg)
        elif op == "mode":
            seen.append((lad.engine_mode(arg), lad.allows_megabatch(arg)))
        elif op == "tick":
            lad.tick(arg)
        elif op == "slo":
            stalls = {arg[1]: 0} if arg[1] else {}
            lad.tick(stalls or None, slo_status=arg[0], offender=arg[1])
        elif op == "sched":
            lad.note_scheduler_error(arg)
        elif op == "err_tick":
            if lad.level(arg) >= ladder.LEVEL_CPU:
                lad.note_device_error(arg)
            lad.tick({arg: 0})
        seen.append((lad.status(), lad.worst_level(), lad.degrades,
                     lad.recovers))
    return seen


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_ladder_status_equals_the_reference(name):
    cfg, steps = SCRIPTS[name]
    clk = _Clock()
    port, ref = _ladders(clk, **cfg)
    assert _run_script(port, clk, steps) == _run_script(ref, clk, steps)
    assert _events(port) == _events(ref)
    assert port._transitions.value(direction="down") == \
        ref._transitions.value(direction="down")


def test_ladder_sheds_newest_never_the_last():
    clk = _Clock()
    lad, _ = _ladders(clk)
    st = RelayStream(sdp.parse(VIDEO_SDP).streams[0])
    outs = [CollectingOutput(ssrc=i) for i in range(3)]
    for o in outs:
        st.add_output(o)
    assert lad.shed_candidate(st) is outs[-1]
    st.remove_output(outs[-1])
    st.remove_output(outs[-2])
    assert lad.shed_candidate(st) is None


def test_ladder_names_equal_the_reference():
    assert ladder.RUNGS == ref_ladder.RUNGS
    assert (ladder.LEVEL_FULL, ladder.LEVEL_DEVICE, ladder.LEVEL_CPU,
            ladder.LEVEL_SHED) == (0, 1, 2, 3)
    assert ladder.LadderConfig() == ladder.LadderConfig(
        **vars(ref_ladder.LadderConfig()))


# --------------------------------------------------------- the checkpoint
def _registries(n_streams: int, outs_per: int, addrs=None, **settings):
    """The same sessions, streams and outputs in a port registry and a
    reference registry (same reporter SSRCs and trace ids)."""
    regs = (SessionRegistry(StreamSettings(bucket_delay_ms=0, **settings)),
            RefRegistry(RefSettings(bucket_delay_ms=0, **settings)))
    out_cls = (CollectingOutput, RefOutput)
    streams = ([], [])
    for i in range(n_streams):
        for k in range(2):
            sess = regs[k].find_or_create(f"/live/s{i}", VIDEO_SDP)
            sess.set_trace(f"trace{i:04d}")
            st = sess.streams[1]
            st.reporter_ssrc = 0x0A0B0000 + i
            rng = random.Random(100 + i)
            for j in range(outs_per):
                o = out_cls[k](ssrc=rng.getrandbits(32),
                               out_seq_start=rng.getrandbits(16),
                               out_ts_start=rng.getrandbits(32))
                if addrs is not None:
                    o.native_addr = addrs[j % len(addrs)]
                st.add_output(o)
            streams[k].append(st)
    return regs, streams


def _same_node(fn):
    """Run ``fn`` with both packages' node ids set to one name."""
    saved = (dict(obs.NODE), dict(ref_obs.NODE))
    obs.NODE["id"] = ref_obs.NODE["id"] = "node-a"
    try:
        return fn()
    finally:
        obs.NODE.clear()
        obs.NODE.update(saved[0])
        ref_obs.NODE.clear()
        ref_obs.NODE.update(saved[1])


def _doc_without_clock(doc):
    return {k: v for k, v in doc.items() if k != "saved_wall"}


@pytest.mark.parametrize("n_streams, outs_per, rounds", [
    (1, 1, 3), (2, 3, 7), (3, 5, 12)])
def test_snapshot_documents_equal_the_reference(n_streams, outs_per, rounds):
    regs, streams = _registries(n_streams, outs_per,
                                addrs=[("127.0.0.1", 5004)])
    t, seq = 1000, 0
    for _ in range(rounds):
        for k in range(2):
            s = seq
            for st in streams[k]:
                st.push_rtp(vid_pkt(s), t)
                s += 1
            for st in streams[k]:
                st.reflect(t)
        seq += n_streams
        t += 20
    docs = _same_node(lambda: [ckpt.snapshot_registry(regs[0]),
                               ref_ckpt.snapshot_registry(regs[1])])
    assert docs[0]["version"] == ckpt.CKPT_VERSION == ref_ckpt.CKPT_VERSION
    assert json.dumps(_doc_without_clock(docs[0]), sort_keys=True) == \
        json.dumps(_doc_without_clock(docs[1]), sort_keys=True)


def _collecting_factory(rec):
    o = CollectingOutput()
    if rec.get("rtp_addr"):
        o.native_addr = tuple(rec["rtp_addr"])
    return o


def test_checkpoint_roundtrip_restores_bookkeeping():
    (reg, _), (streams, _) = _registries(2, 3, addrs=[("127.0.0.1", 5004)])
    t, seq = 1000, 0
    for _ in range(7):
        for st in streams:
            st.push_rtp(vid_pkt(seq), t)
            seq += 1
        for st in streams:
            st.reflect(t)
        t += 20
    doc = json.loads(json.dumps(ckpt.snapshot_registry(reg)))
    reg2 = SessionRegistry(StreamSettings(bucket_delay_ms=0))
    assert ckpt.restore_registry(
        reg2, doc, output_factory=_collecting_factory) == (2, 6)
    for i, st in enumerate(streams):
        sess2 = reg2.find(f"/live/s{i}")
        assert sess2.trace_id == f"trace{i:04d}"
        st2 = sess2.streams[1]
        assert st2.rtp_ring.head == st2.rtp_ring.tail == st.rtp_ring.head
        assert (st2.reporter_ssrc, st2._rr_base_seq, st2._rr_max_seq) == (
            st.reporter_ssrc, st._rr_base_seq, st._rr_max_seq)
        for o, o2 in zip(st.outputs, st2.outputs):
            assert o2.rewrite == o.rewrite
            assert (o2.packets_sent, o2.payload_octets) == (
                o.packets_sent, o.payload_octets)
            assert o2.bookmark == st.rtp_ring.head


def test_restore_pins_buckets_and_parks_tcp_records():
    reg = SessionRegistry(StreamSettings(bucket_size=2))
    st = reg.find_or_create("/live/bk", VIDEO_SDP).streams[1]
    outs = [CollectingOutput(ssrc=i) for i in range(4)]
    for o in outs:
        o.native_addr = ("127.0.0.1", 6000)
        st.add_output(o)
    st.remove_output(outs[0])
    tcp = CollectingOutput(ssrc=99, out_seq_start=500)
    tcp.interleave_chan = 0
    tcp.rtp_channel, tcp.rtcp_channel = 0, 1
    tcp.session_id = "abc123"
    st.add_output(tcp)
    doc = json.loads(json.dumps(ckpt.snapshot_registry(reg)))
    kinds = [o["kind"] for o in doc["sessions"][0]["streams"][0]["outputs"]]
    assert sorted(kinds) == ["tcp", "udp", "udp", "udp"]
    parked = []
    reg2 = SessionRegistry(StreamSettings(bucket_size=2))
    n = ckpt.restore_registry(
        reg2, doc, output_factory=_collecting_factory,
        tcp_sink=lambda *a: parked.append(a))
    assert n == (1, 3)
    assert [len(b) for b in reg2.find("/live/bk").streams[1].buckets] == \
        [1, 2]
    assert parked[0][:2] == ("/live/bk", 1)
    assert parked[0][2]["session_id"] == "abc123"
    assert parked[0][2]["channels"] == [0, 1]


def test_checkpoint_manager_staleness_version_and_throttle(tmp_path):
    (reg, _), _ = _registries(1, 1)
    clk = _Clock()
    mgr = ckpt.CheckpointManager(str(tmp_path), interval_sec=5.0,
                                 max_age_sec=60.0, clock=clk)
    assert mgr.load() is None
    assert mgr.maybe_write(reg) and not mgr.maybe_write(reg)
    clk.t = 6.0
    assert mgr.maybe_write(reg) and mgr.writes == 2
    assert mgr.load() is not None
    doc = json.load(open(mgr.path))
    doc["saved_wall"] -= 3600
    json.dump(doc, open(mgr.path, "w"))
    assert mgr.load() is None
    doc["saved_wall"] += 3600
    doc["version"] = 99
    json.dump(doc, open(mgr.path, "w"))
    assert mgr.load() is None
    open(mgr.path, "w").write("{not json")
    assert mgr.load() is None


# --------------------------------------- kill and restore, 16 x 16 wire
class _Wire:
    def __init__(self, n: int):
        self.socks = []
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind(("127.0.0.1", 0))
            s.setblocking(False)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
            self.socks.append(s)
        self.addrs = [s.getsockname() for s in self.socks]
        self.rx: list[list[bytes]] = [[] for _ in self.socks]

    def drain(self) -> None:
        for i, s in enumerate(self.socks):
            while True:
                try:
                    self.rx[i].append(s.recv(65536))
                except BlockingIOError:
                    break

    def close(self) -> None:
        for s in self.socks:
            s.close()


N_SRC, N_SUB, PHASE_A, PHASE_B = 16, 16, 6, 6


def _kill_restore_run(ref: bool, kill_restore: bool, wire: _Wire,
                      send_fd: int):
    mods = ((RefRegistry, RefSettings, RefOutput, ref_ckpt,
             lambda: RefEngine(egress_fd=send_fd), RefScheduler) if ref else
            (SessionRegistry, StreamSettings, CollectingOutput, ckpt,
             lambda: FanoutEngine(egress_fd=send_fd, device="cpu"),
             lambda: MegabatchScheduler(device="cpu")))
    Registry, Settings, Output, ck, make_engine, make_sched = mods

    def build():
        reg = Registry(Settings(bucket_delay_ms=0))
        for i in range(N_SRC):
            st = reg.find_or_create(f"/live/s{i}", VIDEO_SDP).streams[1]
            st.reporter_ssrc = i
            rng = random.Random(100 + i)
            for j in range(N_SUB):
                o = Output(ssrc=rng.getrandbits(32),
                           out_seq_start=rng.getrandbits(16),
                           out_ts_start=rng.getrandbits(32))
                o.native_addr = wire.addrs[j]
                st.add_output(o)
        return reg

    def factory(rec):
        o = Output()
        o.native_addr = tuple(rec["rtp_addr"])
        return o

    reg = build()
    streams = [reg.find(f"/live/s{i}").streams[1] for i in range(N_SRC)]
    engines = [make_engine() for _ in streams]
    sched = make_sched()
    state = {"t": 1000, "seq": 0}

    def wakes(n, push=True):
        for _ in range(n):
            if push:
                for st in streams:
                    for _ in range(2):
                        st.push_rtp(vid_pkt(state["seq"]), state["t"])
                        state["seq"] += 1
            pairs = list(zip(streams, engines))
            sched.begin_wake(pairs, state["t"])
            for st, eng in pairs:
                eng.step(st, state["t"])
            sched.end_wake(pairs, state["t"])
            wire.drain()
            state["t"] += 20

    wakes(PHASE_A)
    sched.drain()
    wire.drain()
    mark = [len(r) for r in wire.rx]
    if kill_restore:
        doc = json.loads(json.dumps(_same_node(
            lambda: ck.snapshot_registry(reg))))
        reg = Registry(Settings(bucket_delay_ms=0))
        ck.restore_registry(reg, doc, output_factory=factory)
        streams = [reg.find(f"/live/s{i}").streams[1] for i in range(N_SRC)]
        engines = [make_engine() for _ in streams]
        sched = make_sched()
    wakes(PHASE_B)
    sched.drain()
    wakes(1, push=False)
    return mark, [list(r) for r in wire.rx]


@pytest.mark.skipif(not (native.available() and ref_native.available()),
                    reason="the egress cores are not built")
def test_kill_restore_wire_bytes_equal_16x16():
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    wires = [_Wire(N_SUB) for _ in range(3)]
    try:
        mark_o, rx_o = _kill_restore_run(False, False, wires[0],
                                         send.fileno())
        mark_p, rx_p = _kill_restore_run(False, True, wires[1],
                                         send.fileno())
        mark_r, rx_r = _kill_restore_run(True, True, wires[2],
                                         send.fileno())
        assert mark_o == mark_p == mark_r
        total = 0
        for d in range(N_SUB):
            after = rx_p[d][mark_p[d]:]
            assert after == rx_o[d][mark_o[d]:], f"dest {d}: vs oracle"
            assert after == rx_r[d][mark_r[d]:], f"dest {d}: vs reference"
            assert rx_p[d][:mark_p[d]] == rx_r[d][:mark_r[d]]
            total += len(after)
            # the same SSRC set keeps flowing on each destination
            assert {p[8:12] for p in after} <= {
                p[8:12] for p in rx_p[d][:mark_p[d]]}
        assert total >= N_SRC * N_SUB * PHASE_B
    finally:
        send.close()
        for w in wires:
            w.close()


# ----------------------------------------------- the megabatch's draws
def _mega_setup(n_streams, outs, wire=None):
    streams, engines = [], []
    for i in range(n_streams):
        st = RelayStream(sdp.parse(VIDEO_SDP).streams[0],
                         StreamSettings(bucket_delay_ms=0))
        for j in range(outs[i]):
            o = CollectingOutput(ssrc=1000 * i + j)
            if wire is not None:
                o.native_addr = wire.addrs[j % len(wire.addrs)]
            st.add_output(o)
        streams.append(st)
        engines.append(FanoutEngine(device="cpu"))
    return streams, engines


def test_megabatch_draws_once_a_bucket_before_staging(armed):
    # three subscriber counts → three buckets
    streams, engines = _mega_setup(3, [1, 12, 40])
    sched = MegabatchScheduler(device="cpu")
    pairs = list(zip(streams, engines))
    t = 1000
    for st in streams:
        st.push_rtp(vid_pkt(0, nal_type=5), t)
    sched.begin_wake(pairs, t)
    for st, eng in pairs:
        eng.step(st, t)
    for st in streams:
        st.push_rtp(vid_pkt(1), t)
    before = (dict(sched._tracked), sched.window_calls, sched.passes,
              len(sched._inflight), {k: len(v) for k, v
                                     in sched._free.items()})
    armed.arm(FaultPlan(seed=1, device_error_every=3))
    with pytest.raises(InjectedFault, match="megabatch.dispatch"):
        sched.end_wake(pairs, t)
    # three buckets → three draws, the third raised; nothing moved
    assert armed._count["_device_dispatch_calls"] == 3
    assert (dict(sched._tracked), sched.window_calls, sched.passes,
            len(sched._inflight), {k: len(v) for k, v
                                   in sched._free.items()}) == before
    armed.arm(FaultPlan(seed=1, device_error_every=4))
    sched.end_wake(pairs, t)            # draws 1-3 pass: dispatched
    assert armed._count["_device_dispatch_calls"] == 3
    assert sched.window_calls == before[1] + 1
    assert len(sched._inflight) == 3


def test_megabatch_draw_count_equals_the_reference():
    """One wake of the same three streams: the port draws once a bucket
    up front, the reference at each bucket's dispatch; both draw the
    same number of times and raise at the same draw."""
    from easydarwin_tpu.protocol import sdp as ref_sdp
    from easydarwin_tpu.relay.stream import RelayStream as RefStream
    wire = _Wire(1)
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    counts = []
    try:
        for ref in (False, True):
            inj_mod = ref_inject if ref else inject
            inj = inj_mod.INJECTOR
            if ref:
                streams = []
                for i, n in enumerate([1, 12, 40]):
                    st = RefStream(ref_sdp.parse(VIDEO_SDP).streams[0],
                                   RefSettings(bucket_delay_ms=0))
                    for j in range(n):
                        o = RefOutput(ssrc=1000 * i + j)
                        o.native_addr = wire.addrs[0]
                        st.add_output(o)
                    streams.append(st)
                engines = [RefEngine(egress_fd=send.fileno())
                           for _ in streams]
                sched = RefScheduler()
            else:
                streams, engines = _mega_setup(3, [1, 12, 40], wire)
                for eng in engines:
                    eng.egress_fd = send.fileno()
                sched = MegabatchScheduler(device="cpu")
            pairs = list(zip(streams, engines))
            for st in streams:
                st.push_rtp(vid_pkt(0, nal_type=5), 1000)
            sched.begin_wake(pairs, 1000)
            for st, eng in pairs:
                eng.step(st, 1000)
            for st in streams:
                st.push_rtp(vid_pkt(1), 1000)
            try:
                inj.arm(inj_mod.FaultPlan(seed=1, device_error_every=2))
                raised = None
                try:
                    sched.end_wake(pairs, 1000)
                except Exception as e:
                    raised = type(e).__name__
                counts.append((inj._count.get("_device_dispatch_calls", 0),
                               inj.counts().get("device_dispatch", 0),
                               raised))
            finally:
                inj.disarm()
                sched.drain()
            wire.drain()
    finally:
        send.close()
        wire.close()
    assert counts[0] == counts[1] == (2, 1, "InjectedFault")


# ------------------------------------------------------ the native knobs
@pytest.mark.skipif(not native.available(), reason="egress core not built")
def test_native_knobs_armed_and_cleared_with_the_plan(armed):
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.setblocking(False)
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        ring = np.zeros((4, 64), np.uint8)
        ring[:, 0] = 0x80
        lens = np.full(4, 40, np.int32)
        dests = native.make_dests([recv.getsockname()])
        ops_np = np.array([[i, 0] for i in range(4)], np.int32)
        z = np.zeros((1, 1), np.uint32)

        def send_once():
            return native.fanout_send_multi(
                send.fileno(), ring, lens, z, z, z, dests,
                native.ops_from_numpy(ops_np), 4, use_gso=native.SEND_PLAIN)

        pre = native.get_stats()["fault_injections"]
        armed.arm(FaultPlan(seed=1, egress_eagain_every=2))
        assert [send_once() for _ in range(4)] == [4, 0, 4, 0]
        armed.arm(FaultPlan(seed=1, egress_enobufs_every=3))
        res = [send_once() for _ in range(3)]
        assert res[2] < 0 and res[:2] == [4, 4]
        assert native.get_stats()["fault_injections"] >= pre + 3
        armed.disarm()
        assert [send_once() for _ in range(3)] == [4, 4, 4]
    finally:
        native.fault_clear()
        send.close()
        recv.close()


# ------------------------------------------- a dropped slot on no wire
def _drain(sock) -> list[bytes]:
    got = []
    while True:
        try:
            got.append(sock.recv(65536))
        except BlockingIOError:
            return got


def _dropped_seqs(ring) -> set[int]:
    """Source seqs of the slots the gauntlet dropped (length 0)."""
    return {int(ring.seq[ring.slot(pid)]) for pid in range(ring.tail,
                                                           ring.head)
            if ring.length[ring.slot(pid)] == 0}


@pytest.mark.skipif(not native.available(), reason="egress core not built")
@pytest.mark.parametrize("path", ["megabatch", "per_stream", "host"])
def test_dropped_ingest_slot_never_reaches_a_wire(armed, path):
    wire = _Wire(2)
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    pushers = []
    try:
        n = 2 if path == "megabatch" else 1
        streams, engines = _mega_setup(n, [2] * n, wire)
        for eng in engines:
            eng.egress_fd = send.fileno()
        sched = MegabatchScheduler(device="cpu")
        ingest = []
        for _ in streams:
            rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            rx.bind(("127.0.0.1", 0))
            rx.setblocking(False)
            rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 21)
            ingest.append(rx)
            pushers.append(rx)
        armed.arm(FaultPlan(seed=11, ingest_drop=0.3))
        t, seq = 1000, 0
        sent = [[] for _ in streams]
        for _ in range(10):
            for k, rx in enumerate(ingest):
                for _ in range(6):
                    p = vid_pkt(seq + 1000 * k,
                                nal_type=5 if seq == 0 else 1)
                    sent[k].append(p)
                    send.sendto(p, rx.getsockname())
                    seq += 1
            time.sleep(0.02)
            for st, rx in zip(streams, ingest):
                st.drain_rtp_native(rx.fileno(), t)
            pairs = list(zip(streams, engines))
            if path == "megabatch":
                sched.begin_wake(pairs, t)
            for st, eng in pairs:
                if path == "host":
                    st.reflect(t)
                else:
                    eng.step(st, t)
            if path == "megabatch":
                sched.end_wake(pairs, t)
            t += 20
            wire.drain()
        if path == "megabatch":
            sched.drain()
        dropped = set().union(*(_dropped_seqs(st.rtp_ring)
                                for st in streams))
        assert armed.counts()["ingest_drop"] == len(dropped) > 0
        # the host path writes through each output's send_bytes (a
        # collecting output keeps what it was sent); the engine's native
        # rung sends to the wire
        got = [p for r in wire.rx for p in r] + [
            p for st in streams for o in st.outputs for p in o.rtp_packets]
        assert got, "nothing was delivered"
        # the rewritten seq hides the source seq: match by payload
        payloads = {p[12:] for p in got}
        dropped_payloads = {p[12:] for k in range(len(streams))
                            for p in sent[k]
                            if rtp.peek_seq(p) in dropped}
        assert not payloads & dropped_payloads
        kept = {p[12:] for k in range(len(streams)) for p in sent[k]
                if rtp.peek_seq(p) not in dropped}
        assert payloads <= kept
    finally:
        send.close()
        wire.close()
        for rx in pushers:
            rx.close()


# ---------------------------------------------------------- the imports
def test_resilience_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import easydarwin_tpu_torch.resilience\n"
            "import easydarwin_tpu_torch.server.app\n"
            "assert 'easydarwin_tpu_torch.resilience.checkpoint' "
            "in sys.modules\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'easydarwin_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
