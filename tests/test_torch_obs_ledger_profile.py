"""The port's wake ledger and phase profiler against the reference's, on
the CPU, and the profiler's cost on the port's own engine.

* the same seeded sequence of wakes (``begin_wake`` with and without an
  ingest stamp, nested units of every work class with items and trace
  ids, queue ages, deferrals inside and outside a wake, disabled
  ledgers) under a pinned clock gives an equal ``snapshot()``, equal
  wait/service/deferred exposition, an equal ``blame_doc`` (with and
  without a measured p99) and equal ``suspect_flags``;
* the same passes through ``PhaseProfiler.account_pass`` (checked and
  unchecked, in and out of the drift tolerance, multi-engine slices),
  ``observe``, ``account_latency``, ``note_compile`` give an equal
  ``snapshot()``, equal drift counters and the same ``top_offender``;
  ``phase_snapshot``/``phase_breakdown`` agree;
* the profiler keeps a steady-state pass of the port's ``FanoutEngine``
  (64 outputs × 256 packets, the loop and batch-header rungs) within
  the reference's 5% bound (``tests/test_profile.py``: interleaved
  pairs, min of each, up to three rounds);
* a launch inside ``kernel_lib.timed`` records the timer's start event
  just before the first launch and its stop event just after each, and
  nothing around the rest of the call;
* on a two-device mesh where one device holds no row of the wake's first
  bucket, each device's window-call time rides the first bucket that
  device ran and is read only after that device's event is done, in a
  harvest the readiness check allows and in a forced one;
* the bytes an engine's own device ring appends and queries and its
  batch-header rung copy (``ops.staging.COPIED``, counted from the
  copied tensors) equal what its ``tpu_h2d_bytes_total`` and
  ``tpu_d2h_bytes_total`` counted.
"""

import time
import types

import numpy as np
import pytest
import torch

from easydarwin_tpu.obs import ledger as ref_ledger
from easydarwin_tpu.obs import metrics as ref_metrics
from easydarwin_tpu.obs import profile as ref_profile
from easydarwin_tpu_torch.obs import ledger as port_ledger
from easydarwin_tpu_torch.obs import metrics as port_metrics
from easydarwin_tpu_torch.obs import profile as port_profile

SIDES = {"ref": (ref_ledger, ref_metrics, ref_profile),
         "port": (port_ledger, port_metrics, port_profile)}


class Clock:
    """A ``perf_counter_ns`` the test moves."""

    def __init__(self):
        self.ns = 10**12

    def __call__(self):
        return self.ns


def _ledger(side, clock):
    led_mod, met, _ = SIDES[side]
    reg = met.Registry()
    wait = reg.histogram("pump_wait_seconds", "w", labels=("work_class",))
    svc = reg.histogram("pump_service_seconds", "s",
                        labels=("work_class",))
    dfr = reg.counter("pump_deferred_total", "d", labels=("work_class",))
    return led_mod.WorkLedger(wait_hist=wait, service_hist=svc,
                              deferred_counter=dfr, clock_ns=clock,
                              ring=64), reg


def _wake_script(seed: int, n_wakes: int) -> list:
    """Steps: ("begin", wake_offset|None), ("start",), ("end", cls,
    items, trace), ("age", s, n), ("defer", cls, n), ("tick", ns),
    ("close",)."""
    rng = np.random.default_rng(seed)
    classes = list(ref_ledger.WORK_CLASSES)
    steps = []
    for w in range(n_wakes):
        if rng.random() < 0.1:
            steps.append(("defer", classes[int(rng.integers(len(classes)))],
                          int(rng.integers(1, 5))))
        steps.append(("begin", int(rng.integers(0, 5_000_000))
                      if rng.random() < 0.7 else None))
        depth = 0
        for _ in range(int(rng.integers(1, 7))):
            steps.append(("tick", int(rng.integers(1_000, 3_000_000))))
            if depth < 2 and rng.random() < 0.6:
                steps.append(("start",))
                depth += 1
            elif depth:
                if rng.random() < 0.4:
                    steps.append(("age", float(rng.exponential(0.05)),
                                  int(rng.integers(1, 500))))
                steps.append(("end", classes[int(rng.integers(
                    len(classes)))], int(rng.integers(1, 40)),
                    f"{w:08x}" if rng.random() < 0.5 else None))
                depth -= 1
            if rng.random() < 0.05:
                steps.append(("defer", "megabatch", 2))
        while depth:
            steps.append(("tick", 777))
            steps.append(("end", "live_relay", 3, None))
            depth -= 1
        steps.append(("tick", int(rng.integers(1_000, 50_000_000))))
        steps.append(("close",))
    return steps


def _run(side, steps):
    clock = Clock()
    led, reg = _ledger(side, clock)
    toks = []
    for st in steps:
        kind = st[0]
        if kind == "begin":
            led.begin_wake(None if st[1] is None else clock.ns - st[1])
        elif kind == "start":
            toks.append(led.unit_start())
        elif kind == "end":
            led.unit_end(toks.pop(), st[1], items=st[2], trace_id=st[3])
        elif kind == "age":
            led.note_queue_age(st[1], st[2])
        elif kind == "defer":
            led.defer(st[1], st[2])
        elif kind == "tick":
            clock.ns += st[1]
        else:
            led.end_wake()
    return led, reg


@pytest.mark.parametrize("seed", [0, 16, 19])
def test_same_wakes_give_equal_ledger_and_blame(seed):
    steps = _wake_script(seed, 300)
    (rl, rreg), (pl, preg) = (_run(s, steps) for s in SIDES)
    rs, ps = rl.snapshot(), pl.snapshot()
    assert rs == ps
    assert rreg.expose() == preg.expose()
    assert (rl.wakes, rl.last_top_class, rl.last_wake_ms) == \
        (pl.wakes, pl.last_top_class, pl.last_wake_ms)
    assert rl.top_offenders(5) == pl.top_offenders(5)
    for kw in ({}, {"measured_p99_ms": 40.0, "baseline_p50_ms": 5.0},
               {"measured_p99_ms": 0.5}):
        assert ref_ledger.blame_doc(rs, **kw) == \
            port_ledger.blame_doc(ps, **kw)
    assert ref_ledger.suspect_flags(rs) == port_ledger.suspect_flags(ps)
    assert ps["classes"] and ps["wakes"] == 300


def test_disabled_ledgers_record_nothing_alike():
    steps = _wake_script(4, 20)
    out = []
    for side in SIDES:
        clock = Clock()
        led, reg = _ledger(side, clock)
        led.enabled = False
        for st in steps:
            if st[0] == "begin":
                led.begin_wake(None)
            elif st[0] == "start":
                assert led.unit_start() is None
            elif st[0] == "end":
                led.unit_end(None, st[1], items=st[2])
            elif st[0] == "defer":
                led.defer(st[1], st[2])
            elif st[0] == "close":
                led.end_wake()
        out.append((led.snapshot(), reg.expose()))
    assert out[0] == out[1]
    assert out[1][0]["wakes"] == 0


# -------------------------------------------------------------- profiler
def _profiler(side, monkeypatch, clock):
    _, met, prof = SIDES[side]
    monkeypatch.setattr(prof, "time", clock)
    reg = met.Registry()
    hist = reg.histogram("relay_phase_seconds", "p",
                         labels=("engine", "phase"))
    drift = reg.counter("profile_phase_drift_total", "d")
    return prof.PhaseProfiler(hist=hist, drift_counter=drift,
                              max_sessions=8), reg, hist


def _pass_script(seed: int) -> list:
    rng = np.random.default_rng(seed)
    phases = list(ref_profile.PHASES)
    engines = list(ref_profile.ENGINES)
    out = []
    for i in range(400):
        r = rng.random()
        path = f"/cam{int(rng.integers(12))}"
        if r < 0.5:
            ph = {phases[int(rng.integers(len(phases)))]:
                  int(rng.integers(0, 2_000_000))
                  for _ in range(int(rng.integers(1, 4)))}
            total = sum(ph.values()) + int(rng.choice(
                [0, 10_000, 150_000, 900_000, 5_000_000]))
            out.append(("pass", engines[int(rng.integers(len(engines)))],
                        total, ph, path if rng.random() < 0.8 else None,
                        int(rng.integers(0, 10**6)), bool(rng.random() < 0.5),
                        bool(rng.random() < 0.8)))
        elif r < 0.7:
            out.append(("observe", phases[int(rng.integers(len(phases)))],
                        engines[int(rng.integers(len(engines)))],
                        int(rng.integers(-5, 10**7))))
        elif r < 0.95:
            out.append(("latency", path,
                        rng.exponential(0.03, int(rng.integers(0, 60)))))
        else:
            out.append(("compile", f"ed_kernel_{i % 5}",
                        float(rng.random())))
    return out


def test_same_passes_give_equal_profile(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: 1_700_000_000.0)
    profs = {s: _profiler(s, monkeypatch, clock) for s in SIDES}
    for st in _pass_script(9):
        for side, (prof, _reg, _h) in profs.items():
            if st[0] == "pass":
                _, eng, total, ph, path, wb, check, count = st
                prof.account_pass(eng, total, dict(ph), path=path,
                                  wire_bytes=wb, check=check,
                                  count_pass=count)
            elif st[0] == "observe":
                prof.observe(st[1], st[2], st[3])
            elif st[0] == "latency":
                prof.account_latency(st[1], st[2])
            else:
                prof.note_compile(st[1], st[2])
    (rp, rreg, rh), (pp, preg, ph) = profs["ref"], profs["port"]
    assert rp.snapshot(top_n=5) == pp.snapshot(top_n=5)
    assert (rp.drift_checks, rp.drift_violations, rp.last_drift) == \
        (pp.drift_checks, pp.drift_violations, pp.last_drift)
    assert pp.drift_violations > 0 and pp.drift_checks > pp.drift_violations
    assert rreg.expose() == preg.expose()
    assert rp.top_offender() == pp.top_offender() is not None
    assert ref_profile.phase_breakdown(rh) == port_profile.phase_breakdown(ph)
    since = ref_profile.phase_snapshot(rh)
    assert since == port_profile.phase_snapshot(ph)


def test_disabled_profilers_record_nothing_alike(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: 5.0)
    out = []
    for side in SIDES:
        prof, reg, _ = _profiler(side, monkeypatch, clock)
        prof.enabled = False
        for st in _pass_script(2)[:50]:
            if st[0] == "pass":
                prof.account_pass(st[1], st[2], dict(st[3]), path=st[4],
                                  check=True)
            elif st[0] == "latency":
                prof.account_latency(st[1], st[2])
        out.append((prof.snapshot(), reg.expose()))
    assert out[0] == out[1]
    assert out[1][0]["phases"] == {} and out[1][0]["enabled"] is False


# ------------------------------------------------------------- overhead
def test_profiler_overhead_bound_on_the_port_engine():
    """A steady-state pass of the port's engine with the profiler on stays
    within 5% of the pass with it off (interleaved pairs, min of each),
    as the reference bounds its own."""
    from easydarwin_tpu_torch.obs import PROFILER
    from easydarwin_tpu_torch.protocol import sdp
    from easydarwin_tpu_torch.relay.fanout import FanoutEngine
    from easydarwin_tpu_torch.relay.output import CollectingOutput
    from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings

    sdp_txt = ("v=0\r\ns=b\r\nt=0 0\r\nm=video 0 RTP/AVP 96\r\n"
               "a=rtpmap:96 H264/90000\r\na=control:trackID=1\r\n")
    st = RelayStream(sdp.parse(sdp_txt).streams[0],
                     StreamSettings(bucket_delay_ms=0))
    outs = [CollectingOutput(ssrc=i, out_seq_start=i) for i in range(64)]
    for o in outs[:48]:
        st.add_output(o)
    for o in outs[48:]:                  # the batch-header rung too
        o.thinning.level = 1
        st.add_output(o)
    pkt = bytes([0x80, 96]) + bytes(10) + bytes(188)
    for i in range(256):
        st.push_rtp(pkt[:2] + i.to_bytes(2, "big") + pkt[4:], 0)
    eng = FanoutEngine(device="cpu")
    eng.step(st, 10_000)

    def one_pass(enabled: bool) -> float:
        PROFILER.enabled = enabled
        for o in outs:
            o.bookmark = st.rtp_ring.tail
            o.rtp_packets.clear()
        c0 = time.perf_counter()
        eng.step(st, 10_000)
        return time.perf_counter() - c0

    was = PROFILER.enabled
    ratios = []
    try:
        for _ in range(3):
            one_pass(True)
            one_pass(False)
        for _attempt in range(3):
            on, off = [], []
            for _ in range(25):
                on.append(one_pass(True))
                off.append(one_pass(False))
            ratios.append(min(on) / max(min(off), 1e-9))
            if ratios[-1] < 1.05:
                break
    finally:
        PROFILER.enabled = was
    assert min(ratios) < 1.05, f"profiler overhead ratios {ratios}"


# ------------------------------------------------------- device timing
class _FakeEvent:
    """A CUDA event stand-in: ``elapsed_time`` raises, as
    ``cudaEventElapsedTime`` does, unless the work is done."""

    def __init__(self, log=None, name=""):
        self.log, self.name, self.done = log, name, False

    def record(self, _stream=None):
        self.log.append(self.name)

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_launch_records_the_timer_around_the_launch_only(monkeypatch):
    from easydarwin_tpu_torch.ops import kernel_lib, staging
    log = []

    def fake_launch(*args):
        log.append(("launch",) + args)
        return 0

    monkeypatch.setattr(kernel_lib, "library",
                        lambda: types.SimpleNamespace(ed_fake=fake_launch))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *_a: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setitem(kernel_lib.LAUNCHES, "ed_fake", 0)
    timer = staging.DeviceTimer(torch.device("cpu"))
    timer.pair = (_FakeEvent(log, "start"), _FakeEvent(log, "stop"))
    kernel_lib.launch("ed_fake", 1)
    with timer:
        log.append("prepare")
        kernel_lib.launch("ed_fake", 2)
        kernel_lib.launch("ed_fake", 3)
        log.append("after")
    kernel_lib.launch("ed_fake", 4)
    assert log == [("launch", 1, 7), "prepare", "start", ("launch", 2, 7),
                   "stop", ("launch", 3, 7), "stop", "after",
                   ("launch", 4, 7)]
    assert kernel_lib.LAUNCHES["ed_fake"] == 4 and timer.launched
    untimed = staging.DeviceTimer(torch.device("cpu"))
    untimed.pair = timer.pair
    assert untimed.ns() == 0             # launched nothing: no read


class _FakeTimer:
    """A window call's timer whose read fails before its device's event
    has completed."""

    def __init__(self, event):
        self.event, self.reads = event, 0

    def ns(self):
        assert self.event.done, "timer read before its device's work"
        self.reads += 1
        return 2000


def _mesh_wake():
    """A 2-device CPU mesh scheduler after one dispatch of two buckets:
    bucket 0 has one stream (device 1 holds padding only), bucket 1 two
    (one a device)."""
    from easydarwin_tpu_torch.parallel import mesh
    from easydarwin_tpu_torch.protocol import sdp
    from easydarwin_tpu_torch.relay.fanout import FanoutEngine
    from easydarwin_tpu_torch.relay.megabatch import MegabatchScheduler
    from easydarwin_tpu_torch.relay.output import CollectingOutput
    from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings

    sdp_txt = ("v=0\r\ns=b\r\nt=0 0\r\nm=video 0 RTP/AVP 96\r\n"
               "a=rtpmap:96 H264/90000\r\na=control:trackID=1\r\n")
    pairs = []
    for n_out in (4, 9, 9):           # s_pad 8, then 16 and 16
        st = RelayStream(sdp.parse(sdp_txt).streams[0],
                         StreamSettings(bucket_delay_ms=0))
        for i in range(n_out):
            st.add_output(CollectingOutput(ssrc=100 + i, out_seq_start=i))
        for i in range(5):
            st.push_rtp(bytes([0x80, 96]) + i.to_bytes(2, "big")
                        + bytes(8) + bytes([0x65]) + bytes(40), 1000)
        pairs.append((st, FanoutEngine(device="cpu")))
    sched = MegabatchScheduler(
        device="cpu", mesh=mesh.make_megabatch_mesh(
            2, [torch.device("cpu")] * 2))
    sched.begin_wake(pairs, 1000)
    sched.end_wake(pairs, 1000)
    assert len(sched._inflight) == 2
    first, second = sched._inflight
    assert len(first.entries) == 1 and len(second.entries) == 2
    # the real timers: device 0's on bucket 0, device 1's on bucket 1
    assert [t is not None for t in first.timers] == [True, False]
    assert [t is not None for t in second.timers] == [False, True]
    # stand-ins: one event a device, shared by the wake's buckets
    events = [_FakeEvent(), _FakeEvent()]
    timers = [_FakeTimer(events[0]), _FakeTimer(events[1])]
    for inf in sched._inflight:
        for k in range(2):
            ents = inf.entries[k * inf.rows_per:(k + 1) * inf.rows_per]
            inf.event[k] = events[k] if ents else None
            if inf.timers[k] is not None:
                inf.timers[k] = timers[k]
    return sched, events, timers


@pytest.mark.parametrize("forced", [False, True])
def test_mesh_device_time_is_read_after_its_device_event(forced):
    from easydarwin_tpu_torch.obs import PROFILER
    was = PROFILER.enabled
    PROFILER.enabled = True
    try:
        sched, events, timers = _mesh_wake()
        if forced:
            assert sched.drain() == 3
        else:
            events[0].done = True        # device 0 done, device 1 not
            sched._harvest()
            assert [t.reads for t in timers] == [1, 0]
            assert len(sched._inflight) == 1
            events[1].done = True
            sched._harvest()
        assert [t.reads for t in timers] == [1, 1]
        assert not sched._inflight and sched.mismatches == 0
    finally:
        PROFILER.enabled = was


def test_engine_copies_equal_the_byte_counters():
    from easydarwin_tpu_torch import obs
    from easydarwin_tpu_torch.ops import staging
    from easydarwin_tpu_torch.protocol import sdp
    from easydarwin_tpu_torch.relay.fanout import FanoutEngine
    from easydarwin_tpu_torch.relay.output import CollectingOutput
    from easydarwin_tpu_torch.relay.stream import RelayStream, StreamSettings

    sdp_txt = ("v=0\r\ns=b\r\nt=0 0\r\nm=video 0 RTP/AVP 96\r\n"
               "a=rtpmap:96 H264/90000\r\na=control:trackID=1\r\n")
    st = RelayStream(sdp.parse(sdp_txt).streams[0],
                     StreamSettings(bucket_delay_ms=0))
    outs = [CollectingOutput(ssrc=i, out_seq_start=i) for i in range(12)]
    for o in outs[8:]:                   # the batch-header rung
        o.thinning.controller.level = 1
    for o in outs:
        st.add_output(o)
    eng = FanoutEngine(device="cpu")

    def counts():
        return (obs.TPU_H2D_BYTES.total(), obs.TPU_D2H_BYTES.total(),
                staging.COPIED["h2d"], staging.COPIED["d2h"])

    before = counts()
    for wake in range(6):
        for i in range(7):
            seq = wake * 7 + i
            st.push_rtp(bytes([0x80, 96]) + seq.to_bytes(2, "big")
                        + bytes(8) + bytes([0x65 if i == 0 else 0x41])
                        + bytes(60), 1000 + 20 * wake)
        if wake == 3:
            st.add_output(CollectingOutput(ssrc=99, out_seq_start=9))
        eng.step(st, 1000 + 20 * wake)
    h2d, d2h, c_h2d, c_d2h = (a - b for a, b in zip(counts(), before))
    assert eng.dring_appends > 0 and eng.batch_passes > 0
    assert eng.device_param_refreshes > 0
    assert (h2d, d2h) == (c_h2d, c_d2h) and h2d > 0 and d2h > 0
