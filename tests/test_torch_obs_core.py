"""The port's ``obs`` core (metrics, families, trace, events, flight, SLO,
profile's pprof export, fleet's vocabulary) against the reference's, on
the CPU.

* the family inventories are equal: every name, kind, label set, help
  string and bucket bound (two reference help strings cite entries of
  the reference's own tracker; the port's drop the citations:
  ``TRACKER_REFS``, applied to the reference's text);
* the closed vocabularies are equal: ``PHASES``, ``ENGINES``,
  ``WORK_CLASSES``, ``events.SCHEMA``, ``FLEET_TIERS``, the audience
  tiers, ``TIME_BUCKETS`` and ``QOE_BUCKETS``;
* the same seeded sequence of ``inc``/``set``/``set_to``/``remove``/
  ``observe``/``observe_many`` into a fresh registry of every family of
  each package gives a byte-identical ``expose()``, equal quantiles and
  an equal ``as_tree()``;
* the same spans give byte-identical ``build_pprof`` output, and the same
  events byte-identical NDJSON pages, under a pinned clock;
* a session's flight dump (events, spans, node id) is equal, file and
  document, under a pinned clock;
* the SLO flag's ``dump_path`` over a stream's sessions is equal, files
  and documents, from one pass over the span ring, and the port opens no
  file on the calling thread;
* the SLO watchdog's burn windows, budget gauges, violations and
  recoveries are equal over the same latency history and clock.

Every test builds private instances or pins the process-global ones and
restores them, so the order of tests does not matter.
"""

import json
import re
import threading
import types

import numpy as np
import pytest

from easydarwin_tpu import obs as ref_obs
from easydarwin_tpu.obs import audience as ref_audience
from easydarwin_tpu.obs import events as ref_events
from easydarwin_tpu.obs import families as ref_families
from easydarwin_tpu.obs import fleet as ref_fleet
from easydarwin_tpu.obs import flight as ref_flight
from easydarwin_tpu.obs import ledger as ref_ledger
from easydarwin_tpu.obs import metrics as ref_metrics
from easydarwin_tpu.obs import profile as ref_profile
from easydarwin_tpu.obs import slo as ref_slo
from easydarwin_tpu.obs import trace as ref_trace
from easydarwin_tpu_torch import obs as port_obs
from easydarwin_tpu_torch.obs import audience as port_audience
from easydarwin_tpu_torch.obs import events as port_events
from easydarwin_tpu_torch.obs import families as port_families
from easydarwin_tpu_torch.obs import fleet as port_fleet
from easydarwin_tpu_torch.obs import flight as port_flight
from easydarwin_tpu_torch.obs import ledger as port_ledger
from easydarwin_tpu_torch.obs import metrics as port_metrics
from easydarwin_tpu_torch.obs import profile as port_profile
from easydarwin_tpu_torch.obs import slo as port_slo
from easydarwin_tpu_torch.obs import trace as port_trace

#: reference help text → the port's: the citations of the reference's own
#: tracker entries ("(<TRACKER> <n>: ..." and "the <TRACKER> <n> ...")
TRACKER_REFS = ((re.compile(r"\((?:[A-Z]{2}|[A-Z]{5}) \d+: "), "("),
                (re.compile(r"\(the (?:[A-Z]{2}|[A-Z]{5}) \d+ "), "(the "))

SIDES = ("ref", "port")
MODS = {
    "ref": types.SimpleNamespace(
        obs=ref_obs, metrics=ref_metrics, families=ref_families,
        trace=ref_trace, events=ref_events, flight=ref_flight,
        profile=ref_profile, slo=ref_slo),
    "port": types.SimpleNamespace(
        obs=port_obs, metrics=port_metrics, families=port_families,
        trace=port_trace, events=port_events, flight=port_flight,
        profile=port_profile, slo=port_slo),
}


def norm_help(text: str) -> str:
    for pattern, repl in TRACKER_REFS:
        text = pattern.sub(repl, text)
    return text


def _fams(side: str) -> list:
    m = MODS[side]
    return sorted((v for v in vars(m.families).values()
                   if isinstance(v, m.metrics._Family)),
                  key=lambda f: f.name)


def _inventory(side: str) -> dict:
    return {f.name: (f.kind, f.label_names, norm_help(f.help),
                     getattr(f, "bounds", None)) for f in _fams(side)}


class FakeClock:
    """Pinned ``time`` for a module: every read is the set value."""

    def __init__(self, t: float = 1_700_000_000.0):
        self.t = t

    def time(self):
        return self.t

    def time_ns(self):
        return int(self.t * 1e9)

    def monotonic(self):
        return self.t

    def perf_counter_ns(self):
        return int(self.t * 1e9)

    def perf_counter(self):
        return self.t

    def strftime(self, *a):
        return "pinned"


# ----------------------------------------------------------- inventories
def test_family_inventories_are_equal():
    ref, port = _inventory("ref"), _inventory("port")
    assert len(ref) > 100
    assert ref == port
    # the port's process registry holds the inventory and nothing else
    assert {f.name for f in port_obs.REGISTRY.families()} == set(port)
    # two help strings differ, by their citations alone
    differ = [f.name for f in _fams("ref") if norm_help(f.help) != f.help]
    assert len(differ) == 2
    for f in _fams("port"):
        assert norm_help(f.help) == f.help


@pytest.mark.parametrize("name", [
    "PHASES", "ENGINES", "WORK_CLASSES", "SCHEMA", "FLEET_TIERS",
    "AUDIENCE_TIERS", "TIME_BUCKETS", "QOE_BUCKETS", "LEVELS",
    "RESERVED_KEYS"])
def test_closed_vocabularies_are_equal(name):
    where = {"PHASES": "profile", "ENGINES": "profile",
             "WORK_CLASSES": "ledger", "SCHEMA": "events",
             "FLEET_TIERS": "fleet", "AUDIENCE_TIERS": "audience",
             "TIME_BUCKETS": "metrics", "QOE_BUCKETS": "audience",
             "LEVELS": "events", "RESERVED_KEYS": "events"}[name]
    ref_mod = {"profile": ref_profile, "ledger": ref_ledger,
               "events": ref_events, "fleet": ref_fleet,
               "audience": ref_audience, "metrics": ref_metrics}[where]
    port_mod = {"profile": port_profile, "ledger": port_ledger,
                "events": port_events, "fleet": port_fleet,
                "audience": port_audience, "metrics": port_metrics}[where]
    assert getattr(ref_mod, name) == getattr(port_mod, name)
    # the package re-exports name the same objects
    if hasattr(ref_obs, name):
        assert getattr(port_obs, name) == getattr(ref_obs, name)


def test_package_reexports_are_equal():
    assert sorted(n for n in dir(ref_obs) if not n.startswith("_")) == \
        sorted(n for n in dir(port_obs) if not n.startswith("_"))


# ------------------------------------------------------------ exposition
def _fresh_registry(side: str):
    """A private registry holding a fresh copy of every family."""
    m = MODS[side]
    reg = m.metrics.Registry()
    for f in _fams(side):
        if f.kind == "histogram":
            reg.histogram(f.name, f.help, f.label_names, f.bounds)
        elif f.kind == "counter":
            reg.counter(f.name, f.help, f.label_names)
        else:
            reg.gauge(f.name, f.help, f.label_names)
    return reg


#: label values, escapes included
LABEL_VALUES = ("a", "b", "x y", 'q"uote', "back\\slash", "new\nline", "7")


def _drive(reg, ops) -> None:
    for name, op, labels, arg in ops:
        fam = reg.get(name)
        getattr(fam, op)(*arg, **labels)


def _ops(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    fams = _fams("port")
    ops = []
    for _ in range(n):
        f = fams[int(rng.integers(len(fams)))]
        labels = {ln: LABEL_VALUES[int(rng.integers(len(LABEL_VALUES)))]
                  for ln in f.label_names}
        if f.kind == "counter":
            if rng.random() < 0.8:
                ops.append((f.name, "inc", labels,
                            (float(rng.choice([1, 2.5, 1e-7, 3e9])),)))
            else:
                ops.append((f.name, "set_to", labels,
                            (float(rng.integers(0, 10**6)),)))
        elif f.kind == "gauge":
            r = rng.random()
            if r < 0.5:
                ops.append((f.name, "set", labels,
                            (float(rng.normal() * 10.0 ** int(rng.integers(-6, 7))),)))
            elif r < 0.7:
                ops.append((f.name, "inc", labels, (1.5,)))
            elif r < 0.85:
                ops.append((f.name, "dec", labels, (0.25,)))
            else:
                ops.append((f.name, "remove", labels, ()))
        else:
            if rng.random() < 0.5:
                ops.append((f.name, "observe", labels,
                            (float(rng.exponential(0.05)),
                             int(rng.integers(1, 4)))))
            else:
                vals = rng.exponential(0.2, int(rng.integers(1, 50)))
                ops.append((f.name, "observe_many", labels, (vals,)))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 19])
def test_same_sequence_gives_byte_identical_exposition(seed):
    ops = _ops(seed, 1500)
    regs = {side: _fresh_registry(side) for side in SIDES}
    for reg in regs.values():
        _drive(reg, ops)
    ref_text = norm_help(regs["ref"].expose())
    port_text = regs["port"].expose()
    assert ref_text == port_text
    assert regs["ref"].as_tree() == regs["port"].as_tree()
    for f in _fams("port"):
        if f.kind != "histogram":
            continue
        a, b = regs["ref"].get(f.name), regs["port"].get(f.name)
        assert a.total_count() == b.total_count()
        for q in (0.5, 0.9, 0.99):
            assert a.quantile(q) == b.quantile(q)
        assert a.count_above(0.05) == b.count_above(0.05)


def test_bucket_quantile_is_equal():
    rng = np.random.default_rng(7)
    bounds = ref_metrics.TIME_BUCKETS
    for _ in range(200):
        counts = rng.integers(0, 50, len(bounds) + 1)
        total = int(counts.sum())
        q = float(rng.random())
        assert ref_metrics.bucket_quantile(counts, total, bounds, q) == \
            port_metrics.bucket_quantile(counts, total, bounds, q)


# ----------------------------------------------------------------- pprof
def _spans(seed: int) -> list:
    rng = np.random.default_rng(seed)
    names = ["engine.step", "megabatch.dispatch", "megabatch.prime",
             "rtsp.setup", "rtsp.play", "rtsp.describe"]
    cats = ["tpu", "rtsp", "relay"]
    t = 10**9
    out = []
    for _ in range(300):
        t += int(rng.integers(1_000, 2_000_000))
        out.append((names[int(rng.integers(len(names)))],
                    int(t), int(rng.integers(500, 3_000_000)),
                    cats[int(rng.integers(len(cats)))],
                    {"trace_id": f"{int(rng.integers(4)):016x}"}))
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_same_spans_give_byte_identical_pprof(seed, monkeypatch):
    clock = FakeClock()
    blobs = {}
    for side in SIDES:
        m = MODS[side]
        monkeypatch.setattr(m.profile, "time", clock)
        tracer = m.trace.SpanTracer()
        for name, t0, dur, cat, args in _spans(seed):
            tracer.add(name, t0, dur, cat, **args)
        blobs[side] = m.profile.build_pprof(tracer)
    assert blobs["ref"] == blobs["port"]


# ---------------------------------------------------------------- events
def _event_script(seed: int) -> list:
    rng = np.random.default_rng(seed)
    names = list(ref_events.SCHEMA)
    out = []
    for i in range(120):
        ev = names[int(rng.integers(len(names)))]
        fields = {k: int(rng.integers(100)) for k in ref_events.SCHEMA[ev]}
        if rng.random() < 0.1:
            fields.pop(next(iter(fields)), None)       # invalid: missing
        if rng.random() < 0.05:
            fields["seq"] = 5                          # a reserved key
        level = ("info", "warn", "error", "debug", "bogus")[
            int(rng.integers(5))]
        out.append((ev, level, f"s{i % 7}" if i % 3 else None,
                    "/cam" if i % 2 else None, f"t{i % 5}", fields))
    out.append(("not.in.schema", "info", None, None, None, {}))
    return out


def test_events_give_byte_identical_ndjson(monkeypatch):
    clock = FakeClock()
    logs = {}
    for side in SIDES:
        m = MODS[side]
        monkeypatch.setattr(m.events, "time", clock)
        monkeypatch.setitem(m.events.NODE, "id", "node-a")
        monkeypatch.setitem(m.events.NODE, "fence", 3)
        logs[side] = m.events.EventLog(capacity=64)
    for ev, level, sid, stream, trace, fields in _event_script(5):
        clock.t += 0.123456789
        for side in SIDES:
            logs[side].emit(ev, level=level, session_id=sid, stream=stream,
                            trace_id=trace, **dict(fields))
    assert logs["ref"].seq == logs["port"].seq == 121
    assert logs["ref"].dropped == logs["port"].dropped > 0
    for n, since in ((None, None), (10, None), (10, 70), (500, 100),
                     (0, None), (5, 200)):
        a = logs["ref"].dump_lines(n, since)
        b = logs["port"].dump_lines(n, since)
        assert a == b, (n, since)
    assert any('"invalid":true' in ln for ln in logs["port"].dump_lines())


# ---------------------------------------------------------------- flight
def test_flight_dump_is_equal(tmp_path, monkeypatch):
    clock = FakeClock(1_700_000_123.5)
    docs, files = {}, {}
    trace = "f1f2f3f4f5f6f7f8"
    for side in SIDES:
        m = MODS[side]
        monkeypatch.setattr(m.events, "time", clock)
        monkeypatch.setattr(m.flight, "time", clock)
        monkeypatch.setitem(m.events.NODE, "id", "edge-7")
        monkeypatch.setitem(m.events.NODE, "fence", 2)
        rec = m.flight.FlightRecorder(str(tmp_path / side))
        log = m.events.EventLog()
        log.add_sink(rec.on_event)
        rec.register("abc123", trace_id=trace, client_ip="10.0.0.5",
                     path="/cam")
        for i, ev in enumerate(("rtsp.setup", "rtsp.play",
                                "stream.output_add", "rtsp.error")):
            fields = {k: i for k in m.events.SCHEMA[ev]}
            log.emit(ev, session_id="abc123", stream="/cam",
                     trace_id=trace, **fields)
        log.emit("rtsp.play", session_id="other", status=200)
        m.trace.TRACER.add("rtsp.setup", 5_000, 1_234, cat="rtsp",
                           trace_id=trace, extra=1)
        m.trace.TRACER.add("engine.step", 9_000, 77, cat="tpu",
                           trace_id=trace)
        live = rec.lookup("abc123")
        assert live["live"] is True
        doc = rec.dump("abc123", reason="timeout: idle")
        assert rec.lookup("abc123") is doc
        assert rec.dump("abc123", reason="again") is None
        if side == "port":
            rec.flush()                 # its writer thread writes the file
        path = doc.pop("file")
        files[side] = (path.split("/")[-1], open(path).read())
        for s in doc["spans"]:
            s.pop("tid")
        docs[side] = doc
    assert docs["ref"] == docs["port"]
    assert files["ref"][0] == files["port"][0] \
        == "flight_edge-7_abc123_1700000123.json"
    a, b = (json.loads(files[s][1]) for s in SIDES)
    for d in (a, b):
        for s in d["spans"]:
            s.pop("tid")
    assert a == b and a["events"] and len(a["spans"]) >= 2


def test_flight_dump_path_is_equal_and_writes_off_the_caller(tmp_path,
                                                             monkeypatch):
    """The SLO flag's ``dump_path`` over a stream's sessions: the port's
    documents and files equal the reference's, its span summaries come
    from one pass over the span ring, and no file is opened on the
    calling thread (the event loop); ``flush`` waits for them."""
    import builtins
    clock = FakeClock(1_700_000_321.5)
    docs, files = {}, {}
    caller = threading.get_ident()
    opened, scans = [], []
    for side in SIDES:
        m = MODS[side]
        monkeypatch.setattr(m.events, "time", clock)
        monkeypatch.setattr(m.flight, "time", clock)
        monkeypatch.setitem(m.events.NODE, "id", "edge-3")
        monkeypatch.setitem(m.events.NODE, "fence", 1)
        rec = m.flight.FlightRecorder(str(tmp_path / side))
        log = m.events.EventLog()
        log.add_sink(rec.on_event)
        sids = [f"s{i}" for i in range(5)]
        for i, sid in enumerate(sids):
            rec.register(sid, trace_id=f"t{i}" if i != 3 else None,
                         client_ip="10.0.0.9",
                         path="/cam" if i != 4 else "/other")
            for j, ev in enumerate(("rtsp.setup", "rtsp.play")):
                fields = {k: i + j for k in m.events.SCHEMA[ev]}
                log.emit(ev, session_id=sid, stream="/cam",
                         trace_id=f"t{i}", **fields)
        for k in range(40):
            m.trace.TRACER.add("engine.step", 1_000 * k, 50 + k, cat="tpu",
                               trace_id=f"t{k % 6}", extra=k)
        if side == "port":
            def tracked_open(*a, **kw):
                opened.append(threading.get_ident())
                return builtins.open(*a, **kw)
            monkeypatch.setattr(m.flight, "open", tracked_open,
                                raising=False)
            records = m.flight.TRACER.records

            def counted_records():
                scans.append(1)
                return records()
            monkeypatch.setattr(m.flight.TRACER, "records", counted_records)
        flagged = rec.dump_path("/cam", reason="slo: latency burn 20.0x")
        assert flagged == sids[:4]
        if side == "port":
            assert len(scans) == 1
            rec.flush()
            assert opened and caller not in opened
        got = {}
        for sid in flagged:
            doc = dict(rec.lookup(sid))
            assert doc.pop("live") is True
            dumped = dict(rec.dumps[sid])
            path = dumped.pop("file")
            files.setdefault(side, {})[sid] = (
                path.split("/")[-1], json.loads(open(path).read()))
            for d in (dumped, files[side][sid][1]):
                for sp in d["spans"]:
                    sp.pop("tid")
            got[sid] = dumped
        docs[side] = got
    assert docs["ref"] == docs["port"]
    assert files["ref"] == files["port"]
    assert files["port"]["s0"][0] == "flight_edge-3_s0_1700000321.json"
    assert len(docs["port"]["s1"]["spans"]) == 7
    assert docs["port"]["s3"]["spans"] == []


# ------------------------------------------------------------------- SLO
def _slo(side, clock, monkeypatch):
    m = MODS[side]
    reg = m.metrics.Registry()
    lat = reg.histogram("lat", "l", labels=("engine",))
    viol = reg.counter("v", "v", labels=("slo",))
    gauge = reg.gauge("g", "g", labels=("slo",))
    send_err = reg.counter("send_err", "e")
    oversize = reg.counter("oversize", "o")
    monkeypatch.setattr(m.families, "EGRESS_SEND_ERRORS", send_err)
    monkeypatch.setattr(m.families, "INGEST_OVERSIZE_DROPPED", oversize)
    monkeypatch.setattr(m.events, "time", clock)
    monkeypatch.setitem(m.events.NODE, "id", None)  # a started server's
    log = m.events.EventLog()
    rec = m.flight.FlightRecorder("/nonexistent")
    cfg = m.slo.SloConfig(latency_objective_ms=50.0, latency_target=0.99,
                          drop_objective=0.01, fast_window_s=60.0,
                          slow_window_s=600.0, fast_burn=14.0,
                          slow_burn=2.0, min_events=200)
    dog = m.slo.SloWatchdog(cfg, clock=clock.monotonic, latency_hist=lat,
                            offender=lambda: "/cam", flight=rec, events=log,
                            violations=viol, budget_gauge=gauge)
    return dog, lat, send_err, gauge, viol, log


def test_slo_burn_windows_are_equal(monkeypatch):
    clock = FakeClock(1000.0)
    sides = {side: _slo(side, clock, monkeypatch) for side in SIDES}
    rng = np.random.default_rng(11)
    history = []
    for sec in range(900):
        clock.t = 1000.0 + sec
        # a burst of late packets between 300 and 420 s, drops at 500 s
        n = int(rng.integers(50, 400))
        late_frac = 0.5 if 300 <= sec < 420 else 0.001
        vals = np.where(rng.random(n) < late_frac,
                        rng.uniform(0.06, 2.0, n), rng.uniform(0, 0.04, n))
        errs = 40 if sec == 500 else 0
        out = {}
        for side, (dog, lat, send_err, gauge, viol, log) in sides.items():
            lat.observe_many(vals, engine="native")
            if errs:
                send_err.inc(errs)
            fired = dog.tick()
            out[side] = ([(r["event"], r["slo"], r["burn"]) for r in fired],
                         dog.status(), gauge.value(slo="latency"),
                         gauge.value(slo="drops"))
        assert out["ref"] == out["port"], sec
        history.append(out["port"])
    ref_dog, port_dog = sides["ref"][0], sides["port"][0]
    assert ref_dog.violations == port_dog.violations >= 1
    assert sides["ref"][5].dump_lines() == sides["port"][5].dump_lines()
    assert any(h[0] for h in history)
    assert sides["port"][4].value(slo="latency") >= 1
