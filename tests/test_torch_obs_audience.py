"""The port's audience store (the columnar per-subscriber QoE observatory)
against the reference's, on the CPU.

Both stores take the same seeded history under a pinned clock: streams of
several tiers, subscribers joining and leaving (rows freed and reused,
blocks grown), egress passes with drops, late packets and frozen gaps
(``note_pass``), RTX and FEC credits (``note_credit``), and a stall storm
(most subscribers of one stream going silent at once) with its recovery.
After every 1 Hz ``tick`` the ``rollup``, the ``snapshot`` (worst 3) and
the audience families' exposition are equal, floats within 1e-9
relative and everything else exactly; ``suspect_flags`` of both agree;
a disabled store records nothing on either side.
"""

import math
import types

import numpy as np
import pytest

from easydarwin_tpu.obs import audience as ref_audience
from easydarwin_tpu.obs import metrics as ref_metrics
from easydarwin_tpu_torch.obs import audience as port_audience
from easydarwin_tpu_torch.obs import metrics as port_metrics

SIDES = {"ref": (ref_audience, ref_metrics),
         "port": (port_audience, port_metrics)}


def _store(side, monkeypatch, clock):
    aud, met = SIDES[side]
    monkeypatch.setattr(aud, "time", clock)
    reg = met.Registry()
    fams = {"qoe": reg.histogram("audience_qoe_score", "q",
                                 labels=("tier",), buckets=aud.QOE_BUCKETS),
            "stall": reg.counter("audience_stall_seconds_total", "s",
                                 labels=("tier",)),
            "subs": reg.gauge("audience_subscribers", "n",
                              labels=("tier", "band")),
            "storms": reg.counter("audience_stall_storms_total", "t")}
    store = aud.AudienceStore(families=fams)
    store.enabled = True
    store.fresh_slo_s = 0.05
    store.stall_gap_s = 2.0
    store.storm_window_s = 10.0
    return store, reg


def _close(a, b, path="") -> None:
    """Equal, floats within 1e-9 relative."""
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12), (path, a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


class _Stream:
    """What the store reads of a relay stream (weakly referenced)."""

    def __init__(self, path, track, tier):
        self.session_path = path
        self.trace_id = f"tr{track}"
        self.info = types.SimpleNamespace(track_id=track)
        self.audience = None
        self.audience_tier = tier


def _stream(path, track, tier):
    return _Stream(path, track, tier)


@pytest.mark.parametrize("seed", [0, 18])
def test_same_history_gives_equal_audience(seed, monkeypatch):
    clock = types.SimpleNamespace(t_ns=10**13)
    clock.perf_counter_ns = lambda: clock.t_ns
    clock.time = lambda: 1_700_000_000.0 + clock.t_ns / 1e9
    stores = {s: _store(s, monkeypatch, clock) for s in SIDES}
    rng = np.random.default_rng(seed)
    specs = [("/cam", 1, "live"), ("/cam", 2, "live"), ("/pull1", 1, "pull"),
             ("/vod.mp4", 1, "vod"), ("/cam.dvr", 1, "dvr"),
             ("/hls", 1, "hls"), ("/odd", 1, "bogus")]
    streams = {s: [_stream(*sp) for sp in specs] for s in SIDES}
    outs = {s: [] for s in SIDES}          # (stream index, output, next pid)
    flags_seen = []
    for sec in range(90):
        # joins and leaves (control plane)
        for _ in range(int(rng.integers(0, 6))):
            k = int(rng.integers(len(specs)))
            sid = f"s{sec}_{int(rng.integers(1000))}"
            for s in SIDES:
                o = types.SimpleNamespace(session_id=sid)
                stores[s][0].register(streams[s][k], o)
                outs[s].append([k, o, int(rng.integers(0, 50))])
        for _ in range(int(rng.integers(0, 3))):
            if outs["port"]:
                j = int(rng.integers(len(outs["port"])))
                for s in SIDES:
                    stores[s][0].unregister(outs[s][j][1])
                    outs[s].pop(j)
        # storm: stream 0's subscribers freeze from 40 s to 60 s
        for step in range(10):
            clock.t_ns += 100_000_000
            wire_ns = clock.t_ns
            for k in range(len(specs)):
                members = [i for i, e in enumerate(outs["port"])
                           if e[0] == k]
                if not members or (k == 0 and 40 <= sec < 60):
                    continue
                take = [i for i in members if rng.random() < 0.9]
                if not take:
                    continue
                rows_i, pkts, byts, first, last, lats = [], [], [], [], [], []
                for i in take:
                    n = int(rng.integers(1, 12))
                    gap = int(rng.integers(0, 3)) if rng.random() < 0.2 else 0
                    p0 = outs["port"][i][2] + gap
                    pkts.append(n)
                    byts.append(n * 1300)
                    first.append(p0)
                    last.append(p0 + n - 1 + (1 if rng.random() < 0.1
                                              else 0))
                    lats.append(rng.exponential(0.02, n))
                    for s in SIDES:
                        outs[s][i][2] = last[-1] + 1
                    rows_i.append(i)
                lat = np.concatenate(lats)
                for s in SIDES:
                    blk = streams[s][k].audience
                    rows = [outs[s][i][1].audience_row for i in rows_i]
                    stores[s][0].note_pass(blk, rows, pkts, byts, first,
                                           last, lat, wire_ns)
            # repair credits on a cold path
            if rng.random() < 0.3 and outs["port"]:
                j = int(rng.integers(len(outs["port"])))
                rtx, fec = int(rng.integers(0, 4)), int(rng.integers(0, 3))
                for s in SIDES:
                    stores[s][0].note_credit(outs[s][j][1], rtx=rtx, fec=fec)
        docs = {}
        for s in SIDES:
            store, reg = stores[s]
            store.tick()
            docs[s] = (store.rollup(), store.snapshot(worst_n=3),
                       reg.expose(), store.ticks)
        _close(docs["ref"][0], docs["port"][0], f"rollup@{sec}")
        _close(docs["ref"][1], docs["port"][1], f"snapshot@{sec}")
        _close(docs["ref"][3], docs["port"][3])
        ra, pa = docs["ref"][2], docs["port"][2]
        assert ra.splitlines()[:2] == pa.splitlines()[:2]
        _close([_parse_samples(ra)], [_parse_samples(pa)], f"expose@{sec}")
        flags = port_audience.suspect_flags(docs["port"][0])
        assert flags == ref_audience.suspect_flags(docs["ref"][0])
        flags_seen.append(flags)
    roll = docs["port"][0]
    assert roll["stall_storms"] >= 1 and roll["subscribers"] > 0
    assert any(flags_seen)


def _parse_samples(text: str) -> dict:
    out = {}
    for ln in text.splitlines():
        if ln.startswith("#"):
            continue
        key, val = ln.rsplit(" ", 1)
        out[key] = float(val)
    return out


def test_disabled_stores_record_nothing_alike(monkeypatch):
    clock = types.SimpleNamespace(perf_counter_ns=lambda: 10**12,
                                  time=lambda: 5.0)
    out = []
    for s in SIDES:
        store, reg = _store(s, monkeypatch, clock)
        store.enabled = False
        st = _stream("/cam", 1, "live")
        o = types.SimpleNamespace(session_id="x")
        assert store.register(st, o) == -1
        store.note_pass(None, [0], [3], [100], [0], [2], None, 10**12)
        store.note_credit(o, rtx=2)
        store.tick()
        out.append((store.rollup(), store.snapshot(), reg.expose()))
    _close(out[0][:2], out[1][:2])
    assert out[0][2] == out[1][2]
