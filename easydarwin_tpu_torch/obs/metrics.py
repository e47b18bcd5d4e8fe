"""Prometheus-style metrics registry: Counter / Gauge / Histogram.

The reference server's only runtime visibility was the 1 Hz ``-S``
console and the ``server_status`` plist (``RunServer.cpp:397-483``);
everything else — per-datagram syscall efficiency, device-step timing,
real ingest→wire latency — was dark.  This module is the missing layer:
a dependency-free registry whose families expose the standard
`text/plain; version=0.0.4` exposition format, so any Prometheus (or
curl) scrape of ``/metrics`` sees the server account for its own hot
path.

Design notes:

* Families are created once (module import time, see ``families.py``)
  and hold one value cell per label-value tuple.  Label children are
  plain bound handles — no per-observation allocation.
* Histograms use FIXED upper bounds (log-spaced by default).  The hot
  relay paths feed them through ``observe_many`` — one numpy
  ``searchsorted`` + ``bincount`` per pass, never a Python loop per
  packet — which keeps instrumentation overhead far under the 2%%
  budget measured by ``bench.py``.
* ``Registry.collect()`` runs registered collector callbacks before a
  scrape; the native bridge uses one to mirror the C data-plane's
  cumulative ``ed_stats`` snapshot into counter families
  (``Counter.set_to``).

Naming convention (enforced by ``tools/metrics_lint.py``): snake_case,
counters end in ``_total``, histograms and unit-carrying gauges end in
their unit (``_seconds``, ``_bytes``, ``_ratio``), and every family has
help text.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left, bisect_right
from typing import Any, Callable, Iterable

import numpy as np

_NAME_RE_HELP = "metric and label names must match [a-z_][a-z0-9_]*"


def _valid_name(name: str) -> bool:
    if not name or not (name[0].isalpha() or name[0] == "_"):
        return False
    return all(c.isalnum() or c == "_" for c in name) and name == name.lower()


def _escape_label(v: str) -> str:
    """Prometheus text-format label value escaping: backslash, quote,
    newline (in that order, so escapes are not double-escaped)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    """Render a sample value: integers without a trailing .0, floats via
    repr (shortest round-trip), infinities as +Inf/-Inf."""
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _labelstr(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


#: default log-spaced latency bounds: 100 µs … 900 s on a 1-2.5-5 ladder
#: densified through the multi-second regime (a composed-soak
#: 8.1 s p99 must resolve to a bucket, not saturate into (5, 10]), and
#: topped above the SLO watchdog's worst burn window (600 s slow window)
#: so a wait that outlives the entire evaluation horizon still lands in
#: a finite bucket — metrics_lint asserts that ordering.
TIME_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 1.5, 2.5, 4.0, 6.0,
                8.0, 10.0, 15.0, 30.0, 60.0, 120.0, 300.0, 900.0)


def bucket_quantile(counts, total: int, bounds, q: float) -> float:
    """Estimated quantile from per-bucket (NOT cumulative) counts:
    linear interpolation inside the bucket that crosses rank q; 0.0 on
    empty.  The ONE copy of this math — histograms and the profiler's
    per-session latency ladders (obs/profile.py) both resolve here, so
    bucket semantics can never drift between them."""
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            frac = (rank - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += int(c)
    return bounds[-1]


class _Family:
    """Common base: one named metric with a fixed label-name tuple and
    one value cell per observed label-value tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: tuple = ()):
        if not _valid_name(name):
            raise ValueError(f"bad metric name {name!r}: {_NAME_RE_HELP}")
        for ln in labels:
            if not _valid_name(ln):
                raise ValueError(f"bad label name {ln!r}: {_NAME_RE_HELP}")
        if not help:
            raise ValueError(f"metric {name} needs help text")
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        # Mutations are lock-free-looking read-modify-writes; until the
        # requant ladder every observe/inc site was single-writer per
        # key (the pump or one engine thread), so races could not drop
        # counts.  The ladder's pool workers observe the SAME stage/
        # counter keys concurrently — serialize writers per family
        # (uncontended acquire is ~100 ns; the hot relay paths record
        # per PASS, not per packet, so this is noise there).
        self._mu = threading.Lock()

    def _key(self, kv: dict) -> tuple:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}")
        return tuple(str(kv[n]) for n in self.label_names)

    # subclasses: expose_lines() -> list[str], as_value() -> Any


class Counter(_Family):
    """Monotonically increasing count.  ``set_to`` exists only for
    bridging an external cumulative source (the native ``ed_stats``
    snapshot) — never call it with a decreasing value."""

    kind = "counter"

    def __init__(self, name, help, labels=()):
        super().__init__(name, help, labels)
        self._values: dict[tuple, float] = {}
        if not labels:
            self._values[()] = 0

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._mu:
            self._values[key] = self._values.get(key, 0) + amount

    def labels(self, **labels) -> "_BoundCounter":
        return _BoundCounter(self, self._key(labels))

    def set_to(self, value: float, **labels) -> None:
        """Overwrite with an externally-maintained cumulative value."""
        with self._mu:
            self._values[self._key(labels)] = value

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0)

    def total(self) -> float:
        return sum(self._values.values())

    def expose_lines(self) -> list[str]:
        return [f"{self.name}{_labelstr(self.label_names, k)} {_fmt(v)}"
                for k, v in sorted(self._values.items())]

    def as_value(self):
        if not self.label_names:
            return self._values.get((), 0)
        return {",".join(k): v for k, v in sorted(self._values.items())}


class _BoundCounter:
    __slots__ = ("_fam", "_key")

    def __init__(self, fam: Counter, key: tuple):
        self._fam = fam
        self._key = key

    def inc(self, amount: float = 1) -> None:
        fam = self._fam
        with fam._mu:
            fam._values[self._key] = fam._values.get(self._key, 0) \
                + amount


class Gauge(_Family):
    kind = "gauge"

    def __init__(self, name, help, labels=()):
        super().__init__(name, help, labels)
        self._values: dict[tuple, float] = {}
        if not labels:
            self._values[()] = 0

    def set(self, value: float, **labels) -> None:
        with self._mu:
            self._values[self._key(labels)] = value

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._mu:
            self._values[key] = self._values.get(key, 0) + amount

    def dec(self, amount: float = 1, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0)

    def remove(self, **labels) -> None:
        """Drop one label child (a departed session's QoS gauges must not
        linger in the exposition forever)."""
        self._values.pop(self._key(labels), None)

    def expose_lines(self) -> list[str]:
        return [f"{self.name}{_labelstr(self.label_names, k)} {_fmt(v)}"
                for k, v in sorted(self._values.items())]

    def as_value(self):
        if not self.label_names:
            return self._values.get((), 0)
        return {",".join(k): v for k, v in sorted(self._values.items())}


class _HistState:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets    # per-bucket (NOT cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(_Family):
    """Fixed-bound histogram.  ``bounds`` are the finite upper bounds;
    an implicit +Inf bucket is always appended.  Exposition follows the
    Prometheus contract: cumulative ``_bucket{le=...}`` series ending at
    ``le="+Inf"`` whose value equals ``_count``, plus ``_sum``."""

    kind = "histogram"

    def __init__(self, name, help, labels=(), buckets: Iterable[float]
                 = TIME_BUCKETS):
        super().__init__(name, help, labels)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError(f"{name}: need at least one bucket bound")
        self._bounds_arr = np.asarray(self.bounds)
        self._states: dict[tuple, _HistState] = {}

    def _state(self, labels: dict) -> _HistState:
        key = self._key(labels)
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = _HistState(len(self.bounds) + 1)
        return st

    def observe(self, value: float, n: int = 1, **labels) -> None:
        """``n`` is an observation weight (n identical observations in
        one bucket update) — the wake ledger uses it to weight a work
        unit's queue delay by the items the unit serviced, so the wait
        distribution matches the per-item latency the operator measures
        (``n`` is therefore reserved as a label name)."""
        with self._mu:
            st = self._state(labels)
            st.counts[bisect_left(self.bounds, value)] += n
            st.sum += value * n
            st.count += n

    def observe_many(self, values: np.ndarray, **labels) -> None:
        """Vectorized bulk observe — the relay hot paths record one call
        per PASS, not per packet."""
        values = np.asarray(values, dtype=np.float64).ravel()
        if values.size == 0:
            return
        idx = np.searchsorted(self._bounds_arr, values, side="left")
        binned = np.bincount(idx, minlength=len(self.bounds) + 1)
        with self._mu:
            st = self._state(labels)
            for i, c in enumerate(binned):
                if c:
                    st.counts[i] += int(c)
            st.sum += float(values.sum())
            st.count += int(values.size)

    def count(self, **labels) -> int:
        st = self._states.get(self._key(labels))
        return st.count if st else 0

    def total_count(self) -> int:
        return sum(st.count for st in self._states.values())

    def total_sum(self) -> float:
        return sum(st.sum for st in self._states.values())

    def count_above(self, threshold: float) -> int:
        """Observations above ``threshold``, merged over all label
        children, at bucket resolution: only buckets whose (inclusive)
        upper bound is <= threshold count as good, so a threshold BETWEEN
        bounds counts the whole straddling bucket as *bad* — the
        conservative direction for an SLO source.  Put thresholds on a
        bucket bound for exact semantics.  Cumulative, O(buckets)."""
        cut = bisect_right(self.bounds, threshold)
        bad = 0
        # list() is one C-level op: safe against a concurrent engine
        # thread inserting a new label child mid-scan
        for st in list(self._states.values()):
            bad += st.count - sum(st.counts[:cut])
        return bad

    def quantile(self, q: float) -> float:
        """Estimated quantile over ALL label children merged (status
        mirror convenience).  Returns 0.0 on an empty histogram."""
        merged = [0] * (len(self.bounds) + 1)
        total = 0
        for st in list(self._states.values()):
            total += st.count
            for i, c in enumerate(st.counts):
                merged[i] += c
        return bucket_quantile(merged, total, self.bounds, q)

    def expose_lines(self) -> list[str]:
        lines = []
        for key, st in sorted(self._states.items()):
            cum = 0
            for bound, c in zip(self.bounds, st.counts):
                cum += c
                ls = _labelstr(self.label_names + ("le",),
                               key + (_fmt(float(bound)),))
                lines.append(f"{self.name}_bucket{ls} {cum}")
            ls = _labelstr(self.label_names + ("le",), key + ("+Inf",))
            lines.append(f"{self.name}_bucket{ls} {st.count}")
            lines.append(
                f"{self.name}_sum{_labelstr(self.label_names, key)} "
                f"{_fmt(st.sum)}")
            lines.append(
                f"{self.name}_count{_labelstr(self.label_names, key)} "
                f"{st.count}")
        return lines

    def as_value(self):
        out = {}
        for key, st in sorted(self._states.items()):
            out[",".join(key) or "_"] = {
                "count": st.count, "sum": round(st.sum, 6),
                "p50": round(self._child_quantile(st, 0.5), 6),
                "p99": round(self._child_quantile(st, 0.99), 6)}
        if not self.label_names:
            return out.get("_", {"count": 0, "sum": 0.0,
                                 "p50": 0.0, "p99": 0.0})
        return out

    def _child_quantile(self, st: _HistState, q: float) -> float:
        return bucket_quantile(st.counts, st.count, self.bounds, q)


class Registry:
    """Named family set + exposition.  One process-wide default lives in
    ``families.py``; tests build private instances freely."""

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._collectors: list[Callable[[], None]] = []
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------
    def register(self, fam: _Family) -> _Family:
        with self._lock:
            if fam.name in self._families:
                raise ValueError(f"duplicate metric family {fam.name}")
            self._families[fam.name] = fam
        return fam

    def counter(self, name, help, labels=()) -> Counter:
        return self.register(Counter(name, help, labels))

    def gauge(self, name, help, labels=()) -> Gauge:
        return self.register(Gauge(name, help, labels))

    def histogram(self, name, help, labels=(),
                  buckets=TIME_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help, labels, buckets))

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a pre-scrape callback (pull external cumulative
        sources — the native ``ed_stats`` bridge — into families)."""
        self._collectors.append(fn)

    # -- read side ---------------------------------------------------
    def get(self, name: str) -> _Family:
        return self._families[name]

    def families(self) -> list[_Family]:
        return sorted(self._families.values(), key=lambda f: f.name)

    def collect(self) -> None:
        for fn in self._collectors:
            try:
                fn()
            except Exception:
                pass                 # a scrape must never take the server down

    def expose(self) -> str:
        """Prometheus text exposition format 0.0.4: per family, # HELP
        then # TYPE then every sample line, families sorted by name."""
        self.collect()
        out = []
        for fam in self.families():
            help_text = fam.help.replace("\\", "\\\\").replace("\n", "\\n")
            out.append(f"# HELP {fam.name} {help_text}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            out.extend(fam.expose_lines())
        return "\n".join(out) + "\n"

    def as_tree(self) -> dict[str, Any]:
        """{family name: plain value} — the admin AttrStore view."""
        self.collect()
        return {fam.name: fam.as_value() for fam in self.families()}
