"""SLO watchdog: multi-window burn-rate budgets over the obs families.

The profiler (``obs.profile``) says *where* time goes; this module says
*when that became a problem* — continuously, in-server, without a human
watching Grafana.  Two objectives ship by default:

* **latency** — fraction of relayed packets whose in-server ingest→wire
  latency (``relay_ingest_to_wire_seconds``) stays under the configured
  objective (``slo_latency_objective_ms``, target ``slo_latency_target``
  of packets good).
* **drops** — hard egress errors + oversize ingest drops as a fraction
  of wire packets, budgeted by ``slo_drop_objective``.

Evaluation follows the standard multi-window, multi-burn-rate recipe
(SRE workbook ch.5): a violation needs BOTH the fast window (page-fast,
noise-immune because the slow window must agree) and the slow window
(sustained, not a blip) to burn error budget faster than their
thresholds.  Cumulative counters make windows cheap: the watchdog keeps
one (timestamp, good/bad) sample per tick in a deque and differences
against the sample nearest each window edge — O(ticks-in-window) memory,
O(1) math, no per-packet work ever.

On a violation the watchdog

1. emits ONE schema'd ``slo.violation`` event (rising-edge latched: a
   burn that persists does not storm the event log; re-fires only after
   ``cooldown_s`` — default the fast window — of continued burn), and a
   matching ``slo.recover`` on the falling edge;
2. counts ``slo_violations_total{slo}``;
3. flags the worst-offending session's flight recorder (the profiler's
   top-p99 path) so an abnormal-QUALITY session gets the same black-box
   dump an abnormal-teardown one does — retrievable via
   ``command=flight`` / ``GET /api/v1/sessions/<id>/trace``.

``slo_budget_remaining_ratio{slo}`` exports how much of the slow
window's error budget is left (1 = untouched, ≤0 = exhausted); the soak
harness fails on either signal.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from . import families
from .events import EVENTS
from .flight import FLIGHT


@dataclass(frozen=True)
class SloConfig:
    """Budget knobs (mirrored 1:1 from the ``slo_*`` ServerConfig keys —
    see ARCHITECTURE.md "Phase attribution & SLO")."""

    latency_objective_ms: float = 50.0   # a good packet reaches the wire
    latency_target: float = 0.99         # …for this fraction of packets
    drop_objective: float = 0.01         # budgeted bad-packet fraction
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn: float = 14.0              # burn-rate thresholds (workbook
    slow_burn: float = 2.0               # 1h/5m page tier, scaled down)
    cooldown_s: float = 0.0              # 0 = one fast window
    #: a window with fewer total events is never evaluated — on a
    #: near-idle server one player join delivering fast-start backlog
    #: (old packets, honestly "late" by the ingest→wire metric) would
    #: otherwise own the whole burn window and page on innocent traffic
    min_events: int = 200

    def cooldown(self) -> float:
        return self.cooldown_s or self.fast_window_s


class _Objective:
    __slots__ = ("name", "budget", "in_violation", "last_fire")

    def __init__(self, name: str, budget: float):
        self.name = name
        self.budget = max(budget, 1e-9)
        self.in_violation = False
        self.last_fire = 0.0


class SloWatchdog:
    """Tick-driven budget evaluator.  The server calls ``tick()`` from
    the pump loop's 1 Hz maintenance block; tests drive it with an
    injected clock and private sources."""

    def __init__(self, config: SloConfig | None = None, *,
                 clock=time.monotonic, latency_hist=None,
                 offender=None, flight=None, events=None,
                 violations=None, budget_gauge=None):
        self.config = config or SloConfig()
        self._clock = clock
        self._lat = latency_hist if latency_hist is not None \
            else families.RELAY_INGEST_TO_WIRE
        self._offender = offender               # () -> path | None
        self._flight = flight if flight is not None else FLIGHT
        self._events = events if events is not None else EVENTS
        self._violations = violations if violations is not None \
            else families.SLO_VIOLATIONS
        self._budget_gauge = budget_gauge if budget_gauge is not None \
            else families.SLO_BUDGET_REMAINING
        #: (t, {slo: (total, bad)}) cumulative samples, oldest first
        self._samples: deque = deque()
        self._objectives = {
            "latency": _Objective("latency",
                                  1.0 - self.config.latency_target),
            "drops": _Objective("drops", self.config.drop_objective),
        }
        self.violations = 0
        self.last_violation: dict | None = None

    # -- cumulative sources ------------------------------------------------
    def _read(self) -> dict[str, tuple[int, int]]:
        """{slo: (total events, bad events)} — cumulative since boot."""
        # the drop counters are mirrored from the C data-plane only by
        # the registry's pre-scrape collectors; without this pull a
        # server nobody scrapes would watch frozen zeros forever
        families.REGISTRY.collect()
        lat_total = self._lat.total_count()
        lat_bad = self._lat.count_above(
            self.config.latency_objective_ms / 1e3)
        drops_bad = int(families.EGRESS_SEND_ERRORS.total()
                        + families.INGEST_OVERSIZE_DROPPED.total())
        # denominator = every DELIVERED packet: the ingest→wire histogram
        # observes all three egress paths (native, batch/TCP, scalar),
        # where egress_packets_total counts only the native path — on a
        # TCP-players deployment that narrower denominator would let a
        # handful of ingest drops read as a ~100% bad ratio
        drops_total = lat_total + drops_bad
        return {"latency": (lat_total, lat_bad),
                "drops": (drops_total, drops_bad)}

    def _window_delta(self, slo: str, now: float, window_s: float,
                      cur: tuple[int, int]) -> tuple[int, int]:
        """(total, bad) accumulated over the last ``window_s``."""
        base = None
        for t, vals in self._samples:       # oldest → newest
            if now - t <= window_s:
                break
            base = vals.get(slo)
        if base is None:
            # window extends past recorded history: difference against
            # the oldest sample we have (start-up grace)
            base = self._samples[0][1].get(slo, (0, 0))
        return cur[0] - base[0], cur[1] - base[1]

    @staticmethod
    def _burn(total: int, bad: int, budget: float) -> float:
        if total <= 0:
            return 0.0
        return (bad / total) / budget

    # -- the tick ----------------------------------------------------------
    def tick(self, now: float | None = None) -> list[dict]:
        """Evaluate every objective; returns the violations fired this
        tick (empty on a healthy tick)."""
        cfg = self.config
        now = self._clock() if now is None else now
        cur = self._read()
        if not self._samples:
            # first tick: baseline only.  Evaluating against an implied
            # zero would charge the whole boot-to-now cumulative history
            # (a prior test burst, a pre-watchdog incident) to one window
            self._samples.append((now, cur))
            return []
        fired: list[dict] = []
        for slo, obj in self._objectives.items():
            f_tot, f_bad = self._window_delta(slo, now, cfg.fast_window_s,
                                              cur[slo])
            s_tot, s_bad = self._window_delta(slo, now, cfg.slow_window_s,
                                              cur[slo])
            fast = self._burn(f_tot, f_bad, obj.budget) \
                if f_tot >= cfg.min_events else 0.0
            slow = self._burn(s_tot, s_bad, obj.budget) \
                if s_tot >= cfg.min_events else 0.0
            # budget remaining over the slow window: 1 − consumed/allowed.
            # The min_events guard applies here too — the gauge feeds the
            # same alerting (soak fails on ≤ 0) the violation path does,
            # and a sparse window must not page through the side door
            if s_tot >= cfg.min_events:
                remaining = 1.0 - (s_bad / (s_tot * obj.budget))
            else:
                remaining = 1.0
            self._budget_gauge.set(round(max(min(remaining, 1.0), -1.0), 6),
                                   slo=slo)
            burning = fast >= cfg.fast_burn and slow >= cfg.slow_burn
            if burning and (not obj.in_violation
                            or now - obj.last_fire >= cfg.cooldown()):
                obj.in_violation = True
                obj.last_fire = now
                fired.append(self._fire(slo, fast, slow, f_bad, f_tot))
            elif not burning and fast < 1.0 and obj.in_violation:
                # falling edge with hysteresis: fully back under budget
                obj.in_violation = False
                self._events.emit("slo.recover", slo=slo,
                                  burn=round(fast, 3))
        # append AFTER evaluation so a window never differences a sample
        # against itself; prune past the slow window (+1 tick of slack)
        self._samples.append((now, cur))
        horizon = now - cfg.slow_window_s * 1.5
        while len(self._samples) > 2 and self._samples[1][0] < horizon:
            self._samples.popleft()
        return fired

    def _fire(self, slo: str, fast: float, slow: float,
              bad: int, total: int) -> dict:
        self.violations += 1
        self._violations.inc(slo=slo)
        offender = None
        dumped: list[str] = []
        if self._offender is not None:
            try:
                offender = self._offender()
            except Exception:
                offender = None
        if offender:
            # abnormal QUALITY, not abnormal teardown: freeze the
            # offending sessions' black boxes while the evidence is live
            dumped = self._flight.dump_path(
                offender, reason=f"slo: {slo} burn {fast:.1f}x")
        rec = self._events.emit(
            "slo.violation", level="error", stream=offender,
            slo=slo, burn=round(fast, 3), slow_burn=round(slow, 3),
            bad=bad, total=total, flagged=dumped)
        self.last_violation = rec
        return rec

    # -- read side ---------------------------------------------------------
    def status(self) -> dict:
        """Live budget view for ``command=top`` / ``/api/v1/profile``."""
        out = {}
        for slo, obj in self._objectives.items():
            out[slo] = {
                "budget": obj.budget,
                "in_violation": obj.in_violation,
                "budget_remaining":
                    self._budget_gauge.value(slo=slo)
                    if (slo,) in self._budget_gauge._values else 1.0,
            }
        return {"objectives": out, "violations": self.violations,
                "last_violation": self.last_violation}
