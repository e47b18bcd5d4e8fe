"""Health-driven degradation ladder — per-stream graceful fallback.

Every relay stream sits on one rung of a four-rung ladder:

====  ===========  ====================================================
rung  name         what serves the stream
====  ===========  ====================================================
0     megabatch    the cross-stream stacked device pass (full service:
                   the scheduler's one ``ed_relay_window`` launch a wake)
1     device       the stream's own ``FanoutEngine`` on its device ring
                   (one ``ed_ring_query`` when its key changes)
2     cpu          the scalar host path (``RelayStream.reflect``)
3     shed         the host path + the newest subscribers are shed one
                   per maintenance tick until the stream keeps up
====  ===========  ====================================================

Rungs 0, 1 and 2 are code paths the pump already has; this module adds
the *state machine* that moves streams between them.  The ``cpu`` rung
is a path the pump chooses for a stream: no kernel wrapper falls back to
its plain version, and on a card every wrapper still launches its kernel
or raises.

* **Down** — a device error (real or injected) first gets **bounded
  retry-with-backoff**: the stream serves via the CPU oracle for an
  exponentially growing backoff window, then retries its device path.
  Only ``max_retries`` consecutive failures change the rung.  A
  megabatch-scheduler failure degrades every engaged rung-0 stream to
  rung 1 (per-stream stepping is the scheduler's own fallback).  At
  rung 2, sustained stall growth (slow subscribers) degrades to rung 3,
  where the server sheds the newest subscriber per tick — the reference
  would simply let everyone lag.
* **Up** — time hysteresis: one rung per maintenance tick, only after
  ``recover_sec`` with no errors and no rung change (so a flapping
  device cannot oscillate the ladder at tick rate).
* **SLO coupling** — on an SLO violation rising edge the watchdog's
  worst-offender stream is degraded one rung (the quality analogue of a
  device error).

Every transition updates ``resilience_ladder_level{stream}``, counts
``resilience_transitions_total{direction}`` and emits one latched
``ladder.degrade`` / ``ladder.recover`` event (per transition, never per
tick).  ``chip_smoke.py``'s chaos phase fails on any stream still below
rung 0 after its recovery window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from .. import obs

#: rung names, index == level (the ``resilience_ladder_level`` value)
RUNGS = ("megabatch", "device", "cpu", "shed")
LEVEL_FULL, LEVEL_DEVICE, LEVEL_CPU, LEVEL_SHED = range(4)


@dataclass(frozen=True)
class LadderConfig:
    """Mirrored 1:1 from the ``resilience_*`` ServerConfig keys."""

    recover_sec: float = 10.0        # clean time before climbing one rung
    max_retries: int = 3             # device errors retried before a drop
    backoff_ms: float = 250.0        # first retry backoff (doubles, capped)
    backoff_cap_ms: float = 4000.0
    shed_stall_growth: int = 50      # stalls/tick at rung 2 → rung 3


class _Health:
    __slots__ = ("level", "retries", "backoff_until", "last_error",
                 "last_change", "prev_stalls")

    def __init__(self):
        self.level = LEVEL_FULL
        self.retries = 0
        self.backoff_until = 0.0     # monotonic; retrying while < now
        self.last_error = 0.0
        self.last_change = 0.0
        self.prev_stalls: int | None = None


class DegradationLadder:
    """One per server; the pump consults ``engine_mode`` per stream per
    wake and the 1 Hz maintenance block drives ``tick``."""

    def __init__(self, config: LadderConfig | None = None, *,
                 clock=time.monotonic, events=None, gauge=None,
                 transitions=None, retries=None):
        self.config = config or LadderConfig()
        self._clock = clock
        self._events = events if events is not None else obs.EVENTS
        self._gauge = gauge if gauge is not None \
            else obs.RESILIENCE_LADDER_LEVEL
        self._transitions = transitions if transitions is not None \
            else obs.RESILIENCE_TRANSITIONS
        self._retries = retries if retries is not None \
            else obs.RESILIENCE_RETRIES
        self._streams: dict[str, _Health] = {}
        self._slo_was_violating = False
        self.degrades = 0
        self.recovers = 0

    # -- read side --------------------------------------------------------
    def _h(self, path: str) -> _Health:
        h = self._streams.get(path)
        if h is None:
            h = self._streams[path] = _Health()
        return h

    def level(self, path: str | None) -> int:
        h = self._streams.get(path or "")
        return h.level if h is not None else LEVEL_FULL

    def engine_mode(self, path: str | None, now: float | None = None) -> int:
        """Effective rung for THIS wake: the stream's level, except that
        a device-retry backoff window serves via the CPU oracle without
        a rung change — the bounded-retry half of the contract."""
        h = self._streams.get(path or "")
        if h is None:
            return LEVEL_FULL
        if h.level < LEVEL_CPU and h.backoff_until:
            if (self._clock() if now is None else now) < h.backoff_until:
                return LEVEL_CPU
        return h.level

    def allows_megabatch(self, path: str | None) -> bool:
        return self.engine_mode(path) == LEVEL_FULL

    def worst_level(self) -> int:
        return max((h.level for h in self._streams.values()), default=0)

    def status(self) -> dict:
        return {path: {"level": h.level, "rung": RUNGS[h.level],
                       "retries": h.retries}
                for path, h in sorted(self._streams.items())}

    # -- error inputs -----------------------------------------------------
    def note_device_error(self, path: str | None,
                          now: float | None = None, *,
                          reason: str = "device_errors") -> None:
        """A device-path failure (dispatch exception, injected fault) on
        one stream: retry with exponential backoff; past ``max_retries``
        consecutive failures, drop one rung (0→1 or 1→2).  The cluster
        pull envelope charges upstream-pull failures through the same
        machinery with ``reason="pull_errors"`` — a broken pull degrades
        the stream's rung, it never kills the session."""
        if path is None:
            return
        now = self._clock() if now is None else now
        h = self._h(path)
        if h.level >= LEVEL_CPU:
            # no device work left to fail; crucially, do NOT refresh
            # last_error — a non-device exception leaking in here must
            # not hold the clean-window clock and pin the stream on the
            # CPU oracle forever
            return
        h.last_error = now
        h.retries += 1
        if h.retries <= self.config.max_retries:
            backoff = min(self.config.backoff_ms
                          * (2 ** (h.retries - 1)),
                          self.config.backoff_cap_ms) / 1000.0
            h.backoff_until = now + backoff
            self._retries.inc()
        else:
            self._degrade(path, h, now, reason=reason)

    def note_device_ok(self, path: str | None,
                       now: float | None = None) -> None:
        """A successful device pass with retries pending.  The budget
        resets only after a SUSTAINED clean stretch (``recover_sec``):
        a fault every few seconds with successes in between is a sick
        device, not a string of independent transients — interleaved
        successes must not hold the rung forever."""
        h = self._streams.get(path or "")
        if h is None or not h.retries:
            return
        now = self._clock() if now is None else now
        if now - h.last_error >= self.config.recover_sec:
            h.retries = 0
            h.backoff_until = 0.0

    def note_scheduler_error(self, paths, now: float | None = None) -> None:
        """A megabatch-scheduler failure (the pump already degraded the
        WAKE to per-stream stepping): charge every engaged rung-0 stream
        a device error, so persistent scheduler faults latch those
        streams onto rung 1 instead of re-failing every wake."""
        now = self._clock() if now is None else now
        for path in paths:
            if path is not None and self.level(path) == LEVEL_FULL:
                self.note_device_error(path, now)

    # -- the tick ---------------------------------------------------------
    def tick(self, stalls: dict[str, int] | None = None, *,
             slo_status: dict | None = None, offender: str | None = None,
             now: float | None = None) -> None:
        """Once per 1 Hz maintenance block.  ``stalls`` maps live stream
        paths to their cumulative stall counters (drives rung 2→3 and
        prunes dead paths); ``slo_status``/``offender`` couple the SLO
        watchdog's burn signal in."""
        now = self._clock() if now is None else now
        cfg = self.config
        if stalls is not None:
            for path in [p for p in self._streams if p not in stalls]:
                del self._streams[path]
                self._gauge.remove(stream=path)
        # SLO burn rising edge: the worst-p99 session pays one rung
        if slo_status is not None:
            violating = any(o.get("in_violation")
                            for o in (slo_status.get("objectives")
                                      or {}).values())
            if violating and not self._slo_was_violating and offender:
                h = self._h(offender)
                h.last_error = now
                if h.level < LEVEL_SHED:
                    self._degrade(offender, h, now, reason="slo_burn")
            self._slo_was_violating = violating
        for path, h in self._streams.items():
            cur = stalls.get(path) if stalls is not None else None
            if cur is not None:
                growth = cur - (h.prev_stalls
                                if h.prev_stalls is not None else cur)
                h.prev_stalls = cur
                if (h.level == LEVEL_CPU
                        and growth >= cfg.shed_stall_growth):
                    h.last_error = now
                    self._degrade(path, h, now, reason="stall_growth")
                    continue
            if (h.level > LEVEL_FULL
                    and now - h.last_error >= cfg.recover_sec
                    and now - h.last_change >= cfg.recover_sec):
                self._recover(path, h, now)

    def shed_candidate(self, stream):
        """The newest subscriber of ``stream`` (last output of the last
        bucket) — what rung 3 sheds, one per tick, never the last one
        (an empty stream would instantly 'recover')."""
        if stream.num_outputs <= 1:
            return None
        for bucket in reversed(stream.buckets):
            if bucket:
                return bucket[-1]
        return None

    # -- transitions ------------------------------------------------------
    def _degrade(self, path: str, h: _Health, now: float,
                 reason: str) -> None:
        frm = h.level
        h.level = min(h.level + 1, LEVEL_SHED)
        if h.level == frm:
            return
        h.retries = 0
        h.backoff_until = 0.0
        h.last_change = now
        self.degrades += 1
        self._gauge.set(h.level, stream=path)
        self._transitions.inc(direction="down")
        self._events.emit("ladder.degrade", level="warn", stream=path,
                          rung=RUNGS[h.level], from_rung=RUNGS[frm],
                          reason=reason)

    def _recover(self, path: str, h: _Health, now: float) -> None:
        frm = h.level
        h.level -= 1
        # NOT last_error: after one clean window the stream climbs one
        # rung per tick, so a deep degradation recovers in seconds, not
        # rungs × recover_sec (the 30 s post-clearance budget)
        h.last_change = 0.0
        self.recovers += 1
        self._gauge.set(h.level, stream=path)
        self._transitions.inc(direction="up")
        self._events.emit("ladder.recover", stream=path,
                          rung=RUNGS[h.level], from_rung=RUNGS[frm])
