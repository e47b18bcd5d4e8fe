"""Quality adaptation: RTCP-feedback-driven thinning and thickening.

A copy of the reference's ``relay/quality.py`` (``QTSSFlowControlModule``
parity: thin when loss > 30% once or > 10% three times running, thicken
after six clean reports; 3GPP NADU buffer state feeds the same
hysteresis), with its QoS gauges: ``qos_thins_total`` and
``qos_thickens_total`` count the level moves, ``record_rr_qos`` sets a
stream's ``qos_fraction_lost_ratio`` and ``qos_jitter_seconds`` from each
RR block and ``drop_qos`` removes them when its player leaves.  A relay knows only frame boundaries
and keyframes (the ingest classifier), so thinning drops *complete
frames* per output:

====  =========================================
0     full stream
1     drop every second non-key frame
2     key frames (IDR/SPS/PPS GOP heads) only
3     video muted (audio continues)
====  =========================================

Decisions live per output: one slow client must not thin the others.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import obs
from .ring import PacketFlags

MAX_LEVEL = 3

# hysteresis thresholds (QTSSFlowControlModule pref defaults)
LOSS_THIN_NOW = 0.30        # one report above this → thin immediately
LOSS_THIN_SLOW = 0.10       # this many...
NUM_LOSSES_TO_THIN = 3      # ...consecutive reports above SLOW → thin
LOSS_THICK_BELOW = 0.03     # reports below this...
NUM_CLEAN_TO_THICK = 6      # ...this many times → thicken one level

# 3GPP NADU (TS 26.234) buffer-state thresholds: the receiver's buffer
# state drives the same hysteresis as loss
NADU_DELAY_UNKNOWN = 0xFFFF
NADU_UNDERRUN_NOW_MS = 40    # playout delay below this → thin immediately
NADU_DELAY_LOW_MS = 150      # below this repeatedly → thin (underrun risk)
NADU_DELAY_COMFY_MS = 1000   # above this (with free space) → clean report
NADU_FREE_LOW_64B = 24       # < 1.5 KB free receiver buffer → back off


@dataclass
class QualityController:
    level: int = 0
    _lossy_reports: int = 0
    _clean_reports: int = 0
    thins: int = 0
    thickens: int = 0

    def on_receiver_report(self, fraction_lost: float) -> int:
        """Feed one RR's loss fraction (0..1); returns the new level."""
        if fraction_lost >= LOSS_THIN_NOW:
            self._bump(+1)
            self._lossy_reports = self._clean_reports = 0
            return self.level
        if fraction_lost >= LOSS_THIN_SLOW:
            self._lossy_reports += 1
            self._clean_reports = 0
            if self._lossy_reports >= NUM_LOSSES_TO_THIN:
                self._bump(+1)
                self._lossy_reports = 0
        elif fraction_lost <= LOSS_THICK_BELOW:
            self._clean_reports += 1
            self._lossy_reports = 0
            if self._clean_reports >= NUM_CLEAN_TO_THICK:
                self._bump(-1)
                self._clean_reports = 0
        else:
            self._lossy_reports = self._clean_reports = 0
        return self.level

    def on_nadu(self, playout_delay_ms: int, free_buffer_64b: int) -> int:
        """Feed one NADU block's buffer state; returns the new level.  An
        extreme report (a playout delay at the underrun edge, or no free
        buffer) thins at once; a low buffer thins through the loss
        counters; a deep buffer counts as a clean report.  A delay of
        0xFFFF means "not known" and contributes nothing."""
        delay_known = playout_delay_ms != NADU_DELAY_UNKNOWN
        if (delay_known and playout_delay_ms <= NADU_UNDERRUN_NOW_MS) \
                or free_buffer_64b == 0:
            self._bump(+1)
            self._lossy_reports = self._clean_reports = 0
            return self.level
        if (delay_known and playout_delay_ms < NADU_DELAY_LOW_MS) \
                or free_buffer_64b < NADU_FREE_LOW_64B:
            self._lossy_reports += 1
            self._clean_reports = 0
            if self._lossy_reports >= NUM_LOSSES_TO_THIN:
                self._bump(+1)
                self._lossy_reports = 0
        elif delay_known and playout_delay_ms >= NADU_DELAY_COMFY_MS:
            self._clean_reports += 1
            self._lossy_reports = 0
            if self._clean_reports >= NUM_CLEAN_TO_THICK:
                self._bump(-1)
                self._clean_reports = 0
        return self.level

    def _bump(self, d: int) -> None:
        new = max(0, min(MAX_LEVEL, self.level + d))
        if new > self.level:
            self.thins += 1
            obs.QOS_THINS.inc()
        elif new < self.level:
            self.thickens += 1
            obs.QOS_THICKENS.inc()
        self.level = new


def record_rr_qos(path: str, track_id, fraction_lost: float,
                  jitter_units: int, clock_rate: int | None = None) -> None:
    """One RR report block into the stream's QoS gauges: the newest
    report's loss fraction, and its RFC 3550 interarrival jitter (RTP
    timestamp units) in seconds at the stream's clock rate (90 kHz when
    unknown)."""
    rate = clock_rate or 90000
    labels = {"path": path or "-", "track": str(track_id)}
    obs.QOS_FRACTION_LOST.set(round(float(fraction_lost), 6), **labels)
    obs.QOS_JITTER.set(round(jitter_units / rate, 6), **labels)


def drop_qos(path: str, track_id) -> None:
    """Remove a departed stream's QoS gauges from the exposition."""
    labels = {"path": path or "-", "track": str(track_id)}
    obs.QOS_FRACTION_LOST.remove(**labels)
    obs.QOS_JITTER.remove(**labels)


@dataclass
class ThinningFilter:
    """Per-output frame-granular packet filter driven by a quality level."""

    controller: QualityController = field(default_factory=QualityController)
    _frame_index: int = 0
    _dropping_frame: bool = False
    dropped: int = 0

    def passthrough(self) -> bool:
        """True while the filter cannot drop anything (level 0, not mid
        frame-drop): only then may an output take a rung that bypasses
        ``admit`` (the native UDP scatter, the TCP writev)."""
        return self.controller.level == 0 and not self._dropping_frame

    def note_frames(self, n: int) -> None:
        """``n`` video frame starts went out on a rung that bypasses
        ``admit`` (only a pass-through filter takes one): count them as
        ``admit`` would have, so a later level drops the same frames."""
        self._frame_index += n

    def admit(self, flags: int) -> bool:
        """Decide for one packet (classification flags from the ring)."""
        level = self.controller.level
        if not flags & PacketFlags.VIDEO:
            return True                      # audio always flows
        is_key = bool(flags & PacketFlags.KEYFRAME_FIRST)
        if flags & PacketFlags.FRAME_FIRST:
            self._frame_index += 1
            if level == 0:
                self._dropping_frame = False
            elif level == 1:
                self._dropping_frame = (not is_key
                                        and self._frame_index % 2 == 0)
            elif level == 2:
                self._dropping_frame = not is_key
            else:
                self._dropping_frame = True
        elif level >= 3:
            self._dropping_frame = True
        if self._dropping_frame:
            self.dropped += 1
            return False
        return True
