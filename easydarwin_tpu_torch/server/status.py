"""Runtime status: operator console columns + interval status file.

Reference parity: the ``-S n`` stats console (``RunServer.cpp:397-483`` —
1 Hz column printout of RTP conns/packet rates/late/quality the operators
eyeballed as their "test suite") and the ``server_status`` plist written on
an interval (``RunServer.cpp:248-388``).  The plist format is Apple legacy;
the idiomatic carrier today is a JSON snapshot with the same fields, which
also feeds the REST ``getserverinfo`` answer.  A server without a status
loop ticks it from the pump's once-a-second block, so the rates stay live.

Read model: ``tick()`` advances the rate baseline exactly once per status
tick; ``snapshot()`` is a PURE read that combines live counters with the
rates computed by the last tick.  Any number of readers (console, status
file, REST ``getserverinfo``) can snapshot inside one tick without zeroing
each other's rates — the footgun the old single ``sample()`` had, where
the second caller in a tick saw dt≈0 and rates pinned to ~0 forever.
"""

from __future__ import annotations

import json
import os
import time

from .. import obs

#: console column layout (name, width) — RunServer.cpp:427-446 equivalents
COLUMNS = (("RTSP", 6), ("Push", 6), ("Play", 6), ("PktsIn", 10),
           ("PktsOut", 10), ("InRate/s", 10), ("OutRate/s", 10),
           ("Queue", 7), ("UpMin", 7))


class StatusMonitor:
    """Reads server counters, derives rates, renders console lines and
    JSON snapshots.  Pure (no I/O of its own) except ``write_file``."""

    def __init__(self, app):
        self.app = app
        self._last_t: float | None = None
        self._last_in = 0
        self._last_out = 0
        self._in_rate = 0.0
        self._out_rate = 0.0
        self._lines_printed = 0

    # -- sampling ----------------------------------------------------------
    def _counters(self) -> dict:
        app = self.app
        pkts_out = sum(st.stats.packets_out
                       for sess in app.registry.sessions.values()
                       for st in sess.streams.values())
        queued = sum(len(st.rtp_ring)
                     for sess in app.registry.sessions.values()
                     for st in sess.streams.values())
        players = sum(sess.num_outputs
                      for sess in app.registry.sessions.values())
        return {
            "rtsp_connections": len(app.rtsp.connections),
            "push_sessions": len(app.registry.sessions),
            "players": players,
            "packets_in": app.rtsp.packets_in,
            "packets_out": pkts_out,
            "queued_packets": queued,
            "uptime_sec": int(time.time() - app.started_at),
            "requests": app.rtsp.requests,
        }

    def tick(self) -> dict:
        """Advance the rate baseline ONCE and return a snapshot.  Call
        exactly once per status tick; every other reader in the same tick
        uses ``snapshot()`` (or the dict this returns)."""
        c = self._counters()
        now = time.monotonic()
        if self._last_t is not None and now > self._last_t:
            dt = now - self._last_t
            self._in_rate = (c["packets_in"] - self._last_in) / dt
            self._out_rate = (c["packets_out"] - self._last_out) / dt
        self._last_t = now
        self._last_in = c["packets_in"]
        self._last_out = c["packets_out"]
        return self._render(c)

    def snapshot(self) -> dict:
        """PURE read: live counters + rates from the last ``tick()``.
        Never moves the baseline, so console, status file and REST can
        all call it inside one tick."""
        return self._render(self._counters())

    #: kept as an alias so older callers/tests keep working; semantics are
    #: tick() — it DOES advance the baseline
    sample = tick

    def _render(self, c: dict) -> dict:
        snap = dict(c)
        snap["in_rate"] = round(self._in_rate, 1)
        snap["out_rate"] = round(self._out_rate, 1)
        # key obs families mirrored into the operator surface: the real
        # in-server ingest→wire latency and the native bytes-to-wire the
        # console/plist never had (the whole point of the obs layer)
        obs.REGISTRY.collect()
        lat = obs.RELAY_INGEST_TO_WIRE
        snap["ingest_to_wire_count"] = lat.total_count()
        snap["ingest_to_wire_p50_ms"] = round(lat.quantile(0.5) * 1e3, 3)
        snap["ingest_to_wire_p99_ms"] = round(lat.quantile(0.99) * 1e3, 3)
        snap["wire_bytes"] = int(obs.EGRESS_BYTES.value())
        snap["tpu_passes"] = int(obs.TPU_PASSES.value())
        # wake-ledger summary: "is the pump starving" answered
        # from the console/getserverinfo without a scrape — the class
        # that waited longest in the latest wake and that wake's duration
        led = obs.LEDGER
        snap["ledger_top_wait_class"] = led.last_top_class
        snap["ledger_last_wake_ms"] = round(led.last_wake_ms, 3)
        snap["ledger_wakes"] = led.wakes
        # audience summary: "how are the viewers doing"
        # answered from the console surface without a scrape
        aud = obs.AUDIENCE.rollup()
        snap["audience_subscribers"] = aud["subscribers"]
        snap["audience_qoe_p50"] = aud["qoe_p50"]
        snap["audience_qoe_p10"] = aud["qoe_p10"]
        snap["audience_stalled_now"] = aud["stalled_now"]
        snap["audience_stall_storms"] = aud["stall_storms"]
        return snap

    # -- console (the -S display) -----------------------------------------
    def console_line(self, sample: dict | None = None) -> str:
        d = self.snapshot() if sample is None else sample
        vals = (d["rtsp_connections"], d["push_sessions"], d["players"],
                d["packets_in"], d["packets_out"], d["in_rate"],
                d["out_rate"], d["queued_packets"], d["uptime_sec"] // 60)
        line = "".join(str(v).rjust(w) for (_, w), v in zip(COLUMNS, vals))
        self._lines_printed += 1
        return line

    def header_line(self) -> str:
        return "".join(name.rjust(w) for name, w in COLUMNS)

    def needs_header(self, every: int = 20) -> bool:
        """Reprint the header every N lines, as the reference console does."""
        return self._lines_printed % every == 0

    # -- status file (the server_status plist) -----------------------------
    def write_file(self, path: str, sample: dict | None = None) -> None:
        """Defaults to the pure ``snapshot()`` — safe to combine with a
        console print in the same tick (the loop calls ``tick()`` once and
        hands the dict to both)."""
        snap = dict(self.snapshot() if sample is None else sample,
                    written_at=int(time.time()), server="easydarwin-tpu")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f, indent=1)
        os.replace(tmp, path)           # atomic: readers never see a torn file
