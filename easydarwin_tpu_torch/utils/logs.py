"""Rolling logs: the error log and the W3C streaming access log.

``RollingLog`` appends lines to a file it rolls by size and by age
(``.1`` … ``.keep`` suffixes).  ``ErrorLog`` filters by level
(fatal/warning/info/debug); ``AccessLog`` writes one W3C-extended line
for each finished player or pusher session.  Each counts its lines and
rolls (``stats``), where the reference counts them in its metrics
registry.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from .http_misc import parse_user_agent


class RollingLog:
    """Append-only log rolled by size and/or age; files get .N suffixes.
    The file is opened at the first line."""

    def __init__(self, path: str, *, max_bytes: int = 10_000_000,
                 max_age_sec: float = 7 * 86400, keep: int = 5):
        self.path = path
        self.max_bytes = max_bytes
        self.max_age_sec = max_age_sec
        self.keep = keep
        self.lines = 0
        self.rolls = 0
        self._f = None
        self._opened_at = 0.0

    def _open(self):
        if self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
            self._opened_at = time.time()

    def write_line(self, line: str) -> None:
        self._open()
        if (self._f.tell() >= self.max_bytes
                or time.time() - self._opened_at >= self.max_age_sec):
            self.roll()
        self._f.write(line.rstrip("\n") + "\n")
        self.lines += 1
        if self._f.tell() >= self.max_bytes:
            # roll after a crossing write too: one oversized line must not
            # leave the file over the cap until a next write that may
            # never come
            self.roll()

    def roll(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        if os.path.exists(self.path):
            os.replace(self.path, f"{self.path}.1")
        self.rolls += 1
        self._open()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def stats(self) -> dict:
        return {"lines": self.lines, "rolls": self.rolls}


class ErrorLog:
    """Level-filtered rolling error log (fatal/warning/info/debug)."""

    LEVELS = {"fatal": 0, "warning": 1, "info": 2, "debug": 3}

    def __init__(self, path: str, *, verbosity: str = "info", **kw):
        self.log = RollingLog(path, **kw)
        self.verbosity = self.LEVELS.get(verbosity, 2)

    def write(self, level: str, message: str) -> None:
        if self.LEVELS.get(level, 3) <= self.verbosity:
            ts = time.strftime("%Y-%m-%d %H:%M:%S")
            self.log.write_line(f"{ts} [{level.upper()}] {message}")

    def fatal(self, m):
        self.write("fatal", m)

    def warning(self, m):
        self.write("warning", m)

    def info(self, m):
        self.write("info", m)

    def debug(self, m):
        self.write("debug", m)


@dataclass
class AccessRecord:
    """One finished client session."""

    client_ip: str = "-"
    uri: str = "-"
    method: str = "-"                  # PLAY / RECORD
    status: int = 200
    duration_sec: float = 0.0
    bytes_sent: int = 0
    packets_sent: int = 0
    packets_lost: int = 0
    user_agent: str = "-"
    transport: str = "-"               # UDP / TCP


W3C_FIELDS = ("c-ip date time cs-uri cs-method sc-status x-duration "
              "sc-bytes sc-packets x-packets-lost cs(User-Agent) "
              "x-transport c-playerid c-playerversion c-os c-osversion "
              "c-cpu")


def w3c_line(r: AccessRecord, now: time.struct_time) -> str:
    """One access-log line for ``r`` at UTC time ``now``."""
    ua = (r.user_agent or "-").replace(" ", "_")
    att = parse_user_agent(r.user_agent or "")
    cols = " ".join((att.get(k) or "-").replace(" ", "_")
                    for k in ("qtid", "qtver", "os", "osver", "cpu"))
    return (f"{r.client_ip} {time.strftime('%Y-%m-%d', now)} "
            f"{time.strftime('%H:%M:%S', now)} {r.uri} {r.method} "
            f"{r.status} {r.duration_sec:.1f} {r.bytes_sent} "
            f"{r.packets_sent} {r.packets_lost} {ua} {r.transport} {cols}")


class AccessLog:
    def __init__(self, path: str, **kw):
        self.log = RollingLog(path, **kw)
        self._wrote_header = False

    def record(self, r: AccessRecord) -> None:
        if not self._wrote_header:
            self._wrote_header = True
            self.log.write_line("#Version: 1.0")
            self.log.write_line("#Software: easydarwin-tpu/0.1")
            self.log.write_line(f"#Fields: {W3C_FIELDS}")
        self.log.write_line(w3c_line(r, time.gmtime()))
