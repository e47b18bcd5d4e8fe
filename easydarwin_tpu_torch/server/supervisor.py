"""The watchdog: run the server as a child and relaunch it.

The parent runs the server command, waits, and runs it again when it
exits with ``EXIT_RESTART`` (REST ``restart``) or crashes, giving up
after ``MAX_CRASHES`` crashes within ``WINDOW_SEC``.  SIGTERM and SIGINT
sent to the parent go on to the child, whose clean exit (0) ends the
loop, so stopping the parent stops the server.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import time

#: child exit code meaning "restart me" (REST ``restart``)
EXIT_RESTART = 2
#: give up if the child dies this many times within WINDOW_SEC
MAX_CRASHES = 5
WINDOW_SEC = 60.0


def spawn_forwarding(argv: list[str]) -> int:
    """Run ``argv`` to its end, passing SIGTERM and SIGINT on to it;
    returns its exit code."""
    proc = subprocess.Popen(argv)
    sigs = (signal.SIGTERM, signal.SIGINT)
    prev = {s: signal.signal(s, lambda n, _f: proc.send_signal(n))
            for s in sigs}
    try:
        return proc.wait()
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


def run_supervised(child_argv: list[str], *, auto_restart: bool = True,
                   spawn=None, sleep=time.sleep,
                   log=lambda m: print(m, file=sys.stderr, flush=True)) -> int:
    """Run the child command under supervision; returns the final exit
    code.  ``spawn``, ``sleep`` and ``log`` may be replaced (tests)."""
    spawn = spawn or spawn_forwarding
    crashes: list[float] = []
    while True:
        code = spawn(child_argv)
        if code == 0:
            return 0
        if code == EXIT_RESTART:
            log("supervisor: restart requested, relaunching")
            continue
        if not auto_restart:
            return code
        now = time.monotonic()
        crashes = [t for t in crashes if now - t < WINDOW_SEC] + [now]
        if len(crashes) >= MAX_CRASHES:
            log(f"supervisor: {len(crashes)} crashes in {WINDOW_SEC:.0f}s, "
                "giving up")
            return code
        delay = min(2.0 ** len(crashes), 15.0)
        log(f"supervisor: child exited {code}, restarting in {delay:.0f}s")
        sleep(delay)
