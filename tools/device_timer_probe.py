"""The device timer on the card, and the host-timed phases that read it.

One command on the card:

1. times one ``ed_launch_floor`` launch (an empty kernel) with the pair
   of ``ops.staging.DeviceTimer``, whose events the entry point records
   around its own launch (``csrc/launch_timing.h``), and with a pair of
   torch events recorded from Python around the same ctypes call, each
   alone and beside a Python thread that keeps the GIL busy: the host
   pauses a pair recorded from Python holds, and the one the entry point
   records does not;
2. runs ``chip_smoke.py``'s phase 15 (the observed relay, whose
   ``device_step`` mean is that timer's, around each window launch);
3. runs phase 7f (the pump's timer wheel) ``--wheel-runs`` times and
   prints each bucket's release delays, a failed check kept as that run's
   result instead of ending the command, with the process's garbage
   collections during each run (``gc.callbacks``: generation and pause),
   when the slowest release of each bucket was pushed, the pump's slowest
   wake, the event loop's and a plain thread's late wake-ups of 5 ms or
   more (each sleeping 2 ms at a time), the loop thread's Python stack
   whenever the loop has not woken for 15 ms (sampled every 2 ms by a
   plain thread), the process's involuntary context switches and the
   cgroup's CPU throttling (``cpu.stat``, read only).

    python3 tools/device_timer_probe.py [--samples 400] [--wheel-runs 6]
        [--phases timer,observed,wheel]

The detail goes to ``chiprun_out/device_timer_probe.json``; the last line
is ``{"ok": true}`` when every phase-15 and phase-7f check passed.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import resource
import subprocess
import sys
import threading
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from easydarwin_tpu_torch.ops import kernel_lib, staging  # noqa: E402


def _stats(ms: list) -> dict:
    v = np.sort(np.asarray(ms))
    return {"n": len(v), "mean_ms": float(v.mean()),
            "p50_ms": float(v[len(v) // 2]),
            "p99_ms": float(v[min(len(v) - 1, int(len(v) * 0.99))]),
            "max_ms": float(v[-1])}


def timer_pairs(samples: int) -> dict:
    """Each sample: the stream idle, one empty kernel timed by one pair."""
    lib = kernel_lib.library()
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream()

    def native() -> float:
        timer = staging.DeviceTimer(dev)
        with timer:
            stops = kernel_lib._arm(timer)
            rc = lib.ed_launch_floor(stream.cuda_stream)
            kernel_lib._disarm(timer, stops)
        cs.check(rc == 0, f"ed_launch_floor: {kernel_lib.error_message(rc)}")
        torch.cuda.synchronize()
        return timer.ns() / 1e6

    def from_python() -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        rc = lib.ed_launch_floor(stream.cuda_stream)
        b.record(stream)
        cs.check(rc == 0, f"ed_launch_floor: {kernel_lib.error_message(rc)}")
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    stop = threading.Event()

    def busy() -> None:
        while not stop.is_set():
            sum(range(2000))

    out = {}
    for load in ("idle", "busy"):
        th = None
        if load == "busy":
            th = threading.Thread(target=busy, daemon=True)
            th.start()
        try:
            for name, fn in (("native", native), ("python", from_python)):
                for _ in range(20):
                    fn()
                ms = [fn() for _ in range(samples)]
                out[f"{name}_{load}"] = _stats(ms)
        finally:
            stop.set()
            if th is not None:
                th.join()
            stop.clear()
        for name in ("native", "python"):
            s = out[f"{name}_{load}"]
            cs.log(f"[timer] {name:6} pair, host {load}: one empty kernel "
                   f"mean {s['mean_ms']:.6f} ms, p50 {s['p50_ms']:.6f}, "
                   f"p99 {s['p99_ms']:.6f}, max {s['max_ms']:.6f} over "
                   f"{s['n']}")
    return out


def _throttle() -> dict:
    """The cgroup's ``cpu.stat`` counters (v2, else v1), read only."""
    for path in ("/sys/fs/cgroup/cpu.stat", "/sys/fs/cgroup/cpu/cpu.stat",
                 "/sys/fs/cgroup/cpu,cpuacct/cpu.stat"):
        try:
            with open(path) as f:
                return {k: int(v) for k, v in
                        (line.split() for line in f if line.strip())}
        except (OSError, ValueError):
            continue
    return {}


LATE_S, NAP_S, STALL_S = 0.005, 0.002, 0.015


async def _watched_wheel(rng, loop_late: list, stacks: list) -> dict:
    """Phase 7f's run with a task beside it that notes the event loop's
    late wake-ups, and a thread that takes the loop thread's stack while
    the loop has not woken for ``STALL_S``."""
    beat = [time.monotonic()]
    loop_thread = threading.get_ident()
    done = threading.Event()

    async def watch():
        while True:
            t = time.monotonic()
            await asyncio.sleep(NAP_S)
            beat[0] = now = time.monotonic()
            if now - t - NAP_S >= LATE_S:
                loop_late.append((t, now - t - NAP_S))

    def sample():
        seen = 0.0
        while not done.wait(NAP_S):
            t = beat[0]
            if time.monotonic() - t >= STALL_S and t != seen:
                seen = t
                frame = sys._current_frames().get(loop_thread)
                if frame is not None:
                    stacks.append((t, time.monotonic() - t, "".join(
                        traceback.format_stack(frame, limit=14))))

    watcher = asyncio.create_task(watch())
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        return await asyncio.wait_for(cs._wheel_run(rng), 120)
    finally:
        watcher.cancel()
        done.set()
        sampler.join()


def main() -> int:
    if not torch.cuda.is_available():
        print("device_timer_probe: no CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=400)
    ap.add_argument("--wheel-runs", type=int, default=6)
    ap.add_argument("--phases", default="timer,observed,wheel")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    t0 = time.monotonic()
    b = kernel_lib.build()
    kernel_lib.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    cs.log(f"[build] {b.seconds:.1f} s; card {smi}")
    out = {"card": smi}
    if "timer" in phases:
        out["timer"] = timer_pairs(args.samples)
    ok = True
    kernel_lib.reset_launch_counts()
    if "observed" in phases:
        try:
            obs = cs.phase_observed(smi)
            out["observed"] = {k: obs[k] for k in ("device_step", "wake_ms",
                                                    "seconds", "ratio")}
        except AssertionError as e:
            ok = False
            out["observed"] = {"failed": str(e)}
            cs.log(f"[observed] FAILED: {e}")
    rng = np.random.default_rng(20261018)
    out["wheel"] = []
    collections, began = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            began[0] = time.monotonic()
        else:
            collections.append((began[0], time.monotonic() - began[0],
                                info["generation"]))

    gc.callbacks.append(on_gc)
    thread_late: list = []
    watching = threading.Event()

    def thread_watch():
        while not watching.is_set():
            t = time.monotonic()
            time.sleep(NAP_S)
            late = time.monotonic() - t - NAP_S
            if late >= LATE_S:
                thread_late.append((t, late))

    for k in range(args.wheel_runs if "wheel" in phases else 0):
        t_run = time.monotonic()
        del collections[:], thread_late[:]
        loop_late: list = []
        stacks: list = []
        cg0 = _throttle()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        watching.clear()
        th = threading.Thread(target=thread_watch, daemon=True)
        th.start()
        try:
            r = asyncio.run(_watched_wheel(rng, loop_late, stacks))
            st = r["server_stats"]
            run = {"buckets": r["buckets"], "pump": r["pump"],
                   "wake_ms_p50": r["wake_ms_p50"],
                   "wake_ms_max": st.get("wake_ms_max"),
                   "schedule_ms_max": st.get("pump", {}).get(
                       "schedule_ms_max")}
        except AssertionError as e:
            ok = False
            run = {"failed": str(e)}
            cs.log(f"[wheel] run {k} FAILED: {e}")
        watching.set()
        th.join()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        cg1 = _throttle()
        run["loop_late"] = [(round(t - t_run, 4), round(d * 1e3, 3))
                            for t, d in loop_late]
        run["thread_late"] = [(round(t - t_run, 4), round(d * 1e3, 3))
                              for t, d in thread_late]
        run["stalls"] = [(round(t - t_run, 4), round(d * 1e3, 3), st)
                         for t, d, st in stacks]
        for t, d, st in run["stalls"]:
            cs.log(f"[wheel] run {k}: loop still asleep {d} ms after "
                   f"{t} s into the run, its thread at:\n{st}")
        run["nivcsw"] = ru1.ru_nivcsw - ru0.ru_nivcsw
        run["cpu_s"] = (ru1.ru_utime + ru1.ru_stime - ru0.ru_utime
                        - ru0.ru_stime)
        run["cgroup"] = {n: cg1[n] - cg0.get(n, 0) for n in cg1}
        cs.log(f"[wheel] run {k}: pump wake max "
               f"{run.get('wake_ms_max')} ms, loop late (s into the run, "
               f"ms) {run['loop_late']}, thread late {run['thread_late']}, "
               f"involuntary switches {run['nivcsw']}, CPU "
               f"{run['cpu_s']:.2f} s, cgroup {run['cgroup']}")
        gcs = [(round(t - t_run, 4), round(d * 1e3, 3), g)
               for t, d, g in collections]
        run["gc"] = gcs
        slow = [c for c in gcs if c[1] >= 5.0]
        by_gen = {g: sum(1 for c in gcs if c[2] == g) for g in (0, 1, 2)}
        worst = {b: (round(v["max_pushed_at"] - t_run, 4),
                     round(v["max_ms"], 3))
                 for b, v in run.get("buckets", {}).items()}
        cs.log(f"[wheel] run {k}: collections by generation {by_gen}, "
               f"longest {max([c[1] for c in gcs], default=0):.3f} ms, "
               f"those of 5 ms or more (s into the run, ms, gen) {slow}; "
               f"slowest release a bucket (pushed s into the run, ms) "
               f"{worst}")
        out["wheel"].append(run)
    gc.callbacks.remove(on_gc)
    cs.log(f"[time] {time.monotonic() - t0:.1f} s")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "device_timer_probe.json"), "w") as f:
        json.dump(out, f, default=str, indent=1)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
