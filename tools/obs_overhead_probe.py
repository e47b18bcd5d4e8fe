#!/usr/bin/env python3
"""The observed relay of ``chip_smoke.py``'s phase 15 run several times
in turns, profiling on and off, to tell what ``obs`` costs the pump from
how a run's packets fell into wakes.

Run from the repository root:

    python3 tools/obs_overhead_probe.py [--device cuda|cpu] [--runs 0,1,1,0]

Each run is ``utils.obs_loopback.observed_relay`` at phase 15's players,
GOPs and seed, with ``EDTPU_PROFILE`` set from ``--runs`` (``1`` on,
``0`` off).  One line a run: its wakes, the wake host ms p50 and p99,
the pump's host µs a packet relayed (every pass's host ms,
``pass_ms_total``, over ``packets_out``) and the process's CPU seconds a
packet.  Then, for each setting, the mean of both figures and their
ratio on to off, and ``chiprun_out/obs_overhead_probe.json``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

OUT = os.path.join(HERE, "chiprun_out", "obs_overhead_probe.json")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", default="0,1,1,0,0,1,1,0",
                    help="profiling of each run in order, 1 on and 0 off")
    args = ap.parse_args()
    import chip_smoke as cs
    from easydarwin_tpu_torch.utils import obs_loopback as ol
    card = "cpu"
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    rows = []
    for flag in args.runs.split(","):
        profile = flag == "1"
        r = asyncio.run(ol.observed_relay(
            args.device, cs.OBS_SEED, profile=profile, gops=cs.OBS_GOPS,
            **cs.OBS_PLAYERS))
        st = r["server_stats"]
        pkts = max(st["packets_out"], 1)
        row = {"profile": profile, "wakes": st["wakes"],
               "packets_out": st["packets_out"],
               "wake_ms_p50": st["wake_ms_p50"],
               "wake_ms_p99": st["wake_ms_p99"],
               "us_per_packet": st["pass_ms_total"] * 1e3 / pkts,
               "cpu_us_per_packet": st["cpu_s"] * 1e6 / pkts}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for key in ("wake_ms_p50", "us_per_packet", "cpu_us_per_packet"):
        means = {}
        for profile in (True, False):
            xs = [r[key] for r in rows if r["profile"] is profile]
            means[profile] = sum(xs) / len(xs) if xs else None
        ratio = (means[True] / means[False]
                 if None not in means.values() else None)
        summary[key] = {"on": means[True], "off": means[False],
                        "ratio": ratio}
    print(f"card {card}")
    print(json.dumps(summary))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"card": card, "device": args.device, "runs": rows,
                   "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
