"""Phase 7d's traffic alone, a few times, with what explains a short player.

``chip_smoke.py`` phase 7d pushes BASELINE config 2 through the CLI server
to 64 UDP players (``chip_smoke.LOSSY_PLAYERS``: 40 plain, 16 FEC dropping
8% of media, 8 reliable dropping 5%) and fails when a player's span is not
whole after a 60 s wait.  This probe runs the same traffic and, instead of
stopping at the first short player, prints one JSON line a run: the check's
verdict, the settle time, the server's reliable and RTCP counters (the
RTCP socket's drops and the largest RTO where the tree reports them), the
wake p50/max, the host's UDP ``RcvbufErrors`` delta, and per FEC and
reliable player its drops, duplicates (a resend of a packet it held: a
lost or late ack), the kernel drops on its sockets and what it held.

    python3 tools/lossy_probe.py [--runs 2] [--seed0 40] [--busy 4]
                                 [--parent DIR] [--device cuda|cpu]

``--parent DIR`` runs another checkout's server and harness in turns with
this tree's, the parent first, on the same seeds (unpack one with ``git
archive <commit> | tar -x -C DIR``).  ``--busy K`` keeps K busy-looping
processes running beside the runs, as on a loaded host.  The probe exits
0 whatever the runs' verdicts; each line says them.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def udp_drops_by_inode() -> dict[str, int]:
    """``/proc/net/udp``: socket inode → datagrams the kernel dropped."""
    out = {}
    with open("/proc/net/udp") as f:
        for line in f.readlines()[1:]:
            cols = line.split()
            out[cols[9]] = int(cols[-1])
    return out


def child(seed: int, device: str) -> None:
    """One run of the tree in the current directory."""
    sys.path.insert(0, os.getcwd())
    import numpy as np

    import chip_smoke
    from easydarwin_tpu_torch.utils import loopback

    if device == "cuda":
        from easydarwin_tpu_torch.ops import kernel_lib
        kernel_lib.build()
        kernel_lib.library()
    check_lossy, info = loopback._check_lossy, {}

    def check(av, sent):
        drops = udp_drops_by_inode()
        for pl in av:
            socks = [tr.get_extra_info("socket") for tr in pl.client._udp]
            d = [drops.get(str(os.fstat(s.fileno()).st_ino), -1)
                 for s in socks]
            if pl.kind != "plain":
                info.setdefault("players", []).append(
                    [pl.index, pl.kind, pl.dropped, pl.duplicates, d,
                     len(pl.span())])
            elif sum(d) > 0:
                info.setdefault("players", []).append([pl.index, pl.kind, d])
        try:
            return check_lossy(av, sent)
        except AssertionError as e:
            info["failed"] = str(e)
            return {"delivered": {}, "fec_players": [],
                    "reliable_players": []}

    loopback._check_lossy = check
    rcvbuf0 = loopback.udp_rcvbuf_errors()
    t0 = time.monotonic()
    res = asyncio.run(asyncio.wait_for(loopback.serve_and_check(
        device, np.random.default_rng(1000 + seed),
        harness=loopback.push_play_lossy, players=chip_smoke.LOSSY_PLAYERS,
        gops=8, frames=30, packets_per_frame=13, body_len=(1270, 1300),
        rr_every_s=0.5, deadline_s=60), 400))
    st = res["server_stats"]
    print(json.dumps({
        "tree": os.getcwd(), "seed": seed,
        "s": round(time.monotonic() - t0, 1),
        "failed": info.get("failed"), "settle_s": res["settle_s"],
        "rcvbuf_errors": loopback.udp_rcvbuf_errors() - rcvbuf0,
        "reliable": st["reliable"], "rtcp": st["rtcp"],
        "fec_giveups": st["fec"]["rtx_giveups"],
        "wake": [st["wake_ms_p50"], st["wake_ms_max"]],
        "players": info.get("players")}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed0", type=int, default=40)
    ap.add_argument("--busy", type=int, default=0)
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.device)
        return 0
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    trees = ([args.parent.resolve()] if args.parent else []) + [ROOT]
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(args.busy)]
    try:
        for seed in range(args.seed0, args.seed0 + args.runs):
            for tree in trees:
                run = subprocess.run(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--child", str(seed), "--device", args.device],
                    cwd=tree, capture_output=True, text=True, timeout=420)
                lines = [ln for ln in run.stdout.splitlines()
                         if ln.startswith("{")]
                print(lines[-1] if lines else json.dumps(
                    {"tree": str(tree), "seed": seed, "rc": run.returncode,
                     "stderr": run.stderr[-2000:]}), flush=True)
    finally:
        for p in busy:
            p.kill()
            p.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
