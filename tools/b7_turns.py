"""B7 (``ed_requant_rungs``) at config 5, timed in turns across checkouts.

Each turn runs one fresh process in a checkout (its own kernel build under
that checkout's ``build/``): the config-5 levels from chip_smoke's seed
path, then ``ed_requant_rungs`` and the plain chain in CUDA graphs, as
phase 10 times them.  Turns go A, B, B, A for each pair of checkouts, so
two kernel sources compare on one card in one call:

    python3 tools/b7_turns.py DIR_A DIR_B [--rounds 2]

One line a turn, and ``chiprun_out/b7_turns.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import json, sys, time
import torch
import chip_smoke as cs
from easydarwin_tpu_torch.ops import kernel_lib, transform as tf
from easydarwin_tpu_torch.ops import transform_kernel as tk
t0 = time.monotonic()
kernel_lib.library()
levels, _qt = cs.config5_levels(20261018)
qt_in, qt_rungs = cs.config5_tables()
out = {"kernel_ms": [], "plain_ms": []}
for _ in range(3):
    out["kernel_ms"].append(cs.graph_ms(
        lambda: tk.requant_rungs(levels, qt_in, qt_rungs), inner=5))
    out["plain_ms"].append(cs.graph_ms(
        lambda: tf.requant_rungs_plain(levels, qt_in, qt_rungs), inner=5))
out["seconds"] = time.monotonic() - t0
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs=2)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    a, b = (os.path.abspath(d) for d in args.dirs)
    turns = []
    for _ in range(args.rounds):
        for d in (a, b, b, a):
            run = subprocess.run([sys.executable, "-c", TURN], cwd=d,
                                 capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                print(run.stdout[-2000:], run.stderr[-4000:],
                      file=sys.stderr)
                return run.returncode
            res = json.loads(run.stdout.strip().splitlines()[-1])
            res["dir"] = d
            turns.append(res)
            print(f"[b7 turns] {d}: ed_requant_rungs "
                  f"{[round(x, 6) for x in res['kernel_ms']]} ms, plain "
                  f"{[round(x, 6) for x in res['plain_ms']]} ms",
                  flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "b7_turns.json"), "w") as f:
        json.dump(turns, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
