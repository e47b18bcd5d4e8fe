#!/usr/bin/env python3
"""B7 (``ed_requant_rungs``) timed before every measurement of
``chip_smoke.py``'s phase 10 loop, to find what in that loop changes B7's
time.

Run from the repository root on a machine with one CUDA card:

    python3 tools/b7_phase10_probe.py

It builds the kernel library, makes the config-5 levels from the seed
path chip_smoke uses, and times B7 (CUDA events around graph replays of 5
launches, on buffers made before anything else) once alone; then it runs
``chip_smoke.phase_kernels`` with B7 timed again before each of that
phase's ``graph_ms`` and ``call_ms`` measurements, and once after the
phase.  Then it takes phase 10's own B7 buffers (its tables, rungs and
counts, from the closure of the lambda phase 10 times) and times B7 on
each pairing of the probe's and phase 10's tables and outputs, and on
outputs made after the phase, in turns.  The tables phase 10 makes
(``config5_tables``) are copied to the host when made and compared after
every measurement: the first that changes them is named.  One line a
measurement, the card's name and power limit and its clocks after, and
``chiprun_out/b7_phase10_probe.json``.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

OUT = os.path.join(HERE, "chiprun_out", "b7_phase10_probe.json")


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as cs
    from easydarwin_tpu_torch.ops import kernel_lib
    from easydarwin_tpu_torch.ops import transform_kernel as tk
    if not torch.cuda.is_available():
        print("b7_phase10_probe: needs a CUDA card", file=sys.stderr)
        return 2
    kernel_lib.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    levels, qt = cs.config5_levels(20261018)
    qt_in, qt_rungs = cs.config5_tables()
    n, r = levels.shape[0], qt_rungs.shape[0]
    rungs = torch.empty((r, n, 64), dtype=torch.int32, device="cuda")
    nonzeros = torch.empty(r, dtype=torch.int32, device="cuda")

    def b7():
        kernel_lib.launch(
            "ed_requant_rungs", levels.data_ptr(), n, qt_in.data_ptr(),
            qt_rungs.data_ptr(), r, rungs.data_ptr(),
            kernel_lib.scratch("ed_requant_rungs", tk.REQUANT_SCRATCH_WORDS,
                               levels.device).data_ptr(),
            nonzeros.data_ptr())

    graph_ms, call_ms = cs.graph_ms, cs.call_ms
    out = {"card": smi, "alone_ms": graph_ms(b7, inner=5), "trace": []}
    print(f"[b7 phase10] B7 alone {out['alone_ms']:.6f} ms", flush=True)

    captured = {}
    made = []                        # (tables, their values when made)
    tables = cs.config5_tables

    def recording():
        t = tables()
        made.append((t, [x.cpu().clone() for x in t]))
        return t

    def changed() -> list:
        return [(i, j, torch.nonzero(x.cpu() != v).flatten().tolist()[:8],
                 x.cpu().flatten()[:8].tolist())
                for i, (t, vals) in enumerate(made)
                for j, (x, v) in enumerate(zip(t, vals))
                if not torch.equal(x.cpu(), v)]

    def traced(timer, kind):
        def run(fn, *args, **kw):
            before = graph_ms(b7, inner=5)
            ms = timer(fn, *args, **kw)
            code = getattr(fn, "__code__", None)
            if code is not None and "rungs" in code.co_freevars \
                    and "nonzeros" in code.co_freevars:
                captured.update(zip(code.co_freevars, (
                    c.cell_contents for c in fn.__closure__)))
            torch.cuda.synchronize()
            row = {"kind": kind, "line": code.co_firstlineno if code else None,
                   "ms": ms, "b7_before_ms": before, "tables_changed": changed()}
            if row["tables_changed"] and not out.get("first_change"):
                out["first_change"] = row
                print(f"[b7 phase10] phase 10's tables changed by the "
                      f"{kind} of chip_smoke.py:{row['line']}: "
                      f"{row['tables_changed']}", flush=True)
            out["trace"].append(row)
            print(f"[b7 phase10] {kind} of chip_smoke.py:{row['line']} "
                  f"{ms:.6f} ms; B7 just before {before:.6f} ms", flush=True)
            return ms
        return run

    cs.graph_ms = traced(graph_ms, "graph_ms")
    cs.call_ms = traced(call_ms, "call_ms")
    cs.config5_tables = recording
    try:
        timed = cs.phase_kernels(np.random.default_rng(7),
                                 collections.defaultdict(int),
                                 collections.defaultdict(int), levels, qt,
                                 (47, 16))
    finally:
        cs.graph_ms, cs.call_ms = graph_ms, call_ms
        cs.config5_tables = tables
    out["phase10_b7_ms"] = next(t["ms"] for t in timed
                                if t["name"] == "ed_requant_rungs")
    out["after_ms"] = graph_ms(b7, inner=5)
    mine = {"qt_in": qt_in, "qt_rungs": qt_rungs, "rungs": rungs,
            "nonzeros": nonzeros}
    late = {"rungs": torch.empty_like(rungs),
            "nonzeros": torch.empty_like(nonzeros)}
    out["tables_equal"] = bool(
        torch.equal(captured["qt_in"], qt_in)
        and torch.equal(captured["qt_rungs"], qt_rungs))
    out["pointers"] = {f"{who} {k}": hex(d[k].data_ptr())
                       for who, d in (("probe", mine),
                                      ("phase 10", captured),
                                      ("late", late)) for k in d
                       if hasattr(d[k], "data_ptr")}

    def on(tables, outs):
        def run():
            kernel_lib.launch(
                "ed_requant_rungs", levels.data_ptr(), n,
                tables["qt_in"].data_ptr(), tables["qt_rungs"].data_ptr(), r,
                outs["rungs"].data_ptr(),
                kernel_lib.scratch("ed_requant_rungs",
                                   tk.REQUANT_SCRATCH_WORDS,
                                   levels.device).data_ptr(),
                outs["nonzeros"].data_ptr())
        return run

    pairs = {"probe tables, probe outputs": on(mine, mine),
             "phase 10 tables, probe outputs": on(captured, mine),
             "probe tables, phase 10 outputs": on(mine, captured),
             "phase 10 tables, phase 10 outputs": on(captured, captured),
             "probe tables, outputs made after": on(mine, late),
             "phase 10 tables, outputs made after": on(captured, late)}
    out["pairs"] = {k: [] for k in pairs}
    for k in (*pairs, *reversed(pairs)):
        out["pairs"][k].append(graph_ms(pairs[k], inner=5))
    for k, v in out["pairs"].items():
        print(f"[b7 phase10] {k}: {v[0]:.6f} / {v[1]:.6f} ms", flush=True)
    print(f"[b7 phase10] tables equal {out['tables_equal']}; pointers "
          f"{out['pointers']}", flush=True)
    out["clocks"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu,temperature.memory,clocks_throttle_reasons.active",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    print(f"[b7 phase10] phase 10's own B7 reading "
          f"{out['phase10_b7_ms']:.6f} ms; B7 after the phase "
          f"{out['after_ms']:.6f} ms; clocks after {out['clocks']!r}",
          flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[b7 phase10] card {smi}; detail in {OUT}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
