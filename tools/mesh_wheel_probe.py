"""``chip_smoke.py``'s phases 6c, 7f, 7g and 13d alone, and B8's timing.

One command on the card runs the kernel build, phase 4d (B9 against its
plain version: B8 shares its parse and header arithmetic), phase 6
(config 4 in-process, with the pump's deadline walk after each wake),
phase 7b (for the shared pair's
``sendmmsg`` figure phase 7g reports beside its own), phase 6c (B8 on
two shards of the card and the scheduler's mesh path), 7f (the pump's
timer wheel), 7g (per-player UDP pairs), 13d (the closed-loop requant),
each after the launch counts are set to 0, then B8
(``parallel.mesh.sharded_relay_step`` over two shards) at config 4's and
the example batch's shapes: CUDA-event medians in a graph of its one
``ed_relay_shard`` launch and of the entry point, a direct call, its
plain version, its byte and operation bounds and the launch floor.
About two minutes of command on the card, against the whole script's
eight:

    python3 tools/mesh_wheel_probe.py

Each phase raises as it does in ``chip_smoke.py``; the detail goes to
``chiprun_out/mesh_wheel_probe.json`` and the last line is
``{"ok": true}``.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from easydarwin_tpu_torch.ops import fanout, kernel_lib  # noqa: E402
from easydarwin_tpu_torch.parallel import mesh as pm  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_wheel_probe: no CUDA card", file=sys.stderr)
        return 2
    t0 = time.monotonic()
    b = kernel_lib.build()
    kernel_lib.library()
    cs.log(f"[build] {b.seconds:.1f} s")
    rng = np.random.default_rng(20261016)
    out = {"b9": cs.phase_b9(rng)}
    sched = cs.phase_scheduler(rng)
    out["scheduler"] = {k: v for k, v in sched.items() if k != "scheduler"}
    cfg2 = cs.phase_config2(rng)
    out["config2_egress"] = cfg2["server_stats"]["egress"]
    out["mesh"] = cs.phase_mesh(rng)
    for name, run in (
            ("wheel", lambda: cs.phase_wheel(rng)),
            ("pairs", lambda: cs.phase_udp_pairs(rng, cfg2["server_stats"])),
            ("closed", cs.phase_closed_loop)):
        kernel_lib.reset_launch_counts()
        t = time.monotonic()
        r = run()
        cs.log(f"[{name}] {time.monotonic() - t:.1f} s, launches "
               f"{dict(kernel_lib.LAUNCHES)}")
        out[name] = {k: v for k, v in r.items() if k != "server_stats"}
    card = torch.device("cuda")
    floor = cs.launch_floor_ms()
    for n, s, p in ((16, 256, 256), (4, 8, 32)):
        dev = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
               for a in cs.b8_batch(n, s, p, seed=1)]
        m = pm.make_relay_mesh([card, card], src=2)
        step = pm.sharded_relay_step(m)
        plain = pm.sharded_relay_step_plain(m)
        outs = cs.b8_outputs(n, s, p)
        shards = cs.b8_probe().layout_shards(dev, {"src": 2}, *outs[:3])

        def launch():
            fanout.relay_shard_step(shards, 73, outs[3])

        nbytes, ops = cs.b8_bound(n, s, p)
        row = {"kernel_ms": cs.graph_ms(launch, inner=20),
               "graph_ms": cs.graph_ms(lambda: step(*dev), inner=20),
               "call_ms": cs.call_ms(lambda: step(*dev), reps=11, inner=10),
               "plain_ms": cs.graph_ms(lambda: plain(*dev), inner=20),
               "bytes_ms": nbytes / cs.PEAK_BYTES_PER_S * 1e3,
               "ops_ms": ops / cs.PEAK_OPS_PER_S * 1e3, "floor_ms": floor}
        out[f"b8_{n}x{s}x{p}"] = row
        cs.log(f"[b8] {n}x{s}x{p}: one ed_relay_shard in a graph "
               f"{row['kernel_ms']:.6f} ms, entry point in a graph "
               f"{row['graph_ms']:.6f} ms, direct "
               f"call {row['call_ms']:.6f}, plain {row['plain_ms']:.6f}, "
               f"bound {row['bytes_ms']:.6f} (bytes) ops "
               f"{row['ops_ms']:.6f}, floor {floor:.6f}")
    cs.log(f"[time] {time.monotonic() - t0:.1f} s")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "mesh_wheel_probe.json"), "w") as f:
        json.dump(out, f, default=str, indent=1)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
