#!/usr/bin/env python3
"""B8's kernel on one card, beside its variants and its per-shard design.

Run from the repository root on a machine with one CUDA card:

    python3 tools/b8_shard_probe.py [--check-only]

It builds ``tools/b8_shard_probe.cu`` (which takes
``easydarwin_tpu_torch/csrc/relay_kernels.cu`` whole, so the variants run
the product's code) into ``build/b8_probe/`` with ``nvcc -Xptxas -v``.
Then, over phase 6c's mesh of two shards on the card
(``chip_smoke.b8_batch`` inputs):

1. ptxas registers, spills and shared memory of each kernel;
2. the product (``ed_relay_shard`` through
   ``ops.fanout.relay_shard_step``), every variant and the per-shard
   design bit-exact with the plain version (``relay_shard_step_plain``) on the
   card at config 4 ``[16,256,96]x[16,256,6]``, the example
   ``[4,32]x[4,8]`` and the ragged ``(4, 18, 130)`` at W = 100, in the
   layouts (2,1,1), (1,2,1) and (1,1,2).  ``--check-only`` stops here;
3. times by CUDA events around graph replays (``chip_smoke.graph_ms``),
   in turns (each case, then each again in reverse order), at config 4
   and the example in the (2,1,1) layout: the per-shard design's two
   launches (its entry point also filled ``newest`` and ``eligible`` first: not
   timed), the product's one launch, the variants (tile rows x outputs a
   CTA; the product's is 64 x 64), the product's stores alone (no copy,
   parse or fold), the product with a part taken out (``ABLATIONS``), and
   torch's fill of the same headers and mask (what
   the card takes to write those bytes: a yardstick, not a port of
   anything); each beside chip_smoke's byte bound, with the launch
   floor.

It prints the card's name and power limit and writes everything to
``chiprun_out/b8_shard_probe.json``.  ``start_build``, ``load``,
``layout_shards`` and ``per_shard_call`` are what chip_smoke.py's phase 10
uses to time the per-shard design beside the product in the same run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

BUILD = os.path.join(HERE, "build", "b8_probe")
SRC = os.path.join(HERE, "tools", "b8_shard_probe.cu")
OUT = os.path.join(HERE, "chiprun_out", "b8_shard_probe.json")
#: the product's kernel with parts taken out (``probe_shard_ablation``)
ABLATIONS = {"no copy": 1, "no mask stores": 2, "no fold": 4,
             "no copy, no fold": 5, "no copy, mask stores or fold": 7}
#: (tile rows, outputs a CTA) the probe's variants take; the first is the
#: product's
VARIANTS = ((64, 64), (64, 32), (64, 16), (128, 16), (128, 32), (256, 8),
            (256, 16))
KERNELS = ("relay_shard_kernel", "shard_stores_kernel",
           "shard_ablation_kernel", "per_shard_kernel")
LAYOUTS = ({"src": 2}, {"src": 1, "sub": 2}, {"src": 1, "win": 2})

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def log(msg: str) -> None:
    print(msg, flush=True)


def start_build(per_shard_only: bool = False):
    """Start ``nvcc`` on the probe (``per_shard_only``: the per-shard
    design alone); ``load`` waits for it."""
    from easydarwin_tpu_torch.ops import kernel_lib
    os.makedirs(BUILD, exist_ok=True)
    so = os.path.join(BUILD, f"libb8_probe.{os.getpid()}.so")
    csrc = os.path.join(HERE, "easydarwin_tpu_torch", "csrc")
    extra = ["-DB8_PROBE_PER_SHARD_ONLY"] if per_shard_only else []
    proc = subprocess.Popen(
        [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, *extra, "-I", csrc,
         "-shared", "-o", so, SRC], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    # the build's own seconds, read when it ends, however late it is waited
    done: list[float] = []
    out: list[str] = []
    t0 = time.perf_counter()

    def reap():
        out.append(proc.communicate()[0])
        done.append(time.perf_counter() - t0)

    waiter = threading.Thread(target=reap, daemon=True)
    waiter.start()
    return so, proc, waiter, out, done, per_shard_only


def load(build) -> tuple[ctypes.CDLL, dict]:
    """The built probe, bound, and its build's log and seconds."""
    so, proc, waiter, out, done, per_shard_only = build
    waiter.join()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {SRC}:\n{out[0]}")
    lib = ctypes.CDLL(so)
    if not per_shard_only:
        for name in ("probe_shard_variant", "probe_shard_stores"):
            fn = getattr(lib, name)
            fn.argtypes = [_P, _P, _I, _I, _P]
            fn.restype = _I
        lib.probe_shard_ablation.argtypes = [_P, _P, _I, _P]
        lib.probe_shard_ablation.restype = _I
    lib.probe_per_shard.argtypes = [
        _P, _I, _I, _I, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _I, _LL, _I,
        _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P]
    lib.probe_per_shard.restype = _I
    return lib, {"log": out[0], "seconds": done[0]}


def layout_shards(batch, axes, headers, mask, newest) -> list:
    """The ``ShardBlock`` s of a mesh laid out as ``axes`` whose shards all
    lie on ``batch``'s device, as ``parallel.mesh`` cuts them."""
    from easydarwin_tpu_torch.ops import fanout
    prefix, length, age, state, buckets = batch
    n, p = length.shape
    s = state.shape[1]
    src, sub, win = (axes.get(k, 1) for k in ("src", "sub", "win"))
    nb, sb, pb = n // src, s // sub, p // win
    out = []
    for i in range(src):
        rs = slice(i * nb, (i + 1) * nb)
        for j in range(sub):
            ss = slice(j * sb, (j + 1) * sb)
            for k in range(win):
                ps = slice(k * pb, (k + 1) * pb)
                out.append(fanout.ShardBlock(
                    prefix[rs, ps], length[rs, ps], age[rs, ps],
                    state[rs, ss], buckets[rs, ss], headers[rs, ss, ps],
                    mask[rs, ss, ps], newest[rs], kf_base=k * pb))
    return out


def per_shard_call(lib, shards, delay: int, eligible) -> None:
    """The per-shard design over ``shards``: one launch a shard, each folding
    into its block's ``newest`` and ``eligible`` by atomics (the caller
    fills them with -1 and 0 first)."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    for b in shards:
        n, p, w = b.prefix.shape
        rc = lib.probe_per_shard(
            b.prefix.data_ptr(), n, p, w, b.prefix.stride(0),
            b.length.data_ptr(), b.length.stride(0), b.age_ms.data_ptr(),
            b.age_ms.stride(0), b.out_state.data_ptr(),
            b.out_state.stride(0), b.bucket_of_output.data_ptr(),
            b.bucket_of_output.stride(0), b.out_state.shape[1], delay,
            b.kf_base, b.headers.data_ptr(), b.headers.stride(0),
            b.headers.stride(1), b.mask.data_ptr(), b.mask.stride(0),
            b.mask.stride(1), b.newest.data_ptr(), eligible.data_ptr(),
            stream)
        if rc:
            raise RuntimeError(f"probe_per_shard failed: cudaError {rc}")


def variant_call(lib, stores: bool, descs, scratch, rows: int,
                 subs: int) -> None:
    """The product's kernel (``stores``: its stores alone) at ``rows`` x
    ``subs`` over packed launches ``descs``."""
    import torch
    fn = lib.probe_shard_stores if stores else lib.probe_shard_variant
    stream = torch.cuda.current_stream().cuda_stream
    for desc in descs:
        rc = fn(ctypes.addressof(desc), scratch.data_ptr(), rows, subs,
                stream)
        if rc:
            raise RuntimeError(f"probe variant {rows}x{subs} failed: "
                               f"cudaError {rc}")


def ablation_call(lib, descs, scratch, flags: int) -> None:
    """The product's kernel with the parts ``flags`` names taken out."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    for desc in descs:
        rc = lib.probe_shard_ablation(ctypes.addressof(desc),
                                      scratch.data_ptr(), flags, stream)
        if rc:
            raise RuntimeError(f"probe ablation {flags} failed: "
                               f"cudaError {rc}")


def _outs(n, s, p, dev):
    import torch
    return (torch.empty((n, s, p, 12), dtype=torch.uint8, device=dev),
            torch.empty((n, s, p), dtype=torch.bool, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((), dtype=torch.int64, device=dev))


def check(lib, scratch) -> dict:
    """Every design bit-exact with the plain version on the card."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from easydarwin_tpu_torch.ops import fanout
    shapes = {"config 4": (16, 256, 256, 96), "example": (4, 8, 32, 96),
              "ragged": (4, 18, 130, 100)}
    worst = {}
    for label, (n, s, p, w) in shapes.items():
        batch = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in cs.b8_batch(n, s, p, seed=n + s + p, width=w)]
        for axes in LAYOUTS:
            want = _outs(n, s, p, "cuda")
            fanout.relay_shard_step_plain(
                layout_shards(batch, axes, *want[:3]), 73, want[3])
            runs = {"product": lambda sh, o: fanout.relay_shard_step(
                sh, 73, o[3])}
            for rows, subs in VARIANTS:
                runs[f"variant {rows}x{subs}"] = (
                    lambda sh, o, r=rows, u=subs: variant_call(
                        lib, False, [fanout.shard_descriptors(lp, 73, o[3])
                                     for lp in fanout.shard_launch_plan(sh)],
                        scratch, r, u))

            def per_shard(sh, o):
                o[2].fill_(-1)
                o[3].zero_()
                per_shard_call(lib, sh, 73, o[3])

            runs["per shard"] = per_shard
            for name, run in runs.items():
                got = _outs(n, s, p, "cuda")
                run(layout_shards(batch, axes, *got[:3]), got)
                torch.cuda.synchronize()
                for part, a, b in zip(("headers", "mask", "newest",
                                       "eligible"), got, want):
                    d = int((a.cpu().to(torch.int64)
                             - b.cpu().to(torch.int64)).abs().max()) \
                        if a.numel() else 0
                    cs.check(d == 0, f"{name} at {label} {axes}: {part} "
                             f"differs from the plain version (max {d})")
                worst[name] = 0
        log(f"[b8 probe] {label} [{n},{p},{w}]x[{n},{s},6] in {LAYOUTS}: "
            f"{sorted(worst)} bit-exact with the plain version")
    return worst


def timings(lib, scratch) -> list[dict]:
    """Each design at config 4 and the example over two ``src`` shards,
    in turns."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from easydarwin_tpu_torch.ops import fanout, kernel_lib
    rows_out = []
    for label, (n, s, p) in (("config 4", (16, 256, 256)),
                             ("example", (4, 8, 32))):
        batch = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in cs.b8_batch(n, s, p, seed=n + s + p)]
        h, m, newest, total = _outs(n, s, p, "cuda")
        shards = layout_shards(batch, {"src": 2}, h, m, newest)
        descs = [fanout.shard_descriptors(lp, 73, total)
                 for lp in fanout.shard_launch_plan(shards)]
        lib_scratch = kernel_lib.scratch("ed_relay_shard",
                                         fanout.SHARD_SCRATCH_WORDS,
                                         h.device)
        cases = {
            "per_shard": lambda: per_shard_call(lib, shards, 73, total),
            "product": lambda: [kernel_lib.launch(
                "ed_relay_shard", ctypes.addressof(d), lib_scratch.data_ptr())
                for d in descs],
        }
        for rows, subs in VARIANTS[1:]:
            cases[f"variant {rows}x{subs}"] = (
                lambda r=rows, u=subs: variant_call(lib, False, descs,
                                                    scratch, r, u))
        for rows, subs in VARIANTS:
            cases[f"stores {rows}x{subs}"] = (
                lambda r=rows, u=subs: variant_call(lib, True, descs,
                                                    scratch, r, u))
        for name, flags in ABLATIONS.items():
            cases[f"ablation {name}"] = (
                lambda f=flags: ablation_call(lib, descs, scratch, f))
        cases["torch fill"] = lambda: (h.fill_(0), m.fill_(False))
        nbytes, _ops = cs.b8_bound(n, s, p)
        bound = nbytes / cs.PEAK_BYTES_PER_S * 1e3
        times = {k: [] for k in cases}
        for order in (list(cases), list(reversed(cases))):
            for k in order:
                times[k].append(cs.graph_ms(cases[k], inner=20))
        for k, ts in times.items():
            rows_out.append({"shape": label, "case": k, "ms": ts,
                             "bound_ms": bound,
                             "bound_share": [bound / t for t in ts]})
            log(f"[b8 probe] {label} [{n},{p},96]x[{n},{s},6] {k}: "
                f"{ts[0]:.6f} / {ts[1]:.6f} ms (bound {bound:.6f}, "
                f"{bound / min(ts):.1%})")
    return rows_out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from easydarwin_tpu_torch.ops import fanout, kernel_lib
    if not torch.cuda.is_available():
        print("b8_shard_probe: needs a CUDA card", file=sys.stderr)
        return 2
    build = start_build()
    kernel_lib.library()
    lib, built = load(build)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"[card] {smi}")
    out = {"card": smi, "build_seconds": built["seconds"],
           "ptxas": cs.ptxas_report(built["log"], KERNELS)}
    for k, v in out["ptxas"].items():
        log(f"[b8 probe] ptxas {k}: {v}")
    scratch = torch.zeros(fanout.SHARD_SCRATCH_WORDS, dtype=torch.int32,
                          device="cuda")
    out["check"] = check(lib, scratch)
    if not args.check_only:
        out["launch_floor_ms"] = cs.launch_floor_ms()
        log(f"[b8 probe] launch floor {out['launch_floor_ms']:.6f} ms")
        out["timings"] = timings(lib, scratch)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    log(f"[b8 probe] card {smi}; detail in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
