#!/usr/bin/env python3
"""B9's kernel on one card, beside its variants and the column design.

Run from the repository root on a machine with one CUDA card:

    python3 tools/b9_batch_probe.py [--check-only]

It builds ``tools/b9_batch_probe.cu`` (which takes
``easydarwin_tpu_torch/csrc/relay_kernels.cu`` whole, so the variants run
the product's code) into ``build/b9_probe/`` with ``nvcc -Xptxas -v``.
Then:

1. ptxas registers, spills and shared memory of each kernel;
2. the product (``ed_relay_batch``), the column design it replaced (a
   64-row tile copied and parsed for each 4-output column, 4-byte stores,
   an acq_rel fold), the product's kernel
   on 64-row tiles at 2 to 64 outputs a CTA and on 128-row tiles at 4, 8
   and 16, with its parameters in a ``BatchLaunch`` (216 bytes) or in
   B8's ``ShardLaunch`` (2,616 bytes), and at 4, 16, 32 and 64 outputs
   with two other folds of a multi-tile pass (the column design's acq_rel
   ticket, and
   ``fold_keyframe``'s CAS in place of ``fold_fields``' one relaxed add),
   each bit-exact on every key with the
   plain version (``relay_batch_step_plain``) on the card at phase 7c's
   pass (P = 47, S = 16), two tiles (P = 67, S = 16), P = S = 256, the
   group edges and 100-byte rows, every scratch back at 0.
   ``--check-only`` stops here;
3. times by CUDA events around graph replays (``chip_smoke.graph_ms``),
   in turns (each case, then each again in reverse order), at those three
   shapes: the product, the column design, each variant, and torch's fill of
   the same header and mask bytes (what the card takes to write them: a
   yardstick, not a port of anything), each beside chip_smoke's byte
   bound, with the launch floor.

It prints the card's name and power limit and writes everything to
``chiprun_out/b9_batch_probe.json``.  ``start_build``, ``load``,
``column_call`` and ``outputs`` are what chip_smoke.py's phase 10 uses to
time the column design beside the product in the same run.
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

BUILD = os.path.join(HERE, "build", "b9_probe")
SRC = os.path.join(HERE, "tools", "b9_batch_probe.cu")
OUT = os.path.join(HERE, "chiprun_out", "b9_batch_probe.json")
#: (tile rows, outputs a CTA, ShardLaunch form) of the variants (the
#: product's is BATCH_TILE_ROWS x BATCH_SUBS_PER_CTA in a BatchLaunch)
VARIANTS = tuple((64, g, False) for g in (2, 4, 8, 16, 32, 64)) + (
    (64, 4, True), (64, 16, True), (128, 4, False), (128, 8, False),
    (128, 16, False))
#: outputs a CTA the other folds are built for (64-row tiles)
FOLD_SUBS = (4, 16, 32, 64)
#: the other folds, by ``probe_batch_fold``'s number
FOLDS = {"acq_rel": 0, "CAS": 1}
#: (label, P, S): phase 7c's pass, two tiles, and P = S = 256
SHAPES = (("7c", 47, 16), ("two tiles", 67, 16), ("256", 256, 256))
KERNELS = ("relay_shard_kernel", "column_batch_kernel", "batch_fold_kernel")
DELAY = 73

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P, _I, _I, _P, _P, _P, _P, _I, _LL, _P, _P, _P, _P, _P, _P, _P]


def log(msg: str) -> None:
    print(msg, flush=True)


def start_build(column_only: bool = False):
    """Start ``nvcc`` on the probe (``column_only``: the column design
    alone); ``load`` waits for it."""
    from easydarwin_tpu_torch.ops import kernel_lib
    os.makedirs(BUILD, exist_ok=True)
    so = os.path.join(BUILD, f"libb9_probe.{os.getpid()}.so")
    csrc = os.path.join(HERE, "easydarwin_tpu_torch", "csrc")
    extra = ["-DB9_PROBE_COLUMN_ONLY"] if column_only else []
    proc = subprocess.Popen(
        [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, *extra, "-I", csrc,
         "-shared", "-o", so, SRC], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    done: list[float] = []
    out: list[str] = []
    t0 = time.perf_counter()

    def reap():
        out.append(proc.communicate()[0])
        done.append(time.perf_counter() - t0)

    waiter = threading.Thread(target=reap, daemon=True)
    waiter.start()
    return so, proc, waiter, out, done, column_only


def load(build) -> tuple[ctypes.CDLL, dict]:
    """The built probe, bound, and its build's log and seconds."""
    so, proc, waiter, out, done, column_only = build
    waiter.join()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {SRC}:\n{out[0]}")
    lib = ctypes.CDLL(so)
    lib.probe_batch_column.argtypes = _ARGS
    lib.probe_batch_column.restype = _I
    lib.probe_batch_scratch_words.argtypes = []
    lib.probe_batch_scratch_words.restype = _I
    if not column_only:
        lib.probe_batch_variant.argtypes = [_I, _I, _I, *_ARGS]
        lib.probe_batch_variant.restype = _I
        lib.probe_batch_fold.argtypes = [_I, _I, *_ARGS]
        lib.probe_batch_fold.restype = _I
    return lib, {"log": out[0], "seconds": done[0]}


def outputs(p: int, s: int, device="cuda"):
    """Empty headers, mask, flag rows and newest keyframe of one pass."""
    import torch
    return (torch.empty((s, p, 12), dtype=torch.uint8, device=device),
            torch.empty((s, p), dtype=torch.bool, device=device),
            torch.empty((2, p), dtype=torch.bool, device=device),
            torch.empty((), dtype=torch.int32, device=device))


def as_result(outs) -> dict:
    """``outputs`` as ``relay_batch_step``'s dict."""
    headers, mask, flags, newest = outs
    return {"headers": headers, "mask": mask, "keyframe_first": flags[0],
            "frame_last": flags[1], "newest_keyframe": newest}


def _args(dev, outs, scratch) -> tuple:
    import torch
    prefix, length, age, state, buckets = dev
    headers, mask, flags, newest = outs
    p, w = prefix.shape
    return (prefix.data_ptr(), p, w, length.data_ptr(), age.data_ptr(),
            state.data_ptr(), buckets.data_ptr(), state.shape[0], DELAY,
            headers.data_ptr(), mask.data_ptr(), flags[0].data_ptr(),
            flags[1].data_ptr(), scratch.data_ptr(), newest.data_ptr(),
            torch.cuda.current_stream().cuda_stream)


def _rc(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


def column_call(lib, dev, outs, scratch) -> None:
    """The column design (its scratch: ``probe_batch_scratch_words``
    int32)."""
    _rc(lib.probe_batch_column(*_args(dev, outs, scratch)),
        "probe_batch_column")


def variant_call(lib, rows: int, subs: int, shared: bool, dev, outs,
                 scratch) -> None:
    """The product's kernel on ``rows``-row tiles at ``subs`` outputs a
    CTA, its parameters in B8's ShardLaunch (``shared``) or a
    BatchLaunch."""
    _rc(lib.probe_batch_variant(rows, subs, int(shared),
                                *_args(dev, outs, scratch)),
        f"probe variant {rows}x{subs} {'shared' if shared else 'small'}")


def fold_call(lib, fold: str, subs: int, dev, outs, scratch) -> None:
    """The product's kernel at ``subs`` with the fold ``fold``."""
    _rc(lib.probe_batch_fold(FOLDS[fold], subs, *_args(dev, outs, scratch)),
        f"probe {fold} fold at {subs}")


def product_call(dev, outs) -> None:
    """ONE ``ed_relay_batch`` on preallocated outputs (``kernel_lib.launch``
    adds the stream)."""
    from easydarwin_tpu_torch.ops import fanout, kernel_lib
    scratch = kernel_lib.scratch("ed_relay_batch", fanout.BATCH_SCRATCH_WORDS,
                                 dev[0].device)
    kernel_lib.launch("ed_relay_batch", *_args(dev, outs, scratch)[:-1])


def designs(lib, relaxed, ticket) -> dict:
    """Every design as ``fn(dev, outs)``: the product, the column design, each
    variant (``relaxed``: a BatchLaunch-layout scratch, ``ticket``: the column
    design's layout)."""
    out = {"product": product_call,
           "column design": lambda d, o: column_call(lib, d, o, ticket)}
    for rows, g, shared in VARIANTS:
        out[f"{rows}x{g} {'shared' if shared else 'small'} struct"] = (
            lambda d, o, r=rows, g=g, sh=shared: variant_call(
                lib, r, g, sh, d, o, relaxed))
    for g in FOLD_SUBS:
        for fold, buf in (("acq_rel", ticket), ("CAS", relaxed)):
            out[f"64x{g} {fold} fold"] = (
                lambda d, o, g=g, f=fold, b=buf: fold_call(lib, f, g, d, o,
                                                           b))
    return out


def scratch_at_zero(bufs: dict, what: str) -> None:
    import torch
    import chip_smoke as cs
    torch.cuda.synchronize()
    for name, buf in bufs.items():
        words = buf[:2].cpu().tolist()
        cs.check(words[0] == 0 and (name == "ticket" or words[1] == 0),
                 f"{what}: the {name} scratch is {words}, not 0")


def check(lib, relaxed, ticket) -> list:
    """Every design bit-exact on every key with the plain version on the
    card; each scratch back at 0 after each pass."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from easydarwin_tpu_torch.ops import fanout, kernel_lib
    rng = np.random.default_rng(2025)
    g = fanout.BATCH_SUBS_PER_CTA
    shapes = [(p, s, 96) for _, p, s in SHAPES] + [
        (47, g - 1, 96), (47, 2 * g + 1, 96), (129, 33, 96), (1, 1, 96),
        (130, 18, 100), (512, 5, 96), (513, 5, 96), (1000, 3, 96)]
    runs = designs(lib, relaxed, ticket)
    for p, s, w in shapes:
        dev = [torch.from_numpy(a).cuda()
               for a in cs.b9_arrays(rng, p, s, w)]
        want = fanout.relay_batch_step_plain(*dev, DELAY)
        for name, run in runs.items():
            outs = outputs(p, s)
            run(dev, outs)
            cs.b9_diff(as_result(outs), want,
                       f"{name} at P={p} S={s} W={w} vs plain")
            scratch_at_zero({"product": kernel_lib.scratch(
                "ed_relay_batch", fanout.BATCH_SCRATCH_WORDS,
                dev[0].device), "relaxed": relaxed, "ticket": ticket},
                f"{name} at P={p} S={s}")
        log(f"[b9 probe] P={p} S={s} W={w}: {len(runs)} designs bit-exact "
            f"with the plain version on every key, scratch back at 0")
    return shapes


def timings(lib, relaxed, ticket) -> list[dict]:
    """Each design at the three shapes, in turns, beside torch's fill."""
    import numpy as np
    import torch
    import chip_smoke as cs
    rng = np.random.default_rng(7)
    rows = []
    for label, p, s in SHAPES:
        dev = [torch.from_numpy(a).cuda() for a in cs.b9_arrays(rng, p, s)]
        outs = outputs(p, s)
        cases = {k: (lambda f=f: f(dev, outs))
                 for k, f in designs(lib, relaxed, ticket).items()}
        cases["torch fill"] = lambda: (outs[0].fill_(0), outs[1].fill_(False))
        bound = cs.b9_bound(p, s)[0] / cs.PEAK_BYTES_PER_S * 1e3
        times = {k: [] for k in cases}
        for order in (list(cases), list(reversed(cases))):
            for k in order:
                times[k].append(cs.graph_ms(cases[k], inner=100))
        for k, ts in times.items():
            rows.append({"shape": label, "P": p, "S": s, "case": k,
                         "ms": ts, "bound_ms": bound})
            log(f"[b9 probe] {label} P={p} S={s} {k}: {ts[0]:.6f} / "
                f"{ts[1]:.6f} ms (bound {bound:.6f}, "
                f"{bound / min(ts):.1%})")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from easydarwin_tpu_torch.ops import kernel_lib
    if not torch.cuda.is_available():
        print("b9_batch_probe: needs a CUDA card", file=sys.stderr)
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
        log(f"[b9 probe] ptxas {k}: {v}")
    relaxed = torch.zeros(2, dtype=torch.int32, device="cuda")
    ticket = torch.zeros(lib.probe_batch_scratch_words(), dtype=torch.int32,
                         device="cuda")
    out["checked_shapes"] = check(lib, relaxed, ticket)
    if not args.check_only:
        out["launch_floor_ms"] = cs.launch_floor_ms()
        log(f"[b9 probe] launch floor {out['launch_floor_ms']:.6f} ms")
        out["timings"] = timings(lib, relaxed, ticket)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    log(f"[b9 probe] card {smi}; detail in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
