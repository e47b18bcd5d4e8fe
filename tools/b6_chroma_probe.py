#!/usr/bin/env python3
"""B6's chroma kernel on one card, beside its experiments and its parent.

Run from the repository root on a machine with one CUDA card:

    python3 tools/b6_chroma_probe.py [--parent DIR] [--check-only]

It builds ``tools/b6_chroma_probe.cu`` (which takes
``easydarwin_tpu_torch/csrc/h264_kernels.cu`` whole, so ``new`` below is
the package's kernel) and, with ``--parent``, the ``h264_kernels.cu`` of
another checkout (``parent``), each into its own library under
``build/b6_probe/``, with ``nvcc -Xptxas -v``.  Then, at phase 5c's
config-5 chroma rows (``chip_smoke.h264_inputs``, DC [261,120, 4], AC
[261,120, 4, 15], the seeded mix of all three arms):

1. ptxas registers, spills and shared memory of every kernel, the
   occupancy (CTAs an SM) of the new kernel and its variants, and their
   SASS instructions by class (``cuobjdump -sass``, static counts);
2. ``new``, ``parent`` and every variant but ``copy`` and ``arith``
   bit-exact with the plain torch chain
   (``ops.transform.h264_requant_chroma``) on the card at the mix, at
   ``chip_smoke.B6_CHROMA_ARMS``'s four inputs, at phase 13's AU (396
   rows) and at ragged sizes; ``copy`` returns its input; the package's
   own phase 5c (``chip_smoke.phase_h264``: wrappers, edge sizes, legs).
   ``--check-only`` stops here;
3. times by CUDA events around graph replays (``chip_smoke.graph_ms``),
   in turns (each kernel, then each again in reverse order): ``parent``,
   ``new`` and the variants of ``tools/b6_chroma_probe.cu`` (``copy``:
   the rings with no arithmetic; ``arith``: the requant with no
   device-memory traffic; ``separate``, ``warp4``, ``tile``, ``sorted``,
   ``early``: the designs the kernel was chosen against) at the mix, with
   every row general, and at the AU; the luma kernel ``ed_h264_requant``
   new against parent at config 5; the launch floor; each beside its byte
   and int32 bounds.

It prints the card's name and power limit and writes everything to
``chiprun_out/b6_chroma_probe.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

BUILD = os.path.join(HERE, "build", "b6_probe")
OUT = os.path.join(HERE, "chiprun_out", "b6_chroma_probe.json")
VARIANTS = {"copy": 0, "arith": 1, "separate": 2, "warp4": 3, "tile": 4,
            "sorted": 5, "early": 6}
#: kernels whose ptxas and SASS lines are kept
KERNELS = ("h264_requant_chroma_kernel", "h264_requant_kernel",
           "chroma_copy_kernel", "chroma_arith_kernel",
           "chroma_separate_kernel", "chroma_warp4_kernel",
           "chroma_tile_kernel", "chroma_sorted_kernel",
           "chroma_early_kernel")
#: SASS opcodes by the unit that issues them
SASS_CLASSES = {
    "imad": ("IMAD", "IMUL"),
    "int_alu": ("IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
                "IMNMX", "VIMNMX", "ISETP", "SEL", "LEA", "IABS", "PRMT",
                "MOV", "SGXT", "BMSK", "FLO", "POPC", "VIADD", "IDP",
                "P2R", "R2P", "PLOP3", "CS2R", "S2R", "S2UR"),
    "shared": ("LDS", "STS", "ATOMS", "LDSM"),
    "global": ("LDG", "STG", "LD", "ST", "LDC", "RED", "ATOMG", "ATOM",
               "UBLKCP", "UTMALDG", "UTMASTG", "LDGSTS", "SYNCS",
               "UTMACMDFLUSH", "FENCE", "MEMBAR", "CCTL", "ULDC"),
    "warp": ("SHFL", "VOTE", "VOTEU", "MATCH", "REDUX"),
    "control": ("BRA", "BAR", "EXIT", "BSYNC", "BSSY", "WARPSYNC", "RET",
                "CALL", "NOP", "YIELD", "BREAK", "ELECT", "ACQBULK",
                "DEPBAR", "ERRBAR", "WARPGROUP", "BPT", "JMP", "KILL"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def build(parent: str | None) -> dict:
    """nvcc the probe (and the parent's source) into shared libraries, in
    parallel; {name: {"path", "log", "seconds"}}."""
    from easydarwin_tpu_torch.ops import kernel_lib
    nvcc = kernel_lib._nvcc()
    os.makedirs(BUILD, exist_ok=True)
    csrc = os.path.join(HERE, "easydarwin_tpu_torch", "csrc")
    srcs = {"new": (os.path.join(HERE, "tools", "b6_chroma_probe.cu"),
                    ["-I", csrc])}
    if parent:
        srcs["parent"] = (os.path.join(parent, "easydarwin_tpu_torch", "csrc",
                                       "h264_kernels.cu"), [])
    t0 = time.perf_counter()
    procs = {}
    for name, (src, extra) in srcs.items():
        so = os.path.join(BUILD, f"libb6_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *kernel_lib.NVCC_FLAGS, *extra, "-shared", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, p) in procs.items():
        text = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        out[name] = {"path": so, "log": text,
                     "seconds": time.perf_counter() - t0}
    return out


def cuobjdump() -> str | None:
    """The toolkit's cuobjdump, else the one Triton's wheel carries."""
    from easydarwin_tpu_torch.ops import kernel_lib
    cand = os.path.join(os.path.dirname(kernel_lib._nvcc()), "cuobjdump")
    if os.path.exists(cand):
        return cand
    try:
        import triton
        cand = os.path.join(os.path.dirname(triton.__file__), "backends",
                            "nvidia", "bin", "cuobjdump")
        return cand if os.path.exists(cand) else None
    except ImportError:
        return shutil.which("cuobjdump")


def sass_counts(so: str) -> dict:
    """Static SASS instructions of each kernel in ``so`` by class."""
    tool = cuobjdump()
    if tool is None:
        return {"error": "no cuobjdump"}
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    res, cur = {}, None
    by_op = {op: cls for cls, ops in SASS_CLASSES.items() for op in ops}
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = cs.kernel_key(m.group(1), KERNELS)
            if cur:
                res[cur] = {"total": 0, "opcodes": {}}
            continue
        if cur is None:
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if not m:
            continue
        op = m.group(1)
        base = op[1:] if op.startswith("U") and op[1:] in by_op else op
        cls = by_op.get(base, "other")
        res[cur][cls] = res[cur].get(cls, 0) + 1
        res[cur]["opcodes"][op] = res[cur]["opcodes"].get(op, 0) + 1
        res[cur]["total"] += 1
    return res


def bind(path: str, probe: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ed_h264_requant_chroma.argtypes = [p, p, p, p, i, p, p, p]
    lib.ed_h264_requant.argtypes = [p, p, p, i, p, p]
    if probe:
        lib.probe_chroma.argtypes = [i, p, p, p, p, i, p, p, p]
        lib.probe_occupancy.argtypes = [i, ctypes.POINTER(i)]
        lib.probe_geometry.argtypes = [ctypes.POINTER(i)] * 4
    return lib


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout whose h264_kernels.cu is "
                    "timed beside this one's")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b6_chroma_probe: no CUDA card", file=sys.stderr)
        return 2
    from easydarwin_tpu_torch.ops import transform as tf
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"[card] {smi}")
    res: dict = {"card": smi, "int32_ops_per_s": cs.int32_ops_per_s()}
    built = build(args.parent)
    res["build"] = {k: {"seconds": v["seconds"],
                        "ptxas": cs.ptxas_report(v["log"], KERNELS),
                        "sass": sass_counts(v["path"])}
                    for k, v in built.items()}
    libs = {k: bind(v["path"], k == "new") for k, v in built.items()}
    new = libs["new"]
    geo = [ctypes.c_int() for _ in range(4)]
    new.probe_geometry(*map(ctypes.byref, geo))
    res["geometry"] = dict(zip(("chunk_rows", "threads", "stages",
                                "smem_bytes"), (g.value for g in geo)))
    occ = {}
    for name, v in (*VARIANTS.items(), ("new", -1)):
        per_sm = ctypes.c_int()
        rc = new.probe_occupancy(v, ctypes.byref(per_sm))
        cs.check(rc == 0, f"probe_occupancy({name}): cudaError {rc}")
        occ[name] = per_sm.value
    res["occupancy_ctas_per_sm"] = occ
    for k, v in res["build"].items():
        log(f"[build] {k}: {v['seconds']:.1f} s; ptxas {v['ptxas']}")
        for kern, c in v["sass"].items():
            if isinstance(c, dict):
                log(f"[sass] {k} {kern}: "
                    f"{ {a: b for a, b in c.items() if a != 'opcodes'} }")
    log(f"[geometry] {res['geometry']}; CTAs an SM {occ}")

    rng = np.random.default_rng(args.seed)
    x = {k: torch.from_numpy(v).cuda()
         for k, v in cs.h264_inputs(rng).items()}
    m = x["dc"].shape[0]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def call(lib, dc, ac, qi, qo, dco, aco, v=None):
        args_ = (dc.data_ptr(), ac.data_ptr(), qi.data_ptr(), qo.data_ptr(),
                 dc.shape[0], dco.data_ptr(), aco.data_ptr(), stream())
        rc = (lib.ed_h264_requant_chroma(*args_) if v is None
              else lib.probe_chroma(v, *args_))
        cs.check(rc == 0, f"launch failed: cudaError {rc}")

    def runner(name, dc, ac, qi, qo):
        dco, aco = torch.empty_like(dc), torch.empty_like(ac)
        lib = libs["parent"] if name == "parent" else new
        v = VARIANTS.get(name)
        return (lambda: call(lib, dc, ac, qi, qo, dco, aco, v)), (dco, aco)

    inputs = {"mix": (x["dc"], x["ac"], x["qci"], x["qco"])}
    for arm in cs.B6_CHROMA_ARMS:
        qi, qo = cs.chroma_arm_qps({"qci": x["qci"].cpu().numpy()}, arm)
        inputs[arm] = (x["dc"], x["ac"], torch.from_numpy(qi).cuda(),
                       torch.from_numpy(qo).cuda())
    au = slice(0, cs.B6_AU_CHROMA_ROWS)
    inputs["au"] = tuple(t[au] for t in inputs["mix"])
    for n in (1, 3, 7, 9, 10, 11, 63, 65, 229, 33_800, 40_001):
        inputs[f"n={n}"] = tuple(t[:n] for t in inputs["mix"])
    exact = [k for k in ("new", "parent", *VARIANTS)
             if k in libs or k in VARIANTS and k not in ("copy", "arith")]
    checks = {}
    for label, ins in inputs.items():
        want = tf.h264_requant_chroma(*ins)
        for name in exact + ["copy"]:
            fn, outs = runner(name, *ins)
            fn()
            torch.cuda.synchronize()
            ref = ins[:2] if name == "copy" else want
            checks[f"{name} {label}"] = ok = all(
                torch.equal(a, b) for a, b in zip(outs, ref))
            cs.check(ok, f"{name} at {label} differs from "
                     f"{'its input' if name == 'copy' else 'the plain chain'}")
    res["checks"] = checks
    log(f"[check] {', '.join(exact)} bit-exact with the plain chain and copy "
        f"equal to its input at {len(inputs)} inputs "
        f"({', '.join(inputs)})")
    res["phase_5c"] = cs.phase_h264(np.random.default_rng(args.seed + 1))[0]
    if args.check_only:
        with open(OUT, "w") as f:
            json.dump(res, f, indent=1, default=str)
        log(json.dumps({"ok": True, "check_only": True}))
        return 0

    floor = [cs.launch_floor_ms() for _ in range(5)]
    res["launch_floor_ms"] = floor
    log(f"[floor] launch floor {min(floor):.6f}-{max(floor):.6f} ms "
        f"(5 reps)")
    names = [k for k in ("parent", "new", *VARIANTS)
             if k != "parent" or "parent" in libs]
    res["times"] = {}
    for label, inner in (("mix", 20), ("general", 20), ("au", 100)):
        ins = inputs[label]
        rows = ins[0].shape[0]
        nbytes, (ops, rate) = cs.b6_bound(
            "chroma", rows, cs.chroma_arms(ins[2].cpu().numpy(),
                                           ins[3].cpu().numpy()))
        bound = {"bytes_ms": nbytes / cs.PEAK_BYTES_PER_S * 1e3,
                 "ops_ms": ops / rate * 1e3}
        fns = {k: runner(k, *ins)[0] for k in names}
        t = {k: [] for k in names}
        for k in names + names[::-1]:
            t[k].append(cs.graph_ms(fns[k], inner=inner))
        res["times"][label] = {"rows": rows, "bound": bound, "ms": t}
        b = max(bound.values())
        log(f"[time] {label} ({rows} rows; bound {b:.6f} ms, bytes "
            f"{bound['bytes_ms']:.6f}, int32 ops {bound['ops_ms']:.6f}): "
            + "; ".join(f"{k} {v[0]:.6f}/{v[1]:.6f} ms "
                        f"({b / (sum(v) / 2):.1%})" for k, v in t.items()))
    if "parent" in libs:
        lev, out = x["lev"], torch.empty_like(x["lev"])
        n = lev.shape[0]

        def luma(lib):
            def fn():
                rc = lib.ed_h264_requant(lev.data_ptr(), x["qi"].data_ptr(),
                                         x["qo"].data_ptr(), n,
                                         out.data_ptr(), stream())
                cs.check(rc == 0, f"ed_h264_requant: cudaError {rc}")
            return fn
        got = {}
        for k in ("parent", "new"):
            luma(libs[k])()
            got[k] = out.clone()
        cs.check(torch.equal(got["parent"], got["new"]),
                 "ed_h264_requant differs from the parent's")
        t = {"parent": [], "new": []}
        for k in ("parent", "new", "new", "parent"):
            t[k].append(cs.graph_ms(luma(libs[k]), inner=20))
        res["times"]["luma"] = t
        log(f"[time] luma ed_h264_requant [{n},16]: parent "
            f"{t['parent'][0]:.6f}/{t['parent'][1]:.6f} ms, new "
            f"{t['new'][0]:.6f}/{t['new'][1]:.6f} ms (same outputs)")
    with open(OUT, "w") as f:
        json.dump(res, f, indent=1, default=str)
    print(smi, flush=True)
    log(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
