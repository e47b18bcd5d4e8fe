"""Build, load and bind the hand-written CUDA kernels (``csrc/*.cu``).

The library is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/easydarwin_tpu_torch/`` beside the package (a directory git
ignores), under a name that carries the sources' hash, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Each source is
compiled by its own ``nvcc``, all started together, and one more call
links the objects into one shared library.  It has a plain C interface
bound with ``ctypes``; no PyTorch header is compiled, which keeps the
build to seconds.

A failed build or a failed launch raises; nothing here falls back to the
plain PyTorch versions.  Each wrapper adds one to its entry in
``LAUNCHES`` where it launches its kernel.

Kernels are launched from more than one thread (the pump, the storage
tier's workers that run B4 for stripes, and the HLS requant pool's
workers that run B6), so the build and load, the scratch buffers and
the launch counts are guarded by one lock.  A ``ctypes.CDLL`` call gives
up the GIL; the few entry points that serve Python worker threads with
microseconds of host work are bound a second time through
``ctypes.PyDLL`` (``held``), which keeps it.

The first ``library()`` call notes the build and load time with the
profiler (``obs.PROFILER.note_compile``) under each kernel's name: the
port's counterpart of a jitted step's first trace.

A launch made inside ``timed(timer)`` (``ops.staging.DeviceTimer``) arms
the calling thread with the timer's ``TimingPair`` just before the entry
point is called; the entry point itself records the pair's start event
just before the thread's first launch and its stop event just after each
launch, inside the one host call (``csrc/launch_timing.h``), so the pair
holds the kernels and neither the host's preparation of their arguments
nor a wait to take the GIL back.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from ..obs import PROFILER

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "relay_kernels.cu",
           _PKG / "csrc" / "transform_kernels.cu",
           _PKG / "csrc" / "fec_kernels.cu",
           _PKG / "csrc" / "h264_kernels.cu")
#: headers the sources include (hashed with them)
HEADERS = (_PKG / "csrc" / "launch_timing.h",)
BUILD_DIR = _PKG.parent / "build" / "easydarwin_tpu_torch"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
#: compile flags of every source (no fast-math: K2 rounds like jnp.round,
#: and ed_requant_rungs divides as IEEE division does)
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: kernel name → launches made by its wrapper in this process
LAUNCHES = {"ed_parse_packets": 0, "ed_relay_window": 0,
            "ed_ring_query": 0, "ed_decode_blocks": 0, "ed_gf_parity": 0,
            "ed_relay_batch": 0, "ed_relay_shard": 0,
            "ed_requant_rungs": 0,
            "ed_h264_requant": 0, "ed_h264_requant_chroma": 0}

#: cp.async.bulk moves 16-byte-aligned runs that are a multiple of 16 bytes
BULK_ALIGN = 16
#: dynamic shared memory a relay kernel launch may ask for without an
#: opt-in: 48 KB less room for static shared memory (``kDynSmemLimit``)
DYN_SMEM_LIMIT = 48 * 1024 - 2048
#: dynamic shared memory of one ``ed_relay_window`` CTA: the kernel opts
#: into Hopper's 227 KB a block (232,448 B), less 1 KB for its static
#: shared memory (``kWindowSmemLimit``; ``library`` checks the two agree)
WINDOW_SMEM_LIMIT = 227 * 1024 - 1024

#: an entry point's return code at or above this is this base plus the
#: ``CUresult`` of ``cuTensorMapEncodeTiled`` (a TMA tensor map), not a
#: cudaError
TENSOR_MAP_ERROR = 1 << 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_LL = ctypes.c_longlong
_SIGNATURES = {
    # prefix, n_rows, row_stride, length, words, flags, stream
    "ed_parse_packets": (_P, _I, _I, _P, _P, _P, _P),
    # WindowBucket descriptors, n_buckets, cluster size, stream
    "ed_relay_window": (_P, _I, _I, _P),
    # rows, capacity, row_stride, head, state, n_subs, scratch, out, stream
    "ed_ring_query": (_P, _I, _I, _I, _P, _I, _P, _P, _P),
    # -> max buckets, max cluster, window threads, K1 tile rows, smem limit,
    # ring query tile rows
    "ed_relay_geometry": (_IP, _IP, _IP, _IP, _IP, _IP),
    # -> the window kernel's shared-memory limit, after opting it in on
    # the current device
    "ed_relay_window_optin": (_IP,),
    # stream (an empty kernel: the launch floor)
    "ed_launch_floor": (_P,),
    # levels, n_blocks, qtable, idct8 (the 8x8 DCT matrix C), out, stream
    "ed_decode_blocks": (_P, _I, _P, _P, _P, _P),
    # -> blocks per tile, ring stages, CTAs a launch uses (not a launch)
    "ed_decode_blocks_geometry": (_IP, _IP, _IP),
    # rows, K, B, coeff, R, tables (GF_NIB [256, 2, 16]), out, stream
    "ed_gf_parity": (_P, _I, _I, _P, _I, _P, _P, _P),
    # prefix, P, row_stride, length, age_ms, state, bucket, S, delay_ms,
    # headers, mask, keyframe_first, frame_last, scratch, newest, stream
    "ed_relay_batch": (_P, _I, _I, _P, _P, _P, _P, _I, ctypes.c_longlong,
                       _P, _P, _P, _P, _P, _P, _P),
    # -> tile rows, outputs per CTA, max P, max S, scratch words
    "ed_relay_batch_geometry": (_IP, _IP, _IP, _IP, _IP),
    # ShardLaunch descriptor, scratch, stream
    "ed_relay_shard": (_P, _P, _P),
    # -> tile rows, outputs per CTA, max shards, max slots, launch bytes
    "ed_relay_shard_geometry": (_IP, _IP, _IP, _IP, _IP),
    # levels, N, qt_in, qt_rungs, R, rungs, scratch, nonzeros, stream
    "ed_requant_rungs": (_P, _I, _P, _P, _I, _P, _P, _P, _P),
    # -> max rungs, max blocks, max CTAs
    "ed_requant_geometry": (_IP, _IP, _IP),
    # levels, qp_in, qp_out, N, out, stream
    "ed_h264_requant": (_P, _P, _P, _I, _P, _P),
    # dc, ac, qpc_in, qpc_out, N, dc_out, ac_out, stream
    "ed_h264_requant_chroma": (_P, _P, _P, _P, _I, _P, _P, _P),
    # -> a CUDA event without timing
    "ed_event_create": (ctypes.POINTER(_P),),
    # event (waits without the GIL: this library is a CDLL)
    "ed_event_synchronize": (_P,),
    # device, TimingPair -> its two timing events, made on that device
    "ed_timing_open": (_I, _P),
    # TimingPair, -> ms from its start to its last stop
    "ed_timing_elapsed": (_P, ctypes.POINTER(ctypes.c_float)),
    # TimingPair (its events released)
    "ed_timing_close": (_P,),
}
#: the entry points bound again through ``ctypes.PyDLL`` (``held``): host
#: calls of microseconds that keep the GIL, for callers beside busy Python
#: threads, where every call that gives the GIL up waits to take it back
_HELD_SIGNATURES = {
    # rows, qp_in, deltas, r, t, stage, dev, back, event, stream
    "ed_h264_requant_leg": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P),
    # dc, ac, qp_in, qp_out, m, g, t, stage, dev, back, event, stream
    "ed_h264_requant_chroma_leg": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                   _P, _P),
    # event, back, words, out, spin_us
    "ed_h264_leg_finish": (_P, _P, ctypes.c_longlong, _P, _I),
    # TimingPair or null: arms (or disarms) this thread's next launch
    "ed_timing_arm": (_P,),
}
#: ``cudaErrorNotReady``: an event or stream still has work pending
CUDA_ERROR_NOT_READY = 600


class TimingPair(ctypes.Structure):
    """A device timer's two timing events and what the launches recorded
    into them (``TimingPair`` in ``csrc/launch_timing.h``)."""
    _fields_ = [("start", ctypes.c_void_p), ("stop", ctypes.c_void_p),
                ("started", ctypes.c_int), ("stops", ctypes.c_int)]


@dataclass
class BuildResult:
    path: Path
    seconds: float          # build wall time; 0.0 when an earlier build was reused
    log: str                # nvcc's output (ptxas register/spill report)


_LIB: ctypes.CDLL | None = None
_HELD: ctypes.PyDLL | None = None
_BUILD: BuildResult | None = None
_SCRATCH: dict[tuple, torch.Tensor] = {}
#: guards ``_LIB``, ``_HELD``, ``_BUILD``, ``_SCRATCH`` and ``LAUNCHES``
_LOCK = threading.RLock()
#: ``timer``: the ``DeviceTimer`` this thread's launches record into
_TIMING = threading.local()


def reset_launch_counts() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in (*SOURCES, *HEADERS):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile the kernel library unless this source hash is built."""
    global _BUILD
    if _BUILD is not None:
        return _BUILD
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"librelay_kernels.{_source_hash()}.so"
    if out.exists():
        _BUILD = BuildResult(out, 0.0, "")
        return _BUILD
    nvcc = _nvcc()
    # private names and a final rename: two processes building at once (a
    # test and the server it started) never load a torn file
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    try:
        objs = [work / f"{src.stem}.o" for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        outputs = [p.communicate()[0] for p in procs]
        log = "".join(outputs)
        failed = [src.name for src, p in zip(SOURCES, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = work / out.name
        link = subprocess.run([nvcc, "-shared", *GENCODE, "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _BUILD = BuildResult(out, time.perf_counter() - t0, log)
    return _BUILD


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, once however many
    threads ask at the same time)."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                t0 = time.perf_counter()
                _LIB = _load()
                # the build and load are the port's compile: noted once
                # under each kernel's name, never a phase sample
                secs = time.perf_counter() - t0
                for name in LAUNCHES:
                    PROFILER.note_compile(name, secs)
    return _LIB


def _load() -> ctypes.CDLL:
    """Build (unless built), load and bind the library, and opt the
    window kernel into its shared memory."""
    with _LOCK:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.ed_error_string.argtypes = [ctypes.c_int]
        lib.ed_error_string.restype = ctypes.c_char_p
        limit = ctypes.c_int()
        rc = lib.ed_relay_window_optin(ctypes.byref(limit))
        if rc != 0:
            raise RuntimeError("ed_relay_window's shared-memory opt-in "
                               f"failed: cudaError {rc} "
                               f"({lib.ed_error_string(rc).decode()})")
        if limit.value != WINDOW_SMEM_LIMIT:
            raise RuntimeError(f"kWindowSmemLimit {limit.value} != "
                               f"WINDOW_SMEM_LIMIT {WINDOW_SMEM_LIMIT}")
    return lib


def held() -> ctypes.PyDLL:
    """The library's GIL-keeping entry points (``_HELD_SIGNATURES``):
    the same file loaded through ``ctypes.PyDLL``, whose calls do not give
    up the GIL."""
    global _HELD
    if _HELD is None:
        path = build().path
        library()
        with _LOCK:
            if _HELD is None:
                lib = ctypes.PyDLL(str(path))
                for name, argtypes in _HELD_SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                _HELD = lib
    return _HELD


def launch_held(name: str, kernel: str, *args,
                device: torch.device) -> None:
    """Call the GIL-keeping entry point ``name``, which launches
    ``kernel`` once, on ``device``'s current stream; raise on a CUDA
    error, count the launch of ``kernel`` otherwise."""
    stream = torch.cuda.current_stream(device)
    fn = getattr(held(), name)
    timer = getattr(_TIMING, "timer", None)
    stops = _arm(timer)
    rc = fn(*args, stream.cuda_stream)
    _disarm(timer, stops)
    if rc != 0:
        raise RuntimeError(f"{name} failed: {error_message(rc)}")
    with _LOCK:
        LAUNCHES[kernel] += 1


def launch(name: str, *args) -> None:
    """Call one entry point on the current stream; raise on a CUDA error,
    count the launch otherwise."""
    fn = getattr(library(), name)
    stream = torch.cuda.current_stream()
    timer = getattr(_TIMING, "timer", None)
    stops = _arm(timer)
    rc = fn(*args, stream.cuda_stream)
    _disarm(timer, stops)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {error_message(rc)}")
    with _LOCK:
        LAUNCHES[name] += 1


def _arm(timer) -> int:
    """Arm this thread's next launch with ``timer``'s pair (a GIL-keeping
    call, so nothing waits between it and the launch); the pair's stop
    count before the launch (-1 without a timer)."""
    if timer is None:
        return -1
    held().ed_timing_arm(ctypes.byref(timer.pair))
    return timer.pair.stops


def _disarm(timer, stops: int) -> None:
    """Clear the arm of an entry point that launched nothing (every launch,
    made or failed, consumes its arm itself)."""
    if timer is not None and timer.pair.stops == stops:
        held().ed_timing_arm(None)


def timing_pair(device: torch.device) -> TimingPair:
    """A ``TimingPair`` whose two timing events live on ``device``."""
    pair = TimingPair()
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    rc = library().ed_timing_open(index, ctypes.byref(pair))
    if rc != 0:
        raise RuntimeError(f"ed_timing_open failed: {error_message(rc)}")
    return pair


def timing_ms(pair: TimingPair) -> float:
    """Milliseconds from ``pair``'s start to its last stop, both done."""
    ms = ctypes.c_float()
    rc = library().ed_timing_elapsed(ctypes.byref(pair), ctypes.byref(ms))
    if rc != 0:
        raise RuntimeError(f"ed_timing_elapsed failed: {error_message(rc)}")
    return ms.value


def timing_close(pair: TimingPair) -> None:
    """Release ``pair``'s events."""
    library().ed_timing_close(ctypes.byref(pair))


@contextlib.contextmanager
def timed(timer):
    """Arm this thread's launches with ``timer``'s pair (``timer.pair``, a
    ``TimingPair``) while the block runs."""
    outer = getattr(_TIMING, "timer", None)
    _TIMING.timer = timer
    try:
        yield timer
    finally:
        _TIMING.timer = outer


def scratch(name: str, words: int, device: torch.device) -> torch.Tensor:
    """The int32 scratch of ``name``'s cross-CTA fold on ``device``'s
    current stream: ``words`` zeros, made once per (kernel, device, stream)
    and kept.  Its first word is the fold's ticket, which every launch
    leaves at 0, so launches on one stream need no memset between them and
    a CUDA graph replays them as captured."""
    key = (name, device.index, _stream_id(device))
    with _LOCK:
        buf = _SCRATCH.get(key)
        if buf is None:
            buf = _SCRATCH[key] = _zeros(words, device)
    return buf


def _stream_id(device: torch.device) -> int:
    """The handle of ``device``'s current stream in this thread."""
    return torch.cuda.current_stream(device).cuda_stream


def _zeros(words: int, device: torch.device) -> torch.Tensor:
    return torch.zeros(words, dtype=torch.int32, device=device)


def geometry(name: str, count: int) -> tuple[int, ...]:
    """The ``count`` constants a ``*_geometry`` entry point reports."""
    vals = [ctypes.c_int() for _ in range(count)]
    rc = getattr(library(), name)(*(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"{name} failed: {error_message(rc)}")
    return tuple(v.value for v in vals)


def error_message(rc: int) -> str:
    """What an entry point's nonzero return code means."""
    if rc >= TENSOR_MAP_ERROR:
        return (f"cuTensorMapEncodeTiled failed with CUresult "
                f"{rc - TENSOR_MAP_ERROR}")
    return f"cudaError {rc} ({library().ed_error_string(rc).decode()})"


def bulk_split(addr: int, nbytes: int) -> tuple[int, int, int]:
    """``(head, interior, tail)`` of the byte span ``[addr, addr + nbytes)``:
    the interior is the 16-byte-aligned run, a multiple of 16 bytes, that
    one bulk copy moves; head and tail (at most 15 bytes each) are plain
    loads.  ``bulk_split`` in ``csrc/relay_kernels.cu`` is the same rule."""
    lo = -(-addr // BULK_ALIGN) * BULK_ALIGN
    hi = (addr + nbytes) // BULK_ALIGN * BULK_ALIGN
    if hi <= lo:
        return nbytes, 0, 0
    return lo - addr, hi - lo, addr + nbytes - hi


def require(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int,
            device: torch.device) -> None:
    """The wrapper-side checks a kernel relies on: device, dtype, rank and
    a C-contiguous layout (the kernels compute their own offsets)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
