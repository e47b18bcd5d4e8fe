"""ctypes bridge to the port's host egress core (``csrc/egress_core.cpp``).

It sends the relay's wire writes, packs the megabatch upload rows, drains
a UDP pusher's RTP socket into the packet ring (``udp_ingest``) and
probes what io_uring offers this process (``uring_probe``).

The library is compiled at first use with ``g++ -O3 -fPIC -shared
-std=c++17`` into ``build/easydarwin_tpu_torch/libegress_core.<hash>.so``
beside the package (a directory git ignores), under a name that carries
the source's hash, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``available()`` builds and loads it and says whether
that worked; callers that find it missing keep the Python send loop.
``loaded()`` never builds.

Every pointer argument is declared (``c_void_p`` or a typed pointer), so
none is cut to 32 bits, and the stats struct's field count is checked
against the library at load (``ed_stats_fields``).
"""

from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import shutil
import socket
import struct
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "egress_core.cpp"
HEADER = _PKG / "csrc" / "egress_core.h"
BUILD_DIR = _PKG.parent / "build" / "easydarwin_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
#: why the library is missing (the build's or the loader's message)
load_error: str | None = None


class SendOp(ctypes.Structure):
    """``ed_sendop``: ring slot → subscriber index."""
    _fields_ = [("slot", ctypes.c_int32), ("out", ctypes.c_int32)]


class Dest(ctypes.Structure):
    """``ed_dest``: network-order IPv4 address and port."""
    _fields_ = [("ip_be", ctypes.c_uint32), ("port_be", ctypes.c_uint16),
                ("_pad", ctypes.c_uint16)]


#: field order of ``ed_stats`` in ``csrc/egress_core.h``
STAT_FIELDS = ("sendmmsg_calls", "send_packets", "gso_supers",
               "gso_segments", "eagain_stops", "hard_errors", "bytes_to_wire",
               "send_ns", "stage_gather_ns", "staged_bytes", "fault_injections",
               "stream_writev_calls", "stream_packets", "stream_bytes",
               "recvmmsg_calls", "recv_packets", "recv_bytes",
               "oversize_dropped", "ingest_ns")


class EdStats(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int64) for n in STAT_FIELDS]


#: ``use_gso`` values of ``ed_fanout_send_multi``
SEND_PLAIN, SEND_GSO = 0, 1

#: ``ed_uring_probe``'s capability bits (``ED_URING_CAP_*``), by name
URING_CAPS = {"ring": 1, "sqpoll": 2, "send_zc": 4, "recv_multi": 8,
              "fixed_bufs": 16}

_I32 = ctypes.c_int32
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_OPP = ctypes.POINTER(SendOp)
_DESTP = ctypes.POINTER(Dest)
_SIGNATURES = {
    "ed_last_send_errno": (_I32, []),
    "ed_get_stats": (None, [ctypes.POINTER(EdStats)]),
    "ed_reset_stats": (None, []),
    "ed_stats_fields": (_I32, []),
    "ed_fault_set": (None, [ctypes.c_int64] * 4),
    "ed_fault_clear": (None, []),
    "ed_fanout_send_multi": (_I32, [
        ctypes.c_int, _U8P, _I32P, _I32, _I32, _U32P, _U32P, _U32P, _I32,
        _I32, _DESTP, _I32, _OPP, _I32, _I32]),
    "ed_stream_send": (_I32, [
        ctypes.c_int, _U8P, _I32P, _I32, _I32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, _I32, _I32P, _I32, _I32P]),
    "ed_stage_gather": (_I32, [
        _U8P, _I32P, _I32, _I32, _I32P, _I32, _I32, _U8P, _I32, _I32]),
    "ed_udp_ingest": (_I32, [
        ctypes.c_int, _U8P, _I32P, _I64P, _I32, _I32, ctypes.c_int64, _I64P,
        _I32, _I32P]),
    "ed_uring_probe": (_I32, []),
}


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in (SOURCE, HEADER):
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libegress_core.{_source_hash()}.so"


def build() -> Path:
    """Compile the library unless this source hash is built; raise on a
    failed build."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the egress core cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name and a final rename: two processes building at once
    # never load a torn file
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        tmp = work / out.name
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _abi_ok(lib: ctypes.CDLL) -> bool:
    """The library writes exactly the fields ``EdStats`` holds: fewer
    would read as zeros, more would write past the buffer."""
    return lib.ed_stats_fields() == len(STAT_FIELDS)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried, load_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            load_error = str(e)
            return None
        if not _abi_ok(lib):
            load_error = (f"ed_stats has {lib.ed_stats_fields()} fields, "
                          f"the bridge {len(STAT_FIELDS)}")
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """Build (once) and load the library; whether it is usable."""
    return _load() is not None


def loaded() -> bool:
    """Whether the library is already loaded (never builds)."""
    return _lib is not None


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"egress core unavailable: {load_error}")
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _i32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _u32(a: np.ndarray):
    return a.ctypes.data_as(_U32P)


def _ring(ring_data: np.ndarray, ring_len: np.ndarray):
    """The ring's byte and length arrays as the C side reads them."""
    if ring_data.dtype != np.uint8 or ring_data.ndim != 2 \
            or not ring_data.flags.c_contiguous:
        raise ValueError("ring_data must be C-contiguous [capacity, slot] "
                         "uint8")
    lens = np.ascontiguousarray(ring_len, np.int32)
    if lens.shape != (ring_data.shape[0],):
        raise ValueError(f"ring_len {lens.shape} for {ring_data.shape[0]} "
                         f"slots")
    return lens


def get_stats() -> dict[str, int]:
    """The cumulative counters of ``ed_stats``."""
    s = EdStats()
    _need().ed_get_stats(ctypes.byref(s))
    return {n: getattr(s, n) for n in STAT_FIELDS}


def reset_stats() -> None:
    _need().ed_reset_stats()


def fault_set(eagain_every: int, enobufs_every: int, latency_every: int = 0,
              latency_us: int = 0) -> None:
    """Arm the deterministic egress faults (every Nth send call fails
    EAGAIN / ENOBUFS or sleeps first); setting restarts the schedule."""
    _need().ed_fault_set(int(eagain_every), int(enobufs_every),
                         int(latency_every), int(latency_us))


def fault_clear() -> None:
    _need().ed_fault_clear()


def last_send_errno() -> int:
    """Why the calling thread's last send stopped short (0 = it did not)."""
    return _need().ed_last_send_errno()


def make_dests(addrs) -> ctypes.Array:
    """``[(ip, port), ...]`` → a ``Dest`` array."""
    arr = (Dest * len(addrs))()
    for i, (ip, port) in enumerate(addrs):
        arr[i].ip_be = struct.unpack("=I", socket.inet_aton(ip))[0]
        arr[i].port_be = socket.htons(port)
    return arr


def ops_from_numpy(arr: np.ndarray):
    """``[N, 2]`` int32 C-contiguous (slot, out) rows → a ``SendOp``
    pointer into ``arr``, which must outlive the native call."""
    if arr.dtype != np.int32 or arr.ndim != 2 or arr.shape[1] != 2 \
            or not arr.flags.c_contiguous:
        raise ValueError("ops must be C-contiguous [N, 2] int32")
    return ctypes.cast(arr.ctypes.data, _OPP)


def fanout_send_multi(fd: int, ring_data: np.ndarray, ring_len: np.ndarray,
                      seq_off: np.ndarray, ts_off: np.ndarray,
                      ssrc: np.ndarray, dests, ops, n_ops: int, *,
                      use_gso: int = SEND_GSO) -> int:
    """Send ``n_ops`` (slot, subscriber) ops of every source row of the
    ``[n_src, S]`` params in ONE call: ``use_gso`` is ``SEND_PLAIN``
    (sendmmsg) or ``SEND_GSO`` (UDP_SEGMENT).  Returns ops sent, or −errno
    when none was."""
    lib = _need()
    lens = _ring(ring_data, ring_len)
    seq = np.ascontiguousarray(seq_off, np.uint32)
    ts = np.ascontiguousarray(ts_off, np.uint32)
    sc = np.ascontiguousarray(ssrc, np.uint32)
    if seq.ndim != 2 or not seq.shape == ts.shape == sc.shape:
        raise ValueError("params must be three [n_src, S] arrays")
    if seq.shape[1] < len(dests):
        raise ValueError(f"{seq.shape[1]} param columns for {len(dests)} "
                         f"destinations")
    return lib.ed_fanout_send_multi(
        fd, _u8(ring_data), _i32(lens), ring_data.shape[0],
        ring_data.shape[1], _u32(seq), _u32(ts), _u32(sc), seq.shape[0],
        seq.shape[1], dests, len(dests), ops, n_ops, int(use_gso))


def stream_send(fd: int, ring_data: np.ndarray, ring_len: np.ndarray,
                seq_off: int, ts_off: int, ssrc: int, channel: int,
                slots: np.ndarray) -> tuple[int, int]:
    """Framed interleaved egress of ``slots`` onto one stream socket.
    Returns ``(packets fully written, partial bytes)``: when the second is
    above 0 the next packet is torn on the wire and the caller must send
    its remaining bytes before anything else; a hard stop with nothing
    written gives ``(-errno, 0)``."""
    lib = _need()
    lens = _ring(ring_data, ring_len)
    slots32 = np.ascontiguousarray(slots, np.int32)
    partial = ctypes.c_int32(0)
    r = lib.ed_stream_send(
        fd, _u8(ring_data), _i32(lens), ring_data.shape[0],
        ring_data.shape[1], seq_off & 0xFFFFFFFF, ts_off & 0xFFFFFFFF,
        ssrc & 0xFFFFFFFF, channel, _i32(slots32), len(slots32),
        ctypes.byref(partial))
    return int(r), partial.value


def stage_gather(ring_data: np.ndarray, ring_len: np.ndarray,
                 slots: np.ndarray, prefix_width: int,
                 out_rows: np.ndarray) -> int:
    """Pack ``slots``' prefixes and le32 lengths into the rows of
    ``out_rows`` ([rows, stride] uint8, C-contiguous), zeroing the rest;
    returns the rows written, or −EINVAL on bad arguments."""
    lib = _need()
    lens = _ring(ring_data, ring_len)
    if out_rows.dtype != np.uint8 or out_rows.ndim != 2 \
            or not out_rows.flags.c_contiguous:
        raise ValueError("out_rows must be C-contiguous [rows, stride] uint8")
    slots32 = np.ascontiguousarray(slots, np.int32)
    return lib.ed_stage_gather(
        _u8(ring_data), _i32(lens), ring_data.shape[0], ring_data.shape[1],
        _i32(slots32), len(slots32), prefix_width, _u8(out_rows),
        out_rows.shape[1], out_rows.shape[0])


def udp_ingest(fd: int, ring_data: np.ndarray, ring_len: np.ndarray,
               ring_arrival: np.ndarray, now_ms: int, head: int,
               max_pkts: int) -> tuple[int, int, int]:
    """Drain up to ``max_pkts`` datagrams from the non-blocking socket
    ``fd`` in recvmmsg batches straight into the ring's own arrays (rows
    from ``head`` mod capacity; ``ring_len`` int32 and ``ring_arrival``
    int64, written in place).  Returns ``(admitted, new head, oversize
    datagrams dropped)``; a hard receive error with nothing admitted
    raises ``OSError``."""
    lib = _need()
    if ring_data.dtype != np.uint8 or ring_data.ndim != 2 \
            or not ring_data.flags.c_contiguous:
        raise ValueError("ring_data must be C-contiguous [capacity, slot] "
                         "uint8")
    cap = ring_data.shape[0]
    for a, dt, name in ((ring_len, np.int32, "ring_len"),
                        (ring_arrival, np.int64, "ring_arrival")):
        if a.dtype != dt or a.shape != (cap,) or not a.flags.c_contiguous:
            raise ValueError(f"{name} must be C-contiguous [{cap}] {dt}")
    h = ctypes.c_int64(head)
    drops = ctypes.c_int32(0)
    n = lib.ed_udp_ingest(
        fd, _u8(ring_data), _i32(ring_len),
        ring_arrival.ctypes.data_as(_I64P), cap, ring_data.shape[1],
        int(now_ms), ctypes.byref(h), int(max_pkts), ctypes.byref(drops))
    if n < 0:
        raise OSError(-n, os.strerror(-n))
    return n, h.value, drops.value


_uring_caps: int | None = None


def uring_probe() -> int:
    """What io_uring offers this process (``ed_uring_probe``): the
    ``URING_CAPS`` bits (>= 0), or −errno (−ENOSYS where there is no
    io_uring or no library, −EPERM where it is denied).  Probed once per
    process."""
    global _uring_caps
    if _uring_caps is None:
        lib = _load()
        _uring_caps = (-errno.ENOSYS if lib is None
                       else int(lib.ed_uring_probe()))
    return _uring_caps


def describe_uring(caps: int) -> str:
    """``uring_probe``'s answer in words: the capability names, or the
    errno's name."""
    if caps < 0:
        return errno.errorcode.get(-caps, f"errno {-caps}")
    return "+".join(n for n, bit in URING_CAPS.items() if caps & bit) \
        or "none"
