"""ctypes bridge to the port's host core: the egress core
(``csrc/egress_core.cpp``) and the H.264 slice walk (``csrc/h264_walk.cpp``).

The egress core sends the relay's wire writes, packs the megabatch upload
rows, drains a UDP pusher's RTP socket into the packet ring
(``udp_ingest``), probes what io_uring offers this process
(``uring_probe``) and keeps the pump's 1 ms timer wheel
(``TimerWheel``).  The walk serves the HLS requant ladder: the fused walk
``h264_requant_slice`` (decode, requantize and re-encode in one pass, the
split's oracle) and the split walk: ``h264_parse_slice`` (a ``SliceWalk``
holding the gather), B6 elsewhere, then ``SliceWalk.write`` once a rung.

Both sources are compiled at first use with one ``g++ -O3 -fPIC -shared
-std=c++17`` into ``build/easydarwin_tpu_torch/libegress_core.<hash>.so``
beside the package (a directory git ignores), under a name that carries
the sources' hash, so an edited source is rebuilt and an unchanged one is
loaded as it is.  It is loaded with ``ctypes.CDLL``, so every call runs
without the GIL.  ``available()`` builds and loads it and says whether
that worked; the egress callers that find it missing keep the Python send
loop, while the walk's entry points raise (the ladder never quietly runs
its CPython parse instead).  ``loaded()`` never builds.

Every pointer argument is declared (``c_void_p`` or a typed pointer), so
none is cut to 32 bits; at load every symbol must be there, and the
stats struct's and the walk's info field counts are checked against the
library (``ed_stats_fields``, ``ed_h264_walk_info_fields``).

The ``obs`` registry reads the egress core's counters before every scrape
(``egress_*``, ``ingest_*``, ``stage_gather_*``: the reference's names;
the io_uring and ``sendto`` families stay 0, as the port sends neither
way).
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
import weakref
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "egress_core.cpp", _PKG / "csrc" / "h264_walk.cpp")
HEADERS = (_PKG / "csrc" / "egress_core.h", _PKG / "csrc" / "h264_walk.h",
           _PKG / "csrc" / "h264_tables.h")
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


#: the ``info_out`` fields of ``ed_h264_parse_slice`` (``h264_walk.h``)
WALK_INFO_FIELDS = ("rows", "centries", "blocks", "max_qp", "mbs", "qp")

#: the walk's returns: a feature outside it, a malformed bitstream, an
#: output buffer too small, arguments that do not match the handle
WALK_UNSUPPORTED, WALK_MALFORMED, WALK_OVERFLOW, WALK_BAD_ARGS = -1, -2, -3, -4


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
_I64P = ctypes.POINTER(ctypes.c_int64)
_OPP = ctypes.POINTER(SendOp)
_DESTP = ctypes.POINTER(Dest)
_VP = ctypes.c_void_p
#: the walk's slice arguments after (nal, nal_len): width and height in
#: MBs, log2_max_frame_num, poc_type, log2_max_poc_lsb, pic_init_qp,
#: pps_id, deblocking_control, bottom_field_poc
_WALK_SLICE = [_I32] * 9
_FUSED = (_I32, [_U8P, _I32, _U8P, _I32, *_WALK_SLICE, _I32, _I32, _I32, _I32,
                 _I32P, _I32P])
_PARSE = (_I32, [_U8P, _I32, *_WALK_SLICE, _I32, _I32, _I32,
                 ctypes.POINTER(_VP), _I32P])
_WRITE = (_I32, [_VP, _I32, _I64P, _I32, _I64P, _I64P, _I32, _U8P, _I32])
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
    "ed_h264_requant_slice": _FUSED,
    "ed_h264_requant_slice_cabac": _FUSED,
    "ed_h264_parse_slice": _PARSE,
    "ed_h264_parse_slice_cabac": _PARSE,
    "ed_h264_walk_gather": (_I32, [_VP, _I64P, _I64P, _I64P, _I64P, _I64P]),
    "ed_h264_write_slice": _WRITE,
    "ed_h264_write_slice_cabac": _WRITE,
    "ed_h264_walk_free": (None, [_VP]),
    "ed_h264_walk_info_fields": (_I32, []),
    "ed_wheel_new": (_VP, [ctypes.c_int64]),
    "ed_wheel_free": (None, [_VP]),
    "ed_wheel_schedule": (ctypes.c_int64, [_VP, ctypes.c_int64,
                                           ctypes.c_int64]),
    "ed_wheel_cancel": (ctypes.c_int, [_VP, ctypes.c_int64]),
    "ed_wheel_advance": (_I32, [_VP, ctypes.c_int64, _I64P, _I32]),
    "ed_wheel_next": (ctypes.c_int64, [_VP, ctypes.c_int64]),
    "ed_wheel_pending": (_I32, [_VP]),
}


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in (*SOURCES, *HEADERS):
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
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                            *map(str, SOURCES)],
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
    """The library writes exactly the fields ``EdStats`` and the walk's
    info array hold: fewer would read as zeros, more would write past the
    buffer.  (``_bind`` already found every symbol.)"""
    return (lib.ed_stats_fields() == len(STAT_FIELDS)
            and lib.ed_h264_walk_info_fields() == len(WALK_INFO_FIELDS))


def _load() -> ctypes.CDLL | None:
    global _lib, _tried, load_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
        except (OSError, RuntimeError, AttributeError,
                subprocess.SubprocessError) as e:
            load_error = str(e)
            return None
        if not _abi_ok(lib):
            load_error = (f"ed_stats has {lib.ed_stats_fields()} fields and "
                          f"the walk's info {lib.ed_h264_walk_info_fields()}"
                          f", the bridge {len(STAT_FIELDS)} and "
                          f"{len(WALK_INFO_FIELDS)}")
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
        raise RuntimeError(f"host core unavailable: {load_error}")
    return lib


def require() -> None:
    """Build (once) and load the library, or raise: the H.264 walk's
    users call it when they are made, so a missing walk fails there and
    never shows up later as passed-through slices."""
    _need()


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


# ---------------------------------------------------------- the H.264 walk
def _walk_slice_args(width_mbs: int, height_mbs: int,
                     log2_max_frame_num: int, poc_type: int,
                     log2_max_poc_lsb: int, pic_init_qp: int, pps_id: int,
                     deblocking_control: bool, bottom_field_poc: bool
                     ) -> tuple[int, ...]:
    return (width_mbs, height_mbs, log2_max_frame_num, poc_type,
            log2_max_poc_lsb, pic_init_qp, pps_id,
            1 if deblocking_control else 0, 1 if bottom_field_poc else 0)


def h264_requant_slice(nal: bytes, *, width_mbs: int, height_mbs: int,
                       log2_max_frame_num: int, poc_type: int,
                       log2_max_poc_lsb: int, pic_init_qp: int,
                       pps_id: int, deblocking_control: bool,
                       bottom_field_poc: bool, delta_qp: int,
                       chroma_qp_offset: int = 0,
                       cabac: bool = False,
                       num_ref_l0_default: int = 0,
                       weighted_pred: bool = False
                       ) -> tuple[bytes, int, int] | None:
    """The FUSED walk (``ed_h264_requant_slice[_cabac]``, CABAC when
    ``cabac``): one slice requantized ``delta_qp`` steps coarser in one
    pass → (nal, macroblocks in the slice, residual blocks), the blocks
    counted as the Python path batches them (17 an I_16x16 MB, 16 another
    coded MB, 8 more with chroma).  None when the walk returns -1
    (unsupported) or -2 (malformed).  The ladder does not serve from it:
    it is the split walk's oracle and control."""
    lib = _need()
    entry = (lib.ed_h264_requant_slice_cabac if cabac
             else lib.ed_h264_requant_slice)
    src = np.frombuffer(nal, dtype=np.uint8)
    args = _walk_slice_args(width_mbs, height_mbs, log2_max_frame_num,
                            poc_type, log2_max_poc_lsb, pic_init_qp, pps_id,
                            deblocking_control, bottom_field_poc)
    mbs = ctypes.c_int32(0)
    blocks = ctypes.c_int32(0)
    for cap in (len(nal) * 2 + 256, len(nal) * 4 + 4096):
        out = np.empty(cap, dtype=np.uint8)
        n = entry(_u8(src), len(nal), _u8(out), cap, *args, delta_qp,
                  chroma_qp_offset, num_ref_l0_default,
                  1 if weighted_pred else 0, ctypes.byref(mbs),
                  ctypes.byref(blocks))
        if n != WALK_OVERFLOW:       # a slice that grew past twice its size
            break
    return (out[:n].tobytes(), mbs.value, blocks.value) if n > 0 else None


class SliceWalk:
    """One slice parsed by the split walk (``h264_parse_slice``): the C
    handle, freed with this object, and its gather in int64 arrays in the
    order and row map of ``codecs.h264_requant.gather_slice``: ``rows``
    [R, 16], ``qps`` [R], ``cdc`` [2C, 4], ``cac`` [2C, 4, 15] (Cb then Cr
    of each chroma-bearing macroblock), ``cqp`` [C]; ``info`` holds
    ``WALK_INFO_FIELDS``.  ``write`` may run for several rungs at once."""

    def __init__(self, lib: ctypes.CDLL, ptr: int, cabac: bool,
                 info: dict[str, int], nal_len: int):
        self.info = info
        self.nal_len = nal_len
        self._ptr = ptr
        self._write = (lib.ed_h264_write_slice_cabac if cabac
                       else lib.ed_h264_write_slice)
        self._free = weakref.finalize(self, lib.ed_h264_walk_free, ptr)
        r, c = info["rows"], info["centries"]
        self.rows = np.empty((r, 16), dtype=np.int64)
        self.qps = np.empty(r, dtype=np.int64)
        self.cdc = np.empty((2 * c, 4), dtype=np.int64)
        self.cac = np.empty((2 * c, 4, 15), dtype=np.int64)
        self.cqp = np.empty(c, dtype=np.int64)
        rc = lib.ed_h264_walk_gather(
            ptr, *(a.ctypes.data_as(_I64P) for a in (
                self.rows, self.qps, self.cdc, self.cac, self.cqp)))
        if rc != 0:
            raise RuntimeError(f"ed_h264_walk_gather returned {rc}")

    def write(self, delta_qp: int, rows: np.ndarray, cdc: np.ndarray,
              cac: np.ndarray) -> bytes | int:
        """One rung: the slice re-encoded ``delta_qp`` steps coarser from
        that rung's requantized rows (the gather's shapes; ``cdc`` and
        ``cac`` may group Cb and Cr as [C, 2, ...]).  The NAL, or the
        walk's -1 (outside it: the QP-51 ceiling, an mb_qp_delta out of
        range) or -2."""
        r, c = self.info["rows"], self.info["centries"]
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        cdc = np.ascontiguousarray(cdc, dtype=np.int64)
        cac = np.ascontiguousarray(cac, dtype=np.int64)
        if rows.size != 16 * r or cdc.size != 8 * c or cac.size != 120 * c:
            raise ValueError(f"rung rows {rows.shape} {cdc.shape} "
                             f"{cac.shape} for a walk of {r} rows and {c} "
                             f"chroma entries")
        for cap in (self.nal_len * 2 + 256, self.nal_len * 4 + 4096):
            out = np.empty(cap, dtype=np.uint8)
            n = self._write(self._ptr, delta_qp, rows.ctypes.data_as(_I64P),
                            r, cdc.ctypes.data_as(_I64P),
                            cac.ctypes.data_as(_I64P), c, _u8(out), cap)
            if n != WALK_OVERFLOW:
                break
        if n == WALK_BAD_ARGS:
            raise ValueError("the walk refused the rung's arguments")
        return out[:n].tobytes() if n > 0 else n


def h264_parse_slice(nal: bytes, *, width_mbs: int, height_mbs: int,
                     log2_max_frame_num: int, poc_type: int,
                     log2_max_poc_lsb: int, pic_init_qp: int, pps_id: int,
                     deblocking_control: bool, bottom_field_poc: bool,
                     chroma_qp_offset: int = 0, cabac: bool = False,
                     num_ref_l0_default: int = 0,
                     weighted_pred: bool = False) -> SliceWalk | int:
    """The split walk's parse (``ed_h264_parse_slice[_cabac]``) and its
    gather: a ``SliceWalk``, or the walk's -1 (outside it: the caller
    takes the Python path) or -2 (malformed: the caller passes the slice
    through).  Raises when the library is missing."""
    lib = _need()
    entry = (lib.ed_h264_parse_slice_cabac if cabac
             else lib.ed_h264_parse_slice)
    src = np.frombuffer(nal, dtype=np.uint8)
    handle = _VP()
    info = (_I32 * len(WALK_INFO_FIELDS))()
    rc = entry(_u8(src), len(nal),
               *_walk_slice_args(width_mbs, height_mbs, log2_max_frame_num,
                                 poc_type, log2_max_poc_lsb, pic_init_qp,
                                 pps_id, deblocking_control,
                                 bottom_field_poc),
               chroma_qp_offset, num_ref_l0_default,
               1 if weighted_pred else 0, ctypes.byref(handle), info)
    if rc != 0:
        if rc == WALK_BAD_ARGS:
            raise ValueError("the walk refused the parse's arguments")
        return rc
    return SliceWalk(lib, handle.value, cabac,
                     dict(zip(WALK_INFO_FIELDS, info)), len(nal))


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


class TimerWheel:
    """The egress core's 1 ms hashed timer wheel (``ed_wheel``): the pump
    sleeps until its next deadline.  ``schedule`` arms ``user_data`` to
    fire ``delay_ms`` after the time the wheel was last advanced to,
    ``advance`` returns what fired up to ``now_ms``, ``next_deadline``
    the ms until the earliest armed timer (-1: none).  Raises when the
    library is missing: no caller keeps a fixed tick instead."""

    def __init__(self, now_ms: int = 0):
        self._lib = _need()
        self._w = self._lib.ed_wheel_new(int(now_ms))

    def close(self) -> None:
        if self._w:
            self._lib.ed_wheel_free(self._w)
            self._w = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def schedule(self, delay_ms: int, user_data: int) -> int:
        return self._lib.ed_wheel_schedule(self._w, int(delay_ms),
                                           int(user_data))

    def cancel(self, timer_id: int) -> bool:
        return bool(self._lib.ed_wheel_cancel(self._w, int(timer_id)))

    def advance(self, now_ms: int, max_out: int = 1024) -> list[int]:
        out = np.zeros(max_out, dtype=np.int64)
        n = self._lib.ed_wheel_advance(self._w, int(now_ms),
                                       out.ctypes.data_as(_I64P), max_out)
        return out[:n].tolist()

    def next_deadline(self, now_ms: int) -> int:
        return self._lib.ed_wheel_next(self._w, int(now_ms))

    @property
    def pending(self) -> int:
        return self._lib.ed_wheel_pending(self._w)


# ------------------------------------------------------------- observability
def _collect_native_stats() -> None:
    """The ``obs`` registry's pre-scrape collector: the egress core's
    cumulative ``ed_stats`` mirrored into the reference's egress, ingest
    and staging families.  Nothing until the library is loaded (a scrape
    never builds it): the families read 0, as any idle counter."""
    if _lib is None:
        return
    from . import obs
    s = get_stats()
    obs.EGRESS_SENDMMSG_CALLS.set_to(s["sendmmsg_calls"])
    obs.EGRESS_PACKETS.set_to(s["send_packets"])
    obs.EGRESS_BYTES.set_to(s["bytes_to_wire"])
    obs.EGRESS_GSO_SUPERS.set_to(s["gso_supers"])
    obs.EGRESS_GSO_SEGMENTS.set_to(s["gso_segments"])
    obs.EGRESS_EAGAIN.set_to(s["eagain_stops"])
    obs.EGRESS_SEND_ERRORS.set_to(s["hard_errors"])
    obs.INGEST_RECVMMSG_CALLS.set_to(s["recvmmsg_calls"])
    obs.INGEST_DATAGRAMS.set_to(s["recv_packets"])
    obs.INGEST_BYTES.set_to(s["recv_bytes"])
    obs.INGEST_OVERSIZE_DROPPED.set_to(s["oversize_dropped"])
    obs.EGRESS_BUSY_SECONDS.set_to(s["send_ns"] / 1e9)
    obs.INGEST_BUSY_SECONDS.set_to(s["ingest_ns"] / 1e9)
    obs.STAGE_GATHER_BUSY_SECONDS.set_to(s["stage_gather_ns"] / 1e9)
    obs.STAGE_GATHER_BYTES.set_to(s["staged_bytes"])
    if s["fault_injections"]:
        obs.FAULT_INJECTED.set_to(s["fault_injections"],
                                  site="egress_native")


def _register_collector() -> None:
    from .obs import REGISTRY
    REGISTRY.add_collector(_collect_native_stats)


_register_collector()
