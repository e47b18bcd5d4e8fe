"""Batched window extraction for the megabatch scheduler's H2D staging.

One stream's contribution to a stacked device pass is a run of ring packets
packed into the fused ``pack_window`` layout: ``[prefix_width bytes |
le32 length]`` per row, zero-padded.  The staging buffers themselves
belong to the scheduler (``relay.megabatch``), double-buffered per shape
bucket; the functions here only fill them, byte for byte as the reference
packs them: from a ring's own pre-packed rows when it keeps them (the VOD
tier's ``vod.cache.StagedPacketRing``), else through the egress core's
``ed_stage_gather`` when the native library is loaded, with numpy
otherwise.

The FEC tier's device pass stages one window of whole ring rows at a time
(``stage_fec_rows``) into a ``PinnedStage``: host buffers, page-locked
when they feed a card, that are written again only after the CUDA event
recorded behind their last copy has completed.

The relay tiers' copies between host and device go through ``upload``
and ``readback`` (the device ring's appends through ``count_upload``),
which count the bytes of the tensors they copy in ``COPIED``: the
figure that ``tpu_h2d_bytes_total`` and ``tpu_d2h_bytes_total``, bumped
where the reference bumps them, are held to.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import native
from . import kernel_lib
from .fanout import WINDOW_EXTRA
from .parse import PARSE_PREFIX

#: bytes per fused staging row (prefix + trailing le32 length)
ROW_STRIDE = PARSE_PREFIX + WINDOW_EXTRA


def pow2(n: int, lo: int) -> int:
    """Smallest power-of-two multiple of ``lo`` (itself a power of two)
    that is >= ``n`` — the one bucket-shape rounding rule."""
    p = lo
    while p < n:
        p <<= 1
    return p


def rows_per_shard(n_rows: int, n_shards: int) -> int:
    """Stream rows each of ``n_shards`` devices stages for a bucket of
    ``n_rows`` real streams: the pow2-padded per-shard block (min 1)."""
    return pow2((max(n_rows, 1) + n_shards - 1) // n_shards, 1)


def pack_rows(data: np.ndarray, length: np.ndarray,
              out_rows: np.ndarray | None = None,
              prefix_width: int = PARSE_PREFIX) -> np.ndarray:
    """Vectorized pack of ``[N, slot]`` packet bytes + lengths into fused
    staging rows (``[N(+pad), ROW_STRIDE]``: prefix ∥ le32 length)."""
    n = len(length)
    if out_rows is None:
        out_rows = np.zeros((n, prefix_width + WINDOW_EXTRA), np.uint8)
    w = min(prefix_width, data.shape[1])
    out_rows[:n, :w] = data[:, :w]
    lens = np.ascontiguousarray(length, "<u4")
    out_rows[:n, prefix_width:prefix_width + 4] = lens[:, None].view(np.uint8)
    out_rows[:n, prefix_width + 4:] = 0
    out_rows[n:] = 0
    return out_rows


def gather_window(ring, start: int, count: int, out_rows: np.ndarray,
                  prefix_width: int = PARSE_PREFIX) -> int:
    """Pack ``count`` packets from absolute id ``start`` of ``ring`` (a
    ``relay.ring.PacketRing``) into ``out_rows`` ([rows, stride] uint8,
    rows >= count) in the fused window layout; zero-fills the padding
    rows.  Returns the number of live rows staged (clamped to the ring's
    live window)."""
    start = max(start, ring.tail)
    stop = min(start + count, ring.head)
    n = max(stop - start, 0)
    if n > out_rows.shape[0]:
        raise ValueError(f"staging buffer too small: {n} > "
                         f"{out_rows.shape[0]} rows")
    if n == 0:
        out_rows[:] = 0
        return 0
    slots = (np.arange(start, stop) % ring.capacity).astype(np.int32)
    staged = getattr(ring, "staged", None)
    if staged is not None and prefix_width == PARSE_PREFIX:
        # the ring keeps its fused rows current: one row copy, no packing
        out_rows[:n] = staged[slots]
        out_rows[n:] = 0
        return n
    if native.loaded():
        # the same bytes in one C walk (``ed_stage_gather``)
        r = native.stage_gather(ring.data, ring.length, slots, prefix_width,
                                out_rows)
        if r != n:
            raise ValueError(f"ed_stage_gather refused its arguments ({r})")
        return n
    out_rows[:n, :prefix_width] = ring.data[slots, :prefix_width]
    lens = np.ascontiguousarray(ring.length[slots], "<u4")
    out_rows[:n, prefix_width:prefix_width + 4] = lens[:, None].view(np.uint8)
    out_rows[:n, prefix_width + 4:] = 0
    out_rows[n:] = 0
    return n


#: bytes the relay tiers copied to the device (``h2d``) and back
#: (``d2h``), counted from the copied tensors; guarded by ``_COPIED_LOCK``
COPIED = {"h2d": 0, "d2h": 0}
_COPIED_LOCK = threading.Lock()


def count_upload(*tensors: torch.Tensor) -> None:
    """Count ``tensors`` as copied to the device (a copy made elsewhere,
    such as the device ring's slice copies)."""
    with _COPIED_LOCK:
        COPIED["h2d"] += sum(t.nbytes for t in tensors)


def upload(src: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``src`` on ``dev``: a non-blocking copy on a card (from pinned
    memory, so a caller reuses ``src`` only after an event recorded
    behind it), ``src`` itself on the CPU; its bytes counted."""
    count_upload(src)
    return src.to(dev, non_blocking=True)


def readback(src: torch.Tensor, dst: torch.Tensor | None = None
             ) -> torch.Tensor:
    """``src`` copied into the host tensor ``dst`` (non-blocking: valid
    once an event recorded behind it has completed), or, without ``dst``,
    into a new host tensor by a blocking copy; its bytes counted."""
    with _COPIED_LOCK:
        COPIED["d2h"] += src.nbytes
    if dst is None:
        return src.cpu()
    return dst.copy_(src, non_blocking=True)


class PinnedStage:
    """Host buffers for one caller's H2D and D2H copies, one per (name,
    shape, dtype), page-locked when ``pin``; ``buffer`` waits on the event
    recorded behind the last copies (``record``) before it hands a buffer
    out again."""

    def __init__(self, pin: bool):
        self.pin = pin
        self._bufs: dict[tuple, torch.Tensor] = {}
        self.event = None

    def buffer(self, name: str, shape: tuple, dtype=torch.uint8
               ) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()       # the last copies from it are done
            self.event = None
        key = (name, tuple(shape), dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(shape, dtype=dtype,
                                                pin_memory=self.pin)
        return buf

    def record(self) -> None:
        """Mark the copies just enqueued on the current stream."""
        if self.pin:
            self.event = torch.cuda.Event()
            self.event.record()


class DeviceTimer:
    """The device time of one wrapper call's kernels, taken by ``with
    timer:`` around the call.  On a card: a ``kernel_lib.TimingPair``, two
    timing CUDA events on the timer's device that the launching entry
    points themselves record, the start just before the call's first
    launch and the stop just after each (``kernel_lib.timed``), so the
    pair holds the kernels and not the host's preparation of their
    arguments (only the host's time inside the launch calls, where the
    card waits for the kernel to arrive).  On the CPU, or with ``enabled``
    False (as ``EDTPU_PROFILE=0`` asks): host ``perf_counter_ns`` around
    the call and no event at all.  ``ns()`` reads the card's pair only
    once the caller knows the work is done (its own readiness check or a
    wait it makes anyway): it never synchronises for a metric; a call that
    launched nothing reads 0."""

    __slots__ = ("pair", "t0", "t1", "_ctx")

    def __init__(self, device: torch.device, enabled: bool = True):
        self.pair = (kernel_lib.timing_pair(device)
                     if enabled and device.type == "cuda" else None)
        self.t0 = self.t1 = 0
        self._ctx = None

    @property
    def launched(self) -> bool:
        return self.pair is not None and bool(self.pair.started)

    def __enter__(self) -> "DeviceTimer":
        if self.pair is not None:
            self._ctx = kernel_lib.timed(self)
            self._ctx.__enter__()
        else:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
            self._ctx = None
        else:
            self.t1 = time.perf_counter_ns()

    def ns(self) -> int:
        if self.pair is not None:
            if not self.pair.started:
                return 0
            return int(kernel_lib.timing_ms(self.pair) * 1e6)
        return self.t1 - self.t0

    def __del__(self) -> None:
        if self.pair is not None and self.pair.start:
            kernel_lib.timing_close(self.pair)


def stage_fec_rows(ring, slots: np.ndarray, lens: np.ndarray,
                   out_rows: np.ndarray) -> None:
    """Window rows for the GF parity pass: ``out_rows [k, B]`` gets the
    ring bytes of ``slots`` (as many as fit in a slot or in ``B``), zero
    past each packet's length (a slot may hold an earlier occupant's bytes
    there) and zero rows below the window's packets."""
    n = len(slots)
    b_pad = out_rows.shape[1]
    width = min(b_pad, ring.data.shape[1])
    out_rows[:] = 0
    out_rows[:n, :width] = ring.data[slots, :width]
    out_rows[:n][np.arange(b_pad)[None, :] >= np.asarray(lens)[:, None]] = 0
