"""Batched window extraction for the megabatch scheduler's H2D staging.

One stream's contribution to a stacked device pass is a run of ring packets
packed into the fused ``pack_window`` layout: ``[prefix_width bytes |
le32 length]`` per row, zero-padded.  The staging buffers themselves
belong to the scheduler (``relay.megabatch``), double-buffered per shape
bucket; the functions here only fill them, byte for byte as the reference
packs them: through the egress core's ``ed_stage_gather`` when the native
library is loaded, with numpy otherwise.
"""

from __future__ import annotations

import numpy as np

from .. import native
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
