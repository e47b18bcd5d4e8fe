"""Per-stream device-resident packet ring, and its query kernel
``ed_ring_query``.

The counterpart of the reference's ``easydarwin_tpu/ops/device_ring.py``:
a stream that the megabatch scheduler does not own keeps its
classification window on the device, each wake appends only the new
packets, and a query runs over the resident window without staging it
again.  The port keeps the ring in the fused window layout the other relay
kernels read (``ops.fanout.pack_window``):

* ``rows``    ``[C, 96+4]`` uint8 — the packet prefix, then its le32 length
* ``arrival`` ``[C]`` int32       — arrival ms against the owner's epoch
* ``head``    host int            — packets ever appended

``append`` writes the new rows at ``head % C`` by at most two slice copies
(split at the seam), in place: the state is updated and returned.  On a
card the rows come from pinned host staging as asynchronous H2D copies.

``query`` returns the reference's dict (``relay_affine_step`` over the
ring plus the absolute-id mapping ``head − ((head − s − 1) mod C) − 1``)
in plain PyTorch on either device.  ``query_params`` is the engine's call:
the packed ``[4·S + 1]`` uint32 row ``ops.fanout.unpack_affine`` reads,
whose last word is the newest keyframe as an *absolute* id (−1 = none).
On a CUDA ring it is one launch of the hand-written ``ed_ring_query``
(``csrc/relay_kernels.cu``): one CTA per ``RING_TILE_ROWS``-row tile that
also writes its share of the subscribers' columns, and a fold of the
tiles' maxima by the last CTA to arrive, through the ring's own
``scratch`` (``ring_query_plan``).  On a CPU ring it runs
``query_params_plain``, the same function in plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from . import kernel_lib
from .fanout import (STATE_COLS, WINDOW_EXTRA, affine_params,
                     relay_affine_step, window_lengths)
from .parse import PARSE_PREFIX, i64_from_u32, parse_packets, u32_from_i64

#: bytes per ring row: the prefix and its le32 length
ROW_STRIDE = PARSE_PREFIX + WINDOW_EXTRA
#: rows (and threads) per CTA of ``ed_ring_query`` (``kRingTileRows`` in
#: ``csrc/relay_kernels.cu``; chip_smoke.py checks it against the
#: library's ``ed_relay_geometry``)
RING_TILE_ROWS = 128
#: ``head`` stays an int32 on the card; an owner restarts its ring before
MAX_HEAD = (1 << 31) - (1 << 20)


def ring_tiles(capacity: int) -> int:
    """CTAs of one ``ed_ring_query`` launch."""
    return -(-capacity // RING_TILE_ROWS)


@dataclass
class RingState:
    rows: torch.Tensor          # [C, ROW_STRIDE] uint8
    arrival: torch.Tensor       # [C] int32
    #: [ring_tiles(C) + 1] int32: the query's per-tile maxima, then its
    #: arrival counter (0 between queries: each query resets it)
    scratch: torch.Tensor
    head: int = 0

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    @property
    def prefix(self) -> torch.Tensor:
        """``[C, 96]`` uint8 view of the packet prefixes."""
        return self.rows[:, :PARSE_PREFIX]

    @property
    def length(self) -> torch.Tensor:
        """``[C]`` int32 lengths decoded from the rows."""
        return window_lengths(self.rows[None])[0].to(torch.int32)


def init_ring(capacity: int, device: str | torch.device = "cuda"
              ) -> RingState:
    dev = resolve_device(device)
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    return RingState(
        torch.zeros((capacity, ROW_STRIDE), dtype=torch.uint8, device=dev),
        torch.zeros(capacity, dtype=torch.int32, device=dev),
        torch.zeros(ring_tiles(capacity) + 1, dtype=torch.int32, device=dev))


def _seam(head: int, capacity: int, n: int):
    """The ``(ring_lo, ring_hi, src_lo)`` slices ``n`` rows at ``head``
    occupy: one, or two when they cross the seam."""
    pos = head % capacity
    first = min(n, capacity - pos)
    spans = [(pos, pos + first, 0)]
    if n > first:
        spans.append((0, n - first, first))
    return spans


def append_rows(state: RingState, rows: torch.Tensor, arrival: torch.Tensor,
                n_new: int) -> RingState:
    """Append the first ``n_new`` of ``rows`` ``[B, ROW_STRIDE]`` uint8
    and ``arrival`` ``[B]`` int32 (on the ring's device, or pinned host
    memory for a card ring): at most two slice copies each, non-blocking,
    so a caller recycles pinned staging only after a CUDA event recorded
    behind them."""
    n = int(n_new)
    if not 0 <= n <= min(rows.shape[0], state.capacity):
        raise ValueError(f"n_new={n} for {rows.shape[0]} rows and capacity "
                         f"{state.capacity}")
    if rows.dtype != torch.uint8 or tuple(rows.shape[1:]) != (ROW_STRIDE,):
        raise ValueError(f"rows must be [B, {ROW_STRIDE}] uint8, got "
                         f"{rows.dtype}{tuple(rows.shape)}")
    if state.head + n > MAX_HEAD:
        raise OverflowError("ring head would pass int32 range; restart it")
    for lo, hi, src in _seam(state.head, state.capacity, n):
        state.rows[lo:hi].copy_(rows[src:src + hi - lo], non_blocking=True)
        state.arrival[lo:hi].copy_(arrival[src:src + hi - lo],
                                   non_blocking=True)
    state.head += n
    return state


def append(state: RingState, new_prefix, new_length, new_arrival,
           n_new) -> RingState:
    """The reference's ``append``: the first ``n_new`` of the
    ``[B, 96]`` prefixes, ``[B]`` lengths and ``[B]`` arrivals."""
    pre = np.asarray(new_prefix, np.uint8)[:, :PARSE_PREFIX]
    rows = np.zeros((pre.shape[0], ROW_STRIDE), np.uint8)
    rows[:, :pre.shape[1]] = pre
    rows[:, PARSE_PREFIX:] = np.ascontiguousarray(
        new_length, "<u4")[:, None].view(np.uint8)
    arr = np.ascontiguousarray(new_arrival, np.int32)
    return append_rows(state, torch.from_numpy(rows).to(state.rows.device),
                       torch.from_numpy(arr).to(state.rows.device),
                       int(n_new))


def abs_ids(head: int, capacity: int, device) -> torch.Tensor:
    """``[C]`` int64: slot ``s`` holds absolute id
    ``head − ((head − s − 1) mod C) − 1`` (negative: never written)."""
    slots = torch.arange(capacity, dtype=torch.int64, device=device)
    return head - torch.remainder(head - slots - 1, capacity) - 1


def _check_state(state: RingState, out_state: torch.Tensor) -> None:
    if out_state.dim() != 2 or out_state.shape[1] != STATE_COLS:
        raise ValueError(f"out_state must be [S, {STATE_COLS}], got "
                         f"{tuple(out_state.shape)}")
    if out_state.device != state.rows.device:
        raise ValueError(f"out_state is on {out_state.device}, the ring on "
                         f"{state.rows.device}")


def query(state: RingState, out_state: torch.Tensor, now_ms) -> dict:
    """``relay_affine_step`` over the resident window, plus ``abs_id``,
    ``valid``, ``newest_keyframe_abs`` (−1 if none) and ``age_ms`` — the
    reference's ``query``, in plain PyTorch."""
    _check_state(state, out_state)
    length = state.length
    res = relay_affine_step(state.prefix, length, out_state)
    ids = abs_ids(state.head, state.capacity, length.device)
    valid = (ids >= 0) & (ids < state.head) & (length > 0)
    kf = res["keyframe_first"] & valid
    newest = torch.where(kf, ids, torch.full_like(ids, -1)).amax()
    now = torch.tensor(int(now_ms), dtype=torch.int32, device=length.device)
    return {**res, "abs_id": ids.to(torch.int32), "valid": valid,
            "newest_keyframe_abs": newest.to(torch.int32),
            "age_ms": now - state.arrival}


def query_params_plain(state: RingState, out_state: torch.Tensor
                       ) -> torch.Tensor:
    """``ed_ring_query`` in plain PyTorch: ``seq_off[S] ∥ ts_off[S] ∥
    ssrc[S] ∥ chan[S] ∥ newest keyframe abs id`` as ``[4·S + 1]`` uint32
    (−1 rides as 0xFFFFFFFF)."""
    _check_state(state, out_state)
    length = state.length
    kf = parse_packets(state.prefix, length)["keyframe_first"]
    ids = abs_ids(state.head, state.capacity, length.device)
    kf = kf & (length > 0) & (ids >= 0) & (ids < state.head)
    newest = torch.where(kf, ids, torch.full_like(ids, -1)).amax()
    cols = [i64_from_u32(c) for c in affine_params(out_state)]
    return u32_from_i64(torch.cat(cols + [newest[None]]))


def ring_query_plan(capacity: int, n_subs: int, addr: int) -> dict:
    """``ed_ring_query``'s grid as the kernel computes it: one CTA per
    ``RING_TILE_ROWS``-row tile, with its rows ``[lo, hi)``, the head, bulk
    interior and tail of its bytes from byte ``addr``, and the subscribers
    ``[lo, hi)`` it emits while its copy is in flight; ``scratch_words``
    int32 of scratch (the per-tile maxima, then the arrival counter)."""
    n_tiles = ring_tiles(capacity)
    tiles, emit = [], []
    for k in range(n_tiles):
        lo, hi = k * RING_TILE_ROWS, min((k + 1) * RING_TILE_ROWS, capacity)
        tiles.append((lo, hi, *kernel_lib.bulk_split(addr + lo * ROW_STRIDE,
                                                     (hi - lo) * ROW_STRIDE)))
        emit.append((k * n_subs // n_tiles, (k + 1) * n_subs // n_tiles))
    return {"tiles": tiles, "emit": emit, "grid": n_tiles,
            "threads": RING_TILE_ROWS, "scratch_words": n_tiles + 1}


def query_params(state: RingState, out_state: torch.Tensor) -> torch.Tensor:
    """The engine's per-stream query → ``[4·S + 1]`` uint32 on the ring's
    device.  A CUDA ring makes ONE ``ed_ring_query`` launch (or raises); a
    CPU ring runs ``query_params_plain``.  Queries of one ring must stay
    ordered on one stream (they share its scratch)."""
    dev = state.rows.device
    if dev.type == "cpu":
        return query_params_plain(state, out_state)
    if dev.type != "cuda":
        raise ValueError(f"no ring query kernel for device {dev}")
    _check_state(state, out_state)
    kernel_lib.require(state.rows, "rows", torch.uint8, 2, dev)
    kernel_lib.require(out_state, "out_state", torch.uint32, 2, dev)
    kernel_lib.require(state.scratch, "scratch", torch.int32, 1, dev)
    if state.rows.shape[1] != ROW_STRIDE:
        raise ValueError(f"ring rows must be {ROW_STRIDE} bytes wide")
    if state.scratch.shape[0] != ring_tiles(state.capacity) + 1:
        raise ValueError(f"scratch must hold {ring_tiles(state.capacity) + 1}"
                         f" int32, got {state.scratch.shape[0]}")
    n_subs = out_state.shape[0]
    out = torch.empty(4 * n_subs + 1, dtype=torch.int32, device=dev)
    kernel_lib.launch("ed_ring_query", state.rows.data_ptr(), state.capacity,
                      ROW_STRIDE, state.head, out_state.data_ptr(), n_subs,
                      state.scratch.data_ptr(), out.data_ptr())
    return out.view(torch.uint32)
