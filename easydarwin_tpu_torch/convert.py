"""Carry state from the reference's numpy arrays into the port.

The system has no learned weights: what two implementations must share to
compute on the same state is the subscriber rewrite state, the packet
ring's contents and, for the transcode ladder, its quant tables.  All
arrive here as plain numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .relay.ring import PacketRing


def state_from_numpy(out_state_u32, device: str | torch.device = "cuda"
                     ) -> torch.Tensor:
    """A ``[..., S, 6]`` uint32 rewrite-state array (as the reference's
    ``pack_output_state`` gives it) → the port's uint32 tensor on
    ``device``."""
    arr = np.ascontiguousarray(out_state_u32)
    if arr.dtype != np.uint32:
        raise TypeError(f"out_state must be uint32, got {arr.dtype}")
    if arr.ndim < 2 or arr.shape[-1] != 6:
        raise ValueError(f"out_state must be [..., S, 6], got {arr.shape}")
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def ring_from_arrays(data, length, arrival, seq, timestamp, flags,
                     head: int, tail: int, capacity: int, *,
                     is_video: bool = True,
                     codec: str | None = None) -> PacketRing:
    """A port ``PacketRing`` holding a copy of the reference ring's slots
    and cursors.  ``data`` is ``[capacity, slot]`` uint8; the per-slot
    vectors are ``[capacity]``.  SSRCs are re-read from the packet bytes."""
    data = np.asarray(data, np.uint8)
    if data.shape[0] != capacity:
        raise ValueError(f"data has {data.shape[0]} slots, capacity {capacity}")
    if not 0 <= tail <= head or head - tail > capacity:
        raise ValueError(f"bad cursors tail={tail} head={head}")
    ring = PacketRing(capacity, slot_size=data.shape[1], is_video=is_video,
                      codec=codec)
    ring.data[:] = data
    ring.length[:] = np.asarray(length, np.int32)
    ring.arrival[:] = np.asarray(arrival, np.int64)
    ring.seq[:] = np.asarray(seq, np.int32)
    ring.timestamp[:] = np.asarray(timestamp, np.int64)
    ring.flags[:] = np.asarray(flags, np.int32)
    b = data[:, 8:12].astype(np.int64)
    ring.ssrc[:] = np.where(ring.length >= 12,
                            (b[:, 0] << 24) | (b[:, 1] << 16)
                            | (b[:, 2] << 8) | b[:, 3], 0)
    ring.head = int(head)
    ring.tail = int(tail)
    return ring


def transcode_tables_from_numpy(qt_in, qt_rungs,
                                device: str | torch.device = "cuda"
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The transcode pipeline's quant tables (its parameters): the source
    table ``[64]`` and the rung tables ``[R, 64]``, as the reference's
    ``quality_table`` gives them → f32 tensors on ``device``."""
    dev = resolve_device(device)
    qi = np.asarray(qt_in)
    qr = np.asarray(qt_rungs)
    if qi.shape != (64,):
        raise ValueError(f"qt_in must be [64], got {qi.shape}")
    if qr.ndim != 2 or qr.shape[1] != 64 or qr.shape[0] < 1:
        raise ValueError(f"qt_rungs must be [R>=1, 64], got {qr.shape}")
    for name, a in (("qt_in", qi), ("qt_rungs", qr)):
        if a.dtype.kind not in "fiu":
            raise TypeError(f"{name} must be numeric, got {a.dtype}")
        if not np.all(np.isfinite(a)) or np.any(a <= 0):
            raise ValueError(f"{name} entries must be finite and positive")
    return (torch.from_numpy(qi.astype(np.float32)).to(dev),
            torch.from_numpy(np.array(qr, np.float32)).to(dev))
