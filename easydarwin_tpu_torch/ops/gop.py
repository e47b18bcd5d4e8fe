"""GOP bookkeeping as masked reductions over a packet window.

The reflector keeps its newest IDR-start packet by checking each packet on
ingest and walking pointers; over a window on the device the same facts are
reductions.  Each function takes ``[..., P]`` tensors and reduces the last
axis, returning int32 (−1 = none).
"""

from __future__ import annotations

import torch


def _idx(like: torch.Tensor) -> torch.Tensor:
    return torch.arange(like.shape[-1], dtype=torch.int64, device=like.device)


def newest_keyframe(keyframe_first: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Index of the newest valid keyframe-first packet, or −1."""
    idx = _idx(keyframe_first)
    cand = torch.where(keyframe_first & valid, idx, torch.full_like(idx, -1))
    return cand.amax(dim=-1).to(torch.int32)


def gop_window_mask(keyframe_first: torch.Tensor, valid: torch.Tensor,
                    frame_last: torch.Tensor) -> torch.Tensor:
    """Bool mask of the current (newest) GOP: every valid packet from the
    newest keyframe-first onward (what a late joiner is replayed)."""
    start = newest_keyframe(keyframe_first, valid).to(torch.int64)[..., None]
    return valid & (start >= 0) & (_idx(keyframe_first) >= start)


def fast_start_indices(keyframe_first: torch.Tensor, valid: torch.Tensor,
                       age_ms: torch.Tensor, overbuffer_ms: int
                       ) -> torch.Tensor:
    """First packet a brand-new output should receive: the newest in-window
    keyframe if one exists, else the oldest packet younger than the
    over-buffer window, else the newest valid packet."""
    n = keyframe_first.shape[-1]
    idx = _idx(keyframe_first)
    age_ok = valid & (age_ms.to(torch.int64) <= overbuffer_ms)
    kf = newest_keyframe(keyframe_first & age_ok, valid).to(torch.int64)
    oldest_young = torch.where(age_ok, idx, torch.full_like(idx, n)).amin(-1)
    newest_valid = torch.where(valid, idx, torch.full_like(idx, -1)).amax(-1)
    fallback = torch.where(oldest_young < n, oldest_young, newest_valid)
    return torch.where(kf >= 0, kf, fallback).to(torch.int32)
