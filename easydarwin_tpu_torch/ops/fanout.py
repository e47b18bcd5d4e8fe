"""Per-subscriber fan-out as batched tensor work, and the megabatch window
pass.

The per-subscriber rewrite is *affine*: ``seq' = seq + (out_seq_start −
base_src_seq) mod 2¹⁶``, ``ts' = ts + (out_ts_start − base_src_ts) mod
2³²``, SSRC constant per output.  So the device returns O(S) offsets per
stream instead of O(S·P) headers, and the host egress applies them while
it writes the wire.

``relay_affine_step_windows`` is the megabatch's device pass for a whole
wake: on CUDA tensors it makes ONE launch of the hand-written
``ed_relay_window`` kernel (K1's parse fused with the keyframe reduction
and the affine emit) for every ``(window, state)`` bucket, by the plan of
``window_launch_plan``; on CPU tensors it runs
``relay_affine_step_window_plain``, the same function in plain PyTorch,
once per bucket.  ``relay_affine_step_window`` is its group of one.  A
stream row wider than one cluster's shared memory holds (a VOD window of
more than ``window_max_rows`` packets) is cut into pieces that run as
rows of their own, and the pieces' results are merged back
(``split_wide_windows``, on either device).

``relay_batch_step`` (B9) is one source's full step for the engine's
batch-header rung: the parse, the ``[S, P, 12]`` headers, the ``[S, P]``
eligibility mask and the newest keyframe.  On CUDA tensors it is ONE
launch of the hand-written ``ed_relay_batch`` (K1's parse fused in; B8's
kernel as its one-source, one-shard case); on CPU tensors it runs
``relay_batch_step_plain``.  ``pack_batch_upload`` and
``batch_upload_views`` lay its five inputs out as one buffer, so the engine
uploads a pass in one copy.  ``relay_shard_step`` is B8's step for the
mesh shards of one device (``parallel.mesh``): B9's function over each
shard's block of sources, as ONE ``ed_relay_shard`` launch for all of
them, writing into the whole result's views.

All arithmetic on 32-bit quantities runs in int64 masked to 16/32 bits;
values become uint32 only at the output boundary (``u32_from_i64``).
"""

from __future__ import annotations

import ctypes
import itertools
from dataclasses import dataclass

import numpy as np
import torch

from . import kernel_lib
from .gop import newest_keyframe
from .parse import (PARSE_PREFIX, check_prefix, i64_from_u32, parse_packets,
                    u32_from_i64)
from .parse_kernel import parse_packets_kernel

#: columns of the per-output state matrix: ssrc, base_src_seq,
#: base_src_ts, out_seq_start, out_ts_start, chan (the RTSP-interleave
#: channel byte for TCP outputs; CHAN_NONE for datagram subscribers)
STATE_COLS = 6
#: chan column sentinel for outputs with no interleave framing
CHAN_NONE = 0xFFFFFFFF
#: bytes appended to each packet prefix to carry its length (le32)
WINDOW_EXTRA = 4


def pack_output_state(outputs) -> np.ndarray:
    """Host helper: RelayOutput list → [S, STATE_COLS] uint32 state."""
    st = np.zeros((len(outputs), STATE_COLS), dtype=np.uint32)
    for i, o in enumerate(outputs):
        rw = o.rewrite
        ch = getattr(o, "interleave_chan", None)
        st[i] = (rw.ssrc, max(rw.base_src_seq, 0), max(rw.base_src_ts, 0),
                 rw.out_seq_start, rw.out_ts_start,
                 CHAN_NONE if ch is None else (ch & 0xFF))
    return st


def affine_params(out_state: torch.Tensor):
    """``[..., S, STATE_COLS]`` state → per-output ``(seq_off, ts_off,
    ssrc, chan)`` uint32 — the one definition of the affine rewrite in
    terms of the state layout."""
    st = i64_from_u32(out_state)
    return (u32_from_i64((st[..., 3] - st[..., 1]) & 0xFFFF),
            u32_from_i64(st[..., 4] - st[..., 2]),
            u32_from_i64(st[..., 0]),
            u32_from_i64(st[..., 5]))


def _be_bytes(v: torch.Tensor, n: int) -> list[torch.Tensor]:
    return [(v >> (8 * (n - 1 - i))) & 0xFF for i in range(n)]


def fanout_headers(b01: torch.Tensor, seq: torch.Tensor, ts: torch.Tensor,
                   out_state: torch.Tensor) -> torch.Tensor:
    """Rendered headers: b01 [P, 2] uint8 (source bytes 0-1) · seq/ts [P]
    · out_state [S, STATE_COLS] → [S, P, 12] uint8.  Bytes 0-1 are the
    source's, so ``header ∥ packet[12:]`` equals ``rtp.rewrite_header``."""
    seq = i64_from_u32(seq)
    ts = i64_from_u32(ts)
    st = i64_from_u32(out_state)
    S, P = st.shape[0], seq.shape[0]
    new_seq = (seq[None, :] - st[:, 1:2] + st[:, 3:4]) & 0xFFFF
    new_ts = (ts[None, :] - st[:, 2:3] + st[:, 4:5]) & 0xFFFFFFFF
    ssrc = st[:, 0:1].expand(S, P)
    b = b01.to(torch.int64)
    cols = ([b[None, :, 0].expand(S, P), b[None, :, 1].expand(S, P)]
            + _be_bytes(new_seq, 2) + _be_bytes(new_ts, 4)
            + _be_bytes(ssrc, 4))
    return torch.stack(cols, dim=-1).to(torch.uint8)


def eligibility(age_ms: torch.Tensor, bucket_of_output: torch.Tensor,
                bucket_delay_ms: int) -> torch.Tensor:
    """[S, P] bool: packet p may be sent to output s this pass (bucket b
    waits b × bucket_delay_ms).  ``age_ms`` is ``now − arrival``."""
    min_age = bucket_of_output.to(torch.int64) * int(bucket_delay_ms)
    return age_ms[None, :].to(torch.int64) >= min_age[:, None]


#: ``ed_relay_batch``'s tile and limits (``kBatch*`` in
#: ``csrc/relay_kernels.cu``; chip_smoke.py checks them against the
#: library's ``ed_relay_batch_geometry``, the tests against the source):
#: a CTA parses a 64-row tile for 4 outputs, 1 <= P <= 65,536 packets
#: and 1 <= S <= 65,536 outputs a pass
BATCH_TILE_ROWS = 64
BATCH_SUBS_PER_CTA = 4
BATCH_MAX_PKTS = 1 << 16
BATCH_MAX_SUBS = 1 << 16
#: the fold's scratch: one 64-bit word (the newest keyframe + 1 above, the
#: tiles that have reported below), which every pass leaves at 0
BATCH_SCRATCH_WORDS = 2


def check_batch_args(prefix: torch.Tensor, length: torch.Tensor,
                     age_ms: torch.Tensor, out_state: torch.Tensor,
                     bucket_of_output: torch.Tensor) -> None:
    """What ``ed_relay_batch`` takes, on either device: ``prefix``
    ``[P, W]`` uint8 with 96 <= W and a 64-row tile of W-byte rows inside
    ``kernel_lib.DYN_SMEM_LIMIT``, ``length`` and ``age_ms`` int32 ``[P]``,
    ``out_state`` uint32 ``[S, STATE_COLS]``, ``bucket_of_output`` int32
    ``[S]``, 1 <= P <= ``BATCH_MAX_PKTS``, 1 <= S <= ``BATCH_MAX_SUBS``,
    all on one device."""
    check_prefix(prefix)
    if prefix.dtype != torch.uint8:
        raise TypeError(f"prefix must be torch.uint8, got {prefix.dtype}")
    n_pkts, width = prefix.shape
    if BATCH_TILE_ROWS * width + kernel_lib.BULK_ALIGN > \
            kernel_lib.DYN_SMEM_LIMIT:
        raise ValueError(f"row stride {width} too wide for a "
                         f"{BATCH_TILE_ROWS}-row tile in shared memory")
    if not 1 <= n_pkts <= BATCH_MAX_PKTS:
        raise ValueError(f"P = {n_pkts} packets is outside 1..{BATCH_MAX_PKTS}")
    if out_state.dim() != 2 or out_state.shape[1] != STATE_COLS:
        raise ValueError(f"out_state must be [S, {STATE_COLS}], got "
                         f"{tuple(out_state.shape)}")
    if out_state.dtype != torch.uint32:
        raise TypeError(f"out_state must be torch.uint32, got "
                        f"{out_state.dtype}")
    n_subs = out_state.shape[0]
    if not 1 <= n_subs <= BATCH_MAX_SUBS:
        raise ValueError(f"S = {n_subs} outputs is outside 1..{BATCH_MAX_SUBS}")
    for name, t, n in (("length", length, n_pkts), ("age_ms", age_ms, n_pkts),
                       ("bucket_of_output", bucket_of_output, n_subs)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    for name, t in (("length", length), ("age_ms", age_ms),
                    ("out_state", out_state),
                    ("bucket_of_output", bucket_of_output)):
        if t.device != prefix.device:
            raise ValueError(f"{name} is on {t.device}, prefix on "
                             f"{prefix.device}")


def relay_batch_step_plain(prefix: torch.Tensor, length: torch.Tensor,
                           age_ms: torch.Tensor, out_state: torch.Tensor,
                           bucket_of_output: torch.Tensor,
                           bucket_delay_ms: int) -> dict[str, torch.Tensor]:
    """B9 in plain PyTorch (K1's parse through ``parse_packets_kernel``):
    the arguments and results of ``relay_batch_step``."""
    fields = parse_packets_kernel(prefix, length)
    headers = fanout_headers(prefix[:, :2], fields["seq"],
                             fields["timestamp"], out_state)
    mask = eligibility(age_ms, bucket_of_output, bucket_delay_ms)
    return {
        "headers": headers,
        "mask": mask & (length >= 12)[None, :],
        "keyframe_first": fields["keyframe_first"],
        "newest_keyframe": newest_keyframe(fields["keyframe_first"],
                                           length > 0),
        "frame_last": fields["frame_last"],
    }


def relay_batch_step(prefix: torch.Tensor, length: torch.Tensor,
                     age_ms: torch.Tensor, out_state: torch.Tensor,
                     bucket_of_output: torch.Tensor,
                     bucket_delay_ms: int) -> dict[str, torch.Tensor]:
    """One source's device step for the batch-header rung: ``prefix``
    ``[P, W>=96]`` uint8, ``length`` ``[P]`` int32, ``age_ms`` ``[P]``
    int32 (now − arrival), ``out_state`` ``[S, STATE_COLS]`` uint32,
    ``bucket_of_output`` ``[S]`` int32 → ``headers`` ``[S, P, 12]`` uint8,
    ``mask`` ``[S, P]`` (bucket-eligible and ``length >= 12``),
    ``keyframe_first`` and ``frame_last`` ``[P]``, ``newest_keyframe``
    (−1 = none).  Rows of length 0 (padding) are never keyframes and never
    sendable.  CUDA tensors make ONE ``ed_relay_batch`` launch; CPU tensors
    run ``relay_batch_step_plain``."""
    check_batch_args(prefix, length, age_ms, out_state, bucket_of_output)
    dev = prefix.device
    if dev.type == "cpu":
        return relay_batch_step_plain(prefix, length, age_ms, out_state,
                                      bucket_of_output, bucket_delay_ms)
    if dev.type != "cuda":
        raise ValueError(f"no batch-step kernel for device {dev}")
    for name, t in (("prefix", prefix), ("length", length),
                    ("age_ms", age_ms), ("out_state", out_state),
                    ("bucket_of_output", bucket_of_output)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_pkts, width = prefix.shape
    n_subs = out_state.shape[0]
    headers = torch.empty((n_subs, n_pkts, 12), dtype=torch.uint8, device=dev)
    mask = torch.empty((n_subs, n_pkts), dtype=torch.bool, device=dev)
    flags = torch.empty((2, n_pkts), dtype=torch.bool, device=dev)
    newest = torch.empty((), dtype=torch.int32, device=dev)
    kernel_lib.launch(
        "ed_relay_batch", prefix.data_ptr(), n_pkts, width, length.data_ptr(),
        age_ms.data_ptr(), out_state.data_ptr(), bucket_of_output.data_ptr(),
        n_subs, int(bucket_delay_ms), headers.data_ptr(), mask.data_ptr(),
        flags[0].data_ptr(), flags[1].data_ptr(),
        kernel_lib.scratch("ed_relay_batch", BATCH_SCRATCH_WORDS,
                           dev).data_ptr(),
        newest.data_ptr())
    return {"headers": headers, "mask": mask, "keyframe_first": flags[0],
            "newest_keyframe": newest, "frame_last": flags[1]}


#: ``ed_relay_shard``'s geometry and limits (``kShard*`` in
#: ``csrc/relay_kernels.cu``; chip_smoke.py checks them against the
#: library's ``ed_relay_shard_geometry``): a CTA parses a 64-row tile for
#: 64 outputs; a launch takes at most 16 shard descriptors and folds at
#: most 4,096 sources, and runs at most 2^31 − 1 CTAs
SHARD_TILE_ROWS = 64
SHARD_SUBS_PER_CTA = 64
SHARD_MAX_SHARDS = 16
SHARD_MAX_SLOTS = 4096
SHARD_MAX_ITEMS = (1 << 31) - 1
#: the fold's scratch: the launch's ticket (two words), then four words a
#: source slot (its ticket and its keyframe word, 64 bits each)
SHARD_SCRATCH_WORDS = 2 + 4 * SHARD_MAX_SLOTS


@dataclass(frozen=True)
class ShardBlock:
    """One mesh shard's block of ``n`` sources for ``relay_shard_step``:
    views whose innermost axes are dense (any stride between sources and,
    for the outputs, between outputs) — ``prefix`` ``[n, P, W>=96]``
    uint8, ``length`` and ``age_ms`` ``[n, P]`` int32, ``out_state``
    ``[n, S, STATE_COLS]`` uint32, ``bucket_of_output`` ``[n, S]`` int32,
    ``headers`` ``[n, S, P, 12]`` uint8 (4-byte aligned), ``mask``
    ``[n, S, P]`` bool and ``newest`` ``[n]`` int32, all on one device.
    The shards of one source block (its ``sub`` and ``win`` shards)
    share one ``newest`` view; ``kf_base`` is the shard's first packet
    along ``win``."""
    prefix: torch.Tensor
    length: torch.Tensor
    age_ms: torch.Tensor
    out_state: torch.Tensor
    bucket_of_output: torch.Tensor
    headers: torch.Tensor
    mask: torch.Tensor
    newest: torch.Tensor
    kf_base: int = 0

    def sources(self, lo: int, hi: int) -> "ShardBlock":
        """The block's sources ``[lo, hi)``, as views."""
        return ShardBlock(*(getattr(self, f)[lo:hi] for f in _SHARD_VIEWS),
                          kf_base=self.kf_base)


_SHARD_VIEWS = ("prefix", "length", "age_ms", "out_state",
                "bucket_of_output", "headers", "mask", "newest")


def check_shard_args(shards, eligible) -> None:
    """What ``relay_shard_step`` takes, on either device: one or more
    ``ShardBlock`` of one geometry (``n``, P, W, S) on one device, and
    ``eligible`` a scalar int64 there."""
    shards = list(shards)
    if not shards:
        raise ValueError("no shard to run")
    geo = None
    for blk in shards:
        prefix, out_state = blk.prefix, blk.out_state
        if prefix.dim() != 3 or out_state.dim() != 3:
            raise ValueError(f"prefix and out_state must be 3-D, got "
                             f"{tuple(prefix.shape)} and "
                             f"{tuple(out_state.shape)}")
        n, p, w = prefix.shape
        s = out_state.shape[1]
        if n < 1:
            raise ValueError("a shard of 0 sources")
        check_batch_args(prefix[0], blk.length[0], blk.age_ms[0],
                         out_state[0], blk.bucket_of_output[0])
        if geo is None:
            geo = (n, p, w, s, prefix.device)
        elif (n, p, w, s, prefix.device) != geo:
            raise ValueError(f"shards of two geometries: {geo} and "
                             f"{(n, p, w, s, prefix.device)}")
        want = (("prefix", prefix, torch.uint8, (n, p, w), (w, 1)),
                ("length", blk.length, torch.int32, (n, p), (1,)),
                ("age_ms", blk.age_ms, torch.int32, (n, p), (1,)),
                ("out_state", out_state, torch.uint32, (n, s, STATE_COLS),
                 (STATE_COLS, 1)),
                ("bucket_of_output", blk.bucket_of_output, torch.int32,
                 (n, s), (1,)),
                ("headers", blk.headers, torch.uint8, (n, s, p, 12),
                 (12, 1)),
                ("mask", blk.mask, torch.bool, (n, s, p), (1,)),
                ("newest", blk.newest, torch.int32, (n,), (1,)))
        for name, t, dtype, shape, inner in want:
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got "
                                 f"{list(t.shape)}")
            if t.dtype != dtype:
                raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
            if tuple(t.stride()[-len(inner):]) != inner:
                raise ValueError(f"{name}'s inner strides must be {inner}, "
                                 f"got {t.stride()}")
            if t.device != prefix.device:
                raise ValueError(f"{name} is on {t.device}, prefix on "
                                 f"{prefix.device}")
        h = blk.headers
        if (h.data_ptr() | h.stride(0) | h.stride(1)) & 3:
            raise ValueError("headers must be 4-byte aligned")
        if not 0 <= blk.kf_base <= 1 << 30:
            raise ValueError(f"kf_base {blk.kf_base} is outside 0..2^30")
    if (tuple(eligible.shape) != () or eligible.dtype != torch.int64
            or eligible.device != geo[4]):
        raise ValueError(f"eligible must be a scalar int64 on {geo[4]}, got "
                         f"{eligible.dtype}{list(eligible.shape)} on "
                         f"{eligible.device}")


@dataclass(frozen=True)
class ShardLaunch:
    """One ``ed_relay_shard`` launch: its shards (each cut to its share of
    its block's sources), each shard's first fold slot (the shards of one
    block share theirs), the shards of its block (``parts``) and its
    first CTA, the CTAs and slots in all, and whether it adds to
    ``eligible`` (every launch of a call but the first) or writes it."""
    shards: tuple[ShardBlock, ...]
    slot0: tuple[int, ...]
    parts: tuple[int, ...]
    first_item: tuple[int, ...]
    n_items: int
    n_sources: int
    accumulate: bool


def shard_items(n_pkts: int, n_subs: int) -> int:
    """The CTAs of one source of one shard: tiles × output groups."""
    return -(-n_pkts // SHARD_TILE_ROWS) * -(-n_subs // SHARD_SUBS_PER_CTA)


def shard_launch_plan(shards) -> list[ShardLaunch]:
    """The launches that run ``shards`` (checked by ``check_shard_args``):
    one while they fit one launch's ``SHARD_MAX_SHARDS`` descriptors,
    ``SHARD_MAX_SLOTS`` sources and ``SHARD_MAX_ITEMS`` CTAs.  Past that,
    the shards are cut along their sources and packed in order, every
    shard of a source block (those that share its ``newest``) in the same
    launch, so each launch writes its blocks' ``newest`` whole.  A block
    of more than ``SHARD_MAX_SHARDS`` shards raises."""
    shards = list(shards)
    n, p, _w, s = (*shards[0].prefix.shape, shards[0].out_state.shape[1])
    per_src = shard_items(p, s)
    blocks: dict[tuple[int, int], list[ShardBlock]] = {}
    for blk in shards:
        blocks.setdefault((blk.newest.data_ptr(), blk.newest.numel()),
                          []).append(blk)
    units = []                  # (the block's shards cut to [lo, hi), hi - lo)
    for group in blocks.values():
        parts = len(group)
        if parts > SHARD_MAX_SHARDS:
            raise ValueError(f"{parts} shards of one source block (at most "
                             f"{SHARD_MAX_SHARDS} a launch)")
        cap = min(SHARD_MAX_SLOTS, SHARD_MAX_ITEMS // (parts * per_src))
        for lo in range(0, n, cap):
            hi = min(n, lo + cap)
            units.append(([b.sources(lo, hi) if (lo, hi) != (0, n) else b
                           for b in group], hi - lo))
    # pack the units in order: a launch closes when the next unit would
    # pass one of its limits
    groups: list[list] = [[]]
    descs = slots = items = 0
    for group, m in units:
        cost = len(group) * m * per_src
        if groups[-1] and (descs + len(group) > SHARD_MAX_SHARDS
                           or slots + m > SHARD_MAX_SLOTS
                           or items + cost > SHARD_MAX_ITEMS):
            groups.append([])
            descs = slots = items = 0
        groups[-1].append((group, m))
        descs, slots, items = descs + len(group), slots + m, items + cost
    plans = []
    for packed in groups:
        blks, slot0, parts, first = [], [], [], []
        slots = items = 0
        for group, m in packed:
            for blk in group:
                blks.append(blk)
                slot0.append(slots)
                parts.append(len(group))
                first.append(items)
                items += m * per_src
            slots += m
        plans.append(ShardLaunch(tuple(blks), tuple(slot0), tuple(parts),
                                 tuple(first), items, slots, bool(plans)))
    return plans


class ShardDescStruct(ctypes.Structure):
    """One shard of a grouped launch: ``ShardDesc`` in the source."""
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "prefix", "length", "age_ms", "state", "bucket", "headers", "mask",
        "newest")] + [(f, ctypes.c_longlong) for f in (
            "prefix_src", "length_src", "age_src", "state_src", "bucket_src",
            "headers_src", "headers_sub", "mask_src", "mask_sub")] + [
        (f, ctypes.c_int) for f in ("n_src", "kf_base", "slot0", "parts",
                                    "first_item", "pad")]


class ShardLaunchStruct(ctypes.Structure):
    """A grouped launch: ``ShardLaunch`` in the source."""
    _fields_ = [("shard", ShardDescStruct * SHARD_MAX_SHARDS),
                ("eligible", ctypes.c_void_p),
                ("delay_ms", ctypes.c_longlong)] + [
        (f, ctypes.c_int) for f in (
            "n_shards", "n_pkts", "row_stride", "n_subs", "n_tiles",
            "n_groups", "n_items", "n_sources", "accumulate", "pad")]


def shard_descriptors(launch: ShardLaunch, bucket_delay_ms: int,
                      eligible: torch.Tensor) -> ShardLaunchStruct:
    """The ``ShardLaunch`` struct ``ed_relay_shard`` takes for ``launch``
    (strides in the bytes or elements the source names)."""
    first = launch.shards[0]
    _n, p, w = first.prefix.shape
    s = first.out_state.shape[1]
    out = ShardLaunchStruct()
    for k, blk in enumerate(launch.shards):
        out.shard[k] = ShardDescStruct(
            *(getattr(blk, f).data_ptr() for f in _SHARD_VIEWS),
            blk.prefix.stride(0), blk.length.stride(0),
            blk.age_ms.stride(0), blk.out_state.stride(0),
            blk.bucket_of_output.stride(0), blk.headers.stride(0),
            blk.headers.stride(1), blk.mask.stride(0), blk.mask.stride(1),
            blk.prefix.shape[0], blk.kf_base, launch.slot0[k],
            launch.parts[k], launch.first_item[k], 0)
    out.eligible = eligible.data_ptr()
    out.delay_ms = int(bucket_delay_ms)
    out.n_shards = len(launch.shards)
    out.n_pkts, out.row_stride, out.n_subs = p, w, s
    out.n_tiles = -(-p // SHARD_TILE_ROWS)
    out.n_groups = -(-s // SHARD_SUBS_PER_CTA)
    out.n_items, out.n_sources = launch.n_items, launch.n_sources
    out.accumulate = int(launch.accumulate)
    return out


def _shard_launch_plain(launch: ShardLaunch, bucket_delay_ms: int,
                        eligible: torch.Tensor) -> None:
    """One launch of ``relay_shard_step_plain``: B9's plain chain a source
    with the reference's ``length > 0`` mask."""
    total = torch.zeros((), dtype=torch.int64, device=eligible.device)
    best: dict[int, torch.Tensor] = {}
    for blk, slot0 in zip(launch.shards, launch.slot0):
        kfs = []
        for i in range(blk.prefix.shape[0]):
            fields = parse_packets_kernel(blk.prefix[i], blk.length[i])
            blk.headers[i] = fanout_headers(
                blk.prefix[i, :, :2], fields["seq"], fields["timestamp"],
                blk.out_state[i])
            valid = blk.length[i] > 0
            m = eligibility(blk.age_ms[i], blk.bucket_of_output[i],
                            bucket_delay_ms) & valid[None, :]
            blk.mask[i] = m
            total += m.sum(dtype=torch.int64)
            kf = newest_keyframe(fields["keyframe_first"], valid)
            kfs.append(torch.where(kf >= 0, kf + blk.kf_base, kf))
        kf = torch.stack(kfs).to(torch.int32)
        best[slot0] = kf if slot0 not in best \
            else torch.maximum(best[slot0], kf)
    # every shard of a block is in the launch: its newest is written whole
    for blk, slot0 in zip(launch.shards, launch.slot0):
        blk.newest.copy_(best[slot0])
    if launch.accumulate:
        eligible += total
    else:
        eligible.copy_(total)


def relay_shard_step_plain(shards, bucket_delay_ms: int,
                           eligible: torch.Tensor) -> None:
    """B8's grouped shard step in plain PyTorch, launch by launch of the
    same plan (``shard_launch_plan``): the arguments and effects of
    ``relay_shard_step``."""
    shards = list(shards)
    check_shard_args(shards, eligible)
    for launch in shard_launch_plan(shards):
        _shard_launch_plain(launch, bucket_delay_ms, eligible)


def relay_shard_step(shards, bucket_delay_ms: int,
                     eligible: torch.Tensor) -> None:
    """The mesh shards of one device in one step (B8, ``parallel.mesh``):
    each ``ShardBlock``'s ``[S, P, 12]`` headers and ``[S, P]`` mask a
    source (bucket-eligible and ``length > 0``) into its views; each
    source block's ``newest`` written with its sources' newest keyframe +
    ``kf_base``, maxed over the block's shards (−1: none); ``eligible``
    written with the count of the mask.  Nothing needs filling first.
    CUDA tensors make ONE ``ed_relay_shard`` launch for every launch of
    ``shard_launch_plan`` (one, unless the shards pass a launch's
    limits); CPU tensors run ``relay_shard_step_plain``."""
    shards = list(shards)
    check_shard_args(shards, eligible)
    dev = shards[0].prefix.device
    if dev.type == "cpu":
        relay_shard_step_plain(shards, bucket_delay_ms, eligible)
        return
    if dev.type != "cuda":
        raise ValueError(f"no shard-step kernel for device {dev}")
    scratch = kernel_lib.scratch("ed_relay_shard", SHARD_SCRATCH_WORDS, dev)
    for launch in shard_launch_plan(shards):
        desc = shard_descriptors(launch, bucket_delay_ms, eligible)
        kernel_lib.launch("ed_relay_shard", ctypes.addressof(desc),
                          scratch.data_ptr())


def batch_upload_layout(n_pkts: int, n_subs: int) -> tuple[int, ...]:
    """Byte offsets of ``relay_batch_step``'s five inputs in one upload
    buffer (prefix ``[P, 96]``, length, age, state, buckets) and its total
    size; every offset is a multiple of 4."""
    o_len = n_pkts * PARSE_PREFIX
    o_age = o_len + 4 * n_pkts
    o_state = o_age + 4 * n_pkts
    o_bucket = o_state + 4 * STATE_COLS * n_subs
    return o_len, o_age, o_state, o_bucket, o_bucket + 4 * n_subs


def pack_batch_upload(out: np.ndarray, prefix: np.ndarray,
                      length: np.ndarray, age_ms: np.ndarray,
                      out_state: np.ndarray, buckets: np.ndarray) -> int:
    """Host helper: write one pass's inputs into ``out`` (uint8, at least
    the layout's size) in ``batch_upload_layout``'s order; returns the
    bytes used."""
    n_pkts, n_subs = len(length), len(buckets)
    o_len, o_age, o_state, o_bucket, end = batch_upload_layout(n_pkts, n_subs)
    out[:o_len].reshape(n_pkts, PARSE_PREFIX)[:] = prefix
    out[o_len:o_age].view(np.int32)[:] = length
    out[o_age:o_state].view(np.int32)[:] = age_ms
    out[o_state:o_bucket].view(np.uint32)[:] = out_state.reshape(-1)
    out[o_bucket:end].view(np.int32)[:] = buckets
    return end


def batch_upload_views(buf: torch.Tensor, n_pkts: int, n_subs: int
                       ) -> tuple[torch.Tensor, ...]:
    """``(prefix, length, age_ms, out_state, bucket_of_output)`` as views
    of an uploaded ``pack_batch_upload`` buffer (uint8, 4-byte aligned)."""
    o_len, o_age, o_state, o_bucket, end = batch_upload_layout(n_pkts, n_subs)
    return (buf[:o_len].view(n_pkts, PARSE_PREFIX),
            buf[o_len:o_age].view(torch.int32),
            buf[o_age:o_state].view(torch.int32),
            buf[o_state:o_bucket].view(torch.uint32).view(n_subs, STATE_COLS),
            buf[o_bucket:end].view(torch.int32))


def relay_affine_step(prefix: torch.Tensor, length: torch.Tensor,
                      out_state: torch.Tensor) -> dict[str, torch.Tensor]:
    """One source: per-packet parsed fields plus per-output affine params
    (O(S+P) results instead of O(S·P) headers)."""
    fields = parse_packets(prefix, length)
    valid = length > 0
    kf = fields["keyframe_first"] & valid
    seq_off, ts_off, ssrc, chan = affine_params(out_state)
    return {
        "seq": u32_from_i64(fields["seq"].to(torch.int64)),
        "timestamp": fields["timestamp"],
        "keyframe_first": kf,
        "frame_first": fields["frame_first"],
        "frame_last": fields["frame_last"],
        "newest_keyframe": newest_keyframe(kf, valid),
        "seq_off": seq_off,
        "ts_off": ts_off,
        "ssrc": ssrc,
        "chan": chan,
    }


def relay_affine_step_packed(prefix: torch.Tensor, length: torch.Tensor,
                             out_state: torch.Tensor) -> torch.Tensor:
    """``relay_affine_step`` over a leading source axis, packed into ONE
    uint32 array ``[N_SRC, 4·S + 1]``:
    ``seq_off[S] ∥ ts_off[S] ∥ ssrc[S] ∥ chan[S] ∥ newest_keyframe``
    (the −1 sentinel rides as 0xFFFFFFFF)."""
    n, p, w = prefix.shape
    fields = parse_packets(prefix.reshape(n * p, w), length.reshape(n * p))
    valid = length > 0
    kf = fields["keyframe_first"].reshape(n, p) & valid
    newest = newest_keyframe(kf, valid).to(torch.int64)
    cols = [i64_from_u32(c) for c in affine_params(out_state)]
    return u32_from_i64(torch.cat(cols + [newest[:, None]], dim=-1))


def pack_window(prefix, length) -> np.ndarray:
    """Host helper: [..., P, 96] prefixes + [..., P] lengths → ONE uint8
    array [..., P, 100] (length rides as 4 trailing little-endian bytes)."""
    prefix = np.asarray(prefix, np.uint8)
    length = np.ascontiguousarray(length, "<u4")
    lb = length[..., None].view(np.uint8)
    return np.concatenate([prefix, lb], axis=-1)


def window_lengths(window: torch.Tensor) -> torch.Tensor:
    """Decode the le32 length column of ``[B, P, 96+4]`` rows as int32
    values (in int64), wrapping exactly as a uint32 → int32 cast does."""
    lb = window[..., PARSE_PREFIX:PARSE_PREFIX + WINDOW_EXTRA].to(torch.int64)
    v = lb[..., 0] | (lb[..., 1] << 8) | (lb[..., 2] << 16) | (lb[..., 3] << 24)
    return torch.where(v >= 1 << 31, v - (1 << 32), v)


def _check_window(window: torch.Tensor, out_state: torch.Tensor) -> None:
    if window.dim() != 3 or window.shape[2] < PARSE_PREFIX + WINDOW_EXTRA:
        raise ValueError(f"window must be [B, P, >={PARSE_PREFIX + WINDOW_EXTRA}]"
                         f", got {tuple(window.shape)}")
    if (out_state.dim() != 3 or out_state.shape[0] != window.shape[0]
            or out_state.shape[2] != STATE_COLS):
        raise ValueError(f"out_state must be [B, S, {STATE_COLS}] with "
                         f"B={window.shape[0]}, got {tuple(out_state.shape)}")


def relay_affine_step_window_plain(window: torch.Tensor,
                                   out_state: torch.Tensor) -> torch.Tensor:
    """The window pass in plain PyTorch (runs on either device)."""
    _check_window(window, out_state)
    return relay_affine_step_packed(window[:, :, :PARSE_PREFIX],
                                    window_lengths(window), out_state)


def relay_affine_step_window(window: torch.Tensor,
                             out_state: torch.Tensor) -> torch.Tensor:
    """The megabatch window pass: ``window`` [B, P, 96+4] uint8 (fused
    ``pack_window`` rows) · ``out_state`` [B, S, STATE_COLS] uint32 →
    [B, 4·S + 1] uint32.  A group of one of ``relay_affine_step_windows``."""
    return relay_affine_step_windows([(window, out_state)])[0]


#: the window kernel's launch geometry (``kMaxBuckets``, ``kMaxCluster``
#: in ``csrc/relay_kernels.cu``; chip_smoke.py checks them against the
#: library's ``ed_relay_geometry``)
WINDOW_MAX_BUCKETS = 32
WINDOW_MAX_CLUSTER = 8
#: packets a stream row holds per CTA before its cluster takes another
WINDOW_ROWS_PER_CTA = 64


class WindowBucketDesc(ctypes.Structure):
    """One bucket of a grouped launch: ``WindowBucket`` in the source."""
    _fields_ = [("window", ctypes.c_void_p), ("state", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("n_streams", ctypes.c_int),
                ("n_pkts", ctypes.c_int), ("row_stride", ctypes.c_int),
                ("n_subs", ctypes.c_int), ("first_cluster", ctypes.c_int),
                ("pad", ctypes.c_int)]


def cluster_size(p_max: int) -> int:
    """CTAs per stream row for a launch whose widest bucket has ``p_max``
    packets: ``min(8, max(1, p_max // 64))``."""
    return min(WINDOW_MAX_CLUSTER, max(1, p_max // WINDOW_ROWS_PER_CTA))


def cta_range(n: int, rank: int, cluster: int) -> tuple[int, int]:
    """Rank ``rank``'s contiguous share ``[lo, hi)`` of ``n`` items."""
    return rank * n // cluster, (rank + 1) * n // cluster


@dataclass(frozen=True)
class WindowCta:
    """One CTA of a window launch: its stream row, packet rows and
    subscribers, and how its bytes come into shared memory."""
    bucket: int                 # index into the caller's bucket list
    cluster_id: int
    rank: int
    stream: int
    rows: tuple[int, int]
    subs: tuple[int, int]
    addr: int                   # first byte of its rows
    head: int
    interior: int               # the one bulk copy
    tail: int


@dataclass(frozen=True)
class WindowLaunch:
    """One grouped ``ed_relay_window`` launch: at most
    ``WINDOW_MAX_BUCKETS`` buckets, one cluster of ``cluster`` CTAs per
    stream row."""
    buckets: tuple[int, ...]                    # indices into the caller's list
    first_cluster: tuple[int, ...]
    shapes: tuple[tuple[int, int, int, int], ...]   # (B, P, W, S)
    addrs: tuple[int, ...]                      # each window's first byte
    cluster: int
    smem_bytes: int

    def ctas(self):
        """Every CTA, as the kernel computes its spans."""
        for k, ((n_b, p, w, s), addr) in enumerate(zip(self.shapes,
                                                        self.addrs)):
            for b in range(n_b):
                for r in range(self.cluster):
                    lo, hi = cta_range(p, r, self.cluster)
                    start = addr + (b * p + lo) * w
                    yield WindowCta(self.buckets[k], self.first_cluster[k] + b,
                                    r, b, (lo, hi),
                                    cta_range(s, r, self.cluster), start,
                                    *kernel_lib.bulk_split(start,
                                                           (hi - lo) * w))


def window_launch_plan(shapes, addrs) -> list[WindowLaunch]:
    """The launches for buckets of ``(B, P, W, S)`` shapes whose windows
    start at ``addrs``: buckets in order, ``WINDOW_MAX_BUCKETS`` to a
    launch; a bucket with no stream row gets no CTA.  The dynamic shared
    memory is the largest CTA span plus the alignment slack; a launch
    that would need more than ``kernel_lib.WINDOW_SMEM_LIMIT`` (the
    kernel's opt-in to Hopper's large shared memory) raises: callers cut
    wider rows first (``split_wide_windows``)."""
    live = [i for i, shape in enumerate(shapes) if shape[0] > 0]
    plans = []
    for g in range(0, len(live), WINDOW_MAX_BUCKETS):
        idx = tuple(live[g:g + WINDOW_MAX_BUCKETS])
        group = tuple(tuple(shapes[i]) for i in idx)
        c = cluster_size(max(p for _b, p, _w, _s in group))
        align = kernel_lib.BULK_ALIGN
        smem = max([align] + [-(-p // c) * w + align
                              for _b, p, w, _s in group])
        smem = -(-smem // align) * align
        if smem > kernel_lib.WINDOW_SMEM_LIMIT:
            raise ValueError(f"window launch needs {smem} B of shared memory "
                             f"per CTA (> {kernel_lib.WINDOW_SMEM_LIMIT}): "
                             f"shapes {group}")
        firsts = tuple(itertools.accumulate(
            (b for b, _p, _w, _s in group[:-1]), initial=0))
        plans.append(WindowLaunch(idx, firsts, group,
                                  tuple(addrs[i] for i in idx), c, smem))
    return plans


def window_descriptors(plan: WindowLaunch, pairs, outs) -> ctypes.Array:
    """The launch's ``WindowBucket`` array over ``pairs`` (window, state)
    and their ``outs``."""
    return (WindowBucketDesc * len(plan.buckets))(*[
        WindowBucketDesc(pairs[i][0].data_ptr(), pairs[i][1].data_ptr(),
                         outs[i].data_ptr(), *plan.shapes[k],
                         plan.first_cluster[k], 0)
        for k, i in enumerate(plan.buckets)])


def window_max_rows(width: int) -> int:
    """The most packets of ``width``-byte rows one stream row of a window
    launch takes: a cluster of ``WINDOW_MAX_CLUSTER`` CTAs, each within
    ``kernel_lib.WINDOW_SMEM_LIMIT`` (16,384 rows fit at width 100)."""
    per_cta = (kernel_lib.WINDOW_SMEM_LIMIT - kernel_lib.BULK_ALIGN) // width
    if per_cta < 1:
        raise ValueError(f"a {width}-byte row does not fit a CTA's shared "
                         f"memory ({kernel_lib.WINDOW_SMEM_LIMIT} B)")
    return WINDOW_MAX_CLUSTER * per_cta


def split_wide_windows(pairs):
    """Cut every bucket whose rows exceed ``window_max_rows`` into
    ``n`` pieces of at most that many rows, each piece a stream row of its
    own with the stream's state (``[B·n, P/n, W]``, a view when ``n``
    divides ``P``, else zero rows are appended on the window's device).
    Returns the pairs to run and, per bucket, ``(n, piece rows)`` for
    ``merge_wide_results``."""
    out, cuts = [], []
    for window, out_state in pairs:
        n_b, p, w = window.shape
        limit = window_max_rows(w)
        if p <= limit:
            out.append((window, out_state))
            cuts.append((1, p))
            continue
        n = -(-p // limit)
        piece = -(-p // n)
        if piece * n != p:
            window = torch.cat([window, torch.zeros(
                (n_b, piece * n - p, w), dtype=window.dtype,
                device=window.device)], 1)
        out.append((window.reshape(n_b * n, piece, w),
                    out_state.view(torch.int32).repeat_interleave(n, 0)
                    .view(torch.uint32)))
        cuts.append((n, piece))
    return out, cuts


def merge_wide_results(results, cuts) -> list[torch.Tensor]:
    """The results of ``split_wide_windows``'s pairs back as one
    ``[B, 4·S + 1]`` row per stream: every piece has the stream's state,
    so its affine columns are piece 0's; the newest keyframe is the
    highest piece's hit, offset by that piece's first row (−1: none)."""
    merged = []
    for res, (n, piece) in zip(results, cuts):
        if n == 1:
            merged.append(res)
            continue
        r = res.view(torch.int32).reshape(-1, n, res.shape[1])
        kf = r[:, :, -1]
        off = torch.arange(n, dtype=torch.int32, device=res.device) * piece
        best = torch.where(kf >= 0, kf + off, torch.full_like(kf, -1))
        row = r[:, 0].clone()
        row[:, -1] = best.amax(1)
        merged.append(row.view(torch.uint32))
    return merged


def relay_affine_step_windows(pairs) -> list[torch.Tensor]:
    """The window pass over every ``(window, out_state)`` bucket of a wake
    → one [B, 4·S + 1] uint32 result per bucket.  CUDA tensors make ONE
    ``ed_relay_window`` launch per ``WINDOW_MAX_BUCKETS`` buckets; CPU
    tensors run the plain version once per bucket.  Rows wider than one
    launch takes run as pieces (``split_wide_windows``) on either
    device."""
    pairs = list(pairs)
    for window, out_state in pairs:
        _check_window(window, out_state)
    if not pairs:
        return []
    dev = pairs[0][0].device
    if any(t.device != dev for pair in pairs for t in pair):
        raise ValueError("every window and state of a group must be on "
                         f"{dev}")
    pairs, cuts = split_wide_windows(pairs)
    return merge_wide_results(_window_pass(pairs, dev), cuts)


def _window_pass(pairs, dev: torch.device) -> list[torch.Tensor]:
    """``relay_affine_step_windows`` on buckets every launch can take."""
    if dev.type == "cpu":
        return [relay_affine_step_window_plain(w, s) for w, s in pairs]
    if dev.type != "cuda":
        raise ValueError(f"no window kernel for device {dev}")
    for window, out_state in pairs:
        kernel_lib.require(window, "window", torch.uint8, 3, dev)
        kernel_lib.require(out_state, "out_state", torch.uint32, 3, dev)
    outs = [torch.empty((w.shape[0], 4 * s.shape[1] + 1), dtype=torch.int32,
                        device=dev) for w, s in pairs]
    shapes = [(*w.shape, s.shape[1]) for w, s in pairs]
    for plan in window_launch_plan(shapes, [w.data_ptr() for w, _ in pairs]):
        descs = window_descriptors(plan, pairs, outs)
        kernel_lib.launch("ed_relay_window", ctypes.addressof(descs),
                          len(descs), plan.cluster)
    return [o.view(torch.uint32) for o in outs]


def unpack_affine(packed, n_sub: int):
    """Host-side views into the packed egress params:
    ``(seq_off, ts_off, ssrc, chan, newest_keyframe)``; the keyframe
    column is re-cast to int32 so the −1 sentinel survives."""
    return (packed[:, :n_sub], packed[:, n_sub:2 * n_sub],
            packed[:, 2 * n_sub:3 * n_sub],
            packed[:, 3 * n_sub:4 * n_sub],
            packed[:, 4 * n_sub].astype("int32"))
