"""Sharded relay step over a (src, sub, win) mesh of torch devices (B8).

Sharding layout (``RelayMesh``: shard ``(i, j, k)`` on ``devices[i, j, k]``):

====================  ====================  =============================
array                 shape                 split over
====================  ====================  =============================
prefix                [N, P, W]             (src, win, -)
length / age          [N, P]                (src, win)
out_state             [N, S, 6]             (src, sub, -)
bucket_of_output      [N, S]                (src, sub)
headers (out)         [N, S, P, 12]         (src, sub, win, -)
mask (out)            [N, S, P]             (src, sub, win)
newest_keyframe (out) [N]                   (src,): max over win
total_eligible (out)  []                    sum over every shard
====================  ====================  =============================

Each shard renders headers for its subscriber block over its packet
block.  The shards of one device run as ONE launch of the hand-written
``ed_relay_shard`` (``ops.fanout.relay_shard_step``: B9's function, K1's
parse fused in, over every shard's sources, with the reference's
``length > 0`` mask); on the CPU its plain version.  The only cross-shard
dependencies are two scalars a source: the newest keyframe, offset by
the shard's ``win`` base and maxed over the ``win`` shards, and the count
of eligible sends, summed over all.  The shards on the first shard's
device write straight into the whole result, and their launch writes
both folds over them there: nothing is filled first.  The shards of
another device write blocks of their own, which are copied over and
folded by one max and one add on the first device.  With a process group
up (``parallel.distributed``) both become ``all_reduce``s (MAX and SUM)
over it, and each process runs only its own shards.

No serving path calls this step: the server's mesh path is the
megabatch scheduler's (``relay.megabatch``), one ``ed_relay_window`` a
device.  It is the reference's multi-chip relay step, a module of its
own, called directly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..models.relay_pipeline import on_device
from ..ops import fanout as fanout_ops
from ..ops.parse import PARSE_PREFIX

AXES = ("src", "sub", "win")

class RelayMesh:
    """Torch devices laid out as ``(src, sub, win)``; each shard belongs to
    a process rank (0 for a mesh of one process)."""

    def __init__(self, devices, shape: tuple[int, int, int], ranks=None):
        devices = [_indexed(d) for d in devices]
        n = int(np.prod(shape))
        if len(devices) != n:
            raise ValueError(f"mesh {'x'.join(map(str, shape))} != "
                             f"{len(devices)} devices")
        self.devices = np.empty(n, dtype=object)
        self.devices[:] = devices
        self.devices = self.devices.reshape(shape)
        self.ranks = (np.zeros(shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(shape))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list[torch.device]:
        """The devices in src-major order (shard k of a leading stream
        axis lands on ``flat()[k]``)."""
        return list(self.devices.reshape(-1))

    def local(self, idx) -> bool:
        """Whether this process runs shard ``idx``."""
        return int(self.ranks[idx]) == _rank()


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` names the current card,
    as the tensors placed there say."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _rank() -> int:
    dist = torch.distributed
    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)


def _card_devices() -> list[torch.device]:
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_relay_mesh(devices=None, *, src: int | None = None,
                    sub: int | None = None, win: int | None = None
                    ) -> RelayMesh:
    """A 3-axis relay mesh over ``devices`` (default: every card).  An
    axis left out: ``sub`` and ``win`` 1, ``src`` the rest."""
    devices = list(devices) if devices is not None else _card_devices()
    n = len(devices)
    sub = sub or 1
    win = win or 1
    src = src or n // (sub * win)
    if src * sub * win != n:
        raise ValueError(f"mesh {src}x{sub}x{win} != {n} devices")
    return RelayMesh(devices, (src, sub, win))


def make_megabatch_mesh(n_devices: int = 0, devices=None
                        ) -> RelayMesh | None:
    """The megabatch scheduler's serving mesh: ``src`` only (streams
    shard over devices; the stacked pass is already one fused window a
    stream).  ``n_devices``: 0 = every device, N = the first N.  Returns
    None when fewer than two would take part: the caller keeps the
    one-device path.  ``devices`` defaults to every card
    (``torch.cuda.device_count()``)."""
    devices = list(devices) if devices is not None else _card_devices()
    n = len(devices) if n_devices <= 0 else min(n_devices, len(devices))
    if n < 2:
        return None
    return make_relay_mesh(devices[:n], src=n, sub=1, win=1)


def _blocks(n: int, parts: int, axis: str) -> int:
    if n % parts:
        raise ValueError(f"{axis} extent {n} is not divisible by its "
                         f"{parts} shards")
    return n // parts


def _as_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    np_dtype = {torch.uint8: np.uint8, torch.int32: np.int32,
                torch.uint32: np.uint32}[dtype]
    return torch.from_numpy(np.ascontiguousarray(a, np_dtype))


def _sharded(mesh: RelayMesh, bucket_delay_ms: int, group, shard_step):
    devs = mesh.devices
    n_src, n_sub, n_win = devs.shape
    local = [idx for idx in np.ndindex(devs.shape) if mesh.local(idx)]
    if not local:
        raise ValueError("this process runs no shard of the mesh")
    first = devs[local[0]]
    spans = len(set(mesh.ranks.reshape(-1).tolist())) > 1
    # the local shards by device, the first shard's device first
    by_dev: dict[torch.device, list] = {}
    for idx in local:
        by_dev.setdefault(devs[idx], []).append(idx)

    def step(prefix, length, age, out_state, buckets):
        prefix = _as_tensor(prefix, torch.uint8)
        length = _as_tensor(length, torch.int32)
        age = _as_tensor(age, torch.int32)
        out_state = _as_tensor(out_state, torch.uint32)
        buckets = _as_tensor(buckets, torch.int32)
        n, p = length.shape
        s = out_state.shape[1]
        nb = _blocks(n, n_src, "src")
        sb = _blocks(s, n_sub, "sub")
        pb = _blocks(p, n_win, "win")

        def slices_of(i, j, k):
            return (slice(i * nb, (i + 1) * nb), slice(j * sb, (j + 1) * sb),
                    slice(k * pb, (k + 1) * pb))

        # the local shards tile the result; across processes the blocks of
        # other ranks stay 0
        alloc = torch.zeros if spans else torch.empty
        headers = alloc((n, s, p, 12), dtype=torch.uint8, device=first)
        mask = alloc((n, s, p), dtype=torch.bool, device=first)
        newest = torch.empty((n,), dtype=torch.int32, device=first)
        total = torch.empty((), dtype=torch.int64, device=first)
        filled = set()              # source blocks whose newest is written
        for dev, idxs in by_dev.items():
            home = dev == first
            dev_newest, dev_total = (newest, total) if home else (
                torch.empty((n,), dtype=torch.int32, device=dev),
                torch.empty((), dtype=torch.int64, device=dev))
            shards = []
            for i, j, k in idxs:
                rs, ss, ps = slices_of(i, j, k)
                outs = (headers[rs, ss, ps], mask[rs, ss, ps]) if home else (
                    torch.empty((nb, sb, pb, 12), dtype=torch.uint8,
                                device=dev),
                    torch.empty((nb, sb, pb), dtype=torch.bool, device=dev))
                # the shard's block where it lies, or copied to its device
                shards.append(fanout_ops.ShardBlock(
                    prefix[rs, ps].to(dev), length[rs, ps].to(dev),
                    age[rs, ps].to(dev), out_state[rs, ss].to(dev),
                    buckets[rs, ss].to(dev), *outs, dev_newest[rs],
                    kf_base=k * pb))
            with on_device(dev):
                shard_step(shards, bucket_delay_ms, dev_total)
            blocks = sorted({i for i, _j, _k in idxs})
            if home:
                filled.update(blocks)
                continue
            for (i, j, k), blk in zip(idxs, shards):
                rs, ss, ps = slices_of(i, j, k)
                headers[rs, ss, ps] = blk.headers.to(first)
                mask[rs, ss, ps] = blk.mask.to(first)
            for i in blocks:
                rs = slice(i * nb, (i + 1) * nb)
                kf = dev_newest[rs].to(first)
                newest[rs] = torch.maximum(newest[rs], kf) if i in filled \
                    else kf
                filled.add(i)
            total += dev_total.to(first)
        for i in range(n_src):
            if i not in filled:     # another process's blocks
                newest[i * nb:(i + 1) * nb] = -1
        if spans:
            dist = torch.distributed
            dist.all_reduce(newest, op=dist.ReduceOp.MAX, group=group)
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return headers, mask, newest, total

    return step


def sharded_relay_step(mesh: RelayMesh, bucket_delay_ms: int = 73,
                       group=None):
    """The relay step over ``mesh``: returns ``fn(prefix, length, age,
    out_state, buckets)`` → ``(headers, mask, newest_keyframe,
    total_eligible)`` on the first local shard's device.  The inputs
    (numpy arrays or tensors on any device) are split by the layout in the
    module docstring; each local shard reads its block where it lies, or
    a copy on its device, and the shards of each device run as ONE
    ``ed_relay_shard`` there (its plain version on the CPU).  Headers and
    mask hold the blocks this process ran (every block, in one process).
    ``group``: the process group whose shards the mesh spans (default:
    the default group when one is up)."""
    return _sharded(mesh, bucket_delay_ms, group, fanout_ops.relay_shard_step)


def sharded_relay_step_plain(mesh: RelayMesh, bucket_delay_ms: int = 73,
                             group=None):
    """``sharded_relay_step`` with each device's shards running the plain
    version (``ops.fanout.relay_shard_step_plain``) there, the card's
    included."""
    return _sharded(mesh, bucket_delay_ms, group,
                    fanout_ops.relay_shard_step_plain)


def example_batch(n_src=4, n_sub=8, n_pkt=32, width=PARSE_PREFIX, seed=0):
    """A synthetic well-formed relay batch (H.264 single-NAL packets with
    an IDR every 16th packet), the reference's ``example_batch`` to the
    byte: ``(prefix, length, age, out_state, buckets)`` as numpy."""
    rng = np.random.default_rng(seed)
    prefix = np.zeros((n_src, n_pkt, width), dtype=np.uint8)
    length = np.full((n_src, n_pkt), 200, dtype=np.int32)
    prefix[:, :, 0] = 0x80                      # V=2
    prefix[:, :, 1] = 96                        # PT=96
    seqs = np.arange(n_pkt, dtype=np.uint16)
    prefix[:, :, 2] = (seqs >> 8)[None, :]
    prefix[:, :, 3] = (seqs & 0xFF)[None, :]
    ts = (np.arange(n_pkt, dtype=np.uint32) * 3000)
    for i in range(4):
        prefix[:, :, 4 + i] = ((ts >> (8 * (3 - i))) & 0xFF)[None, :]
    ssrc = rng.integers(0, 2**32, size=n_src, dtype=np.uint32)
    for i in range(4):
        prefix[:, :, 8 + i] = ((ssrc >> (8 * (3 - i))) & 0xFF)[:, None]
    nal = np.where(np.arange(n_pkt) % 16 == 0, (3 << 5) | 5, (3 << 5) | 1)
    prefix[:, :, 12] = nal[None, :]
    age = np.full((n_src, n_pkt), 500, dtype=np.int32)
    out_state = np.zeros((n_src, n_sub, fanout_ops.STATE_COLS),
                         dtype=np.uint32)
    out_state[:, :, 0] = rng.integers(0, 2**32, size=(n_src, n_sub))
    out_state[:, :, 3] = rng.integers(0, 2**16, size=(n_src, n_sub))
    buckets = (np.arange(n_sub, dtype=np.int32) // 16)[None, :].repeat(
        n_src, 0)
    return prefix, length, age, out_state, buckets


__all__ = ["AXES", "RelayMesh", "example_batch", "make_megabatch_mesh",
           "make_relay_mesh", "sharded_relay_step",
           "sharded_relay_step_plain"]
