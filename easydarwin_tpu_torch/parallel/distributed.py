"""Multi-process scale-out: the process group a relay mesh spans.

The reference scales across machines with a control plane only (Redis
presence and EasyCMS redirection); here the relay mesh itself can span
processes: ``init_from_env`` brings up ``torch.distributed`` (NCCL for
cards, gloo for the CPU), ``make_cluster_mesh`` lays every process's
devices out host-major, and ``mesh.sharded_relay_step`` then runs each
process's own shards and reduces the keyframe max and the eligible sum
with ``all_reduce`` over the group.

Wire-up order in every process of the fleet::

    from easydarwin_tpu_torch.parallel import distributed, mesh
    distributed.init_from_env()                  # init_process_group
    m = distributed.make_cluster_mesh(sub=2)     # host-major relay mesh
    step = mesh.sharded_relay_step(m)

Axis placement matters: ``src`` (sources) is the outermost axis and the
only one allowed to cross a process boundary; ``sub`` and ``win`` blocks
stay within one process, so the per-source reductions never wait on
another host for their inputs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from .mesh import AXES, RelayMesh, _card_devices

_initialized = False


def init_from_env(coordinator: str | None = None,
                  num_processes: int | None = None,
                  process_id: int | None = None, *,
                  device: str | torch.device = "cuda") -> bool:
    """Join the fleet's process group (``torch.distributed.
    init_process_group``: NCCL when ``device`` is a card, gloo for the
    CPU).  Arguments fall back to the standard variables
    (``MASTER_ADDR``/``MASTER_PORT`` for ``coordinator`` as
    ``host:port``, ``WORLD_SIZE``, ``RANK``).  Does nothing and returns
    False when neither a coordinator nor a process count describes a
    fleet: a single host never pays the rendezvous.  Idempotent."""
    global _initialized
    if _initialized or (torch.distributed.is_available()
                        and torch.distributed.is_initialized()):
        _initialized = True
        return True
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    # a process id alone never describes a fleet
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a fleet needs a coordinator, a process count and "
                         "this process's id")
    dev = resolve_device(device)
    torch.distributed.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id)
    _initialized = True
    return True


def make_cluster_mesh(*, sub: int = 1, win: int = 1,
                      devices=None) -> RelayMesh:
    """The relay mesh of the whole fleet, host-major: this process's
    ``devices`` (default: every card) and every other process's, ordered
    by rank, so a ``src`` row never straddles two processes.  Each
    process's device count must be a multiple of ``sub * win``."""
    local = list(devices) if devices is not None else _card_devices()
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, len(local))
        rank = dist.get_rank()
    else:
        counts, rank = [len(local)], 0
    for proc, cnt in enumerate(counts):
        if cnt % (sub * win):
            raise ValueError(
                f"process {proc} has {cnt} devices, not divisible by "
                f"sub*win={sub * win}; a src row would cross a process "
                f"boundary (see module doc)")
    devs, ranks = [], []
    for proc, cnt in enumerate(counts):
        # another process's devices are named by index only: this process
        # never runs their shards
        devs += local if proc == rank else [torch.device("cpu")] * cnt
        ranks += [proc] * cnt
    n = len(devs)
    shape = (n // (sub * win), sub, win)
    return RelayMesh(devs, shape, np.asarray(ranks).reshape(shape))


def process_span(mesh: RelayMesh) -> dict:
    """How the mesh maps onto processes: the processes, the shards this
    one runs, whether any non-src axis crosses a process boundary (it
    never should), and the axis sizes."""
    ranks = mesh.ranks
    cross = any(len(set(ranks[i].reshape(-1).tolist())) > 1
                for i in range(ranks.shape[0]))
    return {"num_processes": len(set(ranks.reshape(-1).tolist())),
            "local_devices": sum(1 for idx in np.ndindex(ranks.shape)
                                 if mesh.local(idx)),
            "non_src_axis_crosses_hosts": cross,
            "mesh_shape": mesh.shape}


def mesh_summary(mesh: RelayMesh) -> dict[str, str]:
    """``process_span`` as the string-valued fields of the server's stats:
    how many devices and processes, this process's shards, the (src, sub,
    win) factorization, and whether a non-src axis crosses processes."""
    span = process_span(mesh)
    shape = span["mesh_shape"]
    return {
        "MeshDevices": str(mesh.size),
        "MeshShape": ",".join(f"{a}={shape[a]}" for a in AXES),
        "MeshNumProcesses": str(span["num_processes"]),
        "MeshLocalDevices": str(span["local_devices"]),
        "MeshNonSrcAxisCrossesHosts":
            "1" if span["non_src_axis_crosses_hosts"] else "0",
    }


__all__ = ["init_from_env", "make_cluster_mesh", "mesh_summary",
           "process_span"]
