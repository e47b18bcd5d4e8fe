"""Megabatch-on-mesh throughput harness.

Drives the cross-stream megabatch scheduler over real relay streams and
real UDP egress in two interleaved modes, bucket dispatch sharded over a
``src`` mesh against the one-device dispatch, and reports packets a
second for both and the mesh's scaling efficiency.

Method: two identical stream sets fed identical bursts, stepped in turns
with the order flipped each wake (so drift of the shared host cancels).
Every wake pushes a fresh burst to every stream, so each mode's scheduler
has real windows to stage and a real stacked pass to dispatch.
``scaling_efficiency`` = mesh rate / (devices × one-device rate): 1.0 is
linear.  Shards that share one card (``devices=[cuda:0, cuda:0]``) or the
CPU share its cores, so an efficiency well below 1 is expected there.

It is a module only: nothing writes its output as a benchmark.
"""

from __future__ import annotations

import socket
import time

import numpy as np
import torch

from .. import resolve_device


def _mk_streams(n_streams: int, n_sub: int, addrs, send_fd: int, seed: int,
                device: torch.device):
    from ..protocol import sdp
    from ..relay.fanout import FanoutEngine
    from ..relay.output import CollectingOutput
    from ..relay.stream import RelayStream, StreamSettings

    sdp_txt = ("v=0\r\ns=m\r\nt=0 0\r\nm=video 0 RTP/AVP 96\r\n"
               "a=rtpmap:96 H264/90000\r\na=control:trackID=1\r\n")
    rng = np.random.default_rng(seed)
    streams, engines = [], []
    for s in range(n_streams):
        st = RelayStream(sdp.parse(sdp_txt).streams[0],
                         StreamSettings(bucket_delay_ms=0))
        for i in range(n_sub):
            o = CollectingOutput(ssrc=int(rng.integers(0, 2**32)),
                                 out_seq_start=int(rng.integers(0, 2**16)))
            o.native_addr = addrs[(s * n_sub + i) % len(addrs)]
            st.add_output(o)
        streams.append(st)
        engines.append(FanoutEngine(egress_fd=send_fd, device=device))
    return streams, engines


def measure_mesh_throughput(n_devices: int, *, n_streams: int = 16,
                            n_sub: int = 8, burst: int = 24,
                            seconds: float = 4.0, addrs=None, devices=None,
                            device: str | torch.device = "cuda") -> dict:
    """Paired mesh-vs-one-device megabatch throughput (module doc).
    ``devices`` is the mesh's device list (default: every card); the
    one-device side runs on ``device``.  With fewer than 2 devices both
    sides take the one-device path and ``note`` says so."""
    from ..relay.megabatch import MegabatchScheduler
    from .mesh import make_megabatch_mesh

    device = resolve_device(device)
    recv = None
    if addrs is None:
        recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        recv.bind(("127.0.0.1", 0))
        recv.setblocking(False)
        recv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        addrs = [recv.getsockname()]
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    send.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)
    send.setblocking(False)

    mesh = make_megabatch_mesh(n_devices, devices)
    n_dev = mesh.size if mesh is not None else 1
    sets = {
        "mesh": (_mk_streams(n_streams, n_sub, addrs, send.fileno(), 11,
                             device),
                 MegabatchScheduler(device=device, mesh=mesh)),
        "one": (_mk_streams(n_streams, n_sub, addrs, send.fileno(), 11,
                            device),
                MegabatchScheduler(device=device)),
    }
    pkt = bytes([0x80, 96]) + bytes(10) + bytes(1388)

    def push(streams, seq, t):
        for st in streams:
            for b in range(burst):
                st.push_rtp(pkt[:2] + ((seq + b) & 0xFFFF).to_bytes(2, "big")
                            + pkt[4:], t)
        return seq + burst

    def step(mode, t):
        (streams, engines), sched = sets[mode]
        pairs = list(zip(streams, engines))
        sched.begin_wake(pairs, t)
        for st, eng in pairs:
            eng.step(st, t)
        sched.end_wake(pairs, t)

    def drain_recv():
        if recv is None:
            return
        try:
            while True:
                recv.recv(65536)
        except BlockingIOError:
            pass

    # prime both modes (GSO probe, rebase latches, the kernel library)
    # outside the timing
    t = int(time.monotonic() * 1000)
    seq = push(sets["mesh"][0][0], 0, t)
    push(sets["one"][0][0], 0, t)
    step("mesh", t)
    step("one", t)
    for _, sched in sets.values():
        sched.drain()
    drain_recv()
    base_sent = {m: sum(e.packets_sent for e in sets[m][0][1])
                 for m in sets}
    elapsed = {m: 0.0 for m in sets}
    wakes = 0
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        t = int(time.monotonic() * 1000)
        seq = push(sets["mesh"][0][0], seq, t)
        push(sets["one"][0][0], seq - burst, t)
        order = ("mesh", "one") if wakes % 2 == 0 else ("one", "mesh")
        for mode in order:
            c0 = time.perf_counter()
            step(mode, t)
            elapsed[mode] += time.perf_counter() - c0
        drain_recv()
        wakes += 1
        if wakes % 16 == 0:
            for m in sets:
                for st in sets[m][0][0]:
                    st.prune(t)
    for _, sched in sets.values():
        sched.drain()
    sent = {m: sum(e.packets_sent for e in sets[m][0][1]) - base_sent[m]
            for m in sets}
    rate = {m: sent[m] / elapsed[m] if elapsed[m] > 0 else 0.0
            for m in sets}
    send.close()
    if recv is not None:
        recv.close()
    sched_mesh, sched_one = sets["mesh"][1], sets["one"][1]
    if n_dev <= 1:
        eff = 1.0                      # no mesh: nothing to scale
    elif rate["one"] > 0:
        eff = rate["mesh"] / (n_dev * rate["one"])
    else:
        eff = 0.0                      # a dead baseline reads as broken
    out = {
        "n_devices": n_dev,
        "streams": n_streams,
        "subscribers_per_stream": n_sub,
        "wakes": wakes,
        "packets_per_sec": rate["mesh"],
        "packets_per_sec_per_device": rate["mesh"] / n_dev,
        "single_device_packets_per_sec": rate["one"],
        "scaling_efficiency": eff,
        "sharded_passes": sched_mesh.sharded_passes,
        "single_device_passes": sched_one.passes,
        "wire_mismatches": sched_mesh.mismatches + sched_one.mismatches,
        "method": (
            "Two identical stream sets fed identical bursts, stepped in "
            "turns with the order flipped each wake: one under the "
            "mesh-sharded megabatch scheduler, one under one-device "
            "dispatch.  Every wake pushes a fresh burst; packets/s = "
            "subscriber sends / that mode's summed step time.  "
            "scaling_efficiency = mesh rate / (devices x one-device "
            "rate)."),
    }
    if mesh is None:
        out["note"] = ("no mesh: fewer than 2 devices; one-device dispatch "
                       "on both sides")
    return out


__all__ = ["measure_mesh_throughput"]
