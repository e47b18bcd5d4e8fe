"""Server assembly: session registry → RTSP listener + REST API → relay
pump, and the MJPEG transcode service the REST API starts ladders on.

The pump is one asyncio task, woken by ingest and ticking every
``reflect_interval_ms``.  Each wake runs the live relay for every stream
that has outputs.  With at least ``MEGABATCH_MIN_STREAMS`` of them:

1. ``MegabatchScheduler.begin_wake`` — harvest the previous wake's device
   pass, prime params for streams whose membership changed;
2. ``FanoutEngine.step`` per stream — write every eligible packet from the
   installed params: UDP players in one native ``sendmmsg``/GSO scatter
   through the shared egress socket, interleaved players in one framed
   ``writev`` each, meta-info and thinned players through the
   batch-header rung (``relay_batch_step``, K1's parse on the card), the
   rest through the Python loop; then the stream's RTCP (the pusher's
   SRs rebased per player, and SRs of the relay's own);
3. ``MegabatchScheduler.end_wake`` — stage and dispatch the next pass (one
   ``ed_relay_window`` launch for the wake on the card).

Below that the scheduler idles and each engine keeps its stream's ring on
the device, appending the new packets each wake and querying it (one
``ed_ring_query`` launch) when its membership changes.  The native egress
core is built when the server starts; without it every player takes the
Python loop.  On a card the server also makes the CUDA context, loads the
kernel library and runs one small ring query when it starts, so the first
join does not pay for them.  One stream's error is counted
(``pump_errors``) and the wake goes on with the next stream.

After each stream's step the pump runs the resend sweep (``tick``) of
each of its reliable-UDP players, each one guarded like the step.  The
FEC tier's parity rides the step itself (``relay_rtcp``); ``stats()``
sums it over every stream (``"fec"``) and the reliable players' resends,
acks and give-ups (``"reliable"``).

Once a second the pump evicts old packets, sends each pusher its due
receiver reports, closes idle connections and retires transcode ladders
whose source went away.
"""

from __future__ import annotations

import asyncio
import collections
import sys
import time
import traceback

import torch

from .. import native, resolve_device
from ..models.mjpeg_ladder import MjpegTranscodeService
from ..ops import device_ring, kernel_lib
from ..relay.fanout import FanoutEngine
from ..relay.fec import StreamFec
from ..relay.megabatch import MegabatchScheduler
from ..relay.session import SessionRegistry, now_ms
from .config import ServerConfig
from .rest import RestApi
from .rtsp import RtspServer

#: below this many streams with players the megabatch scheduler idles and
#: each stream's engine queries its own device ring (the reference's
#: ``megabatch_min_streams`` default)
MEGABATCH_MIN_STREAMS = 2
#: per-engine counters ``stats()`` sums over every engine the server ran
ENGINE_COUNTERS = ("native_sent", "native_passes", "device_param_refreshes",
                   "send_errors", "missing_params", "batch_sent",
                   "batch_passes", "batch_rows")


class StreamingServer:
    def __init__(self, config: ServerConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        self.config = config or ServerConfig()
        self.device = resolve_device(device)
        self.registry = SessionRegistry(self.config.stream)
        self.rtsp = RtspServer(self.config, self.registry,
                               on_pump_wake=self._wake, device=self.device)
        self.megabatch = MegabatchScheduler(device=self.device)
        self.transcodes = MjpegTranscodeService(
            self.registry, on_frame=lambda _p: self._wake(),
            device=self.device)
        self.rest = RestApi(self.config, self)
        self._engines: dict[int, FanoutEngine] = {}
        #: native counters of engines whose streams went away
        self._retired = dict.fromkeys(ENGINE_COUNTERS, 0)
        #: stream id → the StreamFec of every stream with one, and the FEC
        #: counters of those that went away
        self._fec: dict[int, StreamFec] = {}
        self._fec_retired = dict.fromkeys(StreamFec.COUNTERS, 0)
        #: reliable-UDP resend sweeps: packets resent and given up
        self.reliable_resends = 0
        self.reliable_giveups = 0
        self.native_loaded = False
        self._pump_event = asyncio.Event()
        self._pump_task: asyncio.Task | None = None
        self._running = False
        self.wakes = 0
        #: host ms of the newest wakes that sent packets (the pump's clock)
        self.wake_ms: collections.deque = collections.deque(maxlen=8192)
        #: host ms of the first wake that sent packets (a first join's)
        self.wake_ms_first: float | None = None
        self.packets_out = 0
        self.pump_errors = 0

    async def start(self) -> None:
        self.native_loaded = native.available()
        if self.device.type == "cuda":
            self._warm_card()
        await self.rtsp.start()
        await self.rest.start()
        self._running = True
        self._pump_task = asyncio.create_task(self._pump_loop())

    async def stop(self) -> None:
        self._running = False
        if self._pump_task is not None:
            self._pump_event.set()
            await self._pump_task
            self._pump_task = None
        self.transcodes.stop_all()
        await self.rest.stop()
        await self.rtsp.stop()
        self.megabatch.drain()

    def _wake(self) -> None:
        self._pump_event.set()

    def _warm_card(self) -> None:
        """Make the CUDA context, load the kernel library and run one
        launch-floor kernel and one ring query on a small ring fed from
        pinned memory, then synchronise: a stream's first join then pays
        none of it.  The warm-up calls the library directly, so its
        launches are not counted."""
        lib = kernel_lib.library()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        ring = device_ring.init_ring(64, self.device)
        rows = torch.zeros((1, device_ring.ROW_STRIDE), dtype=torch.uint8,
                           pin_memory=True)
        device_ring.append_rows(ring, rows, torch.zeros(1, dtype=torch.int32,
                                                        pin_memory=True), 1)
        state = torch.zeros((1, 6), dtype=torch.uint32, device=self.device)
        out = torch.empty(5, dtype=torch.int32, device=self.device)
        for name, args in (
                ("ed_launch_floor", ()),
                ("ed_ring_query", (ring.rows.data_ptr(), ring.capacity,
                                   device_ring.ROW_STRIDE, ring.head,
                                   state.data_ptr(), 1,
                                   ring.scratch.data_ptr(), out.data_ptr()))):
            rc = getattr(lib, name)(*args, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: {kernel_lib.error_message(rc)}")
        torch.cuda.synchronize(self.device)

    def _engine_for(self, stream) -> FanoutEngine:
        eng = self._engines.get(id(stream))
        if eng is None:
            eng = self._engines[id(stream)] = FanoutEngine(device=self.device)
        egress = self.rtsp.shared_egress
        eng.egress_fd = egress.fileno() if egress is not None else -1
        return eng

    def _pairs(self) -> list:
        """(stream, engine) for every stream with outputs, in a stable
        order; engines of streams that went away are dropped."""
        pairs = [(stream, self._engine_for(stream))
                 for sess in list(self.registry.sessions.values())
                 for stream in sess.streams.values() if stream.num_outputs]
        live = {id(s) for s, _ in pairs}
        for sid in [k for k in self._engines if k not in live]:
            eng = self._engines.pop(sid)
            for k in ENGINE_COUNTERS:
                self._retired[k] += getattr(eng, k)
        for s, _ in pairs:
            if s.fec is not None:
                self._fec[id(s)] = s.fec
        for sid in [k for k in self._fec if k not in live]:
            fec = self._fec.pop(sid)
            for k, v in fec.drain_counters().items():
                self._fec_retired[k] += v
        return pairs

    def _pump_error(self) -> None:
        """Count an error the pump caught and keep its traceback."""
        self.pump_errors += 1
        traceback.print_exc(file=sys.stderr)

    def reflect_all(self) -> int:
        """One pump wake of the live relay; returns packets written.  One
        stream's error is counted and the wake goes on with the next; a
        failed ``begin_wake`` serves the wake's streams one by one."""
        t = now_ms()
        self.wakes += 1
        pairs = self._pairs()
        engaged = len(pairs) >= MEGABATCH_MIN_STREAMS
        if engaged:
            try:
                self.megabatch.begin_wake(pairs, t)
            except Exception:
                self._pump_error()
                engaged = False
        if not engaged:
            # too few streams to coalesce (or the scheduler failed): each
            # engine runs its own device ring, and the scheduler keeps
            # harvesting what it has out
            try:
                self.megabatch.idle_wake()
            except Exception:
                self._pump_error()
            for _stream, eng in pairs:
                eng.megabatch_owned = False
        sent = 0
        for stream, eng in pairs:
            try:
                sent += eng.step(stream, t)
            except Exception:
                self._pump_error()
            for out in list(stream.tickable_outputs):
                try:
                    self._tick(out, t)
                except Exception:
                    self._pump_error()
        self.packets_out += sent
        if engaged:
            self.megabatch.end_wake(pairs, t)
        return sent

    def _tick(self, out, t: int) -> None:
        """One reliable-UDP player's resend sweep."""
        expired = out.resender.expired
        self.reliable_resends += out.tick(t)
        self.reliable_giveups += out.resender.expired - expired

    def fec_stats(self) -> dict:
        """The FEC tier's counters over every stream the server ran, and
        the host ms per device pass of its three legs."""
        tot = dict(self._fec_retired)
        for fec in self._fec.values():
            for k in StreamFec.COUNTERS:
                tot[k] += getattr(fec, k)
        passes = max(tot["device_passes"], 1)
        for leg in ("stage", "kernel", "oracle"):
            tot[f"{leg}_ms_per_window"] = tot.pop(f"{leg}_ns") / passes / 1e6
        return tot

    async def _pump_loop(self) -> None:
        interval = self.config.reflect_interval_ms / 1000.0
        last_maint = 0.0
        while self._running:
            try:
                await asyncio.wait_for(self._pump_event.wait(), interval)
            except asyncio.TimeoutError:
                pass
            self._pump_event.clear()
            try:
                t0 = time.perf_counter()
                if self.reflect_all():
                    ms = (time.perf_counter() - t0) * 1e3
                    if self.wake_ms_first is None:
                        self.wake_ms_first = ms
                    self.wake_ms.append(ms)
            except Exception:
                # the pump must keep serving the streams; the error is
                # counted and its traceback kept
                self._pump_error()
            now = time.monotonic()
            if now - last_maint >= 1.0:
                last_maint = now
                t = now_ms()
                for sess in list(self.registry.sessions.values()):
                    sess.prune(t)
                    for st in sess.streams.values():
                        st.send_upstream_rr(t)
                self.rtsp.sweep_timeouts()
                self.transcodes.sweep()

    def stats(self) -> dict:
        engines = {k: v + sum(getattr(e, k) for e in self._engines.values())
                   for k, v in self._retired.items()}
        wake = sorted(self.wake_ms)
        return {"wakes": self.wakes, "packets_in": self.rtsp.packets_in,
                "packets_out": self.packets_out,
                "pump_errors": self.pump_errors,
                "sessions": len(self.registry.sessions),
                **engines,
                "wake_ms_p50": wake[len(wake) // 2] if wake else None,
                "wake_ms_max": wake[-1] if wake else None,
                "wake_ms_first": self.wake_ms_first,
                "native_loaded": self.native_loaded,
                "rtcp": {"in": self.rtsp.rtcp_in, **self.rtsp.rtcp_counts},
                "fec": self.fec_stats(),
                "reliable": {"resends": self.reliable_resends,
                             "acks": self.rtsp.reliable_acks,
                             "giveups": self.reliable_giveups},
                "megabatch": self.megabatch.stats(),
                "kernel_launches": dict(kernel_lib.LAUNCHES)}
