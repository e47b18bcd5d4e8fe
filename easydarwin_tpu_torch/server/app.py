"""Server assembly: session registry → RTSP listener + REST API → relay
pump, and the MJPEG transcode service the REST API starts ladders on.

The pump is one asyncio task, woken by ingest and ticking every
``reflect_interval_ms``.  Each wake runs the live relay for every stream
that has outputs:

1. ``MegabatchScheduler.begin_wake`` — harvest the previous wake's device
   pass, prime params for streams whose membership changed;
2. ``FanoutEngine.step`` per stream — write every eligible packet from the
   installed params;
3. ``MegabatchScheduler.end_wake`` — stage and dispatch the next pass (one
   ``ed_relay_window`` launch per shape bucket on the card).

Once a second the pump evicts old packets, closes idle connections and
retires transcode ladders whose source went away.
"""

from __future__ import annotations

import asyncio
import sys
import time
import traceback

import torch

from .. import resolve_device
from ..models.mjpeg_ladder import MjpegTranscodeService
from ..ops import kernel_lib
from ..relay.fanout import FanoutEngine
from ..relay.megabatch import MegabatchScheduler
from ..relay.session import SessionRegistry, now_ms
from .config import ServerConfig
from .rest import RestApi
from .rtsp import RtspServer


class StreamingServer:
    def __init__(self, config: ServerConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        self.config = config or ServerConfig()
        self.device = resolve_device(device)
        self.registry = SessionRegistry(self.config.stream)
        self.rtsp = RtspServer(self.config, self.registry,
                               on_pump_wake=self._wake)
        self.megabatch = MegabatchScheduler(device=self.device)
        self.transcodes = MjpegTranscodeService(
            self.registry, on_frame=lambda _p: self._wake(),
            device=self.device)
        self.rest = RestApi(self.config, self)
        self._engines: dict[int, FanoutEngine] = {}
        self._pump_event = asyncio.Event()
        self._pump_task: asyncio.Task | None = None
        self._running = False
        self.wakes = 0
        self.packets_out = 0
        self.pump_errors = 0

    async def start(self) -> None:
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

    def _pairs(self) -> list:
        """(stream, engine) for every stream with outputs, in a stable
        order; engines of streams that went away are dropped."""
        pairs = []
        for sess in list(self.registry.sessions.values()):
            for stream in sess.streams.values():
                if stream.num_outputs:
                    eng = self._engines.get(id(stream))
                    if eng is None:
                        eng = self._engines[id(stream)] = FanoutEngine()
                    pairs.append((stream, eng))
        live = {id(s) for s, _ in pairs}
        for sid in [k for k in self._engines if k not in live]:
            del self._engines[sid]
        return pairs

    def reflect_all(self) -> int:
        """One pump wake of the live relay; returns packets written."""
        t = now_ms()
        self.wakes += 1
        pairs = self._pairs()
        if not pairs:
            self.megabatch.idle_wake()
            return 0
        self.megabatch.begin_wake(pairs, t)
        sent = 0
        for stream, eng in pairs:
            sent += eng.step(stream, t)
        self.megabatch.end_wake(pairs, t)
        self.packets_out += sent
        return sent

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
                self.reflect_all()
            except Exception:
                # the pump must keep serving the other streams; the error
                # is counted and its traceback kept
                self.pump_errors += 1
                traceback.print_exc(file=sys.stderr)
            now = time.monotonic()
            if now - last_maint >= 1.0:
                last_maint = now
                t = now_ms()
                for sess in list(self.registry.sessions.values()):
                    sess.prune(t)
                self.rtsp.sweep_timeouts()
                self.transcodes.sweep()

    def stats(self) -> dict:
        return {"wakes": self.wakes, "packets_in": self.rtsp.packets_in,
                "packets_out": self.packets_out,
                "pump_errors": self.pump_errors,
                "sessions": len(self.registry.sessions),
                "megabatch": self.megabatch.stats(),
                "kernel_launches": dict(kernel_lib.LAUNCHES)}
