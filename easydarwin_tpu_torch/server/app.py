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
   batch-header rung (``relay_batch_step``, ``ed_relay_batch`` on the
   card), the rest through the Python loop; then the stream's RTCP (the pusher's
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
and HLS entries whose source went away.

HLS (``hls``): REST ``starthls`` or a GET of ``/hls/<path>/master.m3u8``
attaches the path's segmenters to its video track as relay outputs
(temporal rungs are thinned outputs, so they take the batch-header rung);
the requant rungs share one ``RequantLadder`` a path, whose B6 pass runs
on the server's device (or ``ServerConfig.hls_device``) from the requant
worker pool, beside the pump.
``stats()["hls"]`` sums the ladders' counters (dispatches, device
errors, shed AUs, host seconds by stage).

File playback (``vod``): with the segment cache on, the group pacer
(``VodPacerGroup``) fills every hot file session's rings at the head of
each wake and primes its joins on the card; its ``(stream, engine)``
pairs join the live pairs for the megabatch, the steps and the resend
sweeps.  A pacer error is counted (``vod_errors``) and the wake serves
the live streams.

DVR (``dvr``, with ``dvr_enabled`` and the segment cache on): RECORD arms
a spiller a stream, and each wake runs the spill tick after the pacer's
tick and before the pairs are taken, so a time-shift cursor at the
spill/ring seam sees the freshest cold tail; a failed spill tick is
counted (``spill_errors``) and the wake goes on.  Time-shift and ``.dvr``
replay sessions are the pacer's, so their streams ride the megabatch
with the live ones (``dvr_megabatch_streams`` counts them a wake).  With
``storage_enabled`` every finalized asset is sharded on a storage worker
(``StorageService.store_async``: B4 on the server's device), a window
the spill files no longer hold is reconstructed on a worker while the
cursor holds, and the maintenance loop submits a scrub every
``storage_scrub_interval_sec``.  At stop every armed asset finalizes,
then the storage workers finish.

``recordings`` attaches MP4 recorders to live sessions (REST
``startrecord``/``stoprecord``); recorder temp files a crashed process
left in the movie folder are listed at start (``record_orphans``).
"""

from __future__ import annotations

import asyncio
import collections
import os
import sys
import time
import traceback

import torch

from .. import native, resolve_device
from ..dvr import DvrManager
from ..dvr.timeshift import DVR_TIER
from ..hls import HlsService
from ..models.mjpeg_ladder import MjpegTranscodeService
from ..ops import device_ring, kernel_lib
from ..relay.fanout import FanoutEngine
from ..relay.fec import StreamFec
from ..relay.megabatch import MegabatchScheduler
from ..relay.session import SessionRegistry, now_ms
from ..storage import StorageService
from ..vod.cache import SegmentCache
from ..vod.record import RecordingManager, sweep_orphans
from ..vod.session import VodPacerGroup, VodService
from .config import ServerConfig
from .rest import RestApi
from .rtsp import RtspServer

#: below this many streams with players the megabatch scheduler idles and
#: each stream's engine queries its own device ring (the reference's
#: ``megabatch_min_streams`` default)
MEGABATCH_MIN_STREAMS = 2
#: in-flight storage restores the pump keeps at most
STORAGE_RESTORE_INFLIGHT_MAX = 32
#: per-engine counters ``stats()`` sums over every engine the server ran
ENGINE_COUNTERS = ("native_sent", "native_passes", "device_param_refreshes",
                   "send_errors", "tcp_shed_pkts", "missing_params",
                   "batch_sent", "batch_passes", "batch_rows",
                   "batch_stage_ns", "batch_kernel_ns")


class StreamingServer:
    def __init__(self, config: ServerConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        self.config = config or ServerConfig()
        self.device = resolve_device(device)
        self.registry = SessionRegistry(self.config.stream)
        self.vod = VodService(self.config.movie_folder)
        self.rtsp = RtspServer(self.config, self.registry,
                               on_pump_wake=self._wake, device=self.device,
                               vod=self.vod)
        self.megabatch = MegabatchScheduler(device=self.device)
        self.transcodes = MjpegTranscodeService(
            self.registry, on_frame=lambda _p: self._wake(),
            device=self.device)
        self.rest = RestApi(self.config, self)
        #: HLS publishing (REST ``starthls``, ``/hls/`` GETs); its requant
        #: rungs run B6 on the server's device unless the config names one
        self.hls = HlsService(
            self.registry,
            device=(self.device if self.config.hls_device is None
                    else resolve_device(self.config.hls_device)))
        self.recordings = RecordingManager()
        #: recorder temp files found in the movie folder at start
        self.record_orphans: list[str] = []
        self.vod_cache: SegmentCache | None = None
        self.vod_pacer: VodPacerGroup | None = None
        if self.config.vod_cache_enabled:
            self.vod_cache = SegmentCache(
                budget_bytes=self.config.vod_cache_bytes,
                window_samples=self.config.vod_cache_window_samples,
                device=self.device)
            self.vod_pacer = VodPacerGroup(
                self.vod_cache, engine_for=self._engine_for,
                engine_drop=self._drop_engine,
                scheduler=lambda: self.megabatch,
                settings=self.config.stream,
                lookahead_ms=self.config.vod_cache_lookahead_ms,
                device_prime=self.config.vod_cache_device)
            self.rtsp.vod_pacer = self.vod_pacer
        #: pacer ticks that raised (the wake went on without its pairs)
        self.vod_errors = 0
        self.dvr: DvrManager | None = None
        self.storage: StorageService | None = None
        #: (path, track, window) → the storage worker's restore future
        self._storage_fetches: dict = {}
        self._storage_scrub_due = 0.0
        self._build_dvr()
        #: time-shift and ``.dvr`` streams handed to ``begin_wake``,
        #: summed over the wakes
        self.dvr_megabatch_streams = 0
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
        #: the process's CPU seconds (every thread) and the host clock at
        #: construction: ``stats`` reports both since then, which says
        #: whether the server ran short of cores or of the GIL
        self._cpu0 = time.process_time()
        self._wall0 = time.monotonic()

    def _build_dvr(self) -> None:
        """The DVR manager under ``<movie_folder>/.dvr`` and the store
        under ``<movie_folder>/.shards``, as the configuration asks.  DVR
        without the segment cache, or the store without DVR, is refused
        with a line on stderr and stays off."""
        cfg = self.config
        if cfg.dvr_enabled and self.vod_pacer is None:
            print("dvr_enabled needs vod_cache_enabled (the spill serves "
                  "through the segment cache); DVR is off", file=sys.stderr)
        elif cfg.dvr_enabled:
            self.dvr = DvrManager(
                os.path.join(cfg.movie_folder, ".dvr"), self.vod_cache,
                self.vod_pacer, self.registry,
                window_pkts=cfg.dvr_window_pkts,
                retention_bytes=cfg.dvr_retention_bytes,
                retention_sec=cfg.dvr_retention_sec)
            self.rtsp.dvr = self.dvr
        if cfg.storage_enabled and self.dvr is None:
            print("storage_enabled needs dvr_enabled (only finalized DVR "
                  "assets are sharded); storage is off", file=sys.stderr)
        elif cfg.storage_enabled:
            self.storage = StorageService(
                os.path.join(cfg.movie_folder, ".shards"), cfg.server_id,
                k=cfg.storage_data_shards, m=cfg.storage_parity_shards,
                device=self.device)
            self.dvr.on_finalize = self._storage_on_finalize
            self.dvr.restorer = self._storage_restore

    def _storage_on_finalize(self, result: dict) -> None:
        """The finalize hook: shard the finished asset on a storage
        worker (the parity products are blocking; a finalize runs on the
        event loop)."""
        self.storage.store_async(result["path"], self.dvr)

    def _storage_restore(self, path: str, track_id: int,
                         win: int) -> bytes | None:
        """The spill chain's last resort, called on the pump: start the
        shard gather and reconstruct on a storage worker and answer
        ``b""`` while it runs (the time-shift cursor holds), the blob
        when it lands, None when the stripe is beyond the parity budget
        or too many restores are in flight."""
        key = (self.dvr.live_path_of(path), int(track_id), int(win))
        fut = self._storage_fetches.get(key)
        if fut is None:
            if len(self._storage_fetches) >= STORAGE_RESTORE_INFLIGHT_MAX:
                for k in [k for k, f in self._storage_fetches.items()
                          if f.done()]:
                    del self._storage_fetches[k]
                if len(self._storage_fetches) \
                        >= STORAGE_RESTORE_INFLIGHT_MAX:
                    return None
            self._storage_fetches[key] = self.storage.restore_async(
                path, int(track_id), int(win))
            return b""
        if not fut.done():
            return b""
        del self._storage_fetches[key]
        if fut.cancelled() or fut.exception() is not None:
            return None                 # counted in worker_errors
        return fut.result()

    async def start(self) -> None:
        self.native_loaded = native.available()
        if self.device.type == "cuda":
            self._warm_card()
        self.record_orphans = sweep_orphans(self.config.movie_folder)
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
        # every in-flight recording finalizes while its session exists
        self.recordings.stop_all()
        if self.dvr is not None:
            self.dvr.close()            # every armed asset finalizes
            self.rtsp.dvr = None
        if self.storage is not None:
            self.storage.close()        # the stores in flight finish
            self._storage_fetches.clear()
        await self.rest.stop()
        await self.rtsp.stop()
        if self.vod_pacer is not None:
            self.rtsp.vod_pacer = None
            self.vod_pacer.close()
            self.vod_cache.close()
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

    def _drop_engine(self, stream) -> None:
        """Forget a stream's engine, keeping its counters."""
        self._retire_engine(id(stream))

    def _retire_engine(self, sid: int) -> None:
        eng = self._engines.pop(sid, None)
        if eng is not None:
            for k in ENGINE_COUNTERS:
                self._retired[k] += getattr(eng, k)

    def _pairs(self, vod_pairs=()) -> list:
        """(stream, engine) for every live stream with outputs, in a
        stable order, then ``vod_pairs``; engines of streams that went
        away are dropped."""
        pairs = [(stream, self._engine_for(stream))
                 for sess in list(self.registry.sessions.values())
                 for stream in sess.streams.values() if stream.num_outputs]
        pairs.extend(vod_pairs)
        live = {id(s) for s, _ in pairs}
        for sid in [k for k in self._engines if k not in live]:
            self._retire_engine(sid)
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
        vod_pairs = []
        if self.vod_pacer is not None and self.vod_pacer.sessions:
            try:
                vod_pairs = self.vod_pacer.tick(t)
            except Exception:
                self.vod_errors += 1
                traceback.print_exc(file=sys.stderr)
        if self.dvr is not None and self.dvr._armed:
            try:
                self.dvr.tick(t)
            except Exception:
                self.dvr.spill_errors += 1
                traceback.print_exc(file=sys.stderr)
        pairs = self._pairs(vod_pairs)
        engaged = len(pairs) >= MEGABATCH_MIN_STREAMS
        if engaged:
            try:
                self.megabatch.begin_wake(pairs, t)
                self.dvr_megabatch_streams += sum(
                    1 for s, _e in pairs
                    if getattr(s, "audience_tier", None) == DVR_TIER)
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

    def egress_stats(self) -> dict:
        """The egress core's UDP send counters (sendmmsg calls, datagrams,
        ns inside the calls), when it is loaded."""
        if not native.loaded():
            return {}
        core = native.get_stats()
        return {k: core[k] for k in ("sendmmsg_calls", "send_packets",
                                     "send_ns")}

    def ingest_stats(self) -> dict:
        """UDP pushers' RTP ingest: the RTSP layer's counts, and the
        egress core's receive counters (recvmmsg calls and the ns inside
        the native drain) when it is loaded."""
        ing = dict(self.rtsp.ingest)
        if native.loaded():
            core = native.get_stats()
            for k in ("recvmmsg_calls", "recv_packets", "ingest_ns"):
                ing[k] = core[k]
        return ing

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
                self.hls.sweep()
                if self.storage is not None \
                        and now >= self._storage_scrub_due:
                    self._storage_scrub_due = (
                        now + self.config.storage_scrub_interval_sec)
                    self.storage.scrub_async()

    def stats(self) -> dict:
        engines = {k: v + sum(getattr(e, k) for e in self._engines.values())
                   for k, v in self._retired.items()}
        # the batch-header rung's device leg, host ms a pass
        passes = max(engines["batch_passes"], 1)
        for leg in ("stage", "kernel"):
            engines[f"batch_{leg}_ms_per_pass"] = \
                engines.pop(f"batch_{leg}_ns") / passes / 1e6
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
                "ingest": self.ingest_stats(),
                "egress": self.egress_stats(),
                "rtcp": {"in": self.rtsp.rtcp_in, **self.rtsp.rtcp_counts},
                "fec": self.fec_stats(),
                "reliable": {"resends": self.reliable_resends,
                             "acks": self.rtsp.reliable_acks,
                             "giveups": self.reliable_giveups},
                "megabatch": self.megabatch.stats(),
                "vod": (None if self.vod_pacer is None
                        else self.vod_pacer.stats()),
                "vod_errors": self.vod_errors,
                "dvr": None if self.dvr is None else self.dvr.stats(),
                "dvr_megabatch_streams": self.dvr_megabatch_streams,
                "storage": (None if self.storage is None
                            else self.storage.stats()),
                "hls": self.hls.stats(),
                "hls_not_modified": self.rest.hls_not_modified,
                "recordings": len(self.recordings.active),
                "record_orphans": self.record_orphans,
                "cpu_s": time.process_time() - self._cpu0,
                "wall_s": time.monotonic() - self._wall0,
                "kernel_launches": dict(kernel_lib.LAUNCHES)}
