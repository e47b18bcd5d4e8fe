"""Server assembly: session registry → RTSP listener + REST API → relay
pump, and the MJPEG transcode service the REST API starts ladders on.

The pump is one asyncio task, woken by ingest, by the earliest stream
deadline on the egress core's 1 ms timer wheel (``native.TimerWheel``: a
held bucket's release, a reliable-UDP resend's RTO, from
``RelayStream.next_deadline_ms``), and at the latest every
``reflect_interval_ms``.  The wheel is required: a server whose egress
core does not build does not start.  Each wake runs the live relay for
every stream that has outputs.  With at least ``MEGABATCH_MIN_STREAMS``
of them:

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
   ``ed_relay_window`` launch for the wake on the card; with
   ``megabatch_devices`` past 1 on a box of several cards, one a card over
   the ``src`` mesh ``make_megabatch_mesh`` builds, whose summary the
   stats carry as ``mesh``).

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

The server surface (``rtsp``, ``rest``): RTSP auth from the config
(``server.auth``), the access and error logs under ``log_folder``
(``utils.logs``), icy MP3 and ``.m3u`` playlists on the RTSP port
(``mp3``), ``.sdp`` broadcasts (``relay_source``) and pull relays
(``pulls``).  A pulled or broadcast path is a relay session whose
packets enter its ring through ``RelaySession.push`` as a pusher's do,
and wake the pump.  Once a second the housekeeping also closes
broadcasts without players and retires pulls whose upstream ended.
``server_info``, ``live_sessions`` and ``device_stream_url`` answer the
core REST commands; ``request_restart`` sets ``restart_event``, on which
the CLI exits with the watchdog's restart code.  ``update`` on the
config re-reads auth and the logs.

Observability (``obs``, the reference's stack): every pump wake is one
wake-ledger record (``LEDGER.begin_wake`` in ``reflect_all``, closed
after the once-a-second block), its work in units of the closed
work-class vocabulary (``vod_fill``, ``dvr_spill``, ``megabatch``,
``live_relay``); an ingest's wake is stamped and the delay to its pass
observed as the pump's ``wake_to_pass`` phase.  Once a second the pump
ticks the SLO watchdog (``slo_enabled``), observes each relaying
stream's freshness (``obs.fleet``) and ticks the audience store.  At
start the flight recorder's dumps go under ``<log_folder>/flight``, the
node id is ``server_id`` and every registered module's (``register_module``,
before ``start``) ``initialize`` runs; ``stop`` runs their ``shutdown``.  ``status`` (``server.status.StatusMonitor``) answers
``server_info`` (its ingest-to-wire p99 and the ledger's class and last
wake among the reference's keys), the console columns
(``stats_interval_sec``) and the status file (``status_file_path``).
The stats page answers GET ``/`` and ``/stats`` on the RTSP port.
With ``module_folder`` set, the ``*.py`` plugin files there are loaded
(``server.modules.load_modules_from``) and their modules registered at
start, before anything serves.

Resilience (``resilience``, the reference's): with ``resilience_enabled``
the server keeps a ``DegradationLadder``.  Each wake the pump asks it each
live stream's rung: only a stream on the megabatch rung joins the
megabatch (``allows_megabatch``); the device rung steps the stream's
engine on its own device ring; the cpu rung (also a retry's backoff
window) serves the stream by the host scalar path (``RelayStream.
reflect``), a path the pump chooses, not a kernel wrapper falling back;
the shed rung serves it so and sheds its newest subscriber once a
second.  An exception of the device path (an engine step's device
work: ``FanoutEngine.device_error``; the scheduler's ``begin_wake`` or
``end_wake``) counts in ``device_errors``.  Only an injected one
(``InjectedFault``, counted in ``device_errors_injected``) is charged to
the ladder: an engine step's with ``note_device_error`` (a device step
that succeeds with ``note_device_ok``), the scheduler's with
``note_scheduler_error`` over the wake's megabatch streams.  A real one
is a pump error and moves no rung, so the host scalar path never serves
around a failing kernel or launch: the stream's step sends nothing, and
a failed scheduler leaves the wake's streams to their own engines on the
device.  Any other error (a broken output's send) is a pump error and
moves no rung.  An RTX give-up
of the FEC tier is charged to its path.  The 1 Hz block ticks the ladder
with the streams' stalls and the SLO watchdog's edge, and sheds.  A
``resilience_fault_plan`` is armed on the process-wide ``INJECTOR``
before anything serves and disarmed at stop.  With
``resilience_checkpoint_enabled`` the relay state is restored from
``<log_folder>/ckpt/relay.json`` at start (after the egress pair exists,
before the pump) and written every ``resilience_checkpoint_interval_sec``
and at stop, beside the segment cache's hot set (``vod_cache.json``).  A
restored UDP subscriber sends through the shared egress pair and gets a
connection stand-in that its RTCP proves alive; one silent for
``rtsp_timeout_sec`` is removed.  A restored interleaved-TCP record
parks until its player's SETUP re-attaches it; one unclaimed for
``rtsp_timeout_sec`` is counted in ``ckpt.tcp_orphan``.

The cluster (``cluster``, the reference's tier): with ``cluster_enabled``
the server builds a ``ClusterService`` at start, after the listeners and
the pump (its Redis is ``redis_client``, or an ``AsyncRedis`` to
``redis_host``:``redis_port``).  Its tick is a task of its own, the only
code that awaits Redis; the pump's wake never does.  It holds the node's
fenced lease, claims every locally sourced path and publishes its
checkpoint (``Ckpt:``), and adopts a path whose owner's lease died when
this node is the ring's successor: ``_cluster_restore`` restores the
published document into the live registry (a path this node was pulling
merges, each of its own outputs' bookmarks clamped to the restored
head), re-points the UDP subscribers through the shared egress pair
without a re-SETUP and parks the interleaved ones for their re-attach.
A newer fencing token (``_cluster_fence_lost``) takes the path's data
plane away: its pusher connections close and its session goes.  A
DESCRIBE of a path another live node owns (``_cluster_describe``) is
served through a ``RemotePull``.  Its failures count in
``pull_errors``; only an injected one (``pull_stall``, counted in
``pull_errors_injected``) is charged to the degradation ladder's
``pull_errors``, as only an injected device fault moves a rung: a
network failure leaves the stream on the card.  A ``LoadTracker`` publishes the
capacity score (``cluster_capacity_score``, else the boot self-bench)
and the utilization into the lease each tick; past
``cluster_admission_high_water`` (or when ``overload_spoof`` fires) a
session's first play SETUP is answered 305 to an edge with headroom or
453 (``_admission_verdict``; plain local-file VOD is exempt).  A pulling
peer's ``X-Trace-Id`` is adopted only from a live lease's address
(``_peer_trace_gate``).  ``stop`` drains: fresh checkpoints, the lease
released, so a peer adopts within a tick.  Without a cluster,
``cloud_enabled`` keeps the reference's passive presence records (a
Redis unreachable at start leaves the server standalone).
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import sys
import time
import traceback
import types

import torch

from .. import native, obs, resolve_device
from ..resilience import (INJECTOR, LEVEL_DEVICE, LEVEL_FULL, LEVEL_SHED,
                          CheckpointManager, DegradationLadder,
                          InjectedFault)
from ..dvr import DvrManager
from ..dvr.timeshift import DVR_TIER
from ..hls import HlsService
from ..models.mjpeg_ladder import MjpegTranscodeService
from ..obs import fleet as obs_fleet
from ..ops import device_ring, kernel_lib, staging
from ..parallel.distributed import mesh_summary
from ..parallel.mesh import make_megabatch_mesh
from ..relay.fanout import FanoutEngine
from ..relay.fec import StreamFec
from ..relay.megabatch import MegabatchScheduler
from ..relay.pull import PullRelayManager
from ..relay.session import SessionRegistry, now_ms
from ..relay.source import SdpFileRelaySource
from ..storage import StorageService
from ..utils.logs import AccessLog, ErrorLog
from ..vod.cache import SegmentCache
from ..vod.record import RecordingManager, sweep_orphans
from ..vod.session import VodPacerGroup, VodService
from .auth import auth_from_config
from .config import ServerConfig
from .modules import load_modules_from
from .mp3 import Mp3Service
from .rest import RestApi
from .rtsp import RtspServer
from .status import StatusMonitor
from .transports import UdpOutput

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
                   "batch_stage_ns", "batch_kernel_ns", "loop_sent",
                   "loop_ns")


class _RestoredSubscriber:
    """The connection stand-in of a UDP subscriber the checkpoint
    restored.  Its RTSP connection died with the previous process; this
    carries what ``RtspServer.on_client_rtcp`` reads (``player_tracks``,
    ``relay``, ``path``, ``last_activity``), so the player's receiver
    reports still move its output's quality and prove it alive, and the
    sweep removes the output after ``rtsp_timeout_sec`` of silence."""

    def __init__(self, sess, track_id: int, stream, output):
        self.relay = sess
        self.path = sess.path
        self.stream = stream
        self.output = output
        self.player_tracks = {track_id: output}
        self.last_activity = time.monotonic()


class StreamingServer:
    def __init__(self, config: ServerConfig | None = None, *,
                 device: str | torch.device = "cuda", redis_client=None):
        self.config = config or ServerConfig()
        self.device = resolve_device(device)
        self.registry = SessionRegistry(self.config.stream)
        self.vod = VodService(self.config.movie_folder)
        self.rtsp = RtspServer(self.config, self.registry,
                               on_pump_wake=self._wake, device=self.device,
                               vod=self.vod)
        #: the Redis the cluster tier or the presence records use (None:
        #: an ``AsyncRedis`` to ``redis_host``:``redis_port`` at start)
        self._redis_client = redis_client
        #: the cluster service, its load tracker and the passive presence
        #: (built at start as the config asks)
        self.cluster = None
        self.load_tracker = None
        self.presence = None
        self._presence_sync: asyncio.Task | None = None
        #: the cluster's status as it stood when it stopped (``stats``)
        self._cluster_final: dict | None = None
        #: the helper threads of peer REST GETs (a stitched trace's hops)
        self._dvr_fetch_pool = None
        #: the config's auth and log keys the surface was built from
        self._surface_keys = None
        self._apply_surface_config(self.config)
        self.config.on_change(self._apply_surface_config)
        self.config.on_change(self.rtsp.modules.run_reread_prefs)
        self.relay_source = SdpFileRelaySource(
            self.config.movie_folder, self.registry,
            on_ingest=self._on_ingest)
        self.rtsp.relay_source = self.relay_source
        self.pulls = PullRelayManager(self.registry,
                                      on_packet=self._on_ingest)
        #: the running pull sweep (a task; None: none)
        self._pull_sweep: asyncio.Task | None = None
        self.mp3 = Mp3Service(self.config.movie_folder)
        self.rtsp.http_get_handler = self._rtsp_port_http_get
        #: set by REST ``restart``: the CLI stops and exits with the
        #: watchdog's restart code
        self.restart_event = asyncio.Event()
        self.started_at = time.time()
        #: the console, status file and ``server_info`` reader
        self.status = StatusMonitor(self)
        #: the SLO watchdog over the ``obs`` families (ticked once a
        #: second by the pump when ``slo_enabled``)
        self.slo = obs.SloWatchdog(self.config.slo_config(),
                                   offender=obs.PROFILER.top_offender)
        #: the degradation ladder (``resilience_enabled``): each live
        #: stream's rung, asked by the pump a wake and ticked once a second
        self.ladder: DegradationLadder | None = None
        if self.config.resilience_enabled:
            self.ladder = DegradationLadder(self.config.ladder_config())
            # an exhausted RTX budget is charged to the ladder: a
            # black-holed player's NACK storm sheds load like any overload
            self.rtsp.on_rtx_giveup = (
                lambda path: self.ladder.note_device_error(
                    path, reason="rtx_giveup"))
        #: device-path exceptions the pump caught (engine steps and the
        #: scheduler), and of them the injected ones
        self.device_errors = 0
        self.device_errors_injected = 0
        #: cluster pull failures, and of them the injected ones
        self.pull_errors = 0
        self.pull_errors_injected = 0
        #: live stream passes the pump served by the host scalar path
        #: (the cpu and shed rungs, a retry's backoff)
        self.host_steps = 0
        #: the session checkpoint (built at start with the log folder)
        self.checkpoint: CheckpointManager | None = None
        #: where the segment cache's hot set is checkpointed (None: off)
        self._vod_ckpt_path: str | None = None
        #: the stand-ins of checkpoint-restored UDP subscribers
        self._restored_subs: list[_RestoredSubscriber] = []
        #: parked interleaved-TCP checkpoint records: (path, track,
        #: session id) → (record, monotonic time parked)
        self._pending_tcp: dict = {}
        #: restored sessions and outputs at the last start
        self.restored = (0, 0)
        self._armed_faults = False
        #: the ``perf_counter_ns`` of the first ingest wake not yet served
        #: (the pump's ``wake_to_pass`` phase); None: none pending
        self._wake_ns: int | None = None
        self._status_task: asyncio.Task | None = None
        #: the megabatch's serving mesh (``megabatch_devices``), or None:
        #: one device
        self.megabatch_mesh = self._build_mesh()
        self.megabatch = MegabatchScheduler(device=self.device,
                                            mesh=self.megabatch_mesh)
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
        #: the largest RTO a reliable player's sweep ran with (ms)
        self.reliable_rto_ms_max = 0.0
        self.native_loaded = False
        self._pump_event = asyncio.Event()
        self._pump_task: asyncio.Task | None = None
        self._running = False
        #: the pump's timer wheel (made at start) and, per stream id, the
        #: (timer id, due ms) armed on it
        self._wheel: native.TimerWheel | None = None
        self._wheel_sched: dict[int, tuple[int, int]] = {}
        #: pump wakes by cause: the wait timed out (the interval, or a
        #: deadline the wheel armed: ``wheel_wakes`` of them), or an
        #: ingest or a stop set the event
        self.time_wakes = 0
        self.wheel_wakes = 0
        self.event_wakes = 0
        self.wakes = 0
        #: host ms of the newest wakes that sent packets (the pump's clock)
        self.wake_ms: collections.deque = collections.deque(maxlen=8192)
        #: host ms of the first wake that sent packets (a first join's)
        self.wake_ms_first: float | None = None
        #: host ms of each wake's wheel work after its pass (advance, and
        #: every stream's next deadline armed): not in ``wake_ms``
        self.schedule_ms: collections.deque = collections.deque(maxlen=8192)
        self.packets_out = 0
        self.pump_errors = 0
        #: the process's CPU seconds (every thread) and the host clock at
        #: construction: ``stats`` reports both since then, which says
        #: whether the server ran short of cores or of the GIL
        self._cpu0 = time.process_time()
        self._wall0 = time.monotonic()

    def _build_mesh(self):
        """The ``src`` mesh over the first ``megabatch_devices`` cards (0:
        every card), clamped to the cards the box has: None on one card,
        on the CPU, or with ``megabatch_devices`` 1, which keeps the
        one-device path exactly."""
        if self.config.megabatch_devices == 1 or self.device.type != "cuda":
            return None
        return make_megabatch_mesh(self.config.megabatch_devices)

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

    @property
    def modules(self):
        return self.rtsp.modules

    def register_module(self, module) -> None:
        """Add a plugin module to the role arrays (``server.modules``)."""
        self.rtsp.modules.register(module)

    async def start(self) -> None:
        native.require()                # the pump's wheel is the core's
        self.native_loaded = True
        self._wheel = native.TimerWheel(now_ms())
        self._wheel_sched.clear()
        if self.device.type == "cuda":
            self._warm_card()
        self.record_orphans = sweep_orphans(self.config.movie_folder)
        # the recorder and the node id are process-wide: a server that
        # starts claims them (one that is only constructed does not)
        obs.FLIGHT.dump_dir = os.path.join(self.config.log_folder, "flight")
        obs.set_node(self.config.server_id)
        # plugins register before the listeners accept anything, so their
        # hooks see every request
        if self.config.module_folder:
            for m in load_modules_from(
                    self.config.module_folder,
                    on_error=lambda f, e: self.rtsp.log_error(
                        f"module {f} failed: {e!r}")):
                self.register_module(m)
        # the chaos plan is armed before anything serves, so the first
        # pass already runs under it
        plan = self.config.fault_plan()
        if plan is not None:
            INJECTOR.arm(plan)
            self._armed_faults = True
        await self.rtsp.start()
        await self.rest.start()
        if self.config.resilience_checkpoint_enabled:
            self._restore_checkpoint()
        self.rtsp.modules.run_initialize(self)
        self._running = True
        self._pump_task = asyncio.create_task(self._pump_loop())
        if self.config.stats_interval_sec or self.config.status_file_path:
            self._status_task = asyncio.create_task(self._status_loop())
        if self.config.cluster_enabled:
            await self._start_cluster()
        elif self.config.cloud_enabled:
            await self._start_presence()

    def _redis(self):
        from ..cluster.redis_client import AsyncRedis
        return self._redis_client or AsyncRedis(self.config.redis_host,
                                                self.config.redis_port)

    async def _start_cluster(self) -> None:
        """The cluster service on the bound ports, its load tracker (the
        capacity score, else the boot self-bench), the admission gate, the
        fleet rollup, the peer trace gate and the DESCRIBE fallback."""
        from ..cluster.capacity import LoadTracker, self_bench
        from ..cluster.service import ClusterService
        ccfg = self.config.cluster_config()
        ccfg.rtsp_port = self.rtsp.port or self.config.rtsp_port
        ccfg.http_port = self.rest.port or self.config.service_port
        self.cluster = ClusterService(
            self._redis(), ccfg, registry=self.registry,
            pull_manager=self.pulls, restore_doc=self._cluster_restore,
            on_pull_failure=self._on_pull_failure,
            on_fence_lost=self._cluster_fence_lost,
            # the server's error log as it stands when a warning comes (an
            # ``update`` may have made it again)
            error_log=types.SimpleNamespace(warning=self.rtsp.log_error))
        cap = self.config.cluster_capacity_score or self_bench()
        self.load_tracker = LoadTracker(
            cap, slo=self.slo if self.config.slo_enabled else None,
            subscribers=lambda: sum(
                s.num_outputs for s in self.registry.sessions.values()))
        self.cluster.load_status = self.load_tracker.sample
        if ccfg.admission_enabled:
            self.rtsp.admission = self._admission_verdict
        self.cluster.fleet_status = lambda: obs_fleet.build_rollup(self)
        self.rtsp.peer_trace_gate = self._peer_trace_gate
        await self.cluster.start()
        self.rtsp.describe_fallback = self._cluster_describe

    async def _start_presence(self) -> None:
        """The reference's passive presence records; a Redis unreachable
        now leaves the server standalone, as the reference's does."""
        from ..cluster.presence import PresenceService
        self.presence = PresenceService(
            self._redis(), self.config.server_id, ip=self.config.wan_ip,
            rtsp_port=self.rtsp.port or self.config.rtsp_port,
            http_port=self.rest.port or self.config.service_port)
        try:
            await self.presence.start()
        except Exception as e:
            self.rtsp.log_error(f"presence: {e!r}")
            self.presence = None

    async def _stop_cluster(self) -> None:
        """The planned drain (fresh checkpoints, the lease released) while
        the registry is whole, then the presence records."""
        if self.cluster is not None:
            self._cluster_final = self.cluster_stats()
            try:
                await self.cluster.stop(drain=True)
            except Exception as e:
                self.rtsp.log_error(f"cluster stop: {e!r}")
            self.cluster = None
            self.rtsp.admission = None
            self.rtsp.peer_trace_gate = None
            self.rtsp.describe_fallback = None
            self.load_tracker = None
        if self._presence_sync is not None:
            await asyncio.gather(self._presence_sync, return_exceptions=True)
            self._presence_sync = None
        if self.presence is not None:
            try:
                await self.presence.stop()
            except Exception as e:
                self.rtsp.log_error(f"presence stop: {e!r}")
            self.presence = None

    def _restore_checkpoint(self) -> None:
        """Build the checkpoint manager and restore from it: after the
        egress pair exists (restored UDP subscribers send through it),
        before the pump starts.  The segment cache's hot set is re-warmed
        beside it."""
        ckpt_dir = os.path.join(self.config.log_folder, "ckpt")
        self.checkpoint = CheckpointManager(
            ckpt_dir,
            interval_sec=self.config.resilience_checkpoint_interval_sec,
            max_age_sec=self.config.resilience_checkpoint_max_age_sec)
        self.rtsp.tcp_restore = self.claim_tcp_restore
        try:
            self.restored = self.checkpoint.restore(
                self.registry, output_factory=self._restored_output,
                tcp_sink=self._park_tcp_record)
            if self.restored[1]:
                self._adopt_restored_outputs()
            if self.restored[0]:
                self.rtsp.log_error(
                    f"checkpoint: restored {self.restored[0]} sessions / "
                    f"{self.restored[1]} subscribers")
        except Exception as e:
            self.rtsp.log_error(f"checkpoint restore: {e!r}")
        if self.vod_cache is not None:
            self._vod_ckpt_path = os.path.join(ckpt_dir, "vod_cache.json")
            try:
                with open(self._vod_ckpt_path, encoding="utf-8") as fh:
                    self.vod_cache.restore(json.load(fh))
            except (OSError, ValueError):
                pass

    def _write_checkpoint(self) -> bool:
        """One relay checkpoint, and the segment cache's hot set beside
        it (the same tmp + rename rule)."""
        wrote = self.checkpoint.write(self.registry)
        if wrote and self._vod_ckpt_path is not None:
            self._write_vod_cache_meta()
        return wrote

    def _write_vod_cache_meta(self) -> None:
        path = self._vod_ckpt_path
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(self.vod_cache.snapshot(), fh,
                          separators=(",", ":"))
            os.replace(tmp, path)
        except OSError:
            pass

    def _restored_output(self, rec: dict):
        """The checkpoint's output factory: a UDP subscriber made again
        on the shared egress pair (the address pair is its whole
        transport, so the player never learns the server restarted).
        Any other kind gives None."""
        if rec.get("kind") != "udp" or not rec.get("rtp_addr"):
            return None
        egress = self.rtsp.shared_egress
        if egress is None:
            return None
        ip, rtp_port = rec["rtp_addr"]
        rtcp = rec.get("rtcp_addr") or (ip, int(rtp_port) + 1)
        out = UdpOutput(egress, ip, int(rtp_port), int(rtcp[1]))
        # the RTCP destination may be another host than the RTP one
        out.rtcp_addr = (rtcp[0], int(rtcp[1]))
        return out

    def _adopt_restored_outputs(self, *, paths=None, exclude_ids=()) -> None:
        """Give every restored UDP output a connection stand-in whose
        RTCP keys route the player's reports to it.  At start every output
        in the registry is a restored one; a cluster adoption names its
        ``paths`` and excludes the outputs those sessions already had
        (``exclude_ids``, by ``id``), which have their own connections."""
        exclude = set(exclude_ids)
        for sess in self.registry.sessions.values():
            if paths is not None and sess.path not in paths:
                continue
            for tid, stream in sess.streams.items():
                for out in stream.outputs:
                    if getattr(out, "native_addr", None) is None \
                            or id(out) in exclude:
                        continue
                    sub = _RestoredSubscriber(sess, tid, stream, out)
                    self._restored_subs.append(sub)
                    self.rtsp.note_player_output(sub, out)

    # ----------------------------------------------------------- the cluster
    def _cluster_restore(self, doc: dict) -> tuple[int, int]:
        """The cluster's adoption hook: restore an adopted path's
        published checkpoint into the live registry.  UDP subscribers are
        re-pointed through the shared egress pair without a re-SETUP (the
        address pair is their transport); interleaved ones park for their
        player's re-attach with its old Session id.  The adopted sessions'
        trace lineage gains this node."""
        from ..resilience.checkpoint import restore_registry
        if self.rtsp.tcp_restore is None:
            self.rtsp.tcp_restore = self.claim_tcp_restore
        paths = {s.get("path") for s in doc.get("sessions", ())}
        pre = {id(o)
               for p in paths if p
               for sess in (self.registry.find(p),) if sess is not None
               for st in sess.streams.values() for o in st.outputs}
        n_sess, n_out = restore_registry(
            self.registry, doc, output_factory=self._restored_output,
            tcp_sink=self._park_tcp_record)
        for p in paths:
            sess = self.registry.find(p) if p else None
            if sess is not None and (not sess.trace_nodes
                                     or sess.trace_nodes[-1]
                                     != self.config.server_id):
                sess.trace_nodes.append(self.config.server_id)
        if n_out:
            self._adopt_restored_outputs(paths=paths, exclude_ids=pre)
        self._wake()
        return n_sess, n_out

    def _on_pull_failure(self, path: str, injected: bool) -> None:
        """A cluster pull's failure is counted; only an injected one is
        charged to the path's rung (a real one is the network's, and the
        stream stays on the card), never to its session."""
        self.pull_errors += 1
        if not injected:
            return
        self.pull_errors_injected += 1
        if self.ladder is not None:
            self.ladder.note_device_error(path, reason="pull_errors")

    def _cluster_fence_lost(self, path: str) -> None:
        """A newer owner fenced this node out of ``path``: stop serving it
        here.  Its pusher connections close (the source re-pushes to the
        new owner), its restored stand-ins go and its session is
        removed."""
        from ..relay.pull import _spawn_cleanup
        sess = self.registry.find(path)
        if sess is None:
            return
        for sub in [s for s in self._restored_subs if s.path == sess.path]:
            self._restored_subs.remove(sub)
            self.rtsp.drop_player_output(sub, sub.output)
        for conn in [c for c in list(self.rtsp.connections)
                     if c.is_pusher and c.path == sess.path]:
            try:
                conn.writer.close()
            except Exception:
                pass
            _spawn_cleanup(conn.close())
        if self.registry.find(path) is sess:
            self.registry.remove(path)

    async def _cluster_describe(self, path: str):
        """The DESCRIBE fallback in a cluster: a path another live node
        owns is served here through a pull."""
        if self.cluster is None:
            return None
        try:
            return await self.cluster.describe(path)
        except Exception as e:
            self.rtsp.log_error(f"cluster describe: {e!r}")
            return None

    def _peer_trace_gate(self, node_id: str, client_ip: str) -> bool:
        """An ``X-Trace-Id`` is adopted only from a request that names a
        live-leased node in ``X-Cluster-Node`` and comes from that node's
        lease address (node ids are public; the address binds the claim
        to the peer's socket)."""
        if not node_id or self.cluster is None:
            return False
        meta = self.cluster.last_nodes.get(node_id)
        return isinstance(meta, dict) and meta.get("ip") == client_ip

    def _admission_verdict(self, path: str, client_key: str):
        """Overload admission: None admits; ``("redirect", url)`` sends
        305 to the placement's edge with headroom, ``("refuse", None)``
        453.  It reads the last tick's load sample and node snapshot (a
        SETUP never waits on Redis); ``overload_spoof`` forces the
        verdict under a fault plan.  Every refusal is counted and an
        event."""
        lt = self.load_tracker
        if lt is None:
            return None
        hw = self.config.cluster_admission_high_water
        over = lt.last_util >= hw
        if not over and INJECTOR.active:
            over = INJECTOR.overload_spoof()
        if not over:
            return None
        target = url = None
        cl = self.cluster
        if cl is not None and cl.last_nodes:
            target = cl.placement.edge_for(
                path, cl.last_nodes, client_key=client_key,
                exclude=(cl.config.node_id,), high_water=hw)
            if target is not None:
                meta = cl.last_nodes.get(target) or {}
                ip, port = meta.get("ip"), meta.get("rtsp")
                if ip and port:
                    p = path if path.startswith("/") else "/" + path
                    url = f"rtsp://{ip}:{int(port)}{p}"
        action = "redirect" if url else "refuse"
        obs.CLUSTER_ADMISSION_REFUSED.inc(action=action)
        obs.EVENTS.emit("cluster.refuse", level="warn", stream=path,
                        action=action, util=round(lt.last_util, 3),
                        target=target)
        return (action, url)

    def _ensure_dvr_fetch_pool(self):
        """The helper threads peer REST GETs run on."""
        if self._dvr_fetch_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._dvr_fetch_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="peer-fetch")
        return self._dvr_fetch_pool

    def _peer_http_get(self, host: str, port: int,
                       target: str) -> bytes | None:
        """One peer REST GET, on a helper thread, with this node's REST
        credentials (a cluster shares its config); None on any non-200 or
        network failure."""
        import base64
        import http.client
        headers = {}
        if self.config.auth_enabled:
            cred = (f"{self.config.rest_username}:"
                    f"{self.config.rest_password}").encode()
            headers["Authorization"] = \
                "Basic " + base64.b64encode(cred).decode()
        try:
            conn = http.client.HTTPConnection(host, port, timeout=2.0)
            try:
                conn.request("GET", target, headers=headers)
                resp = conn.getresponse()
                if resp.status != 200:
                    return None
                return resp.read()
            finally:
                conn.close()
        except OSError:
            return None

    def _park_tcp_record(self, path: str, track_id, rec: dict) -> None:
        """The restore's sink of ``kind=tcp`` records: parked until the
        player re-attaches.  A record without a session id can never be
        matched and is counted an orphan at once."""
        sid = rec.get("session_id")
        if not sid:
            obs.RESILIENCE_CKPT_TCP_ORPHANS.inc()
            obs.EVENTS.emit("ckpt.tcp_orphan", stream=path or "?",
                            reason="no_session_id")
            return
        self._pending_tcp[(path, track_id, sid)] = (rec, time.monotonic())

    def claim_tcp_restore(self, path: str, track_id, sid: str):
        """The SETUP re-attach hook: the parked record of (path, track,
        old session id), removed from the park, or None."""
        ent = self._pending_tcp.pop((path, track_id, sid), None)
        return ent[0] if ent is not None else None

    def _sweep_pending_tcp(self) -> None:
        """Discard the parked TCP records no player claimed within the
        RTSP timeout, each counted an orphan."""
        now = time.monotonic()
        for key in [k for k, (_r, t0) in self._pending_tcp.items()
                    if now - t0 > self.config.rtsp_timeout_sec]:
            del self._pending_tcp[key]
            obs.RESILIENCE_CKPT_TCP_ORPHANS.inc()
            obs.EVENTS.emit("ckpt.tcp_orphan", stream=key[0],
                            reason="timeout", track=key[1])

    def _sweep_restored(self) -> None:
        """Remove the restored subscribers whose player has not proved
        itself by RTCP for ``rtsp_timeout_sec`` (the clock a live UDP
        player's connection is held to), or whose session went away."""
        self._sweep_pending_tcp()
        now = time.monotonic()
        for sub in list(self._restored_subs):
            stale = now - sub.last_activity > self.config.rtsp_timeout_sec
            gone = self.registry.find(sub.path) is not sub.relay
            if not (stale or gone):
                continue
            self._restored_subs.remove(sub)
            if not gone:
                sub.stream.remove_output(sub.output)
            self.rtsp.drop_player_output(sub, sub.output)

    async def stop(self) -> None:
        self._running = False
        if self.checkpoint is not None:
            # the last snapshot, while the registry is whole: a watchdog
            # relaunch resumes from the very last state
            try:
                self._write_checkpoint()
            except Exception as e:
                self.rtsp.log_error(f"checkpoint: {e!r}")
        if self._armed_faults:
            INJECTOR.disarm()
            self._armed_faults = False
        await self._stop_cluster()
        if self._status_task is not None:
            self._status_task.cancel()
            try:
                await self._status_task
            except asyncio.CancelledError:
                pass
            self._status_task = None
        if self._pump_task is not None:
            self._pump_event.set()
            await self._pump_task
            self._pump_task = None
        self.rtsp.modules.run_shutdown(self)
        self.transcodes.stop_all()
        # every in-flight recording finalizes while its session exists
        self.recordings.stop_all()
        if self._pull_sweep is not None:
            await self._pull_sweep
        await self.pulls.stop_all()
        self.relay_source.close_all()
        if self.dvr is not None:
            self.dvr.close()            # every armed asset finalizes
            self.rtsp.dvr = None
        if self.storage is not None:
            self.storage.close()        # the stores in flight finish
            self._storage_fetches.clear()
        await self.rest.stop()
        await self.rtsp.stop()
        for log in (self.rtsp.access_log, self.rtsp.error_log):
            if log is not None:
                log.log.close()
        if self.vod_pacer is not None:
            self.rtsp.vod_pacer = None
            self.vod_pacer.close()
            self.vod_cache.close()
        if self._dvr_fetch_pool is not None:
            self._dvr_fetch_pool.shutdown(wait=False)
            self._dvr_fetch_pool = None
        self.megabatch.drain()

    def _wake(self) -> None:
        if self._wake_ns is None:
            self._wake_ns = time.perf_counter_ns()
        self._pump_event.set()

    def _on_ingest(self, _path: str) -> None:
        """A pulled or broadcast media packet went into its ring."""
        self.rtsp.packets_in += 1
        self._wake()

    def _apply_surface_config(self, cfg: ServerConfig) -> None:
        """RTSP auth and the logs as the config says, made again when an
        ``update`` changed their keys (a new auth forgets its nonces)."""
        keys = (cfg.rtsp_auth_enabled, cfg.users_file, cfg.auth_scheme,
                cfg.log_folder, cfg.access_log_enabled,
                cfg.error_log_verbosity)
        if keys == self._surface_keys:
            return
        self._surface_keys = keys
        self.rtsp.auth = auth_from_config(cfg)
        for log in (self.rtsp.access_log, self.rtsp.error_log):
            if log is not None:
                log.log.close()
        # both logs only with access logging on, as the reference (a
        # connection's error is on stderr either way)
        self.rtsp.access_log = self.rtsp.error_log = None
        if cfg.access_log_enabled:
            self.rtsp.access_log = AccessLog(
                os.path.join(cfg.log_folder, "access.log"))
            self.rtsp.error_log = ErrorLog(
                os.path.join(cfg.log_folder, "error.log"),
                verbosity=cfg.error_log_verbosity)

    def request_restart(self) -> None:
        """REST ``restart``: the CLI's main loop stops the server and exits
        with ``supervisor.EXIT_RESTART``, and the watchdog relaunches."""
        self.restart_event.set()

    async def _rtsp_port_http_get(self, conn, target: str,
                                  headers: dict) -> bool:
        """A plain HTTP GET on the RTSP port: an icy MP3 stream or an
        ``.m3u`` playlist."""
        path = target.split("?")[0]
        if path.lower().endswith(".mp3"):
            await self.mp3.stream(conn.writer, path, headers)
            return True
        if path.lower().endswith(".m3u"):
            # a directory scan and an ID3 probe a file: off the loop
            pl = await asyncio.to_thread(self.mp3.playlist, path)
            if pl is not None:
                body = pl.encode()
                conn.writer.write(
                    b"HTTP/1.0 200 OK\r\n"
                    b"Content-Type: audio/x-mpegurl\r\n"
                    b"Content-Length: " + str(len(body)).encode()
                    + b"\r\n\r\n" + body)
                return True
        if path in ("/", "/stats"):
            html = self.rest.webstats_html().encode()
            conn.writer.write(
                b"HTTP/1.0 200 OK\r\nContent-Type: text/html\r\n"
                b"Content-Length: " + str(len(html)).encode() + b"\r\n\r\n"
                + html)
            return True
        return False

    # ------------------------------------------------------------- queries
    def _url(self, path: str) -> str:
        return (f"rtsp://{self.config.wan_ip}:"
                f"{self.rtsp.port or self.config.rtsp_port}{path}")

    def server_info(self) -> dict:
        """REST ``getserverinfo``: the reference's keys, read from the
        status monitor's pure snapshot (rates from its last tick)."""
        d = self.status.snapshot()
        info = {
            "ServerName": "easydarwin-tpu",
            "Version": "0.1.0",
            "UpTimeSec": str(d["uptime_sec"]),
            "RTSPPort": str(self.rtsp.port or self.config.rtsp_port),
            "ServicePort": str(self.rest.port or self.config.service_port),
            "Connections": str(d["rtsp_connections"]),
            "PushSessions": str(d["push_sessions"]),
            "Requests": str(d["requests"]),
            "PacketsIn": str(d["packets_in"]),
            "PacketsOut": str(d["packets_out"]),
            "InRatePps": str(d["in_rate"]),
            "OutRatePps": str(d["out_rate"]),
            "IngestToWireP99Ms": str(d["ingest_to_wire_p99_ms"]),
            "TpuFanout": "1",
            "LedgerTopWaitClass": str(d.get("ledger_top_wait_class", "")),
            "LedgerLastWakeMs": str(d.get("ledger_last_wake_ms", 0.0)),
        }
        if self.megabatch_mesh is not None:
            info.update(mesh_summary(self.megabatch_mesh))
            info["MeshShardedPasses"] = str(self.megabatch.sharded_passes)
        return info

    def live_sessions(self) -> list[dict]:
        """REST ``getrtsplivesessions``: every relay session (pushed,
        pulled or broadcast)."""
        return [{"Path": sess.path, "Url": self._url(sess.path),
                 "Outputs": str(sess.num_outputs),
                 "AgeSec": str((now_ms() - sess.created_ms) // 1000),
                 "Streams": sess.stats()["streams"]}
                for sess in self.registry.sessions.values()]

    def device_stream_url(self, device: str) -> str | None:
        name = device.strip("/")
        for cand in (f"/{name}", f"/live/{name}"):
            if self.registry.find(cand) is not None:
                return self._url(cand)
        return None

    def _housekeep_surface(self) -> None:
        """The once-a-second part of the server surface: the packet rates
        (the status monitor's tick, unless its own loop runs), broadcasts
        without players, and pulls whose upstream ended."""
        if self._status_task is None:
            self.status.tick()
        self.relay_source.sweep()
        if self.pulls.has_dead() and (self._pull_sweep is None
                                      or self._pull_sweep.done()):
            self._pull_sweep = asyncio.create_task(self.pulls.sweep())
        if self.presence is not None:
            # the records' sync awaits Redis: a task of its own, never
            # the pump's wake
            self.presence.set_load(sum(
                s.num_outputs for s in self.registry.sessions.values()))
            if self._presence_sync is None or self._presence_sync.done():
                self._presence_sync = asyncio.create_task(
                    self._sync_presence())

    async def _sync_presence(self) -> None:
        try:
            await self.presence.sync_streams(self.registry.paths())
        except Exception:
            pass                        # Redis gone: the next tick retries

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
        stable order, then ``vod_pairs`` (the live ones come first: the
        ladder rules them); engines of streams that went away are
        dropped."""
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
        """Count an error the pump caught and keep its traceback (stderr
        and the error log)."""
        self.pump_errors += 1
        traceback.print_exc(file=sys.stderr)
        self.rtsp.log_error(f"pump: {traceback.format_exc(limit=4)}")

    def reflect_all(self) -> int:
        """One pump wake of the live relay; returns packets written.  One
        stream's error is counted and the wake goes on with the next; a
        failed ``begin_wake`` serves the wake's streams one by one.  Each
        live stream takes the rung its ladder gives it this wake."""
        t = now_ms()
        self.wakes += 1
        wake_ns, self._wake_ns = self._wake_ns, None
        led = obs.LEDGER
        if wake_ns is not None:
            # ingest set the event at wake_ns: the loop's delay to this
            # pass, which no phase of the pass sees
            obs.PROFILER.observe("wake_to_pass", "pump",
                                 time.perf_counter_ns() - wake_ns)
        # one ledger record a wake, closed after the once-a-second block
        led.begin_wake(wake_ns)
        led_on = led.enabled
        vod_pairs = []
        if self.vod_pacer is not None and self.vod_pacer.sessions:
            u = led.unit_start()
            try:
                vod_pairs = self.vod_pacer.tick(t)
            except Exception:
                self.vod_errors += 1
                traceback.print_exc(file=sys.stderr)
            led.unit_end(u, "vod_fill", items=max(len(vod_pairs), 1))
        if self.dvr is not None and self.dvr._armed:
            u = led.unit_start()
            try:
                self.dvr.tick(t)
            except Exception:
                self.dvr.spill_errors += 1
                traceback.print_exc(file=sys.stderr)
            led.unit_end(u, "dvr_spill")
        pairs = self._pairs(vod_pairs)
        # each live stream's rung this wake (file streams: the megabatch's)
        lad = self.ladder
        live = len(pairs) - len(vod_pairs)
        modes = [LEVEL_FULL] * len(pairs)
        if lad is not None:
            for i in range(live):
                modes[i] = lad.engine_mode(pairs[i][0].session_path)
        mega = [p for p, m in zip(pairs, modes) if m == LEVEL_FULL]
        mega_paths = [pairs[i][0].session_path for i in range(live)
                      if modes[i] == LEVEL_FULL]
        engaged = len(mega) >= MEGABATCH_MIN_STREAMS
        for _stream, eng in pairs:
            eng.megabatch_owned = False
        u = led.unit_start()
        if engaged:
            try:
                self.megabatch.begin_wake(mega, t)
                self.dvr_megabatch_streams += sum(
                    1 for s, _e in mega
                    if getattr(s, "audience_tier", None) == DVR_TIER)
            except Exception as e:
                if self._device_error(e):
                    lad.note_scheduler_error(mega_paths)
                for _stream, eng in mega:
                    eng.megabatch_owned = False
                engaged = False
        if not engaged:
            # too few streams to coalesce (or the scheduler failed): each
            # engine runs its own device ring, and the scheduler keeps
            # harvesting what it has out
            try:
                self.megabatch.idle_wake()
            except Exception:
                self._pump_error()
        led.unit_end(u, "megabatch", items=max(len(pairs), 1))
        # one ledger unit for every stream's step; the slowest stream's
        # trace id rides the record
        lu = led.unit_start()
        worst_ns, worst_trace = -1, None
        sent = 0
        for i, (stream, eng) in enumerate(pairs):
            s0 = time.perf_counter_ns() if led_on else 0
            stalls = stream.stats.stalls
            # the device rungs step the engine; the cpu and shed rungs
            # (and a retry's backoff) serve by the host scalar path
            device = modes[i] <= LEVEL_DEVICE
            path = stream.session_path if i < live and lad is not None \
                else None
            try:
                if device:
                    sent += eng.step(stream, t)
                    if path is not None:
                        lad.note_device_ok(path)
                else:
                    self.host_steps += 1
                    sent += stream.reflect(t)
            except Exception as e:
                # only the engine's injected device faults are charged to
                # the ladder (a broken output's send is not device health)
                if device and eng.device_error:
                    if self._device_error(e) and path is not None:
                        lad.note_device_error(path)
                else:
                    self._pump_error()
            for out in list(stream.tickable_outputs):
                try:
                    self._tick(out, t)
                except Exception:
                    self._pump_error()
            # the wheel's hint: a due release of a stream that did not
            # stall may be armed at 1 ms; a stalled one's may not (a time
            # wake cannot unblock a full socket)
            stream.last_pass_stalled = stream.stats.stalls > stalls
            if led_on:
                el = time.perf_counter_ns() - s0
                if el > worst_ns:
                    worst_ns, worst_trace = el, stream.trace_id
        led.unit_end(lu, "live_relay", items=max(len(pairs), 1),
                     trace_id=worst_trace)
        self.packets_out += sent
        if engaged:
            u = led.unit_start()
            try:
                self.megabatch.end_wake(mega, t)
            except Exception as e:
                if self._device_error(e):
                    lad.note_scheduler_error(mega_paths)
            led.unit_end(u, "megabatch", items=len(mega))
        return sent

    def _device_error(self, e: Exception) -> bool:
        """Counts an exception of the device path.  True, to charge the
        ladder, only for an injected one (counted apart, without its
        traceback) on a server with a ladder; a real one is a pump error
        and moves no rung."""
        self.device_errors += 1
        if not isinstance(e, InjectedFault):
            self._pump_error()
            return False
        self.device_errors_injected += 1
        return self.ladder is not None

    def _tick(self, out, t: int) -> None:
        """One reliable-UDP player's resend sweep."""
        expired = out.resender.expired
        self.reliable_resends += out.tick(t)
        self.reliable_giveups += out.resender.expired - expired
        self.reliable_rto_ms_max = max(self.reliable_rto_ms_max,
                                       out.tracker.rto_ms)

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

    def _schedule_stream_deadlines(self, t: int) -> None:
        """Arm each live stream's next deadline on the wheel.  ``t`` must
        be the time the wheel was last advanced to, so relative deadlines
        land on the right tick; a stream that keeps an earlier or equal
        timer armed keeps it."""
        wheel, sched = self._wheel, self._wheel_sched
        for sess in list(self.registry.sessions.values()):
            for stream in sess.streams.values():
                d = stream.next_deadline_ms(
                    t, allow_due=not stream.last_pass_stalled)
                if d < 0:
                    continue
                key = id(stream)
                cur = sched.get(key)
                due = t + d
                if cur is not None and t <= cur[1] <= due:
                    continue
                if cur is not None:
                    wheel.cancel(cur[0])
                sched[key] = (wheel.schedule(d, key), due)

    async def _pump_loop(self) -> None:
        interval = self.config.reflect_interval_ms / 1000.0
        last_maint = 0.0
        wheel = self._wheel
        while self._running:
            timeout = interval
            if wheel.pending:
                nd = wheel.next_deadline(now_ms())
                if nd >= 0:
                    timeout = min(interval, max(nd, 1) / 1000.0)
            try:
                await asyncio.wait_for(self._pump_event.wait(), timeout)
                self.event_wakes += 1
            except asyncio.TimeoutError:
                self.time_wakes += 1
                self.wheel_wakes += timeout < interval
            self._pump_event.clear()
            try:
                t0 = time.perf_counter()
                if self.reflect_all():
                    ms = (time.perf_counter() - t0) * 1e3
                    if self.wake_ms_first is None:
                        self.wake_ms_first = ms
                    self.wake_ms.append(ms)
                # advance and schedule on the SAME clock sample, or timers
                # fire early by the pass's length
                t1 = time.perf_counter()
                t = now_ms()
                for key in wheel.advance(t):
                    self._wheel_sched.pop(key, None)
                self._schedule_stream_deadlines(t)
                self.schedule_ms.append((time.perf_counter() - t1) * 1e3)
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
                self._housekeep_surface()
                if self.storage is not None \
                        and now >= self._storage_scrub_due:
                    self._storage_scrub_due = (
                        now + self.config.storage_scrub_interval_sec)
                    self.storage.scrub_async()
                self._observe_second()
                self._resilience_second()
            # the wake's ledger record closes after the once-a-second
            # block: its duties ran on the same wake
            obs.LEDGER.end_wake()
        wheel.close()

    def _resilience_second(self) -> None:
        """The pump's once-a-second resilience duties: the ladder's tick
        and shed, the checkpoint's write when due, and the sweep of
        restored subscribers and parked TCP records; one that raises is
        logged and the others run."""
        if self.ladder is not None:
            try:
                self._ladder_maintenance()
            except Exception as e:
                self.rtsp.log_error(f"ladder tick: {e!r}")
        if self.checkpoint is not None:
            u = obs.LEDGER.unit_start()
            try:
                if self.checkpoint.maybe_write(self.registry) \
                        and self._vod_ckpt_path is not None:
                    self._write_vod_cache_meta()
            except Exception as e:
                self.rtsp.log_error(f"checkpoint: {e!r}")
            obs.LEDGER.unit_end(u, "checkpoint")
        try:
            self._sweep_restored()
        except Exception as e:
            self.rtsp.log_error(f"restored sweep: {e!r}")

    def _ladder_maintenance(self) -> None:
        """The ladder's tick over every session's stalls and the SLO
        watchdog's state, then the shed: the newest subscriber of each
        shed-rung session's streams, one a session a tick."""
        stalls = {sess.path: sum(st.stats.stalls
                                 for st in sess.streams.values())
                  for sess in self.registry.sessions.values()}
        slo_status = offender = None
        if self.config.slo_enabled:
            slo_status = self.slo.status()
            offender = obs.PROFILER.top_offender()
        self.ladder.tick(stalls, slo_status=slo_status, offender=offender)
        for sess in list(self.registry.sessions.values()):
            if self.ladder.level(sess.path) < LEVEL_SHED:
                continue
            for stream in sess.streams.values():
                out = self.ladder.shed_candidate(stream)
                if out is not None and stream.remove_output(out):
                    obs.RESILIENCE_SHED_OUTPUTS.inc()
                    obs.EVENTS.emit(
                        "ladder.shed", level="warn", stream=sess.path,
                        trace_id=sess.trace_id,
                        outputs=stream.num_outputs)
                    break

    def _observe_second(self) -> None:
        """The pump's once-a-second ``obs`` duties: the SLO watchdog, each
        relaying stream's freshness and the audience store's tick; one
        that raises is logged and the others run."""
        duties = [("freshness", lambda: obs_fleet.observe_freshness(self)),
                  ("audience tick", obs.AUDIENCE.tick)]
        if self.config.slo_enabled:
            duties.insert(0, ("slo tick", self.slo.tick))
        for name, fn in duties:
            try:
                fn()
            except Exception as e:
                self.rtsp.log_error(f"{name}: {e!r}")

    async def _status_loop(self) -> None:
        """The console columns every ``stats_interval_sec`` (stderr) and
        the status file every ``status_file_interval_sec``, from one tick
        of the status monitor a round."""
        cfg = self.config
        enabled = [i for i in (cfg.stats_interval_sec,
                               cfg.status_file_interval_sec
                               if cfg.status_file_path else 0) if i]
        interval = min(enabled) if enabled else 1
        last_console = last_file = 0.0
        while self._running:
            await asyncio.sleep(interval)
            snap = self.status.tick()
            now = time.monotonic()
            if (cfg.stats_interval_sec and now - last_console
                    >= cfg.stats_interval_sec - interval / 2):
                last_console = now
                if self.status.needs_header():
                    print(self.status.header_line(), file=sys.stderr)
                print(self.status.console_line(snap), file=sys.stderr,
                      flush=True)
            if (cfg.status_file_path and now - last_file
                    >= cfg.status_file_interval_sec - interval / 2):
                last_file = now
                try:
                    self.status.write_file(cfg.status_file_path, snap)
                except OSError:
                    pass

    def resilience_stats(self) -> dict:
        """The device errors the pump caught and the cluster pull's
        failures (and of each the injected), the live stream passes
        served on the host, the faults injected by site, the ladder's transitions and each
        stream's rung, and the checkpoint's writes and restore."""
        lad = self.ladder
        ckpt = self.checkpoint
        return {
            "device_errors": self.device_errors,
            "device_errors_injected": self.device_errors_injected,
            "pull_errors": self.pull_errors,
            "pull_errors_injected": self.pull_errors_injected,
            "host_steps": self.host_steps,
            "faults": INJECTOR.counts() if INJECTOR.plan is not None else {},
            "ladder": None if lad is None else {
                "degrades": lad.degrades, "recovers": lad.recovers,
                "worst_level": lad.worst_level(), "streams": lad.status()},
            "checkpoint": None if ckpt is None else {
                "writes": ckpt.writes, "restores": ckpt.restores,
                "restored_sessions": self.restored[0],
                "restored_outputs": self.restored[1],
                "restored_subscribers": len(self._restored_subs),
                "parked_tcp": len(self._pending_tcp)},
        }

    def cluster_stats(self) -> dict | None:
        """The cluster service's status (its lease token, claims, pulls,
        migrations, ticks and last load sample) and the capacity score it
        publishes; the last of them once it stopped; None without one."""
        if self.cluster is None:
            return self._cluster_final
        st = self.cluster.status()
        lt = self.load_tracker
        st["capacity_pps"] = None if lt is None else lt.capacity_pps
        st["restored_subscribers"] = len(self._restored_subs)
        return st

    def surface_stats(self) -> dict:
        """The server surface's counters: tunnels, the per-IP cap, RTSP
        and REST auth refusals, the logs' lines and rolls, icy streams,
        pulls and broadcasts (each pull's own figures: REST
        ``getpullrelays``)."""
        rtsp = self.rtsp
        return {
            "requests": rtsp.requests,
            "tunnels": dict(rtsp.tunnel_counts),
            "per_ip_refused": rtsp.per_ip_refused,
            "rtsp_auth_refused": rtsp.auth_refused,
            "rest_refused": dict(self.rest.refused),
            "access_log": (rtsp.access_log.log.stats()
                           if rtsp.access_log is not None else None),
            "error_log": (rtsp.error_log.log.stats()
                          if rtsp.error_log is not None else None),
            "mp3": {"streams": self.mp3.streams_served,
                    "bytes": self.mp3.bytes_served},
            "pulls": self.pulls.stats(),
            "broadcasts": dict(self.relay_source.counts),
        }

    def stats(self) -> dict:
        engines = {k: v + sum(getattr(e, k) for e in self._engines.values())
                   for k, v in self._retired.items()}
        # the batch-header rung's device leg, host ms a pass
        passes = max(engines["batch_passes"], 1)
        for leg in ("stage", "kernel"):
            engines[f"batch_{leg}_ms_per_pass"] = \
                engines.pop(f"batch_{leg}_ns") / passes / 1e6
        # the loop rung, host µs a packet sent
        engines["loop_us_per_packet"] = (engines.pop("loop_ns") / 1e3
                                         / max(engines["loop_sent"], 1))
        wake = sorted(self.wake_ms)
        sched = sorted(self.schedule_ms)
        return {"wakes": self.wakes, "packets_in": self.rtsp.packets_in,
                "packets_out": self.packets_out,
                "pump_errors": self.pump_errors,
                "sessions": len(self.registry.sessions),
                **engines,
                "wake_ms_p50": wake[len(wake) // 2] if wake else None,
                "wake_ms_p99": wake[len(wake) * 99 // 100] if wake else None,
                "wake_ms_max": wake[-1] if wake else None,
                "wake_ms_first": self.wake_ms_first,
                "pump": {"time_wakes": self.time_wakes,
                         "wheel_wakes": self.wheel_wakes,
                         "event_wakes": self.event_wakes,
                         "schedule_ms_p50":
                         sched[len(sched) // 2] if sched else None,
                         "schedule_ms_max": sched[-1] if sched else None},
                "native_loaded": self.native_loaded,
                "ingest": self.ingest_stats(),
                "egress": self.egress_stats(),
                "rtcp": {"in": self.rtsp.rtcp_in, **self.rtsp.rtcp_counts,
                         **{f"socket_{k}": v for k, v
                            in self.rtsp.rtcp_socket_stats().items()}},
                "fec": self.fec_stats(),
                "reliable": {"resends": self.reliable_resends,
                             "acks": self.rtsp.reliable_acks,
                             "giveups": self.reliable_giveups,
                             "rto_ms_max": self.reliable_rto_ms_max},
                "megabatch": self.megabatch.stats(),
                "mesh": (None if self.megabatch_mesh is None else
                         {**mesh_summary(self.megabatch_mesh),
                          "MeshShardedPasses":
                          str(self.megabatch.sharded_passes)}),
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
                "surface": self.surface_stats(),
                "record_orphans": self.record_orphans,
                "cpu_s": time.process_time() - self._cpu0,
                "wall_s": time.monotonic() - self._wall0,
                "resilience": self.resilience_stats(),
                "cluster": self.cluster_stats(),
                "kernel_launches": dict(kernel_lib.LAUNCHES),
                "copied_bytes": dict(staging.COPIED)}
