"""The metric inventory: every family this server exports, in one place.

Central registration (instead of per-module scatter) guarantees the
``/metrics`` exposition, the admin ``server/metrics`` tree and
``tools/metrics_lint.py`` all see the complete, stable family set no
matter which subsystems have been exercised yet — a scrape taken one
second after boot already carries every family's HELP/TYPE header
(unlabeled families at value 0; labeled children appear on first
observation).

Naming convention: snake_case; counters end ``_total``; histograms and
unit-carrying gauges end in their unit (``_seconds``, ``_bytes``,
``_ratio``).  ``tools/metrics_lint.py`` enforces this and is run from
the test suite.
"""

from __future__ import annotations

from .metrics import TIME_BUCKETS, Registry

#: the process-wide default registry (``/metrics`` serves exactly this)
REGISTRY = Registry()

# ------------------------------------------------------------- relay latency
#: packet bytes are log-spaced 2^k; device pass times are sub-ms — the
#: shared TIME_BUCKETS ladder covers 100 µs…900 s for both
RELAY_INGEST_TO_WIRE = REGISTRY.histogram(
    "relay_ingest_to_wire_seconds",
    "In-server ingest(arrival stamp at push_rtp)->wire latency per relayed "
    "packet, by egress engine (native sendmmsg/GSO, device batch-header, "
    "scalar oracle)",
    labels=("engine",), buckets=TIME_BUCKETS)

# ------------------------------------------------------- phase attribution
#: per-pass stage decomposition of the relay hot path (obs/profile.py):
#: label vocabulary is the CLOSED set obs.profile.PHASES / ENGINES —
#: tools/metrics_lint.py rejects any child outside it
RELAY_PHASE_SECONDS = REGISTRY.histogram(
    "relay_phase_seconds",
    "Duration of one named relay-pass phase (wake_to_pass queueing, h2d "
    "staging, fused device_step, d2h param fetch, egress_native wire "
    "scatter, rtcp_qos), by phase and engine — the always-on ingest->wire "
    "latency attribution layer",
    labels=("engine", "phase"), buckets=TIME_BUCKETS)
PROFILE_PHASE_DRIFT = REGISTRY.counter(
    "profile_phase_drift_total",
    "Passes whose summed phase durations disagreed with the bracketing "
    "pass total beyond tolerance (instrumentation covering different "
    "work than the pass timer — a profiler bug, not a server bug)")

# ------------------------------------------------------------- wake ledger
#: causal latency attribution for the pump wake loop (obs/ledger.py):
#: every unit of work a wake services carries a work class
#: from the CLOSED set obs.ledger.WORK_CLASSES — tools/metrics_lint.py
#: rejects any child outside it.  One wait/service observation per
#: class per wake (the per-wake worst, not per-packet), so a p99 here
#: reads as "the p99 WAKE's queueing delay for this class".
PUMP_WAIT_SECONDS = REGISTRY.histogram(
    "pump_wait_seconds",
    "Enqueue->start queueing delay of one work class inside a pump wake "
    "(time from the wake request / schedule-due stamp to the moment the "
    "class's unit actually started running), by work class",
    labels=("work_class",), buckets=TIME_BUCKETS)
PUMP_SERVICE_SECONDS = REGISTRY.histogram(
    "pump_service_seconds",
    "Self service time of one work class inside a pump wake (nested "
    "classes subtracted, so per-class figures sum to the wake duration "
    "instead of double-counting), by work class",
    labels=("work_class",), buckets=TIME_BUCKETS)
PUMP_DEFERRED_TOTAL = REGISTRY.counter(
    "pump_deferred_total",
    "Units a work class deferred or shed instead of servicing this wake "
    "(megabatch dispatch skipped at the in-flight cap, HLS requant AUs "
    "shed at the admission gate, ...), by work class",
    labels=("work_class",))

# -------------------------------------------------------------- SLO watchdog
SLO_VIOLATIONS = REGISTRY.counter(
    "slo_violations_total",
    "Multi-window burn-rate violations raised by the SLO watchdog, by "
    "objective", labels=("slo",))
SLO_BUDGET_REMAINING = REGISTRY.gauge(
    "slo_budget_remaining_ratio",
    "Fraction of the error budget left in the slow burn window per "
    "objective (1 = untouched, <= 0 = exhausted)", labels=("slo",))

# ------------------------------------------------------------ device engine
TPU_PASS_SECONDS = REGISTRY.histogram(
    "tpu_pass_seconds",
    "Duration of one relay engine pass, by stage (engine_step = full "
    "TpuFanoutEngine.step; pipeline_dispatch = RelayPipeline device "
    "dispatch; device_params = affine-param refresh fetch)",
    labels=("stage",), buckets=TIME_BUCKETS)
TPU_PASSES = REGISTRY.counter(
    "tpu_passes_total", "TpuFanoutEngine.step passes executed")
TPU_PACKETS_SENT = REGISTRY.counter(
    "tpu_packets_sent_total",
    "(packet, subscriber) sends completed by the TPU fan-out engine")
TPU_HEADERS_RENDERED = REGISTRY.counter(
    "tpu_headers_rendered_total",
    "Rewritten 12-byte RTP headers rendered by device batch steps")
TPU_H2D_BYTES = REGISTRY.counter(
    "tpu_h2d_bytes_total",
    "Host->device bytes staged (packet prefixes + metadata appended to "
    "the resident device ring, plus pipeline step inputs)")
TPU_D2H_BYTES = REGISTRY.counter(
    "tpu_d2h_bytes_total",
    "Device->host bytes fetched (affine egress params, header blocks)")
TPU_PARAM_REFRESHES = REGISTRY.counter(
    "tpu_param_refreshes_total",
    "Device affine-param recomputes (membership/rebase state changes)")

# -------------------------------------------------------- megabatch scheduler
# The cross-stream relay scheduler (relay/megabatch.py): one shape-bucketed
# stacked device pass per pump wake instead of one dispatch per stream.
MEGABATCH_PASSES = REGISTRY.counter(
    "megabatch_passes_total",
    "Stacked cross-stream device passes dispatched by the megabatch "
    "scheduler (one per shape bucket per pump wake)")
MEGABATCH_STREAMS = REGISTRY.counter(
    "megabatch_streams_total",
    "Streams coalesced into megabatch passes (streams_total / passes_total "
    "= mean streams per stacked pass)")
MEGABATCH_FALLBACK = REGISTRY.counter(
    "megabatch_fallback_total",
    "Per-stream device param queries taken while a stream was megabatch-"
    "owned (override missing or stale — the slow path the scheduler "
    "replaces in steady state)")
MEGABATCH_WIRE_MISMATCH = REGISTRY.counter(
    "megabatch_wire_mismatch_total",
    "Megabatch-computed affine egress params that disagreed with the host "
    "arithmetic oracle for the same rewrite state (the result is discarded "
    "and the stream falls back to per-stream stepping; any nonzero value "
    "is a device/host divergence bug)")
# Mesh dispatch: the stacked pass sharded over a (src)-axis
# device mesh.  The ``device`` label is the SHARD INDEX within the mesh
# ("0".."N-1"), never a backend device-id string — tools/metrics_lint.py
# bounds the cardinality (a full v5 pod slice is 256 chips; an id string
# like "TPU_v5litepod_..." would shard the family per hostname).  On a
# 1-device box (no mesh) these families stay at zero with no children.
MEGABATCH_DEVICE_PASSES = REGISTRY.counter(
    "megabatch_device_passes_total",
    "Stacked megabatch shard passes executed per mesh device (one per "
    "device per dispatched bucket that carried at least one real stream "
    "row for that shard)", labels=("device",))
MEGABATCH_DEVICE_STREAMS = REGISTRY.counter(
    "megabatch_device_streams_total",
    "Streams whose window rode each mesh device's shard of a stacked "
    "megabatch pass (streams/passes per device = shard occupancy; a "
    "skewed distribution means the stream->shard split is unbalanced)",
    labels=("device",))
MEGABATCH_DEVICE_PHASE_SECONDS = REGISTRY.histogram(
    "megabatch_device_phase_seconds",
    "Per-mesh-device phase durations of the sharded megabatch path: h2d "
    "= that shard's contiguous staging upload, device_step = the "
    "harvest-side wait for that shard's result to become ready, d2h = "
    "fetching that shard's packed params slice; device label is the "
    "shard index within the serving mesh",
    labels=("device", "phase"), buckets=TIME_BUCKETS)
STAGE_GATHER_BYTES = REGISTRY.counter(
    "stage_gather_bytes_total",
    "Prefix+length bytes packed into contiguous upload buffers by the "
    "native staging gather (csrc ed_stage_gather)")
STAGE_GATHER_BUSY_SECONDS = REGISTRY.counter(
    "stage_gather_busy_seconds_total",
    "Cumulative wall time spent inside the native staging gather "
    "(clock_gettime deltas in ed_stats; the native half of the "
    "stage_gather phase)")

# ------------------------------------------------------------ native egress
# Mirrored from the C data-plane's cumulative ed_stats snapshot by the
# collector native.py registers (see _EGRESS_FIELDS there).
EGRESS_SENDMMSG_CALLS = REGISTRY.counter(
    "egress_sendmmsg_calls_total",
    "sendmmsg(2) syscalls issued by the native egress (plain + GSO)")
EGRESS_SENDTO_CALLS = REGISTRY.counter(
    "egress_sendto_calls_total",
    "sendto(2) syscalls issued by the scalar-baseline egress")
EGRESS_PACKETS = REGISTRY.counter(
    "egress_packets_total",
    "Wire datagram-equivalents handed to the kernel by native egress")
EGRESS_BYTES = REGISTRY.counter(
    "egress_bytes_total",
    "Bytes-to-wire handed to the kernel by native egress")
EGRESS_GSO_SUPERS = REGISTRY.counter(
    "egress_gso_supers_total",
    "UDP_SEGMENT super-datagrams sent (multi-segment only)")
EGRESS_GSO_SEGMENTS = REGISTRY.counter(
    "egress_gso_segments_total",
    "Wire segments carried inside UDP_SEGMENT super-datagrams")
EGRESS_EAGAIN = REGISTRY.counter(
    "egress_eagain_total",
    "Native sends stopped early by EAGAIN/EWOULDBLOCK (flow control; "
    "callers keep bookmarks and replay)")
EGRESS_SEND_ERRORS = REGISTRY.counter(
    "egress_send_errors_total",
    "Native sends stopped by a hard per-datagram errno (skipped past)")
EGRESS_BUSY_SECONDS = REGISTRY.counter(
    "egress_busy_seconds_total",
    "Cumulative wall time spent inside the native egress entry points "
    "(clock_gettime deltas in ed_stats; the denominator for per-call "
    "egress cost and the native half of the egress_native phase)")

# --------------------------------------------------------- egress backends
# The boot-time probe ladder: io_uring → GSO/sendmmsg →
# scalar.  ``egress_backend_info`` is an info-style gauge — exactly one
# backend child reads 1 (the effective backend), the others 0 — so a
# forced-backend soak can assert what is actually serving the wire.
EGRESS_BACKEND_INFO = REGISTRY.gauge(
    "egress_backend_info",
    "The effective egress backend serving the shared UDP pair (1 = "
    "active, 0 = probed but not serving), by backend (io_uring / gso / "
    "scalar); the probe ladder's runtime verdict", labels=("backend",))
EGRESS_BACKEND_FALLBACKS = REGISTRY.counter(
    "egress_backend_fallbacks_total",
    "Backend probe/runtime failures that dropped egress one rung down "
    "the ladder (ENOSYS/seccomp EPERM/RLIMIT_MEMLOCK at boot, repeated "
    "send failures at runtime), by the backend fallen FROM; each carries "
    "one structured egress.backend_fallback event and is never counted "
    "as a hard send error", labels=("backend",))
IO_URING_SQE = REGISTRY.counter(
    "io_uring_sqe_total",
    "Submission queue entries queued by the io_uring egress/ingest "
    "backend (one per datagram op, per buffer recycle, per multishot "
    "re-arm)")
IO_URING_CQE = REGISTRY.counter(
    "io_uring_cqe_total",
    "Completion queue entries reaped by the io_uring backend "
    "(send/ingest completions plus zerocopy notifications)")
IO_URING_SUBMITS = REGISTRY.counter(
    "io_uring_submit_calls_total",
    "io_uring_enter(2) syscalls issued (sqe_total / submit_calls_total "
    "= the syscall batching factor; under SQPOLL steady-state pushes "
    "submit without entering at all)")
IO_URING_ZC_COMPLETIONS = REGISTRY.counter(
    "io_uring_zerocopy_completions_total",
    "Zerocopy send notifications reaped (the kernel released its "
    "reference to the registered send arena)")
IO_URING_ZC_COPIED = REGISTRY.counter(
    "io_uring_zerocopy_copied_total",
    "Zerocopy notifications reporting the kernel COPIED the payload "
    "anyway (expected on loopback and some NIC paths — counted so the "
    "zerocopy figure is honest, never hidden)")

# ------------------------------------------------------- TCP/HTTP delivery
# First-class stream-socket egress: interleaved-RTSP frames
# leave through the engine's framed writev/io_uring batches; HLS segment
# bodies leave through the same rung ladder.  ``backend``/``rung`` are
# CLOSED vocabularies (io_uring / writev / buffered) — ``buffered`` is
# the per-send asyncio fallback rung, counted so the totals are honest
# across the whole ladder.
TCP_EGRESS_PACKETS = REGISTRY.counter(
    "tcp_egress_packets_total",
    "Interleaved RTP packets framed and written to stream sockets, by "
    "serving backend rung (io_uring / writev / buffered)",
    labels=("backend",))
TCP_EGRESS_BYTES = REGISTRY.counter(
    "tcp_egress_bytes_total",
    "Bytes written to interleaved stream sockets (4-byte $-framing "
    "included), by serving backend rung", labels=("backend",))
TCP_EGRESS_BACKPRESSURE_SHEDS = REGISTRY.counter(
    "tcp_egress_backpressure_sheds_total",
    "Packets shed (whole AUs, forward to the newest keyframe) because a "
    "TCP reader's backlog crossed half the ring — frame-rate "
    "degradation instead of a blocked pump wake", labels=("backend",))
HLS_SEGMENT_EGRESS_BYTES = REGISTRY.counter(
    "hls_segment_egress_bytes_total",
    "HLS playlist/segment body bytes served, by egress rung (io_uring /"
    " writev / buffered); 304 short-circuits send no body and count "
    "nothing", labels=("rung",))

# ------------------------------------------------------------ native ingest
INGEST_RECVMMSG_CALLS = REGISTRY.counter(
    "ingest_recvmmsg_calls_total",
    "recvmmsg(2) syscalls issued by the native ring ingest")
INGEST_DATAGRAMS = REGISTRY.counter(
    "ingest_datagrams_total",
    "Datagrams admitted into packet rings by the native ingest")
INGEST_BYTES = REGISTRY.counter(
    "ingest_bytes_total", "Bytes admitted by the native ring ingest")
INGEST_OVERSIZE_DROPPED = REGISTRY.counter(
    "ingest_oversize_dropped_total",
    "Datagrams dropped at ingest because they exceed the ring slot")
INGEST_BUSY_SECONDS = REGISTRY.counter(
    "ingest_busy_seconds_total",
    "Cumulative wall time spent inside the native recvmmsg ring ingest "
    "(clock_gettime deltas in ed_stats)")

# ---------------------------------------------------------- requant ladder
# The HLS ABR requant ladder (hls/requant.py RequantLadder): slice-
# parallel entropy recode + shared-parse multi-rendition fan-out +
# device-overlapped transform.  The ``stage`` label vocabulary
# is the CLOSED ``hls.requant.REQUANT_STAGES`` set —
# tools/metrics_lint.py rejects any child outside it, and
# ``tools/soak.py --hls-ladder`` keys on these families.
REQUANT_AUS = REGISTRY.counter(
    "requant_aus_total",
    "Access units admitted into the requant ladder pipeline (each fans "
    "out to every rendition of its source's q-rung ladder)")
REQUANT_SLICES = REGISTRY.counter(
    "requant_slices_total",
    "Slice recode jobs completed by the ladder worker pool (one serial "
    "CAVLC/CABAC state machine per slice per rendition, slices of one "
    "AU fanned across workers)")
REQUANT_RENDITIONS = REGISTRY.counter(
    "requant_renditions_total",
    "Rendition access units emitted by the ladder (renditions_total / "
    "aus_total = mean ladder width actually served)")
REQUANT_SHED = REGISTRY.counter(
    "requant_shed_total",
    "Access units shed at ladder admission because the pipeline was at "
    "its in-flight bound (the rendition set degrades in frame rate "
    "together, never in latency)")
REQUANT_REASSEMBLY_MISMATCH = REGISTRY.counter(
    "requant_reassembly_mismatch_total",
    "Ladder AUs whose ordered per-AU reassembly finished with a missing "
    "or duplicate slice slot (the AU passes through unrequanted; any "
    "nonzero value is a pipeline bookkeeping bug, and soak fails on it)")
REQUANT_STAGE_SECONDS = REGISTRY.histogram(
    "requant_stage_seconds",
    "Duration of one requant-ladder pipeline stage (parse = shared "
    "entropy decode, entropy = fused native walk, transform_device = "
    "fused device requant dispatch+harvest, recode = per-rendition "
    "entropy re-encode, reassemble = ordered per-AU emit), by stage",
    labels=("stage",), buckets=TIME_BUCKETS)

# ------------------------------------------------------------ VOD cache
# The device-resident VOD segment cache + shared group pacer
# (vod/cache.py + vod/session.py).  tools/metrics_lint.py enforces this
# family set (lint_vod: exact labels, path value vocabulary closed to
# hot|cold) and tools/soak.py --vod keys on it.
VOD_CACHE_HITS = REGISTRY.counter(
    "vod_cache_hits_total",
    "Segment-cache window lookups served from a packed entry (the "
    "pacer's vectorized hot fill path)")
VOD_CACHE_MISSES = REGISTRY.counter(
    "vod_cache_misses_total",
    "Segment-cache window lookups that found no packed entry (the "
    "subscriber streams through the cold per-sample mmap path while a "
    "background fill packs the window)")
VOD_CACHE_EVICTIONS = REGISTRY.counter(
    "vod_cache_evictions_total",
    "Packed windows evicted by the byte-budgeted LRU (pinned windows — "
    "currently serving a pacer cursor — are never evicted)")
VOD_CACHE_BYTES = REGISTRY.gauge(
    "vod_cache_bytes",
    "Bytes currently held by the VOD segment cache (packed packet "
    "slots + pre-staged upload rows + HBM-resident copies)")
VOD_SESSIONS = REGISTRY.gauge(
    "vod_sessions_count",
    "Paced VOD sessions currently registered with the shared group "
    "pacer (hot engine-served sessions only; cold FileSession players "
    "are not pacer-owned)")
VOD_PACKETS = REGISTRY.counter(
    "vod_packets_total",
    "RTP packets staged into VOD subscriber rings by the group pacer, "
    "by serving path (hot = vectorized copy from a packed cache window, "
    "cold = per-sample mmap packetization on a cache miss)",
    labels=("path",))

# ------------------------------------------------------------ DVR spill
# The DVR / time-shift subsystem (dvr/).  Live ring windows
# spill to disk in the fixed-slot packed format; pause/rewind/catch-up
# is served by the VOD pacer against the spilled windows.
# tools/metrics_lint.py enforces this family set (lint_dvr: closed set,
# exact labels) and tools/soak.py --dvr keys on it.
DVR_WINDOWS_SPILLED = REGISTRY.counter(
    "dvr_windows_spilled_total",
    "Completed live ring windows snapshot into a per-asset spill file "
    "(fixed-slot rows + index record, the pack-at-record-time cost)")
DVR_SPILL_BYTES = REGISTRY.gauge(
    "dvr_spill_bytes",
    "Bytes currently retained across all DVR spill files (live window "
    "payloads + metadata, after retention eviction)")
DVR_TIMESHIFT_SESSIONS = REGISTRY.gauge(
    "dvr_timeshift_sessions_count",
    "Time-shift sessions currently served by the group pacer (live "
    "subscribers paused/rewound into the spill, plus finalized "
    "stream-to-VOD assets being replayed)")
DVR_CATCHUP_JOINS = REGISTRY.counter(
    "dvr_catchup_joins_total",
    "Time-shift sessions whose cursor reached the live ring head and "
    "rejoined live fan-out gapless (same ssrc, contiguous seq via the "
    "affine rewrite — the ring is the hot tail of one id space)")
DVR_RETENTION_EVICTIONS = REGISTRY.counter(
    "dvr_retention_evictions_total",
    "Spilled windows dropped by the per-asset byte/duration retention "
    "budget (oldest-first; the time-shift horizon moves forward)")

# ------------------------------------------------- erasure-coded storage
# The durable CDN-origin tier (storage/).  Finalized DVR/VOD
# assets shard into k data + m parity window shards striped across the
# fleet; parity is the GF(256) Vandermonde matmul (device, host-oracle
# checked) and a read missing <= m shards reconstructs via gf_solve.
# tools/metrics_lint.py enforces this family set (lint_storage: closed
# set, exact labels) and tools/soak.py --cluster keys on it.
STORAGE_SHARDS = REGISTRY.counter(
    "storage_shards_total",
    "Window shards materialized by the storage tier, by kind (data = "
    "the raw spill window blob, parity = one GF(256) Vandermonde row "
    "over the stripe's padded data blobs)", labels=("kind",))
STORAGE_RECONSTRUCTS = REGISTRY.counter(
    "storage_reconstructs_total",
    "Stripe reads that could not serve the data shard directly and ran "
    "the Gaussian gf_solve reconstruction over k survivors, by result "
    "(ok = byte-exact blob recovered, failed = > m shards missing or a "
    "singular coefficient subset — the read fails LOUDLY, never "
    "silently partial)", labels=("result",))
STORAGE_REPAIRS = REGISTRY.counter(
    "storage_repairs_total",
    "Shards re-materialized onto this node by the background repair "
    "tick after a holder loss (a re-keyed GF matmul / solve over "
    "survivors, not a byte copy), by kind", labels=("kind",))
STORAGE_REPAIR_BYTES = REGISTRY.counter(
    "storage_repair_bytes_total",
    "Bytes of shard payload re-materialized by the background repair "
    "tick (the repair-MB/s numerator bench/soak report)")
STORAGE_SCRUB_ERRORS = REGISTRY.counter(
    "storage_scrub_errors_total",
    "Local shards the background scrub found corrupt (manifest crc32 "
    "mismatch, or a parity shard that disagrees with the host GF "
    "oracle recomputed over locally-present data); the shard is "
    "quarantined and queued for repair — any nonzero value fails "
    "bench/soak")

# ------------------------------------------------------- reliability tier
# The lossy-WAN FEC + NACK/RTX tier (relay/fec.py).
# tools/metrics_lint.py enforces this family set (lint_fec: exact
# labels, the parity kind vocabulary closed to xor|rs) and
# tools/soak.py --lossy keys on it.
FEC_PARITY_PACKETS = REGISTRY.counter(
    "fec_parity_packets_total",
    "FEC parity packets emitted (RED/ULPFEC-shaped, one per parity row "
    "per window per subscriber), by parity kind (xor = GF(2) all-ones "
    "row, rs = GF(256) Reed-Solomon Vandermonde rows)",
    labels=("kind",))
FEC_RECOVERED = REGISTRY.counter(
    "fec_recovered_total",
    "Media packets reconstructed byte-exactly from FEC parity by the "
    "receiver model (in-process receivers — the lossy soak player, the "
    "bench — share this registry, so recovery is scrapeable)")
FEC_PARITY_ORACLE_MISMATCH = REGISTRY.counter(
    "fec_parity_oracle_mismatch_total",
    "Device-computed parity rows that disagreed with the host GF "
    "oracle for the same window (the device result is discarded and "
    "the stream latches onto host-computed parity; any nonzero value "
    "is a kernel/host divergence bug and fails bench/soak)")
FEC_SOLVE_SINGULAR = REGISTRY.counter(
    "fec_solve_singular_total",
    "gf_solve calls that hit a singular coefficient matrix and "
    "returned no solution, by caller (fec_receiver = the lossy-WAN "
    "recovery path retrying with another parity subset, storage = an "
    "erasure-coded stripe read that must fail loudly) — previously "
    "this was an unaccounted silent None", labels=("caller",))
FEC_OVERHEAD_RATIO = REGISTRY.gauge(
    "fec_overhead_ratio",
    "Current closed-loop FEC overhead (parity/media ratio, 0..0.30) "
    "per stream — the worst subscriber's rung, driven by RTCP RR "
    "fraction_lost with NADU buffer distress shifting recovery toward "
    "RTX instead", labels=("path", "track"))
RTX_SENT = REGISTRY.counter(
    "rtx_sent_total",
    "NACKed packets replayed from live ring bookmarks through the "
    "affine rewrite as RFC 4588-shaped RTX packets (OSN-prefixed, own "
    "seq space)")
RTX_GIVEUP = REGISTRY.counter(
    "rtx_giveup_total",
    "NACKed packets NOT replayed because the per-output RTX token "
    "bucket was exhausted (a black-holed client cannot amplify); "
    "give-ups charge the degradation ladder")

# ------------------------------------------------------------------- QoS
QOS_FRACTION_LOST = REGISTRY.gauge(
    "qos_fraction_lost_ratio",
    "Most recent RTCP receiver-report fraction-lost (0..1) per "
    "subscribed stream", labels=("path", "track"))
QOS_JITTER = REGISTRY.gauge(
    "qos_jitter_seconds",
    "Most recent RTCP receiver-report interarrival jitter per "
    "subscribed stream", labels=("path", "track"))
QOS_THINS = REGISTRY.counter(
    "qos_thins_total",
    "Quality-level increases (stream thinned) across all outputs")
QOS_THICKENS = REGISTRY.counter(
    "qos_thickens_total",
    "Quality-level decreases (stream thickened) across all outputs")

# ------------------------------------------------------------------- logs
LOG_LINES = REGISTRY.counter(
    "log_lines_total", "Lines written to rolling logs, by log and level",
    labels=("log", "level"))
LOG_ROLLS = REGISTRY.counter(
    "log_rolls_total", "Rolling-log roll events, by log", labels=("log",))

# -------------------------------------------------- structured events/flight
EVENTS_EMITTED = REGISTRY.counter(
    "events_emitted_total",
    "Structured event-log records emitted, by level", labels=("level",))
EVENTS_DROPPED = REGISTRY.counter(
    "events_dropped_total",
    "Structured event-log records evicted from the bounded ring before "
    "being read (ring overflow)")
EVENTS_INVALID = REGISTRY.counter(
    "events_invalid_total",
    "Structured events emitted with an undeclared name or missing a "
    "schema-required field (recorded anyway, flagged invalid)")
EVENTS_SINK_FAILURES = REGISTRY.counter(
    "events_sink_failures_total",
    "Exceptions raised by registered event sinks (the flight recorder); "
    "the record still lands in the main ring and the sink stays wired")
FLIGHT_DUMPS = REGISTRY.counter(
    "flight_dumps_total",
    "Per-session flight-recorder dumps written on abnormal teardown "
    "(timeout sweep, uncaught exception, hard protocol error)")
FLIGHT_DUMPS_DEDUPED = REGISTRY.counter(
    "flight_dumps_deduped_total",
    "Flight dumps skipped because another node already holds the same "
    "session's dump under a newer-or-equal fencing token (the "
    "migration dedupe guard — one black box per dead session, never a "
    "shadowing duplicate)")

# ---------------------------------------------------- fleet observability
# Cross-node federation (obs/fleet.py + cluster/service.py).
# Each node publishes a compact rollup into a TTL'd fenced Fleet:{node}
# record every heartbeat; any node's GET /api/v1/fleet aggregates the
# live topology.  tools/metrics_lint.py enforces this family set
# (lint_fleet: exact labels, tier vocabulary closed to FLEET_TIERS,
# digit-only hop labels) and tools/soak.py --composed keys on it.
FLEET_NODES_LIVE = REGISTRY.gauge(
    "fleet_nodes_live",
    "Cluster nodes with a live lease at the last fleet aggregation "
    "(dead nodes' rollups persist staleness-marked until their "
    "Fleet:{node} TTL expires)")
FLEET_STREAMS = REGISTRY.gauge(
    "fleet_streams_total",
    "Streams currently served across all LIVE nodes' fleet rollups, by "
    "serving tier (live = locally-sourced relays, pull = relay-tree "
    "edge pulls, vod = pacer-served file sessions, dvr = time-shift "
    "sessions, hls = segmenter outputs)", labels=("tier",))
FLEET_PUBLISHES = REGISTRY.counter(
    "fleet_publishes_total",
    "Fleet rollup records published into the fenced Fleet:{node} key "
    "(one per cluster heartbeat while the lease holds)")
RELAY_E2E_FRESHNESS = REGISTRY.histogram(
    "relay_e2e_freshness_seconds",
    "End-to-end staleness of each actively-relaying stream measured "
    "against the FIRST hop of its freshness chain (pusher ingest at "
    "the origin -> this node's wire), by chain length; hops=1 is a "
    "locally-sourced stream, hops>=2 a relay-tree edge reading the "
    "origin's stamp through the pull's freshness poll",
    labels=("hops",))

# ------------------------------------------------------------- resilience
# The fault-injection / degradation-ladder / checkpoint subsystem
# (easydarwin_tpu/resilience/).  tools/metrics_lint.py enforces this
# family set and tools/soak.py --chaos keys on it.
FAULT_INJECTED = REGISTRY.counter(
    "fault_injected_total",
    "Faults deliberately injected by the armed FaultPlan, by site "
    "(ingest drop/reorder/corrupt, native egress EAGAIN/ENOBUFS/latency, "
    "device-dispatch exceptions, stale params, slow-subscriber "
    "backpressure); nonzero only under chaos testing", labels=("site",))
RESILIENCE_LADDER_LEVEL = REGISTRY.gauge(
    "resilience_ladder_level",
    "Current degradation-ladder rung per stream (0 = megabatch full "
    "service, 1 = per-stream device, 2 = CPU oracle, 3 = shedding the "
    "newest subscribers); anything above 0 means degraded service",
    labels=("stream",))
RESILIENCE_TRANSITIONS = REGISTRY.counter(
    "resilience_transitions_total",
    "Degradation-ladder rung changes, by direction (down = degrade, "
    "up = recover); paired ladder.degrade/ladder.recover events carry "
    "the rung names", labels=("direction",))
RESILIENCE_RETRIES = REGISTRY.counter(
    "resilience_retries_total",
    "Transient device errors absorbed by bounded retry-with-backoff "
    "WITHOUT a ladder rung change (the errors that did cost a rung are "
    "counted in resilience_transitions_total{direction=down})")
RESILIENCE_SHED_OUTPUTS = REGISTRY.counter(
    "resilience_shed_outputs_total",
    "Subscriber outputs shed by ladder rung 3 (newest-first, one per "
    "maintenance tick) to keep an overloaded stream live for everyone "
    "else")
RESILIENCE_CKPT_WRITES = REGISTRY.counter(
    "resilience_checkpoint_writes_total",
    "Relay-state checkpoint documents written to <log_folder>/ckpt/ "
    "(atomic tmp+rename, one per resilience_checkpoint_interval_sec)")
RESILIENCE_CKPT_BYTES = REGISTRY.counter(
    "resilience_checkpoint_bytes_total",
    "Serialized checkpoint bytes written (ring cursors + rewrite "
    "5-tuples + RR accounting are plain integers, so this stays KB-scale "
    "even at hundreds of sessions)")
RESILIENCE_CKPT_RESTORES = REGISTRY.counter(
    "resilience_checkpoint_restores_total",
    "Startup hot-restores that rebuilt at least one relay session from "
    "a fresh checkpoint (supervisor-restarted server resuming without "
    "re-SETUP)")
RESILIENCE_CKPT_ERRORS = REGISTRY.counter(
    "resilience_checkpoint_errors_total",
    "Checkpoint write/parse failures (full disk, version mismatch, "
    "malformed session record); the server keeps serving either way")
RESILIENCE_CKPT_TCP_ORPHANS = REGISTRY.counter(
    "resilience_checkpoint_tcp_orphans_total",
    "Checkpointed interleaved-TCP subscriber records discarded because "
    "no connection re-attached within the RTSP timeout (TCP "
    "outputs are recorded with kind=tcp + channel ids and restored only "
    "when the same session re-SETUPs; stale records age out counted, "
    "never silently)")

# --------------------------------------------------------------- cluster tier
# The fault-tolerant cluster layer (easydarwin_tpu/cluster/): Redis
# leases + fencing, consistent-hash stream placement, cross-server pull
# relay with retry/breaker envelope, and checkpoint-driven live session
# migration.  tools/metrics_lint.py enforces this family set and
# tools/soak.py --cluster keys on it.
REDIS_ERRORS = REGISTRY.counter(
    "redis_errors_total",
    "Redis commands that failed (timeout, connection error, partition — "
    "real or injected); the caller degrades gracefully, a lapsed lease "
    "simply ages out and a peer takes over")
CLUSTER_LEASE_ACQUIRED = REGISTRY.counter(
    "cluster_lease_acquired_total",
    "Server leases acquired in Redis (boot + every re-acquire after an "
    "observed loss); each acquire mints a fresh monotonic fencing token")
CLUSTER_LEASE_RENEWALS = REGISTRY.counter(
    "cluster_lease_renewals_total",
    "Successful lease heartbeat renewals (TTL re-asserted while the "
    "stored fencing token still matches ours)")
CLUSTER_LEASE_LOST = REGISTRY.counter(
    "cluster_lease_lost_total",
    "Heartbeats that found our lease gone or stolen (TTL expiry during "
    "a partition, injected lease loss); the server re-acquires with a "
    "NEW fencing token, so its pre-loss claims are now stale")
CLUSTER_LEASE_FENCE_REJECTED = REGISTRY.counter(
    "cluster_lease_fence_rejected_total",
    "Fenced Redis writes rejected because a NEWER fencing token holds "
    "the record — the split-brain guard firing: a zombie ex-owner came "
    "back and must release the stream instead of double-serving it")
CLUSTER_PLACEMENT_MOVES = REGISTRY.counter(
    "cluster_placement_moves_total",
    "Stream ownership moves observed by the placement layer (consistent-"
    "hash re-placement after a node joined, left, or its lease expired)")
CLUSTER_PULL_RETRIES = REGISTRY.counter(
    "cluster_pull_retries_total",
    "Cross-server pull-relay restart attempts taken by the retry/backoff "
    "envelope (connect timeout, upstream EOF, read stall — each retry "
    "waits a capped jittered exponential backoff first)")
CLUSTER_PULL_BREAKER_OPEN = REGISTRY.counter(
    "cluster_pull_breaker_open_total",
    "Pull-relay circuit-breaker open transitions (N consecutive failures "
    "against one upstream; while open no connect is attempted until the "
    "half-open probe window)")
CLUSTER_MIGRATIONS = REGISTRY.counter(
    "cluster_migrations_total",
    "Live session migrations completed: this node adopted a stream whose "
    "owner's lease expired (or drained), restored its Redis-published "
    "checkpoint (same ssrc, gapless rewritten seq) and re-pointed the "
    "subscribers without re-SETUP")

# ------------------------------------------------------ load-aware control
# The load-aware control plane: boot-time capacity scoring +
# live utilization published into the fenced lease records, capacity-
# weighted ring placement, the proactive SLO-drain rebalancer, overload
# admission (453/305) and origin->edge relay trees.
# tools/metrics_lint.py enforces this family set (lint_control_plane:
# exact labels, the admission action vocabulary closed to
# refuse|redirect) and tools/soak.py --skewed keys on it.
CLUSTER_CAPACITY_SCORE = REGISTRY.gauge(
    "cluster_capacity_score",
    "This node's published capacity score in relayed packets/second "
    "(boot-time self-bench or the operator-pinned "
    "cluster_capacity_score pref, quantized to a power of two so same-"
    "hardware peers weigh the ring equally); the value riding the "
    "fenced Node: lease record that peers weight placement with")
CLUSTER_UTILIZATION_RATIO = REGISTRY.gauge(
    "cluster_utilization_ratio",
    "This node's live utilization (EWMA delivered-packet rate divided "
    "by its effective capacity score, 0 = idle, >= 1 = past rated "
    "capacity); published each heartbeat and read by the admission "
    "gate and the rebalancer")
CLUSTER_REBALANCE_MOVES = REGISTRY.counter(
    "cluster_rebalance_moves_total",
    "Proactive stream drains completed by the rebalancer: a sustained "
    "SLO-burning/over-utilized node published a fresh checkpoint and "
    "handed its hottest stream to the least-loaded live successor "
    "(the crash-migration path reused as a planned move)")
CLUSTER_ADMISSION_REFUSED = REGISTRY.counter(
    "cluster_admission_refused_total",
    "New play SETUPs not admitted because this node was past its "
    "utilization high-water mark, by action (redirect = RTSP 305 to "
    "the placement-resolved edge, refuse = RTSP 453 Not Enough "
    "Bandwidth when no eligible edge exists)", labels=("action",))
RELAY_TREE_EDGES = REGISTRY.counter(
    "relay_tree_edges_total",
    "Origin->edge relay-tree edges established: cross-server pulls "
    "started by this node to serve local subscribers of a stream "
    "another node owns (E edges cost the origin E pulls instead of "
    "E x S subscribers)")

# --------------------------------------------------------------- audience
# The audience observatory: per-subscriber QoE derived from
# the columnar store in obs/audience.py.  tools/metrics_lint.py
# (lint_audience) enforces this family set, the closed tier/band
# vocabularies and the [0, 1] QoE bucket ladder; tools/soak.py
# --composed keys its viewer-experience gate on the same figures.
from .audience import QOE_BUCKETS as _QOE_BUCKETS  # noqa: E402

AUDIENCE_QOE_SCORE = REGISTRY.histogram(
    "audience_qoe_score",
    "Per-subscriber QoE score distribution, one sample per subscriber "
    "per maintenance tick (delivery ratio x freshness x stall penalty, "
    "bounded [0, 1] — the closed formula in ARCHITECTURE.md "
    "'Audience observatory')", labels=("tier",),
    buckets=_QOE_BUCKETS)
AUDIENCE_STALL_SECONDS = REGISTRY.counter(
    "audience_stall_seconds_total",
    "Cumulative viewer-frozen seconds per tier: inter-delivery gaps "
    "beyond the stall threshold, summed across every subscriber "
    "(derived on the maintenance tick from the columnar last-wire "
    "stamps, never measured per packet)", labels=("tier",))
AUDIENCE_SUBSCRIBERS = REGISTRY.gauge(
    "audience_subscribers",
    "Current subscriber census by tier and QoE band (good/fair/poor — "
    "the closed band vocabulary over the same closed tier set the "
    "fleet rollup uses)", labels=("tier", "band"))
AUDIENCE_STALL_STORMS = REGISTRY.counter(
    "audience_stall_storms_total",
    "Stall-storm rising edges: k-of-n subscribers of one stream "
    "entered stall inside the storm window (each latched edge also "
    "emits audience.stall_storm carrying the ledger-blamed work class)")
