"""Server configuration: the live relay, file playback (VOD), DVR and
time-shift, the erasure-coded store, the REST service port, auth, the
logs, pull relays and ``.sdp`` broadcasts.

A ``ServerConfig`` loads from a TOML file of its keys (``load_toml``) or
from the reference's ``easydarwin.xml`` (``load_reference_xml``, the DSS
``PREF``/``MODULE`` layout); ``load_config`` sniffs which one a file is.
Both return the keys they could not apply, never dropping one in
silence: a key this port does not serve (the JAX fan-out switches, …) is
listed.  The cluster tier's keys (``cloud_enabled``, ``redis_host``,
``redis_port``, ``server_id``, ``cms_host``, ``cms_port`` and every
``cluster_*``; the XML's ``enable_cloud_platform``, ``EasyRedisModule``
``redis_ip`` and ``redis_port`` and ``EasyCMSModule`` ``cms_ip`` and
``cms_port``) are applied, and ``cluster_config`` builds the
``cluster.service.ClusterConfig``.  The SLO watchdog's ``slo_*`` keys, the console and status file
(``stats_interval_sec``, ``status_file_*``; the XML's
``monitor_stats_file_*`` with ``enable_monitor_stats_file``), the
plugin folder (``module_folder``) and the resilience keys
(``resilience_*``: the degradation ladder, the armed fault plan and the
session checkpoint; ``ladder_config`` and ``fault_plan`` build their
objects) are applied.  ``to_dict``,
``from_dict`` and ``update`` (``KeyError`` on an unknown key; the
listeners registered with ``on_change`` run after it) serve REST
``getbaseconfig`` and ``setbaseconfig``.  The relay tunables live in
``stream`` (``StreamSettings``) and read and write under the reference's
top-level names (``bucket_size``, ``bucket_delay_ms``, ``overbuffer_sec``,
``max_packet_age_sec``, ``ring_capacity``).

The reference's reliability-tier keys (``reliable_udp``, ``fec_*``,
``rtx_*``; ``fec_config`` builds the validated ``relay.fec.FecConfig``)
and its serving-path switches (``megabatch_enabled``,
``megabatch_min_streams``, ``tcp_engine_enabled``, ``storage_device``,
``timeout_sweep_sec``) are applied; each says which path or kernel it
selects beside its field.  Three keys of the reference stay unmapped:
``tpu_fanout`` and ``tpu_min_outputs`` (the JAX package's switch between
its scalar loop and its batch engine: the port always runs the engine)
and ``egress_backend`` (the port has one egress, the GSO/sendmmsg pair).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import tomllib
from dataclasses import dataclass, field
from typing import Callable

from ..relay.stream import StreamSettings

#: the reference's top-level relay keys → (``StreamSettings`` field, the
#: factor from the key's unit to the field's)
STREAM_KEYS = {"bucket_size": ("bucket_size", 1),
               "bucket_delay_ms": ("bucket_delay_ms", 1),
               "overbuffer_sec": ("overbuffer_ms", 1000),
               "max_packet_age_sec": ("max_age_ms", 1000),
               "ring_capacity": ("ring_capacity", 1)}


@dataclass
class ServerConfig:
    rtsp_port: int = 10554
    service_port: int = 10008          # REST API (service_lan_port)
    bind_ip: str = "0.0.0.0"
    reflect_interval_ms: int = 20      # pump tick when nothing wakes it
    rtsp_timeout_sec: int = 120        # idle player connection kill
    push_timeout_sec: int = 20         # idle pusher connection kill
    #: seconds between the idle-connection sweeps (which also retire
    #: transcode ladders and HLS entries whose source went away): a
    #: connection is closed at the first sweep past its limit
    timeout_sweep_sec: int = 15
    max_connections: int = 20000
    #: a UDP pusher's RTP socket is drained in native recvmmsg batches
    #: straight into the ring (off: one asyncio callback a datagram); the
    #: per-datagram path serves when the egress core is not built
    native_ingest: bool = True
    #: UDP players share one egress pair, written by the native
    #: sendmmsg/GSO scatter; off: each UDP player gets a port pair of its
    #: own from the pool, and its packets take the engine's per-output
    #: loop
    shared_udp_egress: bool = True
    #: devices the megabatch serves from: 1 = one device; N > 1 = each
    #: shape bucket's stream axis sharded over the first N cards
    #: (``parallel.mesh.make_megabatch_mesh``); 0 = every card.  Clamped
    #: to the cards the box has, so one card keeps the one-device path
    megabatch_devices: int = 1
    #: the cross-stream megabatch scheduler: with at least
    #: ``megabatch_min_streams`` streams with players, ONE
    #: ``ed_relay_window`` launch a wake serves them all; below that, or
    #: with ``megabatch_enabled`` off, each stream's engine queries its
    #: own device ring (``ed_ring_query``) and a VOD join is primed there
    megabatch_enabled: bool = True
    megabatch_min_streams: int = 2
    #: interleaved-TCP players take the engine's TCP rung (one framed
    #: ``writev`` a connection); off: they take the batch-header rung
    #: (``ed_relay_batch``) as meta-info and thinned players do
    tcp_engine_enabled: bool = True
    #: ``x-Retransmit`` (reliable UDP) is granted at SETUP; off: the
    #: header is neither echoed nor acted on
    reliable_udp: bool = True
    #: the FEC tier: ``x-FEC: parity`` is granted at a UDP SETUP, with
    #: parity over windows of ``fec_window`` media packets
    #: (``fec_kind`` ``rs`` or ``xor``, at most ``fec_max_overhead`` of the
    #: window), parity and RTX replays on their own payload types, and a
    #: NACK budget of ``rtx_budget_per_sec`` an output (bucket
    #: ``rtx_burst``); off: the header is not granted
    fec_enabled: bool = True
    fec_window: int = 16
    fec_max_overhead: float = 0.30
    fec_kind: str = "rs"
    fec_payload_type: int = 127
    rtx_payload_type: int = 126
    rtx_budget_per_sec: float = 64.0
    rtx_burst: int = 32
    #: a window's parity is B4 (``ed_gf_parity``) on the server's device,
    #: checked against the host product; off: the host product alone,
    #: with no upload and no launch
    fec_device: bool = True
    #: per-stream relay tunables (buckets, fast-start, eviction, ring)
    stream: StreamSettings = field(default_factory=StreamSettings)
    #: where DESCRIBE/SETUP/PLAY of a path that no pusher serves look for
    #: a file (``.mp4``, ``.mov``, ``.m4v``), and recordings are written
    #: (default: ``movies`` in the temp directory)
    movie_folder: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "movies"))
    #: the segment cache: PLAY on a file is served by the shared group
    #: pacer, each hot asset's samples packed once into ring-window rows
    #: that every player's stream rides through the megabatch engine; a
    #: miss streams cold while a background fill packs the window.  Off:
    #: every player gets its own ``FileSession`` (as Scale and meta-info
    #: sessions always do)
    vod_cache_enabled: bool = True
    vod_cache_bytes: int = 268_435_456     # LRU byte budget (host + card)
    vod_cache_window_samples: int = 64     # samples packed per window
    vod_cache_lookahead_ms: int = 500      # pacer ring-fill horizon
    #: keep each packed window's rows resident on the server's device
    #: (uploaded once, shared by every player of that window) and prime
    #: each join there; host-only caching and no device prime when off
    vod_cache_device: bool = True
    #: DVR and time-shift: every pushed session's completed ring windows
    #: spill to ``<movie_folder>/.dvr/<path>/`` in the packed serving
    #: format; a live player can PAUSE and PLAY with a Range into the
    #: past (served by the VOD pacer, catching up onto the live stream),
    #: and a finished recording replays as ``<path>.dvr``.  Needs
    #: ``vod_cache_enabled`` (the spill serves through the segment cache)
    dvr_enabled: bool = False
    dvr_window_pkts: int = 64              # packets a spill window
    dvr_retention_bytes: int = 67_108_864  # spill byte budget a track
    dvr_retention_sec: float = 600.0       # spill duration cap a track
    #: erasure-coded store: every finalized DVR asset is sharded into
    #: ``k`` data + ``m`` parity window shards under
    #: ``<movie_folder>/.shards`` (the parity on the server's device,
    #: checked against the host product); a read missing at most ``m``
    #: shards of a stripe is reconstructed; a scrub re-verifies the
    #: shards every ``storage_scrub_interval_sec``.  Needs
    #: ``dvr_enabled``
    storage_enabled: bool = False
    storage_data_shards: int = 4           # k: data shards a stripe
    storage_parity_shards: int = 2         # m: parity shards a stripe
    storage_scrub_interval_sec: float = 30.0
    #: a stripe's parity and a reconstruct's solve are B4 on the server's
    #: device, checked against the host product or the crc32s; off: the
    #: host product alone (the crc32s still checked), with no launch
    storage_device: bool = True
    #: this node's name in shard claims and manifests, its cluster lease
    #: and its presence records
    server_id: str = "easydarwin-tpu-0"
    #: the reference's passive presence (``EasyDarwin:{id}`` and
    #: ``Live:{name}`` records in Redis, ``cluster.presence``); a server
    #: whose Redis is unreachable at start runs without it
    cloud_enabled: bool = False
    redis_host: str = "127.0.0.1"
    redis_port: int = 6379
    #: the EasyCMS address (the XML's ``EasyCMSModule`` ``cms_ip`` and
    #: ``cms_port``), read and kept as the reference keeps it; nothing
    #: in the server uses it: ``cluster.cms``'s ``CmsServer`` is a
    #: library class that takes its own ``bind_ip`` and ``port``
    cms_host: str = "127.0.0.1"
    cms_port: int = 10000
    #: the fault-tolerant cluster tier (``cluster.service``): Redis leases
    #: with fencing, consistent-hash placement, the cross-server pull
    #: relay and checkpoint-driven live migration; supersedes the passive
    #: presence when on
    cluster_enabled: bool = False
    cluster_lease_ttl_sec: float = 5.0     # lease TTL = failure-detect time
    cluster_heartbeat_sec: float = 1.0     # service tick cadence
    cluster_vnodes: int = 64               # ring points per node
    cluster_own_ttl_sec: float = 30.0      # Own:{path} record TTL
    cluster_migration_ttl_sec: float = 30.0  # Ckpt:{path} record TTL
    #: the cross-server pull envelope (``cluster.pull``)
    cluster_pull_connect_timeout_sec: float = 5.0
    cluster_pull_read_timeout_sec: float = 5.0   # no packet → stall
    cluster_pull_backoff_ms: float = 200.0       # first retry (doubles)
    cluster_pull_backoff_cap_ms: float = 5000.0
    cluster_pull_jitter_frac: float = 0.25       # ± anti-stampede jitter
    cluster_pull_breaker_failures: int = 5       # consecutive → open
    cluster_pull_breaker_open_sec: float = 10.0
    #: the load-aware control plane (``cluster.capacity`` and the
    #: rebalancer): a capacity score (0: the boot self-bench of the host
    #: relay loop, in relayed packets a second) and live utilization ride
    #: the lease; past the admission high-water mark a new SETUP answers
    #: 305 to an edge with headroom or 453; the rebalancer drains a
    #: sustained-burning node's hottest stream to the least-loaded peer
    cluster_capacity_score: float = 0.0
    cluster_admission_enabled: bool = True
    cluster_admission_high_water: float = 0.85   # util ratio gate
    cluster_rebalance_enabled: bool = True
    cluster_rebalance_high_water: float = 0.9    # sustained-burn level
    cluster_rebalance_low_water: float = 0.5     # target headroom gate
    cluster_rebalance_burn_sec: float = 10.0     # sustained-burn window
    cluster_rebalance_cooldown_sec: float = 30.0  # min gap between moves
    #: where the HLS requant rungs run B6 (``"cuda"`` or ``"cpu"``);
    #: None: the server's device
    hls_device: str | None = None
    #: connections one client address may hold (0: no cap); past it a new
    #: connection is closed before it costs a task
    max_connections_per_ip: int = 0
    #: the address the REST answers put in a stream's ``rtsp://`` URL
    wan_ip: str = "127.0.0.1"
    #: REST auth: Basic on every command, a login token (``X-Token``) on
    #: every command that changes state
    auth_enabled: bool = False
    rest_username: str = "admin"
    rest_password: str = "admin"
    #: RTSP auth (``server.auth``): the users file (``user:realm:ha1``
    #: lines) and ``digest`` or ``basic``; every path needs a valid user
    rtsp_auth_enabled: bool = False
    users_file: str = ""
    auth_scheme: str = "digest"
    #: the rolling logs' folder: ``access.log`` (a W3C line a closed
    #: player or pusher session) and ``error.log`` (at
    #: ``error_log_verbosity``: fatal, warning, info or debug)
    log_folder: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "edtpu_torch_logs"))
    access_log_enabled: bool = True
    error_log_verbosity: str = "info"
    #: the SLO watchdog (``obs.slo``): burn-rate budgets over the ``obs``
    #: families, evaluated once a second by the pump
    slo_enabled: bool = True
    slo_latency_objective_ms: float = 50.0   # a good packet hits the wire…
    slo_latency_target: float = 0.99         # …within this for 99% of them
    slo_drop_objective: float = 0.01         # budgeted bad-packet fraction
    slo_fast_window_sec: float = 60.0
    slo_slow_window_sec: float = 600.0
    slo_fast_burn: float = 14.0
    slo_slow_burn: float = 2.0
    slo_min_events: int = 200                # below this a window is noise
    #: the status console (columns on stderr every ``stats_interval_sec``;
    #: 0: off) and the JSON status file (``status_file_path``; "": none)
    stats_interval_sec: int = 0
    status_file_path: str = ""
    status_file_interval_sec: int = 10
    #: a folder of ``*.py`` plugin files whose modules (``server.
    #: modules.Module``) register at start, before anything serves; "":
    #: none
    module_folder: str = ""
    #: the degradation ladder (``resilience.ladder``): each stream's rung,
    #: megabatch → per-stream device → host → shed
    resilience_enabled: bool = True
    #: a ``FaultPlan`` spec armed at start (chaos testing), e.g.
    #: ``"seed=7,ingest_drop=0.05,egress_enobufs_every=300"``; "": none
    resilience_fault_plan: str = ""
    resilience_recover_sec: float = 10.0     # clean time a rung climbed
    resilience_max_retries: int = 3          # device retries before a drop
    resilience_backoff_ms: float = 250.0     # first retry backoff (doubles)
    #: the session checkpoint (``<log_folder>/ckpt/``), off by default: a
    #: restore brings back the sessions of the PREVIOUS process, which an
    #: operator opts into (the watchdog's deployment)
    resilience_checkpoint_enabled: bool = False
    resilience_checkpoint_interval_sec: float = 5.0
    #: a checkpoint older than this is ignored at start
    resilience_checkpoint_max_age_sec: float = 60.0

    _listeners: list[Callable[["ServerConfig"], None]] = field(
        default_factory=list, repr=False, compare=False)

    # -- REST ``getbaseconfig`` / ``setbaseconfig`` --------------------------
    def on_change(self, fn: Callable[["ServerConfig"], None]) -> None:
        self._listeners.append(fn)

    def update(self, **kw) -> None:
        """Apply new values (each cast to its key's type), then run the
        ``on_change`` listeners.  An unknown key raises ``KeyError`` before
        any value changes."""
        known = self.keys()
        for k in kw:
            if k not in known:
                raise KeyError(f"unknown pref {k!r}")
        for k, v in kw.items():
            cur = self.to_dict()[k]
            self._set(k, type(cur)(v) if cur is not None else v)
        for fn in list(self._listeners):
            fn(self)

    def _set(self, key: str, value) -> None:
        if key in STREAM_KEYS:
            name, unit = STREAM_KEYS[key]
            setattr(self.stream, name, int(value * unit))
        else:
            setattr(self, key, value)

    @classmethod
    def keys(cls) -> set[str]:
        return ({f.name for f in dataclasses.fields(cls)
                 if not f.name.startswith("_") and f.name != "stream"}
                | set(STREAM_KEYS))

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)
             if not f.name.startswith("_") and f.name != "stream"}
        for key, (name, unit) in STREAM_KEYS.items():
            v = getattr(self.stream, name)
            d[key] = v / unit if unit != 1 else v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServerConfig":
        """A config from the keys of ``d`` it knows (``split_keys`` says
        which it does not)."""
        cfg = cls()
        for k, v in d.items():
            if k in cls.keys():
                cfg._set(k, v)
        return cfg

    def slo_config(self):
        from ..obs.slo import SloConfig
        return SloConfig(
            latency_objective_ms=self.slo_latency_objective_ms,
            latency_target=self.slo_latency_target,
            drop_objective=self.slo_drop_objective,
            fast_window_s=self.slo_fast_window_sec,
            slow_window_s=self.slo_slow_window_sec,
            fast_burn=self.slo_fast_burn,
            slow_burn=self.slo_slow_burn,
            min_events=self.slo_min_events)

    def cluster_config(self):
        """The ``ClusterConfig`` of the ``cluster_*`` keys (the server
        fills the ports once its listeners are bound)."""
        from ..cluster.pull import PullConfig
        from ..cluster.service import ClusterConfig
        return ClusterConfig(
            self.server_id, ip=self.wan_ip,
            lease_ttl_sec=self.cluster_lease_ttl_sec,
            heartbeat_sec=self.cluster_heartbeat_sec,
            vnodes=self.cluster_vnodes,
            own_ttl_sec=self.cluster_own_ttl_sec,
            migration_ttl_sec=self.cluster_migration_ttl_sec,
            rebalance_enabled=self.cluster_rebalance_enabled,
            rebalance_high_water=self.cluster_rebalance_high_water,
            rebalance_low_water=self.cluster_rebalance_low_water,
            rebalance_burn_sec=self.cluster_rebalance_burn_sec,
            rebalance_cooldown_sec=self.cluster_rebalance_cooldown_sec,
            admission_enabled=self.cluster_admission_enabled,
            admission_high_water=self.cluster_admission_high_water,
            pull=PullConfig(
                connect_timeout_sec=self.cluster_pull_connect_timeout_sec,
                read_timeout_sec=self.cluster_pull_read_timeout_sec,
                backoff_ms=self.cluster_pull_backoff_ms,
                backoff_cap_ms=self.cluster_pull_backoff_cap_ms,
                jitter_frac=self.cluster_pull_jitter_frac,
                breaker_failures=self.cluster_pull_breaker_failures,
                breaker_open_sec=self.cluster_pull_breaker_open_sec))

    def fec_config(self, device: str = "cuda"):
        """The validated FEC tier's ``FecConfig`` (``ValueError`` on a bad
        window, kind or pair of payload types: the server calls it at
        start with ``fec_enabled``).  With ``fec_device`` its parity runs
        on ``device``; without it on no device."""
        from ..relay.fec import FecConfig
        return FecConfig(
            window=self.fec_window,
            max_overhead=self.fec_max_overhead,
            kind=self.fec_kind,
            payload_type=self.fec_payload_type,
            rtx_payload_type=self.rtx_payload_type,
            rtx_budget_per_sec=self.rtx_budget_per_sec,
            rtx_burst=self.rtx_burst,
            use_device=self.fec_device,
            device=str(device) if self.fec_device else None).validate()

    def ladder_config(self):
        from ..resilience.ladder import LadderConfig
        return LadderConfig(
            recover_sec=self.resilience_recover_sec,
            max_retries=self.resilience_max_retries,
            backoff_ms=self.resilience_backoff_ms)

    def fault_plan(self):
        """The ``FaultPlan`` to arm, or None when no spec is set.  A
        malformed spec raises at start: a mistyped plan that injects
        nothing would void the chaos run it was meant to drive."""
        if not self.resilience_fault_plan.strip():
            return None
        from ..resilience.inject import FaultPlan
        return FaultPlan.parse(self.resilience_fault_plan)

    @classmethod
    def from_toml(cls, path: str) -> "ServerConfig":
        return load_toml(path)[0]

    def to_toml(self) -> str:
        out = []
        for k, v in self.to_dict().items():
            if v is None:
                continue
            if isinstance(v, bool):
                out.append(f"{k} = {'true' if v else 'false'}")
            elif isinstance(v, (int, float)):
                out.append(f"{k} = {v}")
            else:
                out.append(f'{k} = "{v}"')
        return "\n".join(out) + "\n"


def load_toml(path: str) -> tuple[ServerConfig, list[str]]:
    """A TOML file of config keys → ``(config, unmapped)``: ``unmapped``
    names each key of the file this port has no counterpart for."""
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    known = ServerConfig.keys()
    return (ServerConfig.from_dict(doc),
            [k for k in doc if k not in known])


def load_config(path: str) -> tuple[ServerConfig, list[str]]:
    """A config file → ``(config, unmapped)``, read as the reference's
    XML when its content starts like XML (configs travel under any name),
    else as TOML."""
    with open(path, "rb") as f:
        head = f.read(256).lstrip()
    if head.startswith((b"<?xml", b"<!DOCTYPE", b"<CONFIGURATION")):
        return load_reference_xml(path)
    return load_toml(path)


# -- the reference's easydarwin.xml -------------------------------------------

def _bool(v: str) -> bool:
    """Strict DSS bool: anything but true/false is reported, not coerced
    (a hand-edited 'True'/'1' must not silently become False)."""
    if v == "true":
        return True
    if v == "false":
        return False
    raise ValueError(f"not a DSS bool: {v!r}")


def _verbosity(v: str) -> str:
    i = int(v)
    if not 0 <= i <= 4:                 # DSS levels 0..4
        raise ValueError(f"verbosity {v!r} out of range")
    return ("fatal", "warning", "info", "info", "debug")[i]


#: reference pref name → (config key, converter), as the reference maps
#: them; a key this port does not have lands in the unmapped list
_XML_SERVER_MAP = {
    "rtsp_port": ("rtsp_port", int),                 # LIST-PREF: first value
    "service_lan_port": ("service_port", int),
    # http_service_port is DSS's RTSP-over-HTTP port, not the REST port:
    # tunnels ride the RTSP port itself, so it stays unmapped
    "service_wan_ip": ("wan_ip", str),
    "bind_ip_addr": ("bind_ip",
                     lambda v: "0.0.0.0" if v in ("", "0") else v),
    "movie_folder": ("movie_folder", str),
    "maximum_connections": ("max_connections", int),
    "rtsp_session_timeout": ("rtsp_timeout_sec", int),
    "enable_cloud_platform": ("cloud_enabled", _bool),
    "authentication_scheme": ("auth_scheme", str),
    "error_logfile_verbosity": ("error_log_verbosity", _verbosity),
    "monitor_stats_file_name": ("status_file_path", str),
    "monitor_stats_file_interval_seconds": ("status_file_interval_sec", int),
}

_XML_MODULE_MAP = {
    ("QTSSReflectorModule", "reflector_bucket_offset_delay_msec"):
        ("bucket_delay_ms", int),
    ("QTSSReflectorModule", "reflector_buffer_size_sec"):
        ("overbuffer_sec", float),
    ("QTSSReflectorModule", "timeout_broadcaster_session_secs"):
        ("push_timeout_sec", int),
    ("QTSSAccessLogModule", "request_logging"):
        ("access_log_enabled", _bool),
    ("EasyRedisModule", "redis_ip"): ("redis_host", str),
    ("EasyRedisModule", "redis_port"): ("redis_port", int),
    ("EasyCMSModule", "cms_ip"): ("cms_host", str),
    ("EasyCMSModule", "cms_port"): ("cms_port", int),
    # DSS prefs the reference's loader leaves unmapped, served here
    ("QTSSSpamDefenseModule", "num_conns_per_ip_addr"):
        ("max_connections_per_ip", int),
    ("QTSSAccessModule", "modAccess_enabled"): ("rtsp_auth_enabled", _bool),
    ("QTSSAccessModule", "modAccess_usersfilepath"): ("users_file", str),
}


def load_reference_xml(path: str) -> tuple[ServerConfig, list[str]]:
    """The reference's ``easydarwin.xml`` → ``(config, unmapped)``.

    ``unmapped`` lists each pref with no counterpart here, each the
    reference maps to a key this port does not serve yet, the dropped
    values of a LIST-PREF and each malformed value, so that a migrating
    operator sees what did not carry over."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    cfg = ServerConfig()
    known = ServerConfig.keys()
    unmapped: list[str] = []
    monitor_enabled = False

    def pref_value(el, label: str) -> str:
        if el.tag == "LIST-PREF":
            vals = el.findall("VALUE")
            if len(vals) > 1:           # only the first value carries over
                unmapped.append(
                    f"{label} (extra values dropped: "
                    f"{[(v.text or '').strip() for v in vals[1:]]})")
            return (vals[0].text or "").strip() if vals else ""
        return (el.text or "").strip()

    def apply(el, label: str, ent) -> None:
        if ent is None or ent[0] not in known:
            unmapped.append(label)
            return
        key, conv = ent
        raw = pref_value(el, label)
        try:
            cfg._set(key, conv(raw))
        except ValueError:              # mapped name, malformed value
            unmapped.append(f"{label} (invalid value {raw!r})")

    server = root.find("SERVER")
    for el in (server if server is not None else []):
        if el.tag not in ("PREF", "LIST-PREF"):
            continue
        name = el.get("NAME", "")
        if name == "enable_monitor_stats_file":
            monitor_enabled = pref_value(el, name) == "true"
            continue
        apply(el, name, _XML_SERVER_MAP.get(name))
    for mod in root.findall("MODULE"):
        mod_name = mod.get("NAME", "")
        for el in mod:
            if el.tag not in ("PREF", "LIST-PREF"):
                continue
            name = el.get("NAME", "")
            apply(el, f"{mod_name}/{name}",
                  _XML_MODULE_MAP.get((mod_name, name)))
    if not monitor_enabled:
        cfg.status_file_path = ""       # a file name without the flag
    return cfg, unmapped
