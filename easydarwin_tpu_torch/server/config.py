"""Server configuration: the live relay, file playback (VOD), DVR and
time-shift, the erasure-coded store, the REST service port, auth, the
logs, pull relays and ``.sdp`` broadcasts.

A ``ServerConfig`` loads from a TOML file of its keys (``load_toml``) or
from the reference's ``easydarwin.xml`` (``load_reference_xml``, the DSS
``PREF``/``MODULE`` layout); ``load_config`` sniffs which one a file is.
Both return the keys they could not apply, never dropping one in
silence: a key this port does not serve yet (``slo_*``, the cluster,
the degradation ladder, fault injection, …) is listed.  ``to_dict``,
``from_dict`` and ``update`` (``KeyError`` on an unknown key; the
listeners registered with ``on_change`` run after it) serve REST
``getbaseconfig`` and ``setbaseconfig``.  The relay tunables live in
``stream`` (``StreamSettings``) and read and write under the reference's
top-level names (``bucket_size``, ``bucket_delay_ms``, ``overbuffer_sec``,
``max_packet_age_sec``, ``ring_capacity``).
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
    #: this node's name in shard claims and manifests
    server_id: str = "easydarwin-tpu-0"
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
        apply(el, name, _XML_SERVER_MAP.get(name))
    for mod in root.findall("MODULE"):
        mod_name = mod.get("NAME", "")
        for el in mod:
            if el.tag not in ("PREF", "LIST-PREF"):
                continue
            name = el.get("NAME", "")
            apply(el, f"{mod_name}/{name}",
                  _XML_MODULE_MAP.get((mod_name, name)))
    return cfg, unmapped
