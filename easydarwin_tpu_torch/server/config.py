"""Server configuration: the live relay, file playback (VOD), DVR and
time-shift, the erasure-coded store and the REST service port."""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field

from ..relay.stream import StreamSettings


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
