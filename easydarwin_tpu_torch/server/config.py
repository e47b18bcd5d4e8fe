"""Server configuration: the live relay, file playback (VOD) and the REST
service port."""

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
    reflect_interval_ms: int = 20      # pump tick when no ingest wakes it
    rtsp_timeout_sec: int = 120        # idle player connection kill
    push_timeout_sec: int = 20         # idle pusher connection kill
    max_connections: int = 20000
    #: a UDP pusher's RTP socket is drained in native recvmmsg batches
    #: straight into the ring (off: one asyncio callback a datagram); the
    #: per-datagram path serves when the egress core is not built
    native_ingest: bool = True
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
