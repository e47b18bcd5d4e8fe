"""Server configuration: the live relay and the REST service port."""

from __future__ import annotations

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
