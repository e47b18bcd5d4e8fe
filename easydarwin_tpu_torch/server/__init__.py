"""The live-relay server: RTSP over TCP with interleaved RTP, a pump that
drives the megabatch scheduler and the fan-out engines."""

from .app import StreamingServer
from .config import ServerConfig

__all__ = ["ServerConfig", "StreamingServer"]
