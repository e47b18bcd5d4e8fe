"""Relay session: the per-source-path unit.

Built from a pushed (ANNOUNCE) SDP; owns one ``RelayStream`` per media
section, keyed by track id.  ``SessionRegistry`` maps paths to sessions.

Audio/video fast-start coupling: when a video stream records a fresh
keyframe, audio outputs that have not started yet are re-aligned so a late
joiner's audio starts with the video GOP.
"""

from __future__ import annotations

import secrets
import time

from ..obs import EVENTS
from ..protocol import sdp as sdp_mod
from .stream import RelayStream, StreamSettings


def now_ms() -> int:
    return int(time.monotonic() * 1000)


class RelaySession:
    def __init__(self, path: str, description: sdp_mod.SessionDescription,
                 settings: StreamSettings | None = None):
        self.path = path
        self.description = description
        self.settings = settings or StreamSettings()
        #: the correlation id of this source's spans and events; a feeder
        #: that owns a trace (an ANNOUNCE pusher) re-stamps it with
        #: ``set_trace``
        self.trace_id = secrets.token_hex(8)
        #: node ids this stream's trace has lived on (the fleet's lineage)
        self.trace_nodes: list[str] = []
        self.streams: dict[int, RelayStream] = {}
        for info in description.streams:
            self.streams[info.track_id] = RelayStream(info, self.settings)
        self.set_trace(self.trace_id)
        self.created_ms = now_ms()
        self.last_ingest_ms = self.created_ms
        #: the object feeding this session (the pusher's RTSP connection):
        #: identity-based ownership, so a teardown never removes a session
        #: something else has since taken over
        self.owner: object | None = None

    def set_trace(self, trace_id: str) -> None:
        """Adopt the feeder's trace id and hand it to every stream (the
        engine reads it off the stream when it records a span)."""
        self.trace_id = trace_id
        for st in self.streams.values():
            st.trace_id = trace_id
            st.session_path = self.path

    # -- ingest ------------------------------------------------------------
    def push(self, track_id: int, packet: bytes, *, is_rtcp: bool = False,
             t_ms: int | None = None) -> None:
        st = self.streams.get(track_id)
        if st is None:
            return
        t = now_ms() if t_ms is None else t_ms
        self.last_ingest_ms = t
        if is_rtcp:
            st.push_rtcp(packet, t)
            return
        st.push_rtp(packet, t)
        self._kf_resync(st)

    def _kf_resync(self, st: RelayStream) -> None:
        if not st.has_keyframe_update:
            return
        st.has_keyframe_update = False
        for other in self.streams.values():
            if other is st or other.info.media_type != "audio":
                continue
            for out in other.outputs:
                if out.bookmark is None and len(other.rtp_ring):
                    out.bookmark = other.rtp_ring.head - 1

    def drain_native(self, track_id: int, fd: int,
                     max_pkts: int = 512) -> int:
        """Drain a UDP pusher's RTP socket of ``track_id`` into its
        stream's ring (``RelayStream.drain_rtp_native``) with ``push``'s
        housekeeping: the ingest clock and the audio re-alignment on a
        fresh keyframe.  Returns the packets admitted."""
        st = self.streams.get(track_id)
        if st is None:
            return 0
        t = now_ms()
        n = st.drain_rtp_native(fd, t, max_pkts)
        if n:
            self.last_ingest_ms = t
            self._kf_resync(st)
        return n

    # -- maintenance -------------------------------------------------------
    def prune(self, t_ms: int | None = None) -> int:
        t = now_ms() if t_ms is None else t_ms
        return sum(s.prune(t) for s in self.streams.values())

    @property
    def num_outputs(self) -> int:
        return sum(s.num_outputs for s in self.streams.values())

    def stats(self) -> dict:
        """Per-track ingest and fan-out counters (REST
        ``getrtsplivesessions``)."""
        return {
            "path": self.path,
            "outputs": self.num_outputs,
            "streams": {
                tid: {
                    "media": s.info.media_type, "codec": s.info.codec,
                    "packets_in": s.stats.packets_in,
                    "bytes_in": s.stats.bytes_in,
                    "packets_out": s.stats.packets_out,
                    "keyframes": s.stats.keyframes,
                    "queue": len(s.rtp_ring),
                    "oversize_dropped": s.rtp_ring.total_oversize,
                } for tid, s in self.streams.items()
            },
        }


class SessionRegistry:
    """Path → RelaySession map."""

    def __init__(self, settings: StreamSettings | None = None):
        self.settings = settings or StreamSettings()
        self.sessions: dict[str, RelaySession] = {}
        self.sdp_cache = sdp_mod.SdpCache()

    def find(self, path: str) -> RelaySession | None:
        return self.sessions.get(sdp_mod._norm(path))

    def find_or_create(self, path: str, sdp_text: str) -> RelaySession:
        key = sdp_mod._norm(path)
        sess = self.sessions.get(key)
        if sess is None:
            sess = RelaySession(key, sdp_mod.parse(sdp_text), self.settings)
            self.sessions[key] = sess
            self.sdp_cache.set(key, sdp_text)
            EVENTS.emit("session.create", stream=key,
                        trace_id=sess.trace_id, path=key,
                        streams=len(sess.streams))
        return sess

    def paths(self) -> list[str]:
        return sorted(self.sessions)

    def remove(self, path: str) -> None:
        key = sdp_mod._norm(path)
        sess = self.sessions.pop(key, None)
        self.sdp_cache.pop(key)
        if sess is not None:
            EVENTS.emit("session.remove", stream=key,
                        trace_id=sess.trace_id, path=key)
