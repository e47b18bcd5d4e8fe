"""SDP parse and build (the RFC 4566 subset push/play needs).

A pushed ANNOUNCE body becomes a ``SessionDescription`` with one
``StreamInfo`` per media section; DESCRIBE answers with the pushed text as
it was announced (``SdpCache``).  A file's DESCRIBE answer is built from
its tracks (``vod.packetizer.sdp_for_file``) and serialized by ``build``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: media kinds
VIDEO, AUDIO, OTHER = "video", "audio", "other"


@dataclass
class StreamInfo:
    """Per-media-section info."""

    media_type: str = OTHER           # "video" | "audio" | "other"
    payload_type: int = 0             # RTP payload type number
    payload_name: str = ""            # e.g. "H264/90000"
    codec: str = ""                   # e.g. "H264"
    clock_rate: int = 90000
    port: int = 0
    track_id: int = 0                 # from a=control:trackID=N (or ordinal)
    control: str = ""                 # raw control attribute value
    fmtp: str = ""
    attributes: dict[str, str] = field(default_factory=dict)
    connection: str = ""              # media-level c= (a broadcast's ingest)

    def dest_address(self, session_connection: str = "") -> str:
        """The ingest destination from the media-level ``c=`` (falling back
        to the session-level one): ``IN IP4 239.1.2.3/127`` → ``239.1.2.3``."""
        conn = self.connection or session_connection
        parts = conn.split()
        return parts[-1].split("/")[0] if parts else ""


@dataclass
class SessionDescription:
    session_name: str = ""
    origin: str = ""
    connection: str = ""
    control: str = "*"
    attributes: dict[str, str] = field(default_factory=dict)
    streams: list[StreamInfo] = field(default_factory=list)
    raw: str = ""


def parse(text: str | bytes) -> SessionDescription:
    if isinstance(text, bytes):
        text = text.decode("utf-8", "replace")
    sd = SessionDescription(raw=text)
    cur: StreamInfo | None = None
    ordinal = 0
    for line in text.replace("\r\n", "\n").split("\n"):
        line = line.strip()
        if len(line) < 2 or line[1] != "=":
            continue
        kind, val = line[0], line[2:]
        if kind == "m":
            parts = val.split()
            cur = StreamInfo()
            ordinal += 1
            cur.track_id = ordinal
            if parts:
                cur.media_type = parts[0] if parts[0] in (VIDEO, AUDIO) else OTHER
            if len(parts) >= 2:
                try:
                    cur.port = int(parts[1].split("/")[0])
                except ValueError:
                    pass
            if len(parts) >= 4:
                try:
                    cur.payload_type = int(parts[3])
                except ValueError:
                    pass
            sd.streams.append(cur)
        elif kind == "s":
            sd.session_name = val
        elif kind == "o":
            sd.origin = val
        elif kind == "c":
            if cur is None:
                sd.connection = val
            else:
                cur.connection = val
        elif kind == "a":
            name, _, aval = val.partition(":")
            if cur is None:
                if name == "control":
                    sd.control = aval
                else:
                    sd.attributes[name] = aval
                continue
            if name == "control":
                cur.control = aval
                # accept trackID=N / streamid=N
                low = aval.lower()
                for pref in ("trackid=", "streamid="):
                    if pref in low:
                        try:
                            cur.track_id = int(low.split(pref)[1].split()[0])
                        except ValueError:
                            pass
            elif name == "rtpmap":
                # rtpmap:<pt> <name>/<clock>[/<chans>]
                try:
                    pt, rest = aval.split(None, 1)
                    if int(pt) == cur.payload_type or not cur.payload_name:
                        cur.payload_name = rest
                        cur.codec = rest.split("/")[0].upper()
                        bits = rest.split("/")
                        if len(bits) >= 2:
                            cur.clock_rate = int(bits[1])
                except (ValueError, IndexError):
                    pass
            elif name == "fmtp":
                cur.fmtp = aval
            else:
                cur.attributes[name] = aval
    # default codecs for static payload types
    for s in sd.streams:
        if not s.codec:
            s.codec = {0: "PCMU", 8: "PCMA", 14: "MPA", 26: "JPEG",
                       32: "MPV", 33: "MP2T"}.get(s.payload_type, "")
    return sd


def build(sd: SessionDescription, *, server_ip: str = "0.0.0.0",
          session_id: int = 0) -> str:
    """Serialize a DESCRIBE answer in the v/o/s/c/t/a line order."""
    lines = [
        "v=0",
        sd.origin and f"o={sd.origin}"
        or f"o=- {session_id} {session_id} IN IP4 {server_ip}",
        f"s={sd.session_name or 'easydarwin_tpu'}",
        f"c={sd.connection or f'IN IP4 {server_ip}'}",
        "t=0 0",
        f"a=control:{sd.control or '*'}",
    ]
    for name, aval in sd.attributes.items():
        lines.append(f"a={name}:{aval}" if aval else f"a={name}")
    for i, s in enumerate(sd.streams, start=1):
        lines.append(f"m={s.media_type} 0 RTP/AVP {s.payload_type}")
        if s.payload_name:
            lines.append(f"a=rtpmap:{s.payload_type} {s.payload_name}")
        if s.fmtp:
            lines.append(f"a=fmtp:{s.fmtp}")
        lines.append(f"a=control:trackID={s.track_id or i}")
        for name, aval in s.attributes.items():
            lines.append(f"a={name}:{aval}" if aval else f"a={name}")
    return "\r\n".join(lines) + "\r\n"


class SdpCache:
    """Path → SDP text of pushed sessions (what DESCRIBE answers from)."""

    def __init__(self):
        self._map: dict[str, str] = {}

    def set(self, path: str, sdp: str) -> None:
        self._map[_norm(path)] = sdp

    def get(self, path: str) -> str | None:
        return self._map.get(_norm(path))

    def pop(self, path: str) -> None:
        self._map.pop(_norm(path), None)


def _norm(path: str) -> str:
    if path.endswith(".sdp"):
        path = path[:-4]
    return path.rstrip("/")
