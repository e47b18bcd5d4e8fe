"""RTSP/1.0 grammar: requests, responses, Transport negotiation, $-framing.

The incremental reader (``RtspWireReader``) is sans-IO: feed bytes, receive
a stream of ``RtspRequest`` / ``InterleavedPacket`` / ``RtspResponse``
events.  Bytes on an RTSP TCP connection are either text messages
(CRLFCRLF-terminated, plus a Content-Length body) or ``$``-framed binary
(RTP/RTCP pushed by a RECORD-mode client, or relayed to a player).
"""

from __future__ import annotations

from dataclasses import dataclass, field

RTSP_VERSION = "RTSP/1.0"

METHODS = (
    "OPTIONS", "DESCRIBE", "ANNOUNCE", "SETUP", "PLAY", "PAUSE", "TEARDOWN",
    "RECORD", "GET_PARAMETER", "SET_PARAMETER", "REDIRECT",
)

#: status code → reason phrase
STATUS_PHRASES = {
    200: "OK", 305: "Use Proxy", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    413: "Request Entity Too Large", 453: "Not Enough Bandwidth",
    454: "Session Not Found", 455: "Method Not Valid in This State",
    459: "Aggregate Operation Not Allowed", 461: "Unsupported Transport",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable", 505: "RTSP Version Not Supported",
}


class RtspError(ValueError):
    def __init__(self, status: int, msg: str = ""):
        super().__init__(msg or STATUS_PHRASES.get(status, str(status)))
        self.status = status


@dataclass
class TransportSpec:
    """Parsed Transport header (the first transport-spec only)."""

    protocol: str = "RTP/AVP"          # RTP/AVP | RTP/AVP/UDP | RTP/AVP/TCP
    is_tcp: bool = False
    unicast: bool = True
    mode: str = "PLAY"                 # PLAY | RECORD (mode=receive → RECORD)
    client_port: tuple[int, int] | None = None
    server_port: tuple[int, int] | None = None
    interleaved: tuple[int, int] | None = None
    ssrc: int | None = None

    @classmethod
    def parse(cls, value: str) -> "TransportSpec":
        spec = value.split(",")[0].strip()
        parts = [p.strip() for p in spec.split(";") if p.strip()]
        if not parts:
            raise RtspError(461, "empty Transport header")
        t = cls(protocol=parts[0].upper())
        t.is_tcp = t.protocol.endswith("/TCP")
        for p in parts[1:]:
            key, _, val = p.partition("=")
            key = key.lower()
            if key == "unicast":
                t.unicast = True
            elif key == "multicast":
                t.unicast = False
            elif key == "mode":
                v = val.strip('"').upper()
                t.mode = "RECORD" if v in ("RECORD", "RECEIVE") else "PLAY"
            elif key in ("client_port", "server_port", "interleaved"):
                lo, _, hi = val.partition("-")
                try:
                    pair = (int(lo), int(hi) if hi else int(lo) + 1)
                except ValueError as e:
                    raise RtspError(461, f"bad {key}: {val!r}") from e
                setattr(t, key, pair)
            elif key == "ssrc":
                try:
                    t.ssrc = int(val, 16)
                except ValueError:
                    pass
        return t

    def to_header(self) -> str:
        parts = [self.protocol, "unicast" if self.unicast else "multicast"]
        if self.client_port:
            parts.append(f"client_port={self.client_port[0]}-{self.client_port[1]}")
        if self.server_port:
            parts.append(f"server_port={self.server_port[0]}-{self.server_port[1]}")
        if self.interleaved:
            parts.append(f"interleaved={self.interleaved[0]}-{self.interleaved[1]}")
        if self.ssrc is not None:
            parts.append(f"ssrc={self.ssrc:08X}")
        if self.mode == "RECORD":
            parts.append("mode=record")
        return ";".join(parts)


@dataclass
class RtspRequest:
    method: str
    uri: str
    headers: dict[str, str]            # keys lower-cased
    body: bytes = b""
    version: str = RTSP_VERSION

    @property
    def cseq(self) -> int:
        try:
            return int(self.headers.get("cseq", "0"))
        except ValueError:
            return 0

    @property
    def transport(self) -> TransportSpec | None:
        v = self.headers.get("transport")
        return TransportSpec.parse(v) if v else None

    def path(self) -> str:
        """URI path without scheme/host: rtsp://h:p/live/a.sdp → /live/a.sdp"""
        uri = self.uri
        if "://" in uri:
            rest = uri.split("://", 1)[1]
            slash = rest.find("/")
            uri = rest[slash:] if slash >= 0 else "/"
        return uri.split("?")[0] or "/"

    def to_bytes(self) -> bytes:
        lines = [f"{self.method} {self.uri} {self.version}"]
        for k, v in self.headers.items():
            lines.append(f"{_canon(k)}: {v}")
        if self.body and "content-length" not in self.headers:
            lines.append(f"Content-Length: {len(self.body)}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode() + self.body


@dataclass
class RtspResponse:
    status: int = 200
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    version: str = RTSP_VERSION

    def to_bytes(self) -> bytes:
        phrase = STATUS_PHRASES.get(self.status, "Unknown")
        lines = [f"{self.version} {self.status} {phrase}"]
        for k, v in self.headers.items():
            lines.append(f"{_canon(k)}: {v}")
        if self.body and "content-length" not in {k.lower() for k in self.headers}:
            lines.append(f"Content-Length: {len(self.body)}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode() + self.body

    @classmethod
    def parse(cls, head: bytes, body: bytes = b"") -> "RtspResponse":
        lines = head.decode("utf-8", "replace").split("\r\n")
        first = lines[0].split(None, 2)
        if len(first) < 2 or not first[0].startswith("RTSP/"):
            raise RtspError(400, f"bad status line {lines[0]!r}")
        return cls(status=int(first[1]), headers=_parse_headers(lines[1:]),
                   body=body, version=first[0])


def _canon(key: str) -> str:
    special = {"cseq": "CSeq", "rtp-info": "RTP-Info",
               "content-length": "Content-Length",
               "content-type": "Content-Type", "content-base": "Content-Base"}
    return special.get(key.lower()) or "-".join(
        w.capitalize() for w in key.split("-"))


def _parse_headers(lines: list[str]) -> dict[str, str]:
    headers: dict[str, str] = {}
    for line in lines:
        name, sep, val = line.partition(":")
        if sep:
            headers[name.strip().lower()] = val.strip()
    return headers


@dataclass
class InterleavedPacket:
    """One $-framed binary chunk from an RTSP/TCP connection."""

    channel: int
    data: bytes


def frame_interleaved(channel: int, data: bytes) -> bytes:
    """Build a $-framed interleaved chunk (RFC 2326 §10.12)."""
    return b"$" + bytes((channel,)) + len(data).to_bytes(2, "big") + data


class RtspWireReader:
    """Incremental RTSP stream reader with interleaved-data demux.

    ``feed()`` buffers; ``events()`` yields completed ``RtspRequest`` /
    ``InterleavedPacket`` (and, with ``parse_responses``, ``RtspResponse``)
    objects."""

    MAX_HEADER = 64 * 1024
    MAX_BODY = 8 * 1024 * 1024

    def __init__(self, parse_responses: bool = False):
        self._buf = bytearray()
        self._parse_responses = parse_responses

    def feed(self, data: bytes) -> None:
        self._buf += data

    def events(self):
        while True:
            ev = self._next()
            if ev is None:
                return
            yield ev

    def _next(self):
        buf = self._buf
        if not buf:
            return None
        if buf[0] == 0x24:  # '$'
            if len(buf) < 4:
                return None
            length = int.from_bytes(buf[2:4], "big")
            if len(buf) < 4 + length:
                return None
            pkt = InterleavedPacket(buf[1], bytes(buf[4:4 + length]))
            del buf[:4 + length]
            return pkt
        # stray CRLF between messages is legal; the next byte may start a
        # '$' frame, so re-dispatch after skipping it
        if buf[:2] == b"\r\n":
            while buf[:2] == b"\r\n":
                del buf[:2]
            return self._next()
        end = buf.find(b"\r\n\r\n")
        if end < 0:
            if len(buf) > self.MAX_HEADER:
                raise RtspError(413, "header too large")
            return None
        head = bytes(buf[:end])
        headers = _parse_headers(head.decode("utf-8", "replace").split("\r\n")[1:])
        try:
            clen = int(headers.get("content-length", "0"))
        except ValueError:
            clen = 0
        if clen < 0 or clen > self.MAX_BODY:
            raise RtspError(413, "body too large")
        total = end + 4 + clen
        if len(buf) < total:
            return None
        body = bytes(buf[end + 4:total])
        del buf[:total]
        first = head.split(b"\r\n", 1)[0].decode("utf-8", "replace")
        if self._parse_responses and first.startswith("RTSP/"):
            return RtspResponse.parse(head, body)
        parts = first.split(None, 2)
        if len(parts) != 3:
            raise RtspError(400, f"bad request line {first!r}")
        method, uri, version = parts
        if method not in METHODS:
            raise RtspError(501, f"unknown method {method!r}")
        return RtspRequest(method=method, uri=uri, headers=headers, body=body,
                           version=version)
