"""The RTSP session layer of the live relay.

One asyncio task per connection.  A connection is a *pusher*
(ANNOUNCE → SETUP mode=record → RECORD, then RTP ``$``-framed on the
negotiated channels, or as datagrams to the server port pair its SETUP
got), a *player* (DESCRIBE → SETUP → PLAY), or a plain control
connection.  Methods: OPTIONS, DESCRIBE, ANNOUNCE, SETUP, RECORD,
PLAY, PAUSE, TEARDOWN.  A player's SETUP takes interleaved transport
(``RTP/AVP/TCP;interleaved=a-b``: relayed RTP comes back ``$``-framed on
the connection) or UDP (``RTP/AVP;unicast;client_port=a-b``: relayed RTP
goes to the client's ports from the server's shared egress pair, whose
ports the reply names as ``server_port``).

A pusher's SETUP takes interleaved transport or UDP
(``RTP/AVP;unicast;client_port=a-b;mode=record``): the track gets a port
pair of its own from the server's pool, named in the reply as
``server_port``.  With ``ServerConfig.native_ingest`` (and the egress
core built) its RTP socket is drained in recvmmsg batches straight into
the ring (``RelaySession.drain_native``), else one datagram at a time.
Its RTCP goes to the stream's RTCP ring, and the first one's source
address becomes the stream's upstream-RTCP writer, so the relay's RRs
reach the pusher.  A UDP SETUP without ``client_port`` gets 461.

A player's SETUP may ask for ``x-RTP-Meta-Info`` (``tt``, ``sq`` and the
mandatory ``md`` are served): the reply grants the fields and the output
wraps every packet.  A pusher's interleaved SETUP installs the stream's
upstream-RTCP writer on its RTCP channel, for the relay's RRs.

A UDP player's SETUP may also ask for one of two loss tiers.
``x-FEC: parity`` arms the FEC tier (``relay.fec``: parity windows whose
overhead follows the player's RRs, and generic-NACK → RTX replay from the
ring); the reply grants ``parity;pt=<fec pt>;rtx-pt=<rtx pt>``.
``x-Retransmit: our-retransmit[;window=KB]`` wraps the output in the
resend window (``relay.reliable.ReliableUdpOutput``) and echoes the
header.  A reliable or meta-info output gets no FEC; TCP gets neither.

A path no pusher serves is looked up as a file under the movie folder
(``vod.session.VodService``): DESCRIBE answers the file's SDP, SETUP makes
the player's outputs (x-RTP-Meta-Info may also ask for ``pp``, ``ft`` and
``pn``; x-Retransmit is offered, x-FEC is not: a NACK resolves through a
relay stream, which a file session does not have) and PLAY (``Range:
npt=a-``, ``Scale``, ``Speed``; a negative or out-of-range value plays at
1 and says so) starts a paced session: on the group pacer
(``VodPacerGroup``, the cache-fed hot path) when the server has one and
the session has neither Scale nor meta-info, else a ``FileSession``.
PAUSE stops it; a later PLAY with a Range starts afresh from there.

With DVR on (``RtspServer.dvr``, a ``DvrManager``), RECORD arms the
session's spillers.  A live PLAY with a numeric ``Range: npt=a-`` (a
rewind) or after a PAUSE enters a ``TimeShiftSession`` (``Speed`` paces
it, and a replay faster than real time catches up and rejoins the live
stream with the same SSRC and a contiguous seq); ``npt=now-`` or no
Range joins the live edge.  PAUSE on a live path with an armed spiller
latches each output's bookmark (the next id it has not been sent) as the
resume cursor, and on a time-shift session its ``pause_ids``.
DESCRIBE, SETUP and PLAY of ``<path>.dvr`` replay the spilled asset
(the stored push SDP; no x-RTP-Meta-Info, no x-FEC; x-Retransmit is
offered), and a PLAY without a Range after a PAUSE resumes at the
latched cursors.

A player's RTCP (a datagram on the shared pair's RTCP port, or an odd
interleaved channel of its connection) goes to ``on_client_rtcp``: routed
by its source address, then by the SSRCs its RR report blocks and NADU
blocks name, an RR's loss fraction and a NADU block's buffer state move
that output's thinning level and, for a FEC output, its parity overhead.
A generic NACK naming a FEC output (or arriving from its registered
address) is replayed as RTX; an APP ack goes to the reliable output of
its source address or SSRC, or to the connection's one reliable output.
A player's RTSP connection is silent while it plays, so that RTCP also
keeps it alive, but only on proof of ownership: the source address a UDP
track registered, a block naming an output SSRC of the connection, a
NACK a FEC output acted on, an APP routed by address or SSRC to a
reliable output, or a fallback ack that popped a packet from the window.

HTTP on the RTSP port: a connection whose first bytes are ``GET `` or
``POST`` never reaches the RTSP reader.  A GET and a POST that carry one
``x-sessioncookie`` are the two halves of an RTSP-over-HTTP tunnel: the
GET half answers ``application/x-rtsp-tunnelled`` and then carries every
RTSP reply and every ``$``-framed packet (a tunneled player's output is
an ``InterleavedOutput`` on its writer, so it takes the engine's framed
writev like any interleaved player); the POST half's body is base64 RTSP
(partial quads kept across reads), decoded into the GET half's reader.
A POST whose GET half is not there answers 404.  Any other GET goes to
the server's ``http_get_handler`` (icy MP3, ``server.mp3``), and 404
when it takes nothing.

With RTSP auth on (``RtspServer.auth``, a ``server.auth.AuthService``),
DESCRIBE, SETUP, ANNOUNCE, PLAY and RECORD of a protected path are
answered 401 with ``WWW-Authenticate`` until the request carries valid
credentials.  ``max_connections_per_ip`` closes a connection past the
cap before it costs a task; every close gives the slot back.  When a
player's or pusher's connection closes, the access log gets its W3C
line.  DESCRIBE and SETUP look a path up as a live session, then a
``.sdp`` broadcast under the movie folder (``relay.source``, opened at
SETUP), then a file, then a ``.dvr`` asset.

Modules (``server.modules``, ``RtspServer.modules``) see every request
as the reference's role arrays do: the filter role may answer it, the
route role sees it, the authorize role may refuse it (403) after RTSP
auth, the postprocess role sees its reply, the incoming-RTP role sees
each pushed interleaved packet and the session-closing role each close.

Observability (``obs``): each connection carries a trace id (an ANNOUNCE
gives it to the session it feeds, a pusher adopting a live session takes
the session's); each request is an ``rtsp.<method>`` span, the media
lifecycle methods and SETUP emit their events, and the first SETUP
registers the session with the flight recorder, which a close for a
protocol error, an exception or an idle timeout dumps (any other close
discards it).  GET_PARAMETER with an ``x-freshness`` body answers the
stream's freshness chain (``obs.fleet``) as JSON.  Each RR report block
sets the stream's ``qos_*`` gauges.

Resilience (``resilience``): while a fault plan with ``rr_loss_spoof``
is armed, every RR report block's loss fraction is replaced by the
plan's before it reaches the output's controllers; an RTX give-up of
the FEC tier calls ``RtspServer.on_rtx_giveup(path)`` (the server
charges it to the degradation ladder).  With the checkpoint on, the
server sets ``tcp_restore``: an interleaved SETUP that carries a
``Session`` id of the previous process resumes that session's parked
``kind=tcp`` record, so the player keeps its SSRC and its framed seq
continues without a gap (``ckpt.tcp_reattach``).

The cluster (set by the server when a cluster runs): ``describe_fallback``
answers a DESCRIBE no local source serves (the cluster pulls the path
from its owner); ``admission`` gates a session's FIRST play SETUP
(``(path, client_key) -> None | (action, url)``: 305 with a ``Location``
to redirect, 453 to refuse; plain local-file VOD is exempt, since no
peer can serve this node's movie folder); ``peer_trace_gate`` decides
whether a request's ``X-Trace-Id`` is adopted (``(X-Cluster-Node, client
ip) -> bool``: a live peer's pull joins the stream's trace).  The
redirect's spread key is the client's ``ip:port``.
"""

from __future__ import annotations

import asyncio
import base64
import json
import secrets
import sys
import time
import traceback

import torch

from ..obs import EVENTS, FLIGHT, TRACER
from ..protocol import rtcp, rtp_meta, rtsp, sdp
from ..relay import quality as quality_mod
from ..relay.fec import FecConfig, FecOutputState, drop_overhead_gauge
from ..relay.reliable import ReliableUdpOutput
from ..relay.session import RelaySession, SessionRegistry, now_ms
from ..resilience.inject import INJECTOR
from ..utils.client import hexish
from ..utils.logs import AccessRecord
from ..vod.session import FileSession
from .config import ServerConfig
from .modules import ModuleRegistry
from .transports import (InterleavedOutput, SharedUdpEgress, UdpOutput,
                         UdpPair, UdpPortPool)

SERVER_NAME = "easydarwin-tpu-torch/0.1"
#: media lifecycle methods whose status the dispatcher emits as an event
#: (SETUP emits its own, richer one)
EVENT_METHODS = frozenset(("ANNOUNCE", "PLAY", "RECORD", "PAUSE",
                           "TEARDOWN"))
ALLOWED = ("OPTIONS, DESCRIBE, ANNOUNCE, SETUP, PLAY, PAUSE, RECORD, "
           "TEARDOWN, GET_PARAMETER, SET_PARAMETER")
#: x-RTP-Meta-Info fields the live relay fills: transmit time, sequence
#: number and the media payload (mandatory)
META_SUPPORTED = ("tt", "sq", "md")
#: a file session adds the packet's file position, the frame type and the
#: packet number from its sample tables
META_SUPPORTED_VOD = ("pp", "tt", "ft", "pn", "sq", "md")
#: the requests the auth hook checks
AUTH_METHODS = ("DESCRIBE", "SETUP", "ANNOUNCE", "PLAY", "RECORD")


def _extract_track(uri_path: str) -> tuple[str, int | None]:
    """Split '/live/cam1/trackID=2' → ('/live/cam1', 2).  The track
    component must be exactly ``track<id>``/``trackID=<id>``/
    ``streamid=<id>``."""
    low = uri_path.lower()
    for marker in ("trackid=", "streamid=", "track"):
        pos = low.rfind("/" + marker)
        if pos >= 0:
            tail = uri_path[pos + 1 + len(marker):]
            if tail.isdigit():
                return uri_path[:pos], int(tail)
    return uri_path, None


def negotiate_meta_info(want: str, out,
                        supported=META_SUPPORTED) -> dict[str, str]:
    """A SETUP's ``x-RTP-Meta-Info`` request → the reply header granting
    the served fields it names (compressed ids in ``supported`` order;
    ``md`` is never compressed), set on ``out``.  No ``md``, no grant: a
    media stream cannot go without its payload."""
    if not want:
        return {}
    requested = rtp_meta.parse_header(want)
    granted = {f: i for i, f in enumerate(
        f for f in supported if f in requested)}
    if "md" not in granted:
        return {}
    granted["md"] = rtp_meta.UNCOMPRESSED
    out.meta_field_ids = granted
    return {"x-RTP-Meta-Info": rtp_meta.build_header(granted)}


def negotiate_retransmit(want: str, out, t):
    """A UDP SETUP's ``x-Retransmit: our-retransmit[;window=KB]`` →
    ``(output, reply headers)``: the output wrapped in the resend window
    and the header echoed.  A TCP transport is never wrapped."""
    if t.is_tcp or "our-retransmit" not in want.lower():
        return out, {}
    window_kb = None
    for part in want.split(";"):
        k, _, v = part.partition("=")
        if k.strip().lower() == "window":
            try:
                window_kb = int(v.strip())
            except ValueError:
                pass
    return (ReliableUdpOutput(out, window_kb=window_kb),
            {"x-Retransmit": want})


def attach_fec(want: str, out, t, device: torch.device) -> dict[str, str]:
    """A UDP SETUP's ``x-FEC: parity`` → the FEC tier state on ``out`` and
    the grant header.  Not for TCP (it does not lose packets), a reliable
    output (its resend window owns its loss) or a meta-info output (parity
    would have to describe the wrapped packets)."""
    if (t.is_tcp or "parity" not in want.lower()
            or isinstance(out, ReliableUdpOutput)
            or out.meta_field_ids is not None):
        return {}
    cfg = FecConfig(device=str(device))
    out.fec = FecOutputState(cfg)
    return {"x-FEC": f"parity;pt={cfg.payload_type}"
                     f";rtx-pt={cfg.rtx_payload_type}"}


def parse_rate(req) -> tuple[float, float, dict[str, str]]:
    """A PLAY's ``Scale`` and ``Speed`` → ``(speed, ts_scale, reply
    headers)``.  Speed (RFC 2326 §12.35) paces delivery; Scale (§12.34)
    paces delivery AND compresses RTP timestamps by the factor.  A value
    outside [0.01, 8] (reverse play included) plays at 1, and the reply
    says so."""
    extra: dict[str, str] = {}
    speed, ts_scale = 1.0, 1.0
    for hdr in ("scale", "speed"):
        v = req.headers.get(hdr, "")
        if not v:
            continue
        try:
            f = float(v)
        except ValueError:
            f = None
        if f is None or not 0.01 <= f <= 8.0:
            extra[hdr.capitalize()] = "1"
            continue
        speed *= f
        if hdr == "scale":
            ts_scale = f
        extra[hdr.capitalize()] = f"{f:g}"
    return speed, ts_scale, extra


def parse_range_npt(req) -> float:
    """A PLAY's ``Range: npt=a-`` start in seconds (0 when absent)."""
    rng = req.headers.get("range", "")
    if rng.startswith("npt="):
        try:
            return float(rng[4:].split("-")[0] or 0.0)
        except ValueError:
            return 0.0
    return 0.0


def parse_range_start(req) -> float | None:
    """The numeric start of a PLAY's ``Range: npt=a-``, or None for a
    missing range or ``npt=now-`` (the live edge, RFC 2326 §3.6)."""
    rng = req.headers.get("range", "")
    if not rng.startswith("npt="):
        return None
    start = rng[4:].split("-")[0].strip()
    if not start or start == "now":
        return None
    try:
        return max(float(start), 0.0)
    except ValueError:
        return None


def parse_speed(req) -> tuple[float, dict[str, str]]:
    """A time-shift PLAY's ``Speed`` (RFC 2326 §12.35: >1 is how a
    shifted viewer reaches the live head).  A value outside [0.01, 8]
    plays at 1 and the reply says so."""
    v = req.headers.get("speed", "")
    if not v:
        return 1.0, {}
    try:
        f = float(v)
    except ValueError:
        f = None
    if f is None or not 0.01 <= f <= 8.0:
        return 1.0, {"Speed": "1"}
    return f, {"Speed": f"{f:g}"}


def _rtcp_keys(out) -> list[tuple]:
    """What proves a player's RTCP is its own: its output's SSRC, and a
    UDP output's registered RTCP address."""
    keys = [("ssrc", out.rewrite.ssrc)]
    addr = getattr(out, "rtcp_addr", None)
    if addr is not None:
        keys.append(("addr", addr))
    return keys


class RtspConnection:
    """One RTSP TCP connection (player, pusher, or control)."""

    def __init__(self, server: "RtspServer", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.wire = rtsp.RtspWireReader()
        self.session_id: str | None = None
        self.path: str | None = None
        self.relay: RelaySession | None = None
        self.is_pusher = False
        #: track id → output (interleaved or UDP) of this player
        self.player_tracks: dict[int, InterleavedOutput | UdpOutput] = {}
        #: interleaved channel → (track_id, is_rtcp) for push ingest
        self.channel_map: dict[int, tuple[int, bool]] = {}
        #: track id → the UDP port pair a pusher sends that track to
        self.pusher_pairs: dict[int, UdpPair] = {}
        #: track id → a UDP player's own port pair (``shared_udp_egress``
        #: off)
        self.player_pairs: dict[int, UdpPair] = {}
        #: the file a VOD player SETUP (an ``Mp4File``), and its playing
        #: session (``FileSession`` or ``PacedVodSession``)
        self.vod_file = None
        self.vod_session = None
        #: the ``<live>.dvr`` path a SETUP landed on (a replay)
        self.dvr_path: str | None = None
        #: resume cursors a track latched by a PAUSE under DVR: the next
        #: PLAY without a Range re-enters the past here
        self.pause_ids: dict[int, int] | None = None
        #: a live or DVR PLAY is in effect (no PAUSE since)
        self.playing = False
        self.last_activity = time.monotonic()
        self.created_at = self.last_activity
        self.closed = False
        peer = writer.get_extra_info("peername") or ("?", 0)
        self.client_ip = peer[0]
        #: ``ip:port``: the admission redirect's spread key (viewers behind
        #: one address still fan over several edges)
        self.client_key = f"{peer[0]}:{peer[1]}"
        #: the last request URI and User-Agent (the access log's)
        self.uri = ""
        self.user_agent = ""
        #: the correlation id of this connection's spans, events and
        #: flight records (stamped on its session and outputs)
        self.trace_id = secrets.token_hex(8)
        #: why the connection died when not by TEARDOWN or EOF (a
        #: protocol error, an exception, the idle sweep): a close with it
        #: set dumps the flight recorder
        self.abnormal_reason: str | None = None
        #: the reply of the request being dispatched
        self._last_response: rtsp.RtspResponse | None = None

    # ------------------------------------------------------------------ io
    async def run(self) -> None:
        try:
            first = await self.reader.read(65536)
            # a GET or POST split before its fourth byte is still HTTP
            while first and len(first) < 4 and (
                    b"GET ".startswith(first) or b"POST".startswith(first)):
                more = await self.reader.read(65536)
                if not more:
                    break
                first += more
            if first.startswith((b"GET ", b"POST")):
                await self._run_http(first)
                return
            data = first
            while data and not self.closed:
                self.last_activity = time.monotonic()
                self.wire.feed(data)
                await self._drain_events()
                data = await self.reader.read(65536)
        except ConnectionError:
            pass
        except rtsp.RtspError as e:
            self._reply(rtsp.RtspResponse(e.status), cseq=0)
            self.abnormal_reason = f"protocol: {e.status}"
        except Exception as e:
            # one connection's bug must not take the server down; leave
            # the traceback where an operator reads it, and a black box
            traceback.print_exc(file=sys.stderr)
            self.server.log_error(f"rtsp connection {self.client_ip}: "
                                  f"{traceback.format_exc(limit=4)}")
            self.abnormal_reason = (f"exception: {type(e).__name__}: "
                                    f"{e}"[:200])
            EVENTS.emit("rtsp.exception", level="error",
                        session_id=self.session_id, stream=self.path,
                        trace_id=self.trace_id,
                        error=f"{type(e).__name__}: {e}"[:200],
                        tb=traceback.format_exc(limit=12)[-2000:])
        finally:
            await self.close()

    async def _drain_events(self) -> None:
        for ev in self.wire.events():
            if isinstance(ev, rtsp.InterleavedPacket):
                self._on_interleaved(ev)
            else:
                await self._dispatch(ev)

    # ------------------------------------------------ HTTP on the RTSP port
    async def _run_http(self, first: bytes) -> None:
        buf = bytearray(first)
        while b"\r\n\r\n" not in buf:
            data = await self.reader.read(65536)
            if not data:
                return
            buf += data
        head_end = buf.index(b"\r\n\r\n")
        lines = bytes(buf[:head_end]).decode("latin-1").split("\r\n")
        rest = bytes(buf[head_end + 4:])
        try:
            method, target, _ver = lines[0].split(None, 2)
        except ValueError:
            return
        headers = {}
        for ln in lines[1:]:
            k, sep, v = ln.partition(":")
            if sep:
                headers[k.strip().lower()] = v.strip()
        cookie = headers.get("x-sessioncookie")
        if method == "GET" and cookie:
            await self._tunnel_get(cookie)
        elif method == "POST" and cookie:
            await self._tunnel_post(cookie, rest)
        elif method == "GET":
            await self.server.handle_http_get(self, target, headers)
        else:
            self.writer.write(b"HTTP/1.0 404 Not Found\r\n\r\n")

    async def _tunnel_get(self, cookie: str) -> None:
        """The data half of a tunnel: answer the preamble and hold the
        connection; every RTSP reply and packet goes out here."""
        self.writer.write(
            b"HTTP/1.0 200 OK\r\nServer: " + SERVER_NAME.encode() +
            b"\r\nConnection: close\r\nCache-Control: no-store\r\n"
            b"Pragma: no-cache\r\n"
            b"Content-Type: application/x-rtsp-tunnelled\r\n\r\n")
        self.server.tunnels[cookie] = self
        self.server.tunnel_counts["opened"] += 1
        try:
            while not self.closed:        # the client sends nothing here
                if not await self.reader.read(4096):
                    break
        finally:
            if self.server.tunnels.get(cookie) is self:
                del self.server.tunnels[cookie]

    async def _tunnel_post(self, cookie: str, initial: bytes) -> None:
        """The command half: base64 RTSP, decoded a whole quad at a time
        into the GET half's reader and run there (its replies go out on
        the GET half)."""
        target = self.server.tunnels.get(cookie)
        if target is None:
            self.server.tunnel_counts["orphan_posts"] += 1
            self.writer.write(b"HTTP/1.0 404 Not Found\r\n\r\n")
            return
        b64 = bytearray()

        async def feed(raw: bytes) -> None:
            b64.extend(c for c in raw if c not in b" \r\n\t")
            n = len(b64) // 4 * 4
            if n:
                decoded = base64.b64decode(bytes(b64[:n]))
                del b64[:n]
                target.last_activity = time.monotonic()
                target.wire.feed(decoded)
                await target._drain_events()

        await feed(initial)
        while not self.closed and not target.closed:
            data = await self.reader.read(65536)
            if not data:
                break
            self.last_activity = time.monotonic()
            await feed(data)

    def _reply(self, resp: rtsp.RtspResponse, cseq: int) -> None:
        resp.headers.setdefault("CSeq", str(cseq))
        resp.headers.setdefault("Server", SERVER_NAME)
        if self.session_id:
            resp.headers.setdefault("Session", self.session_id)
        self._last_response = resp
        if not self.writer.is_closing():
            self.writer.write(resp.to_bytes())

    # ----------------------------------------------------------- dispatch
    def _adopt_peer_trace(self, req: rtsp.RtspRequest) -> None:
        """A cluster peer's pull carries the stream's trace upstream as
        ``X-Trace-Id``; the connection adopts it when the server's gate
        accepts the request's ``X-Cluster-Node`` from this address."""
        tid = req.headers.get("x-trace-id", "").strip()
        if not tid or tid == self.trace_id:
            return
        gate = self.server.peer_trace_gate
        if gate is None or not gate(req.headers.get("x-cluster-node", ""),
                                    self.client_ip):
            return
        if hexish(tid):
            self.trace_id = tid

    async def _dispatch(self, req: rtsp.RtspRequest) -> None:
        self.server.requests += 1
        self._adopt_peer_trace(req)
        handler = getattr(self, f"_do_{req.method.lower()}", None)
        if handler is None:
            self._reply(rtsp.RtspResponse(501), req.cseq)
            return
        if ua := req.headers.get("user-agent"):
            self.user_agent = ua
        if req.uri != "*":
            self.uri = req.uri
        mods = self.server.modules
        filtered = mods.run_filter(self, req)
        if filtered is not None:
            self._reply(filtered, req.cseq)
            return
        mods.run_route(self, req)
        auth = self.server.auth
        if auth is not None and req.method in AUTH_METHODS:
            allowed, _user = auth.authorize(
                req.path(), req.method, req.headers.get("authorization"))
            if not allowed:
                self.server.auth_refused += 1
                self._reply(rtsp.RtspResponse(401, {
                    "WWW-Authenticate": auth.challenge()}), req.cseq)
                return
        if not mods.run_authorize(self, req):
            self._reply(rtsp.RtspResponse(403), req.cseq)
            return
        self._last_response = None
        t0 = TRACER.begin()
        errored = False
        try:
            await handler(req)
        except rtsp.RtspError as e:
            errored = True
            self._reply(rtsp.RtspResponse(e.status), req.cseq)
            EVENTS.emit("rtsp.error", level="warn",
                        session_id=self.session_id, stream=self.path,
                        trace_id=self.trace_id, method=req.method,
                        status=e.status)
        finally:
            TRACER.end(f"rtsp.{req.method.lower()}", t0, cat="rtsp",
                       trace_id=self.trace_id)
        if (not errored and req.method in EVENT_METHODS
                and self._last_response is not None):
            EVENTS.emit(f"rtsp.{req.method.lower()}",
                        session_id=self.session_id, stream=self.path,
                        trace_id=self.trace_id,
                        status=self._last_response.status)
        if self._last_response is not None:
            mods.run_postprocess(self, req, self._last_response)

    async def _do_options(self, req: rtsp.RtspRequest) -> None:
        self._reply(rtsp.RtspResponse(200, {"Public": ALLOWED}), req.cseq)

    async def _do_get_parameter(self, req: rtsp.RtspRequest) -> None:
        """A keep-alive (an empty 200), or with ``x-freshness`` in the
        body the stream's freshness chain, origin hop first, as JSON: the
        hop a downstream relay appends its own stamp to."""
        body = (req.body or b"").decode("utf-8", "replace").lower()
        if "x-freshness" in body:
            from ..obs import fleet
            sess = self.server.registry.find(self.path or req.path())
            if sess is not None:
                chain = fleet.freshness_chain(sess,
                                              self.server.config.server_id)
                self._reply(rtsp.RtspResponse(
                    200, {"Content-Type": "application/json"},
                    json.dumps(chain).encode()), req.cseq)
                return
        self._reply(rtsp.RtspResponse(200), req.cseq)

    async def _do_set_parameter(self, req: rtsp.RtspRequest) -> None:
        self._reply(rtsp.RtspResponse(200), req.cseq)

    async def _do_describe(self, req: rtsp.RtspRequest) -> None:
        path = req.path()
        text = await self.server.describe(path)
        if text is None:
            raise rtsp.RtspError(404)
        self.path = sdp._norm(path)
        extra = {}
        sess = self.server.registry.find(self.path)
        if sess is not None:
            # the stream's trace id, for a pulling relay to serve its
            # replica under (informational: an id grants nothing)
            extra["X-Trace-Id"] = sess.trace_id
        self._reply(rtsp.RtspResponse(200, {
            "Content-Type": "application/sdp",
            "Content-Base": req.uri.rstrip("/") + "/",
            **extra,
        }, text.encode()), req.cseq)

    async def _do_announce(self, req: rtsp.RtspRequest) -> None:
        if not req.body:
            raise rtsp.RtspError(400, "ANNOUNCE without SDP")
        existing = self.server.registry.find(req.path())
        self.relay = self.server.registry.find_or_create(
            req.path(), req.body.decode("utf-8", "replace"))
        self.relay.owner = self         # ANNOUNCE takes ownership
        if existing is self.relay:
            # an adopted session keeps its trace across feeders
            self.trace_id = self.relay.trace_id
        else:
            self.relay.set_trace(self.trace_id)
        self.path = self.relay.path
        self.is_pusher = True
        self._reply(rtsp.RtspResponse(200), req.cseq)

    async def _do_setup(self, req: rtsp.RtspRequest) -> None:
        t = req.transport
        if t is None:
            raise rtsp.RtspError(461)
        record = t.mode == "RECORD" or self.is_pusher
        if not t.is_tcp and not t.client_port:
            raise rtsp.RtspError(461, "UDP needs client_port")
        base, track_id = _extract_track(req.path())
        if self.session_id is None:
            self.session_id = secrets.token_hex(8)
            FLIGHT.register(self.session_id, trace_id=self.trace_id,
                            client_ip=self.client_ip, path=base)
        if record:
            await self._setup_record(req, track_id, t)
        else:
            await self._setup_play(req, base, track_id, t)
        EVENTS.emit("rtsp.setup", session_id=self.session_id,
                    stream=self.path or base, trace_id=self.trace_id,
                    status=self._last_response.status
                    if self._last_response else 0,
                    track=track_id, mode="record" if record else "play")

    async def _setup_record(self, req, track_id, t) -> None:
        if self.relay is None:
            raise rtsp.RtspError(455, "SETUP record before ANNOUNCE")
        if track_id is None or track_id not in self.relay.streams:
            raise rtsp.RtspError(404, f"unknown track {track_id}")
        st = self.relay.streams[track_id]
        if t.is_tcp:
            n = len({tid for tid, _ in self.channel_map.values()})
            ch = t.interleaved or (2 * n, 2 * n + 1)
            self.channel_map[ch[0]] = (track_id, False)
            self.channel_map[ch[1]] = (track_id, True)
            # the relay's receiver reports go back on the RTCP channel
            st.upstream_rtcp = lambda d, c=ch[1]: self.send_interleaved(c, d)
            st.upstream_rtcp_owner = self
            resp_t = rtsp.TransportSpec(protocol=t.protocol, is_tcp=True,
                                        mode="RECORD", interleaved=ch)
        else:
            old = self.pusher_pairs.pop(track_id, None)
            if old is not None:
                old.close()
            pair = await self.server.allocate_pusher_pair(self, track_id)
            self.pusher_pairs[track_id] = pair
            resp_t = rtsp.TransportSpec(
                protocol=t.protocol, is_tcp=False, mode="RECORD",
                client_port=t.client_port,
                server_port=(pair.rtp_port, pair.rtcp_port))
        self._reply(rtsp.RtspResponse(200, {"Transport": resp_t.to_header()}),
                    req.cseq)

    async def _make_output(self, t, rewrite: dict, track_id: int):
        """A player track's output for transport ``t``: interleaved on this
        connection, or UDP: from the shared egress pair, or with
        ``shared_udp_egress`` off from a port pair of the track's own (its
        RTCP port hands the player's reports to ``on_client_rtcp``; the
        pair goes back at TEARDOWN or close, or when the track is SETUP
        again).  Returns ``(output, reply transport)``."""
        resp_t = rtsp.TransportSpec(protocol=t.protocol, is_tcp=t.is_tcp,
                                    ssrc=rewrite["ssrc"])
        if t.is_tcp:
            n = len(self.player_tracks)
            ch = t.interleaved or (2 * n, 2 * n + 1)
            out = InterleavedOutput(self.writer.transport, ch[0], ch[1],
                                    **rewrite)
            resp_t.interleaved = ch
            return out, resp_t
        srv = self.server
        if srv.config.shared_udp_egress:
            sender = srv.shared_egress
            if sender is None:
                raise rtsp.RtspError(503, "the UDP egress is not started")
        else:
            old = self.player_pairs.pop(track_id, None)
            if old is not None:
                old.close()
            sender = await srv.udp_pool.allocate(
                None, lambda d, a: srv.on_client_rtcp(d, a, conn=self))
            self.player_pairs[track_id] = sender
        out = UdpOutput(sender, self.writer.get_extra_info("peername")[0],
                        *t.client_port, **rewrite)
        resp_t.client_port = t.client_port
        resp_t.server_port = (sender.rtp_port, sender.rtcp_port)
        return out, resp_t

    async def _setup_play(self, req, base, track_id, t) -> None:
        srv = self.server
        adm = srv.admission
        if adm is not None and not self.player_tracks:
            is_dvr = srv.dvr is not None and srv.dvr.is_dvr_path(base)
            local_file = (not is_dvr and srv.vod is not None
                          and srv.vod.resolve(base) is not None)
            verdict = None if local_file else adm(base, self.client_key)
            if verdict is not None:
                action, url = verdict
                if action == "redirect" and url:
                    self._reply(rtsp.RtspResponse(305, {"Location": url}),
                                req.cseq)
                    return
                raise rtsp.RtspError(453)
        dvr = srv.dvr
        if (dvr is not None and dvr.is_dvr_path(base)
                and self.vod_file is None):
            await self._setup_play_dvr(req, base, track_id, t)
            return
        relay = await srv.open_for_play(base)
        if relay is None:
            await self._setup_play_vod(req, base, track_id, t)
            return
        self.relay = relay
        self.path = relay.path
        if track_id is None:
            free = sorted(set(relay.streams) - set(self.player_tracks))
            track_id = free[0] if free else None
        if track_id is None or track_id not in relay.streams:
            raise rtsp.RtspError(404, f"unknown track {track_id}")
        out, resp_t = await self._make_output(t, dict(
            ssrc=secrets.randbits(32), out_seq_start=secrets.randbits(16),
            out_ts_start=secrets.randbits(32)), track_id)
        if t.is_tcp:
            self._maybe_readopt_tcp(req, relay.path, track_id, out, resp_t)
        extra = negotiate_meta_info(req.headers.get("x-rtp-meta-info", ""),
                                    out)
        out, rel = negotiate_retransmit(req.headers.get("x-retransmit", ""),
                                        out, t)
        extra.update(rel)
        extra.update(attach_fec(req.headers.get("x-fec", ""), out, t,
                                srv.device))
        out.trace_id = self.trace_id
        out.session_id = self.session_id
        srv.note_player_output(self, out, self.player_tracks.get(track_id))
        self.player_tracks[track_id] = out
        self._reply(rtsp.RtspResponse(200, {"Transport": resp_t.to_header(),
                                            **extra}), req.cseq)

    def _maybe_readopt_tcp(self, req, path, track_id, out, resp_t) -> None:
        """A player re-connecting after a restart presents its old
        ``Session`` id on an interleaved SETUP; when the server parked a
        ``kind=tcp`` checkpoint record for (path, track, session), the
        output takes its rewrite state and sent counters: the same SSRC,
        and the framed seq continues where the old process's wire
        stopped.  No match: a fresh subscriber."""
        hook = self.server.tcp_restore
        sid = (req.headers.get("session") or "").split(";")[0].strip()
        if hook is None or not sid:
            return
        rec = hook(path, track_id, sid)
        if rec is None:
            return
        rw = rec.get("rewrite") or [0, -1, -1, 0, 0]
        out.rewrite.ssrc = int(rw[0])
        out.rewrite.base_src_seq = int(rw[1])
        out.rewrite.base_src_ts = int(rw[2])
        out.rewrite.out_seq_start = int(rw[3])
        out.rewrite.out_ts_start = int(rw[4])
        out.packets_sent = int(rec.get("packets_sent", 0))
        out.bytes_sent = int(rec.get("bytes_sent", 0))
        out.payload_octets = int(rec.get("payload_octets", 0))
        resp_t.ssrc = out.rewrite.ssrc      # Transport echoes the OLD ssrc
        EVENTS.emit("ckpt.tcp_reattach", session_id=self.session_id,
                    stream=path, trace_id=self.trace_id, track=track_id)

    async def _setup_play_vod(self, req, base, track_id, t) -> None:
        """SETUP of a track of a file under the movie folder."""
        if self.vod_file is None:
            vod = self.server.vod
            f = vod.open(base) if vod is not None else None
            if f is None:
                raise rtsp.RtspError(404)
            self.vod_file = f
            self.path = base
        n_tracks = sum(1 for tr in (self.vod_file.video_track(),
                                    self.vod_file.audio_track())
                       if tr is not None)
        if track_id is None:
            track_id = len(self.player_tracks) + 1
        if not 1 <= track_id <= n_tracks:
            raise rtsp.RtspError(404, f"unknown track {track_id}")
        out, resp_t = await self._make_output(t, dict(
            ssrc=secrets.randbits(32), out_seq_start=secrets.randbits(16)),
            track_id)
        extra = negotiate_meta_info(req.headers.get("x-rtp-meta-info", ""),
                                    out, META_SUPPORTED_VOD)
        out, rel = negotiate_retransmit(req.headers.get("x-retransmit", ""),
                                        out, t)
        extra.update(rel)
        # no x-FEC: a NACK is replayed from a relay stream's ring, which a
        # file session does not have
        self.server.note_player_output(self, out,
                                       self.player_tracks.get(track_id))
        self.player_tracks[track_id] = out
        self._reply(rtsp.RtspResponse(200, {"Transport": resp_t.to_header(),
                                            **extra}), req.cseq)

    async def _setup_play_dvr(self, req, base, track_id, t) -> None:
        """SETUP of a track of a ``<live>.dvr`` asset: the spilled
        tracks name the tracks, and the output is an ordinary player
        output the time-shift session fills at PLAY.  No x-RTP-Meta-Info
        (no sample tables) and no x-FEC (no live relay stream)."""
        asset = self.server.dvr.open_asset(base)
        if asset is None:
            raise rtsp.RtspError(404)
        try:
            track_ids = sorted(asset.tracks)
        finally:
            asset.close()
        if track_id is None:
            avail = [i for i in track_ids if i not in self.player_tracks]
            track_id = avail[0] if avail else None
        if track_id is None or track_id not in track_ids:
            raise rtsp.RtspError(404, f"unknown track {track_id}")
        self.dvr_path = sdp._norm(base)
        self.path = self.dvr_path
        out, resp_t = await self._make_output(t, dict(
            ssrc=secrets.randbits(32), out_seq_start=secrets.randbits(16)),
            track_id)
        out, extra = negotiate_retransmit(req.headers.get("x-retransmit", ""),
                                          out, t)
        self.server.note_player_output(self, out,
                                       self.player_tracks.get(track_id))
        self.player_tracks[track_id] = out
        self._reply(rtsp.RtspResponse(200, {"Transport": resp_t.to_header(),
                                            **extra}), req.cseq)

    async def _do_record(self, req: rtsp.RtspRequest) -> None:
        if not self.is_pusher or self.relay is None:
            raise rtsp.RtspError(455)
        if self.server.dvr is not None:
            # every pushed broadcast records from its first full window
            # (a second RECORD does not re-arm)
            self.server.dvr.arm(
                self.relay,
                self.server.registry.sdp_cache.get(self.relay.path) or "")
        self._reply(rtsp.RtspResponse(200), req.cseq)

    async def _do_play(self, req: rtsp.RtspRequest) -> None:
        if self.vod_file is not None:
            self._play_vod(req)
            return
        if self.dvr_path is not None:
            self._play_dvr(req)
            return
        if self.relay is None or not self.player_tracks:
            raise rtsp.RtspError(455)
        # under DVR a numeric Range (a rewind) or a PAUSE's cursors enter
        # the time-shift tier; npt=now- or no Range joins the live edge
        start_npt = parse_range_start(req)
        if (self.server.dvr is not None
                and (start_npt is not None or self.pause_ids)
                and self._play_timeshift(req, start_npt)):
            return
        if self.vod_session is not None:  # a time-shift session ends
            self.vod_session.stop()
            self.vod_session = None
        self.playing = True
        infos = []
        for tid, out in self.player_tracks.items():
            stream = self.relay.streams[tid]
            if out not in stream.outputs:
                stream.add_output(out)
            infos.append(f"url={req.uri.rstrip('/')}/trackID={tid}"
                         f";seq={out.rewrite.out_seq_start}"
                         f";rtptime={out.rewrite.out_ts_start}")
        self.server.wake_pump()
        self._reply(rtsp.RtspResponse(200, {
            "Range": "npt=now-", "RTP-Info": ",".join(infos)}), req.cseq)

    def _play_timeshift(self, req, start_npt: float | None) -> bool:
        """PLAY into the past on a live subscription: the outputs leave
        the live streams and (their rewrites kept) go to a time-shift
        session over the spilled windows.  A Range wins over the PAUSE
        cursors.  False (the caller joins live) when the asset has
        nothing yet."""
        speed, extra = parse_speed(req)
        start_ids = None if start_npt is not None else self.pause_ids
        self._detach_outputs()
        if self.vod_session is not None:
            self.vod_session.stop()
            self.vod_session = None
        sess = self.server.dvr.open_timeshift(
            self.path, dict(self.player_tracks), start_npt=start_npt,
            start_ids=start_ids, speed=speed)
        if sess is None:
            return False
        self._started_shift(req, sess, extra)
        return True

    def _play_dvr(self, req: rtsp.RtspRequest) -> None:
        """PLAY a ``.dvr`` asset: a replay under the shared pacer.  No
        Range after a PAUSE resumes at the latched cursors; a Range
        always wins."""
        if not self.player_tracks:
            raise rtsp.RtspError(455)
        start_npt = parse_range_start(req)
        start_ids = None if start_npt is not None else self.pause_ids
        speed, extra = parse_speed(req)
        if self.vod_session is not None:
            self.vod_session.stop()
            self.vod_session = None
        sess = self.server.dvr.open_timeshift(
            self.dvr_path, dict(self.player_tracks), start_npt=start_npt,
            start_ids=start_ids, speed=speed)
        if sess is None:
            raise rtsp.RtspError(404)
        self._started_shift(req, sess, extra)

    def _started_shift(self, req, sess, extra: dict) -> None:
        self.vod_session = sess
        self.pause_ids = None
        self.playing = True
        self.server.wake_pump()
        infos = ",".join(f"url={req.uri.rstrip('/')}/trackID={tid}"
                         f";seq={out.rewrite.out_seq_start}"
                         for tid, out in self.player_tracks.items())
        self._reply(rtsp.RtspResponse(200, {
            "Range": f"npt={sess.position_npt() or sess.start_npt:.3f}-",
            "RTP-Info": infos, **extra}), req.cseq)

    def _play_vod(self, req: rtsp.RtspRequest) -> None:
        if not self.player_tracks:
            raise rtsp.RtspError(455)
        start_npt = parse_range_npt(req)
        speed, ts_scale, extra = parse_rate(req)
        if self.vod_session is not None:
            self.vod_session.stop()
        outputs = dict(self.player_tracks)
        # hot: the group pacer serves plain-RTP sessions through the cache
        # and the live engine; Scale (compressed timestamps are not an
        # affine offset) and meta-info sessions (ft/pn/pp come from the
        # sample tables mid-send) keep a FileSession
        pacer = self.server.vod_pacer
        if (pacer is not None and ts_scale == 1.0
                and all(o.meta_field_ids is None for o in outputs.values())):
            self.vod_session = pacer.open(self.vod_file, outputs,
                                          start_npt=start_npt, speed=speed,
                                          path=self.path or req.uri)
            self.server.wake_pump()
        else:
            self.vod_session = FileSession(self.vod_file, outputs,
                                           start_npt=start_npt, speed=speed,
                                           ts_scale=ts_scale)
            self.vod_session.start()
        infos = ",".join(f"url={req.uri.rstrip('/')}/trackID={tid}"
                         f";seq={out.rewrite.out_seq_start}"
                         for tid, out in self.player_tracks.items())
        self._reply(rtsp.RtspResponse(200, {
            "Range": f"npt={start_npt:.3f}-", "RTP-Info": infos, **extra}),
            req.cseq)

    async def _do_pause(self, req: rtsp.RtspRequest) -> None:
        """A file session stops (a PLAY starts it afresh); a live player's
        outputs leave their streams until the next PLAY.  A time-shift
        session latches its ``pause_ids``; a live player under an armed
        spiller latches each output's bookmark (the next id it has not
        been sent, in the spill's id space)."""
        sess = self.vod_session
        if sess is not None and hasattr(sess, "pause_ids"):
            self.pause_ids = sess.pause_ids()
        elif (self.relay is not None and self.playing
                and self.server.dvr is not None
                and self.server.dvr.armed(self.path)):
            ids = {tid: int(out.bookmark)
                   for tid, out in self.player_tracks.items()
                   if out.bookmark is not None}
            self.pause_ids = ids or None
        if sess is not None:
            sess.stop()
            self.vod_session = None
        self._detach_outputs()
        self.playing = False
        self._reply(rtsp.RtspResponse(200), req.cseq)

    def _detach_outputs(self) -> None:
        if self.relay is None:
            return
        for tid, out in self.player_tracks.items():
            st = self.relay.streams.get(tid)
            if st is not None:
                st.remove_output(out)

    async def _do_teardown(self, req: rtsp.RtspRequest) -> None:
        self._reply(rtsp.RtspResponse(200), req.cseq)
        await self.close()

    # -------------------------------------------------------- media path
    def _on_interleaved(self, pkt: rtsp.InterleavedPacket) -> None:
        """Pushed media and RTCP (RECORD mode), or a player's RTCP on an
        odd channel."""
        m = self.channel_map.get(pkt.channel)
        if m is not None and self.relay is not None:
            track_id, is_rtcp = m
            if not is_rtcp:
                self.server.modules.run_incoming_rtp(self.relay, track_id,
                                                     pkt.data)
            self.relay.push(track_id, pkt.data, is_rtcp=is_rtcp)
            self.server.packets_in += 1
            self.server.wake_pump()
        elif self.player_tracks and pkt.channel % 2 == 1:
            self.server.on_client_rtcp(pkt.data, conn=self)

    def send_interleaved(self, channel: int, data: bytes) -> None:
        """Write one ``$``-framed packet on this connection."""
        if not self.writer.is_closing():
            self.writer.write(rtsp.frame_interleaved(channel, data))

    def native_rtp_drain(self, track_id: int, fd: int) -> None:
        """A UDP pusher's RTP socket is readable: drain everything pending
        into the ring in recvmmsg batches.  A hard receive error, or a
        track this connection no longer feeds, stops the watch, so a
        socket nobody drains cannot spin the loop; the idle sweep then
        closes the connection."""
        st = self.relay.streams.get(track_id) if self.relay else None
        if st is None:
            asyncio.get_running_loop().remove_reader(fd)
            return
        oversize = st.rtp_ring.total_oversize
        try:
            n = self.relay.drain_native(track_id, fd)
        except OSError:
            asyncio.get_running_loop().remove_reader(fd)
            self.server.ingest["errors"] += 1
            return
        ing = self.server.ingest
        ing["oversize"] += st.rtp_ring.total_oversize - oversize
        if n:
            ing["native_pkts"] += n
            ing["native_batches"] += 1
            self._pushed(n)

    def udp_ingest(self, track_id: int, data: bytes, addr,
                   is_rtcp: bool) -> None:
        """One datagram to a UDP pusher's port pair: RTP (the per-datagram
        path) into the ring, RTCP into the RTCP ring.  The first RTCP
        datagram's source address becomes the stream's upstream-RTCP
        writer."""
        st = self.relay.streams.get(track_id) if self.relay else None
        if st is None:
            return
        if not is_rtcp:
            oversize = st.rtp_ring.total_oversize
            self.relay.push(track_id, data)
            dropped = st.rtp_ring.total_oversize - oversize
            self.server.ingest["oversize"] += dropped
            if not dropped:
                self.server.ingest["datagram_pkts"] += 1
                self._pushed(1)
            return
        self.relay.push(track_id, data, is_rtcp=True)
        pair = self.pusher_pairs.get(track_id)
        if (st.upstream_rtcp is None and pair is not None
                and pair.rtcp_transport is not None):
            st.upstream_rtcp = (lambda d, tr=pair.rtcp_transport, a=addr:
                                tr.sendto(d, a))
            st.upstream_rtcp_owner = self
        self.server.packets_in += 1
        self.server.wake_pump()

    def _pushed(self, n: int) -> None:
        """Media arrived from this pusher: it is alive, and the pump has
        work."""
        self.last_activity = time.monotonic()
        self.server.packets_in += n
        self.server.wake_pump()

    # ----------------------------------------------------------- teardown
    async def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self.session_id is not None:
            EVENTS.emit("rtsp.close", session_id=self.session_id,
                        stream=self.path, trace_id=self.trace_id,
                        level="warn" if self.abnormal_reason else "info",
                        reason=self.abnormal_reason or "eof")
            if self.abnormal_reason and (self.player_tracks
                                         or self.is_pusher):
                FLIGHT.dump(self.session_id, reason=self.abnormal_reason)
            else:
                FLIGHT.discard(self.session_id)
        self.server.modules.run_session_closing(self)
        self.server.on_session_closed(self)
        for pair in (*self.pusher_pairs.values(),
                     *self.player_pairs.values()):
            pair.close()
        self.pusher_pairs.clear()
        self.player_pairs.clear()
        if self.vod_session is not None:
            self.vod_session.stop()
            self.vod_session = None
        if self.vod_file is not None or self.dvr_path is not None:
            if self.vod_file is not None:
                self.vod_file.close()
                self.vod_file = None
            for out in self.player_tracks.values():
                self.server.drop_player_output(self, out)
        if self.relay is not None:
            for tid, out in self.player_tracks.items():
                st = self.relay.streams.get(tid)
                if st is not None:
                    st.remove_output(out)
                self.server.drop_player_output(self, out)
                # a departed player's gauges leave the exposition (a
                # surviving player's next RR or FEC pass sets them again)
                quality_mod.drop_qos(self.path, tid)
                drop_overhead_gauge(self.path, tid)
            if self.is_pusher:
                # our RR writers point at this closing connection; a
                # pusher that adopted the session installed its own
                for st in self.relay.streams.values():
                    if st.upstream_rtcp_owner is self:
                        st.upstream_rtcp = st.upstream_rtcp_owner = None
            # pusher gone → tear the session down, if it is still ours
            if (self.is_pusher and self.relay.owner is self
                    and self.server.registry.find(self.relay.path)
                    is self.relay):
                self.server.registry.remove(self.relay.path)
            self.relay = None
        if self in self.server.connections:
            self.server.connections.discard(self)
            self.server.on_ip_disconnect(self.client_ip)
        self.writer.close()


class RtspServer:
    """Listener + connection registry."""

    def __init__(self, config: ServerConfig, registry: SessionRegistry, *,
                 on_pump_wake=None, device: str | torch.device = "cuda",
                 vod=None, auth=None, access_log=None, error_log=None):
        self.config = config
        self.registry = registry
        #: ``async (path) -> sdp | None`` asked when nothing local serves a
        #: DESCRIBE (the cluster's pull), or None
        self.describe_fallback = None
        #: the cluster's admission gate and peer trace gate (None: every
        #: SETUP admitted, no ``X-Trace-Id`` adopted)
        self.admission = None
        self.peer_trace_gate = None
        #: RTSP auth (``server.auth.AuthService``; None: every path open),
        #: the access log (``utils.logs.AccessLog``; None: off) and the
        #: error log (``utils.logs.ErrorLog``; None: stderr only)
        self.auth = auth
        self.access_log = access_log
        self.error_log = error_log
        #: ``.sdp`` broadcasts (``relay.source.SdpFileRelaySource``)
        self.relay_source = None
        #: an HTTP GET on the RTSP port that is not a tunnel:
        #: ``async (conn, target, headers) -> handled``
        self.http_get_handler = None
        #: RTSP-over-HTTP tunnels: x-sessioncookie → the GET half
        self.tunnels: dict[str, RtspConnection] = {}
        #: GET halves opened, and POST halves that found no GET half
        self.tunnel_counts = {"opened": 0, "orphan_posts": 0}
        #: live connections a client address holds, and connections
        #: refused by the per-IP cap
        self._per_ip: dict[str, int] = {}
        self.per_ip_refused = 0
        #: RTSP requests dispatched, and answered 401 by the auth hook
        self.requests = 0
        self.auth_refused = 0
        #: the file tier (``vod.session.VodService``; None: live only) and
        #: the group pacer of hot file sessions (None: every file session
        #: is a ``FileSession``)
        self.vod = vod
        self.vod_pacer = None
        #: the DVR manager (None: PAUSE detaches, ``.dvr`` paths 404 and
        #: RECORD arms nothing)
        self.dvr = None
        #: where the FEC tier's parity pass runs
        self.device = torch.device(device)
        self.connections: set[RtspConnection] = set()
        #: plugin modules and their role hooks (``server.modules``)
        self.modules = ModuleRegistry()
        self.packets_in = 0
        self._on_pump_wake = on_pump_wake
        self._server: asyncio.AbstractServer | None = None
        self._tasks: set[asyncio.Task] = set()
        self.port: int | None = None
        #: the UDP players' shared egress pair (None until start)
        self.shared_egress: SharedUdpEgress | None = None
        #: UDP pushers' port pairs
        self.udp_pool = UdpPortPool(config.bind_ip)
        #: UDP pushers' RTP: packets and non-empty drains of the native
        #: ingest, datagrams of the per-datagram path, datagrams dropped
        #: as larger than a ring slot, and drains stopped by an error
        self.ingest = dict.fromkeys(("native_pkts", "native_batches",
                                     "datagram_pkts", "oversize", "errors"),
                                    0)
        #: ("ssrc", n) / ("addr", (ip, port)) → the player connection whose
        #: RTCP that proves (``_rtcp_keys``)
        self._rtcp_owner: dict[tuple, RtspConnection] = {}
        #: players' RTCP compounds that parsed, and the packets in them
        #: by kind: RR and NADU blocks applied to an output, generic
        #: NACKs and APP packets (each one, acted on or not)
        self.rtcp_in = 0
        self.rtcp_counts = dict.fromkeys(("rr", "nadu", "nack", "app"), 0)
        #: packets APP acks popped from reliable outputs' resend windows
        self.reliable_acks = 0
        #: the interleaved-TCP checkpoint re-attach hook, set by the
        #: server when the checkpoint is on: ``(path, track_id,
        #: session_id) -> record | None``
        self.tcp_restore = None
        #: ``(path) -> None``, called at each RTX give-up of the FEC tier
        #: (the server charges it to the degradation ladder); None: none
        self.on_rtx_giveup = None
        #: the shared RTCP socket's buffer and drops as they stood at stop
        self._rtcp_socket_final = {"rcvbuf": 0, "drops": -1}

    def rtcp_socket_stats(self) -> dict:
        """The shared RTCP socket's granted receive buffer and the
        datagrams the kernel dropped on it (at ``stop`` once it ran)."""
        if self.shared_egress is not None:
            return self.shared_egress.rtcp_socket_stats()
        return self._rtcp_socket_final

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, self.config.bind_ip, self.config.rtsp_port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.config.shared_udp_egress:
            self.shared_egress = SharedUdpEgress(self.config.bind_ip,
                                                 on_rtcp=self.on_client_rtcp)
            await self.shared_egress.start()

    async def stop(self) -> None:
        for conn in list(self.connections):
            await conn.close()
        if self.shared_egress is not None:
            self._rtcp_socket_final = self.shared_egress.rtcp_socket_stats()
            self.shared_egress.close()
            self.shared_egress = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _on_connection(self, reader, writer) -> None:
        if len(self.connections) >= self.config.max_connections:
            writer.close()
            return
        per_ip = self.config.max_connections_per_ip
        peer = writer.get_extra_info("peername")
        ip = peer[0] if peer else "?"
        if per_ip and self._per_ip.get(ip, 0) >= per_ip:
            self.per_ip_refused += 1
            writer.close()
            return
        conn = RtspConnection(self, reader, writer)
        self.connections.add(conn)
        self._per_ip[ip] = self._per_ip.get(ip, 0) + 1
        await conn.run()

    def on_ip_disconnect(self, ip: str) -> None:
        n = self._per_ip.get(ip, 0) - 1
        if n > 0:
            self._per_ip[ip] = n
        else:
            self._per_ip.pop(ip, None)

    # -- lookup chain, HTTP and the logs -----------------------------------
    async def describe(self, path: str) -> str | None:
        """A path's SDP: a live session's, then an ``.sdp`` broadcast's
        (stripped of its ingest transport), a file's, a ``.dvr`` asset's,
        then the fallback's."""
        text = self.registry.sdp_cache.get(path)
        if text is None and self.relay_source is not None:
            text = await self.relay_source.describe(path)
        if text is None and self.vod is not None:
            text = self.vod.describe(path)
        if text is None and self.dvr is not None:
            text = await self.dvr.describe(path)
        if text is None and self.describe_fallback is not None:
            text = await self.describe_fallback(path)
        return text

    async def open_for_play(self, path: str) -> RelaySession | None:
        """The live session a player SETUP joins: a registered one, or an
        ``.sdp`` broadcast opened now."""
        sess = self.registry.find(path)
        if sess is None and self.relay_source is not None:
            sess = await self.relay_source.open(path)
        return sess

    async def handle_http_get(self, conn: RtspConnection, target: str,
                              headers: dict) -> None:
        if self.http_get_handler is not None \
                and await self.http_get_handler(conn, target, headers):
            return
        conn.writer.write(b"HTTP/1.0 404 Not Found\r\n\r\n")

    def on_session_closed(self, conn: RtspConnection) -> None:
        """A closing player's or pusher's connection → its access-log
        line."""
        if self.access_log is None or (not conn.player_tracks
                                       and not conn.is_pusher):
            return
        outs = conn.player_tracks.values()
        udp = any(not isinstance(o, InterleavedOutput) for o in outs)
        self.access_log.record(AccessRecord(
            client_ip=conn.client_ip, uri=conn.uri or conn.path or "-",
            method="RECORD" if conn.is_pusher else "PLAY",
            duration_sec=time.monotonic() - conn.created_at,
            bytes_sent=sum(o.bytes_sent for o in outs),
            packets_sent=sum(o.packets_sent for o in outs),
            user_agent=conn.user_agent,
            transport="UDP" if udp else "TCP"))

    def log_error(self, message: str) -> None:
        if self.error_log is not None:
            self.error_log.warning(message)

    async def allocate_pusher_pair(self, conn: RtspConnection,
                                   track_id: int) -> UdpPair:
        """A port pair for one track of a UDP pusher: RTP drained natively
        when ``native_ingest`` is on and the egress core is built, else a
        datagram endpoint; RTCP an endpoint either way."""
        from .. import native
        on_rtcp = (lambda d, a, tid=track_id:
                   conn.udp_ingest(tid, d, a, True))
        if self.config.native_ingest and native.available():
            return await self.udp_pool.allocate_native(
                lambda fd, tid=track_id: conn.native_rtp_drain(tid, fd),
                on_rtcp)
        return await self.udp_pool.allocate(
            lambda d, a, tid=track_id: conn.udp_ingest(tid, d, a, False),
            on_rtcp)

    @staticmethod
    def _record_qos(conn, out, frac: float, jitter: int) -> None:
        """One RR block into its stream's ``qos_*`` gauges."""
        if conn is None or conn.relay is None:
            return
        tid = next((t for t, o in conn.player_tracks.items() if o is out),
                   None)
        st = conn.relay.streams.get(tid)
        quality_mod.record_rr_qos(conn.path, tid, frac, jitter,
                                  st.info.clock_rate if st else None)

    def note_player_output(self, conn: RtspConnection, out,
                           replaced=None) -> None:
        """Register a player output's RTCP keys (a re-SETUP of a track
        drops the output it replaces)."""
        if replaced is not None:
            self.drop_player_output(conn, replaced)
        for key in _rtcp_keys(out):
            self._rtcp_owner[key] = conn

    def drop_player_output(self, conn: RtspConnection, out) -> None:
        for key in _rtcp_keys(out):
            if self._rtcp_owner.get(key) is conn:
                del self._rtcp_owner[key]

    def on_client_rtcp(self, data: bytes, addr=None,
                       conn: RtspConnection | None = None) -> None:
        """A player's RTCP compound: from ``addr`` on the shared pair, or
        on ``conn``'s own interleaved channel.  It is routed to the
        connection that registered ``addr`` (or ``conn``), else, block by
        block, to the connection owning the SSRC a block names.  RR and
        NADU blocks move the named output's thinning level
        (``on_receiver_report`` with ``fraction_lost / 256``, ``on_nadu``)
        and a FEC output's parity overhead; a generic NACK replays the
        named FEC output's lost seqs as RTX (``_handle_nack``); an APP ack
        goes to a reliable output (``_route_ack``).  The idle clock of a
        connection is refreshed only on proof (the module docstring)."""
        try:
            pkts = rtcp.parse_compound(data)
        except rtcp.RtcpError:
            return
        self.rtcp_in += 1
        if conn is None and addr is not None:
            conn = self._rtcp_owner.get(("addr", (addr[0], addr[1])))
        proven = {conn} if conn is not None and addr is not None else set()
        #: the output whose registered RTCP address sent this
        addr_out = None
        if conn is not None and addr is not None:
            addr_out = next((o for o in conn.player_tracks.values()
                             if getattr(o, "rtcp_addr", None)
                             == (addr[0], addr[1])), None)

        def output(ssrc: int):
            """(connection, output) whose output SSRC is ``ssrc``."""
            c = conn or self._rtcp_owner.get(("ssrc", ssrc))
            if c is None:
                return None, None
            return c, next((o for o in c.player_tracks.values()
                            if o.rewrite.ssrc == ssrc), None)

        for p in pkts:
            if isinstance(p, rtcp.ReceiverReport):
                for rb in p.reports:
                    c, out = output(rb.ssrc)
                    if out is not None:
                        proven.add(c)
                        self.rtcp_counts["rr"] += 1
                        frac = rb.fraction_lost / 256.0
                        if INJECTOR.active:
                            # the chaos site: drive the loss-fed
                            # controllers without a lossy wire
                            spoof = INJECTOR.rr_loss_spoof()
                            if spoof is not None:
                                frac = spoof
                        out.on_receiver_report(frac)
                        if out.fec is not None:
                            out.fec.controller.on_receiver_report(frac)
                        self._record_qos(c, out, frac, rb.jitter)
            elif isinstance(p, rtcp.Nadu):
                for blk in p.blocks:
                    c, out = output(blk.ssrc)
                    if out is not None:
                        proven.add(c)
                        self.rtcp_counts["nadu"] += 1
                        out.on_nadu(blk.playout_delay_ms,
                                    blk.free_buffer_64b)
                        if out.fec is not None:
                            out.fec.controller.on_nadu(
                                blk.playout_delay_ms, blk.free_buffer_64b)
            elif isinstance(p, rtcp.GenericNack):
                self.rtcp_counts["nack"] += 1
                c, out = output(p.media_ssrc)
                if out is None and addr_out is not None \
                        and addr_out.fec is not None:
                    c, out = conn, addr_out     # routed by source address
                if out is not None and self._handle_nack(c, out, p):
                    proven.add(c)
            elif isinstance(p, rtcp.App):
                self.rtcp_counts["app"] += 1
                c = self._route_ack(p, conn, addr_out, output)
                if c is not None:
                    proven.add(c)
        now = time.monotonic()
        for c in proven:
            c.last_activity = now

    def _route_ack(self, app, conn, addr_out, output):
        """An APP ack to the reliable output it is for: the one of its
        source address, else the one whose SSRC it carries, else the
        connection's only reliable output.  Returns the connection it
        proves (None: none).  A fallback ack proves ownership only if it
        popped a packet from the window: a forged APP with an arbitrary
        SSRC proves nothing."""
        c, owned = output(app.ssrc)
        if addr_out is not None:
            c, target, routed = conn, addr_out, True
        elif owned is not None:
            target, routed = owned, True
        elif conn is not None:
            reliable = [o for o in conn.player_tracks.values()
                        if isinstance(o, ReliableUdpOutput)]
            if len(reliable) != 1:
                return None
            c, target, routed = conn, reliable[0], False
        else:
            return None
        if not isinstance(target, ReliableUdpOutput):
            return None
        matched = target.on_rtcp_app(app)
        self.reliable_acks += matched
        return c if routed or matched else None

    def _handle_nack(self, conn: RtspConnection, out, nack) -> bool:
        """Replay one generic NACK's lost OUTPUT seqs from the ring as RTX
        (``StreamFec.replay_nacked``; an empty token bucket is a counted
        give-up).  True when a FEC output acted on it: the proof of
        ownership (a forged NACK for an unknown SSRC proves nothing)."""
        if out.fec is None or conn.relay is None:
            return False
        tid = next((t for t, o in conn.player_tracks.items() if o is out),
                   None)
        stream = conn.relay.streams.get(tid) if tid is not None else None
        if stream is None or stream.fec is None:
            return False
        stream.fec.replay_nacked(out, nack.lost_seqs(), now_ms(),
                                 on_giveup=self.on_rtx_giveup)
        return True

    def wake_pump(self) -> None:
        if self._on_pump_wake is not None:
            self._on_pump_wake()

    def sweep_timeouts(self) -> int:
        """Close connections idle past their limit; returns how many."""
        now = time.monotonic()
        killed = 0
        for conn in list(self.connections):
            limit = (self.config.push_timeout_sec if conn.is_pusher
                     else self.config.rtsp_timeout_sec)
            idle = now - conn.last_activity
            if idle > limit:
                conn.abnormal_reason = (conn.abnormal_reason
                                        or f"timeout: idle {idle:.1f}s "
                                           f"> {limit}s")
                task = asyncio.get_running_loop().create_task(conn.close())
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
                killed += 1
        return killed
