"""The RTSP session layer of the live relay.

One asyncio task per connection.  A connection is a *pusher*
(ANNOUNCE → SETUP mode=record → RECORD, then ``$``-framed RTP on the
negotiated channels), a *player* (DESCRIBE → SETUP → PLAY), or a plain
control connection.  Methods: OPTIONS, DESCRIBE, ANNOUNCE, SETUP, RECORD,
PLAY, TEARDOWN.  A player's SETUP takes interleaved transport
(``RTP/AVP/TCP;interleaved=a-b``: relayed RTP comes back ``$``-framed on
the connection) or UDP (``RTP/AVP;unicast;client_port=a-b``: relayed RTP
goes to the client's ports from the server's shared egress pair, whose
ports the reply names as ``server_port``).  Pushers send interleaved.

A player's RTSP connection is silent while it plays, so RTCP keeps it
alive: a datagram on the shared pair's RTCP port that parses as RTCP
refreshes the idle clock of the connection whose UDP track registered its
source address, or whose output SSRC an RR report block names.
"""

from __future__ import annotations

import asyncio
import secrets
import sys
import time
import traceback

from ..protocol import rtcp, rtsp, sdp
from ..relay.session import RelaySession, SessionRegistry
from .config import ServerConfig
from .transports import InterleavedOutput, SharedUdpEgress, UdpOutput

SERVER_NAME = "easydarwin-tpu-torch/0.1"
ALLOWED = "OPTIONS, DESCRIBE, ANNOUNCE, SETUP, PLAY, RECORD, TEARDOWN"


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


def _rtcp_keys(out) -> list[tuple]:
    """What proves a player's RTCP is its own: its output's SSRC, and a
    UDP output's registered RTCP address."""
    keys = [("ssrc", out.rewrite.ssrc)]
    if isinstance(out, UdpOutput):
        keys.append(("addr", out.rtcp_addr))
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
        self.last_activity = time.monotonic()
        self.closed = False

    # ------------------------------------------------------------------ io
    async def run(self) -> None:
        try:
            while not self.closed:
                data = await self.reader.read(65536)
                if not data:
                    break
                self.last_activity = time.monotonic()
                self.wire.feed(data)
                for ev in self.wire.events():
                    if isinstance(ev, rtsp.InterleavedPacket):
                        self._on_interleaved(ev)
                    else:
                        await self._dispatch(ev)
        except ConnectionError:
            pass
        except rtsp.RtspError as e:
            self._reply(rtsp.RtspResponse(e.status), cseq=0)
        except Exception:
            # one connection's bug must not take the server down; leave
            # the traceback where an operator reads it
            traceback.print_exc(file=sys.stderr)
        finally:
            await self.close()

    def _reply(self, resp: rtsp.RtspResponse, cseq: int) -> None:
        resp.headers.setdefault("CSeq", str(cseq))
        resp.headers.setdefault("Server", SERVER_NAME)
        if self.session_id:
            resp.headers.setdefault("Session", self.session_id)
        if not self.writer.is_closing():
            self.writer.write(resp.to_bytes())

    # ----------------------------------------------------------- dispatch
    async def _dispatch(self, req: rtsp.RtspRequest) -> None:
        handler = getattr(self, f"_do_{req.method.lower()}", None)
        if handler is None:
            self._reply(rtsp.RtspResponse(501), req.cseq)
            return
        try:
            await handler(req)
        except rtsp.RtspError as e:
            self._reply(rtsp.RtspResponse(e.status), req.cseq)

    async def _do_options(self, req: rtsp.RtspRequest) -> None:
        self._reply(rtsp.RtspResponse(200, {"Public": ALLOWED}), req.cseq)

    async def _do_describe(self, req: rtsp.RtspRequest) -> None:
        path = req.path()
        text = self.server.registry.sdp_cache.get(path)
        if text is None:
            raise rtsp.RtspError(404)
        self.path = sdp._norm(path)
        self._reply(rtsp.RtspResponse(200, {
            "Content-Type": "application/sdp",
            "Content-Base": req.uri.rstrip("/") + "/",
        }, text.encode()), req.cseq)

    async def _do_announce(self, req: rtsp.RtspRequest) -> None:
        if not req.body:
            raise rtsp.RtspError(400, "ANNOUNCE without SDP")
        self.relay = self.server.registry.find_or_create(
            req.path(), req.body.decode("utf-8", "replace"))
        self.relay.owner = self         # ANNOUNCE takes ownership
        self.path = self.relay.path
        self.is_pusher = True
        self._reply(rtsp.RtspResponse(200), req.cseq)

    async def _do_setup(self, req: rtsp.RtspRequest) -> None:
        t = req.transport
        if t is None:
            raise rtsp.RtspError(461)
        record = t.mode == "RECORD" or self.is_pusher
        if not t.is_tcp and (record or not t.client_port):
            raise rtsp.RtspError(461, "UDP needs client_port, and pushers "
                                      "send interleaved")
        base, track_id = _extract_track(req.path())
        if self.session_id is None:
            self.session_id = secrets.token_hex(8)
        if record:
            self._setup_record(req, track_id, t)
        else:
            await self._setup_play(req, base, track_id, t)

    def _setup_record(self, req, track_id, t) -> None:
        if self.relay is None:
            raise rtsp.RtspError(455, "SETUP record before ANNOUNCE")
        if track_id is None or track_id not in self.relay.streams:
            raise rtsp.RtspError(404, f"unknown track {track_id}")
        n = len({tid for tid, _ in self.channel_map.values()})
        ch = t.interleaved or (2 * n, 2 * n + 1)
        self.channel_map[ch[0]] = (track_id, False)
        self.channel_map[ch[1]] = (track_id, True)
        resp_t = rtsp.TransportSpec(protocol=t.protocol, is_tcp=True,
                                    mode="RECORD", interleaved=ch)
        self._reply(rtsp.RtspResponse(200, {"Transport": resp_t.to_header()}),
                    req.cseq)

    async def _setup_play(self, req, base, track_id, t) -> None:
        relay = self.server.registry.find(base)
        if relay is None:
            raise rtsp.RtspError(404)
        self.relay = relay
        self.path = relay.path
        if track_id is None:
            free = sorted(set(relay.streams) - set(self.player_tracks))
            track_id = free[0] if free else None
        if track_id is None or track_id not in relay.streams:
            raise rtsp.RtspError(404, f"unknown track {track_id}")
        rewrite = dict(ssrc=secrets.randbits(32),
                       out_seq_start=secrets.randbits(16),
                       out_ts_start=secrets.randbits(32))
        resp_t = rtsp.TransportSpec(protocol=t.protocol, is_tcp=t.is_tcp,
                                    ssrc=rewrite["ssrc"])
        if t.is_tcp:
            n = len(self.player_tracks)
            ch = t.interleaved or (2 * n, 2 * n + 1)
            out = InterleavedOutput(self.writer.transport, ch[0], ch[1],
                                    **rewrite)
            resp_t.interleaved = ch
        else:
            sender = self.server.shared_egress
            if sender is None:
                raise rtsp.RtspError(503, "the UDP egress is not started")
            out = UdpOutput(sender, self.writer.get_extra_info("peername")[0],
                            *t.client_port, **rewrite)
            resp_t.client_port = t.client_port
            resp_t.server_port = (sender.rtp_port, sender.rtcp_port)
        self.server.note_player_output(self, out,
                                       self.player_tracks.get(track_id))
        self.player_tracks[track_id] = out
        self._reply(rtsp.RtspResponse(200, {"Transport": resp_t.to_header()}),
                    req.cseq)

    async def _do_record(self, req: rtsp.RtspRequest) -> None:
        if not self.is_pusher or self.relay is None:
            raise rtsp.RtspError(455)
        self._reply(rtsp.RtspResponse(200), req.cseq)

    async def _do_play(self, req: rtsp.RtspRequest) -> None:
        if self.relay is None or not self.player_tracks:
            raise rtsp.RtspError(455)
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

    async def _do_teardown(self, req: rtsp.RtspRequest) -> None:
        self._reply(rtsp.RtspResponse(200), req.cseq)
        await self.close()

    # -------------------------------------------------------- media path
    def _on_interleaved(self, pkt: rtsp.InterleavedPacket) -> None:
        """Pushed media (RECORD mode); a player's RTCP is read and dropped
        (receiver-report handling is later work)."""
        m = self.channel_map.get(pkt.channel)
        if m is None or self.relay is None:
            return
        track_id, is_rtcp = m
        self.relay.push(track_id, pkt.data, is_rtcp=is_rtcp)
        self.server.packets_in += 1
        self.server.wake_pump()

    # ----------------------------------------------------------- teardown
    async def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self.relay is not None:
            for tid, out in self.player_tracks.items():
                st = self.relay.streams.get(tid)
                if st is not None:
                    st.remove_output(out)
                self.server.drop_player_output(self, out)
            # pusher gone → tear the session down, if it is still ours
            if (self.is_pusher and self.relay.owner is self
                    and self.server.registry.find(self.relay.path)
                    is self.relay):
                self.server.registry.remove(self.relay.path)
            self.relay = None
        self.server.connections.discard(self)
        self.writer.close()


class RtspServer:
    """Listener + connection registry."""

    def __init__(self, config: ServerConfig, registry: SessionRegistry, *,
                 on_pump_wake=None):
        self.config = config
        self.registry = registry
        self.connections: set[RtspConnection] = set()
        self.packets_in = 0
        self._on_pump_wake = on_pump_wake
        self._server: asyncio.AbstractServer | None = None
        self._tasks: set[asyncio.Task] = set()
        self.port: int | None = None
        #: the UDP players' shared egress pair (None until start)
        self.shared_egress: SharedUdpEgress | None = None
        #: ("ssrc", n) / ("addr", (ip, port)) → the player connection whose
        #: RTCP that proves (``_rtcp_keys``)
        self._rtcp_owner: dict[tuple, RtspConnection] = {}
        #: datagrams on the RTCP port that parsed as RTCP
        self.rtcp_in = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, self.config.bind_ip, self.config.rtsp_port)
        self.port = self._server.sockets[0].getsockname()[1]
        self.shared_egress = SharedUdpEgress(self.config.bind_ip,
                                             on_rtcp=self.on_player_rtcp)
        await self.shared_egress.start()

    async def stop(self) -> None:
        for conn in list(self.connections):
            await conn.close()
        if self.shared_egress is not None:
            self.shared_egress.close()
            self.shared_egress = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _on_connection(self, reader, writer) -> None:
        if len(self.connections) >= self.config.max_connections:
            writer.close()
            return
        conn = RtspConnection(self, reader, writer)
        self.connections.add(conn)
        await conn.run()

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

    def on_player_rtcp(self, data: bytes, addr) -> None:
        """Incoming RTCP on the shared pair: refresh the idle clock of the
        connection that registered ``addr``, and of each whose output SSRC
        an RR report block names.  A datagram that is not RTCP proves
        nothing."""
        ssrcs = rtcp.rr_report_ssrcs(data)
        if ssrcs is None:
            return
        self.rtcp_in += 1
        keys = [("addr", (addr[0], addr[1]))] + [("ssrc", s) for s in ssrcs]
        now = time.monotonic()
        for key in keys:
            conn = self._rtcp_owner.get(key)
            if conn is not None:
                conn.last_activity = now

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
            if now - conn.last_activity > limit:
                task = asyncio.get_running_loop().create_task(conn.close())
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
                killed += 1
        return killed
