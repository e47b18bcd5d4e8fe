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
"""

from __future__ import annotations

import asyncio
import secrets
import sys
import time
import traceback

import torch

from ..protocol import rtcp, rtp_meta, rtsp, sdp
from ..relay.fec import FecConfig, FecOutputState
from ..relay.reliable import ReliableUdpOutput
from ..relay.session import RelaySession, SessionRegistry, now_ms
from .config import ServerConfig
from .transports import InterleavedOutput, SharedUdpEgress, UdpOutput

SERVER_NAME = "easydarwin-tpu-torch/0.1"
ALLOWED = "OPTIONS, DESCRIBE, ANNOUNCE, SETUP, PLAY, RECORD, TEARDOWN"
#: x-RTP-Meta-Info fields the live relay fills: transmit time, sequence
#: number and the media payload (mandatory)
META_SUPPORTED = ("tt", "sq", "md")


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


def negotiate_meta_info(want: str, out) -> dict[str, str]:
    """A SETUP's ``x-RTP-Meta-Info`` request → the reply header granting
    the served fields it names (compressed ids in ``META_SUPPORTED``
    order; ``md`` is never compressed), set on ``out``.  No ``md``, no
    grant: a media stream cannot go without its payload."""
    if not want:
        return {}
    requested = rtp_meta.parse_header(want)
    granted = {f: i for i, f in enumerate(
        f for f in META_SUPPORTED if f in requested)}
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
        # the relay's receiver reports go back on the RTCP channel
        st = self.relay.streams[track_id]
        st.upstream_rtcp = lambda d, c=ch[1]: self.send_interleaved(c, d)
        st.upstream_rtcp_owner = self
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
        extra = negotiate_meta_info(req.headers.get("x-rtp-meta-info", ""),
                                    out)
        srv = self.server
        out, rel = negotiate_retransmit(req.headers.get("x-retransmit", ""),
                                        out, t)
        extra.update(rel)
        extra.update(attach_fec(req.headers.get("x-fec", ""), out, t,
                                srv.device))
        srv.note_player_output(self, out, self.player_tracks.get(track_id))
        self.player_tracks[track_id] = out
        self._reply(rtsp.RtspResponse(200, {"Transport": resp_t.to_header(),
                                            **extra}), req.cseq)

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
        """Pushed media and RTCP (RECORD mode), or a player's RTCP on an
        odd channel."""
        m = self.channel_map.get(pkt.channel)
        if m is not None and self.relay is not None:
            track_id, is_rtcp = m
            self.relay.push(track_id, pkt.data, is_rtcp=is_rtcp)
            self.server.packets_in += 1
            self.server.wake_pump()
        elif self.player_tracks and pkt.channel % 2 == 1:
            self.server.on_client_rtcp(pkt.data, conn=self)

    def send_interleaved(self, channel: int, data: bytes) -> None:
        """Write one ``$``-framed packet on this connection."""
        if not self.writer.is_closing():
            self.writer.write(rtsp.frame_interleaved(channel, data))

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
        self.server.connections.discard(self)
        self.writer.close()


class RtspServer:
    """Listener + connection registry."""

    def __init__(self, config: ServerConfig, registry: SessionRegistry, *,
                 on_pump_wake=None, device: str | torch.device = "cuda"):
        self.config = config
        self.registry = registry
        #: where the FEC tier's parity pass runs
        self.device = torch.device(device)
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
        #: players' RTCP compounds that parsed, and the packets in them
        #: by kind: RR and NADU blocks applied to an output, generic
        #: NACKs and APP packets (each one, acted on or not)
        self.rtcp_in = 0
        self.rtcp_counts = dict.fromkeys(("rr", "nadu", "nack", "app"), 0)
        #: packets APP acks popped from reliable outputs' resend windows
        self.reliable_acks = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, self.config.bind_ip, self.config.rtsp_port)
        self.port = self._server.sockets[0].getsockname()[1]
        self.shared_egress = SharedUdpEgress(self.config.bind_ip,
                                             on_rtcp=self.on_client_rtcp)
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
                        out.on_receiver_report(frac)
                        if out.fec is not None:
                            out.fec.controller.on_receiver_report(frac)
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
        stream.fec.replay_nacked(out, nack.lost_seqs(), now_ms())
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
            if now - conn.last_activity > limit:
                task = asyncio.get_running_loop().create_task(conn.close())
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
                killed += 1
        return killed
