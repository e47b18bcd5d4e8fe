"""CMS: the central device-management server (the EasyCMS of the
reference platform).

A copy of the reference's ``cluster/cms.py``.  Devices hold a persistent
TCP connection and exchange HTTP-framed EasyProtocol JSON (``_frame``,
``read_framed``) in both directions; clients connect for one-shot
requests.  The handlers: device register (a ``Token`` in the ack),
device list and info, get stream (the least-loaded media server from the
Redis presence records, ``PresenceService.pick_least_loaded``; the
device is told to push there and the client gets the ``rtsp://`` URL),
free stream, PTZ, preset and talkback forwarding to the device, and a
snapshot upload written as a JPEG file under ``snap_dir``.  Every
request carries a ``TraceId`` (the caller's, or one minted here) through
its forwarded request, its ack and its events (``cms.rpc``,
``cms.register``, ``cms.push_stream``).  A device whose keepalive lapsed
past ``device_timeout_sec`` is reaped (``reap``, run by a task every
fifth of the timeout; one ``cms.device_offline`` event each).

It is a library class that a test or a script starts; there is no CLI.
``stop`` closes every connection its handlers hold before it waits for
the listener to close (Python 3.12's ``wait_closed`` waits for them).
"""

from __future__ import annotations

import asyncio
import base64
import os
import secrets
import tempfile
import time
from dataclasses import dataclass, field

from ..obs import EVENTS
from . import protocol as ep
from .presence import PresenceService


def _frame(json_text: str, *, request: bool = True) -> bytes:
    body = json_text.encode()
    head = ("POST /easycms HTTP/1.1\r\n" if request
            else "HTTP/1.1 200 OK\r\n")
    return (f"{head}Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


async def read_framed(reader: asyncio.StreamReader) -> ep.Message | None:
    """One HTTP-framed EasyProtocol message (either direction); None at
    the end of the stream or for a body that is no envelope."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    clen = 0
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"content-length"):
            try:
                clen = int(line.split(b":")[1])
            except ValueError:
                pass
    body = await reader.readexactly(clen) if clen else b""
    try:
        return ep.Message.parse(body)
    except ep.ProtocolError:
        return None


@dataclass
class DeviceRecord:
    serial: str
    name: str = ""
    device_type: str = "camera"
    channels: list[dict] = field(default_factory=list)
    token: str = ""
    writer: asyncio.StreamWriter | None = None
    last_seen: float = field(default_factory=time.time)
    #: channel → the URL it pushes to
    pushing: dict[str, str] = field(default_factory=dict)

    @property
    def online(self) -> bool:
        return self.writer is not None and not self.writer.is_closing()


class CmsServer:
    def __init__(self, redis, *, bind_ip: str = "127.0.0.1", port: int = 0,
                 snap_dir: str | None = None,
                 device_timeout_sec: float = 150.0):
        self.redis = redis
        self.bind_ip = bind_ip
        self.cfg_port = port
        self.snap_dir = snap_dir or os.path.join(tempfile.gettempdir(),
                                                 "edtpu_snaps")
        self.device_timeout_sec = device_timeout_sec
        self.devices: dict[str, DeviceRecord] = {}
        self._server: asyncio.AbstractServer | None = None
        self._reap_task: asyncio.Task | None = None
        self.port: int | None = None
        self._pending_push: dict[str, asyncio.Future] = {}
        #: the writers of the connections the handlers hold
        self._conns: set[asyncio.StreamWriter] = set()

    async def start(self) -> None:
        os.makedirs(self.snap_dir, exist_ok=True)
        self._server = await asyncio.start_server(
            self._on_connection, self.bind_ip, self.cfg_port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._reap_task = asyncio.create_task(self._reap_loop(),
                                              name="cms-reap")

    async def stop(self) -> None:
        if self._reap_task is not None:
            self._reap_task.cancel()
            try:
                await self._reap_task
            except (asyncio.CancelledError, Exception):
                pass
            self._reap_task = None
        for d in self.devices.values():
            if d.writer is not None:
                d.writer.close()
        for w in list(self._conns):
            w.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------- reaping
    def reap(self, now: float | None = None) -> list[str]:
        """Drop the records whose keepalive lapsed past
        ``device_timeout_sec``, lapse alone deciding (a device behind a
        silently dropped network sends no FIN, so its writer still looks
        open).  Each reap closes the stale writer and emits one
        ``cms.device_offline`` event; returns the reaped serials."""
        now = time.time() if now is None else now
        gone = [serial for serial, rec in self.devices.items()
                if now - rec.last_seen > self.device_timeout_sec]
        for serial in gone:
            rec = self.devices.pop(serial)
            self._pending_push.pop(serial, None)
            if rec.writer is not None:
                try:
                    rec.writer.close()
                except Exception:
                    pass
            EVENTS.emit("cms.device_offline", level="warn", serial=serial,
                        name=rec.name)
        return gone

    async def _reap_loop(self) -> None:
        interval = max(self.device_timeout_sec / 5.0, 1.0)
        while True:
            await asyncio.sleep(interval)
            try:
                self.reap()
            except Exception:
                pass

    # ------------------------------------------------------------ sessions
    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        bound_device: DeviceRecord | None = None
        self._conns.add(writer)
        try:
            while True:
                msg = await read_framed(reader)
                if msg is None:
                    break
                reply, bound = await self._dispatch(msg, writer, bound_device)
                if bound is not None:
                    bound_device = bound
                if bound_device is not None:
                    # any traffic from a bound device is its keepalive
                    bound_device.last_seen = time.time()
                if reply is not None:
                    writer.write(_frame(reply, request=False))
                    await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(writer)
            if bound_device is not None and bound_device.writer is writer:
                bound_device.writer = None
            writer.close()

    async def _dispatch(self, msg: ep.Message, writer, bound):
        mt = msg.message_type
        # adopt the caller's TraceId or mint one, so every forwarded
        # request, ack and event of this RPC correlates
        if not msg.trace_id:
            msg.trace_id = secrets.token_hex(8)
        EVENTS.emit("cms.rpc", trace_id=msg.trace_id,
                    msg_type=f"0x{mt:04X}", cseq=msg.cseq,
                    serial=str(msg.body.get("Serial", "")))
        if mt == ep.MSG_DS_REGISTER_REQ:
            return self._register_device(msg, writer)
        if mt == ep.MSG_DS_PUSH_STREAM_ACK:
            fut = self._pending_push.pop(str(msg.body.get("Serial", "")), None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return None, None
        if mt == ep.MSG_DS_POST_SNAP_REQ:
            return self._post_snap(msg), None
        if mt == ep.MSG_CS_DEVICE_LIST_REQ:
            return self._device_list(msg), None
        if mt == ep.MSG_CS_DEVICE_INFO_REQ:
            return self._device_info(msg), None
        if mt == ep.MSG_CS_GET_STREAM_REQ:
            return await self._get_stream(msg), None
        if mt == ep.MSG_CS_FREE_STREAM_REQ:
            return await self._free_stream(msg), None
        if mt in (ep.MSG_CS_PTZ_CTRL_REQ, ep.MSG_CS_PRESET_CTRL_REQ,
                  ep.MSG_CS_TALKBACK_CTRL_REQ):
            return await self._forward_ctrl(msg), None
        return ep.ack(ep.MSG_SC_EXCEPTION, msg.cseq,
                      ep.ERR_BAD_REQUEST, trace_id=msg.trace_id), None

    # ------------------------------------------------------------ handlers
    def _register_device(self, msg: ep.Message, writer):
        b = msg.body
        serial = str(b.get("Serial", "")).strip()
        if not serial:
            return ep.ack(ep.MSG_SD_REGISTER_ACK, msg.cseq,
                          ep.ERR_BAD_REQUEST, trace_id=msg.trace_id), None
        rec = self.devices.get(serial) or DeviceRecord(serial)
        rec.name = str(b.get("Name", rec.name or serial))
        rec.device_type = str(b.get("Type", rec.device_type))
        rec.channels = b.get("Channels", rec.channels) or []
        rec.token = base64.b16encode(os.urandom(8)).decode()
        rec.writer = writer
        rec.last_seen = time.time()
        self.devices[serial] = rec
        EVENTS.emit("cms.register", trace_id=msg.trace_id, serial=serial,
                    name=rec.name)
        return ep.ack(ep.MSG_SD_REGISTER_ACK, msg.cseq, ep.ERR_OK,
                      {"Serial": serial, "Token": rec.token},
                      trace_id=msg.trace_id), rec

    def _post_snap(self, msg: ep.Message):
        b = msg.body
        serial = str(b.get("Serial", "unknown"))
        img = b.get("Image", "")
        try:
            raw = base64.b64decode(img)
        except (ValueError, TypeError):
            return ep.ack(ep.MSG_SD_POST_SNAP_ACK, msg.cseq,
                          ep.ERR_BAD_REQUEST, trace_id=msg.trace_id)
        path = os.path.join(self.snap_dir, f"{serial}_{int(time.time())}.jpg")
        with open(path, "wb") as f:
            f.write(raw)
        rec = self.devices.get(serial)
        if rec is not None:
            rec.last_seen = time.time()
        return ep.ack(ep.MSG_SD_POST_SNAP_ACK, msg.cseq, ep.ERR_OK,
                      {"SnapURL": f"file://{path}"}, trace_id=msg.trace_id)

    def _device_list(self, msg: ep.Message):
        now = time.time()
        devs = [{
            "Serial": d.serial, "Name": d.name, "Type": d.device_type,
            "Online": "1" if d.online else "0",
            "ChannelCount": str(len(d.channels)),
        } for d in self.devices.values()
            if now - d.last_seen < self.device_timeout_sec]
        return ep.ack(ep.MSG_SC_DEVICE_LIST_ACK, msg.cseq, ep.ERR_OK,
                      {"DeviceCount": str(len(devs)), "Devices": devs},
                      trace_id=msg.trace_id)

    def _device_info(self, msg: ep.Message):
        rec = self.devices.get(str(msg.body.get("Serial", "")))
        if rec is None:
            return ep.ack(ep.MSG_SC_DEVICE_INFO_ACK, msg.cseq,
                          ep.ERR_NOT_FOUND, trace_id=msg.trace_id)
        return ep.ack(ep.MSG_SC_DEVICE_INFO_ACK, msg.cseq, ep.ERR_OK, {
            "Serial": rec.serial, "Name": rec.name, "Type": rec.device_type,
            "Online": "1" if rec.online else "0", "Channels": rec.channels},
            trace_id=msg.trace_id)

    async def _get_stream(self, msg: ep.Message):
        """A client wants a device's stream: place it on the least-loaded
        media server and tell the device to push there."""
        b = msg.body
        serial = str(b.get("Serial", ""))
        channel = str(b.get("Channel", "0"))
        rec = self.devices.get(serial)
        if rec is None or not rec.online:
            return ep.ack(ep.MSG_SC_GET_STREAM_ACK, msg.cseq,
                          ep.ERR_DEVICE_OFFLINE, trace_id=msg.trace_id)
        # this channel already pushes: answer with its URL
        if channel in rec.pushing:
            return ep.ack(ep.MSG_SC_GET_STREAM_ACK, msg.cseq, ep.ERR_OK,
                          {"URL": rec.pushing[channel], "Serial": serial,
                           "Channel": channel}, trace_id=msg.trace_id)
        server = await PresenceService.pick_least_loaded(self.redis)
        if server is None:
            return ep.ack(ep.MSG_SC_GET_STREAM_ACK, msg.cseq,
                          ep.ERR_INTERNAL, {"Detail": "no media servers"},
                          trace_id=msg.trace_id)
        url = (f"rtsp://{server['IP']}:{server['RTSP']}"
               f"/{serial}/{channel}.sdp")
        fut = asyncio.get_running_loop().create_future()
        self._pending_push[serial] = fut
        rec.writer.write(_frame(ep.Message(
            ep.MSG_SD_PUSH_STREAM_REQ, msg.cseq,
            body={"Serial": serial, "Channel": channel, "URL": url,
                  "IP": server["IP"], "Port": server["RTSP"]},
            trace_id=msg.trace_id).to_json()))
        await rec.writer.drain()
        try:
            await asyncio.wait_for(fut, 5.0)
        except asyncio.TimeoutError:
            self._pending_push.pop(serial, None)
            return ep.ack(ep.MSG_SC_GET_STREAM_ACK, msg.cseq,
                          ep.ERR_DEVICE_OFFLINE, {"Detail": "push timeout"},
                          trace_id=msg.trace_id)
        rec.pushing[channel] = url
        EVENTS.emit("cms.push_stream", trace_id=msg.trace_id,
                    serial=serial, url=url)
        return ep.ack(ep.MSG_SC_GET_STREAM_ACK, msg.cseq, ep.ERR_OK,
                      {"URL": url, "Serial": serial, "Channel": channel},
                      trace_id=msg.trace_id)

    async def _free_stream(self, msg: ep.Message):
        """The last viewer left: tell the device to stop pushing."""
        serial = str(msg.body.get("Serial", ""))
        channel = str(msg.body.get("Channel", "0"))
        rec = self.devices.get(serial)
        if rec is None:
            return ep.ack(ep.MSG_SC_FREE_STREAM_ACK, msg.cseq,
                          ep.ERR_NOT_FOUND, trace_id=msg.trace_id)
        rec.pushing.pop(channel, None)
        if rec.online:
            rec.writer.write(_frame(ep.Message(
                ep.MSG_SD_STREAM_STOP_REQ, msg.cseq,
                body={"Serial": serial, "Channel": channel},
                trace_id=msg.trace_id).to_json()))
            await rec.writer.drain()
        return ep.ack(ep.MSG_SC_FREE_STREAM_ACK, msg.cseq, ep.ERR_OK,
                      trace_id=msg.trace_id)

    async def _forward_ctrl(self, msg: ep.Message):
        """PTZ, preset and talkback commands, forwarded to the device."""
        serial = str(msg.body.get("Serial", ""))
        rec = self.devices.get(serial)
        ack_type = {
            ep.MSG_CS_PTZ_CTRL_REQ: ep.MSG_SC_PTZ_CTRL_ACK,
            ep.MSG_CS_PRESET_CTRL_REQ: ep.MSG_SC_PRESET_CTRL_ACK,
            ep.MSG_CS_TALKBACK_CTRL_REQ: ep.MSG_SC_TALKBACK_CTRL_ACK,
        }[msg.message_type]
        if rec is None or not rec.online:
            return ep.ack(ack_type, msg.cseq, ep.ERR_DEVICE_OFFLINE,
                          trace_id=msg.trace_id)
        rec.writer.write(_frame(ep.Message(
            ep.MSG_SD_CONTROL_PTZ_REQ, msg.cseq, body=msg.body,
            trace_id=msg.trace_id).to_json()))
        await rec.writer.drain()
        return ep.ack(ack_type, msg.cseq, ep.ERR_OK,
                      trace_id=msg.trace_id)
