"""A simulated device (camera or NVR) and a one-shot client of the CMS.

A copy of the reference's ``cluster/device.py``.  ``SimDevice`` plays the
firmware the platform assumes: it registers with the CMS over a
persistent connection, answers PTZ and stop requests, and on
``MSG_SD_PUSH_STREAM_REQ`` calls its push callback (in a test, an
ANNOUNCE/RECORD push to the media server the CMS chose) and acks.
``CmsClient`` is the client side: one connection a request (device
list, get stream, PTZ).
"""

from __future__ import annotations

import asyncio
import base64

from . import protocol as ep
from .cms import _frame, read_framed


class SimDevice:
    def __init__(self, serial: str, *, name: str = "", channels=None,
                 on_push=None, on_stop=None, on_ctrl=None):
        self.serial = serial
        self.name = name or serial
        self.channels = channels or [{"Channel": "0", "Name": "main"}]
        self.on_push = on_push          # async (body) -> bool
        self.on_stop = on_stop          # async (body) -> None
        self.on_ctrl = on_ctrl          # async (body) -> None
        self.token: str | None = None
        self._reader = None
        self._writer = None
        self._task: asyncio.Task | None = None
        self.registered = asyncio.Event()
        self.ctrl_log: list[dict] = []

    async def connect(self, host: str, port: int) -> None:
        self._reader, self._writer = await asyncio.open_connection(host, port)
        self._writer.write(_frame(ep.Message(
            ep.MSG_DS_REGISTER_REQ,
            body={"Serial": self.serial, "Name": self.name, "Type": "camera",
                  "Channels": self.channels}).to_json()))
        await self._writer.drain()
        self._task = asyncio.create_task(self._loop(),
                                         name=f"dev-{self.serial}")
        await asyncio.wait_for(self.registered.wait(), 5.0)

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        if self._writer:
            self._writer.close()

    async def _loop(self) -> None:
        while True:
            msg = await read_framed(self._reader)
            if msg is None:
                return
            mt = msg.message_type
            if mt == ep.MSG_SD_REGISTER_ACK:
                self.token = msg.body.get("Token")
                self.registered.set()
            elif mt == ep.MSG_SD_PUSH_STREAM_REQ:
                ok = True
                if self.on_push is not None:
                    try:
                        ok = await self.on_push(msg.body)
                    except Exception:
                        ok = False
                self._writer.write(_frame(ep.Message(
                    ep.MSG_DS_PUSH_STREAM_ACK, msg.cseq,
                    error=ep.ERR_OK if ok else ep.ERR_INTERNAL,
                    body={"Serial": self.serial,
                          "Channel": msg.body.get("Channel", "0")}).to_json()))
                await self._writer.drain()
            elif mt == ep.MSG_SD_STREAM_STOP_REQ:
                if self.on_stop is not None:
                    await self.on_stop(msg.body)
            elif mt == ep.MSG_SD_CONTROL_PTZ_REQ:
                self.ctrl_log.append(msg.body)
                if self.on_ctrl is not None:
                    await self.on_ctrl(msg.body)

    async def post_snapshot(self, host: str, port: int, jpeg: bytes) -> str:
        """A one-shot snapshot upload; the ack's ``SnapURL``."""
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(_frame(ep.Message(
            ep.MSG_DS_POST_SNAP_REQ,
            body={"Serial": self.serial,
                  "Image": base64.b64encode(jpeg).decode()}).to_json()))
        await writer.drain()
        msg = await read_framed(reader)
        writer.close()
        return msg.body.get("SnapURL", "") if msg else ""


class CmsClient:
    """One-shot requests to the CMS (the EasyClient side)."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port

    async def request(self, message_type: int, body: dict,
                      cseq: int = 1) -> ep.Message:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        writer.write(_frame(ep.Message(message_type, cseq, body=body)
                            .to_json()))
        await writer.drain()
        msg = await read_framed(reader)
        writer.close()
        if msg is None:
            raise ep.ProtocolError("no reply")
        return msg

    async def device_list(self) -> list[dict]:
        m = await self.request(ep.MSG_CS_DEVICE_LIST_REQ, {})
        return m.body.get("Devices", [])

    async def get_stream(self, serial: str, channel: str = "0") -> ep.Message:
        return await self.request(ep.MSG_CS_GET_STREAM_REQ,
                                  {"Serial": serial, "Channel": channel})

    async def ptz(self, serial: str, command: str, speed: int = 5
                  ) -> ep.Message:
        return await self.request(ep.MSG_CS_PTZ_CTRL_REQ, {
            "Serial": serial, "Command": command, "Speed": str(speed)})
