"""JSON REST management API on the service port, trimmed to the
transcode ladder and the recorder.

A tiny HTTP/1.1 keep-alive server (no framework): request line, headers
and an optional body, a ``/api/v1/<cmd>`` router, and answers in the
EasyProtocol envelope (``cluster.protocol.ack``).  Commands:
``starttranscode``, ``stoptranscode``, ``gettranscodes``, ``startrecord``
and ``stoprecord`` (with DVR on they also arm and finalize the path's
DVR asset) and ``storagestats`` (plain JSON: the storage tier's counters
and ``pack_window.calls``); any other command answers the 404 envelope.
There is no auth (the reference's is off by default).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from urllib.parse import parse_qs, urlparse

from ..cluster import protocol as ep
from ..utils.paths import confined_subpath
from ..vod.cache import pack_window
from .config import ServerConfig

SERVER_NAME = "easydarwin-tpu-torch/0.1"


class RestApi:
    def __init__(self, config: ServerConfig, app):
        self.config = config
        self.app = app                      # StreamingServer
        self._server: asyncio.AbstractServer | None = None
        self.port: int | None = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, self.config.bind_ip,
            self.config.service_port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                head = await reader.readuntil(b"\r\n\r\n")
                lines = head.decode("latin-1").split("\r\n")
                try:
                    method, target, _version = lines[0].split(None, 2)
                except ValueError:
                    break
                headers = {}
                for ln in lines[1:]:
                    k, sep, v = ln.partition(":")
                    if sep:
                        headers[k.strip().lower()] = v.strip()
                body = b""
                clen = int(headers.get("content-length", "0") or 0)
                if clen:
                    body = await reader.readexactly(clen)
                status, payload = await self.route(method, target, headers,
                                                   body)
                data = payload.encode()
                reason = "OK" if status == 200 else "Error"
                writer.write((
                    f"HTTP/1.1 {status} {reason}\r\n"
                    f"Server: {SERVER_NAME}\r\n"
                    "Content-Type: application/json\r\n"
                    f"Content-Length: {len(data)}\r\n"
                    "Connection: keep-alive\r\n\r\n").encode() + data)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.LimitOverrunError):
            pass
        finally:
            writer.close()

    async def route(self, method: str, target: str, headers: dict,
                    body: bytes) -> tuple[int, str]:
        url = urlparse(target)
        path = url.path.rstrip("/").lower()
        params = parse_qs(url.query)
        if not path.startswith("/api/v1/"):
            return 404, json.dumps({"error": "not found"})
        fn = getattr(self, f"_cmd_{path[len('/api/v1/'):]}", None)
        if fn is None:
            return 404, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_NOT_FOUND)
        return fn(params, body)

    def _cmd_starttranscode(self, params: dict,
                            body: bytes) -> tuple[int, str]:
        """Start an MJPEG bitrate ladder on a live path; the rungs appear
        as {path}@q{Q}[s2] live streams."""
        path = params.get("path", [""])[0]
        rungs = tuple(q for q in
                      params.get("rungs", ["40,20"])[0].split(",") if q)
        try:
            out = self.app.transcodes.start(path, rungs)
        except KeyError:
            return 404, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_NOT_FOUND)
        except ValueError as e:
            return 400, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_BAD_REQUEST,
                               body={"Detail": str(e)})
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={
            "Transcode": out.source_path,
            "Rungs": [r.session.path for r in out.rungs]})

    def _cmd_stoptranscode(self, params: dict,
                           body: bytes) -> tuple[int, str]:
        path = params.get("path", [""])[0]
        try:
            st = self.app.transcodes.stop(path)
        except KeyError:
            return 404, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_NOT_FOUND)
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={
            "Transcode": st["path"], "FramesIn": str(st["frames_in"])})

    def _cmd_gettranscodes(self, params: dict,
                           body: bytes) -> tuple[int, str]:
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={
            "Transcodes": self.app.transcodes.list_ladders()})

    def _cmd_startrecord(self, params: dict, body: bytes) -> tuple[int, str]:
        """Attach an MP4 recorder to a live session's video track; the file
        (``file=``, default ``<path>_<time>.mp4``) lands under the movie
        folder, confined to it."""
        path = params.get("path", [""])[0]
        sess = self.app.registry.find(path) if path else None
        if sess is None:
            return 404, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_NOT_FOUND)
        fname = params.get("file", [""])[0] or (
            sess.path.strip("/").replace("/", "_")
            + time.strftime("_%Y%m%d%H%M%S") + ".mp4")
        root = self.config.movie_folder
        os.makedirs(root, exist_ok=True)
        # commonpath over realpaths: refuses .. traversal, a sibling
        # folder sharing the prefix string and a symlink leaving the root
        full = confined_subpath(root, fname)
        if full is None:
            return 400, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_BAD_REQUEST,
                               body={"Detail": "file escapes movie_folder"})
        os.makedirs(os.path.dirname(full), exist_ok=True)
        try:
            self.app.recordings.start(sess, full)
        except ValueError as e:
            return 400, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_BAD_REQUEST,
                               body={"Detail": str(e)})
        dvr_armed = False
        if self.app.dvr is not None:
            sdp = self.app.registry.sdp_cache.get(sess.path) or ""
            dvr_armed = (self.app.dvr.arm(sess, sdp)
                         or self.app.dvr.armed(sess.path))
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK,
                           body={"Recording": sess.path, "File": full,
                                 "Dvr": "1" if dvr_armed else "0"})

    def _cmd_stoprecord(self, params: dict, body: bytes) -> tuple[int, str]:
        """Stop the path's MP4 recorder and finalize its DVR asset (a
        DVR-only recording, armed at RECORD, answers its window count)."""
        path = params.get("path", [""])[0]
        dvr_res = (self.app.dvr.finalize(path)
                   if self.app.dvr is not None else None)
        try:
            res = self.app.recordings.stop(path)
        except KeyError:
            if dvr_res is None:
                return 404, ep.ack(ep.MSG_SC_EXCEPTION,
                                   error=ep.ERR_NOT_FOUND)
            return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={
                "DvrWindows": str(dvr_res["windows"])})
        extra = ({"DvrWindows": str(dvr_res["windows"])}
                 if dvr_res is not None else {})
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={
            "File": res["path"], "Samples": str(res["samples"]), **extra})

    def _cmd_storagestats(self, params: dict,
                          body: bytes) -> tuple[int, str]:
        """The storage tier's counters and ``pack_window.calls`` (a
        reconstructed replay repacks nothing), as plain JSON."""
        st = self.app.storage
        doc: dict = {"enabled": st is not None,
                     "pack_window_calls": int(pack_window.calls)}
        if st is not None:
            doc.update(st.stats())
        return 200, json.dumps(doc, separators=(",", ":"))
