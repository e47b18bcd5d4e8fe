"""JSON REST management API and HLS serving on the service port.

A tiny HTTP/1.1 keep-alive server (no framework): request line, headers
and an optional body, a ``/api/v1/<cmd>`` router answering in the
EasyProtocol envelope (``cluster.protocol.ack``), and ``/hls/...`` GETs
served by ``hls.HlsService.serve`` (playlists, ``init.mp4`` and
segments with their content type and ETag; a matching
``If-None-Match`` is answered 304 with no body).  A route answers
``(status, body)`` or ``(status, body, content_type, headers)``, the
body ``str`` or ``bytes``; the header block and the body go out as two
writes, so a segment is never copied into a response buffer.

Commands: ``login`` (``username=``, ``password=``; answers a ``Token``)
and ``logout``, ``getserverinfo``, ``getrtsplivesessions``,
``getbaseconfig`` (every config key but ``rest_password``) and
``setbaseconfig`` (a JSON body ``{"Config": {key: value}}``; an unknown
key answers 400), ``restart`` (the process exits with the watchdog's
restart code), ``getdevicestream`` / ``livedevicestream``
(``device=``: the ``rtsp://`` URL of ``/<device>`` or
``/live/<device>`` when it is live), ``startpullrelay`` (``path=``,
``url=``), ``stoppullrelay`` and ``getpullrelays``,
``starttranscode``, ``stoptranscode``, ``gettranscodes``,
``startrecord`` and ``stoprecord`` (with DVR on they also arm and
finalize the path's DVR asset), ``storagestats`` (plain JSON: the
storage tier's counters and ``pack_window.calls``), ``starthls``
(``path=``, ``rungs=`` a comma list of thinning levels 1-2 and requant
rungs q6-q18, default ``1,2``), ``stophls`` and ``gethlsstreams``; any
other command answers the 404 envelope.

With ``auth_enabled`` every command but ``login`` needs a login token
(``token=`` or the ``X-Token`` header) or Basic credentials, else 401;
a command that changes state (``MUTATING``) also needs the token in the
``X-Token`` header, else 403: a cross-site request can carry cached
credentials but not a custom header.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import json
import os
import secrets
import time
from urllib.parse import parse_qs, urlparse

from ..cluster import protocol as ep
from ..hls.segmenter import DEFAULT_RUNGS
from ..protocol.sdp import _norm
from ..relay.pull import PullError
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
        #: ``/hls/`` GETs answered 304 (an ``If-None-Match`` revalidation)
        self.hls_not_modified = 0
        #: live login tokens
        self.tokens: set[str] = set()
        #: calls answered 401 and 403
        self.refused = {"401": 0, "403": 0}

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
                res = await self.route(method, target, headers, body)
                status, payload = res[0], res[1]
                ctype = res[2] if len(res) > 2 else "application/json"
                extra = res[3] if len(res) > 3 else {}
                data = payload.encode() if isinstance(payload, str) \
                    else payload
                reason = {200: "OK", 304: "Not Modified"}.get(status,
                                                              "Error")
                writer.write((
                    f"HTTP/1.1 {status} {reason}\r\n"
                    f"Server: {SERVER_NAME}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(data)}\r\n"
                    + "".join(f"{k}: {v}\r\n" for k, v in extra.items())
                    + "Connection: keep-alive\r\n\r\n").encode())
                if data:
                    writer.write(data)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.LimitOverrunError):
            pass
        finally:
            writer.close()

    #: commands that change the server's state
    MUTATING = frozenset((
        "setbaseconfig", "restart", "startrecord", "stoprecord",
        "startpullrelay", "stoppullrelay", "starttranscode",
        "stoptranscode", "starthls", "stophls", "logout"))

    async def route(self, method: str, target: str, headers: dict,
                    body: bytes) -> tuple:
        url = urlparse(target)
        path = url.path.rstrip("/").lower()
        params = parse_qs(url.query)
        if path.startswith("/hls/"):
            return self._serve_hls(url.path, headers)
        if not path.startswith("/api/v1/"):
            return 404, json.dumps({"error": "not found"})
        cmd = path[len("/api/v1/"):]
        if "x-token" in headers and "token" not in params:
            params["token"] = [headers["x-token"]]
        if cmd == "login":
            return self._login(params)
        if not self._authorized(headers, params):
            self.refused["401"] += 1
            return 401, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_UNAUTHORIZED)
        if (self.config.auth_enabled and cmd in self.MUTATING
                and headers.get("x-token") not in self.tokens):
            self.refused["403"] += 1
            return 403, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_UNAUTHORIZED,
                               body={"Detail":
                                     "mutating API calls need the X-Token "
                                     "header (see /api/v1/login)"})
        fn = getattr(self, f"_cmd_{cmd}", None)
        if fn is None:
            return 404, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_NOT_FOUND)
        res = fn(params, body)
        return await res if asyncio.iscoroutine(res) else res

    # ---------------------------------------------------------------- auth
    def _authorized(self, headers: dict, params: dict) -> bool:
        if not self.config.auth_enabled:
            return True
        if params.get("token", [None])[0] in self.tokens:
            return True
        auth = headers.get("authorization", "")
        if auth.lower().startswith("basic "):
            try:
                user, _, pw = base64.b64decode(auth[6:]).decode() \
                    .partition(":")
            except (binascii.Error, UnicodeDecodeError):
                return False
            return (user == self.config.rest_username
                    and pw == self.config.rest_password)
        return False

    def _login(self, params: dict) -> tuple[int, str]:
        user = params.get("username", [""])[0]
        pw = params.get("password", [""])[0]
        if (self.config.auth_enabled
                and (user != self.config.rest_username
                     or pw != self.config.rest_password)):
            self.refused["401"] += 1
            return 401, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_UNAUTHORIZED)
        token = secrets.token_hex(16)
        self.tokens.add(token)
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={"Token": token})

    def _cmd_logout(self, params: dict, body: bytes) -> tuple[int, str]:
        self.tokens.discard(params.get("token", [""])[0])
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK)

    # -------------------------------------------------------- core commands
    def _cmd_getserverinfo(self, params: dict, body: bytes) -> tuple[int, str]:
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK,
                           body=self.app.server_info())

    def _cmd_getrtsplivesessions(self, params: dict,
                                 body: bytes) -> tuple[int, str]:
        sessions = self.app.live_sessions()
        return 200, ep.ack(ep.MSG_SC_RTSP_LIVE_SESSIONS_ACK, body={
            "SessionCount": str(len(sessions)), "Sessions": sessions})

    def _cmd_getbaseconfig(self, params: dict, body: bytes) -> tuple[int, str]:
        cfg = {k: v for k, v in self.config.to_dict().items()
               if k != "rest_password"}
        return 200, ep.ack(ep.MSG_SC_BASE_CONFIG_ACK, body={"Config": cfg})

    def _cmd_setbaseconfig(self, params: dict, body: bytes) -> tuple[int, str]:
        try:
            doc = json.loads(body or b"{}")
            changes = doc.get("Config", doc) if isinstance(doc, dict) else {}
            self.config.update(**changes)
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            return 400, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_BAD_REQUEST,
                               body={"Detail": str(e)})
        return 200, ep.ack(ep.MSG_SC_BASE_CONFIG_ACK)

    def _cmd_restart(self, params: dict, body: bytes) -> tuple[int, str]:
        self.app.request_restart()
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={"Restarting": "1"})

    def _cmd_getdevicestream(self, params: dict,
                             body: bytes) -> tuple[int, str]:
        """A device's stream URL when its path is live here."""
        device = params.get("device", params.get("serial", [""]))[0]
        if not device:
            return 400, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_BAD_REQUEST)
        url = self.app.device_stream_url(device)
        if url is None:
            return 404, ep.ack(ep.MSG_SC_EXCEPTION,
                               error=ep.ERR_DEVICE_OFFLINE)
        return 200, ep.ack(ep.MSG_SC_GET_STREAM_ACK, body={"URL": url})

    _cmd_livedevicestream = _cmd_getdevicestream

    async def _cmd_startpullrelay(self, params: dict,
                                  body: bytes) -> tuple[int, str]:
        """Pull a remote ``rtsp://`` stream into a local path."""
        url = params.get("url", [""])[0]
        path = params.get("path", [""])[0]
        if not url or not path:
            return 400, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_BAD_REQUEST,
                               body={"Detail": "need url= and path="})
        try:
            pull = await self.app.pulls.start_pull(path, url)
        except PullError as e:
            return 502, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_BAD_REQUEST,
                               body={"Detail": str(e)})
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={
            "Pull": pull.local_path, "Url": pull.url})

    async def _cmd_stoppullrelay(self, params: dict,
                                 body: bytes) -> tuple[int, str]:
        path = params.get("path", [""])[0]
        try:
            st = await self.app.pulls.stop_pull(path)
        except KeyError:
            return 404, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_NOT_FOUND)
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={
            "Pull": st["path"], "Packets": str(st["packets"])})

    def _cmd_getpullrelays(self, params: dict, body: bytes) -> tuple[int, str]:
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={
            "Pulls": self.app.pulls.list_pulls()})

    def _serve_hls(self, url_path: str, headers: dict) -> tuple:
        """A ``/hls/`` GET: the body, its content type and ETag, or a 304
        when ``If-None-Match`` names the current ETag."""
        served = self.app.hls.serve(url_path)
        if served is None:
            return 404, json.dumps({"error": "not found"})
        ctype, data, etag = served
        if etag is None:
            return 200, data, ctype, {}
        if headers.get("if-none-match") == etag:
            self.hls_not_modified += 1
            return 304, b"", ctype, {"ETag": etag}
        return 200, data, ctype, {"ETag": etag}

    def _cmd_starthls(self, params: dict, body: bytes) -> tuple[int, str]:
        """Publish a live path over HLS: the source rendition plus the
        rungs asked for (thinning levels and requant ``qN`` rungs)."""
        path = params.get("path", [""])[0]
        rungs_raw = params.get("rungs", [""])[0]
        try:
            rungs = (tuple(r if r.startswith("q") else int(r)
                           for r in rungs_raw.split(",") if r)
                     if rungs_raw else DEFAULT_RUNGS)
            self.app.hls.start(path, rungs)
        except KeyError:
            return 404, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_NOT_FOUND)
        except ValueError as e:
            return 400, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_BAD_REQUEST,
                               body={"Detail": str(e)})
        key = _norm(path)
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={
            "Master": f"/hls{key}/master.m3u8",
            "Renditions": ["index.m3u8"]
            + [(f"{r}/index.m3u8" if isinstance(r, str)
                else f"r{int(r)}/index.m3u8") for r in rungs]})

    def _cmd_stophls(self, params: dict, body: bytes) -> tuple[int, str]:
        key = _norm(params.get("path", [""])[0])
        if key not in self.app.hls.outputs:
            return 404, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_NOT_FOUND)
        self.app.hls.stop(key)
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={"Hls": key})

    def _cmd_gethlsstreams(self, params: dict,
                           body: bytes) -> tuple[int, str]:
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK, body={
            "Streams": self.app.hls.list_streams()})

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
