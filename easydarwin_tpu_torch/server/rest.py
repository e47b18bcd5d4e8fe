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
a command that changes state (``MUTATING``, and ``admin`` with
``command=set``) also needs the token in the ``X-Token`` header, else
403: a cross-site request can carry cached credentials but not a custom
header.

Observability, as the reference serves it: GET ``/`` and ``/stats`` (the
HTML stats page) and ``/metrics`` (the Prometheus exposition) answer
without auth, as does ``/debug/profile`` (the span ring as a gzipped
pprof profile); ``/admin`` is the HTML dictionary tree (Basic or a
token), whose set form carries a per-process CSRF token.  The commands
``profile``, ``ledger``, ``audience`` (``n=`` worst subscribers),
``events`` (NDJSON, ``n=`` and ``since=`` a sequence number), ``fleet``,
``streamtrace`` (``path=``) and ``sessions/<id>/trace`` or ``/flight``
answer raw JSON; ``admin`` browses the tree (``path=``, ``command=get``
with ``recurse=``, or ``set`` with ``value=``) or answers the span ring
(``command=trace``), a flight record (``flight``, ``session=``), the
events, the fleet, the profile (``top``), the ledger's blame table
(``blame``) and the audience.  ``/metrics`` and NDJSON bodies of 256
bytes and more are gzipped when the client accepts it.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import gzip
import html as html_mod
import json
import os
import re
import secrets
import time
from urllib.parse import parse_qs, quote, urlparse

from .. import obs
from ..cluster import protocol as ep
from ..hls.segmenter import DEFAULT_RUNGS
from ..obs import fleet
from ..protocol.sdp import _norm
from ..relay.pull import PullError
from ..utils.paths import confined_subpath
from ..vod.cache import pack_window
from . import admin
from .config import ServerConfig

SERVER_NAME = "easydarwin-tpu-torch/0.1"

#: ``/api/v1/sessions/<rtsp session id>/trace`` (or ``/flight``); the ids
#: are lower-case hex, so the router's lower-casing loses nothing
_SESSION_DOC_RE = re.compile(r"^sessions/([0-9a-f]+)/(trace|flight)$")
#: content types whose bodies are gzipped for a client that accepts it
#: (the exposition and the NDJSON feeds), and the size below which a
#: gzip header costs more than it saves
_GZIP_CTYPES = ("text/plain", "application/x-ndjson")
_GZIP_MIN_BYTES = 256


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
        #: the ``/admin`` set form's per-process CSRF token: a cross-site
        #: POST may carry cached Basic credentials but cannot read the page
        self._admin_csrf = secrets.token_urlsafe(16)

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
                data, enc = _maybe_gzip(headers, status, ctype, data)
                if enc:
                    extra = {**extra, **enc}
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

    def _mutates(self, cmd: str, params: dict) -> bool:
        return cmd in self.MUTATING or (
            cmd == "admin"
            and params.get("command", ["get"])[0].lower() == "set")

    async def route(self, method: str, target: str, headers: dict,
                    body: bytes) -> tuple:
        url = urlparse(target)
        path = url.path.rstrip("/").lower()
        params = parse_qs(url.query)
        if path.startswith("/hls/"):
            return self._serve_hls(url.path, headers)
        if path in ("", "/stats"):
            return 200, self.webstats_html(), "text/html"
        if path == "/metrics":
            # the scrape: unauthenticated and read-only, as /stats
            return (200, obs.REGISTRY.expose(),
                    "text/plain; version=0.0.4; charset=utf-8")
        if path == "/debug/profile":
            return 200, obs.build_pprof(), "application/octet-stream"
        if path == "/admin":
            if not self._authorized(headers, params):
                self.refused["401"] += 1
                return 401, "<h1>401</h1>", "text/html"
            if method == "POST" and body:
                params = {**params, **parse_qs(body.decode("utf-8",
                                                           "replace"))}
            return self._admin_html(params, method, headers)
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
        m = _SESSION_DOC_RE.match(cmd)
        if m is not None:
            # a session's flight record, raw JSON; a trace is stitched
            # over the cluster's pull and ownership records, hop by hop
            status, doc = admin.flight_query(self.app, m.group(1))
            if status == 200 and m.group(2) == "trace" \
                    and params.get("local", ["0"])[0] not in ("1", "true"):
                doc = await fleet.stitch_trace(self.app, doc)
            return status, json.dumps(doc, default=str), "application/json"
        if (self.config.auth_enabled and self._mutates(cmd, params)
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

    # ------------------------------------------------------ observability
    def _cmd_profile(self, params: dict, body: bytes) -> tuple:
        """The phase profiler's live document (``admin command=top``)."""
        return _json(admin.profile_snapshot(self.app))

    def _cmd_ledger(self, params: dict, body: bytes) -> tuple:
        """The wake ledger's live document (``tools/blame_report.py
        --url`` reads it)."""
        return _json(admin.ledger_snapshot(self.app))

    def _cmd_audience(self, params: dict, body: bytes) -> tuple:
        """The audience store's per-stream rollup and worst ``n=``
        subscribers (default 5, at most 100)."""
        try:
            n = int(params.get("n", ["5"])[0])
        except ValueError:
            n = 5
        return _json(admin.audience_snapshot(self.app,
                                             worst_n=max(0, min(n, 100))))

    def _cmd_fleet(self, params: dict, body: bytes) -> tuple:
        """The fleet document: the cluster's last aggregate (every node's
        rollup, a dead node's marked stale) when a cluster runs, else this
        node alone."""
        return _json(fleet.fleet_snapshot(self.app))

    def _cmd_streamtrace(self, params: dict, body: bytes) -> tuple:
        """This node's hop of a stream's trace (``path=``)."""
        path = params.get("path", [""])[0]
        if not path:
            return 400, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_BAD_REQUEST)
        doc = fleet.local_hop_doc(self.app, path)
        return (404 if doc.get("error") else 200,
                json.dumps(doc, default=str), "application/json")

    @staticmethod
    def _page_params(params: dict) -> tuple[int, int | None]:
        """The event log's ``(n, since)`` paging query: the one parser
        ``events`` and ``admin command=events`` share."""
        try:
            n = int(params.get("n", ["256"])[0])
        except ValueError:
            n = 256
        since = None
        try:
            if "since" in params:
                since = int(params["since"][0])
        except ValueError:
            since = None
        return n, since

    def _cmd_events(self, params: dict, body: bytes) -> tuple:
        """The structured event log as NDJSON, oldest first from
        ``since=`` (a record's ``seq``)."""
        lines = obs.EVENTS.dump_lines(*self._page_params(params))
        return (200, "\n".join(lines) + ("\n" if lines else ""),
                "application/x-ndjson")

    def _cmd_admin(self, params: dict, body: bytes) -> tuple:
        """The dictionary tree (``path=``, ``command=get|set``) and the
        raw ``obs`` documents (``command=trace|flight|events|fleet|top|
        blame|audience``)."""
        path = params.get("path", ["server/*"])[0]
        command = params.get("command", ["get"])[0].lower()
        if command == "trace":
            return _json(obs.TRACER.dump())
        if command == "flight":
            status, doc = admin.flight_query(
                self.app, params.get("session", [""])[0])
            return status, json.dumps(doc, default=str), "application/json"
        if command == "events":
            return self._cmd_events(params, b"")
        if command == "fleet":
            return self._cmd_fleet(params, b"")
        if command == "top":
            return self._cmd_profile(params, b"")
        if command == "blame":
            return _json(admin.blame_snapshot(self.app))
        if command == "audience":
            return self._cmd_audience(params, b"")
        if command == "set":
            status, payload = admin.set_pref(
                self.app, path, params.get("value", [""])[0])
        elif command == "get":
            recurse = params.get("recurse", ["0"])[0] in ("1", "true")
            status, payload = admin.query(self.app, path, recurse=recurse)
        else:
            return 400, ep.ack(ep.MSG_SC_EXCEPTION, error=ep.ERR_BAD_REQUEST,
                               body={"Detail": f"unknown command {command}"})
        if status != 200:
            return status, ep.ack(
                ep.MSG_SC_EXCEPTION,
                error=ep.ERR_NOT_FOUND if status == 404
                else ep.ERR_BAD_REQUEST, body=payload)
        return 200, ep.ack(ep.MSG_SC_SERVER_INFO_ACK,
                           body={"Path": path, "Value": payload})

    def _admin_html(self, params: dict, method: str,
                    headers: dict) -> tuple:
        """The HTML face of the dictionary tree: containers to follow,
        leaf values, and a set form on each pref (a set needs a POST with
        the page's CSRF token or an ``X-Token`` header)."""
        esc = html_mod.escape
        path = params.get("path", ["server/*"])[0]
        msg = ""
        if params.get("command", [""])[0].lower() == "set":
            if method != "POST":
                msg = "<p class=err>set requires POST</p>"
            elif (not secrets.compare_digest(
                    params.get("csrf", [""])[0].encode("utf-8"),
                    self._admin_csrf.encode("ascii"))
                    and headers.get("x-token") not in self.tokens):
                msg = "<p class=err>set requires the page CSRF token</p>"
            else:
                st, payload = admin.set_pref(self.app, path.rstrip("/*"),
                                             params.get("value", [""])[0])
                msg = ("<p class=ok>set ok</p>" if st == 200 else
                       f"<p class=err>{esc(str(payload))}</p>")
            path = "server/prefs/*"
        status, payload = admin.query(self.app, path)
        crumbs, acc = [], []
        for part in [p for p in path.strip("/").split("/") if p != "*"]:
            acc.append(part)
            href = quote("/".join(acc), safe="/") + "/*"
            crumbs.append(f'<a href="/admin?path={quote(href, safe="/*")}"'
                          f">{esc(part)}</a>")
        rows = []
        if status != 200:
            rows.append(f"<tr><td colspan=2 class=err>"
                        f"{esc(str(payload))}</td></tr>")
        elif isinstance(payload, dict):
            base = path.strip("/").rstrip("*").rstrip("/")
            for k in sorted(payload):
                v = payload[k]
                if isinstance(v, dict) or v == "*container*":
                    href = quote(f"{base}/{k}", safe="/") + "/*"
                    rows.append(f'<tr><td><a href="/admin?path='
                                f'{quote(href, safe="/*")}">'
                                f"{esc(str(k))}/</a></td><td></td></tr>")
                    continue
                cell = esc(str(v))
                if base == "server/prefs":
                    cell += (f'<form method=post action=/admin '
                             f'style="display:inline">'
                             f'<input type=hidden name=path value='
                             f'"server/prefs/{esc(str(k))}">'
                             f'<input type=hidden name=command value=set>'
                             f'<input type=hidden name=csrf value='
                             f'"{self._admin_csrf}">'
                             f'<input name=value size=12> '
                             f'<input type=submit value=set></form>')
                rows.append(f"<tr><td>{esc(str(k))}</td>"
                            f"<td>{cell}</td></tr>")
        else:
            rows.append(f"<tr><td>{esc(path)}</td>"
                        f"<td>{esc(str(payload))}</td></tr>")
        page = ("<!doctype html><html><head><title>easydarwin-tpu admin"
                "</title><style>body{font-family:monospace;margin:2em}"
                "table{border-collapse:collapse}td{border:1px solid #ccc;"
                "padding:2px 8px}.err{color:#b00}.ok{color:#080}"
                "</style></head><body>"
                f"<h2><a href=\"/admin?path=server/*\">admin</a> "
                f"{' / '.join(crumbs)}</h2>{msg}"
                f"<table>{''.join(rows)}</table>"
                "<p><a href=/stats>stats</a></p></body></html>")
        return 200, page, "text/html"

    def webstats_html(self) -> str:
        """The HTML stats page (the reference's web stats module): the
        server's ``getserverinfo`` keys and its live sessions."""
        info = self.app.server_info()
        sessions = self.app.live_sessions()
        rows = "".join(
            f"<tr><td>{s['Path']}</td><td>{s['Outputs']}</td>"
            f"<td>{s['AgeSec']}s</td><td><code>{s['Url']}</code></td></tr>"
            for s in sessions)
        infos = "".join(f"<tr><td>{k}</td><td>{v}</td></tr>"
                        for k, v in info.items())
        return (
            "<!doctype html><html><head><title>easydarwin-tpu stats"
            "</title><style>body{font-family:monospace;margin:2em}"
            "table{border-collapse:collapse;margin:1em 0}"
            "td,th{border:1px solid #999;padding:4px 10px}</style></head>"
            f"<body><h1>easydarwin-tpu</h1><h2>Server</h2>"
            f"<table>{infos}</table>"
            f"<h2>Live sessions ({len(sessions)})</h2>"
            f"<table><tr><th>Path</th><th>Outputs</th><th>Age</th>"
            f"<th>URL</th></tr>{rows}</table></body></html>")

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
        # the body goes out through the transport: the reference's
        # "buffered" rung
        obs.HLS_SEGMENT_EGRESS_BYTES.inc(len(data), rung="buffered")
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


def _json(doc) -> tuple:
    """A raw JSON answer (not the envelope): pipes straight to jq."""
    return 200, json.dumps(doc, default=str), "application/json"


def _maybe_gzip(headers: dict, status: int, ctype: str,
                data: bytes) -> tuple[bytes, dict | None]:
    """A body gzipped (deterministic bytes: ``mtime=0``) when the client
    accepts gzip, its type is one of ``_GZIP_CTYPES`` and it shrinks;
    else as it is."""
    if (status != 200 or len(data) < _GZIP_MIN_BYTES
            or not (ctype or "").startswith(_GZIP_CTYPES)
            or "gzip" not in headers.get("accept-encoding", "").lower()):
        return data, None
    packed = gzip.compress(data, 6, mtime=0)
    if len(packed) >= len(data):
        return data, None
    return packed, {"Content-Encoding": "gzip", "Vary": "Accept-Encoding"}
