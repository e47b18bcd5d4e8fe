"""EasyProtocol-compatible JSON envelope and message vocabulary.

Every message is ``{"EasyDarwin": {"Header": {CSeq, MessageType,
Version, [TraceId], ErrorNum, ErrorString}, "Body": {...}}}``,
byte-compatible with the reference's (same keys, order and indentation),
so stock EasyDarwin tooling and a reference node read it.  ``ack``
answers the REST commands and the CMS's replies; ``Message`` carries the
CMS's requests in both directions (``parse`` reads one, ``to_json``
writes it).  ``TraceId`` is optional: the CMS stamps one on a request
that lacks it and echoes it on every forwarded request and ack.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

ROOT = "EasyDarwin"
VERSION = "1.0"

# message types (the reference's EasyProtocolDef.h names and values)
MSG_DS_REGISTER_REQ = 0x0001          # device → CMS register
MSG_SD_REGISTER_ACK = 0x0002
MSG_SD_PUSH_STREAM_REQ = 0x0003       # CMS → device: start pushing
MSG_DS_PUSH_STREAM_ACK = 0x0004
MSG_SD_STREAM_STOP_REQ = 0x0005
MSG_DS_STREAM_STOP_ACK = 0x0006
MSG_CS_DEVICE_LIST_REQ = 0x0007       # client → CMS
MSG_SC_DEVICE_LIST_ACK = 0x0008
MSG_CS_DEVICE_INFO_REQ = 0x0009
MSG_SC_DEVICE_INFO_ACK = 0x000A
MSG_CS_GET_STREAM_REQ = 0x000B        # client → CMS: want a stream
MSG_SC_GET_STREAM_ACK = 0x000C
MSG_CS_FREE_STREAM_REQ = 0x000D
MSG_SC_FREE_STREAM_ACK = 0x000E
MSG_DS_POST_SNAP_REQ = 0x000F         # device → CMS snapshot upload
MSG_SD_POST_SNAP_ACK = 0x0010
MSG_CS_PTZ_CTRL_REQ = 0x0011
MSG_SC_PTZ_CTRL_ACK = 0x0012
MSG_CS_PRESET_CTRL_REQ = 0x0013
MSG_SC_PRESET_CTRL_ACK = 0x0014
MSG_CS_TALKBACK_CTRL_REQ = 0x0015
MSG_SC_TALKBACK_CTRL_ACK = 0x0016
MSG_DS_CONTROL_PTZ_ACK = 0x0017
MSG_SD_CONTROL_PTZ_REQ = 0x0018
MSG_SC_SERVER_INFO_ACK = 0x0020
MSG_SC_RTSP_LIVE_SESSIONS_ACK = 0x0021
MSG_SC_BASE_CONFIG_ACK = 0x0022
MSG_SC_EXCEPTION = 0x0FFF

ERR_OK = 200
ERR_BAD_REQUEST = 400
ERR_UNAUTHORIZED = 401
ERR_NOT_FOUND = 404
ERR_INTERNAL = 500
ERR_DEVICE_OFFLINE = 600

_ERROR_STRINGS = {
    ERR_OK: "Success OK", ERR_UNAUTHORIZED: "Unauthorized",
    ERR_NOT_FOUND: "Not Found", ERR_BAD_REQUEST: "Bad Request",
    ERR_DEVICE_OFFLINE: "Device Offline", ERR_INTERNAL: "Internal Error",
}


class ProtocolError(ValueError):
    """A message that is not an EasyProtocol envelope."""


@dataclass
class Message:
    message_type: int
    cseq: int = 1
    #: None for a request, the error code for an ack
    error: int | None = None
    body: dict[str, Any] = field(default_factory=dict)
    #: the correlation id of one RPC across client, CMS and device
    trace_id: str | None = None

    def to_json(self) -> str:
        header: dict[str, Any] = {
            "CSeq": str(self.cseq),
            "MessageType": f"0x{self.message_type:04X}",
            "Version": VERSION,
        }
        if self.trace_id:
            header["TraceId"] = self.trace_id
        if self.error is not None:
            header["ErrorNum"] = str(self.error)
            header["ErrorString"] = _ERROR_STRINGS.get(self.error, "Unknown")
        return json.dumps({ROOT: {"Header": header, "Body": self.body}},
                          indent=1)

    @classmethod
    def parse(cls, text: str | bytes) -> "Message":
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise ProtocolError(f"bad JSON: {e}") from e
        env = doc.get(ROOT) if isinstance(doc, dict) else None
        if not isinstance(env, dict) or "Header" not in env:
            raise ProtocolError("missing EasyDarwin envelope")
        h = env["Header"]
        try:
            mt = h.get("MessageType", "0")
            message_type = int(mt, 16) if isinstance(mt, str) else int(mt)
        except ValueError as e:
            raise ProtocolError(
                f"bad MessageType {h.get('MessageType')!r}") from e
        err = h.get("ErrorNum")
        tid = h.get("TraceId")
        return cls(
            message_type=message_type,
            cseq=int(h.get("CSeq", "1") or 1),
            error=int(err) if err is not None else None,
            body=env.get("Body") or {},
            trace_id=str(tid) if tid else None)


def ack(message_type: int, cseq: int = 1, error: int = ERR_OK,
        body: dict | None = None, *, trace_id: str | None = None) -> str:
    return Message(message_type, cseq, error, body or {},
                   trace_id=trace_id).to_json()
