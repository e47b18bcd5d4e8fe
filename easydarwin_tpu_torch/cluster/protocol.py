"""EasyProtocol-compatible JSON envelope, trimmed to the REST answers.

Every answer is ``{"EasyDarwin": {"Header": {CSeq, MessageType, Version,
ErrorNum, ErrorString}, "Body": {...}}}``, byte-compatible with the
reference's ``ack()`` (same keys, order and indentation), so stock
EasyDarwin tooling reads it.  Only the message types and error codes the
REST commands answer with are kept.
"""

from __future__ import annotations

import json

ROOT = "EasyDarwin"
VERSION = "1.0"

MSG_SC_GET_STREAM_ACK = 0x000C
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


def ack(message_type: int, cseq: int = 1, error: int = ERR_OK,
        body: dict | None = None) -> str:
    header = {"CSeq": str(cseq), "MessageType": f"0x{message_type:04X}",
              "Version": VERSION, "ErrorNum": str(error),
              "ErrorString": _ERROR_STRINGS.get(error, "Unknown")}
    return json.dumps({ROOT: {"Header": header, "Body": body or {}}},
                      indent=1)
