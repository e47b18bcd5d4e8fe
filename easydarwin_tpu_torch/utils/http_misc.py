"""Streaming-client User-Agent parsing for the access log.

``QTS (qtid=...;qtver=...;os=...)``-style User-Agent strings carry the six
attributes DSS understands; the W3C access log writes five of them as its
c-playerid, c-playerversion, c-os, c-osversion and c-cpu columns.
"""

from __future__ import annotations

from urllib.parse import unquote

#: the six attributes DSS understands
UA_ATTRIBUTES = ("qtid", "qtver", "lang", "os", "osver", "cpu")


def parse_user_agent(value: str) -> dict[str, str]:
    """User-Agent → {attribute: value} for the known attributes.

    Everything inside the first parenthesized group is ``name=value;``
    pairs; a value may itself be parenthesized or %-escaped; unknown names
    are ignored and the first occurrence of a name wins."""
    out: dict[str, str] = {}
    start = value.find("(")
    end = value.rfind(")")
    body = value[start + 1:end] if 0 <= start < end else value
    for part in body.split(";"):
        name, sep, val = part.partition("=")
        if not sep:
            continue
        name = name.strip().lower()
        if name not in UA_ATTRIBUTES:
            continue
        val = unquote(val.strip()).strip('"')
        if val.startswith("(") and val.endswith(")"):
            val = val[1:-1]
        if name not in out:
            out[name] = val
    return out
