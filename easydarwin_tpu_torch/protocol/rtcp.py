"""The one RTCP read the relay needs yet (RFC 3550 §6.4.2): which SSRCs a
compound's receiver reports name in their report blocks.

A UDP player's RTCP proves it is alive.  The server takes a datagram as
that proof only when it parses as RTCP, and when it comes from a player's
registered RTCP address or an RR names that player's SSRC (the
reference's rule, ``RtspServer.on_client_rtcp``).  Sender reports, SDES,
BYE and the rest are walked over, not read.
"""

from __future__ import annotations

import struct

RR = 201
#: the receiver report's sender SSRC, then 24-byte report blocks
RR_SENDER_LEN, REPORT_BLOCK_LEN = 4, 24


def rr_report_ssrcs(data: bytes) -> set[int] | None:
    """The SSRCs named by the report blocks of every RR in the compound
    ``data``; None when ``data`` is not RTCP (a version other than 2, or a
    packet that runs past the datagram)."""
    ssrcs: set[int] = set()
    off = 0
    if len(data) < 4:
        return None
    while off + 4 <= len(data):
        b0, ptype, words = struct.unpack_from("!BBH", data, off)
        end = off + 4 + 4 * words
        if b0 >> 6 != 2 or end > len(data):
            return None
        if ptype == RR:
            body = off + 4 + RR_SENDER_LEN
            for i in range(b0 & 0x1F):
                at = body + i * REPORT_BLOCK_LEN
                if at + REPORT_BLOCK_LEN > end:
                    break
                ssrcs.add(struct.unpack_from("!I", data, at)[0])
        off = end
    return ssrcs
