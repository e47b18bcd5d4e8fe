"""Reliable UDP: resend window, RTT/cwnd tracking, overbuffer pacing.

A copy of the reference's ``relay/reliable.py`` (the reliable-RTP kit
behind ``RTPStream::ReliableRTPWrite``), with its ``obs`` event: a
resend sweep in which packets gave up emits one ``reliable.expired``
(per sweep, never per packet):

* ``BandwidthTracker``: Karn-style smoothed RTT (SRTT/RTTVAR → RTO) and a
  byte congestion window, slow start then congestion avoidance;
* ``PacketResender``: the window of unacked packets, resent on RTO expiry
  with backoff, given up after ``MAX_RESENDS``;
* ``OverbufferWindow``: how far ahead of real time a sender may run;
* ``build_ack``/``parse_ack``: the 'qtak' APP ack, a first seq and a bit
  mask of the following acked seqs (``RTCPAckPacket``'s layout).

``ReliableUdpOutput`` decorates a UDP output with the window.  It must see
every datagram it sends, so only the fan-out engine's batch-header rung
serves it (``records_sends``); the server's pump runs its ``tick`` each
wake and routes the player's acks to ``on_rtcp_app``.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass

from ..obs import EVENTS
from ..protocol import rtp
from ..protocol.rtcp import App
from .output import RelayOutput, WriteResult

ACK_NAME = "qtak"
LEGACY_ACK_NAME = "ack "


# ------------------------------------------------------------- RTT / cwnd
class BandwidthTracker:
    """SRTT/RTTVAR/RTO + byte congestion window (slow start → avoidance)."""

    MIN_RTO_MS = 250
    MAX_RTO_MS = 24_000
    MSS = 1466                # segment size of the window arithmetic

    def __init__(self, *, initial_window: int = 3 * 1466):
        self.srtt_ms: float | None = None
        self.rttvar_ms = 0.0
        self.cwnd = float(initial_window)
        self.ssthresh = 64 * 1024.0
        #: the client's advertised ceiling (x-Retransmit window=KB)
        self.max_cwnd: float | None = None
        self.bytes_in_flight = 0
        self.acks = 0
        self.losses = 0

    @property
    def rto_ms(self) -> float:
        if self.srtt_ms is None:
            return 1000.0
        return min(max(self.srtt_ms + 4 * self.rttvar_ms, self.MIN_RTO_MS),
                   self.MAX_RTO_MS)

    def can_send(self, nbytes: int) -> bool:
        return self.bytes_in_flight + nbytes <= self.cwnd

    def on_sent(self, nbytes: int) -> None:
        self.bytes_in_flight += nbytes

    def on_ack(self, nbytes: int, rtt_ms: float | None) -> None:
        self.bytes_in_flight = max(0, self.bytes_in_flight - nbytes)
        self.acks += 1
        if rtt_ms is not None:           # Karn: only unambiguous samples
            if self.srtt_ms is None:
                self.srtt_ms = rtt_ms
                self.rttvar_ms = rtt_ms / 2
            else:
                self.rttvar_ms += 0.25 * (abs(self.srtt_ms - rtt_ms)
                                          - self.rttvar_ms)
                self.srtt_ms += 0.125 * (rtt_ms - self.srtt_ms)
        if self.cwnd < self.ssthresh:
            self.cwnd += self.MSS                      # slow start
        else:
            self.cwnd += self.MSS * self.MSS / self.cwnd   # avoidance
        if self.max_cwnd is not None:
            self.cwnd = min(self.cwnd, self.max_cwnd)

    def on_loss(self, nbytes: int) -> None:
        self.bytes_in_flight = max(0, self.bytes_in_flight - nbytes)
        self.losses += 1
        self.ssthresh = max(self.cwnd / 2, 2 * self.MSS)
        self.cwnd = self.ssthresh

    def deflate(self, nbytes: int) -> None:
        """Take expired bytes out of flight without a window backoff (one
        multiplicative decrease a loss sweep, not one a packet)."""
        self.bytes_in_flight = max(0, self.bytes_in_flight - nbytes)


# --------------------------------------------------------------- resender
@dataclass
class _Pending:
    data: bytes
    first_sent_ms: int
    last_sent_ms: int
    resends: int = 0


class PacketResender:
    MAX_RESENDS = 4           # then give up (counted as loss)

    def __init__(self, tracker: BandwidthTracker):
        self.tracker = tracker
        self.pending: dict[int, _Pending] = {}
        self.resent = 0
        self.expired = 0

    def add(self, seq: int, data: bytes, now_ms: int) -> None:
        self.pending[seq & 0xFFFF] = _Pending(data, now_ms, now_ms)
        self.tracker.on_sent(len(data))

    def ack(self, seq: int, now_ms: int) -> bool:
        p = self.pending.pop(seq & 0xFFFF, None)
        if p is None:
            return False
        rtt = (now_ms - p.first_sent_ms) if p.resends == 0 else None
        self.tracker.on_ack(len(p.data), rtt)
        return True

    def due_for_resend(self, now_ms: int) -> list[tuple[int, bytes]]:
        """The packets past their RTO, for retransmission; those past
        ``MAX_RESENDS`` are dropped (loss).  One sweep is ONE congestion
        event: a burst loss halves the window once."""
        rto = self.tracker.rto_ms
        out: list[tuple[int, bytes]] = []
        congested = False
        for seq in list(self.pending):
            p = self.pending[seq]
            if now_ms - p.last_sent_ms < rto * (2 ** p.resends):
                continue
            congested = True
            if p.resends >= self.MAX_RESENDS:
                del self.pending[seq]
                self.expired += 1
                self.tracker.deflate(len(p.data))
                continue
            p.resends += 1
            p.last_sent_ms = now_ms
            self.resent += 1
            out.append((seq, p.data))
        if congested:
            self.tracker.on_loss(0)      # one backoff per sweep
        return out

    @property
    def in_flight(self) -> int:
        return len(self.pending)

    def next_deadline_ms(self, now_ms: int) -> int:
        """ms until the earliest pending packet's RTO fires (0 = due now,
        −1 = nothing pending)."""
        if not self.pending:
            return -1
        rto = self.tracker.rto_ms
        due = min(p.last_sent_ms + rto * (2 ** p.resends)
                  for p in self.pending.values())
        return max(int(due - now_ms), 0)


# -------------------------------------------------------- overbuffer window
class OverbufferWindow:
    """May a packet whose play-out time is ``ahead_ms`` in the future go
    now?  (An unlimited window always says yes; otherwise the window
    bounds how far ahead the sender runs.)"""

    def __init__(self, *, window_ms: int = 10_000,
                 max_send_ahead_ms: int = 25_000):
        self.window_ms = window_ms
        self.max_send_ahead_ms = max_send_ahead_ms

    def can_send(self, packet_playout_ms: int, now_ms: int) -> bool:
        ahead = packet_playout_ms - now_ms
        if ahead <= 0:
            return True                   # due or late: always sendable
        if self.window_ms <= 0:
            return True                   # unlimited overbuffering
        return ahead <= min(self.window_ms, self.max_send_ahead_ms)

    def suggested_wakeup(self, packet_playout_ms: int, now_ms: int) -> int:
        """When to retry a deferred packet (ms from now)."""
        return max(packet_playout_ms - self.window_ms - now_ms, 10)


# ------------------------------------------------------------ ack packets
def build_ack(ssrc: int, first_seq: int, extra_mask: int = 0,
              mask_bytes: int = 4) -> bytes:
    """A 'qtak' APP ack: the first seq and a bit mask of following seqs."""
    payload = struct.pack(">HH", first_seq & 0xFFFF, 0)
    payload += extra_mask.to_bytes(mask_bytes, "big")
    if len(payload) % 4:
        payload += b"\x00" * (4 - len(payload) % 4)
    return App(ssrc, ACK_NAME, data=payload).to_bytes()


def parse_ack(app: App) -> list[int]:
    """'qtak'/'ack ' APP → acked seqs: the first, then bit i of the mask
    acking ``first_seq + 1 + i``."""
    if app.name not in (ACK_NAME, LEGACY_ACK_NAME) or len(app.data) < 4:
        return []
    first_seq = struct.unpack_from(">H", app.data, 0)[0]
    seqs = [first_seq]
    mask = app.data[4:]
    for byte_i, b in enumerate(mask):
        for bit in range(8):
            if b & (0x80 >> bit):
                seqs.append((first_seq + 1 + byte_i * 8 + bit) & 0xFFFF)
    return seqs


# ------------------------------------------------------- output decorator
class ReliableUdpOutput(RelayOutput):
    """A UDP output with the resend window (``RTPStream::ReliableRTPWrite``
    as a ``RelayOutput``):

    * ``send_bytes`` gates media on the congestion window (WOULD_BLOCK: the
      engine holds the bookmark and replays) and records every sent
      packet, keyed by its OUTPUT seq, for retransmission;
    * ``on_rtcp_app`` takes the client's 'qtak'/'ack ' acks;
    * ``tick`` retransmits the packets past their RTO (the pump, each
      wake).

    The rewrite and thinning state is the wrapped transport's."""

    #: every datagram must pass ``send_bytes``: the batch-header rung only
    records_sends = True

    def __init__(self, transport: RelayOutput, *,
                 window_kb: int | None = None, clock=None):
        super().__init__()
        self.transport = transport
        self.rewrite = transport.rewrite        # shared rebase state
        self.thinning = transport.thinning
        self.meta_field_ids = transport.meta_field_ids
        self.tracker = BandwidthTracker()
        if window_kb is not None:
            # the client's advertised buffer (x-Retransmit;window=N KB):
            # never grow the window past it (0 clamps to the 2*MSS floor)
            cap = max(int(window_kb) * 1024, 2 * BandwidthTracker.MSS)
            self.tracker.max_cwnd = float(cap)
            self.tracker.ssthresh = min(self.tracker.ssthresh, float(cap))
        self.resender = PacketResender(self.tracker)
        #: the give-ups the last ``reliable.expired`` event reported
        self._expired_reported = 0
        self._clock = clock or (lambda: int(time.monotonic() * 1000))

    @property
    def rtcp_addr(self):
        return self.transport.rtcp_addr

    @property
    def rtp_addr(self):
        return self.transport.rtp_addr

    def send_bytes(self, data: bytes, *, is_rtcp: bool) -> WriteResult:
        if is_rtcp:
            return self.transport.send_bytes(data, is_rtcp=True)
        if not self.tracker.can_send(len(data)):
            return WriteResult.WOULD_BLOCK
        res = self.transport.send_bytes(data, is_rtcp=False)
        if res is WriteResult.OK:
            self.resender.add(rtp.peek_seq(data), data, self._clock())
        return res

    def on_rtcp_app(self, app: App, now_ms: int | None = None) -> int:
        """Packets the ack popped from the window."""
        now = now_ms if now_ms is not None else self._clock()
        n = 0
        for seq in parse_ack(app):
            if self.resender.ack(seq, now):
                n += 1
        return n

    def tick(self, now_ms: int | None = None) -> int:
        """Retransmit the packets past their RTO, ungated by the window (a
        retransmit must not starve behind fresh data)."""
        now = now_ms if now_ms is not None else self._clock()
        n = 0
        for _seq, data in self.resender.due_for_resend(now):
            if self.transport.send_bytes(data, is_rtcp=False) \
                    is WriteResult.OK:
                n += 1
        if self.resender.expired > self._expired_reported:
            self._expired_reported = self.resender.expired
            EVENTS.emit("reliable.expired", level="warn",
                        session_id=getattr(self, "session_id", None),
                        trace_id=getattr(self, "trace_id", None),
                        expired=self.resender.expired,
                        resent=self.resender.resent)
        return n
