"""Per-track relay stream: rings, keyframe index, bucketed fan-out, RTCP.

Outputs live in buckets of ``bucket_size``; bucket *b*'s sends are delayed
``b × bucket_delay_ms`` to smooth the egress burst, so a packet is eligible
for bucket *b* at ``arrival + b·delay ≤ now``.  New outputs fast-start from
the newest keyframe run head when the stream is video, otherwise from the
oldest packet inside the over-buffer window.  Eviction keeps everything an
output still needs (bookmark pinning) up to ``max_age_ms``.

``reflect`` is the scalar oracle: one packet at a time through each
output's thinning filter and ``write_rtp``.  The serving path is
``relay.fanout.FanoutEngine`` fed by the megabatch scheduler; both deliver
the same bytes, and both end a pass in ``relay_rtcp``: the pusher's newest
RTCP compound rebased onto each output's timeline, and an SR of the
relay's own for every output that has had none for ``SR_INTERVAL_MS``.
``send_upstream_rr`` reports the reception of the pushed stream (RFC 3550
A.3) back to the pusher at the same cadence.

The lossy-UDP tier hangs off the stream: ``fec`` (a ``relay.fec.
StreamFec``, made when the first output with an ``out.fec`` state joins)
emits parity at the head of every ``relay_rtcp``, and
``tickable_outputs`` lists the outputs with a ``tick`` (reliable UDP's
resend sweeps), which the server's pump runs each wake.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from ..protocol import rtcp as rtcp_mod
from ..protocol.sdp import StreamInfo
from .output import RelayOutput, WriteResult
from .ring import DEFAULT_CAPACITY, PacketFlags, PacketRing

#: SR origination and upstream-RR cadence (``ReflectorStream.h:341``
#: kRRInterval = 5 s)
SR_INTERVAL_MS = 5000
#: the CNAME of the SRs the relay originates
SR_CNAME = "easydarwin-tpu"


@dataclass
class StreamSettings:
    """Tunables with the reflector's defaults."""

    bucket_size: int = 16             # outputs per delay bucket
    bucket_delay_ms: int = 73         # extra delay per bucket
    overbuffer_ms: int = 10_000       # fast-start look-back window
    max_age_ms: int = 20_000          # eviction age
    ring_capacity: int = DEFAULT_CAPACITY


@dataclass
class StreamStats:
    packets_in: int = 0
    bytes_in: int = 0
    packets_out: int = 0
    stalls: int = 0
    keyframes: int = 0


class RelayStream:
    def __init__(self, info: StreamInfo,
                 settings: StreamSettings | None = None, *,
                 rtp_ring: PacketRing | None = None):
        self.info = info
        self.settings = settings or StreamSettings()
        self.rtp_ring = rtp_ring if rtp_ring is not None else PacketRing(
            self.settings.ring_capacity,
            is_video=info.media_type == "video", codec=info.codec or None)
        #: absolute id of the newest keyframe *run head* (video only): the
        #: first packet of a consecutive keyframe-classified run, so a
        #: pusher sending SPS/PPS/IDR as separate packets still gives late
        #: joiners the whole GOP head
        self.keyframe_id: int | None = None
        self._kf_run_active = False
        self.has_keyframe_update = False
        self.session_path: str | None = None
        self.buckets: list[list[RelayOutput]] = []
        self.stats = StreamStats()
        #: the pusher's RTCP compounds; ``relay_rtcp`` forwards the newest
        self.rtcp_ring = PacketRing(min(256, self.settings.ring_capacity))
        #: where receiver reports to the pusher go (a callable taking the
        #: compound), and the connection that installed it: a closing
        #: pusher clears only its own
        self.upstream_rtcp = None
        self.upstream_rtcp_owner = None
        self.last_upstream_rr_ms = 0
        #: the reporter SSRC of the upstream RRs: random per stream, so it
        #: collides neither across tracks nor with a media SSRC
        self.reporter_ssrc = random.getrandbits(32)
        #: the wall clock at relay-clock ms 0, latched at the first ingest:
        #: SR NTP times are real wall-clock times that advance with the
        #: relay's monotonic clock
        self._wall_base: float | None = None
        #: the earliest relay ms an output could need an originated SR
        #: (``relay_rtcp`` returns at once before it, with nothing buffered)
        self._next_sr_due_ms = 0
        #: reception accounting for the upstream RRs (RFC 3550 A.3)
        self._rr_base_seq: int | None = None
        self._rr_max_seq = 0
        self._rr_cycles = 0
        self._rr_received = 0
        self._rr_prev_expected = 0
        self._rr_prev_received = 0
        #: the FEC tier's per-stream engine (``relay.fec.StreamFec``),
        #: made when the first FEC output joins
        self.fec = None
        #: outputs with a resend sweep (``tick``), run by the pump
        self.tickable_outputs: list[RelayOutput] = []

    # -- ingest ------------------------------------------------------------
    def _note_rtp_ingested(self, pid: int) -> None:
        """Per-packet ingest bookkeeping: RR reception accounting and the
        keyframe-run bookmark."""
        ring = self.rtp_ring
        s = ring.slot(pid)
        n = int(ring.length[s])
        self.stats.packets_in += 1
        self.stats.bytes_in += n
        if n >= 12:
            seq = int(ring.seq[s])
            if self._rr_base_seq is None:
                self._rr_base_seq = self._rr_max_seq = seq
            elif (seq - self._rr_max_seq) & 0xFFFF < 0x8000:
                if seq < self._rr_max_seq:     # in order or a small gap
                    self._rr_cycles += 1       # wrapped
                self._rr_max_seq = seq
            self._rr_received += 1
        if int(ring.flags[s]) & PacketFlags.KEYFRAME_FIRST:
            if not self._kf_run_active:
                self.keyframe_id = pid
                self.has_keyframe_update = True
                self.stats.keyframes += 1
                self._kf_run_active = True
        else:
            self._kf_run_active = False

    def _latch_wall_base(self, now_ms: int) -> None:
        if self._wall_base is None:
            self._wall_base = time.time() - now_ms / 1000.0

    def push_rtp(self, packet: bytes, now_ms: int) -> int:
        self._latch_wall_base(now_ms)
        pid = self.rtp_ring.push(packet, now_ms)
        if pid >= 0:
            self._note_rtp_ingested(pid)
        return pid

    def push_rtcp(self, packet: bytes, now_ms: int) -> int:
        return self.rtcp_ring.push(packet, now_ms, is_rtcp=True)

    # -- output management -------------------------------------------------
    def add_output(self, output: RelayOutput, *,
                   bucket: int | None = None) -> None:
        """Place in the first bucket with a free slot, growing the bucket
        array as needed; ``bucket`` pins an explicit index instead."""
        self._next_sr_due_ms = 0        # a new output: its SR is due now
        if hasattr(output, "tick"):     # reliable UDP's resend sweeps
            self.tickable_outputs.append(output)
        if getattr(output, "fec", None) is not None:
            if self.fec is None:
                from .fec import StreamFec
                self.fec = StreamFec(self, output.fec.cfg)
            self.fec.add_output(output)
        if bucket is not None:
            while len(self.buckets) <= bucket:
                self.buckets.append([])
            self.buckets[bucket].append(output)
            return
        for b in self.buckets:
            if len(b) < self.settings.bucket_size:
                b.append(output)
                return
        self.buckets.append([output])

    def remove_output(self, output: RelayOutput) -> bool:
        if output in self.tickable_outputs:
            self.tickable_outputs.remove(output)
        if self.fec is not None:
            self.fec.remove_output(output)
        for bucket in self.buckets:
            if output in bucket:
                bucket.remove(output)
                return True
        return False

    @property
    def outputs(self) -> list[RelayOutput]:
        return [o for b in self.buckets for o in b]

    @property
    def num_outputs(self) -> int:
        return sum(len(b) for b in self.buckets)

    # -- new-output placement ---------------------------------------------
    def first_packet_for_new_output(self, now_ms: int) -> int | None:
        """Fast-start resume point for a just-added output."""
        ring = self.rtp_ring
        if len(ring) == 0:
            return None
        if self.keyframe_id is not None and ring.valid(self.keyframe_id):
            age = now_ms - ring.get_arrival(self.keyframe_id)
            if age <= self.settings.overbuffer_ms:
                return self.keyframe_id
        for pid in ring.ids():
            if now_ms - ring.get_arrival(pid) <= self.settings.overbuffer_ms:
                return pid
        return ring.head - 1

    # -- fan-out (scalar oracle) -------------------------------------------
    def reflect(self, now_ms: int) -> int:
        """One fan-out pass; returns packets written.  Per-bucket delay
        stagger, per-output bookmark, stop-on-WouldBlock (the bookmark
        holds for replay next pass), runts (< 12 bytes) skipped, thinned
        frames skipped for their output only; then ``relay_rtcp``."""
        ring = self.rtp_ring
        sent = 0
        for b_idx, bucket in enumerate(self.buckets):
            deadline = now_ms - b_idx * self.settings.bucket_delay_ms
            for out in bucket:
                if out.bookmark is None:
                    out.bookmark = self.first_packet_for_new_output(now_ms)
                    if out.bookmark is None:
                        continue
                if out.bookmark < ring.tail:   # evicted under a stalled output
                    out.bookmark = ring.tail
                pid = out.bookmark
                while pid < ring.head:
                    if ring.get_arrival(pid) > deadline:
                        break
                    data = ring.get(pid)
                    if len(data) < 12:         # runt: skip, never parse
                        pid += 1
                        continue
                    if not out.thinning.admit(
                            int(ring.flags[ring.slot(pid)])):
                        pid += 1               # a frame thinned for out
                        continue
                    res = out.write_rtp(data)
                    if res is WriteResult.WOULD_BLOCK:
                        self.stats.stalls += 1
                        break
                    pid += 1
                    if res is WriteResult.OK:
                        sent += 1
                out.bookmark = pid
        self.stats.packets_out += sent
        self.relay_rtcp(now_ms)
        return sent

    # -- RTCP: relay, SR origination, upstream RRs -------------------------
    def src_ts_now(self, now_ms: int) -> int | None:
        """The source-timeline RTP timestamp of ``now_ms``: the newest
        packet's timestamp extrapolated by its age at the stream's clock
        rate (``RTPSessionOutput.cpp:436-446``)."""
        ring = self.rtp_ring
        if len(ring) == 0:
            return None
        s = ring.slot(ring.head - 1)
        age_ms = max(now_ms - int(ring.arrival[s]), 0)
        rate = self.info.clock_rate or 90000
        return (int(ring.timestamp[s]) + age_ms * rate // 1000) & 0xFFFFFFFF

    def relay_rtcp(self, now_ms: int) -> None:
        """Forward the newest pusher RTCP compound, rebased onto each
        output's timeline, and originate an SR for each output that has
        had none for ``SR_INTERVAL_MS`` (a pusher that sends no RTCP would
        leave its players without an NTP↔RTP mapping, so no A/V sync).
        An output whose rebase has not latched gets no SR: the
        source-timeline pair would poison its sync; it is checked again
        every pass until it latches.  SR NTP time is the wall-clock base
        plus the relay clock, so both engines give the same bytes.  The
        FEC tier's parity goes first, before the early return: a pusher
        that sends no RTCP still gets its players' parity."""
        if self.fec is not None:
            self.fec.tick(now_ms)
        rring = self.rtcp_ring
        if len(rring) == 0 and now_ms < self._next_sr_due_ms:
            return                  # nothing buffered, no SR due
        self._latch_wall_base(now_ms)
        unix_time = self._wall_base + now_ms / 1000.0
        ts_now = self.src_ts_now(now_ms)
        outputs = self.outputs
        if len(rring):
            newest = rring.get(rring.head - 1)
            has_sr = rtcp_mod.compound_has_sr(newest)
            for out in outputs:
                if has_sr and out.rewrite.base_src_ts < 0:
                    continue        # originated right after the latch
                out.write_rtcp(newest, src_ts_now=ts_now,
                               unix_time=unix_time)
                if has_sr:
                    out.last_sr_ms = now_ms
            rring.tail = rring.head
        next_due = now_ms + SR_INTERVAL_MS
        for out in outputs:
            if out.rewrite.base_src_ts < 0:
                next_due = now_ms
                continue
            if ts_now is not None and (
                    out.last_sr_ms == 0
                    or now_ms - out.last_sr_ms >= SR_INTERVAL_MS):
                out.last_sr_ms = now_ms
                out.send_bytes(rtcp_mod.build_server_compound(
                    out.rewrite.ssrc, SR_CNAME, unix_time=unix_time,
                    rtp_ts=out.rewrite.map_ts(ts_now),
                    packet_count=out.packets_sent,
                    octet_count=out.payload_octets), is_rtcp=True)
            next_due = min(next_due, out.last_sr_ms + SR_INTERVAL_MS)
        self._next_sr_due_ms = next_due

    def send_upstream_rr(self, now_ms: int) -> bool:
        """A receiver report to the pusher every ``SR_INTERVAL_MS``, with
        the RFC 3550 A.3 reception figures of the pushed stream (the
        cumulative loss is signed: duplicates drive it negative).
        Returns True when one was sent."""
        if (self.upstream_rtcp is None or self._rr_base_seq is None
                or now_ms - self.last_upstream_rr_ms < SR_INTERVAL_MS):
            return False
        self.last_upstream_rr_ms = now_ms
        ext_max = (self._rr_cycles << 16) | self._rr_max_seq
        expected = ext_max - self._rr_base_seq + 1
        lost = expected - self._rr_received
        d_exp = expected - self._rr_prev_expected
        d_rcv = self._rr_received - self._rr_prev_received
        self._rr_prev_expected = expected
        self._rr_prev_received = self._rr_received
        frac = 0
        if d_exp > 0 and d_exp > d_rcv:
            frac = min(int(((d_exp - d_rcv) << 8) / d_exp), 255)
        ring = self.rtp_ring
        src_ssrc = int(ring.ssrc[ring.slot(ring.head - 1)]) if len(ring) \
            else 0
        rr = rtcp_mod.ReceiverReport(
            self.reporter_ssrc,
            [rtcp_mod.ReportBlock(src_ssrc, frac, lost, ext_max,
                                  0, 0, 0)]).to_bytes()
        try:
            self.upstream_rtcp(rr)
        except OSError:
            # a dead transport: stop trying
            self.upstream_rtcp = self.upstream_rtcp_owner = None
        return True

    # -- maintenance -------------------------------------------------------
    def prune(self, now_ms: int) -> int:
        """Age-based eviction with bookmark + keyframe pinning."""
        pins = [o.bookmark for o in self.outputs if o.bookmark is not None]
        if self.keyframe_id is not None:
            pins.append(self.keyframe_id)
        pin = min(pins) if pins else None
        n = self.rtp_ring.evict_older_than(now_ms, self.settings.max_age_ms, pin)
        if (self.keyframe_id is not None
                and not self.rtp_ring.valid(self.keyframe_id)):
            self.keyframe_id = None
        return n
