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
``next_deadline_ms`` says when the stream next needs a pump pass without
new ingest (a held bucket's release, a resend's RTO): the pump's timer
wheel sleeps until the earliest one.

Observability (``obs``): each output joins the audience store's block of
its stream at ``add_output`` and leaves it at ``remove_output`` (with a
``stream.output_add``/``_remove`` event); ``reflect`` observes the
ingest-to-wire latency of every packet it delivers (engine ``scalar``)
and feeds the audience store and the profiler's session attribution;
``relay_rtcp`` charges the FEC tier's parity to the wake ledger's
``fec_parity`` class.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

import numpy as np

from .. import obs
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


class Delivered:
    """The packets one rung's pass delivered: every ring slot (for the
    ingest-to-wire latency) and, per output with an audience row, its
    row, packets, bytes, first and last ring id and its slots; ``note``
    files them once the pass is on the wire.  The one per-output
    accumulation of ``RelayStream.reflect`` and the engine's TCP, scalar
    and batch rungs."""

    __slots__ = ("slots", "nbytes", "rows", "pkts", "byts", "first", "last",
                 "a_slots")

    def __init__(self):
        self.slots: list[np.ndarray] = []
        self.nbytes = 0
        self.rows: list[int] = []
        self.pkts: list[int] = []
        self.byts: list[int] = []
        self.first: list[int] = []
        self.last: list[int] = []
        self.a_slots: list[np.ndarray] = []

    def add(self, out, slots: np.ndarray, nbytes: int, first_pid: int,
            last_pid: int) -> None:
        self.slots.append(slots)
        self.nbytes += nbytes
        row = getattr(out, "audience_row", -1)
        if row >= 0:
            self.rows.append(row)
            self.pkts.append(len(slots))
            self.byts.append(nbytes)
            self.first.append(first_pid)
            self.last.append(last_pid)
            self.a_slots.append(slots)

    def note(self, stream, engine: str, wire_ns: int) -> None:
        """Observe the latencies and apply the audience columns."""
        if not self.slots:
            return
        arrival_ns = stream.rtp_ring.arrival_ns
        lat_s = (wire_ns - arrival_ns[np.concatenate(self.slots)]) / 1e9
        if self.rows and stream.audience is not None:
            # every delivering output has a row (the usual case): the
            # same latencies, in the same order
            a_lat = (lat_s if len(self.a_slots) == len(self.slots) else
                     (wire_ns - arrival_ns[np.concatenate(self.a_slots)])
                     / 1e9)
            obs.AUDIENCE.note_pass(stream.audience, self.rows, self.pkts,
                                   self.byts, self.first, self.last, a_lat,
                                   wire_ns)
        note_latency(stream, engine, lat_s)


def note_latency(stream, engine: str, lat_s: np.ndarray) -> None:
    """One rung's ingest-to-wire latencies: the histogram, the wake
    ledger's queue age and the profiler's session attribution."""
    if not lat_s.size:
        return
    obs.RELAY_INGEST_TO_WIRE.observe_many(lat_s, engine=engine)
    if obs.LEDGER.enabled:
        obs.LEDGER.note_queue_age(float(lat_s.max()), lat_s.size)
    obs.PROFILER.account_latency(stream.session_path, lat_s)


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
        #: the session's trace id (``RelaySession.set_trace``), carried on
        #: the engine's spans
        self.trace_id: str | None = None
        #: this stream's audience column block (``obs.audience``), set at
        #: the first ``add_output``, and the tier its outputs count under
        self.audience = None
        self.audience_tier = "live"
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
        #: the pump's last pass over this stream stalled an output (a due
        #: release then waits for ingest or the tick, not the wheel)
        self.last_pass_stalled = False
        #: packets and non-empty drains of the native UDP ingest
        self.native_ingest_pkts = 0
        self.native_ingest_batches = 0

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

    def drain_rtp_native(self, fd: int, now_ms: int,
                         max_pkts: int = 512) -> int:
        """Drain a UDP pusher's RTP socket straight into the ring
        (``PacketRing.native_drain``: recvmmsg batches, no Python per
        datagram on the receive), then run ``push_rtp``'s per-packet
        bookkeeping for every admitted id, so the RR accounting, the
        keyframe-run bookmark and every ring reading this one see the
        batch as they see the same packets pushed one by one.  Returns
        the packets admitted."""
        self._latch_wall_base(now_ms)
        pre = self.rtp_ring.head
        n = self.rtp_ring.native_drain(fd, now_ms, max_pkts)
        for pid in range(pre, self.rtp_ring.head):
            self._note_rtp_ingested(pid)
        if n > 0:
            self.native_ingest_batches += 1
            self.native_ingest_pkts += n
        return n

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
        else:
            for b in self.buckets:
                if len(b) < self.settings.bucket_size:
                    b.append(output)
                    break
            else:
                self.buckets.append([output])
        obs.AUDIENCE.register(self, output)
        obs.EVENTS.emit("stream.output_add", stream=self.session_path,
                        trace_id=self.trace_id,
                        session_id=getattr(output, "session_id", None),
                        track=self.info.track_id, outputs=self.num_outputs)

    def remove_output(self, output: RelayOutput) -> bool:
        if output in self.tickable_outputs:
            self.tickable_outputs.remove(output)
        if self.fec is not None:
            self.fec.remove_output(output)
        for bucket in self.buckets:
            if output in bucket:
                bucket.remove(output)
                obs.AUDIENCE.unregister(output)
                obs.EVENTS.emit(
                    "stream.output_remove", stream=self.session_path,
                    trace_id=self.trace_id,
                    session_id=getattr(output, "session_id", None),
                    track=self.info.track_id, outputs=self.num_outputs)
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
        delivered = Delivered()
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
                o_slots: list[int] = []
                o_byts = 0
                o_first = -1
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
                        o_slots.append(ring.slot(pid - 1))
                        o_byts += len(data)
                        if o_first < 0:
                            o_first = pid - 1
                        o_last = pid - 1
                out.bookmark = pid
                if o_slots:
                    sent += len(o_slots)
                    delivered.add(out, np.asarray(o_slots, np.int64), o_byts,
                                  o_first, o_last)
        self.stats.packets_out += sent
        if delivered.slots:
            delivered.note(self, "scalar", time.perf_counter_ns())
            if self.session_path is not None:
                obs.PROFILER.account_pass("scalar", 0, {},
                                          path=self.session_path,
                                          wire_bytes=delivered.nbytes)
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
            # parity runs nested in the live-relay pass: charged to its
            # own ledger class, so ``live_relay``'s service stays conserved
            tok = obs.LEDGER.unit_start()
            self.fec.tick(now_ms)
            obs.LEDGER.unit_end(tok, "fec_parity")
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

    def next_deadline_ms(self, now_ms: int, *, allow_due: bool = False
                         ) -> int:
        """ms until this stream next needs a pump pass without new ingest:
        the earliest bucket-delay release among held-back packets (bucket
        0 has no delay), or the earliest future reliable-UDP RTO.  -1 =
        nothing scheduled.  Reads the ring's host arrival times only.

        ``allow_due`` controls releases already due: a caller that knows
        the stream's last pass did NOT stall arms them at 1 ms (the
        release matured mid-pass and the next pass sends it); for a
        stalled stream they are left out, since a time wake cannot make a
        blocked socket writable and 1 ms timers would spin the pump until
        the client drains.  Future RTOs are always reported, due ones
        never (the sweep that just ran handled them)."""
        best = -1
        ring = self.rtp_ring
        delay = self.settings.bucket_delay_ms
        for b_idx, bucket in enumerate(self.buckets):
            if b_idx == 0:
                continue
            for out in bucket:
                bm = out.bookmark
                if bm is None or bm >= ring.head:
                    continue
                if bm < ring.tail:
                    bm = ring.tail
                d = int(ring.arrival[ring.slot(bm)]) + b_idx * delay - now_ms
                if d <= 0:
                    if not allow_due:
                        continue
                    d = 1
                if best < 0 or d < best:
                    best = d
        for out in self.tickable_outputs:
            d = out.resender.next_deadline_ms(now_ms)
            if d > 0 and (best < 0 or d < best):
                best = d
        return best

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
