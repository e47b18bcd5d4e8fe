"""Per-track relay stream: ring, keyframe index, bucketed fan-out.

Outputs live in buckets of ``bucket_size``; bucket *b*'s sends are delayed
``b × bucket_delay_ms`` to smooth the egress burst, so a packet is eligible
for bucket *b* at ``arrival + b·delay ≤ now``.  New outputs fast-start from
the newest keyframe run head when the stream is video, otherwise from the
oldest packet inside the over-buffer window.  Eviction keeps everything an
output still needs (bookmark pinning) up to ``max_age_ms``.

``reflect`` is the scalar oracle: one packet at a time through each
output's ``write_rtp``.  The serving path is ``relay.fanout.FanoutEngine``
fed by the megabatch scheduler; both deliver the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..protocol.sdp import StreamInfo
from .output import RelayOutput, WriteResult
from .ring import DEFAULT_CAPACITY, PacketFlags, PacketRing


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

    # -- ingest ------------------------------------------------------------
    def _note_rtp_ingested(self, pid: int) -> None:
        ring = self.rtp_ring
        s = ring.slot(pid)
        self.stats.packets_in += 1
        self.stats.bytes_in += int(ring.length[s])
        if int(ring.flags[s]) & PacketFlags.KEYFRAME_FIRST:
            if not self._kf_run_active:
                self.keyframe_id = pid
                self.has_keyframe_update = True
                self.stats.keyframes += 1
                self._kf_run_active = True
        else:
            self._kf_run_active = False

    def push_rtp(self, packet: bytes, now_ms: int) -> int:
        pid = self.rtp_ring.push(packet, now_ms)
        if pid >= 0:
            self._note_rtp_ingested(pid)
        return pid

    # -- output management -------------------------------------------------
    def add_output(self, output: RelayOutput, *,
                   bucket: int | None = None) -> None:
        """Place in the first bucket with a free slot, growing the bucket
        array as needed; ``bucket`` pins an explicit index instead."""
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
        holds for replay next pass), runts (< 12 bytes) skipped."""
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
                    res = out.write_rtp(data)
                    if res is WriteResult.WOULD_BLOCK:
                        self.stats.stalls += 1
                        break
                    pid += 1
                    if res is WriteResult.OK:
                        sent += 1
                out.bookmark = pid
        self.stats.packets_out += sent
        return sent

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
