"""Fixed-shape packet ring with absolute packet ids.

A struct-of-arrays ring replaces the reflector's linked packet queue:

* ``data``     uint8  [capacity, SLOT_SIZE]  packet bytes, zero-padded
* ``length``   int32  [capacity]
* ``arrival``  int64  [capacity]             arrival time, ms
* ``flags``    int32  [capacity]             bitfield (RTCP / keyframe / …)
* ``seq``      int32  [capacity]             RTP sequence (host byte order)
* ``timestamp``/``ssrc`` int64 [capacity]

A packet admitted at absolute id ``i`` lives in slot ``i % capacity`` until
``tail`` passes it.  Bookmarks are plain integers, immune to slot reuse
because ids never repeat.
"""

from __future__ import annotations

import numpy as np

from ..protocol import mjpeg, nalu, rtp

#: reflector slot size (kMaxReflectorPacketSize)
SLOT_SIZE = 2060
#: reflector queue cap
DEFAULT_CAPACITY = 4096


class PacketFlags:
    RTCP = 1 << 0
    KEYFRAME_FIRST = 1 << 1      # IsKeyFrameFirstPacket
    FRAME_FIRST = 1 << 2         # IsFrameFirstPacket
    FRAME_LAST = 1 << 3          # marker bit
    VIDEO = 1 << 4


class PacketRing:
    """Bounded packet store with absolute ids ``[tail, head)``."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 slot_size: int = SLOT_SIZE, is_video: bool = False,
                 codec: str | None = None):
        """``codec`` selects the ingest classifier: "H264" (default for
        video) walks NALU types; "JPEG"/"MJPEG" marks every
        fragment-offset-0 packet keyframe-first."""
        self.capacity = capacity
        self.slot_size = slot_size
        self.is_video = is_video
        self.codec = (codec or ("H264" if is_video else "")).upper()
        self.data = np.zeros((capacity, slot_size), dtype=np.uint8)
        self.length = np.zeros(capacity, dtype=np.int32)
        self.arrival = np.zeros(capacity, dtype=np.int64)
        self.flags = np.zeros(capacity, dtype=np.int32)
        self.seq = np.zeros(capacity, dtype=np.int32)
        self.timestamp = np.zeros(capacity, dtype=np.int64)
        self.ssrc = np.zeros(capacity, dtype=np.int64)
        self.head = 0            # next id to assign
        self.tail = 0            # oldest live id
        self.total_dropped = 0
        self.total_oversize = 0  # dropped: larger than the slot

    def __len__(self) -> int:
        return self.head - self.tail

    def slot(self, pkt_id: int) -> int:
        return pkt_id % self.capacity

    def valid(self, pkt_id: int) -> bool:
        return self.tail <= pkt_id < self.head

    def classify_slot(self, s: int, packet: bytes, *,
                      is_rtcp: bool = False) -> None:
        """Flags + parsed RTP fields for a just-filled slot."""
        f = 0
        if is_rtcp:
            f |= PacketFlags.RTCP
        else:
            if self.is_video:
                f |= PacketFlags.VIDEO
                if self.codec in ("JPEG", "MJPEG", "MJPG"):
                    if mjpeg.is_frame_first_packet(packet):
                        f |= PacketFlags.KEYFRAME_FIRST | PacketFlags.FRAME_FIRST
                else:
                    if nalu.is_keyframe_first_packet(packet):
                        f |= PacketFlags.KEYFRAME_FIRST
                    if nalu.is_frame_first_packet(packet):
                        f |= PacketFlags.FRAME_FIRST
            if nalu.is_frame_last_packet(packet):
                f |= PacketFlags.FRAME_LAST
            if len(packet) >= 12:
                self.seq[s] = rtp.peek_seq(packet)
                self.timestamp[s] = rtp.peek_timestamp(packet)
                self.ssrc[s] = rtp.peek_ssrc(packet)
        self.flags[s] = f

    def push(self, packet: bytes, arrival_ms: int, *,
             is_rtcp: bool = False) -> int:
        """Admit one packet, classifying keyframe boundaries on ingest.
        Returns the absolute id, or −1 when the packet exceeds the slot and
        is dropped (a truncated slot would relay a corrupt packet)."""
        if len(packet) > self.slot_size:
            self.total_oversize += 1
            return -1
        if len(self) >= self.capacity:
            self.tail += 1          # overwrite-oldest
            self.total_dropped += 1
        pid = self.head
        s = self.slot(pid)
        n = len(packet)
        self.data[s, :n] = np.frombuffer(packet, dtype=np.uint8)
        if n < self.slot_size:
            self.data[s, n:] = 0
        self.length[s] = n
        self.arrival[s] = arrival_ms
        self.classify_slot(s, packet, is_rtcp=is_rtcp)
        self.head = pid + 1
        return pid

    def push_block(self, data: np.ndarray, length: np.ndarray,
                   arrival_ms: np.ndarray, flags: np.ndarray,
                   seq: np.ndarray, timestamp: np.ndarray) -> int:
        """Admit ``n`` pre-classified packets (``data [n, <= slot_size]``
        uint8 rows and their per-packet metadata) into consecutive slots
        in a few array copies: the VOD pacer's fill from a packed cache
        window, which was parsed and classified once when it was packed.
        Each row's RTP seq bytes are restamped from ``seq``, so one shared
        canonical window serves every subscriber's ring.  Returns the
        absolute id of the first packet."""
        n = len(length)
        if n == 0:
            return self.head
        if n > self.capacity:
            raise ValueError(f"push_block of {n} > capacity {self.capacity}")
        overflow = len(self) + n - self.capacity
        if overflow > 0:                 # overwrite-oldest, like push()
            self.tail += overflow
            self.total_dropped += overflow
        first = self.head
        slots = np.arange(first, first + n) % self.capacity
        w = min(data.shape[1], self.slot_size)
        self.data[slots, :w] = data[:, :w]
        if w < self.slot_size:
            self.data[slots, w:] = 0
        sq = (np.asarray(seq, np.int64) & 0xFFFF).astype(">u2")
        self.data[slots, 2:4] = sq[:, None].view(np.uint8)
        self.length[slots] = length
        self.arrival[slots] = arrival_ms
        self.flags[slots] = flags
        self.seq[slots] = np.asarray(seq, np.int64) & 0xFFFF
        self.timestamp[slots] = timestamp
        self.ssrc[slots] = 0
        self.head = first + n
        return first

    def native_drain(self, fd: int, now_ms: int, max_pkts: int = 512) -> int:
        """Drain the datagrams pending on the non-blocking socket ``fd``
        straight into the ring's slots through the egress core's recvmmsg
        batches (``native.udp_ingest``), then classify each admitted slot
        as ``push`` does.  At most one ring's worth a call, so the
        overwrite-oldest accounting stays exact; a datagram larger than
        the slot is dropped and counted in ``total_oversize``.  Returns
        the packets admitted."""
        from .. import native
        n, new_head, oversize = native.udp_ingest(
            fd, self.data, self.length, self.arrival, now_ms, self.head,
            min(max_pkts, self.capacity))
        self.total_oversize += oversize
        for pid in range(self.head, new_head):
            s = self.slot(pid)
            self.classify_slot(s, self.data[s, :self.length[s]].tobytes())
        self.head = new_head
        if len(self) > self.capacity:       # the batch wrapped the ring
            dropped = len(self) - self.capacity
            self.tail += dropped
            self.total_dropped += dropped
        return n

    def get(self, pkt_id: int) -> bytes:
        if not self.valid(pkt_id):
            raise IndexError(f"packet {pkt_id} not in [{self.tail}, {self.head})")
        s = self.slot(pkt_id)
        return self.data[s, :self.length[s]].tobytes()

    def get_arrival(self, pkt_id: int) -> int:
        return int(self.arrival[self.slot(pkt_id)])

    def evict_older_than(self, now_ms: int, max_age_ms: int,
                         pin_id: int | None = None) -> int:
        """Advance ``tail`` past packets older than ``max_age_ms``, but
        never past ``pin_id`` (packets still needed by an output or by the
        keyframe index survive)."""
        limit = self.head if pin_id is None else min(pin_id, self.head)
        evicted = 0
        while self.tail < limit:
            if now_ms - self.get_arrival(self.tail) <= max_age_ms:
                break
            self.tail += 1
            evicted += 1
        return evicted

    def ids(self, start: int | None = None) -> range:
        return range(max(self.tail, start if start is not None else self.tail),
                     self.head)

    def window_meta(self, start: int, count: int):
        """(ids, length, flags) of up to ``count`` packets from absolute id
        ``start`` — metadata only, no payload copy."""
        start = max(start, self.tail)
        stop = min(start + count, self.head)
        if stop <= start:
            z = np.zeros(0, dtype=np.int64)
            return z, self.length[:0], self.flags[:0]
        idx = np.arange(start, stop) % self.capacity
        return np.arange(start, stop), self.length[idx], self.flags[idx]
