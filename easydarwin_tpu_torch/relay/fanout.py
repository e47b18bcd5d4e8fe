"""The fan-out engine of the megabatch path.

``RelayStream.reflect`` is the scalar oracle.  ``FanoutEngine`` serves the
same outputs from the affine params the megabatch scheduler computed on the
device (``relay.megabatch``): it renders every (subscriber, packet) header
from O(P) packet fields and O(S) offsets in one numpy pass
(``render_headers``) and writes ``header ∥ packet[12:]`` through each
output's ``send_rewritten``.  Payload bytes never go to the device and are
never rewritten per subscriber.

The engine never computes params itself: a stream whose installed segment
is missing or stale this wake sends nothing this wake, and its bookmarks
do not move.  For the same ring and output state its bytes equal those of
``RelayStream.reflect`` (tested).
"""

from __future__ import annotations

import numpy as np

from .output import WriteResult
from .stream import RelayStream


def render_headers(b01: np.ndarray, seq: np.ndarray, ts: np.ndarray,
                   seq_off: np.ndarray, ts_off: np.ndarray,
                   ssrc: np.ndarray) -> np.ndarray:
    """[S, P, 12] uint8 headers from O(P) packet fields + O(S) output
    offsets; byte-identical to ``ops.fanout.fanout_headers``."""
    S, P = seq_off.shape[0], seq.shape[0]
    out = np.empty((S, P, 12), dtype=np.uint8)
    out[:, :, 0:2] = b01[None, :, :]
    seq_sp = ((seq[None, :].astype(np.uint32) + seq_off[:, None]) & 0xFFFF
              ).astype(">u2")
    out[:, :, 2:4] = seq_sp.view(np.uint8).reshape(S, P, 2)
    ts_sp = (ts[None, :].astype(np.uint32) + ts_off[:, None]).astype(">u4")
    out[:, :, 4:8] = ts_sp.view(np.uint8).reshape(S, P, 4)
    ssrc_sp = np.broadcast_to(ssrc.astype(np.uint32)[:, None], (S, P)
                              ).astype(">u4")
    out[:, :, 8:12] = ssrc_sp.view(np.uint8).reshape(S, P, 4)
    return out


def params_key(outputs) -> tuple:
    """The affine-params cache key: one 6-tuple of rewrite state per
    output, in list order (the 6th element is the interleave channel byte,
    −1 for datagram outputs).  The one definition the engine and the
    megabatch scheduler share."""
    def _chan(o):
        ch = getattr(o, "interleave_chan", None)
        return -1 if ch is None else (ch & 0xFF)
    return tuple((o.rewrite.ssrc, o.rewrite.base_src_seq,
                  o.rewrite.base_src_ts, o.rewrite.out_seq_start,
                  o.rewrite.out_ts_start, _chan(o)) for o in outputs)


class FanoutEngine:
    """Batched fan-out for one stream, fed by the megabatch scheduler.

    Stateless between steps apart from the installed params; all mutable
    relay state stays in the stream and its outputs."""

    def __init__(self):
        self.steps = 0
        self.packets_sent = 0
        self.last_newest_keyframe = -1
        #: (params_key, (seq_off, ts_off, ssrc, chan)) installed by the
        #: scheduler's last harvest or prime pass for this stream
        self.megabatch_params: tuple | None = None
        self.megabatch_installs = 0
        #: steps that found no installed params for the current key
        self.missing_params = 0
        self._params_key = None
        self._params = None           # ([1,S] seq_off, ts_off, ssrc, chan)

    def _flat_outputs(self, stream: RelayStream):
        return [(out, b_idx) for b_idx, bucket in enumerate(stream.buckets)
                for out in bucket]

    def fast_from_flat(self, flat) -> list:
        """The outputs this engine serves, in the order ``params_key`` and
        the device state matrix are built in: every primed output."""
        return [o for o, _ in flat if o.bookmark is not None]

    def fast_outputs(self, stream: RelayStream) -> list:
        return self.fast_from_flat(self._flat_outputs(stream))

    def _prime(self, stream: RelayStream, flat, now_ms: int) -> None:
        """New-output placement + seq/ts rebase latch.

        The scalar oracle latches the rebase origin exactly once, inside
        the first ``write_rtp`` *attempt* (even a WOULD_BLOCK'd one).
        Mirror that: latch only if unlatched, from the first ring packet
        this output would attempt this pass (bookmark advanced past runts,
        and only if that packet is bucket-eligible now).  Idempotent
        within a wake, so the scheduler and the step may both run it."""
        ring = stream.rtp_ring
        delay = stream.settings.bucket_delay_ms
        for out, b_idx in flat:
            if out.bookmark is None:
                out.bookmark = stream.first_packet_for_new_output(now_ms)
            if out.bookmark is not None and out.bookmark < ring.tail:
                out.bookmark = ring.tail
            if out.rewrite.base_src_seq >= 0 or out.bookmark is None:
                continue
            pid = out.bookmark
            while pid < ring.head and ring.length[ring.slot(pid)] < 12:
                pid += 1               # runts are skipped, never latched
            if pid >= ring.head:
                continue
            s = ring.slot(pid)
            if now_ms - int(ring.arrival[s]) >= b_idx * delay:
                out.rewrite.base_src_seq = int(ring.seq[s])
                out.rewrite.base_src_ts = int(ring.timestamp[s])

    def _installed_params(self, outputs):
        key = params_key(outputs)
        if key == self._params_key:
            return self._params
        mb = self.megabatch_params
        if mb is not None and mb[0] == key:
            self._params = mb[1]
            self._params_key = key
            self.megabatch_installs += 1
            return self._params
        return None

    def step(self, stream: RelayStream, now_ms: int) -> int:
        """One fan-out pass over ``stream``; returns packets written."""
        ring = stream.rtp_ring
        flat = self._flat_outputs(stream)
        if not flat or len(ring) == 0:
            return 0
        self._prime(stream, flat, now_ms)
        flat = [(o, b) for o, b in flat if o.bookmark is not None]
        if not flat:
            return 0
        params = self._installed_params([o for o, _ in flat])
        if params is None:
            self.missing_params += 1
            return 0
        seq_off, ts_off, ssrc, _chan = params
        start = min(o.bookmark for o, _ in flat)
        ids, lengths, _flags = ring.window_meta(start, ring.head - start)
        if len(ids) == 0:
            return 0
        start = int(ids[0])                 # window_meta clamps to tail
        idx = ids % ring.capacity
        arrivals = ring.arrival[idx]
        headers = render_headers(ring.data[idx, :2], ring.seq[idx],
                                 ring.timestamp[idx], seq_off[0], ts_off[0],
                                 ssrc[0])
        delay = stream.settings.bucket_delay_ms
        sent = 0
        for s, (out, b_idx) in enumerate(flat):
            deadline = now_ms - b_idx * delay
            pid = out.bookmark
            while pid < ring.head:
                j = pid - start
                # the oracle's order: eligibility first (break holds the
                # bookmark), runt-skip second (advance)
                if arrivals[j] > deadline:
                    break
                n = int(lengths[j])
                if n < 12:
                    pid += 1
                    continue
                wr = out.send_rewritten(headers[s, j].tobytes(),
                                        ring.data[idx[j], 12:n].tobytes())
                if wr is WriteResult.WOULD_BLOCK:
                    out.stalls += 1
                    stream.stats.stalls += 1
                    break
                pid += 1
                if wr is WriteResult.OK:
                    out.packets_sent += 1
                    out.bytes_sent += n
                    out.payload_octets += n - 12
                    sent += 1
            out.bookmark = pid
        stream.stats.packets_out += sent
        self.steps += 1
        self.packets_sent += sent
        return sent
