"""The fan-out engine: one stream's wire writes from device-computed params.

``RelayStream.reflect`` is the scalar oracle.  ``FanoutEngine`` serves the
same outputs on four rungs.  Three of them write from the affine rewrite
params (``seq_off``, ``ts_off``, ``ssrc``, ``chan`` per output) that the
device computed:

* **UDP fast** — outputs with a ``native_addr`` (the server's shared
  egress socket): ONE ``sendmmsg``/UDP-GSO scatter of every eligible
  (packet, output) pair through the egress core (``native``), the header
  rewritten in C;
* **TCP fast** — interleaved outputs whose socket is directly writable:
  ONE framed ``writev`` per connection (``native.stream_send``), a torn
  packet's remainder completed through ``push_tail``;
* **the loop** — every other primed output (``CollectingOutput``, an
  interleaved output whose transport holds a backlog, a UDP player on a
  port pair of its own): headers rendered by numpy (``render_headers``)
  and written through ``send_rewritten``.

The fourth, the **batch-header rung**, serves the outputs the other three
must not: a meta-info output (its packets are wrapped), a thinned one
(``thinning.passthrough()`` false: its filter drops frames) and a reliable
UDP output (``records_sends``: every datagram enters its resend window).
It renders their headers with ``ops.fanout.relay_batch_step`` (B9; ONE
``ed_relay_batch`` launch on the card, fed by one upload from pinned
memory, with only the headers copied back) and walks each output through
``admit`` and ``send_rewritten`` in the oracle's order.  A FEC output stays on the UDP
fast rung; its parity and RTX leave through ``send_bytes`` from
``relay.fec``.  Every pass ends in ``RelayStream.relay_rtcp``.

The canonical order of a stream's primed param-rung outputs is UDP fast,
TCP fast, then the loop; ``params_key``, the scheduler's state rows and
the dest table all follow it, so one set of params covers all three, and
a batch-rung output is never staged by the megabatch.

Where the params come from: the megabatch scheduler installs them
(``megabatch_params``) for the streams it owns.  Otherwise — a stream the
scheduler does not own, or an owned stream whose key went stale mid-wake
(a join, a rebase latch, an output moving between rungs) — the engine
queries its own device-resident ring (``ops.device_ring``; one
``ed_ring_query`` launch on the card), which it keeps current by
appending each wake's new packets.  Params are only recomputed when the
key (membership and rebase state) changes, and every computed set is
checked against the host arithmetic oracle ``host_affine_params`` before
it is used: a disagreement sends nothing on those rungs that wake and
leaves their bookmarks.

For the same ring and output state the bytes equal those of
``RelayStream.reflect`` (tested), apart from the TCP rung's shed of a
reader more than half the ring behind.

Observability (``obs``): each pass is one ``engine.step`` span and one
``tpu_pass_seconds{stage="engine_step"}`` sample, its phases filed with
the profiler by engine: ``native`` (the ring append as ``h2d``, the ring
query as ``device_step`` and ``d2h``, the UDP and TCP scatters as
``egress_native``, the RTCP as ``rtcp_qos``) and ``batch`` (the batch
rung's upload as ``h2d``, its kernel as ``device_step``, its headers'
copy back as ``d2h``).  A device phase on a card is read from a pair of
timing events recorded around its one launch (``ops.staging.
DeviceTimer``) once the engine's own wait on the result is done.  Every
delivered packet's ingest-to-wire latency (against the ring's
``arrival_ns``) feeds ``relay_ingest_to_wire_seconds``, the wake ledger's
queue age, the profiler's session attribution and the audience store,
one vectorized call each a rung.  What the engine uploads and reads back
is counted in ``tpu_h2d_bytes_total`` and ``tpu_d2h_bytes_total``; its
copies go through ``ops.staging``'s counted ``upload`` and ``readback``.
"""

from __future__ import annotations

import errno
import time

import numpy as np
import torch

from .. import native, obs, resolve_device
from ..obs import PROFILER, TRACER
from ..ops import device_ring, staging
from ..ops.fanout import (batch_upload_views, pack_batch_upload,
                          pack_output_state, relay_batch_step, unpack_affine)
from ..ops.parse import PARSE_PREFIX
from ..protocol import rtp
from .output import WriteResult
from .ring import PacketFlags
from .stream import Delivered, RelayStream, note_latency

#: the flags of a packet that starts a video frame (``admit`` counts it)
_VIDEO_FRAME_FIRST = PacketFlags.VIDEO | PacketFlags.FRAME_FIRST

_EAGAIN = (0, errno.EAGAIN, errno.EWOULDBLOCK)


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


def host_affine_params(key) -> tuple:
    """The affine rewrite computed by plain host arithmetic from a
    ``params_key`` — the oracle every device result is checked against
    (the uint32 formulas of ``ops.fanout.affine_params`` over
    ``pack_output_state``'s max(·, 0) clamping; the channel column is a
    passthrough)."""
    st = np.asarray(key, dtype=np.int64).reshape(-1, 6)
    ssrc = (st[:, 0] & 0xFFFFFFFF).astype(np.uint32)
    base_seq = np.maximum(st[:, 1], 0).astype(np.uint32)
    base_ts = np.maximum(st[:, 2], 0).astype(np.uint32)
    seq0 = (st[:, 3] & 0xFFFFFFFF).astype(np.uint32)
    ts0 = (st[:, 4] & 0xFFFFFFFF).astype(np.uint32)
    chan = (st[:, 5] & 0xFFFFFFFF).astype(np.uint32)
    return ((seq0 - base_seq) & np.uint32(0xFFFF), ts0 - base_ts, ssrc,
            chan)


def params_agree(params, key) -> bool:
    """Whether ``(seq_off, ts_off, ssrc, chan)`` ``[1, S]`` rows equal the
    host oracle for ``key``."""
    return all(np.array_equal(a[0], b)
               for a, b in zip(params, host_affine_params(key)))


class _RingStaging:
    """The pinned host rows one append uploads from, reused only after the
    CUDA event recorded behind its copies has completed."""

    __slots__ = ("rows", "arrival", "event")

    def __init__(self, n: int, pin: bool):
        self.rows = torch.zeros((n, device_ring.ROW_STRIDE),
                                dtype=torch.uint8, pin_memory=pin)
        self.arrival = torch.zeros(n, dtype=torch.int32, pin_memory=pin)
        self.event = None


class FanoutEngine:
    """Batched fan-out for one stream.

    ``egress_fd`` is the shared UDP egress socket (−1: none, UDP outputs
    take the loop), written with UDP GSO over ``sendmmsg`` (retried
    without GSO, which is dropped after two strikes); ``device`` holds the
    per-stream ring (resolved at first use)."""

    def __init__(self, *, egress_fd: int = -1,
                 device: str | torch.device = "cuda"):
        self.egress_fd = egress_fd
        self.device = device
        self.steps = 0
        self.packets_sent = 0
        #: packets sent by the native rungs / passes that used them
        self.native_sent = 0
        self.native_passes = 0
        #: per-stream ring queries that installed params
        self.device_param_refreshes = 0
        #: datagrams or packets a hard send error skipped
        self.send_errors = 0
        #: packets the TCP rung skipped for readers more than half the
        #: ring behind (moved forward to the newest keyframe)
        self.tcp_shed_pkts = 0
        #: packets the batch-header rung sent, passes that ran it and the
        #: window rows those passes rendered
        self.batch_sent = 0
        self.batch_passes = 0
        self.batch_rows = 0
        #: host ns of the batch passes' device leg: staging + H2D, and
        #: kernel + D2H (launch, headers copy, the wait on its event)
        self.batch_stage_ns = 0
        self.batch_kernel_ns = 0
        #: packets the loop rung sent and the host ns of its passes (a UDP
        #: player on a port pair of its own takes this rung)
        self.loop_sent = 0
        self.loop_ns = 0
        self._batch_stage: staging.PinnedStage | None = None
        self._batch_dev: torch.device | None = None
        self.last_newest_keyframe = -1
        #: True while the megabatch scheduler owns this stream's device
        #: work (it stages the windows; the engine skips its ring append)
        self.megabatch_owned = False
        #: (params_key, (seq_off, ts_off, ssrc, chan)) installed by the
        #: scheduler's last harvest or prime pass for this stream
        self.megabatch_params: tuple | None = None
        self.megabatch_installs = 0
        #: steps that found no params agreeing with the host oracle
        self.missing_params = 0
        self._params_key = None
        self._params = None           # ([1,S] seq_off, ts_off, ssrc, chan)
        self._dests_key = None
        self._dests = None
        # UDP GSO is tried each pass until proven broken: two passes where
        # it fails and plain sendmmsg works drop it
        self._gso_disabled = False
        self._gso_strikes = 0
        self._dring: device_ring.RingState | None = None
        self._dring_appended = 0      # host pid appended up to
        self._dring_base = 0          # host pid of device abs id 0
        self._dring_epoch = 0         # arrival-ms epoch (int32 room)
        self._stage: _RingStaging | None = None
        self.dring_appends = 0
        #: (engine, phase) → ns of the current pass, filed at its end
        self._pass_phases: dict[tuple[str, str], int] = {}
        self._pass_wire_bytes = 0
        self._pass_ran = False

    def _phase_add(self, phase: str, dur_ns: int,
                   engine: str = "native") -> None:
        key = (engine, phase)
        self._pass_phases[key] = self._pass_phases.get(key, 0) + dur_ns

    # ------------------------------------------------------------ outputs
    def _flat_outputs(self, stream: RelayStream):
        return [(out, b_idx) for b_idx, bucket in enumerate(stream.buckets)
                for out in bucket]

    def _native_ok(self) -> bool:
        return self.egress_fd >= 0 and native.available()

    @staticmethod
    def _batched(out) -> bool:
        """An output only the batch-header rung may serve: its packets are
        wrapped in meta-info, its thinning filter may drop them, or it
        must see each datagram it sends (``records_sends``)."""
        return (out.meta_field_ids is not None or out.records_sends
                or not out.thinning.passthrough())

    @classmethod
    def _fast_eligible(cls, out, native_ok: bool) -> bool:
        """UDP fast rung: a primed plain, unthinned output on the shared
        egress socket."""
        return (native_ok and out.bookmark is not None
                and out.native_addr is not None and not cls._batched(out))

    @classmethod
    def _tcp_eligible(cls, out) -> bool:
        """TCP fast rung: a primed plain, unthinned interleaved output
        whose socket takes raw writes now (nothing buffered that they
        could overtake)."""
        return (out.bookmark is not None and not cls._batched(out)
                and getattr(out, "interleave_chan", None) is not None
                and out.stream_fd >= 0 and out.engine_writable()
                and native.available())

    def split_flat(self, flat) -> tuple[list, list, list, list]:
        """The primed ``(output, bucket)`` pairs as (UDP fast, TCP fast,
        the loop, the batch-header rung)."""
        udp, tcp, rest, batch = [], [], [], []
        native_ok = None
        for out, b_idx in flat:
            if out.bookmark is None:
                continue
            if self._batched(out):
                batch.append((out, b_idx))
                continue
            if out.native_addr is not None:
                if native_ok is None:
                    native_ok = self._native_ok()
                if self._fast_eligible(out, native_ok):
                    udp.append((out, b_idx))
                    continue
            if self._tcp_eligible(out):
                tcp.append((out, b_idx))
            else:
                rest.append((out, b_idx))
        return udp, tcp, rest, batch

    def fast_from_flat(self, flat) -> list:
        """Every primed output of the param rungs in the canonical order
        (UDP fast, TCP fast, the loop): the order ``params_key``, the
        device state rows and the dest table are built in.  Batch-rung
        outputs are not in it."""
        return [o for group in self.split_flat(flat)[:3] for o, _ in group]

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

    # ------------------------------------------------------- device ring
    def _ring_sync(self, ring, now_ms: int) -> None:
        """Append the packets the device ring has not seen (O(new) H2D):
        one gather into pinned staging, at most two slice copies a
        tensor.  A ring that fell behind by more than its capacity, lost
        packets to eviction or nears the int32 head restarts."""
        dr = self._dring
        if (dr is None or ring.head - self._dring_appended > ring.capacity
                or ring.tail > self._dring_appended
                or dr.head > device_ring.MAX_HEAD):
            self._dring = dr = device_ring.init_ring(ring.capacity,
                                                     self.device)
            self._dring_appended = self._dring_base = max(
                ring.tail, ring.head - ring.capacity)
            self._dring_epoch = now_ms
        n = ring.head - self._dring_appended
        if n <= 0:
            return
        t_h = time.perf_counter_ns()
        pin = dr.rows.device.type == "cuda"
        st = self._stage
        if st is None or st.rows.shape[0] < n:
            st = self._stage = _RingStaging(staging.pow2(n, 16), pin)
        elif st.event is not None:
            st.event.synchronize()     # the last upload from it is done
        start = self._dring_appended
        staging.gather_window(ring, start, n, st.rows.numpy())
        slots = np.arange(start, start + n) % ring.capacity
        st.arrival.numpy()[:n] = ring.arrival[slots] - self._dring_epoch
        device_ring.append_rows(dr, st.rows, st.arrival, n)
        staging.count_upload(st.rows[:n], st.arrival[:n])
        if pin:
            st.event = torch.cuda.Event()
            st.event.record()
        self._dring_appended = ring.head
        self.dring_appends += 1
        obs.TPU_H2D_BYTES.inc(n * (device_ring.ROW_STRIDE + 4))
        if PROFILER.enabled:
            self._phase_add("h2d", time.perf_counter_ns() - t_h)

    def _install(self, key, params) -> tuple:
        self._params, self._params_key = params, key
        return params

    def _device_params(self, outputs, ring, now_ms: int):
        """The affine params for ``outputs`` (canonical order): cached
        while the key holds, else the scheduler's installed set, else one
        per-stream query of the device ring.  None when the device result
        disagrees with the host oracle."""
        key = params_key(outputs)
        if key == self._params_key:
            return self._params
        mb = self.megabatch_params
        if mb is not None and mb[0] == key:
            self.megabatch_installs += 1
            return self._install(key, mb[1])
        if self.megabatch_owned:
            # an owned stream's override is missing or stale (a join or a
            # rebase latch mid-wake): the scheduler staged its windows, so
            # the resident ring catches up first
            self._ring_sync(ring, now_ms)
        dev = self._dring.rows.device
        state = staging.upload(
            torch.from_numpy(pack_output_state(outputs)), dev)
        obs.TPU_H2D_BYTES.inc(state.numel() * 4)
        with staging.DeviceTimer(dev, PROFILER.enabled) as timer:
            packed = device_ring.query_params(self._dring, state)
        t_d = time.perf_counter_ns()
        host = staging.readback(packed).numpy()   # the wait: query done
        t_f = time.perf_counter_ns()
        obs.TPU_D2H_BYTES.inc(host.nbytes)
        if PROFILER.enabled:
            dev_ns = timer.ns()
            self._phase_add("device_step", dev_ns)
            self._phase_add("d2h", t_f - t_d)
            obs.TPU_PASS_SECONDS.observe(dev_ns / 1e9, stage="device_params")
        seq_off, ts_off, ssrc, chan, kf = unpack_affine(host[None],
                                                        len(outputs))
        params = tuple(np.ascontiguousarray(a)
                       for a in (seq_off, ts_off, ssrc, chan))
        if not params_agree(params, key):
            return None
        kf = int(kf[0])
        self.last_newest_keyframe = self._dring_base + kf if kf >= 0 else -1
        self.device_param_refreshes += 1
        obs.TPU_PARAM_REFRESHES.inc()
        return self._install(key, params)

    # --------------------------------------------------------------- step
    def step(self, stream: RelayStream, now_ms: int) -> int:
        """One fan-out pass over ``stream``, then its RTCP; returns RTP
        packets written."""
        t0 = time.perf_counter_ns()
        profiled = PROFILER.enabled
        self._pass_phases = {}
        self._pass_wire_bytes = 0
        self._pass_ran = False
        sent = self._send_rtp(stream, now_ms)
        if profiled and self._pass_ran:
            t_r = time.perf_counter_ns()
            stream.relay_rtcp(now_ms)
            dt = time.perf_counter_ns() - t_r
            # one slice per engine the pass ran, the last taking the
            # division's remainder, so the slices sum to the bracket
            engines = sorted({e for e, _ph in self._pass_phases}) \
                or ["native"]
            share = dt // len(engines)
            for i, e in enumerate(engines):
                self._phase_add("rtcp_qos", dt - share * (len(engines) - 1)
                                if i == len(engines) - 1 else share,
                                engine=e)
        else:
            stream.relay_rtcp(now_ms)
        if not self._pass_ran:
            return sent
        dur = time.perf_counter_ns() - t0
        obs.TPU_PASS_SECONDS.observe(dur / 1e9, stage="engine_step")
        obs.TPU_PASSES.inc()
        if sent:
            obs.TPU_PACKETS_SENT.inc(sent)
        if profiled and self._pass_phases:
            by_engine: dict[str, dict[str, int]] = {}
            for (eng, ph), ns in self._pass_phases.items():
                by_engine.setdefault(eng, {})[ph] = ns
            first = True                # session bytes and passes once
            for eng, phases in sorted(by_engine.items()):
                PROFILER.account_pass(
                    eng, dur, phases, path=stream.session_path,
                    wire_bytes=self._pass_wire_bytes if first else 0,
                    count_pass=first)
                first = False
        span_args = {"sent": sent, "outputs": stream.num_outputs}
        if stream.trace_id is not None:
            span_args["trace_id"] = stream.trace_id
        TRACER.add("engine.step", t0, dur, cat="tpu", **span_args)
        return sent

    def _send_rtp(self, stream: RelayStream, now_ms: int) -> int:
        ring = stream.rtp_ring
        flat = self._flat_outputs(stream)
        if not flat or len(ring) == 0:
            return 0
        self._prime(stream, flat, now_ms)
        udp, tcp, rest, batch = self.split_flat(flat)
        if not (udp or tcp or rest or batch):
            return 0
        self._pass_ran = True
        sent = 0
        if udp or tcp or rest:
            sent += self._param_rungs(stream, udp, tcp, rest, now_ms)
        if batch:
            sent += self._batch_header_step(stream, batch, now_ms)
        stream.stats.packets_out += sent
        self.steps += 1
        self.packets_sent += sent
        return sent

    def _param_rungs(self, stream, udp, tcp, rest, now_ms: int) -> int:
        """The UDP fast, TCP fast and loop rungs from one params set."""
        ring = stream.rtp_ring
        if not self.megabatch_owned:
            self._ring_sync(ring, now_ms)
        order = [o for group in (udp, tcp, rest) for o, _ in group]
        params = self._device_params(order, ring, now_ms)
        if params is None:
            self.missing_params += 1
            return 0
        start = min(o.bookmark for o in order)
        ids, lengths, flags = ring.window_meta(start, ring.head - start)
        if len(ids) == 0:
            return 0
        win = _Window(ring, ids, lengths, flags, now_ms,
                      stream.settings.bucket_delay_ms)
        sent = 0
        if udp:
            sent += self._udp_scatter(stream, udp, win, params)
        if tcp:
            sent += self._tcp_scatter(stream, tcp, len(udp), win, params)
        if udp or tcp:
            self.native_passes += 1
        if rest:
            t0 = time.perf_counter_ns()
            n = self._loop(stream, rest, len(udp) + len(tcp), win, params)
            self.loop_ns += time.perf_counter_ns() - t0
            self.loop_sent += n
            sent += n
        return sent

    # ---------------------------------------------------------- UDP rung
    def _dests_for(self, udp):
        key = tuple(o.native_addr for o, _ in udp)
        if key != self._dests_key:
            self._dests = native.make_dests(list(key))
            self._dests_key = key
        return self._dests

    def _send_ops(self, ring, params, dests, ops_np, mode) -> int:
        seq_off, ts_off, ssrc, _chan = params
        return native.fanout_send_multi(
            self.egress_fd, ring.data, ring.length, seq_off, ts_off, ssrc,
            dests, native.ops_from_numpy(ops_np), len(ops_np), use_gso=mode)

    def _udp_scatter(self, stream, udp, win, params) -> int:
        """ONE native scatter of every eligible (packet, output) pair;
        bookmarks move exactly as the scalar loop's would under the same
        partial (EAGAIN) or failed (hard error) sends.  The op list is
        built for all outputs at once from prefix counts over the
        window's valid rows; only the bookkeeping walks the outputs."""
        ring = stream.rtp_ring
        n_out = len(udp)
        lo = np.maximum(np.fromiter((o.bookmark for o, _ in udp), np.int64,
                                    n_out) - win.start, 0)
        hi = win.his(lo, np.fromiter((b for _, b in udp), np.int64, n_out))
        has = hi > lo
        first = win.valid_cum[lo]                 # valid rows before lo
        n = np.where(has, win.valid_cum[hi] - first, 0)
        total = int(n.sum())
        ends = np.cumsum(n)
        starts = ends - n                         # each output's first op
        r, hard = 0, False
        if total:
            rows = win.valid_rows[np.repeat(first - starts, n)
                                  + np.arange(total)]
            ops_np = np.empty((total, 2), np.int32)
            ops_np[:, 0] = win.idx[rows]
            ops_np[:, 1] = np.repeat(np.arange(n_out, dtype=np.int32), n)
            t_e = time.perf_counter_ns()
            r, hard = self._udp_send_all(ring, params, self._dests_for(udp),
                                         ops_np)
            wire_ns = time.perf_counter_ns()
            if PROFILER.enabled:
                self._phase_add("egress_native", wire_ns - t_e)
        k = np.clip(r - starts, 0, n)
        nbytes = win.valid_len_cum[first + k] - win.valid_len_cum[first]
        if r > 0:
            self._note_udp_delivered(stream, udp, win, ops_np[:r], first, k,
                                     nbytes, wire_ns)
        # video frame starts among each output's first k + 1 and all n
        # sendable rows (``admit`` would have counted them)
        ff_k1 = (win.ff_cum[first + np.minimum(k + 1, n)]
                 - win.ff_cum[first])
        ff_n = win.ff_cum[first + n] - win.ff_cum[first]
        hard_used = False
        for (out, _b), h, ok, ns, ks, nb, f, fk, fn in zip(
                udp, has.tolist(), hi.tolist(), n.tolist(), k.tolist(),
                nbytes.tolist(), first.tolist(), ff_k1.tolist(),
                ff_n.tolist()):
            if not h:
                continue
            if ks == ns:                    # all sent, or a runt-only span
                out.bookmark = win.start + ok
            elif hard and not hard_used:
                # the datagram at the boundary failed hard: drop this
                # output's rest for the pass so the others are not starved
                hard_used = True
                out.bookmark = win.start + ok
                self.send_errors += ns - ks
            else:
                out.bookmark = int(win.ids[win.valid_rows[f + ks]])
                out.stalls += 1             # the first unsent packet
                stream.stats.stalls += 1
                fn = fk      # the oracle admits the blocked packet again
            out.thinning.note_frames(fn)
            if ks:
                out.packets_sent += ks
                out.bytes_sent += nb
                out.payload_octets += nb - 12 * ks
        self.native_sent += r
        return r

    def _note_udp_delivered(self, stream, udp, win, ops, first, k, nbytes,
                            wire_ns: int) -> None:
        """The UDP rung's delivered ops (``ops``: the sent prefix of the op
        list, grouped by output) into the latency histogram and, for the
        outputs with an audience row, the audience columns."""
        self._pass_wire_bytes += int(nbytes.sum())
        lat_s = (wire_ns - stream.rtp_ring.arrival_ns[ops[:, 0]]) / 1e9
        blk = stream.audience
        if blk is not None and obs.AUDIENCE.enabled:
            rows = np.fromiter((getattr(o, "audience_row", -1)
                                for o, _ in udp), np.int64, len(udp))
            take = (rows >= 0) & (k > 0)
            if take.any():
                f, kk = first[take], k[take]
                obs.AUDIENCE.note_pass(
                    blk, rows[take], kk, nbytes[take],
                    win.ids[win.valid_rows[f]],
                    win.ids[win.valid_rows[f + kk - 1]],
                    lat_s[take[ops[:, 1]]], wire_ns)
        note_latency(stream, "native", lat_s)

    def _udp_send_all(self, ring, params, dests, ops_np) -> tuple[int, bool]:
        """``(ops sent, whether the stop was hard)`` for ``ops_np``."""
        total = len(ops_np)
        r, used_gso = self._udp_send(ring, params, dests, ops_np)
        if r < 0:
            # nothing sent and the stop was hard: the poisoned output is
            # skipped (the scalar loop advances on ERROR too)
            return 0, True
        if r == total:
            return r, False
        hard = native.last_send_errno() not in _EAGAIN
        if hard and used_gso:
            # a kernel without UDP_SEGMENT may send one-segment supers and
            # refuse the next: a GSO failure, not a bad destination — the
            # rest goes again without GSO
            self._gso_strike()
            r2 = self._send_ops(ring, params, dests, ops_np[r:],
                                native.SEND_PLAIN)
            if r2 >= 0:
                r += r2
                hard = (r < total
                        and native.last_send_errno() not in _EAGAIN)
        return int(r), hard

    def _gso_strike(self) -> None:
        self._gso_strikes += 1
        if self._gso_strikes >= 2:
            self._gso_disabled = True

    def _udp_send(self, ring, params, dests, ops_np) -> tuple[int, bool]:
        """``(ops sent or −errno, whether GSO sent)``.  A GSO call that
        sends nothing while plain sendmmsg works is a strike; a GSO pass
        that works clears them."""
        if not self._gso_disabled:
            r = self._send_ops(ring, params, dests, ops_np, native.SEND_GSO)
            if r >= 0:
                self._gso_strikes = 0
                return r, True
        r = self._send_ops(ring, params, dests, ops_np, native.SEND_PLAIN)
        if r >= 0 and not self._gso_disabled:
            self._gso_strike()
        return r, False

    # ---------------------------------------------------------- TCP rung
    def _tcp_scatter(self, stream, tcp, col0: int, win, params) -> int:
        """One framed ``writev`` per connection.  EAGAIN holds the
        bookmark; a torn packet's remainder goes through ``push_tail``
        (the transport then owns the connection's order); a reader more
        than half the ring behind is moved forward to the newest keyframe
        (whole frames dropped, never a blocked wake)."""
        ring = stream.rtp_ring
        seq_off, ts_off, ssrc, chan = params
        sent = 0
        delivered = Delivered()
        shed0 = self.tcp_shed_pkts
        t_e = time.perf_counter_ns()
        for j, (out, b_idx) in enumerate(tcp):
            col = col0 + j
            if ring.head - out.bookmark > ring.capacity // 2:
                kf = stream.keyframe_id
                if kf is None or kf <= out.bookmark:
                    kf = ring.head - ring.capacity // 4
                if kf > out.bookmark:
                    self.tcp_shed_pkts += int(kf) - out.bookmark
                    out.bookmark = int(kf)
                    out.stalls += 1
                    stream.stats.stalls += 1
            lo, hi = win.span(out.bookmark, b_idx)
            if hi <= lo:
                continue
            sel = win.valid[lo:hi]
            pids = win.ids[lo:hi][sel]
            slots = np.ascontiguousarray(win.idx[lo:hi][sel])
            lens = win.lengths[lo:hi][sel]
            ffs = win.frame_first[lo:hi][sel]
            if len(pids) == 0:
                out.bookmark = win.start + hi   # a runt-only span
                continue
            ch = int(chan[0, col]) & 0xFF
            r, partial = native.stream_send(
                out.stream_fd, ring.data, ring.length, int(seq_off[0, col]),
                int(ts_off[0, col]), int(ssrc[0, col]), ch, slots)
            if r < 0:
                if native.last_send_errno() in _EAGAIN:
                    out.stalls += 1           # replay from the bookmark
                    stream.stats.stalls += 1
                    out.thinning.note_frames(int(ffs[0]))
                else:                         # a dead connection: skip
                    out.bookmark = win.start + hi
                    self.send_errors += len(pids)
                    out.thinning.note_frames(int(ffs.sum()))
                continue
            k = r
            nbytes = int(lens[:k].sum())
            dead = False
            if partial > 0 and k < len(pids):
                # the k-th packet is torn on the wire: its remainder must
                # be the connection's next bytes
                if out.push_tail(self._framed(ring, int(slots[k]), out,
                                              ch)[partial:]):
                    nbytes += int(lens[k])
                    k += 1
                else:
                    # the transport died: skip the span, and never send
                    # the torn packet again on a socket holding its start
                    dead = True
                    out.bookmark = win.start + hi
                    self.send_errors += len(pids) - k
            if dead:
                out.thinning.note_frames(int(ffs.sum()))
            elif k == len(pids):
                out.bookmark = win.start + hi
                out.thinning.note_frames(int(ffs.sum()))
            else:
                out.bookmark = int(pids[k])  # the first unsent packet
                out.stalls += 1
                stream.stats.stalls += 1
                # the oracle admits the blocked packet again on replay
                out.thinning.note_frames(int(ffs[:k + 1].sum()))
            if k:
                out.packets_sent += k
                out.bytes_sent += nbytes
                out.payload_octets += nbytes - 12 * k
                sent += k
                delivered.add(out, slots[:k], nbytes, int(pids[0]),
                              int(pids[k - 1]))
        wire_ns = time.perf_counter_ns()
        if PROFILER.enabled:
            self._phase_add("egress_native", wire_ns - t_e)
        if sent:
            self._pass_wire_bytes += delivered.nbytes
            obs.TCP_EGRESS_PACKETS.inc(sent, backend="writev")
            obs.TCP_EGRESS_BYTES.inc(delivered.nbytes + 4 * sent,
                                     backend="writev")
            delivered.note(stream, "native", wire_ns)
        if self.tcp_shed_pkts > shed0:
            obs.TCP_EGRESS_BACKPRESSURE_SHEDS.inc(
                self.tcp_shed_pkts - shed0, backend="writev")
        self.native_sent += sent
        return sent

    @staticmethod
    def _framed(ring, slot: int, out, chan: int) -> bytes:
        """One framed interleaved packet rendered on the host (what the C
        renderer writes, by the same rewrite)."""
        n = int(ring.length[slot])
        pkt = ring.data[slot, :n].tobytes()
        rw = out.rewrite
        body = rtp.rewrite_header(
            pkt, seq=rw.map_seq(rtp.peek_seq(pkt)),
            timestamp=rw.map_ts(rtp.peek_timestamp(pkt)), ssrc=rw.ssrc)
        return b"$" + bytes((chan,)) + n.to_bytes(2, "big") + body

    # ----------------------------------------------------------- the loop
    def _loop(self, stream, rest, col0: int, win, params) -> int:
        """Render every header with numpy and write each packet through
        ``send_rewritten``, in the scalar oracle's order."""
        ring = stream.rtp_ring
        seq_off, ts_off, ssrc, _chan = (p[:, col0:col0 + len(rest)]
                                        for p in params)
        headers = render_headers(ring.data[win.idx, :2], ring.seq[win.idx],
                                 ring.timestamp[win.idx], seq_off[0],
                                 ts_off[0], ssrc[0])
        sent = 0
        delivered = Delivered()
        for s, (out, b_idx) in enumerate(rest):
            deadline = win.now_ms - b_idx * win.delay
            pid = out.bookmark
            o_slots, o_pids, nbytes = [], [], 0
            while pid < ring.head:
                j = pid - win.start
                # the oracle's order: eligibility first (break holds the
                # bookmark), runt-skip second (advance)
                if win.arrivals[j] > deadline:
                    break
                n = int(win.lengths[j])
                if n < 12:
                    pid += 1
                    continue
                # a pass-through filter admits every packet; it still
                # counts the frames, as the oracle's does
                out.thinning.admit(int(ring.flags[win.idx[j]]))
                wr = out.send_rewritten(headers[s, j].tobytes(),
                                        ring.data[win.idx[j], 12:n].tobytes())
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
                    nbytes += n
                    o_slots.append(win.idx[j])
                    o_pids.append(pid - 1)
            if o_slots:
                delivered.add(out, np.asarray(o_slots, np.int64), nbytes,
                              o_pids[0], o_pids[-1])
            out.bookmark = pid
        self._pass_wire_bytes += delivered.nbytes
        delivered.note(stream, "scalar", time.perf_counter_ns())
        return sent

    # ------------------------------------------------- batch-header rung
    def _batch_header_step(self, stream, batch, now_ms: int) -> int:
        """Meta-info and thinned outputs: ``relay_batch_step`` renders
        every (output, packet) header on the engine's device, then each
        output walks its span in the oracle's order (eligibility, runts,
        ``admit``) and sends through ``send_rewritten``."""
        ring = stream.rtp_ring
        start = min(o.bookmark for o, _ in batch)
        ids, lengths, flags = ring.window_meta(start, ring.head - start)
        if len(ids) == 0:
            return 0
        start = int(ids[0])                 # window_meta clamps to tail
        idx = ids % ring.capacity
        arrivals = ring.arrival[idx]
        delay = stream.settings.bucket_delay_ms
        headers = self._batch_headers(ring, idx, lengths, now_ms - arrivals,
                                      batch, delay)
        self.batch_passes += 1
        self.batch_rows += len(ids)
        sent = 0
        delivered = Delivered()
        for s, (out, b_idx) in enumerate(batch):
            deadline = now_ms - b_idx * delay
            pid = out.bookmark
            o_slots, o_pids, nbytes = [], [], 0
            while pid < ring.head:
                j = pid - start
                # the oracle's order: eligibility first (break holds the
                # bookmark), runt-skip second, the thinning filter third
                if arrivals[j] > deadline:
                    break
                n = int(lengths[j])
                if n < 12 or not out.thinning.admit(int(flags[j])):
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
                    nbytes += n
                    o_slots.append(idx[j])
                    o_pids.append(pid - 1)
            if o_slots:
                delivered.add(out, np.asarray(o_slots, np.int64), nbytes,
                              o_pids[0], o_pids[-1])
            out.bookmark = pid
        self._pass_wire_bytes += delivered.nbytes
        delivered.note(stream, "batch", time.perf_counter_ns())
        self.batch_sent += sent
        return sent


    def _batch_headers(self, ring, idx, lengths, ages, batch,
                       delay: int) -> np.ndarray:
        """``[S, P, 12]`` headers of one batch pass: the window's rows,
        lengths and ages and the outputs' state and buckets packed into
        one pinned buffer (kept per size, reused after its event), ONE
        upload, ONE ``relay_batch_step``, the headers alone copied back
        into pinned memory, and that copy's event waited on."""
        if self._batch_stage is None:
            self._batch_dev = resolve_device(self.device)
            self._batch_stage = staging.PinnedStage(
                self._batch_dev.type == "cuda")
        st, dev = self._batch_stage, self._batch_dev
        n_pkts, n_subs = len(idx), len(batch)
        t0 = time.perf_counter_ns()
        up = st.buffer("upload", (staging.pow2(
            n_pkts * (PARSE_PREFIX + 8) + n_subs * 28, 4096),))
        nbytes = pack_batch_upload(
            up.numpy(), ring.data[idx, :PARSE_PREFIX], lengths, ages,
            pack_output_state([o for o, _ in batch]),
            np.fromiter((b for _, b in batch), np.int32, n_subs))
        d_up = staging.upload(up[:nbytes], dev)
        t1 = time.perf_counter_ns()
        with staging.DeviceTimer(dev, PROFILER.enabled) as timer:
            res = relay_batch_step(
                *batch_upload_views(d_up, n_pkts, n_subs), delay)
        n_hdr = n_subs * n_pkts * 12
        out = st.buffer("headers", (staging.pow2(n_hdr, 4096),))[:n_hdr]
        staging.readback(res["headers"].view(-1), out)
        st.record()
        if st.event is not None:
            st.event.synchronize()       # the wait: kernel and copy done
        t2 = time.perf_counter_ns()
        self.batch_stage_ns += t1 - t0
        self.batch_kernel_ns += t2 - t1
        obs.TPU_H2D_BYTES.inc(nbytes)
        obs.TPU_D2H_BYTES.inc(n_hdr)
        obs.TPU_HEADERS_RENDERED.inc(n_subs * n_pkts)
        if PROFILER.enabled:
            dev_ns = timer.ns()
            self._phase_add("h2d", t1 - t0, engine="batch")
            self._phase_add("device_step", dev_ns, engine="batch")
            # the copy back and the wait on it, past the kernel's own time
            self._phase_add("d2h", max(t2 - t1 - dev_ns, 0), engine="batch")
        return out.numpy().reshape(n_subs, n_pkts, 12)


class _Window:
    """One pass's view of the ring from the lowest bookmark to the head:
    absolute ids, slots, lengths and arrivals, and each bucket's
    eligibility edge."""

    __slots__ = ("ids", "idx", "lengths", "arrivals", "valid", "start",
                 "now_ms", "delay", "valid_rows", "valid_cum",
                 "valid_len_cum", "frame_first", "ff_cum", "_late")

    def __init__(self, ring, ids, lengths, flags, now_ms: int, delay: int):
        self.ids = ids
        self.start = int(ids[0])            # window_meta clamps to tail
        self.idx = (ids % ring.capacity).astype(np.int32)
        self.lengths = lengths
        self.arrivals = ring.arrival[self.idx]
        self.valid = lengths >= 12
        self.now_ms = now_ms
        self.delay = delay
        #: the rows a send takes (not runts), how many precede each row,
        #: and their bytes before each of them
        self.valid_rows = np.flatnonzero(self.valid)
        self.valid_cum = np.concatenate(([0], np.cumsum(self.valid)))
        self.valid_len_cum = np.concatenate(
            ([0], np.cumsum(lengths[self.valid_rows], dtype=np.int64)))
        #: the rows that start a video frame, and how many of them the
        #: sendable rows before each sendable row hold
        self.frame_first = (flags & _VIDEO_FRAME_FIRST) == _VIDEO_FRAME_FIRST
        self.ff_cum = np.concatenate(
            ([0], np.cumsum(self.frame_first[self.valid_rows])))
        self._late: dict[int, np.ndarray] = {}

    def _late_rows(self, b_idx: int) -> np.ndarray:
        late = self._late.get(b_idx)
        if late is None:
            late = self._late[b_idx] = np.flatnonzero(
                self.arrivals > self.now_ms - b_idx * self.delay)
        return late

    def his(self, lo: np.ndarray, b_idx: np.ndarray) -> np.ndarray:
        """Each output's end row: the first row at or after its ``lo``
        that arrived after its bucket's deadline (where the scalar loop
        stops), or the window's end."""
        hi = np.empty_like(lo)
        for b in np.unique(b_idx).tolist():
            sel = b_idx == b
            late = np.append(self._late_rows(b), len(self.ids))
            hi[sel] = late[np.searchsorted(late, lo[sel])]
        return hi

    def span(self, bookmark: int, b_idx: int) -> tuple[int, int]:
        """``[lo, hi)`` window rows one output may send (``his`` for one)."""
        lo = max(bookmark - self.start, 0)
        return lo, int(self.his(np.array([lo]), np.array([b_idx]))[0])
