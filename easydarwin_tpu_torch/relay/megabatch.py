"""Cross-stream megabatch relay scheduler (one device, or a mesh).

Coalesces every stream's device work into **one shape-bucketed stacked
pass per wake**:

* **collect** — each stream contributes the ring packets not yet staged
  and its outputs' rewrite state;
* **bucket** — streams are grouped by pow2-padded (window, subscriber)
  shape;
* **stage** — each bucket's windows are gathered into ONE pinned host
  buffer in the fused ``pack_window`` layout and copied to the device with
  ``non_blocking=True``.  Buffers are **double-buffered** per bucket
  shape: the buffer dispatched at wake N goes back to the pool only at
  harvest, after the pass's CUDA event — recorded behind its H2D copy,
  the kernel and the D2H copy — has completed, so the host never
  rewrites an upload the copy engine may still be reading;
* **dispatch** — ONE ``megabatch_window_steps`` call per wake over every
  bucket (one ``ed_relay_window`` launch on the card); each bucket's
  result is copied into its pinned host buffer with ``non_blocking=True``
  and one CUDA event, recorded behind them all, stands for the wake (the
  one-device dispatch is the mesh dispatch below with one shard);
* **harvest** (next wake) — a pass whose event ``query()`` reports done is
  scattered back into per-stream affine params (``scatter_affine_segments``)
  and installed into each engine's ``megabatch_params``.

Streams whose membership or rebase state changed are served by a
synchronous **prime** pass in ``begin_wake``, on fresh zero windows (one
call for all its subscriber buckets): the affine params depend only on
rewrite state, never on packet bytes.  ``window_calls`` counts the calls.

Every installed segment is checked against the host arithmetic oracle
(``relay.fanout.host_affine_params``); a disagreement is counted in
``mismatches`` and the segment discarded, so a device/host divergence can
never reach the wire.

**Mesh dispatch.**  Given a serving mesh (``parallel.mesh.
make_megabatch_mesh``: ``src`` only, built once by the server from
``megabatch_devices``), each bucket's stream axis is split over the
mesh's devices instead:

* stream i rides row i; shard k owns the block ``[k·rows_per,
  (k+1)·rows_per)`` (``ops.staging.rows_per_shard``, pow2), staged in
  its OWN pinned buffer, so each shard's upload is one H2D copy only its
  device reads; uneven stream counts leave the tail shards zero rows
  (zero windows and state stage and install nothing), and a shard of
  padding only is neither uploaded nor launched;
* one window call a device a wake over every bucket
  (``models.relay_pipeline.megabatch_window_steps`` with the device
  current: one ``ed_relay_window`` launch on each card), no collectives;
* each shard's result is copied to its own pinned host buffer behind an
  event of its device, and the harvest fetches and installs every shard
  on its own, through the same oracle check.

A mesh dispatch that fails is counted (``mesh_dispatch_errors``) and
raised to the wake.  Without a mesh every dispatch takes the one-device
path.

**Observability** (``obs``).  A dispatch is one ``megabatch.dispatch``
span and one profiler pass (engine ``megabatch``: ``stage_gather``, the
host gather into the staging buffers, and ``h2d``, the uploads and the
enqueue of the copies back, without the window calls); a prime is one
``megabatch.prime`` span and a pass of ``device_step`` and ``d2h``.  Each
window call's device time comes from a pair of timing events that its
launch wrapper records on the current stream just before and just after
the ``ed_relay_window`` launch (``ops.staging.DeviceTimer``), and is read
only when that device's work is known done: a prime after its own
blocking read, a dispatch at the harvest of the first bucket the device
ran, once its event there has answered ``query()`` (or been waited on by
a forced fetch), never through an added wait.  It is filed as
``device_step`` (so that phase's count is the window calls of the
scheduler) and as ``tpu_pass_seconds{stage="pipeline_dispatch"}``.  A
harvest's fetch is ``d2h`` when the pass was ready and ``h2d_overlap``
when it was forced (the double buffer's un-hidden remainder).  A
saturated ``end_wake`` is a ``megabatch`` deferral in the wake ledger.
``megabatch_passes_total``/``_streams_total`` count buckets and their
streams, ``tpu_h2d_bytes_total``/``tpu_d2h_bytes_total`` the staging and
readback bytes (the copies themselves go through ``ops.staging``'s
counted ``upload`` and ``readback``), and the mesh path bumps the
per-device families.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import native, obs, resolve_device
from ..obs import LEDGER, PROFILER, TRACER
from ..models.relay_pipeline import (megabatch_window_steps, on_device,
                                     scatter_affine_segments)
from ..ops import staging
from ..ops.fanout import STATE_COLS, pack_output_state
from ..ops.staging import pow2
from .fanout import params_agree, params_key


class _Staging:
    """One bucket's host upload: window rows + subscriber state, pinned
    when the device is a card, with numpy views for the gather."""

    __slots__ = ("win", "state", "win_np", "state_np")

    def __init__(self, b_pad: int, p_pad: int, s_pad: int, pin: bool):
        self.win = torch.zeros((b_pad, p_pad, staging.ROW_STRIDE),
                               dtype=torch.uint8, pin_memory=pin)
        self.state = torch.zeros((b_pad, s_pad, STATE_COLS),
                                 dtype=torch.uint32, pin_memory=pin)
        self.win_np = self.win.numpy()
        self.state_np = self.state.numpy()


class _InFlight:
    """One dispatched bucket awaiting harvest, one entry a shard in each
    list (one shard without a mesh)."""

    __slots__ = ("host", "event", "entries", "buf", "dispatch_ns",
                 "rows_per", "timers")

    def __init__(self, host, event, entries, buf, dispatch_ns, rows_per,
                 timers):
        #: each shard's host copy of its [rows, 4·S+1] result, pinned on a
        #: card (valid once its event has completed); None: padding only
        self.host = host
        #: each shard's CUDA event, recorded after its device's D2H copies
        #: of the wake (shared by the wake's buckets); None on the CPU,
        #: where the pass has run
        self.event = event
        #: per-row (stream, engine, key, n_fast, base_pid)
        self.entries = entries
        #: each shard's staging, held until harvest
        self.buf = buf
        self.dispatch_ns = dispatch_ns
        #: stream rows a shard
        self.rows_per = rows_per
        #: each shard's ``DeviceTimer`` of its device's window call of the
        #: wake, on the first bucket that device ran (the call is shared,
        #: and that bucket's event of the device comes after its stop);
        #: None: none
        self.timers = timers

    def ready(self) -> bool:
        return all(e is None or e.query() for e in self.event)


class MegabatchScheduler:
    """One per server; the pump calls ``begin_wake`` before the per-stream
    engine steps and ``end_wake`` after them."""

    #: never stage more than this many packets per stream per pass (a burst
    #: beyond it restages from the newest tail)
    MAX_STAGE_ROWS = 1024
    #: outstanding stacked passes before staging pauses
    MAX_INFLIGHT = 2
    #: an in-flight pass older than this is force-fetched
    FORCE_FETCH_NS = 2_000_000_000

    def __init__(self, device: str | torch.device = "cuda", mesh=None):
        self.device = resolve_device(device)
        #: the serving mesh (``parallel.mesh.make_megabatch_mesh``), or
        #: None for the one-device path; the prime passes stay on
        #: ``device``
        self.mesh = None
        self._mesh_devices: list[torch.device] = []
        if mesh is not None and mesh.size > 1:
            self.mesh = mesh
            self._mesh_devices = [resolve_device(d) for d in mesh.flat()]
        self._pin = any(d.type == "cuda"
                        for d in (self.device, *self._mesh_devices))
        #: staging gathers through the egress core's ``ed_stage_gather``
        #: when it builds (``ops.staging.gather_window``)
        self.native_gather = native.available()
        #: staging buffers kept per hot shape: the double buffer, per
        #: device under a mesh (every shard of a bucket draws from one pool)
        self._pool_cap = 2 * max(1, len(self._mesh_devices))
        self._tracked: dict[int, int] = {}     # id(stream) → staged head
        #: id(stream) → (params_key, packed out_state rows)
        self._state_cache: dict[int, tuple] = {}
        #: id(stream) → (fast, key) from this wake's prime scan
        self._wake_fast: dict[int, tuple] = {}
        self._inflight: list[_InFlight] = []
        self._free: dict[tuple, list[_Staging]] = {}
        self.wakes = 0
        self.passes = 0
        self.prime_passes = 0
        #: megabatch_window_steps calls (one device launch each on the card)
        self.window_calls = 0
        self.streams_coalesced = 0
        self.harvests = 0
        self.installs = 0
        self.mismatches = 0
        self.deferred_wakes = 0
        #: buckets dispatched over the mesh, and mesh dispatches that raised
        self.sharded_passes = 0
        self.mesh_dispatch_errors = 0

    # ------------------------------------------------------------- wake API
    def begin_wake(self, pairs, now_ms: int) -> None:
        """Mark the engines owned (they skip their own ring appends this
        wake), harvest any finished stacked pass, then prime params for
        streams whose membership or rebase state changed — ONE stacked
        pass for every such stream."""
        self.wakes += 1
        for _stream, eng in pairs:
            eng.megabatch_owned = True
        self._harvest()
        self._prime_stale(pairs, now_ms)

    def idle_wake(self) -> None:
        """A wake with no megabatch streams: keep harvesting what is in
        flight, and drop the per-stream cursors once nothing is."""
        if self._inflight:
            self._harvest()
        if not self._inflight and self._tracked:
            self._tracked.clear()
            self._state_cache.clear()

    def end_wake(self, pairs, now_ms: int) -> None:
        """Collect, bucket, stage and dispatch the next stacked pass."""
        t0 = time.perf_counter_ns()
        # prune dead streams BEFORE any early return: a torn-down stream's
        # id() can be recycled by a new RelayStream
        live = {id(s) for s, _ in pairs}
        for sid in [k for k in self._tracked if k not in live]:
            del self._tracked[sid]
            self._state_cache.pop(sid, None)
        if len(self._inflight) >= self.MAX_INFLIGHT:
            self.deferred_wakes += 1       # saturated: dispatch next wake
            LEDGER.defer("megabatch", len(pairs))
            return
        work = self._collect(pairs)
        if not work:
            return
        buckets: dict[tuple, list] = {}
        for item in work:
            _stream, _eng, fast, _key, _base, n_new = item
            shape = (pow2(max(n_new, 1), 16), pow2(len(fast), 8))
            buckets.setdefault(shape, []).append(item)
        gather_ns, h2d_ns = self._dispatch(
            [(entries, p_pad, s_pad) for (p_pad, s_pad), entries
             in sorted(buckets.items())])
        total = time.perf_counter_ns() - t0
        PROFILER.account_pass("megabatch", total,
                              {"stage_gather": gather_ns, "h2d": h2d_ns})
        TRACER.add("megabatch.dispatch", t0, total, cat="tpu",
                   buckets=len(buckets), streams=len(work))

    # ------------------------------------------------------------- prime
    def _prime_stale(self, pairs, now_ms: int) -> None:
        """Synchronous stacked param pass for key-stale streams.

        Runs the engine's own deterministic bookmark/rebase latch first
        (idempotent — the engine's step re-runs it as a no-op with the same
        wake timestamp), so the key computed here is the key the engine
        checks moments later in the same wake."""
        stale = []
        self._wake_fast.clear()
        for stream, eng in pairs:
            flat = eng._flat_outputs(stream)
            eng._prime(stream, flat, now_ms)
            fast = eng.fast_from_flat(flat)
            key = params_key(fast) if fast else None
            self._wake_fast[id(stream)] = (fast, key)
            if not fast or not self._needs_params(eng, key):
                continue
            stale.append((eng, fast, key))
        if not stale:
            return
        t0 = time.perf_counter_ns()
        buckets: dict[int, list] = {}
        for item in stale:
            buckets.setdefault(pow2(len(item[1]), 8), []).append(item)
        groups, inputs = [], []
        for s_pad, items in sorted(buckets.items()):
            b_pad = pow2(len(items), 1)
            # fresh zeros on the device, never a recycled buffer: a stale
            # le32 length row would resurrect an old wake's packets into
            # the keyframe scan
            win = torch.zeros((b_pad, 16, staging.ROW_STRIDE),
                              dtype=torch.uint8, device=self.device)
            state = np.zeros((b_pad, s_pad, STATE_COLS), np.uint32)
            for i, (_eng, fast, _key) in enumerate(items):
                state[i, :len(fast)] = pack_output_state(fast)
            groups.append(items)
            inputs.append((win, staging.upload(torch.from_numpy(state),
                                               self.device)))
            obs.TPU_H2D_BYTES.inc(state.nbytes)
        with staging.DeviceTimer(self.device, PROFILER.enabled) as timer:
            results = self._window_steps(inputs)
        t_d = time.perf_counter_ns()
        packed = [staging.readback(res).numpy()         # the wait
                  for res in results]
        t_f = time.perf_counter_ns()
        for items, host in zip(groups, packed):
            obs.TPU_D2H_BYTES.inc(host.nbytes)
            segs = scatter_affine_segments(
                host, [len(f) for (_e, f, _k) in items])
            for (eng, _fast, key), seg in zip(items, segs):
                self._install_segment(eng, key, seg)
            self.prime_passes += 1
            self._note_pass(len(items))
        if PROFILER.enabled:
            dev_ns = max(timer.ns(), 1)
            PROFILER.account_pass("megabatch", t_f - t_d + dev_ns,
                                  {"device_step": dev_ns, "d2h": t_f - t_d})
            obs.TPU_PASS_SECONDS.observe(dev_ns / 1e9,
                                         stage="pipeline_dispatch")
        TRACER.add("megabatch.prime", t0, time.perf_counter_ns() - t0,
                   cat="tpu", streams=len(stale))

    def _window_steps(self, inputs) -> list:
        """The one device call of a dispatch or a prime."""
        self.window_calls += 1
        return megabatch_window_steps(inputs)

    @staticmethod
    def _needs_params(eng, key) -> bool:
        mb = eng.megabatch_params
        return key != eng._params_key and not (mb is not None and mb[0] == key)

    # ------------------------------------------------------------- collect
    def _collect(self, pairs) -> list:
        work = []
        for stream, eng in pairs:
            ring = stream.rtp_ring
            cached = self._wake_fast.get(id(stream))
            if cached is not None:
                fast, key = cached
            else:                          # end_wake without a prime scan
                fast = eng.fast_outputs(stream)
                key = params_key(fast) if fast else None
            if not fast:
                self._tracked[id(stream)] = ring.head
                continue
            base = self._tracked.get(id(stream))
            floor = max(ring.tail, ring.head - self.MAX_STAGE_ROWS)
            if base is None or base > ring.head or base < floor:
                base = floor               # new/recycled/fell-behind
            n_new = ring.head - base
            if n_new <= 0 and not self._needs_params(eng, key):
                continue                   # idle stream: zero device work
            work.append((stream, eng, fast, key, base, n_new))
        return work

    # ------------------------------------------------------------ dispatch
    def _buffer(self, b_pad: int, p_pad: int, s_pad: int) -> _Staging:
        pool = self._free.get((b_pad, p_pad, s_pad))
        if pool:
            return pool.pop()
        return _Staging(b_pad, p_pad, s_pad, self._pin)

    def _recycle(self, buf: _Staging) -> None:
        key = (buf.win.shape[0], buf.win.shape[1], buf.state.shape[1])
        pool = self._free.setdefault(key, [])
        if len(pool) < self._pool_cap:     # double buffer per shape; a
            pool.append(buf)               # cold shape's extras are freed

    def _install_segment(self, eng, key, seg, base=None) -> bool:
        """Oracle-check one scattered segment and install it as the
        engine's params — the ONE definition the harvest and the prime go
        through.  Returns False (and counts the mismatch) on device/host
        divergence."""
        params, kf = seg[:4], seg[4]
        if not params_agree(params, key):
            self.mismatches += 1
            obs.MEGABATCH_WIRE_MISMATCH.inc()
            eng.megabatch_params = None
            return False
        eng.megabatch_params = (key, params)
        self.installs += 1
        if base is not None and kf >= 0:
            eng.last_newest_keyframe = max(eng.last_newest_keyframe,
                                           base + kf)
        return True

    def _note_pass(self, n_streams: int) -> None:
        self.passes += 1
        self.streams_coalesced += n_streams
        obs.MEGABATCH_PASSES.inc()
        obs.MEGABATCH_STREAMS.inc(n_streams)

    def _packed_state(self, stream, fast, key) -> np.ndarray:
        cached = self._state_cache.get(id(stream))
        if cached is not None and cached[0] == key:
            return cached[1]
        packed = pack_output_state(fast)
        self._state_cache[id(stream)] = (key, packed)
        return packed

    def _dispatch(self, buckets) -> None:
        """Stage every ``(entries, p_pad, s_pad)`` bucket, split over the
        serving mesh's devices (without a mesh: one shard on ``device``),
        upload each shard's rows from its own pinned buffer, then ONE
        window call a device for the wake; each shard's result goes to its
        pinned host buffer behind its device's event.  A mesh dispatch
        that raises is counted first.  Returns the host ns of the gather
        and of the uploads and calls."""
        if self.mesh is None:
            return self._dispatch_shards(buckets, [self.device])
        try:
            return self._dispatch_shards(buckets, self._mesh_devices)
        except Exception:
            self.mesh_dispatch_errors += 1
            raise

    def _dispatch_shards(self, buckets, devs) -> tuple[int, int]:
        n_dev = len(devs)
        mesh = self.mesh is not None
        gather_ns = 0
        up_ns = [0] * n_dev
        staged = []
        #: per device, the (window, state) of each bucket it takes, and
        #: the index of that bucket
        inputs = [[] for _ in devs]
        where = [[] for _ in devs]
        for b, (entries, p_pad, s_pad) in enumerate(buckets):
            rows_per = staging.rows_per_shard(len(entries), n_dev)
            bufs = [self._buffer(rows_per, p_pad, s_pad) for _ in devs]
            filled = [0] * n_dev
            recs = []
            t_g = time.perf_counter_ns()
            for buf in bufs:
                buf.state_np[:] = 0
            for i, (stream, eng, fast, key, base, n_new) in enumerate(
                    entries):
                k, r = divmod(i, rows_per)
                staging.gather_window(stream.rtp_ring, base, n_new,
                                      bufs[k].win_np[r])
                bufs[k].state_np[r, :len(fast)] = self._packed_state(
                    stream, fast, key)
                self._tracked[id(stream)] = base + n_new
                recs.append((stream, eng, key, len(fast), base))
                filled[k] = r + 1
            for k, buf in enumerate(bufs):
                buf.win_np[filled[k]:] = 0   # shard and bucket padding
            t_u = time.perf_counter_ns()
            gather_ns += t_u - t_g
            for k, buf in enumerate(bufs):
                if filled[k]:                # a padding-only shard: none
                    dev = devs[k]
                    inputs[k].append((staging.upload(buf.win, dev),
                                      staging.upload(buf.state, dev)))
                    where[k].append(b)
                    obs.TPU_H2D_BYTES.inc(buf.win.nbytes + buf.state.nbytes)
                    t_k = time.perf_counter_ns()
                    up_ns[k] += t_k - t_u
                    t_u = t_k
                    if mesh:
                        obs.MEGABATCH_DEVICE_PASSES.inc(device=str(k))
                        obs.MEGABATCH_DEVICE_STREAMS.inc(filled[k],
                                                         device=str(k))
            staged.append((bufs, recs, rows_per))
        results = []
        timers = [None] * n_dev
        t_c = time.perf_counter_ns()
        call_ns = 0
        for k, (dev, pairs) in enumerate(zip(devs, inputs)):
            with on_device(dev):
                if pairs:
                    t_k = time.perf_counter_ns()
                    with staging.DeviceTimer(dev, PROFILER.enabled) as tm:
                        results.append(self._window_steps(pairs))
                    timers[k] = tm
                    call_ns += time.perf_counter_ns() - t_k
                else:
                    results.append([])
        hosts = [[None] * n_dev for _ in buckets]
        events = [[None] * n_dev for _ in buckets]
        for k, (dev, outs) in enumerate(zip(devs, results)):
            card = dev.type == "cuda"
            event = None
            copies = [staging.readback(res.view(torch.int32), torch.empty(
                res.shape, dtype=torch.int32, pin_memory=card))
                for res in outs]
            if card and outs:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
            for b, host in zip(where[k], copies):
                hosts[b][k] = host
                events[b][k] = event
        # device k's timer rides the first bucket it ran: that bucket's
        # harvest waits on (or has seen done) device k's event, recorded
        # behind the timer's stop
        bucket_timers = [[None] * n_dev for _ in buckets]
        for k, timer in enumerate(timers):
            if timer is not None:
                bucket_timers[where[k][0]][k] = timer
        now = time.perf_counter_ns()
        for (bufs, recs, rows_per), host, ev, tms in zip(
                staged, hosts, events, bucket_timers):
            self._inflight.append(_InFlight(host, ev, recs, bufs, now,
                                            rows_per, tms))
            self._note_pass(len(recs))
            self.sharded_passes += mesh
        if mesh and PROFILER.enabled:
            for k, ns in enumerate(up_ns):
                if ns:
                    obs.MEGABATCH_DEVICE_PHASE_SECONDS.observe(
                        ns / 1e9, device=str(k), phase="h2d")
        # the window calls are the device_step phase's, not the upload's
        return gather_ns, sum(up_ns) + now - t_c - call_ns

    def _consume(self, inf: _InFlight) -> tuple[int, int]:
        """Install one pass shard by shard: each shard's rows from its own
        host copy, through the oracle check, and, once the shard's event
        is known done, its device's window-call time when the pass holds
        it.  Returns the installs and the host ns of the fetches (the
        event waits and host views)."""
        installed = 0
        fetch_ns = 0
        mesh = self.mesh is not None
        for k, host in enumerate(inf.host):
            ents = inf.entries[k * inf.rows_per:(k + 1) * inf.rows_per]
            if not ents:
                continue                     # padding only: nothing ran
            t_w = time.perf_counter_ns()
            if inf.event[k] is not None:
                inf.event[k].synchronize()   # no-op once ready() said done
            packed = host.numpy().view(np.uint32)
            t_f = time.perf_counter_ns()
            fetch_ns += t_f - t_w
            if inf.timers[k] is not None:
                self._note_device_time(k, inf.timers[k])
            obs.TPU_D2H_BYTES.inc(packed.nbytes)
            if mesh and PROFILER.enabled:
                obs.MEGABATCH_DEVICE_PHASE_SECONDS.observe(
                    (t_f - t_w) / 1e9, device=str(k), phase="d2h")
            segs = scatter_affine_segments(
                packed, [n for (_s, _e, _k, n, _b) in ents])
            for (_stream, eng, key, _n, base), seg in zip(ents, segs):
                if self._install_segment(eng, key, seg, base=base):
                    installed += 1
        return installed, fetch_ns

    def _note_device_time(self, k: int, timer) -> None:
        """Device ``k``'s window-call time of a harvested wake, one
        ``device_step`` sample a call (read only after that device's event
        of the wake has completed)."""
        if not PROFILER.enabled:
            return
        dev_ns = max(timer.ns(), 1)
        PROFILER.observe("device_step", "megabatch", dev_ns)
        obs.TPU_PASS_SECONDS.observe(dev_ns / 1e9, stage="pipeline_dispatch")
        if self.mesh is not None:
            obs.MEGABATCH_DEVICE_PHASE_SECONDS.observe(
                dev_ns / 1e9, device=str(k), phase="device_step")

    # ------------------------------------------------------------- harvest
    def _harvest(self, *, force: bool = False) -> int:
        if not self._inflight:
            return 0
        t0 = time.perf_counter_ns()
        keep: list[_InFlight] = []
        installed = 0
        d2h_ns = overlap_ns = 0
        for inf in self._inflight:
            age = time.perf_counter_ns() - inf.dispatch_ns
            ready = inf.ready()
            if not (ready or force or age >= self.FORCE_FETCH_NS):
                keep.append(inf)           # never stall the wake on it
                continue
            got, fetch_ns = self._consume(inf)
            installed += got
            # a ready pass's fetch is the copy's; a forced one's is the
            # double buffer's un-hidden remainder
            if ready:
                d2h_ns += fetch_ns
            else:
                overlap_ns += fetch_ns
            for buf in inf.buf:
                self._recycle(buf)
            self.harvests += 1
        self._inflight = keep
        if d2h_ns or overlap_ns:
            PROFILER.account_pass(
                "megabatch", time.perf_counter_ns() - t0,
                {"h2d_overlap": overlap_ns, "d2h": d2h_ns})
        return installed

    # -------------------------------------------------------------- stats
    def drain(self) -> int:
        """Force-fetch everything in flight (tests/teardown)."""
        return self._harvest(force=True)

    def stats(self) -> dict:
        return {
            "wakes": self.wakes,
            "passes": self.passes,
            "prime_passes": self.prime_passes,
            "window_calls": self.window_calls,
            "streams_coalesced": self.streams_coalesced,
            "inflight": len(self._inflight),
            "harvests": self.harvests,
            "installs": self.installs,
            "mismatches": self.mismatches,
            "deferred_wakes": self.deferred_wakes,
            "sharded_passes": self.sharded_passes,
            "mesh_devices": len(self._mesh_devices),
            "mesh_dispatch_errors": self.mesh_dispatch_errors,
            "native_gather": self.native_gather,
        }
